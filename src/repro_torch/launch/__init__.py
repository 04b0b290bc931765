"""Launchers (serving, training)."""
