"""Deterministic, seekable token streams (numpy)."""
from .pipeline import PackedFile, SyntheticLM, batch_for

__all__ = ["SyntheticLM", "PackedFile", "batch_for"]
