"""The LM substrate's dense attention family: layers, attention with its
KV cache, the decoder stack and the serving step API."""
from .model import LMModel

__all__ = ["LMModel"]
