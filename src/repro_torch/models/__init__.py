"""The LM substrate's dense attention family: layers, attention with its
KV cache, the decoder stack (with remat and the loss), the step API
(serving and training) and the weight conversions to and from the JAX
package."""
from .model import LMModel

__all__ = ["LMModel"]
