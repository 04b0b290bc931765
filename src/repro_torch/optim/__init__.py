"""Optimizers of the LM substrate: a copy of the JAX package's
`repro.optim` (AdamW, Adafactor, int8 gradient compression with error
feedback) on dicts of tensors keyed like `LMParams.state_dict()`.

Each update is JAX's function: it takes (grads, state, params) and returns
(new params, new state, the gradient norm) without touching its inputs.
The state is f32 and the update runs in f32, then casts to each
parameter's dtype. `torch.optim` is not used: on bf16 parameters it keeps
bf16 state and casts in another order.
"""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .adafactor import AdafactorState, adafactor_init, adafactor_update
from .compress import compress_grads, decompress_grads, ef_init, ef_apply

__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "AdafactorState", "adafactor_init", "adafactor_update",
           "compress_grads", "decompress_grads", "ef_init", "ef_apply"]
