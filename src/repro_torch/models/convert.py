"""Carry weights from the JAX package into the port.

`params_from_jax(tree, cfg)` takes the JAX package's `init_params` pytree
with numpy leaves and returns a state dict for `transformer.LMParams`
(`model.params.load_state_dict(...)`). It unstacks the JAX package's
`pattern` axis (one slice per repeat) into the port's one block per
layer, in layer order, and keeps every leaf as it is: the same layouts,
the same dtype, RMSNorm weights as "scale − 1". A leaf missing from the
tree, an extra one, or one of another shape raises, so that a test that
carries weights computes the same function in both packages.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import transformer as tfm

__all__ = ["params_from_jax"]


def _flat(prefix: str, d: dict, out: Dict[str, np.ndarray]) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}.", v, out)
        else:
            out[prefix + k] = np.asarray(v)


def params_from_jax(tree: dict, cfg) -> Dict[str, torch.Tensor]:
    """{state-dict key: CPU tensor} for `LMParams` of `cfg`."""
    pre, pat, reps, suf = cfg.layer_kinds()
    flat: Dict[str, np.ndarray] = {}
    _flat("", {k: tree[k] for k in ("embed", "unembed", "lnf")}, flat)
    layers = list(tree["prefix"])
    for r in range(reps):
        for group in tree["pattern"]:
            layers.append({name: {leaf: np.asarray(a)[r]
                                  for leaf, a in sub.items()}
                           for name, sub in group.items()})
    layers += list(tree["suffix"])
    if len(tree["pattern"]) != len(pat) or len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree has {len(layers)} layers, "
                         f"the config {cfg.n_layers}")
    for i, block in enumerate(layers):
        _flat(f"blocks.{i}.", block, flat)
    want = tfm.init_params(cfg, generator=torch.Generator(),
                           device="meta").state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: leaves missing {missing}, extra "
                         f"{extra}")
    out = {}
    for k, t in want.items():
        a = flat[k]
        if a.dtype.name == "bfloat16":    # ml_dtypes: widen exactly first
            a = a.astype(np.float32)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{cfg.name}: {k} has shape {a.shape}, the "
                             f"port {tuple(t.shape)}")
        out[k] = torch.from_numpy(np.array(a)).to(t.dtype)   # a copy
    return out
