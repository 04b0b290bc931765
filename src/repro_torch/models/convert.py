"""Carry weights and optimizer states between the JAX package and the port.

The JAX package stacks its repeated `pattern` of layers on a leading axis
(one slice per repeat); the port holds one block per layer, in layer
order, under `LMParams.state_dict()` keys ("blocks.{i}.mix.wq", ...;
a nested leaf as its path, "blocks.{i}.mix.mu.r"). Every leaf keeps its
layout and dtype (RWKV's and RG-LRU's f32 leaves stay f32 in a bf16
model), RMSNorm weights as "scale − 1".

- `params_from_jax(tree, cfg)`: the JAX `init_params` pytree with numpy
  leaves -> a state dict for `LMParams` (`load_state_dict`). A leaf
  missing from the tree, an extra one, or one of another shape raises, so
  that a test that carries weights computes the same function in both
  packages;
- `params_to_jax(state_dict, cfg)`: the inverse, a JAX tree of numpy
  arrays (bf16 leaves widened exactly to f32: numpy has no bfloat16 of its
  own; `jnp.asarray(a, jnp.bfloat16)` narrows them back exactly);
- `opt_state_from_jax` / `opt_state_to_jax`: the same for `AdamWState`
  and `AdafactorState`. AdamW's dicts are keyed like the weights (its
  update is element-wise, so the stacking changes nothing but the order of
  the global norm's sum). Adafactor's are keyed by the JAX tree's paths
  ("pattern.0.mix.wq", ...) and hold stacked leaves (`jax_paths`): its
  factored moments and its update clipping span a whole stacked leaf, the
  layer axis included, so only that grouping computes JAX's update;
- `jax_tree(flat, cfg)`: any dict keyed like the weights in the JAX
  tree's structure, its leaves stacked as they are (tensors stay
  tensors): the tree the training loop checkpoints; `opt_tree` does the
  same for an optimizer state.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ..optim import AdafactorState, AdamWState
from . import transformer as tfm

__all__ = ["params_from_jax", "params_to_jax", "opt_state_from_jax",
           "opt_state_to_jax", "jax_tree", "unstack_jax_tree", "jax_paths",
           "unstack_paths", "opt_tree"]

_STATES = {("step", "m", "v"): AdamWState,
           ("step", "vr", "vc"): AdafactorState}


def _flat(prefix: str, d: dict, out: dict) -> None:
    for k, v in d.items():
        if isinstance(v, dict):
            _flat(f"{prefix}{k}.", v, out)
        else:
            out[prefix + k] = v


def _layer_ids(cfg):
    """(prefix layer ids, [pattern slot j -> its layer ids in repeat
    order], suffix layer ids), in the port's one-block-per-layer order."""
    pre, pat, reps, suf = cfg.layer_kinds()
    n_pre, n_pat = len(pre), len(pat)
    first_suf = n_pre + reps * n_pat
    return (list(range(n_pre)),
            [[n_pre + r * n_pat + j for r in range(reps)]
             for j in range(n_pat)],
            list(range(first_suf, first_suf + len(suf))))


def _slice(tree, r):
    """Repeat r of a stacked (possibly nested) dict of leaves."""
    if isinstance(tree, dict):
        return {k: _slice(v, r) for k, v in tree.items()}
    return tree[r]


def _stack(trees: list, stack: Callable):
    """The inverse of `_slice`: leaves stacked over the repeats."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees], stack) for k in trees[0]}
    return stack(trees)


def unstack_jax_tree(tree: dict, cfg) -> dict:
    """A JAX tree keyed like `init_params` (the weights, or an optimizer
    state's dict of them) -> {state-dict key: leaf}, the pattern axis
    split into one block per layer (numpy, JAX or torch leaves; a pattern
    leaf's slices are views)."""
    pre, pat, reps, suf = cfg.layer_kinds()
    flat: dict = {}
    _flat("", {k: tree[k] for k in ("embed", "unembed", "lnf")}, flat)
    layers = list(tree.get("prefix", []))
    # (a pattern repeated 0 times may have no entry: it holds no leaf)
    pattern = tree.get("pattern", [])
    for r in range(reps):
        for group in pattern:
            layers.append(_slice(group, r))
    layers += list(tree.get("suffix", []))
    if (reps and len(pattern) != len(pat)) or len(layers) != cfg.n_layers:
        raise ValueError(f"{cfg.name}: the tree has {len(layers)} layers, "
                         f"the config {cfg.n_layers}")
    for i, block in enumerate(layers):
        _flat(f"blocks.{i}.", block, flat)
    return flat


def jax_tree(flat: dict, cfg, stack: Callable = torch.stack) -> dict:
    """`flat` ({state-dict key: leaf}) in the JAX tree's structure: embed,
    unembed, lnf, prefix and suffix blocks as they are, each pattern slot's
    leaves stacked over its repeats with `stack` (`np.stack` for numpy
    leaves)."""
    pre_ids, pat_ids, suf_ids = _layer_ids(cfg)

    def block(i):
        out: dict = {}
        head = f"blocks.{i}."
        for key, leaf in flat.items():
            if key.startswith(head):
                *groups, name = key[len(head):].split(".")
                node = out
                for g in groups:
                    node = node.setdefault(g, {})
                node[name] = leaf
        return out

    tree = {"embed": flat["embed"], "unembed": flat["unembed"],
            "lnf": {k[4:]: v for k, v in flat.items()
                    if k.startswith("lnf.")},
            "prefix": [block(i) for i in pre_ids],
            "suffix": [block(i) for i in suf_ids], "pattern": []}
    for ids in pat_ids:
        # a pattern repeated 0 times (a model cut to its prefix) has no leaf
        tree["pattern"].append(_stack([block(i) for i in ids], stack)
                               if ids else {})
    return tree


def _paths(tree, prefix: str = "", out=None) -> dict:
    """A JAX tree of dicts and lists -> {"a.0.b": leaf}."""
    out = {} if out is None else out
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        out[prefix[:-1]] = tree
        return out
    for k, v in items:
        _paths(v, f"{prefix}{k}.", out)
    return out


def _nest(paths: dict) -> dict:
    """{"a.0.b": leaf} -> the JAX model tree of dicts and lists (a numeric
    part is a list index; no path names an empty prefix or suffix)."""
    root: dict = {"prefix": [], "suffix": []}
    for path, leaf in paths.items():
        parts = path.split(".")
        node = root
        for part, nxt in zip(parts, parts[1:]):
            child = [] if nxt.isdigit() else {}
            if isinstance(node, list):
                i = int(part)
                node.extend([None] * (i + 1 - len(node)))
                node[i] = child if node[i] is None else node[i]
                node = node[i]
            else:
                node = node.setdefault(part, child)
        node[parts[-1]] = leaf
    return root


def jax_paths(flat: dict, cfg, stack: Callable = torch.stack) -> dict:
    """`flat` (keyed like the weights) as {JAX tree path: leaf}, the
    pattern's leaves stacked: the grouping of Adafactor's state."""
    return _paths(jax_tree(flat, cfg, stack))


def unstack_paths(paths: dict, cfg) -> dict:
    """The inverse of `jax_paths`: keyed like the weights (views)."""
    return unstack_jax_tree(_nest(paths), cfg)


def opt_tree(state, cfg, leaf: Callable = lambda t: t,
             stack: Callable = torch.stack):
    """An optimizer state of the port as the JAX package's: the same
    NamedTuple, `leaf` applied to every tensor, each dict in the JAX
    tree's structure (AdamW's stacked from its per-layer keys, Adafactor's
    nested from its paths)."""
    def tree(d):
        d = {k: leaf(v) for k, v in d.items()}
        if isinstance(state, AdafactorState):
            return _nest(d)
        return jax_tree(d, cfg, stack)

    return type(state)(leaf(state.step), *(tree(d) for d in state[1:]))


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_jax(tree: dict, cfg) -> Dict[str, torch.Tensor]:
    """{state-dict key: CPU tensor} for `LMParams` of `cfg`."""
    flat = unstack_jax_tree(tree, cfg)
    want = tfm.init_params(cfg, generator=torch.Generator(),
                           device="meta").state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: leaves missing {missing}, extra "
                         f"{extra}")
    out = {}
    for k, t in want.items():
        a = np.asarray(flat[k])
        if a.dtype.name == "bfloat16":    # ml_dtypes: widen exactly first
            a = a.astype(np.float32)
        if tuple(a.shape) != tuple(t.shape):
            raise ValueError(f"{cfg.name}: {k} has shape {a.shape}, the "
                             f"port {tuple(t.shape)}")
        out[k] = torch.from_numpy(np.array(a)).to(t.dtype)   # a copy
    return out


def params_to_jax(state_dict: dict, cfg) -> dict:
    """The JAX package's `init_params` tree of numpy arrays for a state
    dict of `LMParams` (bf16 leaves as exact f32)."""
    return jax_tree({k: _numpy(v) for k, v in state_dict.items()}, cfg,
                    np.stack)


def opt_state_to_jax(state, cfg):
    """An `AdamWState`/`AdafactorState` of the port -> the same NamedTuple
    with numpy leaves in the JAX tree's structure (`JAXState(*result)`
    gives the JAX package's state)."""
    return opt_tree(state, cfg, _numpy, np.stack)


def opt_state_from_jax(state, cfg, device=None):
    """The JAX package's `AdamWState`/`AdafactorState` (numpy, JAX or
    torch leaves, in its tree) -> the port's: f32 tensors on `device`
    (the CPU unless named), keyed as `opt_tree` says."""
    kind = _STATES.get(tuple(state._fields))
    if kind is None:
        raise TypeError(f"not an optimizer state: fields {state._fields}")
    split = _paths if kind is AdafactorState else (
        lambda d: unstack_jax_tree(d, cfg))

    def tensor(v):
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v, dtype=np.float32))
        return v.to(device=device, dtype=torch.float32)

    step = torch.tensor(int(np.asarray(state.step)), dtype=torch.int32)
    return kind(step.to(device),
                *({k: tensor(v) for k, v in split(d).items()}
                  for d in state[1:]))
