"""Checkpointing: one .npy file per array with an atomic JSON manifest.

The on-disk format of the JAX package's `repro.train.checkpoint`, so each
package restores the other's checkpoints:

  * ``step_{step:010d}/`` is written as ``step_{step:010d}.tmp/`` and
    renamed into place (atomic on POSIX), so a crash mid-save never
    corrupts the latest checkpoint;
  * ``leaf_{i:05d}.npy`` per array, in sorted-key order (JAX's
    ``tree_flatten`` order for a dict);
  * ``manifest.json`` with ``step``, ``time``, ``treedef``, ``n_leaves``,
    ``extra`` and ``files[leaf] = {shape, dtype, sha256_16}``; restore
    verifies every checksum before use.

The port's trees are flat ``{name: array}`` dicts of numpy arrays or
tensors (tensors go through ``.cpu().numpy()``), which is what the guard's
session checkpoints need; model trees come with ROADMAP A9.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints"]

#: dtypes a .npy file round-trips (the JAX module stores others, such as
#: bfloat16, as byte views; the port's flat trees hold none yet)
_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16", "int8",
           "uint64", "uint32", "uint16", "uint8", "bool"}


def _key(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _sha256_16(path: str) -> str:
    # the digest of the whole file, read in chunks (the same digest as the
    # JAX module's sha256(f.read()))
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()[:16]


def _flatten(tree: dict):
    if not isinstance(tree, dict) or not all(isinstance(k, str)
                                             for k in tree):
        raise TypeError("a checkpoint tree is a flat {name: array} dict")
    keys = sorted(tree)
    return keys, [tree[k] for k in keys]


def _treedef(keys) -> str:
    # JAX writes str(treedef); for a flat dict that is this string, so the
    # two packages' manifests read the same (restore takes the structure
    # from `like` in both, not from this field)
    return "PyTreeDef({" + ", ".join(f"{k!r}: *" for k in keys) + "})"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name not in _NATIVE:
        raise TypeError(f"checkpoint leaf of dtype {arr.dtype} is not "
                        f"supported yet (ROADMAP A9)")
    return arr


def save_checkpoint(directory: str, step: int, tree: dict,
                    extra: Optional[dict] = None) -> str:
    """Blocking save. Returns the committed checkpoint path."""
    ckpt = os.path.join(directory, f"step_{step:010d}")
    tmp = ckpt + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    keys, leaves = _flatten(tree)
    manifest = {"step": step, "time": time.time(),
                "treedef": _treedef(keys), "n_leaves": len(leaves),
                "extra": extra or {}, "files": {}}
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        path = os.path.join(tmp, _key(i))
        np.save(path, arr, allow_pickle=False)
        manifest["files"][_key(i)] = {
            "shape": list(arr.shape), "dtype": arr.dtype.name,
            "sha256_16": _sha256_16(path)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(ckpt):
        shutil.rmtree(ckpt)
    os.rename(tmp, ckpt)      # atomic commit
    return ckpt


def list_checkpoints(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                steps.append(int(name[5:]))
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = list_checkpoints(directory)
    return steps[-1] if steps else None


def restore_checkpoint(directory: str, like: dict,
                       step: Optional[int] = None):
    """Restore into the structure of `like`, a flat dict whose values have
    numpy ``shape`` and ``dtype`` (arrays, or any such template), after
    verifying every checksum: numpy arrays of those dtypes.

    Returns (tree, extra_dict, step).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    keys, leaves = _flatten(like)
    assert manifest["n_leaves"] == len(leaves), \
        f"checkpoint has {manifest['n_leaves']} leaves, expected {len(leaves)}"
    out = {}
    for i, (key, leaf) in enumerate(zip(keys, leaves)):
        path = os.path.join(ckpt, _key(i))
        if _sha256_16(path) != manifest["files"][_key(i)]["sha256_16"]:
            raise IOError(f"checksum mismatch in {path}")
        arr = np.load(path, allow_pickle=False)
        want_shape = tuple(leaf.shape)
        assert arr.shape == want_shape, (arr.shape, want_shape)
        out[key] = arr.astype(np.dtype(leaf.dtype), copy=False)
    return out, manifest["extra"], step
