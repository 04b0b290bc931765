"""Checkpointing: one .npy file per array with an atomic JSON manifest.

The on-disk format of the JAX package's `repro.train.checkpoint`, so each
package restores the other's checkpoints:

  * ``step_{step:010d}/`` is written as ``step_{step:010d}.tmp/`` and
    renamed into place (atomic on POSIX), so a crash mid-save never
    corrupts the latest checkpoint;
  * ``leaf_{i:05d}.npy`` per array, in JAX's ``tree_flatten`` order: dict
    keys sorted, lists, tuples and NamedTuples in order (a flat dict is
    sorted-key order);
  * ``manifest.json`` with ``step``, ``time``, ``treedef`` (JAX's
    ``str(treedef)`` for the same tree), ``n_leaves``, ``extra`` and
    ``files[leaf] = {shape, dtype, sha256_16}``; restore verifies every
    checksum before use.

Trees nest dicts, lists, tuples and NamedTuples (the optimizer states) of
numpy arrays or tensors (tensors go through the host). A dtype that .npy
cannot hold, such as bfloat16, is stored as an unsigned-integer view of its
bytes with its own name in the manifest, as JAX's ``_to_native`` stores it;
the views are taken with torch (`Tensor.view`), so no ``ml_dtypes`` is
needed. The training loop writes ``(params, opt_state)`` in JAX's tree
(``models.convert``), so either package resumes the other's run.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "list_checkpoints"]

#: dtypes a .npy file round-trips; others are stored as byte views
_NATIVE = {"float64", "float32", "float16", "int64", "int32", "int16", "int8",
           "uint64", "uint32", "uint16", "uint8", "bool"}
_VIEW = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _key(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _sha256_16(path: str) -> str:
    # the digest of the whole file, read in chunks (the same digest as the
    # JAX module's sha256(f.read()))
    with open(path, "rb") as f:
        return hashlib.file_digest(f, "sha256").hexdigest()[:16]


def _hasher() -> ThreadPoolExecutor:
    """Threads that hash leaf files side by side: sha256 runs at well under
    a GB/s on one core and hashlib releases the GIL, so a 21 GiB
    checkpoint hashes in a few seconds instead of half a minute."""
    return ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree):
    """(leaves in JAX's tree_flatten order, JAX's str(treedef))."""
    leaves = []

    def walk(x) -> str:
        if isinstance(x, dict):
            if not all(isinstance(k, str) for k in x):
                raise TypeError("checkpoint dict keys must be strings")
            return "{" + ", ".join(f"{k!r}: {walk(x[k])}"
                                   for k in sorted(x)) + "}"
        if _is_namedtuple(x):
            return (f"CustomNode(namedtuple[{type(x).__name__}], ["
                    + ", ".join(walk(c) for c in x) + "])")
        if isinstance(x, tuple):
            inner = ", ".join(walk(c) for c in x)
            return "(" + inner + ("," if len(x) == 1 else "") + ")"
        if isinstance(x, list):
            return "[" + ", ".join(walk(c) for c in x) + "]"
        if x is None:
            return "None"
        leaves.append(x)
        return "*"

    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    it = iter(leaves)

    def build(x):
        if isinstance(x, dict):
            return {k: build(x[k]) for k in sorted(x)}
        if _is_namedtuple(x):
            return type(x)(*(build(c) for c in x))
        if isinstance(x, (tuple, list)):
            return type(x)(build(c) for c in x)
        if x is None:
            return None
        return next(it)

    return build(like)


def _host(leaf):
    """(the array .npy stores, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _NATIVE:
            return t.numpy(), name
        size = t.element_size()
        return t.view(_SIGNED[size]).numpy().view(_VIEW[size]), name
    arr = np.asarray(leaf)
    if arr.dtype.name in _NATIVE:
        return arr, arr.dtype.name
    return (np.ascontiguousarray(arr).view(_VIEW[arr.dtype.itemsize]),
            arr.dtype.name)


def _leaf_like(arr: np.ndarray, dtype_name: str, leaf):
    """The stored array as `leaf` is: a CPU tensor of its dtype for a
    tensor template, else a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        if dtype_name in _NATIVE:
            t = torch.from_numpy(arr)
        else:
            size = arr.dtype.itemsize
            t = torch.from_numpy(arr.view(np.dtype(f"int{8 * size}"))).view(
                getattr(torch, dtype_name))
        return t.to(leaf.dtype)
    if dtype_name not in _NATIVE:
        raise TypeError(f"a {dtype_name} leaf restores into a torch.Tensor "
                        f"template only (numpy has no {dtype_name})")
    return arr.astype(np.dtype(leaf.dtype), copy=False)


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Blocking save. Returns the committed checkpoint path."""
    ckpt = os.path.join(directory, f"step_{step:010d}")
    tmp = ckpt + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    leaves, treedef = _flatten(tree)
    manifest = {"step": step, "time": time.time(),
                "treedef": treedef, "n_leaves": len(leaves),
                "extra": extra or {}, "files": {}}
    with _hasher() as pool:               # a leaf hashes while the next saves
        digests = []
        for i, leaf in enumerate(leaves):
            arr, dtype_name = _host(leaf)
            path = os.path.join(tmp, _key(i))
            np.save(path, arr, allow_pickle=False)
            manifest["files"][_key(i)] = {
                "shape": list(arr.shape), "dtype": dtype_name}
            digests.append(pool.submit(_sha256_16, path))
        for i, d in enumerate(digests):
            manifest["files"][_key(i)]["sha256_16"] = d.result()
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


def restore_checkpoint(directory: str, like: Any,
                       step: Optional[int] = None, mmap: bool = False):
    """Restore into the structure of `like`, a tree whose leaves have a
    ``shape`` and a ``dtype`` (arrays, tensors, or any such template),
    after verifying every checksum: CPU tensors where `like` has tensors
    (any device, "meta" too), numpy arrays elsewhere, of `like`'s dtypes.
    With `mmap` a leaf of the stored dtype is a copy-on-write map of its
    file: a reader that keeps a slice of each leaf copies that slice only.

    Returns (tree, extra_dict, step).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    ckpt = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(ckpt, "manifest.json")) as f:
        manifest = json.load(f)
    leaves, _ = _flatten(like)
    assert manifest["n_leaves"] == len(leaves), \
        f"checkpoint has {manifest['n_leaves']} leaves, expected {len(leaves)}"
    paths = [os.path.join(ckpt, _key(i)) for i in range(len(leaves))]
    with _hasher() as pool:               # every checksum, before any use
        digests = list(pool.map(_sha256_16, paths))
    for i, path in enumerate(paths):
        if digests[i] != manifest["files"][_key(i)]["sha256_16"]:
            raise IOError(f"checksum mismatch in {path}")
    out = []
    for i, leaf in enumerate(leaves):
        path = paths[i]
        entry = manifest["files"][_key(i)]
        arr = np.load(path, mmap_mode="c" if mmap else None,
                      allow_pickle=False)
        want_shape = tuple(leaf.shape)
        assert arr.shape == want_shape, (arr.shape, want_shape)
        out.append(_leaf_like(arr, entry["dtype"], leaf))
    return _unflatten(like, out), manifest["extra"], step
