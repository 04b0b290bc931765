"""``scatter_rows``: in-place row scatter for streaming snapshot updates.

A batch Δ^t touches O(|Δ|) rows of an ELL bucket's ``[cap_b, w_b]``
index/mask tables or of the ``[t_cap, tile]`` tile pool; copying the whole
table per batch would bring back the O(|E|) cost the streaming snapshot
exists to avoid. These wrappers write *only* the edited rows, into the
destination itself.

A batch edits up to a few rows of each of several tables (each ELL
bucket's pair, the tile pool's pair, in both halves of the snapshot):
``scatter_rows_batch`` writes all of them in one launch. ``scatter_rows``
(one table) and ``ell_scatter_rows`` (one idx/mask pair) are the JAX
package's entry points, one-table calls of the same kernel.

On a CUDA tensor each wrapper launches the kernel in
`csrc/scatter_rows.cu`; on a CPU tensor it runs the plain version,
``dst.index_copy_(0, rows, new)`` per table, which also writes in place;
on any other device it raises. Duplicate row ids are allowed only when
they carry identical contents. A row id outside ``[0, R)`` raises in the
plain version and writes nothing in the kernel.

Every call counts, on either device, ``kernels.stream_scatter.calls``
(one per table it writes; an (index, mask) pair is one table) and
``kernels.stream_scatter.rows`` (the rows given) in the `obs` registry.
The names are the JAX package's, the meaning is not: there the counters
run while `jit` traces, once per build, with the rows padded to a power
of two, so they say nothing about a batch the cached build scatters.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ..obs.spans import get_registry

__all__ = ["scatter_rows", "ell_scatter_rows", "scatter_rows_batch",
           "scatter_rows_plain", "ell_scatter_rows_plain",
           "scatter_rows_batch_plain"]

_SIG = {"scatter_rows_batch": [_build.I, _build.P, _build.P, _build.P]}
_WORDS = (torch.int32, torch.float32)


def scatter_rows_plain(dst: torch.Tensor, rows: torch.Tensor,
                       new_rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``dst[rows[i]] = new_rows[i]``, in place."""
    return dst.index_copy_(0, rows.long(), new_rows)


def ell_scatter_rows_plain(idx, mask, rows, new_idx, new_mask):
    return (scatter_rows_plain(idx, rows, new_idx),
            scatter_rows_plain(mask, rows, new_mask))


def scatter_rows_batch_plain(tables) -> None:
    """The plain version of `scatter_rows_batch`: the per-table loop."""
    for dst, dst_m, rows, new, new_m in tables:
        scatter_rows_plain(dst, rows, new)
        if dst_m is not None:
            scatter_rows_plain(dst_m, rows, new_m)


def scatter_rows(dst: torch.Tensor, rows: torch.Tensor,
                 new_rows: torch.Tensor) -> torch.Tensor:
    """``dst[rows[i]] = new_rows[i]`` in place; returns ``dst``.

    dst: [R, d] int32 or float32; rows: [K] int32; new_rows: [K, d] of
    dst's dtype, all contiguous on one device."""
    _count(((dst, None, rows, new_rows, None),))
    if dst.device.type == "cpu":
        return scatter_rows_plain(dst, rows, new_rows)
    _launch([(dst, None, rows, new_rows, None)])
    return dst


def ell_scatter_rows(idx: torch.Tensor, mask: torch.Tensor,
                     rows: torch.Tensor, new_idx: torch.Tensor,
                     new_mask: torch.Tensor):
    """Scatter edited (index, mask) row pairs of one layout table in place,
    in one launch: idx [R, d] int32, mask [R, d] float32. Returns
    (idx, mask)."""
    _count(((idx, mask, rows, new_idx, new_mask),))
    if idx.device.type == "cpu":
        return ell_scatter_rows_plain(idx, mask, rows, new_idx, new_mask)
    if idx.dtype != torch.int32 or mask.dtype != torch.float32:
        raise TypeError("ell_scatter_rows: expects int32 idx and float32 "
                        f"mask, got {idx.dtype} and {mask.dtype}")
    _launch([(idx, mask, rows, new_idx, new_mask)])
    return idx, mask


def scatter_rows_batch(tables) -> None:
    """Every table's edited rows in one launch, in place.

    `tables`: a sequence of (dst, dst_mask or None, rows, new_rows,
    new_mask or None): dst [R, d] int32 or float32 (a pair's dst_mask
    [R, d] beside it, sharing its rows), rows [K] int32, new_rows [K, d]
    (and new_mask) of the destination's dtype, all contiguous on one
    device. Tables may differ in R, d, K and dtype."""
    if not tables:
        return
    _count(tables)
    if tables[0][0].device.type == "cpu":
        scatter_rows_batch_plain(tables)
        return
    _launch(tables)


def _count(tables) -> None:
    reg = get_registry()
    reg.inc("kernels.stream_scatter.calls", len(tables))
    reg.inc("kernels.stream_scatter.rows", sum(t[2].shape[0] for t in tables))


def _launch(tables):
    dev = tables[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"scatter_rows: no kernel for device {dev}")
    ptrs, ints = [], []
    for dst, dst_m, rows, new, new_m in tables:
        if dst.dtype not in _WORDS:
            raise TypeError(f"scatter_rows: no kernel for dtype {dst.dtype}")
        if dst.dim() != 2:
            raise ValueError("scatter_rows: dst must be [R, d]")
        n_rows, d = dst.shape
        k = rows.shape[0]
        _build.check("scatter_rows rows", rows, torch.int32, (k,), dev)
        pair = ((dst, new),) if dst_m is None else ((dst, new),
                                                    (dst_m, new_m))
        for t, t_new in pair:
            if t.dtype not in _WORDS:
                raise TypeError(f"scatter_rows: no kernel for dtype "
                                f"{t.dtype}")
            _build.check("scatter_rows dst", t, t.dtype, (n_rows, d), dev)
            _build.check("scatter_rows new_rows", t_new, t.dtype, (k, d),
                         dev)
        if k == 0 or d == 0:
            continue
        ptrs += [dst.data_ptr(), new.data_ptr(),
                 0 if dst_m is None else dst_m.data_ptr(),
                 0 if dst_m is None else new_m.data_ptr(), rows.data_ptr()]
        ints += [n_rows, k, d]
    if not ints:
        return
    lib = _build.load("scatter_rows", _SIG)
    err = lib.scatter_rows_batch(
        len(ints) // 3, (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(ints))(*ints), _build.stream_ptr(dev))
    _build.launch_error("scatter_rows", err)
    scatter_rows.launches += 1


scatter_rows.launches = 0
