"""``scatter_rows``: in-place row scatter for streaming snapshot updates.

A batch Δ^t touches O(|Δ|) rows of an ELL bucket's ``[cap_b, w_b]``
index/mask tables or of the ``[t_cap, tile]`` tile pool; copying the whole
table per batch would bring back the O(|E|) cost the streaming snapshot
exists to avoid. These wrappers write *only* the edited rows, into the
destination itself.

On a CUDA tensor the wrapper launches the kernel in `csrc/scatter_rows.cu`
(one launch scatters an idx/mask pair together); on a CPU tensor it runs
the plain version, ``dst.index_copy_(0, rows, new)``, which also writes in
place; on any other device it raises. Duplicate row ids are allowed only
when they carry identical contents. A row id outside ``[0, R)`` raises in
the plain version and writes nothing in the kernel.
"""
from __future__ import annotations

import torch

from . import _build

__all__ = ["scatter_rows", "ell_scatter_rows", "scatter_rows_plain",
           "ell_scatter_rows_plain"]

_ROW = [_build.P] * 3 + [_build.I] * 3 + [_build.P]
_SIG = {"scatter_rows_i32": _ROW, "scatter_rows_f32": _ROW,
        "ell_scatter_rows": [_build.P] * 5 + [_build.I] * 3 + [_build.P]}
_ENTRY = {torch.int32: "scatter_rows_i32", torch.float32: "scatter_rows_f32"}


def scatter_rows_plain(dst: torch.Tensor, rows: torch.Tensor,
                       new_rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``dst[rows[i]] = new_rows[i]``, in place."""
    return dst.index_copy_(0, rows.long(), new_rows)


def ell_scatter_rows_plain(idx, mask, rows, new_idx, new_mask):
    return (scatter_rows_plain(idx, rows, new_idx),
            scatter_rows_plain(mask, rows, new_mask))


def scatter_rows(dst: torch.Tensor, rows: torch.Tensor,
                 new_rows: torch.Tensor) -> torch.Tensor:
    """``dst[rows[i]] = new_rows[i]`` in place; returns ``dst``.

    dst: [R, d] int32 or float32; rows: [K] int32; new_rows: [K, d] of
    dst's dtype, all contiguous on one device."""
    if dst.device.type == "cpu":
        return scatter_rows_plain(dst, rows, new_rows)
    _launch(_ENTRY.get(dst.dtype), (dst,), rows, (new_rows,))
    return dst


def ell_scatter_rows(idx: torch.Tensor, mask: torch.Tensor,
                     rows: torch.Tensor, new_idx: torch.Tensor,
                     new_mask: torch.Tensor):
    """Scatter edited (index, mask) row pairs of one layout table in place,
    in one launch: idx [R, d] int32, mask [R, d] float32. Returns
    (idx, mask)."""
    if idx.device.type == "cpu":
        return ell_scatter_rows_plain(idx, mask, rows, new_idx, new_mask)
    if idx.dtype != torch.int32 or mask.dtype != torch.float32:
        raise TypeError("ell_scatter_rows: expects int32 idx and float32 "
                        f"mask, got {idx.dtype} and {mask.dtype}")
    _launch("ell_scatter_rows", (idx, mask), rows, (new_idx, new_mask))
    return idx, mask


def _launch(entry, dsts, rows, news):
    dev = dsts[0].device
    if dev.type != "cuda":
        raise ValueError(f"scatter_rows: no kernel for device {dev}")
    if entry is None:
        raise TypeError(f"scatter_rows: no kernel for dtype {dsts[0].dtype}")
    if dsts[0].dim() != 2:
        raise ValueError("scatter_rows: dst must be [R, d]")
    n_rows, d = dsts[0].shape
    k = rows.shape[0]
    _build.check("scatter_rows rows", rows, torch.int32, (k,), dev)
    for dst, new in zip(dsts, news):
        _build.check("scatter_rows dst", dst, dst.dtype, (n_rows, d), dev)
        _build.check("scatter_rows new_rows", new, dst.dtype, (k, d), dev)
    if k == 0 or d == 0:
        return
    lib = _build.load("scatter_rows", _SIG)
    # C order: the destination(s), the row ids, the new rows
    ptrs = ([t.data_ptr() for t in dsts] + [rows.data_ptr()]
            + [t.data_ptr() for t in news])
    err = getattr(lib, entry)(*ptrs, n_rows, k, d, _build.stream_ptr(dev))
    _build.launch_error("scatter_rows", err)
    scatter_rows.launches += 1


scatter_rows.launches = 0
