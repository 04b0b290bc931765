"""``ell_pull``: the pull-only masked gather row-sum over the ELL tables
(the paper's thread-per-vertex kernel for low in-degree vertices).

    out[row] = sum_j c[idx[row, j]] * mask[row, j]

Two entries run the kernel in `csrc/ell_pull.cu`:

* ``ell_pull_buckets(c, buckets)``: every bucket of the staged sweep in one
  launch, each slot's sum written at its row id through the bucket's row
  map (`ell_bucket_pull`, then `ops.pull_sum_kernels`); a slot whose row
  is the sentinel ``n`` writes nothing;
* ``ell_pull(c, idx, mask)``: one bucket's table, the counterpart of the
  JAX kernel; the same body with the identity map, so the two agree bit
  for bit.

The gather body (`csrc/ell_gather.cuh`) is shared with `fused_ell_update`;
`gather_plan.ell_plan` picks its instantiation for a bucket.
`ell_pull.launches` counts the kernels started (one per call, unless a
layout holds more buckets than one launch takes). On a CUDA tensor each
wrapper launches the kernel; on a CPU tensor it runs its plain version
(`kernels.ref.ell_pull_ref`, and the JAX package's glue around it for the
buckets); on any other device it raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .gather_plan import aligned16, ell_kind
from .ref import ell_pull_ref

__all__ = ["ell_pull", "ell_pull_plain", "ell_pull_buckets",
           "ell_pull_buckets_plain", "bucket_ints"]

_COUNT = ctypes.POINTER(ctypes.c_int)
_SIG = {"ell_pull": [_build.P] * 4 + [_build.I] * 3 + [_COUNT, _build.P],
        "ell_pull_buckets": [_build.P, _build.I, _build.P, _build.P,
                             _build.P, _build.I, _COUNT, _build.P]}

ell_pull_plain = ell_pull_ref


def bucket_ints(name, dev, idx, mask, count=None):
    """(work lanes, cap, width, plan kind) of one bucket's table, the ints
    the C entries take per bucket, after checking the table on `dev`."""
    if idx.dim() != 2 or idx.shape[0] == 0 or idx.shape[1] == 0:
        raise ValueError(f"{name}: bad slot table {tuple(idx.shape)}")
    cap, width = idx.shape
    _build.check(f"{name} idx", idx, torch.int32, (cap, width), dev)
    _build.check(f"{name} mask", mask, torch.float32, (cap, width), dev)
    kind = ell_kind(width, aligned16(idx.data_ptr(), mask.data_ptr()))
    return (cap if count is None else count, cap, width, kind)


def ell_pull(c: torch.Tensor, idx: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """out[row] = sum_j c[idx[row, j]] * mask[row, j], shape [rows].

    c: [n] contributions; idx: [rows, w] int32 ids into c; mask: [rows, w]
    float32. Every slot counts, padding included (mask 0 there), so a NaN
    in c reaches each row whose table names it."""
    if c.device.type == "cpu":
        return ell_pull_plain(c, idx, mask)
    return _launch(c, idx, mask)


def ell_pull_buckets_plain(c: torch.Tensor, buckets,
                           n_rows: Optional[int] = None) -> torch.Tensor:
    """The plain version of `ell_pull_buckets`: the JAX package's glue
    around `ell_pull_ref` (sums added through each row map into a sink row
    n), the sink row then cleared."""
    out = c.new_zeros((c.shape[0] if n_rows is None else n_rows) + 1)
    for blk in buckets:
        out.index_add_(0, blk.rows, ell_pull_ref(c, blk.idx, blk.mask))
    out[-1] = 0.0
    return out


def ell_pull_buckets(c: torch.Tensor, buckets,
                     n_rows: Optional[int] = None) -> torch.Tensor:
    """out[blk.rows[s]] = sum_j c[blk.idx[s, j]] * blk.mask[s, j] over every
    bucket's slots, shape [n + 1] (n = `n_rows`, default len(c)): rows in
    no bucket and the sink row n stay 0, so a caller may add
    sentinel-indexed sums there. A shard's layout names `n_rows` local
    rows (sentinel n_rows) and ids into the gathered `c` of every shard.
    Each vertex lives in at most one bucket slot, so no two sums meet. On
    CUDA: one zero fill and one launch."""
    if c.device.type == "cpu":
        return ell_pull_buckets_plain(c, buckets, n_rows)
    return _launch_buckets(c, buckets, n_rows)


def _launch(c, idx, mask):
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"ell_pull: no kernel for device {dev}")
    ints = bucket_ints("ell_pull", dev, idx, mask)
    _build.check("ell_pull c", c, torch.float64, (c.shape[0],), dev)
    out = torch.empty(ints[1], dtype=torch.float64, device=dev)
    lib = _build.load("ell_pull", _SIG)
    launched = ctypes.c_int(0)
    err = lib.ell_pull(c.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                       out.data_ptr(), *ints[1:], ctypes.byref(launched),
                       _build.stream_ptr(dev))
    _build.launch_error("ell_pull", err)
    ell_pull.launches += launched.value
    return out


def _launch_buckets(c, buckets, n_rows):
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"ell_pull_buckets: no kernel for device {dev}")
    _build.check("ell_pull_buckets c", c, torch.float64, (c.shape[0],), dev)
    n = c.shape[0] if n_rows is None else int(n_rows)
    out = torch.zeros(n + 1, dtype=torch.float64, device=dev)
    if not buckets:
        return out
    ptrs, ints = [], []
    for blk in buckets:
        b = bucket_ints("ell_pull_buckets", dev, blk.idx, blk.mask)
        _build.check("ell_pull_buckets rows", blk.rows, torch.int32, (b[1],),
                     dev)
        ptrs += [blk.rows.data_ptr(), blk.idx.data_ptr(),
                 blk.mask.data_ptr(), 0]
        ints += b
    lib = _build.load("ell_pull", _SIG)
    launched = ctypes.c_int(0)
    err = lib.ell_pull_buckets(
        c.data_ptr(), len(buckets), (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(ints))(*ints), out.data_ptr(), n,
        ctypes.byref(launched), _build.stream_ptr(dev))
    _build.launch_error("ell_pull_buckets", err)
    ell_pull.launches += launched.value
    return out


ell_pull.launches = 0
