"""``ell_pull``: the pull-only masked gather row-sum over one ELL table
(the paper's thread-per-vertex kernel for low in-degree vertices).

    out[row] = sum_j c[idx[row, j]] * mask[row, j]

The staged sweep runs it once per degree bucket (`ell_bucket_pull`, then
`ops.pull_sum_kernels`). On a CUDA tensor the wrapper launches the kernel
in `csrc/ell_pull.cu`, which shares its gather body with
`fused_ell_update`; on a CPU tensor it runs the plain version,
`kernels.ref.ell_pull_ref`; on any other device it raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import ell_pull_ref

__all__ = ["ell_pull", "ell_pull_plain", "lanes_for"]

_SIG = {"ell_pull": [_build.P] * 4 + [_build.I] * 3 + [_build.P]}

ell_pull_plain = ell_pull_ref


def lanes_for(width: int) -> int:
    """Threads per row of both ELL kernels (`ell_pull`,
    `fused_ell_update`): one for the narrowest buckets (the paper's
    thread-per-vertex kernel), else a sub-warp of the largest power of two
    up to min(width, 32), which divides the warp."""
    if width <= 2:
        return 1
    lanes = 1
    while lanes * 2 <= min(width, 32):
        lanes *= 2
    return lanes


def ell_pull(c: torch.Tensor, idx: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """out[row] = sum_j c[idx[row, j]] * mask[row, j], shape [rows].

    c: [n] contributions; idx: [rows, w] int32 ids into c; mask: [rows, w]
    float32. Every slot counts, padding included (mask 0 there), so a NaN
    in c reaches each row whose table names it."""
    if c.device.type == "cpu":
        return ell_pull_plain(c, idx, mask)
    return _launch(c, idx, mask)


def _launch(c, idx, mask):
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"ell_pull: no kernel for device {dev}")
    if idx.dim() != 2 or idx.shape[0] == 0 or idx.shape[1] == 0:
        raise ValueError(f"ell_pull: bad slot table {tuple(idx.shape)}")
    rows, width = idx.shape
    _build.check("ell_pull c", c, torch.float64, (c.shape[0],), dev)
    _build.check("ell_pull idx", idx, torch.int32, (rows, width), dev)
    _build.check("ell_pull mask", mask, torch.float32, (rows, width), dev)
    out = torch.empty(rows, dtype=torch.float64, device=dev)
    lib = _build.load("ell_pull", _SIG)
    err = lib.ell_pull(c.data_ptr(), idx.data_ptr(), mask.data_ptr(),
                       out.data_ptr(), rows, width, lanes_for(width),
                       _build.stream_ptr(dev))
    _build.launch_error("ell_pull", err)
    ell_pull.launches += 1
    return out


ell_pull.launches = 0
