"""``linf_delta``: max |a - b| over two vectors — the paper's
convergence-detection kernel pair (block partials, then one final
reduction).

The staged sweep takes its L∞ delta from here (`core.pagerank.update_ranks`
with `pull_sum_fn=`): the same value `core.rank_step` computes as
``max |r_new - r|``, by the ported kernel. On a CUDA tensor the wrapper
launches the two stages in `csrc/linf_delta.cu`; on a CPU tensor it runs
the plain version, `kernels.ref.linf_delta_ref`; on any other device it
raises. NaN wins in both, so a NaN rank reaches the health word.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import linf_delta_ref

__all__ = ["linf_delta", "linf_delta_plain"]

_SIG = {"linf_delta_max_grid": [_build.I],
        "linf_delta": [_build.P] * 2 + [_build.I] * 2 + [_build.P] * 2}

linf_delta_plain = linf_delta_ref

# stage 1's grid per device index (SMs x resident blocks), taken once
_max_grid: dict = {}


def linf_delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max_i |a[i] - b[i]| as a 0-d tensor on a's device (never read on
    the host here). a, b: [n] float64, n >= 1."""
    if a.device.type == "cpu":
        return linf_delta_plain(a, b)
    return _launch(a, b)


def _launch(a, b):
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"linf_delta: no kernel for device {dev}")
    if a.dim() != 1 or a.shape[0] == 0:
        raise ValueError(f"linf_delta: expects a non-empty vector, got "
                         f"shape {tuple(a.shape)}")
    n = a.shape[0]
    pa, pb = a.data_ptr(), b.data_ptr()
    # what `_build.check` asks of both, in one expression; it names the
    # fault when one fails
    if not (a.dtype == b.dtype == torch.float64 and b.shape == a.shape
            and b.device == dev and a.is_contiguous() and b.is_contiguous()
            and (pa | pb) % 8 == 0):
        _build.check("linf_delta a", a, torch.float64, (n,), dev)
        _build.check("linf_delta b", b, torch.float64, (n,), dev)
    lib = _build.load("linf_delta", _SIG)
    cap = _max_grid.get(dev.index)
    if cap is None:
        cap = _max_grid[dev.index] = lib.linf_delta_max_grid(dev.index)
        if cap < 1:
            raise RuntimeError(f"linf_delta: no grid for device {dev}")
    partials = torch.empty(cap + 1, dtype=torch.float64, device=dev)
    err = lib.linf_delta(pa, pb, n, cap, partials.data_ptr(),
                         _build.stream_ptr(dev))
    _build.launch_error("linf_delta", err)
    linf_delta.launches += 1
    return partials[cap]


linf_delta.launches = 0
