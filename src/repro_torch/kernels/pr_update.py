"""``pr_update``: the Alg. 3 epilogue over pre-reduced in-edge sums.

Rank formula (Eq. 1 or the self-loop closed form Eq. 2), masked write,
DF-P pruning (τ_p), frontier flag δ_N (τ_f) and the L∞ |Δr| in one pass.
`ops.update_ranks_kernel` runs it over the high in-degree slots, whose
sums come from `csr_block_pull`.

On a CUDA tensor the wrapper launches the kernel in `csrc/pr_update.cu`
(which shares its epilogue with `fused_ell_update`); on a CPU tensor it
runs the plain version, `kernels.ref.pr_update_ref`.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import pr_update_ref

__all__ = ["pr_update", "pr_update_plain"]

_SIG = {"pr_update_grid": [_build.I],
        "pr_update": [_build.P] * 8 + [_build.I] + [_build.D] * 4
        + [_build.I, _build.I, _build.P]}

pr_update_plain = pr_update_ref


def pr_update(contrib: torch.Tensor, r: torch.Tensor, out_deg: torch.Tensor,
              affected: torch.Tensor, *, alpha: float = 0.85,
              inv_n: float | None = None, tau_f: float = 1e-6,
              tau_p: float = 1e-6, prune: bool = True,
              closed_form: bool = True):
    """Returns (r_new, affected', delta_n, linf_dr); the flags are {0, 1}
    in `affected`'s dtype. The kernel takes f64 contiguous [n] tensors
    only (pad lanes: r = 1, deg = 1, affected = 0)."""
    n = r.shape[0]
    inv_n = 1.0 / n if inv_n is None else inv_n
    kw = dict(alpha=alpha, inv_n=inv_n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)
    if r.device.type == "cpu":
        return pr_update_plain(contrib, r, out_deg, affected, **kw)
    return _launch(contrib, r, out_deg, affected, **kw)


def _launch(contrib, r, deg, aff, *, alpha, inv_n, tau_f, tau_p, prune,
            closed_form):
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"pr_update: no kernel for device {dev}")
    n = r.shape[0]
    if n == 0:
        raise ValueError("pr_update: empty input")
    for name, t in (("contrib", contrib), ("r", r), ("out_deg", deg),
                    ("affected", aff)):
        _build.check(f"pr_update {name}", t, torch.float64, (n,), dev)
    lib = _build.load("pr_update", _SIG)
    grid = lib.pr_update_grid(n)
    out = torch.empty((3, n), dtype=torch.float64, device=dev)
    partials = torch.empty(grid + 1, dtype=torch.float64, device=dev)
    err = lib.pr_update(
        contrib.data_ptr(), r.data_ptr(), deg.data_ptr(), aff.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        partials.data_ptr(), n, alpha, (1.0 - alpha) * inv_n, tau_f, tau_p,
        int(prune), int(closed_form), _build.stream_ptr(dev))
    _build.launch_error("pr_update", err)
    pr_update.launches += 1
    return out[0], out[1], out[2], partials[grid]


pr_update.launches = 0
