"""The degree-bucketed ELL low side: the pull-only ``ell_bucket_pull`` of
the staged sweep, and ``fused_ell_update``, one bucket's pull and
``updateRanks`` epilogue in one pass.

``ell_bucket_pull`` runs the `ell_pull` kernel once per bucket at that
bucket's width and adds the per-slot sums into the result through the
bucket's row map (sentinel ids land in a sink row that is sliced off,
where the JAX package drops them).

For ``fused_ell_update`` one kernel instance gathers a bucket's in-edge
contributions AND applies the Alg. 3 epilogue (Eq. 1 / Eq. 2, DF-P
pruning, δ_N, L∞ partials) before writing, so each rank is written once
per sweep and no `contrib [n]` vector makes a round trip through device
memory. On a CUDA tensor the wrapper launches the kernel in
`csrc/fused_ell_update.cu`; on a CPU tensor it runs the plain version
(`kernels.ref.ell_pull_ref` then `kernels.ref.pr_update_ref`).

Padding discipline: lanes past a bucket's live slots carry r = 1, deg = 1,
aff = 0, mask = 0 — contrib 0, rank unchanged, |Δr| = 0 — so they are
inert in every output, and the caller's sentinel row ids drop their
writes.
"""
from __future__ import annotations

import torch

from . import _build
from .ell_pull import ell_pull, lanes_for
from .ref import ell_pull_ref, pr_update_ref
from ..sentinel import take_fill

__all__ = ["ell_bucket_pull", "bucket_sums", "fused_ell_update",
           "fused_ell_update_plain", "lanes_for"]

_SIG = {"fused_ell_update_grid": [_build.I, _build.I],
        "fused_ell_update": [_build.P] * 10 + [_build.I] * 3
        + [_build.D] * 4 + [_build.I, _build.I, _build.P]}


def bucket_sums(c: torch.Tensor, buckets) -> torch.Tensor:
    """`ell_bucket_pull` with its sink row: shape [n + 1], row n holding
    whatever the sentinel ids added."""
    out = c.new_zeros(c.shape[0] + 1)
    for blk in buckets:
        out.index_add_(0, blk.rows, ell_pull(c, blk.idx, blk.mask))
    return out


def ell_bucket_pull(c: torch.Tensor, buckets) -> torch.Tensor:
    """out[blk.rows[s]] = sum_j c[blk.idx[s, j]] * blk.mask[s, j] over
    every bucket, shape [n]; rows in no bucket stay 0. Each vertex lives
    in at most one bucket slot, so no two sums meet."""
    return bucket_sums(c, buckets)[:c.shape[0]]


def fused_ell_update_plain(c, idx, mask, r_rows, deg_rows, aff_rows, *,
                           alpha, inv_n, tau_f, tau_p, prune, closed_form):
    """The plain PyTorch version: masked gather row-sum, then the epilogue."""
    return pr_update_ref(ell_pull_ref(c, idx, mask), r_rows, deg_rows,
                         aff_rows, alpha=alpha, inv_n=inv_n, tau_f=tau_f,
                         tau_p=tau_p, prune=prune, closed_form=closed_form)


def fused_ell_update(c: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                     r_rows: torch.Tensor, deg_rows: torch.Tensor,
                     aff_rows: torch.Tensor, *, alpha: float, inv_n: float,
                     tau_f: float, tau_p: float, prune: bool,
                     closed_form: bool, active: torch.Tensor | None = None):
    """One-pass pull + updateRanks over one bucket's slot table.

    c: [n] contributions; idx/mask: [cap_b, w_b]; r/deg/aff: [cap_b]
    operands pre-gathered at the bucket's row ids (sentinel lanes carry
    r=1, deg=1, aff=0). Returns per-slot (r_new, affected', delta_n,
    linf_dr scalar) — the caller scatters the first three back through
    the row-id map.

    With `active` (a compacted [k] active-slot list, sentinel == cap_b —
    core.frontier.ActiveFrontier) all five per-slot inputs are pre-gathered
    at `active` (dead lanes land on the inert padding above) and the
    returned vectors are [k]-shaped: edge work O(k · w_b).
    """
    if active is not None:
        idx = take_fill(idx, active, 0)
        mask = take_fill(mask, active, 0.0)
        r_rows = take_fill(r_rows, active, 1.0)
        deg_rows = take_fill(deg_rows, active, 1.0)
        aff_rows = take_fill(aff_rows, active, 0.0)
    kw = dict(alpha=alpha, inv_n=inv_n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)
    if c.device.type == "cpu":
        return fused_ell_update_plain(c, idx, mask, r_rows, deg_rows,
                                      aff_rows, **kw)
    return _launch(c, idx, mask, r_rows, deg_rows, aff_rows, **kw)


def _launch(c, idx, mask, r, deg, aff, *, alpha, inv_n, tau_f, tau_p, prune,
            closed_form):
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ell_update: no kernel for device {dev}")
    if idx.dim() != 2 or idx.shape[0] == 0 or idx.shape[1] == 0:
        raise ValueError("fused_ell_update: bad slot table "
                         f"{tuple(idx.shape)}")
    rows, width = idx.shape
    _build.check("fused_ell_update c", c, torch.float64, (c.shape[0],), dev)
    _build.check("fused_ell_update idx", idx, torch.int32, (rows, width), dev)
    _build.check("fused_ell_update mask", mask, torch.float32, (rows, width),
                 dev)
    for name, t in (("r", r), ("deg", deg), ("aff", aff)):
        _build.check(f"fused_ell_update {name}", t, torch.float64, (rows,),
                     dev)
    lanes = lanes_for(width)
    lib = _build.load("fused_ell_update", _SIG)
    grid = lib.fused_ell_update_grid(rows, lanes)
    out = torch.empty((3, rows), dtype=torch.float64, device=dev)
    partials = torch.empty(grid + 1, dtype=torch.float64, device=dev)
    err = lib.fused_ell_update(
        c.data_ptr(), idx.data_ptr(), mask.data_ptr(), r.data_ptr(),
        deg.data_ptr(), aff.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), partials.data_ptr(), rows, width, lanes, alpha,
        (1.0 - alpha) * inv_n, tau_f, tau_p, int(prune), int(closed_form),
        _build.stream_ptr(dev))
    _build.launch_error("fused_ell_update", err)
    fused_ell_update.launches += 1
    return out[0], out[1], out[2], partials[grid]


fused_ell_update.launches = 0
