"""The kernel-backed sweeps: `update_ranks_kernel` (fused) and
`pull_sum_kernels` (the pull of the staged sweep).

`update_ranks_kernel`: one `fused_ell_sweep` launch gathers the in-edge
contributions of every ELL bucket and applies the rank/prune/frontier
epilogue, reading each row's rank, out-degree and flag through the
bucket's row map and writing the new rank and flags there in place (one
more launch folds its L∞ partials); the high side pulls per-slot sums
through `csr_block_pull` and runs the same epilogue over the slot table
with `pr_update_sweep`, which reads and writes through the slot→vertex map
in the same way (sentinel ids write nothing) and folds its L∞ partials
together with the low side's max. This is the default sweep of every
engine on CUDA tensors (`core.pagerank.update_ranks`).

`pull_sum_kernels(dg, c)` is a drop-in `pull_sum_fn` for the engines of
`core.pagerank` and `core.dynamic`: `ell_pull` over every bucket in one
launch (`ell_pull_buckets`) on the low side, `csr_block_pull` on the high
side.
The engines then run the rank update in `core.rank_step` and take the L∞
delta from the `linf_delta` kernel — the paper's staged sweep, with the
`contrib [n]` round trip through device memory that the fused sweep
avoids.
"""
from __future__ import annotations

import torch

from .csr_block import csr_block_pull
from .ell_bucket_pull import fused_ell_sweep
from .ell_pull import ell_pull_buckets
from .pr_update import pr_update_sweep

__all__ = ["update_ranks_kernel", "pull_sum_kernels"]


def pull_sum_kernels(dg, c: torch.Tensor, n_out=None) -> torch.Tensor:
    """Kernel-backed pull over the hybrid layout (cf.
    `core.pagerank.pull_sum`): sum_{u in G'.row(v)} c[u] for every v.

    `dg` is a DeviceGraph, a snapshot's `.dg` included (its slot->tile
    table is kept fresh by the snapshot), or a shard's layout
    (`core.distributed.ShardedGraph`), whose `n_out` local rows read ids
    into the gathered `c`. The high side's sentinel ids land in the sink
    row of `ell_pull_buckets`, sliced off at the end."""
    n = c.shape[0] if n_out is None else n_out
    out = ell_pull_buckets(c, dg.buckets, n_rows=n)
    hi = csr_block_pull(c, dg.hi_tiles, dg.hi_tmask, dg.hi_rowmap,
                        dg.n_hi_cap, slots=(dg.hi_slot_tiles, dg.hi_slot_off))
    return out.index_add_(0, dg.hi_ids, hi)[:n]


def update_ranks_kernel(dg, r: torch.Tensor, affected: torch.Tensor, *,
                        alpha: float, tau_f: float, tau_p: float,
                        prune: bool, closed_form: bool, track_frontier: bool,
                        active=None):
    """Kernel-backed Alg. 3 body: the ELL low side in one pass over every
    bucket, the high side in `csr_block_pull` + `pr_update_sweep`.

    Same contract as core.pagerank.update_ranks. Every vertex lives in
    exactly one bucket or one high slot (self-loops guarantee in-degree
    >= 1, so the d_p = 0 layout puts every vertex high-side and one
    epilogue serves all layouts), so in the dense sweep each output is
    written exactly once and the outputs start uninitialised.

    `active` (core.frontier.ActiveFrontier, valid only when its `overflow`
    is False) restricts every kernel to the compacted active lists. Rows
    off the lists keep rank/affected untouched and contribute no δ_N or
    L∞ — identical outputs to the full sweep whenever `active` covers the
    affected set.
    """
    n = r.shape[0]
    c = r / dg.out_deg
    kw = dict(alpha=alpha, inv_n=1.0 / n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)

    # both halves write in place; over active lists the rows off the lists
    # keep their rank and flag
    flag = dict(dtype=torch.bool, device=r.device)
    if active is None:
        r_new = torch.empty_like(r)
        aff_new = torch.empty(n, **flag)
        dn = torch.empty(n, **flag)
    else:
        r_new = r.clone()
        aff_new = affected.to(torch.bool, copy=True)
        dn = torch.zeros(n, **flag)
    dmax = fused_ell_sweep(
        c, dg.buckets, r, dg.out_deg, affected, r_new, aff_new, dn,
        bucket_sel=active.bucket_sel if active is not None else None, **kw)
    hi_sums = csr_block_pull(
        c, dg.hi_tiles, dg.hi_tmask, dg.hi_rowmap, dg.n_hi_cap,
        tile_sel=active.tile_sel if active is not None else None,
        slots=(dg.hi_slot_tiles, dg.hi_slot_off))
    dmax = pr_update_sweep(
        hi_sums, dg.hi_ids, r, dg.out_deg, affected, r_new, aff_new, dn,
        hi_sel=active.hi_sel if active is not None else None, prior=dmax,
        **kw)

    aff_out = aff_new if prune else affected
    dn_out = dn if track_frontier else torch.zeros_like(affected)
    return r_new, aff_out, dn_out, dmax
