"""The kernel-backed sweeps: `update_ranks_kernel` (fused) and
`pull_sum_kernels` (the pull of the staged sweep).

`update_ranks_kernel`: per degree bucket, one `fused_ell_update` gathers the in-edge
contributions and applies the rank/prune/frontier epilogue before writing;
the high side pulls per-slot sums through `csr_block_pull` and runs the
same epilogue over the slot table with `pr_update`. This is the default
sweep of every engine on CUDA tensors (`core.pagerank.update_ranks`).

The per-slot gathers of r/deg/aff and the scatters of the results back
through the row-id maps are plain tensor ops, as in the JAX package; ids
equal to the sentinel `n` read the pad values (r=1, deg=1, aff=0) and
write into a sink row that is sliced off.

`pull_sum_kernels(dg, c)` is a drop-in `pull_sum_fn` for the engines of
`core.pagerank` and `core.dynamic`: `ell_pull` per bucket
(`ell_bucket_pull`) on the low side, `csr_block_pull` on the high side.
The engines then run the rank update in `core.rank_step` and take the L∞
delta from the `linf_delta` kernel — the paper's staged sweep, with the
`contrib [n]` round trip through device memory that the fused sweep
avoids.
"""
from __future__ import annotations

import torch

from .csr_block import csr_block_pull
from .ell_bucket_pull import bucket_sums, fused_ell_update
from .pr_update import pr_update
from ..sentinel import take_fill, with_sink

__all__ = ["update_ranks_kernel", "pull_sum_kernels"]


def pull_sum_kernels(dg, c: torch.Tensor) -> torch.Tensor:
    """Kernel-backed pull over the hybrid layout (cf.
    `core.pagerank.pull_sum`): sum_{u in G'.row(v)} c[u] for every v.

    `dg` is a DeviceGraph, a snapshot's `.dg` included (its slot->tile
    table is kept fresh by the snapshot). Sentinel ids land in the sink
    row of `bucket_sums`, sliced off at the end."""
    n = c.shape[0]
    out = bucket_sums(c, dg.buckets)
    hi = csr_block_pull(c, dg.hi_tiles, dg.hi_tmask, dg.hi_rowmap,
                        dg.n_hi_cap, slots=(dg.hi_slot_tiles, dg.hi_slot_off))
    return out.index_add_(0, dg.hi_ids, hi)[:n]


def update_ranks_kernel(dg, r: torch.Tensor, affected: torch.Tensor, *,
                        alpha: float, tau_f: float, tau_p: float,
                        prune: bool, closed_form: bool, track_frontier: bool,
                        active=None):
    """Kernel-backed Alg. 3 body, single-pass per bucket.

    Same contract as core.pagerank.update_ranks. Every vertex lives in
    exactly one bucket or one high slot (self-loops guarantee in-degree
    >= 1, so the d_p = 0 layout puts every vertex high-side and one
    epilogue serves all layouts), so each output is written exactly once.

    `active` (core.frontier.ActiveFrontier, valid only when its `overflow`
    is False) restricts every kernel to the compacted active lists. Rows
    off the lists keep rank/affected untouched and contribute no δ_N or
    L∞ — identical outputs to the full sweep whenever `active` covers the
    affected set.
    """
    n = r.shape[0]
    dt = r.dtype
    deg = dg.out_deg.to(dt)
    c = r / deg
    aff_f = affected.to(dt)
    kw = dict(alpha=alpha, inv_n=1.0 / n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)

    # reads at id n see the pad values; writes at id n land in the sink
    r_src, d_src, a_src = with_sink(r, 1.0), with_sink(deg, 1.0), \
        with_sink(aff_f, 0.0)
    r_new, aff_new = r_src.clone(), a_src.clone()
    dn_f = torch.zeros_like(a_src)
    dmax = r.new_zeros(())

    b_sel = active.bucket_sel if active is not None \
        else (None,) * len(dg.buckets)
    for blk, sel in zip(dg.buckets, b_sel):
        rows = blk.rows if sel is None else take_fill(blk.rows, sel, n)
        rb, ab, db, pb = fused_ell_update(
            c, blk.idx, blk.mask, r_src.index_select(0, blk.rows),
            d_src.index_select(0, blk.rows), a_src.index_select(0, blk.rows),
            active=sel, **kw)
        r_new[rows] = rb
        aff_new[rows] = ab
        dn_f[rows] = db
        dmax = torch.maximum(dmax, pb)

    hi_sums = csr_block_pull(
        c, dg.hi_tiles, dg.hi_tmask, dg.hi_rowmap, dg.n_hi_cap,
        tile_sel=active.tile_sel if active is not None else None,
        slots=(dg.hi_slot_tiles, dg.hi_slot_off))
    if active is not None:
        # epilogue over the k_h active hi slots only, scattered back
        # through their vertex ids (sentinel lanes dropped)
        ids = take_fill(dg.hi_ids, active.hi_sel, n)
        hi_sums = take_fill(hi_sums, active.hi_sel, 0.0)
    else:
        ids = dg.hi_ids
    rh, ah, dh, ph = pr_update(
        hi_sums, r_src.index_select(0, ids), d_src.index_select(0, ids),
        a_src.index_select(0, ids), **kw)
    r_new[ids] = rh
    aff_new[ids] = ah
    dn_f[ids] = dh
    dmax = torch.maximum(dmax, ph)

    aff_out = aff_new[:n] > 0 if prune else affected
    dn_out = dn_f[:n] > 0 if track_frontier else torch.zeros_like(affected)
    return r_new[:n], aff_out, dn_out, dmax
