"""Multi-rank PageRank on ``torch.distributed``: the 1-D vertex partition.

Every shard owns ``n_loc = n_pad / nd`` vertices — their ELL rows,
tile-padded CSR slices, ranks and affected flags. The pull model makes the
per-iteration communication exactly one collective: the all-gather of the
contribution vector ``c = R / outdeg``, plus a scalar max for convergence —
the paper's "one write per vertex" discipline lifted to the cluster (each
rank writes only its own rank slice; no cross-rank scatter exists). DF-P
gathers its frontier flags δ_N the same way and pulls them through the
same layout.

A port of the JAX package's `repro.core.distributed`, SPMD: one process
per shard (`core.mesh.Mesh`), where JAX runs one controller over stacked
``[nd, n_loc]`` arrays. So here:

  * `build_sharded(..., shard=s)` builds shard s alone, array-equal to row
    s of JAX's stacked build: every rank runs `sharded_need` over all
    shards (it reads only the degrees and yields the shared capacities),
    then `build_hybrid_rows` for its own block;
  * the engines take and return this rank's ``[n_loc]`` slices; their
    iteration counts, traces, health words and frontier stats are the
    same on every rank (they come out of the all-reduces);
  * the solve loop runs on the host with one device→host read per
    iteration (the reduced L∞, with the caps path's overflow flag), as
    the port's single-device engines do;
  * the local pull is `pull_sum` over the shard's layout with `n_loc`
    output rows — on CUDA tensors the hand-written kernels
    (`kernels.ops.pull_sum_kernels`: `ell_pull` over every bucket in one
    launch, `csr_block_pull` on the high side), on CPU tensors the plain
    version. The epilogue is `core.rank_step`, as in JAX; the frontier's
    pull-max and the compacted caps path stay plain tensor ops, as on one
    device.

Spans ``solve.static_1d`` and ``solve.dfp_1d`` and the trace kinds
``static_1d`` and ``dfp_1d`` are the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .dynamic import solve_health
from .frontier import (FS_ACTIVE_ROWS, FS_ACTIVE_TILES, FS_COMPACT, FS_ITERS,
                       FS_NB, FS_OVERFLOW, active_frontier, active_pull_sum,
                       caps_for_parts, fstats_init, initial_affected,
                       publish_fstats)
from .graph import (Graph, bucket_band_counts, build_hybrid_rows,
                    choose_bucket_widths, next_pow2)
from .mesh import Mesh
from .pagerank import (EllBlock, PRParams, as_ranks, pull_max, pull_sum,
                       resolve_device, slot_tile_table, use_kernels)
from .rank_step import rank_step
from ..obs.spans import get_registry
from ..obs.trace import trace_init, trace_record

__all__ = ["ShardedGraph", "build_sharded", "sharded_caps", "sharded_need",
           "shard_bounds", "shard_block_rows", "shard_graph",
           "initial_affected_sharded", "shard_vector", "unshard_vector",
           "local_pull", "local_pull_max",
           "distributed_static_pagerank", "distributed_dfp_pagerank",
           "sharded_frontier_caps", "pagerank_step_specs"]


class ShardedGraph(NamedTuple):
    """One shard's hybrid layout, staged on its rank's device.

    Each ELL degree bucket is one `EllBlock`: rows [cap_b] hold LOCAL row
    ids (sentinel n_loc), idx/mask [cap_b, w_b] GLOBAL column ids /
    validity. Bucket widths and every capacity are shared by all shards
    (`sharded_need`). `hi_slot_tiles` / `hi_slot_off` are the slot→tile
    table `csr_block_pull` reduces over (`core.pagerank.slot_tile_table`).
    """
    buckets: Tuple[EllBlock, ...]
    hi_pos: torch.Tensor        # [hi_cap] int32, LOCAL rows (sentinel n_loc)
    hi_tiles: torch.Tensor      # [t_cap, tile] int32, GLOBAL column ids
    hi_tmask: torch.Tensor      # [t_cap, tile] f32
    hi_rowmap: torch.Tensor     # [t_cap] int32
    hi_slot_tiles: torch.Tensor  # [t_cap] int32 tile ids grouped by slot
    hi_slot_off: torch.Tensor   # [hi_cap + 1] int32
    out_deg: torch.Tensor       # [n_loc] int32 (>=1)
    valid: torch.Tensor         # [n_loc] bool (False on padding vertices)
    n_true: int                 # real |V| (for the (1-α)/|V| constant)
    nd: int                     # number of shards
    shard: int                  # which shard this is

    @property
    def n_loc(self) -> int:
        return self.out_deg.shape[0]

    # the names the single-device pulls read (`core.pagerank.pull_sum`)
    @property
    def hi_ids(self) -> torch.Tensor:
        return self.hi_pos

    @property
    def n_hi_cap(self) -> int:
        return self.hi_pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.out_deg.device


def shard_bounds(s: int, n_loc: int, n: int) -> Tuple[int, int]:
    """[lo, hi) of shard s's real vertices, clamped: a trailing shard may be
    entirely padding (lo == hi == n) when n_loc · nd overshoots |V|."""
    return min(s * n_loc, n), min((s + 1) * n_loc, n)


def shard_block_rows(g: Graph, s: int, n_loc: int):
    """(offsets, data) ragged-rows slice of shard s's contiguous vertex
    block in the transpose CSR — the input `build_hybrid_rows` consumes.
    Shared by `build_sharded` and `stream.ShardedSnapshot`."""
    lo, hi = shard_bounds(s, n_loc, g.n)
    off = g.t_offsets[lo:hi + 1] - g.t_offsets[lo]
    dat = g.t_sources[g.t_offsets[lo]:g.t_offsets[hi]]
    return off, dat


def sharded_need(indeg: np.ndarray, nd: int, n_loc: int, d_p: int, tile: int,
                 widths: Tuple[int, ...] = (),
                 band: bool = False) -> Tuple[int, int, Tuple[int, ...]]:
    """Worst-shard (high-slot, tile, per-bucket-slot) needs across the
    contiguous blocks — the raw sizes the pow2 capacity ladder is applied
    to. Bucket needs include each shard's padding rows (degree 0, parked in
    bucket 0 like `build_hybrid_rows` does). `band=True` counts each
    bucket's streaming hysteresis band (`bucket_band_counts`) instead of
    the initial placement census. Reads only the degrees, so every rank
    derives the same capacities."""
    n = int(indeg.shape[0])
    need_hi = need_t = 1
    need_b = [1] * len(widths)
    for s in range(nd):
        lo, hi = shard_bounds(s, n_loc, n)
        blk = indeg[lo:hi]
        deg_hi = blk[blk > d_p]
        need_hi = max(need_hi, int(deg_hi.size))
        need_t = max(need_t, int(((deg_hi + tile - 1) // tile).sum()))
        if widths:
            if band:
                cnt = list(bucket_band_counts(blk, widths, d_p))
            else:
                low = blk[blk <= d_p]
                grp = np.searchsorted(widths, np.maximum(low, 1), side="left")
                cnt = np.bincount(grp, minlength=len(widths))
            cnt[0] += n_loc - (hi - lo)       # padding rows -> bucket 0
            need_b = [max(a, int(b)) for a, b in zip(need_b, cnt)]
    return need_hi, need_t, tuple(need_b)


def shard_graph(rows, idx, mask, hi_pos, hi_tiles, hi_tmask, hi_rowmap,
                out_deg, valid, *, n_true: int, nd: int, shard: int,
                device) -> ShardedGraph:
    """Stage copies of one shard's host arrays (per-bucket lists `rows`,
    `idx`, `mask`) as a `ShardedGraph` on `device`, with its slot→tile
    table. Copies on the CPU too: `stream.ShardedSnapshot` edits its
    mirrors in place."""
    dev = resolve_device(device)

    def stage(a, d):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.clone() if d.type == "cpu" else t.to(d)
    slot_tiles, slot_off = slot_tile_table(hi_rowmap, len(hi_pos))
    return ShardedGraph(
        buckets=tuple(EllBlock(rows=stage(r, dev), idx=stage(i, dev),
                               mask=stage(m, dev))
                      for r, i, m in zip(rows, idx, mask)),
        hi_pos=stage(hi_pos, dev), hi_tiles=stage(hi_tiles, dev),
        hi_tmask=stage(hi_tmask, dev), hi_rowmap=stage(hi_rowmap, dev),
        hi_slot_tiles=stage(slot_tiles, dev),
        hi_slot_off=stage(slot_off, dev), out_deg=stage(out_deg, dev),
        valid=stage(valid, dev), n_true=int(n_true), nd=int(nd),
        shard=int(shard))


def build_sharded(g: Graph, nd: int, d_p: int = 64, tile: int = 1024,
                  hi_cap: Optional[int] = None, t_cap: Optional[int] = None,
                  widths: Optional[Tuple[int, ...]] = None,
                  bucket_caps: Optional[Tuple[int, ...]] = None, *,
                  shard: int, device=None) -> ShardedGraph:
    """Host partitioner: contiguous vertex blocks, one hybrid per shard;
    builds and stages shard `shard` (of `nd`) on `device` (CUDA unless
    named; a mesh's rank passes ``shard=mesh.shard, device=mesh.device``).

    Pads |V| to a multiple of nd with isolated vertices (masked out of
    updates and results). Bucket widths come from the *global* degree
    histogram, and the bucket/high/tile capacities are the worst shard's
    (`sharded_need`, pow2 by default), so every shard shares one
    structure and the result is array-equal to row `shard` of the JAX
    package's stacked build. Never pass smaller capacities than a previous
    build when re-sharding a growing graph (`sharded_caps`).
    """
    if not 0 <= shard < nd:
        raise ValueError(f"shard {shard} of {nd}")
    dev = resolve_device(device)          # raise before the host build
    n = g.n
    n_pad = ((n + nd - 1) // nd) * nd
    n_loc = n_pad // nd
    indeg = g.in_degree()
    if widths is None:
        widths = choose_bucket_widths(indeg, d_p)
    widths = tuple(int(w) for w in widths)
    need_hi, need_t, need_b = sharded_need(indeg, nd, n_loc, d_p, tile,
                                           widths)
    if hi_cap is None:
        hi_cap = next_pow2(need_hi, 8)
    if t_cap is None:
        t_cap = next_pow2(need_t, 8)
    if bucket_caps is None:
        bucket_caps = tuple(next_pow2(nb, 8) for nb in need_b)
    if need_hi > hi_cap or need_t > t_cap or any(
            nb > c for nb, c in zip(need_b, bucket_caps)):
        raise ValueError("sharded caps too small for this snapshot")
    off, dat = shard_block_rows(g, shard, n_loc)
    p = build_hybrid_rows(off, dat, d_p=d_p, tile=tile, n_rows=n_loc,
                          n_hi_cap=hi_cap, t_cap=t_cap, widths=widths,
                          bucket_caps=bucket_caps)
    lo, hi = shard_bounds(shard, n_loc, n)
    deg = np.ones(n_loc, np.int32)
    deg[:hi - lo] = g.out_degree()[lo:hi]
    valid = np.zeros(n_loc, bool)
    valid[:hi - lo] = True
    return shard_graph([b.rows for b in p.buckets],
                       [b.idx for b in p.buckets],
                       [b.mask for b in p.buckets], p.hi_ids, p.hi_tiles,
                       p.hi_tmask, p.hi_rowmap, deg, valid, n_true=n, nd=nd,
                       shard=shard, device=dev)


def sharded_caps(sg: ShardedGraph) -> dict:
    """Capacity signature — pass as **caps to `build_sharded` to rebuild a
    later snapshot of the same graph with identical device shapes (the
    same on every shard)."""
    widths = tuple(int(b.idx.shape[1]) for b in sg.buckets)
    return dict(d_p=widths[-1] if widths else 0,
                tile=int(sg.hi_tiles.shape[1]),
                hi_cap=int(sg.hi_pos.shape[0]),
                t_cap=int(sg.hi_tiles.shape[0]), widths=widths,
                bucket_caps=tuple(int(b.rows.shape[0]) for b in sg.buckets))


# ---------------------------------------------------------------------------
# Host <-> shard staging helpers
# ---------------------------------------------------------------------------

def shard_vector(x, nd: int, shard: int, fill=0, device=None
                 ) -> torch.Tensor:
    """Shard `shard`'s [n_loc] slice of a dense [n] host vector padded to a
    multiple of nd with `fill` (row `shard` of JAX's stacked
    `shard_vector`), on `device` (CUDA unless named)."""
    x = np.asarray(x)
    n = x.shape[0]
    n_loc = ((n + nd - 1) // nd)
    out = np.full(n_loc, fill, x.dtype)
    lo, hi = shard_bounds(shard, n_loc, n)
    out[:hi - lo] = x[lo:hi]
    return torch.from_numpy(out).to(resolve_device(device))


def unshard_vector(x, n: int, mesh: Optional[Mesh] = None) -> np.ndarray:
    """Dense host [n] from shards: this rank's [n_loc] slice all-gathered
    over `mesh` (a collective: every rank calls it and gets the whole
    vector), or, without a mesh, a stacked [nd, n_loc] array as JAX's
    `unshard_vector` takes it."""
    if mesh is not None:
        x = mesh.all_gather(torch.as_tensor(x))
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)[:n]


def initial_affected_sharded(nd: int, n_loc: int, batch, shard: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Alg. 5 initialAffected, shard `shard`'s slice (row `shard` of
    JAX's stacked result): (δ_V [n_loc], δ_N [n_loc]) ready for
    `distributed_dfp_pagerank`, which performs the initial frontier
    expansion at iteration 0.

    `batch` is a DeviceBatch (every rank stages the whole batch; ids may be
    padded with the id-n sentinel: one landing on a padding vertex is
    harmless, since padding vertices have `valid=False` and no edges)."""
    dv, dn = initial_affected(nd * n_loc, batch.del_src, batch.del_dst,
                              batch.ins_src)
    lo = shard * n_loc
    return dv[lo:lo + n_loc], dn[lo:lo + n_loc]


# ---------------------------------------------------------------------------
# Local (per-shard) pull, consuming the gathered contribution vector
# ---------------------------------------------------------------------------

def local_pull(sg: ShardedGraph, c_full: torch.Tensor,
               kernels: Optional[bool] = None) -> torch.Tensor:
    """This shard's [n_loc] in-edge sums of the gathered `c_full` [n_pad]:
    the `ell_pull` and `csr_block_pull` kernels on CUDA tensors
    (`kernels.ops.pull_sum_kernels`), the plain `pull_sum` on CPU ones
    (the JAX package's `_local_pull`); `kernels` names one or the other."""
    if use_kernels(c_full, kernels):
        from ..kernels.ops import pull_sum_kernels
        return pull_sum_kernels(sg, c_full, n_out=sg.n_loc)
    return pull_sum(sg, c_full, n_out=sg.n_loc)


def local_pull_max(sg: ShardedGraph, x_full: torch.Tensor) -> torch.Tensor:
    """This shard's [n_loc] in-neighbour max of the gathered `x_full` (x ≥
    0): the frontier expansion's pull (plain tensor ops)."""
    return pull_max(sg, x_full, n_out=sg.n_loc)


def _check(mesh: Mesh, sg: ShardedGraph) -> None:
    if sg.nd != mesh.size or sg.shard != mesh.shard:
        raise ValueError(f"shard {sg.shard} of {sg.nd} on mesh rank "
                         f"{mesh.shard} of {mesh.size}")


def _solve(mesh: Mesh, sg: ShardedGraph, r0, dv0, dn0, params: PRParams, *,
           dfp: bool, engine: str, delta_every: int = 1, trace: bool = False,
           caps=None, health: bool = False, kernels: Optional[bool] = None):
    """The per-shard loop of JAX's `_make_loop`: per iteration the
    contribution all-gather, the local pull, `core.rank_step` on this
    shard's slice and the max all-reduce of its L∞.

    DF-P pulls the gathered δ_N through the same layout, *including at
    iteration 0* (the paper's initial expansion, line 9), so callers seed
    raw flags. `delta_every=k` reduces the L∞ only every k-th iteration
    (the others run without a global sync; with `trace` it is reduced
    every iteration for the record, but the loop still reads it every
    k-th only). `caps` (`sharded_frontier_caps`) compacts each shard's
    rank pull to its active rows and tiles; a shard whose lists overflow
    runs its dense local pull that iteration — neither branch holds a
    collective, so shards may diverge. One host read per iteration: the
    next iteration's expansion and compaction run before it, and are
    discarded when the loop stops.

    Returns (r [n_loc], iters)[, TraceBuffer][, health word][, fstats] —
    everything but r the same on every rank."""
    _check(mesh, sg)
    dev = sg.device
    r = as_ranks(r0, dev)
    dt = r.dtype
    d = sg.out_deg.to(dt)
    valid = sg.valid
    n_loc = sg.n_loc
    kw = dict(alpha=params.alpha, n_norm=sg.n_true, tau_f=params.tau_f,
              tau_p=params.tau_p, prune=dfp, closed_form=dfp,
              track_frontier=dfp)
    tb = trace_init(params.max_iter, dt, engine, dev) if trace else None
    fs = fstats_init(len(sg.buckets), dev) if caps is not None else None
    host_fs = [0] * FS_NB
    inf = torch.full((), float("inf"), dtype=dt, device=dev)

    def expand(dv, dn):
        grow = local_pull_max(sg, mesh.all_gather(dn.to(dt))) > 0
        return (dv | grow) & valid

    def compact(dv):
        return active_frontier(sg.buckets, sg.hi_pos, sg.hi_rowmap,
                               dv & valid, caps)

    dv, dn = dv0.to(dev), dn0.to(dev)
    if dfp:
        dv = expand(dv, dn)
    af = compact(dv) if caps is not None else None
    overflow = bool(af.overflow) if caps is not None else False
    delta = inf
    i = 0
    while i < params.max_iter:
        c_full = mesh.all_gather(r / d)
        dv_in = dv & valid
        if caps is not None and not overflow:
            s = active_pull_sum(sg.buckets, sg.hi_pos, sg.hi_tiles,
                                sg.hi_tmask, sg.hi_rowmap, af, c_full, n_loc)
            host_fs[FS_COMPACT] += 1
            fs[FS_ACTIVE_ROWS] += af.n_rows
            fs[FS_ACTIVE_TILES] += af.n_tiles
            fs[FS_NB:] += af.bucket_counts
        else:
            s = local_pull(sg, c_full, kernels)
            host_fs[FS_OVERFLOW] += 1
        host_fs[FS_ITERS] += 1
        r_new, dv_new, dn_new, local = rank_step(s, r, dv_in, sg.out_deg,
                                                 **kw)
        if not dfp:
            dn_new = dn
        check = delta_every <= 1 or (i + 1) % delta_every == 0
        gmax = mesh.all_max(local) if (check or trace) else None
        delta = gmax if check else inf
        if trace:
            n_in = dv_in.sum()
            counts = mesh.all_sum(torch.stack([
                n_in, dn_new.sum(), n_in - (dv_new & valid).sum()]
            ).to(torch.int32))
            trace_record(tb, i, linf=gmax, frontier=counts[0],
                         delta_n=counts[1] if dfp else 0,
                         pruned=counts[2] if dfp else 0)
        r, dv, dn = r_new, dv_new, dn_new
        i += 1
        if i >= params.max_iter:
            break
        if dfp:
            dv = expand(dv, dn)
        reads = [delta > params.tau] if check else []
        if caps is not None:
            af = compact(dv)
            reads.append(af.overflow)
        if reads:
            got = torch.stack(reads).tolist()      # the one host read
            if check and not got[0]:
                break
            if caps is not None:
                overflow = got[-1]

    out = [r, i]
    if tb is not None:
        out.append(tb)
    if health:
        # the delta came through the max all-reduce; the mass is one sum
        # all-reduce over the valid slice. A delta left at the inf
        # skip-sentinel (delta_every > 1 ending between checks) reads as
        # H_MAX_ITER in solve_health.
        mass = mesh.all_sum(torch.where(valid, r, 0.0).sum())
        out.append(solve_health(delta, i, mass, params))
    if caps is not None:
        fs[:FS_NB] += torch.tensor(host_fs, dtype=torch.int32, device=dev)
        out.append(mesh.all_sum(fs))
    return tuple(out)


def pagerank_step_specs(mesh):
    """The dry run's sharding specs of this workload: comes with the dry
    run and the LM substrate's sharding specs."""
    raise NotImplementedError("pagerank_step_specs serves the dry run "
                              "(launch/dryrun.py), not ported yet: ROADMAP "
                              "A9")


def distributed_static_pagerank(mesh: Mesh, sg: ShardedGraph, r0,
                                params: PRParams = PRParams(),
                                delta_every: int = 1, trace: bool = False,
                                health: bool = False,
                                kernels: Optional[bool] = None):
    """r0: this rank's [n_loc] ranks. Returns (ranks [n_loc], iters), plus
    an obs.trace.TraceBuffer when ``trace=True`` and the guard.health word
    (last) when ``health=True``, both the same on every rank. `kernels`
    picks the local pull (`local_pull`)."""
    with get_registry().span("solve.static_1d", annotate=True):
        on = torch.ones(sg.n_loc, dtype=torch.bool, device=sg.device)
        return _solve(mesh, sg, r0, on, torch.zeros_like(on), params,
                      dfp=False, engine="static_1d", delta_every=delta_every,
                      trace=trace, health=health, kernels=kernels)


def sharded_frontier_caps(sg: ShardedGraph, est: int, headroom: int = 16):
    """FrontierCaps over the PER-SHARD layout shapes for `frontier_caps` of
    `distributed_dfp_pagerank` (the same on every shard). `est` is the
    expected initial frontier size of the worst shard (a global estimate
    works too — caps only affect speed, never correctness)."""
    return caps_for_parts(
        tuple(int(b.rows.shape[0]) for b in sg.buckets),
        int(sg.hi_pos.shape[0]), int(sg.hi_tiles.shape[0]), sg.n_loc, est,
        headroom)


def distributed_dfp_pagerank(mesh: Mesh, sg: ShardedGraph, r_prev,
                             dv0: torch.Tensor, dn0: torch.Tensor,
                             params: PRParams = PRParams(),
                             delta_every: int = 1, trace: bool = False,
                             frontier_caps=None, health: bool = False,
                             kernels: Optional[bool] = None):
    """DF-P over the mesh: dv0/dn0 are this rank's initial affected /
    to-expand flags ([n_loc], from `initial_affected_sharded`). Iteration
    0 pulls dn0 through the layout — the paper's initial frontier
    expansion — so callers seed raw flags; pre-expanded dv0 (with dn0
    zeroed) also works. ``trace=True`` appends an obs.trace.TraceBuffer;
    ``health=True`` appends the guard.health word (before the frontier
    stats, which stay last in the loop and are published here).
    ``frontier_caps`` (`sharded_frontier_caps`) compacts each shard's rank
    pull to its active rows/tiles — identical results, ``frontier.*``
    counters (summed over the shards) published on every rank."""
    with get_registry().span("solve.dfp_1d", annotate=True):
        out = _solve(mesh, sg, r_prev, dv0, dn0, params, dfp=True,
                     engine="dfp_1d", delta_every=delta_every, trace=trace,
                     caps=frontier_caps, health=health, kernels=kernels)
    if frontier_caps is not None:
        *out, fs = out
        publish_fstats(fs)
        out = tuple(out)
    return out
