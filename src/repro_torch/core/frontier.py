"""Paper Alg. 5 affected-set machinery + device-side frontier compaction.

Marking: `initial_affected` scatters O(|Δ|) flags, `expand_affected` is the
dense pull-based expansion (every vertex pulls the OR of δ_N over its
in-neighbors in G^t), `reach_affected` the DT fixpoint.

Compaction (the O(frontier·degree) layer): δ_V becomes *active gather
lists* over the hybrid layout, with fixed capacities:

  * `stream_compact` — order-preserving prefix-sum compaction of a flag
    vector into a fixed-capacity index list;
  * `FrontierCaps` — the pow2 capacity plan; capacities never shrink
    across a session (`merge_caps`);
  * `active_frontier` — per-bucket active-slot lists + active hi-slot and
    CSR-tile lists from δ_V, with an `overflow` flag when any list is
    truncated (callers then run the full sweep for that iteration —
    capacity guesses affect speed, never correctness);
  * `active_pull_sum` / `update_ranks_active` — the rank pull (and the
    full Alg. 3 sweep) restricted to the active lists; on CUDA the sweep
    runs the kernels over the lists (`update_ranks_kernel(active=)`);
  * `push_expand` / `expand_frontier` — the paper's out-edge expansion
    driven by the compacted δ_N worklist, with the dense pull as the
    overflow branch.

A copy of the JAX package's `repro.core.frontier` on tensors. Where JAX
uses ``lax.cond`` the host decides from a value it reads back; the engine
loop (`core.dynamic._loop`) folds those reads into its one read per
iteration.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .graph import next_pow2
from ..device import resolve_device
from .pagerank import DeviceGraph, gather_rows, pull_max, use_kernels
from .rank_step import rank_step
from ..obs.spans import get_registry
from ..sentinel import take_fill, with_sink

__all__ = [
    "initial_affected", "expand_affected", "reach_affected",
    "stream_compact", "FrontierCaps", "ActiveFrontier", "caps_for",
    "caps_for_parts", "merge_caps", "plan_capacity", "active_frontier",
    "active_pull_sum", "update_ranks_active", "push_expand",
    "expand_frontier", "fstats_init", "publish_fstats",
    "FS_ITERS", "FS_COMPACT", "FS_OVERFLOW", "FS_ACTIVE_ROWS",
    "FS_ACTIVE_TILES", "FS_PUSH", "FS_PULL", "FS_EXPAND_WORK", "FS_NB",
]


def _mark(n: int, *id_lists: torch.Tensor) -> torch.Tensor:
    """[n] bool with True at every id of the lists (ids == n dropped)."""
    dev = id_lists[0].device
    out = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    for ids in id_lists:
        out[ids] = True
    return out[:n]


def initial_affected(n: int, del_src: torch.Tensor, del_dst: torch.Tensor,
                     ins_src: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alg. 5 initialAffected: δ_N[u]=1 for every updated source u; δ_V[v]=1
    for every deletion target v. Inputs may be padded with id == n."""
    return _mark(n, del_dst), _mark(n, del_src, ins_src)


def expand_affected(dg: DeviceGraph, dv: torch.Tensor, dn: torch.Tensor
                    ) -> torch.Tensor:
    """δ_V'[v] = δ_V[v] OR (∃ u ∈ G^t.in(v): δ_N[u]) — dense O(|E|) pull on
    the transpose layout (the rank pull structure)."""
    pulled = pull_max(dg, dn.to(torch.float32))
    return dv | (pulled > 0.5)


def reach_affected(dg: DeviceGraph, seeds: torch.Tensor,
                   max_steps: int | None = None) -> torch.Tensor:
    """Dynamic Traversal marking: all vertices reachable (along out-edges)
    from the seed mask, via a pull-based BFS fixpoint on the transpose
    layout. One host read per step."""
    max_steps = dg.n if max_steps is None else max_steps
    vis = seeds
    for _ in range(max_steps):
        nxt = vis | (pull_max(dg, vis.to(torch.float32)) > 0.5)
        changed = bool(torch.any(nxt != vis))
        vis = nxt
        if not changed:
            break
    return vis


# ---------------------------------------------------------------------------
# Stream compaction + capacity plans
# ---------------------------------------------------------------------------

def stream_compact(flags: torch.Tensor, k: int, fill: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices of set flags, order-preserving, into a fixed [k] list.

    Prefix-sum compaction: each set flag's exclusive count is its slot;
    slots past k, and unset lanes, go to a sink slot that is cut off.
    Callers must treat count > k as overflow (the list is then
    truncated). Dead lanes hold `fill`. Returns (idx [k] int32, count).
    """
    ln = flags.shape[0]
    pos = torch.cumsum(flags, 0, dtype=torch.int32) - 1
    dest = torch.where(flags & (pos < k), pos, k).long()
    idx = torch.full((k + 1,), fill, dtype=torch.int32, device=flags.device)
    idx.scatter_(0, dest, torch.arange(ln, dtype=torch.int32,
                                       device=flags.device))
    return idx[:k], flags.sum(dtype=torch.int32)


class FrontierCaps(NamedTuple):
    """Compaction capacities (hashable; all ints on the pow2 ladder).

    `bucket[b]` bounds bucket b's active-slot list, `hi`/`tiles` the
    active high-slot / CSR-tile lists of the pull layout, `dn` the
    push-expansion vertex worklist, `fwd_tiles` the forward layout's tile
    worklist (0 = uncompacted full tile list: affected hubs legitimately
    need all their tiles)."""
    bucket: Tuple[int, ...]
    hi: int
    tiles: int
    dn: int
    fwd_tiles: int = 0


def plan_capacity(est: int, n: int, headroom: int = 16) -> int:
    """One shared sizing rule: pow2(est·headroom), clamped to n, floor 16."""
    return min(next_pow2(max(int(est), 1) * headroom), max(next_pow2(n), 16))


def caps_for_parts(bucket_caps: Tuple[int, ...], n_hi_cap: int, t_cap: int,
                   n: int, est: int, headroom: int = 16) -> FrontierCaps:
    """Capacity plan from layout shapes + an expected initial frontier size.
    Each list is bounded by both the plan size and its layout capacity."""
    k = plan_capacity(est, n, headroom)
    return FrontierCaps(
        bucket=tuple(min(k, int(c)) for c in bucket_caps),
        hi=min(k, int(n_hi_cap)),
        tiles=min(next_pow2(k), int(t_cap)),
        dn=k,
        fwd_tiles=0)


def caps_for(dg: DeviceGraph, est: int, headroom: int = 16) -> FrontierCaps:
    """`caps_for_parts` reading the shapes off a staged DeviceGraph."""
    return caps_for_parts(
        tuple(int(b.rows.shape[0]) for b in dg.buckets),
        dg.n_hi_cap, int(dg.hi_tiles.shape[0]), dg.n, est, headroom)


def merge_caps(a: Optional[FrontierCaps], b: FrontierCaps) -> FrontierCaps:
    """Elementwise max — the never-shrink discipline across a session."""
    if a is None:
        return b
    return FrontierCaps(
        bucket=tuple(max(x, y) for x, y in zip(a.bucket, b.bucket)),
        hi=max(a.hi, b.hi), tiles=max(a.tiles, b.tiles),
        dn=max(a.dn, b.dn), fwd_tiles=max(a.fwd_tiles, b.fwd_tiles))


# ---------------------------------------------------------------------------
# Active gather lists over the hybrid layout
# ---------------------------------------------------------------------------

class ActiveFrontier(NamedTuple):
    """δ_V compacted against one hybrid layout (fixed shapes from caps).

    Sentinels: bucket_sel[b] dead lanes = cap_b, hi_sel = n_hi_cap,
    tile_sel = t_cap. `overflow` (a 0-d bool tensor) is the single validity
    bit: when True some list was truncated and NONE of the lists may be
    used for an update — callers run the dense full sweep instead."""
    bucket_sel: Tuple[torch.Tensor, ...]  # per bucket [k_b] slot ids
    hi_sel: torch.Tensor                  # [k_h] hi slot ids
    tile_sel: torch.Tensor                # [k_t] CSR tile ids
    bucket_counts: torch.Tensor           # [nb] int32 active rows per bucket
    n_rows: torch.Tensor                  # 0-d int32 (buckets + hi)
    n_tiles: torch.Tensor                 # 0-d int32
    overflow: torch.Tensor                # 0-d bool


def active_frontier(buckets, hi_ids: torch.Tensor, hi_rowmap: torch.Tensor,
                    dv: torch.Tensor, caps: FrontierCaps) -> ActiveFrontier:
    """Compact δ_V into active gather lists, slot-based: a bucket's active
    slots are found by reading δ_V at the bucket's row ids (sentinel rows
    read False), the active tile list by reading the hi-slot activity
    through the tile→slot map."""
    if len(caps.bucket) != len(buckets):
        raise ValueError("FrontierCaps bucket arity != layout bucket arity")
    dv_s = with_sink(dv, False)
    sels, counts = [], []
    overflow = torch.zeros((), dtype=torch.bool, device=dv.device)
    for blk, kb in zip(buckets, caps.bucket):
        on = dv_s.index_select(0, blk.rows)
        sel, cnt = stream_compact(on, kb, blk.rows.shape[0])
        sels.append(sel)
        counts.append(cnt)
        overflow = overflow | (cnt > kb)
    on_hi = dv_s.index_select(0, hi_ids)
    hi_sel, hi_cnt = stream_compact(on_hi, caps.hi, hi_ids.shape[0])
    tile_on = on_hi.index_select(0, hi_rowmap)
    tile_sel, t_cnt = stream_compact(tile_on, caps.tiles,
                                     hi_rowmap.shape[0])
    overflow = overflow | (hi_cnt > caps.hi) | (t_cnt > caps.tiles)
    bucket_counts = (torch.stack(counts) if counts else
                     torch.zeros(0, dtype=torch.int32, device=dv.device))
    n_rows = bucket_counts.sum(dtype=torch.int32) + hi_cnt
    return ActiveFrontier(tuple(sels), hi_sel, tile_sel, bucket_counts,
                          n_rows, t_cnt, overflow)


def active_pull_sum(buckets, hi_ids, hi_tiles, hi_tmask, hi_rowmap,
                    af: ActiveFrontier, c: torch.Tensor, n_out: int
                    ) -> torch.Tensor:
    """`pull_sum` restricted to the active lists: dense [n_out] sums that
    are exact for every active row and zero elsewhere. Edge work is
    O(Σ_b k_b·w_b + k_t·tile) — the frontier·degree bound.

    Only valid when `af.overflow` is False (truncated lists would silently
    drop in-edges of hubs)."""
    dt = c.dtype
    out = c.new_zeros(n_out + 1)        # id n_out is the sink
    for blk, sel in zip(buckets, af.bucket_sel):
        rows = take_fill(blk.rows, sel, n_out)
        idx = take_fill(blk.idx, sel, 0)
        msk = take_fill(blk.mask, sel, 0.0)
        out.index_add_(0, rows, (gather_rows(c, idx) * msk.to(dt)).sum(1))
    tiles = take_fill(hi_tiles, af.tile_sel, 0)
    tmask = take_fill(hi_tmask, af.tile_sel, 0.0)
    tsums = (gather_rows(c, tiles) * tmask.to(dt)).sum(1)
    slot = take_fill(hi_rowmap, af.tile_sel, 0)
    owner = hi_ids.index_select(0, slot)   # dead lanes add 0.0 — inert
    out.index_add_(0, owner, tsums)
    return out[:n_out]


def update_ranks_active(dg: DeviceGraph, r: torch.Tensor, dv: torch.Tensor,
                        af: ActiveFrontier, *, alpha: float, tau_f: float,
                        tau_p: float, prune: bool, closed_form: bool,
                        track_frontier: bool, kernels: Optional[bool] = None):
    """One Alg. 3 sweep whose pull touches only the active lists.

    Same contract (and the same outputs, lane for lane) as
    `core.pagerank.update_ranks` whenever `af` covers δ_V — i.e. whenever
    `af.overflow` is False, which callers must guarantee."""
    kw = dict(alpha=alpha, tau_f=tau_f, tau_p=tau_p, prune=prune,
              closed_form=closed_form, track_frontier=track_frontier)
    if use_kernels(r, kernels):
        from ..kernels.ops import update_ranks_kernel
        return update_ranks_kernel(dg, r, dv, active=af, **kw)
    s = active_pull_sum(dg.buckets, dg.hi_ids, dg.hi_tiles, dg.hi_tmask,
                        dg.hi_rowmap, af, r / dg.out_deg.to(r.dtype), dg.n)
    return rank_step(s, r, dv, dg.out_deg, n_norm=dg.n, **kw)


# ---------------------------------------------------------------------------
# Push-style expansion (paper Alg. 5 expandAffected, worklist-driven)
# ---------------------------------------------------------------------------

def push_expand(fwd: DeviceGraph, dn: torch.Tensor, kn: int,
                kt: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Out-neighbors of the compacted δ_N worklist, marked.

    Low out-degree sources walk their own ELL row of the forward layout;
    high out-degree sources walk their tile lists (through a compacted
    tile worklist when kt > 0, else the full tile table gated by the
    activity mask — never overflows). Returns (marks [n] bool, overflow
    0-d bool) — marks are only complete when overflow is False."""
    n = fwd.n
    src, n_src = stream_compact(dn, kn, n)
    overflow = n_src > kn
    nb = len(fwd.buckets)
    b_of = take_fill(fwd.bucket_of, src, nb)
    s_of = take_fill(fwd.slot_of, src, 0)
    out = torch.zeros(n + 1, dtype=torch.bool, device=dn.device)
    for bi, blk in enumerate(fwd.buckets):
        slot = torch.where(b_of == bi, s_of, blk.rows.shape[0])
        nbr = take_fill(blk.idx, slot, 0)
        msk = take_fill(blk.mask, slot, 0.0)
        out[torch.where(msk > 0, nbr, n).reshape(-1)] = True
    hi_aff = take_fill(dn, fwd.hi_ids, False)
    tile_on = hi_aff.index_select(0, fwd.hi_rowmap)
    if kt:
        tsel, n_t = stream_compact(tile_on, kt, fwd.hi_tiles.shape[0])
        overflow = overflow | (n_t > kt)
        tiles = take_fill(fwd.hi_tiles, tsel, 0)
        tmask = take_fill(fwd.hi_tmask, tsel, 0.0)
        tgt2 = torch.where(tmask > 0, tiles, n)
    else:
        tgt2 = torch.where((fwd.hi_tmask > 0) & tile_on[:, None],
                           fwd.hi_tiles, n)
    out[tgt2.reshape(-1)] = True
    return out[:n], overflow


def expand_frontier(dg: DeviceGraph, fwd: DeviceGraph, dv: torch.Tensor,
                    dn: torch.Tensor, caps: FrontierCaps
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """δ_V ∪ out-neighbors(δ_N): push-style when the worklist fits its caps,
    dense pull (`expand_affected`) otherwise. The choice takes one host
    read. Returns (δ_V', stats [work, pushed, pulled] int32)."""
    n_dn = dn.sum(dtype=torch.int32)
    ovf = n_dn > caps.dn
    if caps.fwd_tiles:
        hi_aff = take_fill(dn, fwd.hi_ids, False)
        n_t = hi_aff.index_select(0, fwd.hi_rowmap).sum(dtype=torch.int32)
        ovf = ovf | (n_t > caps.fwd_tiles)
    pulled = bool(ovf)
    if pulled:
        dv_new = expand_affected(dg, dv, dn)
    else:
        dv_new = dv | push_expand(fwd, dn, caps.dn, caps.fwd_tiles)[0]
    return dv_new, torch.stack([n_dn, torch.full_like(n_dn, int(not pulled)),
                                torch.full_like(n_dn, int(pulled))])


# ---------------------------------------------------------------------------
# frontier.* statistics (device-accumulated)
# ---------------------------------------------------------------------------

# fstats vector layout: fixed slots, then one active-row counter per bucket.
FS_ITERS = 0          # loop iterations run
FS_COMPACT = 1        # iterations that used the active lists
FS_OVERFLOW = 2       # iterations that fell back to the full sweep
FS_ACTIVE_ROWS = 3    # Σ active rows over compacted iterations
FS_ACTIVE_TILES = 4   # Σ active CSR tiles over compacted iterations
FS_PUSH = 5           # push-style expansions
FS_PULL = 6           # dense pull expansions (worklist overflow)
FS_EXPAND_WORK = 7    # Σ δ_N worklist sizes fed to expansion
FS_NB = 8             # per-bucket active-row counters start here


def fstats_init(n_buckets: int, device=None) -> torch.Tensor:
    """Zeroed frontier-stats accumulator carried through a solve loop, on
    `device` (CUDA unless named, as every staging call)."""
    return torch.zeros(FS_NB + n_buckets, dtype=torch.int32,
                       device=resolve_device(device))


_FS_NAMES = ("iters", "compact_iters", "compaction_overflows",
             "active_rows", "active_tiles", "push_expands", "pull_expands",
             "expansion_work")


def publish_fstats(fs, registry=None) -> None:
    """Fold a loop's fstats vector into the host registry (`frontier.*`
    and `frontier.active_rows.b{b}`), reading it from the device once."""
    reg = registry if registry is not None else get_registry()
    vals = fs.cpu().tolist()
    for name, v in zip(_FS_NAMES, vals):
        reg.inc(f"frontier.{name}", v)
    for b, v in enumerate(vals[FS_NB:]):
        reg.inc(f"frontier.active_rows.b{b}", v)
