"""Host-side graph representation and dynamic-batch machinery.

A numpy copy of the JAX package's `repro.core.graph` (which cannot be
imported without JAX): same builders, same generators, so the same seed
gives array-identical graphs and layouts in both packages.

The paper (Sahu 2024) stores the *transpose* of the current graph G^t' in CSR on
the GPU for pull-based rank computation, and the forward graph G^t for marking
affected vertices. We keep both, plus the hybrid layout:

  * low in-degree vertices (deg <= d_p)  -> degree-bucketed ELLPACK blocks
    (the paper's thread-per-vertex side), and
  * high in-degree vertices              -> tile-padded CSR slices
    (the paper's block-per-vertex side).

All construction is host-side numpy (the paper likewise builds CSR on the CPU
before copying to the device); `core.pagerank.to_device` stages the tensors.
Dead ends are eliminated by adding a self-loop to every vertex (paper §5.1.4),
which the DF-P closed form (Eq. 2) then absorbs.

Deduplication and membership are spelled with `np.sort` and
`np.searchsorted` (`_sorted_unique`, `_isin`) instead of `np.unique` and
`np.isin`: the same arrays, but numpy 2.3's `np.unique` (which `np.isin`
calls) runs far slower than a sort on tens of millions of int64 keys,
which put a full-size build (|E| ≈ 68M) at minutes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

__all__ = [
    "Graph",
    "EllBucket",
    "HybridLayout",
    "HybridRows",
    "BatchUpdate",
    "build_graph",
    "add_self_loops",
    "graph_from_sorted_keys",
    "apply_batch",
    "random_graph",
    "powerlaw_graph",
    "random_batch",
    "temporal_stream",
    "edge_keys",
    "keys_to_edges",
    "next_pow2",
    "ragged_positions",
    "bucket_band_counts",
    "choose_bucket_widths",
    "build_hybrid_rows",
    "build_hybrid",
    "hybrid_caps",
    "layout_slot_stats",
]


# ---------------------------------------------------------------------------
# Edge-key and ragged-index primitives (shared with repro.stream)
# ---------------------------------------------------------------------------

def edge_keys(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Pack (src, dst) pairs into sortable int64 keys (src-major order)."""
    return np.asarray(src, np.int64) * n + np.asarray(dst, np.int64)


def keys_to_edges(n: int, keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of `edge_keys`."""
    return (keys // n).astype(np.int32), (keys % n).astype(np.int32)


def next_pow2(x, floor: int = 16) -> int:
    """Smallest power of two >= max(x, 1), floored for bucket stability.

    The shared shape-bucketing policy: jitted engines see capacities only
    from this ladder, so the compact engine, the stream delta padding, and
    the snapshot scatter paths all compile O(log) variants total.
    """
    return max(floor, 1 << int(np.ceil(np.log2(max(1, x)))))


def ragged_positions(counts: np.ndarray) -> np.ndarray:
    """Within-segment positions for ragged data: counts [k] -> [sum(counts)]
    array 0..c0-1, 0..c1-1, ... — one vectorized pass, no Python loop."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = np.cumsum(counts) - counts
    return np.arange(total, dtype=np.int64) - np.repeat(starts, counts)


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable CSR graph (forward) + its transpose, self-loops guaranteed.

    offsets/targets   : CSR of G   (out-edges)  -- used for frontier marking.
    t_offsets/t_sources: CSR of G' (in-edges)   -- used for rank pull.
    """

    n: int
    offsets: np.ndarray      # [n+1] int64
    targets: np.ndarray      # [m]   int32
    t_offsets: np.ndarray    # [n+1] int64
    t_sources: np.ndarray    # [m]   int32

    @property
    def m(self) -> int:
        return int(self.targets.shape[0])

    def out_degree(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int32)

    def in_degree(self) -> np.ndarray:
        return np.diff(self.t_offsets).astype(np.int32)

    def edges(self) -> Tuple[np.ndarray, np.ndarray]:
        src = np.repeat(np.arange(self.n, dtype=np.int32), np.diff(self.offsets))
        return src, self.targets.copy()

    def has_edge(self, u: int, v: int) -> bool:
        lo, hi = self.offsets[u], self.offsets[u + 1]
        return bool(np.any(self.targets[lo:hi] == v))

    def transpose(self) -> "Graph":
        """G' with edge directions reversed (shares the underlying arrays).

        `build_hybrid(g)` lays out *in*-neighbors; `build_hybrid(g.transpose())`
        therefore lays out out-neighbors — the forward orientation used for
        compacted frontier expansion.
        """
        return Graph(n=self.n, offsets=self.t_offsets, targets=self.t_sources,
                     t_offsets=self.offsets, t_sources=self.targets)


@dataclasses.dataclass(frozen=True)
class BatchUpdate:
    """A batch Δ^t: edge deletions (u,v) and insertions (u,v), dedup'd."""

    del_src: np.ndarray  # int32 [nd]
    del_dst: np.ndarray  # int32 [nd]
    ins_src: np.ndarray  # int32 [ni]
    ins_dst: np.ndarray  # int32 [ni]

    @property
    def size(self) -> int:
        return int(self.del_src.shape[0] + self.ins_src.shape[0])


def _sorted_unique(a: np.ndarray) -> np.ndarray:
    """np.unique(a) for a 1-D array: sort, then drop repeats."""
    a = np.sort(a)
    if a.size:
        a = a[np.concatenate(([True], a[1:] != a[:-1]))]
    return a


def _isin(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """np.isin(a, b): binary search of each element of a in sorted b."""
    b = _sorted_unique(b)
    if not b.size:
        return np.zeros(a.shape, bool)
    pos = np.minimum(np.searchsorted(b, a), b.size - 1)
    return b[pos] == a


def _csr_from_edges(n: int, src: np.ndarray, dst: np.ndarray):
    """Build CSR from an edge list (duplicates removed); returns offsets, targets."""
    if src.size:
        key = src.astype(np.int64) * n + dst.astype(np.int64)
        key = _sorted_unique(key)
        src = (key // n).astype(np.int32)
        dst = (key % n).astype(np.int32)
    counts = np.bincount(src, minlength=n).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets, dst.astype(np.int32), src, dst


def build_graph(n: int, src: np.ndarray, dst: np.ndarray,
                self_loops: bool = True) -> Graph:
    """Construct a Graph from edge arrays; optionally augment with self-loops."""
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    if self_loops:
        src, dst = add_self_loops(n, src, dst)
    offsets, targets, usrc, udst = _csr_from_edges(n, src, dst)
    # transpose CSR
    t_offsets, t_sources, _, _ = _csr_from_edges(n, udst, usrc)
    return Graph(n=n, offsets=offsets, targets=targets,
                 t_offsets=t_offsets, t_sources=t_sources)


def graph_from_sorted_keys(n: int, keys: np.ndarray) -> Graph:
    """Build a Graph from already-unique, already-sorted edge keys.

    The rebuild path of `repro_torch.stream.snapshot`: the maintained key
    set is sorted src-major, so the forward CSR falls out of a single
    bincount (no dedup sort as in `build_graph`).
    """
    src, dst = keys_to_edges(n, keys)
    counts = np.bincount(src, minlength=n).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(dst, kind="stable")
    t_counts = np.bincount(dst, minlength=n).astype(np.int64)
    t_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(t_counts, out=t_offsets[1:])
    return Graph(n=n, offsets=offsets, targets=dst,
                 t_offsets=t_offsets, t_sources=src[order])


def add_self_loops(n: int, src: np.ndarray, dst: np.ndarray):
    """(src, dst) as int32 with the n self-loops (v, v) appended."""
    loops = np.arange(n, dtype=np.int32)
    return (np.concatenate([np.asarray(src, np.int32), loops]),
            np.concatenate([np.asarray(dst, np.int32), loops]))


def apply_batch(g: Graph, batch: BatchUpdate) -> Graph:
    """Apply Δ^t to g, returning G^t (self-loops preserved — never deleted)."""
    src, dst = g.edges()
    if batch.del_src.size:
        key = src.astype(np.int64) * g.n + dst.astype(np.int64)
        dkey = batch.del_src.astype(np.int64) * g.n + batch.del_dst.astype(np.int64)
        # never delete self-loops (paper re-adds them with every batch)
        dkey = dkey[batch.del_src != batch.del_dst]
        keep = ~_isin(key, dkey)
        src, dst = src[keep], dst[keep]
    if batch.ins_src.size:
        src = np.concatenate([src, batch.ins_src.astype(np.int32)])
        dst = np.concatenate([dst, batch.ins_dst.astype(np.int32)])
    return build_graph(g.n, src, dst, self_loops=True)


# ---------------------------------------------------------------------------
# Hybrid degree-bucketed ELL + tiled-CSR device layout (the paper's
# degree-partitioned kernels, generalized to a multi-bucket low side)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EllBucket:
    """One dense ELL block of the low side: rows whose degree fits `width`.

    rows [cap] int32 : row id per slot (sentinel = n_rows for unused slots)
    idx  [cap, width] int32 : neighbor ids, padded with 0
    mask [cap, width] f32   : 1.0 for real edges, 0.0 for padding
    """

    width: int
    rows: np.ndarray
    idx: np.ndarray
    mask: np.ndarray

    @property
    def cap(self) -> int:
        return int(self.rows.shape[0])


def choose_bucket_widths(deg: np.ndarray, d_p: int,
                         max_buckets: int = 4) -> Tuple[int, ...]:
    """Pick ELL bucket widths from the degree histogram (Gunrock-style
    multi-bucket load balancing, arXiv:1701.01170).

    Candidates are the powers of two below `d_p` plus `d_p` itself; a small
    exact DP picks the subset (always containing `d_p`, at most
    `max_buckets`) that minimizes total ELL slots when every row of degree
    <= d_p is stored at the smallest chosen width that fits it. Ties prefer
    fewer buckets. `d_p <= 0` means no ELL side at all -> ().
    """
    if d_p <= 0:
        return ()
    ladder = []
    w = 1
    while w < d_p:
        ladder.append(w)
        w <<= 1
    ladder.append(d_p)
    deg = np.asarray(deg, np.int64)
    low_deg = deg[deg <= d_p]
    if low_deg.size == 0:
        return (d_p,)
    grp = np.searchsorted(ladder, np.maximum(low_deg, 1), side="left")
    counts = np.bincount(grp, minlength=len(ladder)).astype(np.int64)
    pre = np.concatenate([[0], np.cumsum(counts)])
    k = len(ladder)
    inf = float("inf")
    best = [[inf] * (max_buckets + 1) for _ in range(k)]
    back = [[None] * (max_buckets + 1) for _ in range(k)]
    for i in range(k):
        best[i][1] = ladder[i] * int(pre[i + 1])
        for j in range(2, max_buckets + 1):
            for p in range(i):
                cost = best[p][j - 1] + ladder[i] * int(pre[i + 1] - pre[p + 1])
                if cost < best[i][j]:
                    best[i][j] = cost
                    back[i][j] = p
    bj, bcost = 1, best[k - 1][1]
    for j in range(2, max_buckets + 1):
        if best[k - 1][j] < bcost:
            bcost = best[k - 1][j]
            bj = j
    sel = [k - 1]
    i, j = k - 1, bj
    while j > 1:
        i = back[i][j]
        sel.append(i)
        j -= 1
    return tuple(ladder[i] for i in sorted(sel))


def bucket_band_counts(deg: np.ndarray, widths: Tuple[int, ...],
                       d_p: int) -> Tuple[int, ...]:
    """Rows each bucket can hold under the streaming hysteresis.

    Bucket b's occupancy band is (widths[b-1]//2, widths[b]] — a row
    demotes out of b only once its degree drops to half the *narrower*
    width, so every degree in that band may legally sit in b (bucket 0's
    band is [0, widths[0]]). Bands of adjacent buckets overlap, so these
    are per-bucket upper bounds, not a partition: streaming capacity
    planning must use them instead of the initial placement counts, or
    migration drift exhausts a bucket that the placement census said was
    big enough.
    """
    deg = np.asarray(deg, np.int64)
    low = deg[deg <= d_p]
    out = []
    for bi, w in enumerate(widths):
        if bi == 0:
            out.append(int((low <= w).sum()))
        else:
            floor = widths[bi - 1] // 2
            out.append(int(((low > floor) & (low <= w)).sum()))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class HybridLayout:
    """Device-friendly pull layout for the transpose graph G'.

    Low side (in-degree <= d_p): degree buckets — `buckets[b]` is a dense
    `[cap_b, widths[b]]` ELL block holding every row whose degree fits
    `widths[b]` but not `widths[b-1]`, with its own row-id map (see
    `EllBucket`). `bucket_of[v]` gives the bucket index (== len(widths)
    for CSR-side rows) and `slot_of[v]` the row's slot within its side.
    CSR side (high in-degree), tile-padded to `tile` edges:
      hi_ids    [n_hi_cap]      int32 : vertex id per high vertex (pad = n)
      hi_tiles  [t_cap, tile]   int32 : in-neighbor ids, tiles padded with 0
      hi_tmask  [t_cap, tile]   f32   : edge validity
      hi_rowmap [t_cap]         int32 : which *high-slot* each tile belongs to
    Common:
      is_low   [n] bool ; out_deg [n] int32 (of G, for contributions)
      perm     [n] int32 : partition order, low-degree vertices first (Alg. 4)
      n_low    int
    """

    d_p: int
    tile: int
    widths: Tuple[int, ...]
    buckets: Tuple[EllBucket, ...]
    bucket_of: np.ndarray
    slot_of: np.ndarray
    hi_ids: np.ndarray
    hi_tiles: np.ndarray
    hi_tmask: np.ndarray
    hi_rowmap: np.ndarray
    is_low: np.ndarray
    out_deg: np.ndarray
    perm: np.ndarray
    n_low: int

    @property
    def n(self) -> int:
        return int(self.is_low.shape[0])

    @property
    def n_hi_cap(self) -> int:
        return int(self.hi_ids.shape[0])


@dataclasses.dataclass(frozen=True)
class HybridRows:
    """Hybrid bucketed-ELL + tiled-CSR layout of `n_rows` ragged rows — one
    orientation, no graph semantics attached.

    This is the layout *primitive* both scales share: `build_hybrid` wraps it
    for the single-device full graph (row = vertex, ids = global), and
    `core.distributed.build_sharded` stacks one per shard (row = local
    vertex, stored ids = global column ids). Field conventions match
    `HybridLayout`: bucket `rows` and `hi_ids` hold row ids with sentinel
    `n_rows` for unused slots, `hi_rowmap` points pad tiles at slot
    `n_hi_cap - 1` (mask 0).
    """

    d_p: int
    tile: int
    widths: Tuple[int, ...]
    buckets: Tuple[EllBucket, ...]
    bucket_of: np.ndarray   # [n_rows] int32 (len(widths) = CSR side / none)
    slot_of: np.ndarray     # [n_rows] int32 (slot within bucket or hi side)
    hi_ids: np.ndarray      # [n_hi_cap]    int32 (sentinel = n_rows)
    hi_tiles: np.ndarray    # [t_cap, tile] int32
    hi_tmask: np.ndarray    # [t_cap, tile] f32
    hi_rowmap: np.ndarray   # [t_cap]       int32
    is_low: np.ndarray      # [n_rows]      bool
    row_deg: np.ndarray     # [n_rows]      int64

    @property
    def n(self) -> int:
        return int(self.is_low.shape[0])

    @property
    def n_hi_cap(self) -> int:
        return int(self.hi_ids.shape[0])


def _ragged_copy(shape, dst_base, src_base, counts, data):
    """Zero-filled (int32 values, f32 mask) of `shape` holding, for each
    row r and j < counts[r], data[src_base[r] + j] at flat position
    dst_base[r] + j, with the mask 1 there."""
    size = int(np.prod(shape))
    vals = np.zeros(size, np.int32)
    mask = np.zeros(size, np.float32)
    pos = ragged_positions(counts)
    at = np.repeat(dst_base, counts) + pos
    vals[at] = data[np.repeat(src_base, counts) + pos]
    mask[at] = 1.0
    return vals.reshape(shape), mask.reshape(shape)


def build_hybrid_rows(offsets: np.ndarray, data: np.ndarray,
                      d_p: int = 64, tile: int = 1024,
                      n_rows: Optional[int] = None,
                      n_hi_cap: Optional[int] = None,
                      t_cap: Optional[int] = None,
                      widths: Optional[Tuple[int, ...]] = None,
                      bucket_caps: Optional[Tuple[int, ...]] = None
                      ) -> HybridRows:
    """Vectorized hybrid layout of ragged rows (the shared Alg. 4 split).

    `offsets` [k+1] / `data` [offsets[-1]] describe k ragged rows; `n_rows`
    (>= k, default k) pads trailing empty rows so callers can present a
    fixed row capacity (sharded blocks pad |V| to a multiple of the shard
    count). Rows with more than `d_p` entries go to the tiled-CSR side;
    rows with <= d_p entries go to the ELL bucket of the smallest width
    that fits them. `widths` defaults to `choose_bucket_widths` over the
    degree histogram; `bucket_caps` / `n_hi_cap` / `t_cap` fix capacities
    so repeated builds keep identical device shapes (default: exact current
    sizes). Vectorized ragged-fill passes — no per-row Python loop.
    """
    offsets = np.asarray(offsets, np.int64)
    data = np.asarray(data, np.int32)
    k = int(offsets.shape[0]) - 1
    if n_rows is None:
        n_rows = k
    assert n_rows >= k, "n_rows smaller than the described row count"
    deg = np.zeros(n_rows, np.int64)
    deg[:k] = np.diff(offsets)
    is_low = deg <= d_p

    if widths is None:
        widths = choose_bucket_widths(deg[:k], d_p)
    widths = tuple(int(w) for w in widths)
    assert list(widths) == sorted(set(widths)), "widths must be ascending"
    if widths:
        assert widths[-1] == d_p, "top bucket width must equal d_p"
    else:
        assert d_p <= 0, "d_p > 0 requires at least one ELL bucket"
    n_buckets = len(widths)

    # --- ELL buckets (one vectorized ragged-fill pass per bucket) ----------
    bucket_of = np.full(n_rows, n_buckets, dtype=np.int32)
    slot_of = np.zeros(n_rows, dtype=np.int32)
    if n_buckets:
        low_rows = np.nonzero(is_low)[0]
        bucket_of[low_rows] = np.searchsorted(
            widths, np.maximum(deg[low_rows], 1), side="left")
    buckets = []
    for bi, w in enumerate(widths):
        rows_b = np.nonzero(bucket_of == bi)[0]
        cnt = int(rows_b.size)
        cap = max(cnt, 1) if bucket_caps is None else int(bucket_caps[bi])
        assert cnt <= cap, f"bucket_caps[{bi}] too small for this snapshot"
        rows_arr = np.full(cap, n_rows, dtype=np.int32)
        rows_arr[:cnt] = rows_b
        slot_of[rows_b] = np.arange(cnt, dtype=np.int32)
        real = rows_b[rows_b < k]     # rows >= k are empty, nothing to fill
        idx, mask = _ragged_copy((cap, w), slot_of[real].astype(np.int64) * w,
                                 offsets[real], deg[real], data)
        buckets.append(EllBucket(width=w, rows=rows_arr, idx=idx, mask=mask))

    # --- tiled CSR side (single scatter; no per-row Python loop) -----------
    hi = np.nonzero(~is_low)[0].astype(np.int32)
    n_hi = int(hi.size)
    if n_hi_cap is None:
        n_hi_cap = max(n_hi, 1)
    assert n_hi <= n_hi_cap, "n_hi_cap too small for this snapshot"
    deg_hi = deg[hi]
    nt_per = (deg_hi + tile - 1) // tile            # tiles per high row
    nt_total = int(nt_per.sum())
    if t_cap is None:
        t_cap = max(nt_total, 1)
    assert nt_total <= t_cap, "t_cap too small for this snapshot"
    # every high entry's flat position inside the [t_cap*tile] pool: per-row
    # base (cumsum of nt*tile) + within-row position
    base = np.cumsum(nt_per * tile) - nt_per * tile
    hi_tiles, hi_tmask = _ragged_copy((t_cap, tile), base, offsets[hi],
                                      deg_hi, data)
    hi_rowmap = np.full(t_cap, n_hi_cap - 1, dtype=np.int32)  # pad tiles -> last slot, mask=0
    hi_rowmap[:nt_total] = np.repeat(np.arange(n_hi, dtype=np.int32), nt_per)
    hi_ids = np.full(n_hi_cap, n_rows, dtype=np.int32)  # sentinel = "no row"
    hi_ids[:n_hi] = hi
    slot_of[hi] = np.arange(n_hi, dtype=np.int32)

    return HybridRows(d_p=d_p, tile=tile, widths=widths,
                      buckets=tuple(buckets), bucket_of=bucket_of,
                      slot_of=slot_of, hi_ids=hi_ids, hi_tiles=hi_tiles,
                      hi_tmask=hi_tmask, hi_rowmap=hi_rowmap, is_low=is_low,
                      row_deg=deg)


def build_hybrid(g: Graph, d_p: int = 64, tile: int = 1024,
                 n_hi_cap: Optional[int] = None,
                 t_cap: Optional[int] = None,
                 widths: Optional[Tuple[int, ...]] = None,
                 bucket_caps: Optional[Tuple[int, ...]] = None
                 ) -> HybridLayout:
    """Partition vertices by in-degree (Alg. 4) and build the hybrid layout.

    A thin graph-aware wrapper over `build_hybrid_rows` (rows = in-neighbor
    lists of the transpose CSR). `widths` defaults to the degree-histogram
    bucket choice; `bucket_caps` / `n_hi_cap` / `t_cap` allow fixed
    capacities across dynamic snapshots so device shapes stay stable; they
    default to the exact current sizes.
    """
    from .partition import partition_by_degree

    indeg = g.in_degree()
    perm, n_low = partition_by_degree(indeg, d_p)
    hr = build_hybrid_rows(g.t_offsets, g.t_sources, d_p=d_p, tile=tile,
                           n_hi_cap=n_hi_cap, t_cap=t_cap,
                           widths=widths, bucket_caps=bucket_caps)
    return HybridLayout(
        d_p=d_p, tile=tile, widths=hr.widths, buckets=hr.buckets,
        bucket_of=hr.bucket_of, slot_of=hr.slot_of,
        hi_ids=hr.hi_ids, hi_tiles=hr.hi_tiles, hi_tmask=hr.hi_tmask,
        hi_rowmap=hr.hi_rowmap, is_low=hr.is_low, out_deg=g.out_degree(),
        perm=perm, n_low=int(n_low))


def hybrid_caps(lay) -> dict:
    """Capacity signature of a layout — pass as **caps to `build_hybrid` to
    rebuild a later snapshot with identical device shapes (no recompiles)."""
    return dict(d_p=lay.d_p, tile=lay.tile, n_hi_cap=lay.n_hi_cap,
                t_cap=int(lay.hi_tiles.shape[0]), widths=lay.widths,
                bucket_caps=tuple(b.cap for b in lay.buckets))


def layout_slot_stats(lay) -> dict:
    """Edge-slot efficiency of a layout: how many slots one full pull
    gathers vs how many real edges it carries (padded-edge accounting).

    Works on HybridRows / HybridLayout. `ell_slots` counts every bucket's
    `cap * width`; `hi_slots` counts `t_cap * tile`; `real_edges` counts
    mask bits actually set. `gathered_slots / real_edges` is the padding
    overhead one iteration pays.
    """
    ell_slots = sum(b.cap * b.width for b in lay.buckets)
    hi_slots = int(lay.hi_tiles.shape[0] * lay.hi_tiles.shape[1])
    real = int(sum(int(b.mask.sum()) for b in lay.buckets)
               + int(lay.hi_tmask.sum()))
    return dict(real_edges=real, ell_slots=ell_slots, hi_slots=hi_slots,
                gathered_slots=ell_slots + hi_slots)


# ---------------------------------------------------------------------------
# Synthetic graph + batch generators (paper §5.1.3/5.1.4 protocol, scaled down)
# ---------------------------------------------------------------------------

def random_graph(n: int, m: int, seed: int = 0) -> Graph:
    """Uniform random directed graph with self-loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m, dtype=np.int64).astype(np.int32)
    dst = rng.integers(0, n, size=m, dtype=np.int64).astype(np.int32)
    return build_graph(n, src, dst, self_loops=True)


def powerlaw_graph(n: int, m: int, alpha: float = 2.1, seed: int = 0) -> Graph:
    """Power-law in-degree graph (Zipf targets) — exercises the high/low split."""
    rng = np.random.default_rng(seed)
    # Zipf-ranked popularity for *targets* => skewed in-degree
    ranks = np.arange(1, n + 1, dtype=np.float64)
    p = ranks ** (-alpha)
    p /= p.sum()
    dst = rng.choice(n, size=m, p=p).astype(np.int32)
    src = rng.integers(0, n, size=m, dtype=np.int64).astype(np.int32)
    return build_graph(n, src, dst, self_loops=True)


def random_batch(g: Graph, frac: float, insert_frac: float = 0.8,
                 seed: int = 0) -> BatchUpdate:
    """Paper §5.1.4: batch of size frac*|E|, 80% insertions / 20% deletions.

    Insertions pick uniform vertex pairs; deletions sample existing edges
    uniformly. No vertices are added/removed. Self-loops survive deletion.
    """
    rng = np.random.default_rng(seed)
    b = max(1, int(round(frac * g.m)))
    ni = int(round(b * insert_frac))
    nd = b - ni
    ins_src = rng.integers(0, g.n, size=ni).astype(np.int32)
    ins_dst = rng.integers(0, g.n, size=ni).astype(np.int32)
    src, dst = g.edges()
    if nd > 0 and g.m > 0:
        pick = rng.integers(0, g.m, size=nd)
        del_src, del_dst = src[pick], dst[pick]
        nonloop = del_src != del_dst
        del_src, del_dst = del_src[nonloop], del_dst[nonloop]
    else:
        del_src = del_dst = np.zeros(0, np.int32)
    return BatchUpdate(del_src=del_src, del_dst=del_dst,
                       ins_src=ins_src, ins_dst=ins_dst)


def temporal_stream(n: int, n_edges: int, n_batches: int, warm_frac: float = 0.9,
                    seed: int = 0):
    """Emulate the real-world-dynamic protocol: preferential-attachment-ish
    temporal edge stream; load `warm_frac` as the base graph, then yield
    `n_batches` insertion-only batches of the remainder (paper §5.1.4).

    Returns (base_graph, [BatchUpdate...]).
    """
    rng = np.random.default_rng(seed)
    # growing-popularity stream: later edges prefer earlier vertices (Zipf)
    ranks = np.arange(1, n + 1, dtype=np.float64) ** -1.5
    p = ranks / ranks.sum()
    src = rng.choice(n, size=n_edges, p=p).astype(np.int32)
    dst = rng.choice(n, size=n_edges, p=p).astype(np.int32)
    warm = int(n_edges * warm_frac)
    base = build_graph(n, src[:warm], dst[:warm], self_loops=True)
    rest = n_edges - warm
    per = max(1, rest // n_batches)
    batches = []
    for k in range(n_batches):
        lo = warm + k * per
        hi = min(warm + (k + 1) * per, n_edges)
        if lo >= hi:
            break
        batches.append(BatchUpdate(
            del_src=np.zeros(0, np.int32), del_dst=np.zeros(0, np.int32),
            ins_src=src[lo:hi], ins_dst=dst[lo:hi]))
    return base, batches
