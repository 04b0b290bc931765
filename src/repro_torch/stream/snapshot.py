"""Incremental device-resident snapshot maintenance.

``DeviceSnapshot`` owns both hybrid layouts of the current graph G^t —

  * the **pull** half (rows = in-neighbors): rank pull + frontier expansion,
  * the **fwd** half (rows = out-neighbors): compacted frontier scatter —

and applies a canonical ``Delta`` *in place*: O(|Δ| · d_p) host bookkeeping
plus O(touched rows) device scatters, instead of the O(|E|) host rebuild
(`apply_batch` + `build_hybrid`) the static pipeline pays per batch.

Mechanics per edited row (mirrors are host numpy; the device tensors are
updated by row/tile scatters, the `kernels.stream_scatter` kernel on CUDA):

  * low-degree endpoints: bucketed-ELL slot edits — append at the row's
    fill cursor, delete by swapping the last valid entry into the hole; a
    row that outgrows its bucket's width promotes to the next wider bucket,
    one that shrinks to half the narrower width demotes (per-bucket free
    lists, same swap discipline as the tile pool);
  * high-degree endpoints: tile-slot edits against a **free list** — the
    last tile of a vertex is the only partial one, so inserts append there
    (allocating a fresh tile when it fills) and deletes swap from it
    (freeing it when it empties);
  * degree-crossing vertices migrate between sides: deg > d_p promotes a
    row out of the ELL into tiles; demotion back happens only once deg
    drops to `low_water` (< d_p hysteresis) to avoid thrash, parking some
    sub-d_p vertices on the tile side — the *fragmentation* this design
    tolerates, bounded by `frag_budget`.

Fallback: capacity exhaustion (slot/tile free list empty), fragmentation
above budget, or a batch too large for incremental maintenance to win
(`rebuild_threshold` · |E|) all route to a full `build_hybrid` rebuild at
fixed capacities (grown by pow2 when genuinely exceeded).

A copy of the JAX package's `repro.stream.snapshot`: the same free lists,
the same placement order, so every host mirror and every device tensor is
array-equal to the JAX snapshot's after the same deltas. What differs:

  * **Updates happen in place.** JAX arrays are immutable, so a `snap.dg`
    taken before `apply` still sees the old graph there. Here the device
    tensors are written in place (row scatters, and `copy_` for the side
    tables), on the CPU as on CUDA: after `apply`, every `DeviceGraph`
    taken earlier from this snapshot sees the edits too — until a rebuild,
    which stages new tensors and leaves earlier ones stale. Take `snap.dg`
    afresh after every `apply`; keep none across it.
  * The slot→tile table of the port's `DeviceGraph` (`hi_slot_tiles`,
    `hi_slot_off`, which the `csr_block_pull` kernel sums over) is rebuilt
    from the mirror whenever a tile is allocated or freed.
  * The edited-row lists are not padded to a power of two (there is no
    `jit` to keep shapes few).

Every `apply` feeds the `obs` registry with the JAX package's names: spans
``snapshot.apply_net_delta``, ``snapshot.host_edit``, ``snapshot.rebuild``
and ``snapshot.device_refresh`` (annotated, so the refresh's
``scatter_rows`` launch falls inside that range of a ``torch.profiler``
capture; it ends in a synchronize, so it times the device), counters
``snapshot.rebuilds``, ``snapshot.rebuild.<reason>``,
``snapshot.inplace_batches``, ``snapshot.rows_touched``,
``snapshot.tiles_touched``, ``snapshot.migrations``, and the flight event
``snapshot.rebuild``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.graph import (Graph, bucket_band_counts, build_hybrid,
                          choose_bucket_widths, edge_keys,
                          graph_from_sorted_keys, keys_to_edges, next_pow2)
from ..core.pagerank import (DeviceGraph, EllBlock, resolve_device,
                             slot_tile_table)
from ..kernels.stream_scatter import scatter_rows_batch
from ..obs.flight import get_flight
from ..obs.spans import get_registry as _obs
from .delta import Delta

__all__ = ["CapacityError", "DeviceSnapshot", "SnapshotStats",
           "apply_net_delta", "rebuild_reason"]


class CapacityError(RuntimeError):
    """A fixed-capacity structure (hi slots / tile pool) is exhausted."""


@dataclasses.dataclass
class SnapshotStats:
    """Per-apply accounting (replay aggregates these into latency records)."""
    net_ins: int = 0
    net_del: int = 0
    rows_touched: int = 0
    tiles_touched: int = 0
    migrations: int = 0
    rebuilt: bool = False
    rebuild_reason: str = ""
    host_s: float = 0.0
    device_s: float = 0.0


def _stage(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A device tensor holding a copy of `a`. `torch.from_numpy` aliases
    the buffer, and the mirrors are edited in place across batches, so on
    the CPU the tensor is cloned; `.to(cuda)` copies anyway."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.clone() if dev.type == "cpu" else t.to(dev)


def _restage(dst: torch.Tensor, a: np.ndarray) -> None:
    """Overwrite the device tensor `dst` in place with the mirror `a`."""
    dst.copy_(torch.from_numpy(np.ascontiguousarray(a)))


def _sync(dev: torch.device) -> None:
    """Wait for the device, so a host clock read next times the work."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _scatter_from_host(jobs, dev: torch.device) -> None:
    """Write host rows into device tables, in place, with one copy to the
    device and one `scatter_rows_batch` call.

    `jobs`: (dst, dst_mask or None, ids, new, new_mask or None) with dst
    (and dst_mask) a device table [R, d] of 32-bit words, ids [k] int32
    and new (new_mask) [k, d] numpy rows of the destination's dtype. All
    of them are packed, as raw 32-bit words, into one host buffer (pinned
    on CUDA, fresh per call: PyTorch's pinned-memory cache keeps a block
    from reuse until the copy out of it has run), every segment starting
    on a 16-byte boundary so the kernel's vector path stays open."""
    if not jobs:
        return
    def pad(words):                 # to the next 16-byte boundary
        return -(-words // 4) * 4

    total = sum(pad(ids.size) + pad(new.size)
                + (0 if new_m is None else pad(new_m.size))
                for _, _, ids, new, new_m in jobs)
    buf = torch.empty(total, dtype=torch.int32,
                      pin_memory=dev.type == "cuda")
    words = buf.numpy()
    spans, at = [], 0
    for _, _, ids, new, new_m in jobs:
        seg = []
        for a in (ids, new, new_m):
            if a is None:
                seg.append(None)
                continue
            if a.dtype.itemsize != 4:
                raise TypeError(f"scatter rows of dtype {a.dtype}: the "
                                "tables hold 32-bit words")
            words[at:at + a.size] = np.ascontiguousarray(a).reshape(
                -1).view(np.int32)
            seg.append((at, a.shape))
            at += pad(a.size)
        spans.append(seg)
    on_dev = buf.to(dev, non_blocking=True) if dev.type == "cuda" else buf

    def view(span, dtype):
        at, shape = span
        n = int(np.prod(shape))
        return on_dev[at:at + n].view(dtype).view(shape)

    scatter_rows_batch([
        (dst, dst_m, view(sp[0], torch.int32), view(sp[1], dst.dtype),
         None if sp[2] is None else view(sp[2], dst_m.dtype))
        for (dst, dst_m, _, _, _), sp in zip(jobs, spans)])


def apply_net_delta(keys: np.ndarray, n: int, delta: Delta,
                    indeg: np.ndarray, outdeg: np.ndarray):
    """Net-effect of a canonical Δ against the sorted edge-key set.

    Deletions of absent edges and insertions of present edges are no-ops
    (one vectorized searchsorted membership pass each); the key set is
    maintained sorted; `indeg`/`outdeg` are updated IN PLACE.

    Returns (keys', (d_s, d_d), (i_s, i_d)) — the *net* edge arrays.
    """
    dk = edge_keys(n, delta.del_src, delta.del_dst)
    pos = np.searchsorted(keys, dk)
    found = (pos < keys.size)
    found[found] = keys[pos[found]] == dk[found]
    net_del = dk[found]
    ik = edge_keys(n, delta.ins_src, delta.ins_dst)
    pos = np.searchsorted(keys, ik)
    present = (pos < keys.size)
    present[present] = keys[pos[present]] == ik[present]
    net_ins = ik[~present]
    # maintain the sorted key set (O(|E|) memmove, vectorized)
    if net_del.size:
        keys = np.delete(keys, np.searchsorted(keys, net_del))
    if net_ins.size:
        at = np.searchsorted(keys, net_ins)
        keys = np.insert(keys, at, net_ins)
    # degree bookkeeping
    d_s, d_d = keys_to_edges(n, net_del)
    i_s, i_d = keys_to_edges(n, net_ins)
    np.subtract.at(outdeg, d_s, 1)
    np.subtract.at(indeg, d_d, 1)
    np.add.at(outdeg, i_s, 1)
    np.add.at(indeg, i_d, 1)
    return keys, (d_s, d_d), (i_s, i_d)


def rebuild_reason(delta_size: int, m: int, fragmentation: float,
                   threshold: float, budget: float):
    """The rebuild-over-incremental decision: a batch above the cost
    crossover or fragmentation over budget. Returns a reason or None."""
    if delta_size > threshold * max(m, 1):
        return "batch_too_large"
    if fragmentation > budget:
        return "fragmentation"
    return None


class _HalfLayout:
    """Host mirror of one orientation's hybrid layout with in-place edits,
    and its device tensors.

    `row_deg[v]` is the number of neighbors in row v (in-degree for the pull
    half, out-degree for the fwd half). The DeviceGraph's `out_deg` field is
    the *opposite* orientation's degree and is owned by the snapshot.

    The low side is the degree-bucketed ELL: each bucket keeps its own
    [cap_b, w_b] idx/mask mirrors, row-id map and free-slot list. A row
    that outgrows its bucket's width migrates to the next wider bucket (or
    to the tile side past d_p); a row that shrinks migrates down only once
    its degree drops to half the *destination* width (bucket hysteresis) —
    or, from the tile side, to `low_water` (the d_p hysteresis).
    """

    def __init__(self, lay, row_deg: np.ndarray, device: torch.device,
                 low_water: Optional[int] = None):
        n = lay.n
        self.n, self.d_p, self.tile = n, lay.d_p, lay.tile
        self.device = device
        self.low_water = (max(self.d_p // 2, 1) if low_water is None
                          else min(low_water, self.d_p))
        self.widths = tuple(lay.widths)
        self.bk_rows = [np.ascontiguousarray(b.rows) for b in lay.buckets]
        self.bk_idx = [np.ascontiguousarray(b.idx) for b in lay.buckets]
        self.bk_mask = [np.ascontiguousarray(b.mask) for b in lay.buckets]
        self.bucket_of = np.ascontiguousarray(lay.bucket_of)
        self.slot_of = np.ascontiguousarray(lay.slot_of)
        self.hi_tiles = np.ascontiguousarray(lay.hi_tiles)
        self.hi_tmask = np.ascontiguousarray(lay.hi_tmask)
        self.hi_rowmap = np.ascontiguousarray(lay.hi_rowmap)
        self.hi_ids = np.ascontiguousarray(lay.hi_ids)
        self.is_low = np.ascontiguousarray(lay.is_low)
        self.row_deg = row_deg.astype(np.int64).copy()
        # slot / tile occupancy, reconstructed from the built layout: ELL
        # bucket slots [0, cnt_b), hi slots [0, n_hi) and tiles
        # [0, nt_total) are used contiguously. Free lists are consumed LIFO.
        nb = len(self.widths)
        self.free_bslots: List[List[int]] = []
        for bi in range(nb):
            used = np.nonzero(self.bk_rows[bi] < n)[0]
            used_set = set(used.tolist())
            self.free_bslots.append(
                [s for s in range(self.bk_rows[bi].shape[0] - 1, -1, -1)
                 if s not in used_set])
        n_hi_cap = lay.n_hi_cap
        hi = np.nonzero(lay.hi_ids < n)[0]
        self.hi_slot = np.full(n, -1, np.int64)
        self.hi_slot[lay.hi_ids[hi]] = hi
        self.slot_tiles: List[List[int]] = [[] for _ in range(n_hi_cap)]
        used_tiles = np.nonzero(lay.hi_tmask.any(axis=1))[0]
        for t in used_tiles.tolist():
            self.slot_tiles[int(lay.hi_rowmap[t])].append(t)
        used_t = set(used_tiles.tolist())
        self.free_tiles = [t for t in range(lay.hi_tiles.shape[0] - 1, -1, -1)
                           if t not in used_t]
        used_s = set(hi.tolist())
        self.free_slots = [s for s in range(n_hi_cap - 1, -1, -1)
                           if s not in used_s]
        self._clear_dirty()
        self.migrations = 0
        #: the slot / tile ids the last `device_refresh` scattered, by table
        #: (bucket index, or "tiles") — what `chip_smoke.py` replays
        self.last_scatter: dict = {}
        self._stage_device()

    def _clear_dirty(self) -> None:
        nb = len(self.widths)
        self._dirty_slots: List[set] = [set() for _ in range(nb)]
        self._dirty_tiles: set = set()
        self._bmap_dirty = [False] * nb  # bucket rows map changed (migration)
        self._rowmap_dirty = False   # hi_rowmap changed (tile alloc/free)
        self._side_dirty = False     # hi_ids/is_low/bucket_of/slot_of changed

    def _stage_device(self) -> None:
        dev = self.device
        self.dev_bk_rows = [_stage(a, dev) for a in self.bk_rows]
        self.dev_bk_idx = [_stage(a, dev) for a in self.bk_idx]
        self.dev_bk_mask = [_stage(a, dev) for a in self.bk_mask]
        self.dev_bucket_of = _stage(self.bucket_of, dev)
        self.dev_slot_of = _stage(self.slot_of, dev)
        self.dev_hi_tiles = _stage(self.hi_tiles, dev)
        self.dev_hi_tmask = _stage(self.hi_tmask, dev)
        self.dev_hi_rowmap = _stage(self.hi_rowmap, dev)
        slot_tiles, slot_off = slot_tile_table(self.hi_rowmap,
                                               self.hi_ids.shape[0])
        self.dev_hi_slot_tiles = _stage(slot_tiles, dev)
        self.dev_hi_slot_off = _stage(slot_off, dev)
        self.dev_hi_ids = _stage(self.hi_ids, dev)
        self.dev_is_low = _stage(self.is_low, dev)

    # -- checkpoint state -----------------------------------------------------

    def state_dict(self, prefix: str) -> dict:
        """Complete host-mirror state as a flat {name: np.ndarray} dict, in
        the JAX package's names.

        Everything that steers future edits is captured, INCLUDING the
        free-list orders: a free list is consumed LIFO, so its order decides
        where the next insertion lands, which decides gather/summation
        order, which decides the floating-point result. ``slot_tiles``
        (ragged per-slot tile lists) flattens to an offsets+data pair.
        """
        st = {}
        for bi in range(len(self.widths)):
            st[f"{prefix}bk_rows{bi}"] = self.bk_rows[bi]
            st[f"{prefix}bk_idx{bi}"] = self.bk_idx[bi]
            st[f"{prefix}bk_mask{bi}"] = self.bk_mask[bi]
            st[f"{prefix}free_bslots{bi}"] = np.asarray(
                self.free_bslots[bi], np.int64)
        st[f"{prefix}bucket_of"] = self.bucket_of
        st[f"{prefix}slot_of"] = self.slot_of
        st[f"{prefix}hi_tiles"] = self.hi_tiles
        st[f"{prefix}hi_tmask"] = self.hi_tmask
        st[f"{prefix}hi_rowmap"] = self.hi_rowmap
        st[f"{prefix}hi_ids"] = self.hi_ids
        st[f"{prefix}is_low"] = self.is_low
        st[f"{prefix}row_deg"] = self.row_deg
        st[f"{prefix}hi_slot"] = self.hi_slot
        st[f"{prefix}free_tiles"] = np.asarray(self.free_tiles, np.int64)
        st[f"{prefix}free_slots"] = np.asarray(self.free_slots, np.int64)
        off = np.zeros(len(self.slot_tiles) + 1, np.int64)
        off[1:] = np.cumsum([len(t) for t in self.slot_tiles])
        st[f"{prefix}slot_tiles_off"] = off
        st[f"{prefix}slot_tiles_dat"] = np.asarray(
            [t for ts in self.slot_tiles for t in ts], np.int64)
        st[f"{prefix}migrations"] = np.asarray([self.migrations], np.int64)
        return st

    def load_state(self, st: dict, prefix: str) -> None:
        """Inverse of ``state_dict`` — overwrites the mirrors of a half
        built at the SAME capacities, then restages the device tensors."""
        nb = len(self.widths)
        for bi in range(nb):
            self.bk_rows[bi] = np.array(st[f"{prefix}bk_rows{bi}"])
            self.bk_idx[bi] = np.array(st[f"{prefix}bk_idx{bi}"])
            self.bk_mask[bi] = np.array(st[f"{prefix}bk_mask{bi}"])
            self.free_bslots[bi] = [
                int(s) for s in st[f"{prefix}free_bslots{bi}"]]
        for name in ("bucket_of", "slot_of", "hi_tiles", "hi_tmask",
                     "hi_rowmap", "hi_ids", "is_low", "row_deg", "hi_slot"):
            setattr(self, name, np.array(st[f"{prefix}{name}"]))
        self.free_tiles = [int(t) for t in st[f"{prefix}free_tiles"]]
        self.free_slots = [int(s) for s in st[f"{prefix}free_slots"]]
        off = st[f"{prefix}slot_tiles_off"]
        dat = st[f"{prefix}slot_tiles_dat"]
        self.slot_tiles = [
            [int(t) for t in dat[off[i]:off[i + 1]]]
            for i in range(off.shape[0] - 1)]
        self.migrations = int(st[f"{prefix}migrations"][0])
        self._clear_dirty()
        self._stage_device()

    # -- structural edits (host mirrors) ------------------------------------

    def insert(self, row: int, nbr: int) -> None:
        if self.is_low[row]:
            bi = int(self.bucket_of[row])
            d = int(self.row_deg[row])
            if d >= self.widths[bi]:
                if bi + 1 < len(self.widths):
                    self._migrate_bucket(row, bi, bi + 1)
                    bi += 1
                else:
                    self._migrate_to_high(row)
                    self._hi_insert(row, nbr)
                    return
            slot = int(self.slot_of[row])
            self.bk_idx[bi][slot, d] = nbr
            self.bk_mask[bi][slot, d] = 1.0
            self.row_deg[row] = d + 1
            self._dirty_slots[bi].add(slot)
            return
        self._hi_insert(row, nbr)

    def delete(self, row: int, nbr: int) -> None:
        if self.is_low[row]:
            bi = int(self.bucket_of[row])
            slot = int(self.slot_of[row])
            d = int(self.row_deg[row])
            j = int(np.nonzero(self.bk_idx[bi][slot, :d] == nbr)[0][0])
            last = d - 1
            self.bk_idx[bi][slot, j] = self.bk_idx[bi][slot, last]
            self.bk_idx[bi][slot, last] = 0
            self.bk_mask[bi][slot, last] = 0.0
            self.row_deg[row] = last
            self._dirty_slots[bi].add(slot)
            # demote only once the row would half-fill the narrower bucket
            if bi > 0 and last <= self.widths[bi - 1] // 2:
                self._migrate_bucket(row, bi, bi - 1)
            return
        self._hi_delete(row, nbr)
        if self.widths and self.row_deg[row] <= self.low_water:
            self._migrate_to_low(row)

    # -- ELL bucket slot management -----------------------------------------

    def _bucket_free(self, bi: int, slot: int) -> None:
        self.bk_idx[bi][slot] = 0
        self.bk_mask[bi][slot] = 0.0
        self.bk_rows[bi][slot] = self.n  # sentinel
        self.free_bslots[bi].append(slot)
        self._dirty_slots[bi].add(slot)
        self._bmap_dirty[bi] = True

    def _bucket_place(self, row: int, bi: int, nbrs: np.ndarray) -> None:
        if not self.free_bslots[bi]:
            raise CapacityError(f"bucket {self.widths[bi]} slots exhausted")
        slot = self.free_bslots[bi].pop()
        self.bk_rows[bi][slot] = row
        self.bk_idx[bi][slot, :nbrs.size] = nbrs
        self.bk_mask[bi][slot, :nbrs.size] = 1.0
        self.bucket_of[row] = bi
        self.slot_of[row] = slot
        self._dirty_slots[bi].add(slot)
        self._bmap_dirty[bi] = True
        self._side_dirty = True

    def _migrate_bucket(self, row: int, bi_from: int, bi_to: int) -> None:
        d = int(self.row_deg[row])
        slot = int(self.slot_of[row])
        nbrs = self.bk_idx[bi_from][slot, :d].copy()
        self._bucket_free(bi_from, slot)
        self._bucket_place(row, bi_to, nbrs)
        self.migrations += 1

    def _hi_insert(self, row: int, nbr: int) -> None:
        slot = int(self.hi_slot[row])
        tiles = self.slot_tiles[slot]
        d = int(self.row_deg[row])
        fill = d - (len(tiles) - 1) * self.tile if tiles else self.tile
        if fill == self.tile:
            if not self.free_tiles:
                raise CapacityError("tile pool exhausted")
            t = self.free_tiles.pop()
            self.hi_rowmap[t] = slot
            self._rowmap_dirty = True
            tiles.append(t)
            fill = 0
        t = tiles[-1]
        self.hi_tiles[t, fill] = nbr
        self.hi_tmask[t, fill] = 1.0
        self.row_deg[row] = d + 1
        self._dirty_tiles.add(t)

    def _hi_delete(self, row: int, nbr: int) -> None:
        slot = int(self.hi_slot[row])
        tiles = self.slot_tiles[slot]
        d = int(self.row_deg[row])
        fill = d - (len(tiles) - 1) * self.tile
        t = j = -1
        for cand in tiles:
            hits = np.nonzero((self.hi_tiles[cand] == nbr)
                              & (self.hi_tmask[cand] > 0))[0]
            if hits.size:
                t, j = cand, int(hits[0])
                break
        if t < 0:
            raise RuntimeError("edge not present in tile list")
        tl, jl = tiles[-1], fill - 1
        self.hi_tiles[t, j] = self.hi_tiles[tl, jl]
        self.hi_tiles[tl, jl] = 0
        self.hi_tmask[tl, jl] = 0.0
        self._dirty_tiles.add(t)
        self._dirty_tiles.add(tl)
        self.row_deg[row] = d - 1
        if jl == 0:  # last tile emptied
            tiles.pop()
            self._free_tile(tl)

    def _free_tile(self, t: int) -> None:
        self.hi_tiles[t] = 0
        self.hi_tmask[t] = 0.0
        self.hi_rowmap[t] = self.hi_ids.shape[0] - 1  # pad convention
        self._rowmap_dirty = True
        self.free_tiles.append(t)
        self._dirty_tiles.add(t)

    def _migrate_to_high(self, row: int) -> None:
        if not self.free_slots:
            raise CapacityError("hi slot table exhausted")
        slot = self.free_slots.pop()
        self.hi_slot[row] = slot
        self.hi_ids[slot] = row
        self._side_dirty = True
        d = int(self.row_deg[row])
        bi = int(self.bucket_of[row])
        bslot = int(self.slot_of[row])
        nbrs = self.bk_idx[bi][bslot, :d].copy()
        self._bucket_free(bi, bslot)
        self.bucket_of[row] = len(self.widths)  # CSR-side sentinel
        self.slot_of[row] = slot
        self.is_low[row] = False
        tiles = self.slot_tiles[slot]
        for off in range(0, d, self.tile):
            if not self.free_tiles:
                raise CapacityError("tile pool exhausted")
            t = self.free_tiles.pop()
            chunk = nbrs[off:off + self.tile]
            self.hi_tiles[t, :chunk.size] = chunk
            self.hi_tmask[t, :chunk.size] = 1.0
            self.hi_rowmap[t] = slot
            self._rowmap_dirty = True
            tiles.append(t)
            self._dirty_tiles.add(t)
        self.migrations += 1

    def _migrate_to_low(self, row: int) -> None:
        slot = int(self.hi_slot[row])
        tiles = self.slot_tiles[slot]
        d = int(self.row_deg[row])
        nbrs = np.zeros(d, np.int32)
        at = 0
        for t in tiles:
            valid = np.nonzero(self.hi_tmask[t] > 0)[0]
            nbrs[at:at + valid.size] = self.hi_tiles[t, valid]
            at += valid.size
        for t in list(tiles):
            self._free_tile(t)
        self.slot_tiles[slot] = []
        self.hi_ids[slot] = self.n  # sentinel
        self._side_dirty = True
        self.free_slots.append(slot)
        self.hi_slot[row] = -1
        # land in the narrowest bucket that fits the current degree — the
        # same placement rule build_hybrid_rows uses
        bi = int(np.searchsorted(np.asarray(self.widths), max(d, 1), "left"))
        self._bucket_place(row, bi, nbrs)
        self.is_low[row] = True
        self.migrations += 1

    # -- fragmentation ------------------------------------------------------

    def tile_waste(self) -> float:
        """Excess tile slots relative to a fresh rebuild, as a fraction of
        allocated slots: exactly the tiles held by sub-d_p vertices parked
        on the high side by the demotion hysteresis."""
        used = self.hi_tiles.shape[0] - len(self.free_tiles)
        if used == 0:
            return 0.0
        deg = self.row_deg[~self.is_low]
        ideal = int(((deg[deg > self.d_p] + self.tile - 1)
                     // self.tile).sum())
        return (used - ideal) / float(used)

    # -- device refresh -----------------------------------------------------

    def device_refresh(self, jobs: list) -> tuple:
        """Push dirty slots/tiles to the device tensors, in place: the
        edited rows of every (index, mask) table go into `jobs` for
        `_scatter_from_host`, the small side tables are re-staged here.
        Returns (#slots, #tiles)."""
        nr = sum(len(s) for s in self._dirty_slots)
        nt = len(self._dirty_tiles)
        self.last_scatter = {}
        tables = [(bi, self.dev_bk_idx[bi], self.dev_bk_mask[bi],
                   self.bk_idx[bi], self.bk_mask[bi], dirty)
                  for bi, dirty in enumerate(self._dirty_slots)]
        tables.append(("tiles", self.dev_hi_tiles, self.dev_hi_tmask,
                       self.hi_tiles, self.hi_tmask, self._dirty_tiles))
        for key, dev_idx, dev_mask, host_idx, host_mask, dirty in tables:
            if dirty:
                ids = np.fromiter(dirty, np.int32, len(dirty))
                jobs.append((dev_idx, dev_mask, ids, host_idx[ids],
                             host_mask[ids]))
                self.last_scatter[key] = ids
        for bi, dirty in enumerate(self._bmap_dirty):
            if dirty:
                _restage(self.dev_bk_rows[bi], self.bk_rows[bi])
        # small 1-D side tables: re-staged wholesale, but only when touched
        if self._rowmap_dirty:
            _restage(self.dev_hi_rowmap, self.hi_rowmap)
            slot_tiles, slot_off = slot_tile_table(self.hi_rowmap,
                                                   self.hi_ids.shape[0])
            _restage(self.dev_hi_slot_tiles, slot_tiles)
            _restage(self.dev_hi_slot_off, slot_off)
        if self._side_dirty:
            _restage(self.dev_hi_ids, self.hi_ids)
            _restage(self.dev_is_low, self.is_low)
            _restage(self.dev_bucket_of, self.bucket_of)
            _restage(self.dev_slot_of, self.slot_of)
        self._clear_dirty()
        return nr, nt

    def device_graph(self, out_deg: torch.Tensor) -> DeviceGraph:
        buckets = tuple(
            EllBlock(rows=self.dev_bk_rows[bi], idx=self.dev_bk_idx[bi],
                     mask=self.dev_bk_mask[bi])
            for bi in range(len(self.widths)))
        return DeviceGraph(
            buckets=buckets, bucket_of=self.dev_bucket_of,
            slot_of=self.dev_slot_of,
            hi_ids=self.dev_hi_ids, hi_tiles=self.dev_hi_tiles,
            hi_tmask=self.dev_hi_tmask, hi_rowmap=self.dev_hi_rowmap,
            hi_slot_tiles=self.dev_hi_slot_tiles,
            hi_slot_off=self.dev_hi_slot_off,
            is_low=self.dev_is_low, out_deg=out_deg)


class DeviceSnapshot:
    """Both hybrid layouts of G^t, maintained incrementally across batches.

    Exposes `.dg` (pull orientation) and `.fwd_dg` (forward orientation) —
    the pre-staged snapshot interface every core driver accepts directly.
    The tensors live on `device` (CUDA unless the caller names another;
    without a card the constructor raises) and are updated in place by
    `apply` (see the module docstring).
    """

    def __init__(self, g: Graph, d_p: int = 64, tile: int = 256,
                 hi_headroom: float = 2.0, tile_headroom: float = 2.0,
                 rebuild_threshold: float = 0.05, frag_budget: float = 0.6,
                 low_water: Optional[int] = None, device=None):
        self.device = resolve_device(device)   # raise before the host work
        self.n = g.n
        self.d_p, self.tile = d_p, tile
        self.rebuild_threshold = rebuild_threshold
        self.frag_budget = frag_budget
        self._low_water = low_water
        self._hi_headroom, self._tile_headroom = hi_headroom, tile_headroom
        src, dst = g.edges()
        self._keys = np.sort(edge_keys(g.n, src, dst))
        self._indeg = g.in_degree().astype(np.int64)
        self._outdeg = g.out_degree().astype(np.int64)
        self._adopt(g)

    # -- construction / rebuild ---------------------------------------------

    def _caps_for(self, indeg: np.ndarray, outdeg: np.ndarray,
                  widths: Optional[tuple] = None) -> dict:
        # widths are chosen ONCE from both orientations' histograms and then
        # frozen across rebuilds (passed back in): only bucket_caps may grow,
        # so device shapes stay stable modulo genuine capacity growth.
        if widths is None:
            widths = choose_bucket_widths(
                np.concatenate([indeg, outdeg]), self.d_p)

        def side(deg):
            hi = deg[deg > self.d_p]
            n_hi = int(hi.size)
            nt = int(((hi + self.tile - 1) // self.tile).sum())
            # bucket caps must cover the hysteresis *band*, not just the
            # initial placement census — see bucket_band_counts
            nb = bucket_band_counts(deg, widths, self.d_p)
            return n_hi, nt, nb

        hi_p, nt_p, nb_p = side(indeg)
        hi_f, nt_f, nb_f = side(outdeg)
        n_hi_cap = next_pow2(int(max(hi_p, hi_f, 1) * self._hi_headroom), 8)
        t_cap = next_pow2(int(max(nt_p, nt_f, 1) * self._tile_headroom), 8)
        bucket_caps = tuple(
            next_pow2(int(max(int(p), int(f), 1) * self._hi_headroom), 8)
            for p, f in zip(nb_p, nb_f))
        return dict(n_hi_cap=n_hi_cap, t_cap=t_cap,
                    widths=tuple(widths), bucket_caps=bucket_caps)

    def _adopt(self, g: Graph, caps: Optional[dict] = None) -> None:
        """(Re)build both halves from a host Graph at fixed capacities; the
        device tensors are staged anew."""
        t0 = time.perf_counter()
        caps = caps or self._caps_for(self._indeg, self._outdeg)
        lay_p = build_hybrid(g, d_p=self.d_p, tile=self.tile, **caps)
        lay_f = build_hybrid(g.transpose(), d_p=self.d_p, tile=self.tile,
                             **caps)
        t1 = time.perf_counter()
        self._caps = caps
        self._pull = _HalfLayout(lay_p, self._indeg, self.device,
                                 self._low_water)
        self._fwd = _HalfLayout(lay_f, self._outdeg, self.device,
                                self._low_water)
        self._dev_outdeg = _stage(self._outdeg.astype(np.int32), self.device)
        self._dev_indeg = _stage(self._indeg.astype(np.int32), self.device)
        _sync(self.device)
        #: host seconds of the last (re)build: the two `build_hybrid` calls,
        #: then the mirrors, free lists and device staging of both halves
        self.adopt_s = dict(layouts=t1 - t0,
                            halves=time.perf_counter() - t1)

    def _rebuild(self, reason: str) -> None:
        g = self.graph()
        caps = self._caps_for(self._indeg, self._outdeg,
                              widths=self._caps["widths"])
        # never shrink: keep device shapes stable unless we *must* grow
        # (widths stay frozen; bucket_caps grow elementwise)
        caps = dict(
            n_hi_cap=max(caps["n_hi_cap"], self._caps["n_hi_cap"]),
            t_cap=max(caps["t_cap"], self._caps["t_cap"]),
            widths=self._caps["widths"],
            bucket_caps=tuple(max(a, b) for a, b in
                              zip(caps["bucket_caps"],
                                  self._caps["bucket_caps"])),
        )
        self._adopt(g, caps)
        self._last_rebuild_reason = reason

    # -- queries -------------------------------------------------------------

    @property
    def m(self) -> int:
        return int(self._keys.size)

    @property
    def dg(self) -> DeviceGraph:
        return self._pull.device_graph(self._dev_outdeg)

    @property
    def fwd_dg(self) -> DeviceGraph:
        return self._fwd.device_graph(self._dev_indeg)

    def graph(self) -> Graph:
        """Materialize the host CSR Graph (verification / rebuild path)."""
        return graph_from_sorted_keys(self.n, self._keys)

    def fragmentation(self) -> float:
        return max(self._pull.tile_waste(), self._fwd.tile_waste())

    # -- checkpoint state ------------------------------------------------------

    def state_dict(self) -> tuple:
        """(arrays, extra): the complete snapshot state, in the names and
        layout of the JAX package's `DeviceSnapshot.state_dict`. ``arrays``
        is a flat {name: np.ndarray} dict (edge keys, degrees, both halves'
        mirrors + free-list orders); ``extra`` is the JSON-safe capacity
        signature ``load_state`` rebuilds at."""
        arrays = dict(keys=self._keys, indeg=self._indeg,
                      outdeg=self._outdeg)
        arrays.update(self._pull.state_dict("p."))
        arrays.update(self._fwd.state_dict("f."))
        extra = {"caps": {k: list(v) if isinstance(v, tuple) else int(v)
                          for k, v in self._caps.items()}}
        return arrays, extra

    def load_state(self, arrays: dict, extra: dict) -> None:
        """Restore from ``state_dict`` output (this package's or the JAX
        package's): re-adopt at the saved capacities, then overwrite every
        mirror and restage the device tensors."""
        self._keys = np.array(arrays["keys"])
        self._indeg = np.array(arrays["indeg"])
        self._outdeg = np.array(arrays["outdeg"])
        caps = {k: tuple(v) if isinstance(v, list) else int(v)
                for k, v in extra["caps"].items()}
        self._adopt(self.graph(), caps)
        self._pull.load_state(arrays, "p.")
        self._fwd.load_state(arrays, "f.")

    # -- the batch-update lifecycle ------------------------------------------

    def apply(self, delta: Delta) -> SnapshotStats:
        """Apply a canonical Δ^t in place; returns per-apply stats.

        `host_s` times the key-set update and the mirror edits, `device_s`
        the device scatters, ending in a synchronize on CUDA."""
        obs = _obs()
        t0 = time.perf_counter()
        stats = SnapshotStats()
        with obs.span("snapshot.apply_net_delta"):
            self._keys, (d_s, d_d), (i_s, i_d) = apply_net_delta(
                self._keys, self.n, delta, self._indeg, self._outdeg)
        stats.net_del, stats.net_ins = int(d_s.size), int(i_s.size)

        reason = rebuild_reason(delta.size, self.m, self.fragmentation(),
                                self.rebuild_threshold, self.frag_budget)
        if reason is None:
            mig0 = self._pull.migrations + self._fwd.migrations
            try:
                with obs.span("snapshot.host_edit"):
                    for u, v in zip(d_s.tolist(), d_d.tolist()):
                        self._pull.delete(v, u)
                        self._fwd.delete(u, v)
                    for u, v in zip(i_s.tolist(), i_d.tolist()):
                        self._pull.insert(v, u)
                        self._fwd.insert(u, v)
            except CapacityError as e:
                # mirrors are mid-edit but the key set is complete
                reason = f"capacity:{e}"
        if reason is not None:
            with obs.span("snapshot.rebuild"):
                self._rebuild(reason)
                _sync(self.device)
            obs.inc("snapshot.rebuilds")
            obs.inc(f"snapshot.rebuild.{reason.split(':')[0]}")
            get_flight().emit("snapshot.rebuild", reason=reason)
            stats.rebuilt, stats.rebuild_reason = True, reason
            stats.host_s = time.perf_counter() - t0
            return stats

        stats.migrations = self._pull.migrations + self._fwd.migrations - mig0
        t1 = time.perf_counter()
        stats.host_s = t1 - t0
        with obs.span("snapshot.device_refresh", annotate=True):
            jobs = []
            rows_p, tiles_p = self._pull.device_refresh(jobs)
            rows_f, tiles_f = self._fwd.device_refresh(jobs)
            touched = np.unique(np.concatenate([d_s, d_d, i_s, i_d]))
            if touched.size:
                ids = touched.astype(np.int32)
                for dst, deg in ((self._dev_outdeg, self._outdeg),
                                 (self._dev_indeg, self._indeg)):
                    jobs.append((dst.view(-1, 1), None, ids,
                                 deg[touched].astype(np.int32)[:, None],
                                 None))
            _scatter_from_host(jobs, self.device)
            _sync(self.device)
        stats.rows_touched = rows_p + rows_f
        stats.tiles_touched = tiles_p + tiles_f
        stats.device_s = time.perf_counter() - t1
        obs.inc("snapshot.inplace_batches")
        obs.inc("snapshot.rows_touched", stats.rows_touched)
        obs.inc("snapshot.tiles_touched", stats.tiles_touched)
        obs.inc("snapshot.migrations", stats.migrations)
        return stats
