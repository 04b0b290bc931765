"""Incrementally maintained sharded snapshots — multi-rank streaming.

``ShardedSnapshot`` is the mesh sibling of ``DeviceSnapshot``: it owns this
rank's shard of the 1-D partitioned hybrid layout of the current graph G^t
(the ``ShardedGraph`` consumed by ``core.distributed``) and applies a
canonical ``Delta`` *in place* — O(|Δ| · d_p) host bookkeeping on the
shard's ``_HalfLayout`` mirror plus O(touched rows) scatters into its
device tables — instead of re-partitioning and restaging per batch.

A port of the JAX package's `repro.stream.sharded`, SPMD: every rank
receives the whole ``Delta`` and keeps the global edge keys and degrees, as
the JAX controller does, but the mirror, free lists and device tables of
its own shard only (vertex v lives on shard ``v // n_loc`` at local row
``v % n_loc``, as in `build_sharded`). The shard's mirror IS the
single-device `_HalfLayout` machinery (`stage_device=False`: this class
stages the tables itself and drains the mirror's dirty state into them),
so every mirror and free list equals the JAX snapshot's ``s{shard}.``
state after the same deltas. A device refresh is one `scatter_rows_batch`
call per `apply` (one `scatter_rows` launch on CUDA).

Decisions that change device shapes are the same on every rank: rebuild
(the batch size against |E|, the worst shard's fragmentation by a max
over the mesh, and a capacity error in any shard) and the capacities
(derived from the global degrees, never shrinking). Each costs one small
collective per `apply`.

Only the pull orientation is maintained: the 1-D DF-P engine expands its
frontier by pulling the gathered δ_N through the same layout.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from ..core.distributed import (ShardedGraph, shard_block_rows, shard_bounds,
                                shard_graph, sharded_need)
from ..core.graph import (Graph, build_hybrid_rows, choose_bucket_widths,
                          edge_keys, graph_from_sorted_keys, next_pow2)
from ..core.mesh import Mesh
from ..core.pagerank import slot_tile_table
from ..obs.flight import get_flight
from ..obs.spans import get_registry as _obs
from .delta import Delta
from .snapshot import (CapacityError, SnapshotStats, _HalfLayout, _restage,
                       _scatter_from_host, _sync, apply_net_delta,
                       rebuild_reason)

__all__ = ["ShardedSnapshot"]


class ShardedSnapshot:
    """This rank's shard of the partitioned hybrid layout of G^t,
    maintained incrementally.

    Exposes `.sg` — the `ShardedGraph` the distributed engines accept —
    and the same `apply(delta) -> SnapshotStats` lifecycle as
    `DeviceSnapshot`; `apply`, `fragmentation`, `state_dict` and
    `load_state` are collectives (every rank of `mesh` calls them, in
    the same order). The tables live on `mesh.device`."""

    def __init__(self, g: Graph, mesh: Mesh, d_p: int = 64, tile: int = 256,
                 hi_headroom: float = 2.0, tile_headroom: float = 2.0,
                 rebuild_threshold: float = 0.05, frag_budget: float = 0.6,
                 low_water: Optional[int] = None):
        self.mesh = mesh
        self.device = mesh.device
        self.n = g.n
        self.nd = mesh.size
        self.shard = mesh.shard
        self.n_pad = ((g.n + self.nd - 1) // self.nd) * self.nd
        self.n_loc = self.n_pad // self.nd
        self.d_p, self.tile = d_p, tile
        self.rebuild_threshold = rebuild_threshold
        self.frag_budget = frag_budget
        self._low_water = low_water
        self._hi_headroom, self._tile_headroom = hi_headroom, tile_headroom
        src, dst = g.edges()
        self._keys = np.sort(edge_keys(g.n, src, dst))
        self._indeg = g.in_degree().astype(np.int64)
        self._outdeg = g.out_degree().astype(np.int64)
        # the vertex set never changes across the stream
        self._lo, self._hi = shard_bounds(self.shard, self.n_loc, self.n)
        self._valid = np.zeros(self.n_loc, bool)
        self._valid[:self._hi - self._lo] = True
        self._adopt(g)
        self._last_rebuild_reason = ""

    # -- construction / rebuild ---------------------------------------------

    def _caps_for(self, indeg: np.ndarray,
                  widths: Optional[tuple] = None) -> dict:
        """Worst-shard bucket/high/tile needs, pow2 with headroom, from the
        global degrees (so the same on every rank). Widths are chosen once
        from the global in-degree histogram and then frozen across
        rebuilds; only caps may grow."""
        if widths is None:
            widths = choose_bucket_widths(indeg, self.d_p)
        # band=True: caps must cover the hysteresis band each bucket can
        # accumulate under streaming, not just the placement census
        need_hi, need_t, need_b = sharded_need(indeg, self.nd, self.n_loc,
                                               self.d_p, self.tile, widths,
                                               band=True)
        return dict(
            hi_cap=next_pow2(int(need_hi * self._hi_headroom), 8),
            t_cap=next_pow2(int(need_t * self._tile_headroom), 8),
            widths=tuple(widths),
            bucket_caps=tuple(next_pow2(int(nb * self._hi_headroom), 8)
                              for nb in need_b))

    def _adopt(self, g: Graph, caps: Optional[dict] = None) -> None:
        """(Re)build this rank's shard from a host Graph at fixed caps and
        stage its tables anew."""
        caps = caps or self._caps_for(self._indeg)
        self._caps = caps
        off, dat = shard_block_rows(g, self.shard, self.n_loc)
        hr = build_hybrid_rows(off, dat, d_p=self.d_p, tile=self.tile,
                               n_rows=self.n_loc, n_hi_cap=caps["hi_cap"],
                               t_cap=caps["t_cap"], widths=caps["widths"],
                               bucket_caps=caps["bucket_caps"])
        row_deg = np.zeros(self.n_loc, np.int64)
        row_deg[:self._hi - self._lo] = self._indeg[self._lo:self._hi]
        self._half = _HalfLayout(hr, row_deg, None, stage_device=False)
        if self._low_water is not None:
            self._half.low_water = self._low_water
        self._restack()

    def _restack(self) -> None:
        """Stage the shard's tables from (copies of) the mirror; adopt,
        rebuild and checkpoint restore all end here."""
        h = self._half
        outdeg = np.ones(self.n_loc, np.int32)
        outdeg[:self._hi - self._lo] = self._outdeg[self._lo:self._hi]
        self._sg = shard_graph(h.bk_rows, h.bk_idx, h.bk_mask, h.hi_ids,
                               h.hi_tiles, h.hi_tmask, h.hi_rowmap, outdeg,
                               self._valid, n_true=self.n, nd=self.nd,
                               shard=self.shard, device=self.device)
        _sync(self.device)

    def _rebuild(self, reason: str) -> None:
        caps = self._caps_for(self._indeg, widths=self._caps["widths"])
        # never shrink: keep device shapes stable unless they *must* grow
        caps = dict(
            hi_cap=max(caps["hi_cap"], self._caps["hi_cap"]),
            t_cap=max(caps["t_cap"], self._caps["t_cap"]),
            widths=self._caps["widths"],
            bucket_caps=tuple(max(a, b) for a, b in
                              zip(caps["bucket_caps"],
                                  self._caps["bucket_caps"])))
        self._adopt(self.graph(), caps)
        self._last_rebuild_reason = reason

    # -- queries -------------------------------------------------------------

    @property
    def m(self) -> int:
        return int(self._keys.size)

    @property
    def sg(self) -> ShardedGraph:
        """This rank's `ShardedGraph`. Its tensors are written in place by
        `apply` (as `DeviceSnapshot.dg`'s) until a rebuild stages new
        ones: take it afresh after every `apply`."""
        return self._sg

    def graph(self) -> Graph:
        """Materialize the host CSR Graph (verification / rebuild path)."""
        return graph_from_sorted_keys(self.n, self._keys)

    def local_fragmentation(self) -> float:
        return self._half.tile_waste()

    def fragmentation(self) -> float:
        """The worst shard's tile waste (a max over the mesh)."""
        mine = torch.tensor([self.local_fragmentation()], dtype=torch.float64,
                            device=self.device)
        return float(self.mesh.all_max(mine))

    # -- checkpoint state --------------------------------------------------

    def shard_state(self) -> dict:
        """This shard's mirror and free-list state under its ``s{shard}.``
        prefix (the JAX snapshot's names)."""
        return self._half.state_dict(f"s{self.shard}.")

    def state_dict(self) -> tuple:
        """(arrays, extra): the complete snapshot state in the JAX
        package's layout — edge keys, degrees and every shard's mirrors
        and free-list orders under ``s{shard}.`` prefixes. A collective:
        the shards' states are gathered to every rank (the checkpoint
        writer is rank 0)."""
        arrays = dict(keys=self._keys, indeg=self._indeg,
                      outdeg=self._outdeg)
        for part in self.mesh.all_gather_object(self.shard_state()):
            arrays.update(part)
        extra = {"caps": {k: list(v) if isinstance(v, tuple) else int(v)
                          for k, v in self._caps.items()}}
        return arrays, extra

    def load_state(self, arrays: dict, extra: dict) -> None:
        """Restore from ``state_dict`` output (this package's or the JAX
        package's): re-adopt at the checkpointed capacities, overwrite this
        shard's mirror from its ``s{shard}.`` arrays, restage."""
        self._keys = np.array(arrays["keys"])
        self._indeg = np.array(arrays["indeg"])
        self._outdeg = np.array(arrays["outdeg"])
        caps = {k: tuple(v) if isinstance(v, list) else int(v)
                for k, v in extra["caps"].items()}
        self._adopt(self.graph(), caps)
        self._half.load_state(arrays, f"s{self.shard}.")
        self._restack()

    # -- the batch-update lifecycle ------------------------------------------

    def apply(self, delta: Delta) -> SnapshotStats:
        """Apply a canonical Δ^t in place; returns per-apply stats (rows,
        tiles and migrations summed over the shards, as JAX counts them;
        the seconds this rank's).

        Feeds the same obs span/counter names as `DeviceSnapshot.apply`
        (prefix ``snapshot.``), plus ``snapshot.shard_scatters`` for this
        shard's non-empty tables."""
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
            reason, dirty, counts = self._edit(d_s, d_d, i_s, i_d)
        if reason is not None:
            with obs.span("snapshot.rebuild"):
                self._rebuild(reason)
            obs.inc("snapshot.rebuilds")
            obs.inc(f"snapshot.rebuild.{reason.split(':')[0]}")
            get_flight().emit("snapshot.rebuild", reason=reason,
                              sharded=True)
            stats.rebuilt, stats.rebuild_reason = True, reason
            stats.host_s = time.perf_counter() - t0
            return stats

        stats.rows_touched, stats.tiles_touched, stats.migrations = counts
        t1 = time.perf_counter()
        stats.host_s = t1 - t0
        with obs.span("snapshot.device_refresh", annotate=True):
            self._refresh(dirty, np.unique(np.concatenate([d_s, i_s])))
            _sync(self.device)
        stats.device_s = time.perf_counter() - t1
        obs.inc("snapshot.inplace_batches")
        obs.inc("snapshot.rows_touched", stats.rows_touched)
        obs.inc("snapshot.tiles_touched", stats.tiles_touched)
        obs.inc("snapshot.migrations", stats.migrations)
        return stats

    def _edit(self, d_s, d_d, i_s, i_d):
        """This shard's mirror edits, in the batch's order (pull
        orientation: row = destination, entry = source). Returns (rebuild
        reason or None, the drained dirty state, the shards' summed
        [rows, tiles, migrations]). A capacity error on any shard makes
        every rank rebuild; the reason is the error met first in the
        batch's edit order, as the JAX snapshot's single loop meets it."""
        h, lo, n_loc = self._half, self.shard * self.n_loc, self.n_loc
        mig0 = h.migrations
        n_del = d_s.size
        err_at, err = n_del + i_s.size, ""
        dels = np.nonzero(d_d // n_loc == self.shard)[0]
        ins = np.nonzero(i_d // n_loc == self.shard)[0]
        at = 0          # the edit's place in the batch's edit order
        try:
            with _obs().span("snapshot.host_edit"):
                for k in dels.tolist():
                    at = k
                    h.delete(int(d_d[k]) - lo, int(d_s[k]))
                for k in ins.tolist():
                    at = n_del + k
                    h.insert(int(i_d[k]) - lo, int(i_s[k]))
        except CapacityError as e:
            # the mirror is mid-edit but the key set is complete
            err_at, err = at, str(e)
        dirty = h.drain_dirty()
        rows = sum(int(s.size) for s in dirty["bucket_slots"])
        mine = torch.tensor([err_at, rows, int(dirty["tiles"].size),
                             h.migrations - mig0], dtype=torch.int64,
                            device=self.device)
        every = self.mesh.all_gather(mine.reshape(1, -1)).cpu().numpy()
        if int(every[:, 0].min()) < n_del + i_s.size:
            first = int(np.argmin(every[:, 0]))
            msg = self.mesh.all_gather_object(err)[first]
            return f"capacity:{msg}", None, None
        return None, dirty, tuple(int(x) for x in every[:, 1:].sum(0))

    def _refresh(self, dirty: dict, touched: np.ndarray) -> None:
        """Push the shard's dirty slots and tiles and its touched
        out-degrees to the device tables: the (index, mask) rows and the
        degrees in one `scatter_rows_batch` call, the small side tables
        re-staged in place only when touched."""
        h, sg, obs = self._half, self._sg, _obs()
        jobs = []
        for bi, slots in enumerate(dirty["bucket_slots"]):
            if slots.size:
                blk = sg.buckets[bi]
                jobs.append((blk.idx, blk.mask, slots, h.bk_idx[bi][slots],
                             h.bk_mask[bi][slots]))
                obs.inc("snapshot.shard_scatters")
            if dirty["bucket_maps"][bi]:
                _restage(sg.buckets[bi].rows, h.bk_rows[bi])
        tiles = dirty["tiles"]
        if tiles.size:
            jobs.append((sg.hi_tiles, sg.hi_tmask, tiles, h.hi_tiles[tiles],
                         h.hi_tmask[tiles]))
            obs.inc("snapshot.shard_scatters")
        if dirty["rowmap_dirty"]:
            _restage(sg.hi_rowmap, h.hi_rowmap)
            slot_tiles, slot_off = slot_tile_table(h.hi_rowmap,
                                                   h.hi_ids.shape[0])
            _restage(sg.hi_slot_tiles, slot_tiles)
            _restage(sg.hi_slot_off, slot_off)
        if dirty["side_dirty"]:
            _restage(sg.hi_pos, h.hi_ids)
        mine = touched[(touched >= self._lo) & (touched < self._hi)]
        if mine.size:
            jobs.append((sg.out_deg.view(-1, 1), None,
                         (mine - self._lo).astype(np.int32),
                         self._outdeg[mine].astype(np.int32)[:, None], None))
        _scatter_from_host(jobs, self.device)
