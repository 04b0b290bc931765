"""StreamSession — chained DF-P PageRank over a continuous update stream.

The session keeps everything resident across batches: ranks and both
hybrid graph layouts (the incremental ``DeviceSnapshot``). ``apply(batch)``
is the full per-batch lifecycle:

  ingest Δ^t  ->  in-place snapshot update  ->  DF-P from previous ranks

choosing between the **compact** engine (frontier-gathered work, right when
the initial frontier is a small fraction of |V|) and the **dense** engine
(`dfp_pagerank` with `frontier_caps`: compacted sweeps with a per-iteration
full-sweep fallback, right when the batch is large). Capacity guesses
never affect correctness, only speed.

A copy of the JAX package's single-device `repro.stream.session`, with its
iteration trace (``trace=True``: each `BatchStats` carries the solve's
`obs.trace.trace_summary`) and its observability: spans ``session.ingest``
and ``session.solve`` (annotated; it ends in a synchronize, so it times
the device), counters ``session.engine.<engine>``, ``session.recompute``,
``frontier.caps_growth``, flight events ``session.engine`` and
``session.batch``, a per-session solve histogram (`solve_percentiles`),
and SLO judging (``slo=SLOConfig(...)``) that arms one ``torch.profiler``
capture around the next batches after a breach (`arm_capture` re-arms by
hand).

Fault tolerance (``guard=GuardConfig(...)``): every raw batch is validated
(raise or quarantine out-of-range pairs), every solve returns its health
word, and an unhealthy solve walks the escalation ladder — a full-budget
dense DF-P retry from the pre-solve ranks, then a static recompute — with
``guard.*`` counters at each rung and a post-mortem bundle when the budget
runs out; ``audit_every`` adds a periodic drift audit against a static
solve. ``journal_dir=`` adds a write-ahead delta journal and (with
``checkpoint_every=K``) periodic full-state checkpoints;
``StreamSession.restore(dir, device=...)`` rebuilds the session
bit-identically from the newest checkpoint plus a journal replay, from a
checkpoint directory of either package.

Multi-rank mode (``mesh=``, a `core.mesh.Mesh`): every rank of the mesh
builds the session with the same arguments and applies the same batches.
Each holds its shard of the partitioned layout (`ShardedSnapshot`) and its
[n_loc] slice of the ranks, which `apply` returns (JAX returns the stacked
[nd, n_loc]); `flat_ranks` all-gathers the dense [n] on every rank. Every
batch runs ``distributed_dfp_pagerank`` with the initial frontier seeded on
the device (`initial_affected_sharded`), and the ladder's first rung is
the same sharded engine. Rank 0 alone writes the journal and the
checkpoints (the JAX on-disk format, ``mesh: true``: `ShardedSnapshot`'s
``s{shard}.`` arrays and the stacked ranks); the other ranks wait for it.
``restore(dir, mesh=)`` has every rank read the directory and keep its
shard.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.compact import df_pagerank_compact, dfp_pagerank_compact
from ..core.distributed import (distributed_dfp_pagerank,
                                distributed_static_pagerank,
                                initial_affected_sharded,
                                sharded_frontier_caps)
from ..core.dynamic import df_pagerank, dfp_pagerank
from ..core.frontier import FrontierCaps, caps_for, merge_caps
from ..core.graph import BatchUpdate, Graph, graph_from_sorted_keys
from ..core.pagerank import PRParams, init_ranks, static_pagerank
from ..guard import GuardConfig
from ..guard.health import HEALTH_OK, H_MASS_DRIFT, MASS_TOL, health_flags
from ..guard.journal import (DeltaJournal, JournalRecord, journal_path,
                             load_session_checkpoint, record_bytes,
                             save_session_checkpoint)
from ..guard.validate import validate_batch
from ..obs.flight import get_flight
from ..obs.hist import Histogram, SLOConfig, start_profiler, stop_profiler
from ..obs.postmortem import write_bundle
from ..obs.spans import get_registry as _obs
from ..obs.trace import maybe_summary
from .delta import Delta, ingest
from .sharded import ShardedSnapshot
from .snapshot import DeviceSnapshot, SnapshotStats, _sync

__all__ = ["StreamSession", "BatchStats", "choose_engine",
           "frontier_estimate"]


def frontier_estimate(delta: Delta, outdeg: np.ndarray) -> int:
    """Initial-frontier size estimate of Δ^t (paper Alg. 5: the first
    expansion marks the out-neighbors of every updated source, plus every
    deletion target) — the one number engine choice and frontier capacity
    planning both key off."""
    srcs = np.unique(np.concatenate([delta.del_src, delta.ins_src]))
    return int(srcs.size) + int(outdeg[srcs].sum()) + int(delta.del_dst.size)


def choose_engine(delta: Delta, outdeg: np.ndarray, n: int,
                  threshold: float) -> str:
    """Dense vs compact, from the *initial frontier estimate*
    (`frontier_estimate`).

    The compact engine sizes its capacity K ≈ 16 · initial frontier and its
    per-iteration cost scales with K; once K approaches |V| it is a slower
    dense sweep. So compaction is only worth entering when the estimated
    frontier is a small fraction of |V|.
    """
    est = frontier_estimate(delta, outdeg)
    return "compact" if est <= threshold * n else "dense"


@dataclasses.dataclass
class BatchStats:
    """End-to-end accounting for one applied batch."""
    batch_size: int
    engine: str
    iters: int
    ingest_s: float
    snapshot: SnapshotStats
    solve_s: float
    #: per-iteration trace summary (`obs.trace.trace_summary` dict) when the
    #: session was built with ``trace=True``; None otherwise.
    trace: Optional[dict] = None
    #: guard.health word of the FIRST solve attempt (0 = healthy; only
    #: populated on guarded sessions)
    health: int = 0
    #: escalation-ladder rungs walked for this batch (0 = none needed)
    escalations: int = 0
    #: out-of-range pairs dropped by the quarantine policy at ingest
    quarantined: int = 0

    @property
    def total_s(self) -> float:
        return (self.ingest_s + self.snapshot.host_s
                + self.snapshot.device_s + self.solve_s)


def _caps_to_json(caps: Optional[FrontierCaps]):
    if caps is None:
        return None
    return {k: list(v) if isinstance(v, tuple) else int(v)
            for k, v in caps._asdict().items()}


def _caps_from_json(d) -> Optional[FrontierCaps]:
    if d is None:
        return None
    return FrontierCaps(**{k: tuple(v) if isinstance(v, list) else int(v)
                           for k, v in d.items()})


class StreamSession:
    """Incrementally expanding DF-P PageRank over a stream of batches.

    >>> sess = StreamSession(base_graph)          # on CUDA by default
    >>> for batch in batches:
    ...     ranks = sess.apply(batch)
    >>> ids, vals = sess.topk(10)

    `device` places the snapshot and the ranks (CUDA unless named; pass
    ``device="cpu"`` to run the plain PyTorch path on the CPU). With
    ``trace=True`` every batch's solve fills an iteration trace and its
    `BatchStats.trace` holds the summary. ``slo`` (an `obs.SLOConfig`)
    judges the running solve p99 after every batch.

    Fault tolerance: ``guard=GuardConfig(...)`` switches on ingest
    validation, the per-solve health watchdog + escalation ladder and the
    periodic drift audit; ``journal_dir=``/``checkpoint_every=`` add crash
    recovery via ``StreamSession.restore(journal_dir)``.

    Multi-rank: pass ``mesh=`` (a `core.mesh.Mesh`; `device` is then the
    mesh's) — the session shards the snapshot over the mesh and chains
    the 1-D distributed DF-P engine instead (``engine``/``prune``/
    ``compact_threshold`` apply only to the single-device path; sharded
    DF-P always prunes).
    """

    def __init__(self, g: Graph, params: Optional[PRParams] = None,
                 d_p: int = 64, tile: int = 256, engine: str = "auto",
                 prune: bool = True, compact_threshold: float = 0.015,
                 snapshot=None, mesh=None, trace: bool = False,
                 guard: Optional[GuardConfig] = None,
                 slo: Optional[SLOConfig] = None,
                 journal_dir: Optional[str] = None,
                 checkpoint_every: int = 0, device=None, **snap_kw):
        if engine not in ("auto", "dense", "compact"):
            raise ValueError(f"unknown engine: {engine!r}")
        #: when True every batch's solve records an obs.trace.TraceBuffer
        #: and its BatchStats carries the `trace_summary` dict
        self.trace = trace
        # Session default: frontier thresholds at 1e-9 (vs the one-shot
        # default 1e-6). Chained DF-P re-uses its own output as the next
        # prior, so per-batch frontier truncation error would otherwise
        # accumulate across the stream; at 1e-9 it stays under what τ
        # leaves. The L1 gap to a from-scratch static solve is then that of
        # two solves each stopped at an L∞ change under τ, and it grows
        # with the graph: at τ = 1e-10 it passes 1e-8 on a 65,536-vertex
        # power-law graph (`python -m repro_torch.stream` measures it).
        self.params = params if params is not None else PRParams(
            tau_f=1e-9, tau_p=1e-9)
        self.engine = engine
        self.prune = prune
        self.compact_threshold = compact_threshold
        self.mesh = mesh
        self.guard = guard
        self.slo = slo
        self.journal_dir = journal_dir
        self.checkpoint_every = checkpoint_every
        self._snap_kw = dict(snap_kw)
        self._d_p, self._tile = d_p, tile
        if mesh is not None:
            if device is not None and torch.device(device) != mesh.device:
                raise ValueError(f"device {device} on a mesh of "
                                 f"{mesh.device}")
            self.snap = snapshot if snapshot is not None else \
                ShardedSnapshot(g, mesh, d_p=d_p, tile=tile, **snap_kw)
        else:
            self.snap = snapshot if snapshot is not None else \
                DeviceSnapshot(g, d_p=d_p, tile=tile, device=device,
                               **snap_kw)
        self.ranks, self._init_iters = self._static_solve()
        self.history: List[BatchStats] = []
        #: never-shrink FrontierCaps across the stream (None until the
        #: first batch): a burst batch can only ever grow them
        self._caps = None
        #: sequence number of the last journaled batch (noops don't count:
        #: they change no state and are never journaled, so restore()'s
        #: replay and the live stream stay aligned)
        self._batch_idx = 0
        self._replaying = False
        # one writer: on a mesh, rank 0 journals for every rank
        self._journal = (DeltaJournal(journal_path(journal_dir))
                         if journal_dir is not None and self._writer
                         else None)
        #: per-session solve-latency histogram (the SLO judges THIS stream's
        #: p99, not the process-wide registry shared across sessions)
        self._solve_hist = Histogram()
        #: profiler-capture state machine: ``_capture_remaining`` batches
        #: still to run under an armed/active capture, ``_capture_active``
        #: while torch.profiler is recording. One automatic arm per session
        #: (``_slo_captured``); re-arm explicitly via `arm_capture`.
        self._capture_remaining = 0
        self._capture_active = False
        self._capture_dir: Optional[str] = None
        self._slo_captured = False
        #: quarantine summary of the most recent non-clean ingest (bundles
        #: embed it: the poisoned batch is usually the story)
        self._last_quarantine: Optional[dict] = None

    @property
    def n(self) -> int:
        return self.snap.n

    @property
    def m(self) -> int:
        return self.snap.m

    @property
    def device(self) -> torch.device:
        return self.snap.device

    @property
    def _writer(self) -> bool:
        """Whether this process writes the journal and checkpoints (rank
        0 of a mesh; always, single-device)."""
        return self.mesh is None or self.mesh.rank == 0

    # -- the streaming API ---------------------------------------------------

    def apply(self, batch: BatchUpdate | Delta) -> torch.Tensor:
        """Apply Δ^t and return the new rank vector (on the device; this
        rank's [n_loc] slice in mesh mode — see `flat_ranks`).

        A raw batch is validated under the guard's policy ("raise" when
        unguarded) and canonicalized (`ingest`); a `Delta` is taken as it
        is. A journaled session appends the delta before the snapshot
        pass (write-ahead). `solve_s` times the span ``session.solve``
        from inside it — the solve, and on an unhealthy guarded solve the
        escalation ladder — and ends in a synchronize on CUDA. An armed
        profiler capture encloses the snapshot pass and the solve;
        starting and stopping it falls outside every timed span."""
        obs = _obs()
        flight = get_flight()
        t0 = time.perf_counter()
        with obs.span("session.ingest"):
            quarantined = 0
            if isinstance(batch, Delta):
                delta = batch
            else:
                policy = (self.guard.policy if self.guard is not None
                          else "raise")
                batch, report = validate_batch(batch, self.n, policy=policy)
                quarantined = report.size
                if quarantined:
                    self._last_quarantine = {
                        "size": int(report.size),
                        "deletions": int(report.del_src.size),
                        "insertions": int(report.ins_src.size)}
                    flight.emit("guard.quarantine", seq=self._batch_idx + 1,
                                dropped=int(report.size))
                delta = ingest(batch, self.n)
            db = delta.to_device(device=self.device) if delta.size else None
        ingest_s = time.perf_counter() - t0

        if delta.size == 0:
            # an empty (or fully quarantined) Δ changes nothing: skip the
            # snapshot pass, the solve and the journal — the zero-cost
            # no-op every upstream coalescer expects
            obs.inc("session.engine.noop")
            self.history.append(BatchStats(
                batch_size=0, engine="noop", iters=0, ingest_s=ingest_s,
                snapshot=SnapshotStats(), solve_s=0.0,
                quarantined=quarantined))
            return self.ranks

        # write-ahead: the journal record lands BEFORE the delta touches the
        # snapshot, so a crash anywhere past this line replays the batch
        seq = self._batch_idx + 1
        self._journal_append(seq, delta)
        # an armed capture starts before the snapshot pass (JAX's starts at
        # the solve), so its trace holds the device refresh's scatter too
        self._maybe_capture_start()
        snap_stats = self.snap.apply(delta)

        engine = self._choose_engine(delta)
        obs.inc(f"session.engine.{engine}")
        flight.emit("session.engine", seq=seq, engine=engine,
                    size=delta.size)
        caps = self._frontier_caps(frontier_estimate(delta,
                                                     self.snap._outdeg))
        guarded = self.guard is not None
        r_pre = self.ranks
        with obs.span("session.solve", annotate=True):
            t1 = time.perf_counter()
            out = self.solve(engine, r_pre, db, caps, trace=self.trace,
                             health=guarded)
            hw = 0
            if guarded:
                *rest, hw_dev = out
                out = tuple(rest)
                hw = self._apply_mass_tol(int(hw_dev), rest[0])
            (r, iters), summary = maybe_summary(out, self.trace)
            iters = int(iters)
            escalations = 0
            if guarded and hw != HEALTH_OK:
                r, iters, escalations = self._escalate(
                    r_pre, db, hw, r, iters, summary=summary, seq=seq)
            _sync(self.device)
            solve_s = time.perf_counter() - t1
        self._maybe_capture_stop()

        self.ranks = r
        self._batch_idx = seq
        self.history.append(BatchStats(
            batch_size=delta.size, engine=engine, iters=iters,
            ingest_s=ingest_s, snapshot=snap_stats, solve_s=solve_s,
            trace=summary, health=hw, escalations=escalations,
            quarantined=quarantined))
        self._solve_hist.add(solve_s)
        flight.emit("session.batch", seq=seq, engine=engine,
                    size=delta.size, iters=iters,
                    solve_us=round(solve_s * 1e6, 1), health=hw,
                    escalations=escalations)
        self._check_slo()
        if (self.guard is not None and self.guard.audit_every
                and self._batch_idx % self.guard.audit_every == 0):
            self._audit()
        if (self._journal is not None and self.checkpoint_every
                and not self._replaying
                and self._batch_idx % self.checkpoint_every == 0):
            self.checkpoint()
        return self.ranks

    # -- SLO + on-demand profiler capture ------------------------------------

    def solve_percentiles(self) -> dict:
        """Percentile snapshot of this session's per-batch solve latency
        (seconds): ``{count, p50_s, p95_s, p99_s, max_s}``."""
        return self._solve_hist.as_dict()

    def arm_capture(self, batches: int, log_dir: Optional[str] = None
                    ) -> None:
        """Arm a ``torch.profiler`` capture around the next ``batches``
        applies (manual re-arm of the SLO auto-capture); its chrome trace
        lands in ``log_dir`` (default: the SLO's ``capture_dir``, else
        ``profile`` under the journal directory or ``.``)."""
        self._capture_remaining = max(int(batches), 0)
        if log_dir is not None:
            self._capture_dir = log_dir

    def _capture_log_dir(self) -> str:
        if self._capture_dir is not None:
            return self._capture_dir
        if self.slo is not None and self.slo.capture_dir is not None:
            return self.slo.capture_dir
        base = self.journal_dir if self.journal_dir is not None else "."
        return os.path.join(base, "profile")

    def _maybe_capture_start(self) -> None:
        if self._capture_remaining <= 0 or self._capture_active:
            return
        log_dir = self._capture_log_dir()
        if start_profiler(log_dir):
            self._capture_active = True
            _obs().inc("slo.capture.start")
            get_flight().emit("slo.capture.start", dir=log_dir,
                              batches=self._capture_remaining)
        else:
            # no capture to be had (another profile is live): disarm rather
            # than retrying (and failing) on every subsequent batch
            self._capture_remaining = 0
            _obs().inc("slo.capture.unavailable")

    def _maybe_capture_stop(self) -> None:
        if not self._capture_active:
            return
        self._capture_remaining -= 1
        if self._capture_remaining > 0:
            return
        self._capture_active = False
        stop_profiler()
        _obs().inc("slo.capture.stop")
        get_flight().emit("slo.capture.stop")

    def _check_slo(self) -> None:
        """Judge the running solve p99 against the session's SLOConfig;
        on breach bump counters, emit a flight event, and (once per
        session) auto-arm profiler capture for the next batches."""
        s = self.slo
        if s is None or self._solve_hist.count < max(int(s.min_samples), 1):
            return
        p99 = self._solve_hist.percentile(99)
        if p99 is None or p99 * 1e6 <= s.solve_p99_us:
            return
        _obs().inc("slo.breach.solve_p99")
        get_flight().emit("slo.breach", metric="solve_p99",
                          p99_us=round(p99 * 1e6, 1),
                          budget_us=s.solve_p99_us)
        if s.capture_batches > 0 and not self._slo_captured:
            self._slo_captured = True
            self.arm_capture(s.capture_batches)

    # -- guard: escalation ladder + drift audit ------------------------------

    def _apply_mass_tol(self, hw: int, r: torch.Tensor) -> int:
        """Re-judge the H_MASS_DRIFT bit under the guard's ``mass_tol``.

        The engines judge the library default (``health.MASS_TOL``); a
        session-level override re-derives the bit from the candidate ranks
        — one [n] sum and one read, negligible next to the solve. A
        non-finite mass clears the bit (H_NONFINITE already covers that
        failure)."""
        g = self.guard
        if g is None or g.mass_tol == MASS_TOL:
            return hw
        drift = abs(float(torch.sum(self._flatten(r))) - 1.0)
        if np.isfinite(drift) and drift > g.mass_tol:
            return hw | H_MASS_DRIFT
        return hw & ~H_MASS_DRIFT

    def _recovery_params(self) -> PRParams:
        if self.guard.recovery_params is not None:
            return self.guard.recovery_params
        # the session's params with the full default iteration budget
        # restored: a chaos-starved max_iter=1 session must still recover
        # with a real solve
        return self.params._replace(max_iter=PRParams().max_iter)

    def _escalate(self, r_pre: torch.Tensor, db, hw: int, r, iters: int,
                  summary: Optional[dict] = None,
                  seq: Optional[int] = None):
        """Walk the recovery ladder after an unhealthy solve.

        Rung 1 (``dense``, or ``sharded`` in mesh mode) retries the batch
        with the *recovery* params (full iteration budget) from the
        pre-solve ranks, on the dense engine (the compact engine's own
        superset) or the sharded one. Rung 2
        (``recompute``) solves from scratch: a static solve from
        ``init_ranks``, which ignores every piece of possibly-poisoned rank
        state. Each rung's result is accepted only if ITS health word is
        clean; ``retry_budget`` bounds the rungs walked. Returns
        ``(ranks, iters, rungs_walked)`` — on an exhausted budget, the last
        attempt's result (counted in ``guard.escalate.exhausted``) plus a
        post-mortem bundle under `_postmortem_dir`."""
        obs = _obs()
        flight = get_flight()
        obs.inc("guard.unhealthy")
        for name in health_flags(hw):
            obs.inc(f"guard.health.{name}")
        rp = self._recovery_params()
        walked = 0
        hw2 = hw
        rungs = ("sharded" if self.mesh is not None else "dense",
                 "recompute")
        for rung in rungs[:max(int(self.guard.retry_budget), 0)]:
            walked += 1
            obs.inc(f"guard.escalate.{rung}")
            flight.emit("guard.escalate", rung=rung, seq=seq, health=hw)
            if rung == "dense":
                fn = dfp_pagerank if self.prune else df_pagerank
                r, it, hw2 = fn(self.snap, r_pre, db, rp, health=True)
            elif rung == "sharded":
                r, it, hw2 = self._sharded_solve(r_pre, db, rp, health=True)
            else:
                r, it, hw2 = self._static_solve(params=rp, health=True)
            iters, hw2 = int(it), self._apply_mass_tol(int(hw2), r)
            if hw2 == HEALTH_OK:
                obs.inc("guard.escalate.success")
                return r, iters, walked
        obs.inc("guard.escalate.exhausted")
        flight.emit("guard.escalate.exhausted", seq=seq, health=int(hw2))
        pdir = self._postmortem_dir()
        if pdir is not None:
            write_bundle(pdir, reason="escalation_exhausted",
                         health=int(hw2), trace=summary,
                         quarantine=self._last_quarantine,
                         journal_seq=seq,
                         extra={"first_health": int(hw),
                                "rungs_walked": walked,
                                "slo": self._solve_hist.as_dict()})
        return r, iters, walked

    def _postmortem_dir(self) -> Optional[str]:
        """Where failure bundles land: ``GuardConfig.postmortem_dir``, else
        the journal directory, else ``$REPRO_POSTMORTEM_DIR``; None disables
        bundle writing (no sensible destination)."""
        if self.guard is not None and self.guard.postmortem_dir is not None:
            return self.guard.postmortem_dir
        if self.journal_dir is not None:
            return self.journal_dir
        return os.environ.get("REPRO_POSTMORTEM_DIR") or None

    def _audit(self) -> None:
        """Every-K-batches drift audit: chained ranks vs a from-scratch
        static solve on the current snapshot. Breaching ``audit_tol`` (L1)
        adopts the static solve — the bounded-staleness backstop chained
        approximation error cannot creep past. The reference runs with the
        *recovery* params: the audit exists to catch degraded session state,
        so its anchor must not inherit a degraded iteration budget."""
        obs = _obs()
        obs.inc("guard.audit.runs")
        r_ref = self._static_solve(params=self._recovery_params())[0]
        l1 = float(torch.sum(torch.abs(self.flat_ranks()
                                       - self._flatten(r_ref))))
        resync = l1 > self.guard.audit_tol
        get_flight().emit("guard.audit", seq=self._batch_idx, l1=l1,
                          resync=resync)
        if resync:
            obs.inc("guard.audit.resync")
            self.ranks = r_ref

    # -- guard: journal + checkpoint / restore -------------------------------

    def _journal_append(self, seq: int, delta: Delta) -> None:
        if self._journal is None or self._replaying:
            return
        self._journal.append(JournalRecord(
            seq=seq, n=delta.n,
            del_src=np.asarray(delta.del_src, np.int32),
            del_dst=np.asarray(delta.del_dst, np.int32),
            ins_src=np.asarray(delta.ins_src, np.int32),
            ins_dst=np.asarray(delta.ins_dst, np.int32)))

    def _session_config(self) -> dict:
        """The JSON-safe arguments `restore` rebuilds the session with —
        the JAX session's keys, so either package restores the other's
        checkpoints."""
        g = self.guard
        gd = None
        if g is not None:
            gd = dataclasses.asdict(g)
            gd["recovery_params"] = (list(g.recovery_params)
                                     if g.recovery_params is not None
                                     else None)
        slo = (dataclasses.asdict(self.slo) if self.slo is not None
               else None)
        if slo is not None and slo["solve_p99_us"] == float("inf"):
            slo["solve_p99_us"] = None  # JSON has no inf
        return dict(n=self.n, params=list(self.params),
                    d_p=self._d_p, tile=self._tile, engine=self.engine,
                    prune=self.prune,
                    compact_threshold=self.compact_threshold,
                    trace=self.trace, mesh=self.mesh is not None,
                    checkpoint_every=self.checkpoint_every,
                    guard=gd, slo=slo, snap_kw=dict(self._snap_kw))

    def checkpoint(self) -> str:
        """Write a full-state checkpoint (ranks + snapshot mirrors + config)
        under ``journal_dir``, valid after batch ``_batch_idx``. Atomic via
        train/checkpoint.py's manifest rename. In mesh mode a collective:
        the shards' states and ranks (stacked [nd, n_loc], as JAX writes
        them) are gathered, rank 0 writes, and every rank returns once the
        checkpoint is committed."""
        if self.journal_dir is None:
            raise ValueError("session has no journal_dir")
        arrays, snap_extra = self.snap.state_dict()
        arrays = dict(arrays)
        if self.mesh is None:
            arrays["ranks"] = self.ranks
        else:
            arrays["ranks"] = self.mesh.all_gather(self.ranks).reshape(
                self.snap.nd, self.snap.n_loc)
        extra = {"snap": snap_extra, "session": self._session_config(),
                 "frontier_caps": _caps_to_json(self._caps)}
        path = os.path.join(self.journal_dir, f"step_{self._batch_idx:010d}")
        if self._writer:
            path = save_session_checkpoint(self.journal_dir, self._batch_idx,
                                           arrays, extra)
        if self.mesh is not None:
            self.mesh.barrier()
        get_flight().emit("guard.checkpoint", seq=self._batch_idx,
                          path=path)
        return path

    @classmethod
    def restore(cls, directory: str, mesh=None,
                device=None) -> "StreamSession":
        """Rebuild a session from ``directory``: newest checkpoint + replay
        of every journaled delta with a later sequence number. The
        snapshot and the ranks go on ``device`` (CUDA unless named).

        Bit-identical to the uninterrupted session: the checkpoint restores
        the snapshot mirrors exactly (free-list order included — it steers
        slot placement and therefore floating-point summation order), the
        frontier-caps high-water mark (overflow→dense fallback changes
        summation order too), and the rank vector; the replay then re-runs
        the deterministic per-batch lifecycle. A torn journal tail (crash
        mid-append) is detected by ``DeltaJournal.scan`` and dropped — at
        most the batch being written when the process died. The restored
        session's ``restore_s`` holds the seconds of each step: ``load``
        (the checkpoint, checksums verified), ``graph`` (the graph from
        the checkpoint's keys), ``snapshot`` (its `DeviceSnapshot`),
        ``static`` (the session's static solve), ``restage``
        (`load_state`) and ``replay``.

        A checkpoint of either package restores. A mesh session's
        checkpoint needs ``mesh=`` (meshes do not serialize) of the
        checkpoint's shard count: every rank calls `restore` and keeps its
        shard; only rank 0 cuts a torn journal tail."""
        try:
            return cls._restore_impl(directory, mesh, device)
        except Exception as e:
            # a failed recovery is the post-mortem case par excellence:
            # bundle the flight tail + registry before re-raising (the
            # write is best-effort and never masks the original error)
            write_bundle(directory, reason="restore_failed",
                         extra={"error": repr(e)})
            raise

    @classmethod
    def _restore_impl(cls, directory: str, mesh, device) -> "StreamSession":
        t0 = time.perf_counter()
        arrays, extra, step = load_session_checkpoint(directory)
        t1 = time.perf_counter()
        cfg = extra["session"]
        if cfg["mesh"] and mesh is None:
            raise ValueError("checkpoint is from a mesh session: pass mesh=")
        if not cfg["mesh"] and mesh is not None:
            raise ValueError("checkpoint is single-device: mesh= given")
        params = PRParams(*cfg["params"])
        guard = None
        if cfg.get("guard") is not None:
            gd = dict(cfg["guard"])
            if gd.get("recovery_params") is not None:
                gd["recovery_params"] = PRParams(*gd["recovery_params"])
            guard = GuardConfig(**gd)
        slo = None
        if cfg.get("slo") is not None:
            sd = dict(cfg["slo"])
            if sd.get("solve_p99_us") is None:
                sd["solve_p99_us"] = float("inf")
            slo = SLOConfig(**sd)
        g = graph_from_sorted_keys(
            int(cfg["n"]), np.ascontiguousarray(arrays["keys"]))
        t_graph = time.perf_counter()
        snap_kw = cfg.get("snap_kw", {})
        if mesh is not None:
            snap = ShardedSnapshot(g, mesh, d_p=cfg["d_p"], tile=cfg["tile"],
                                   **snap_kw)
        else:
            snap = DeviceSnapshot(g, d_p=cfg["d_p"], tile=cfg["tile"],
                                  device=device, **snap_kw)
        _sync(snap.device)
        t_snap = time.perf_counter()
        sess = cls(g, params=params, d_p=cfg["d_p"], tile=cfg["tile"],
                   engine=cfg["engine"], prune=cfg["prune"],
                   compact_threshold=cfg["compact_threshold"], mesh=mesh,
                   trace=cfg["trace"], guard=guard, slo=slo,
                   journal_dir=directory,
                   checkpoint_every=cfg["checkpoint_every"], snapshot=snap,
                   device=device, **snap_kw)
        del g, snap
        _sync(sess.device)
        t2 = time.perf_counter()
        sess.snap.load_state(arrays, extra["snap"])
        ranks = arrays.pop("ranks")
        if mesh is not None:
            want = (sess.snap.nd, sess.snap.n_loc)
            if ranks.shape != want:
                raise ValueError(f"checkpointed ranks {ranks.shape} on a "
                                 f"mesh of {want}")
            ranks = ranks[sess.snap.shard]
        sess.ranks = torch.from_numpy(np.ascontiguousarray(ranks)).to(
            sess.device)
        del arrays
        _sync(sess.device)
        t3 = time.perf_counter()
        sess._batch_idx = step
        sess._caps = _caps_from_json(extra.get("frontier_caps"))
        records, truncated = DeltaJournal.scan(journal_path(directory))
        if mesh is not None:
            # every rank has read the journal before rank 0 may cut it or
            # append the next batch
            mesh.barrier()
        if truncated and sess._writer:
            # cut the torn tail, so the session's next append follows the
            # last intact record and a later restore reads it (JAX's
            # session appends after the torn bytes)
            os.truncate(journal_path(directory),
                        sum(record_bytes(rec) for rec in records))
        sess._replaying = True
        replayed = 0
        try:
            for rec in records:
                if rec.seq <= step:
                    continue
                sess.apply(Delta(
                    n=rec.n, del_src=rec.del_src.astype(np.int64),
                    del_dst=rec.del_dst.astype(np.int64),
                    ins_src=rec.ins_src.astype(np.int64),
                    ins_dst=rec.ins_dst.astype(np.int64)))
                sess._batch_idx = rec.seq
                replayed += 1
        finally:
            sess._replaying = False
        sess.restore_s = dict(load=t1 - t0, graph=t_graph - t1,
                              snapshot=t_snap - t_graph, static=t2 - t_snap,
                              restage=t3 - t2,
                              replay=time.perf_counter() - t3)
        _obs().inc("guard.restores")
        get_flight().emit("guard.restore", step=step, replayed=replayed)
        return sess

    def close(self) -> None:
        """Close the journal file handle (restore() reopens on demand)."""
        if self._journal is not None:
            self._journal.close()
            self._journal = None

    # -- engine/caps plumbing ------------------------------------------------

    def solve(self, engine: str, r_prev: torch.Tensor, db, caps,
              kernels: Optional[bool] = None, trace: bool = False,
              health: bool = False):
        """One batch's DF(-P) solve on the current snapshot from `r_prev`:
        (r, iters), with the engine's TraceBuffer appended when `trace` and
        its health word (a 0-d int32 tensor) when `health`. `apply` calls
        it; `kernels=False` repeats a batch's solve on the plain PyTorch
        path. Does not touch session state."""
        if engine == "sharded":
            return self._sharded_solve(r_prev, db, self.params, caps=caps,
                                       kernels=kernels, trace=trace,
                                       health=health)
        if engine == "compact":
            fn = dfp_pagerank_compact if self.prune else df_pagerank_compact
            return fn(self.snap, None, r_prev, db, self.params,
                      kernels=kernels, trace=trace, health=health)
        fn = dfp_pagerank if self.prune else df_pagerank
        return fn(self.snap, r_prev, db, self.params, frontier_caps=caps,
                  kernels=kernels, trace=trace, health=health)

    def _frontier_caps(self, est: int):
        """Frontier capacity plan for this batch — the running elementwise
        max over the stream (never-shrink). `frontier.caps_growth` counts
        the batches that grew it."""
        new = (sharded_frontier_caps(self.snap.sg, est)
               if self.mesh is not None else caps_for(self.snap.dg, est))
        merged = merge_caps(self._caps, new)
        if self._caps is not None and merged != self._caps:
            _obs().inc("frontier.caps_growth")
        self._caps = merged
        return merged

    def _sharded_solve(self, r_prev, db, params: PRParams, caps=None,
                       kernels: Optional[bool] = None, trace: bool = False,
                       health: bool = False):
        """The sharded DF-P solve of one batch from `r_prev` (this rank's
        slice), its frontier seeded from the batch on the device."""
        snap = self.snap
        dv0, dn0 = initial_affected_sharded(snap.nd, snap.n_loc, db,
                                            snap.shard)
        return distributed_dfp_pagerank(
            self.mesh, snap.sg, r_prev, dv0, dn0, params, trace=trace,
            frontier_caps=caps, health=health, kernels=kernels)

    def _choose_engine(self, delta: Delta) -> str:
        if self.mesh is not None:
            return "sharded"
        if self.engine != "auto":
            return self.engine
        return choose_engine(delta, self.snap._outdeg, self.n,
                             self.compact_threshold)

    def _static_solve(self, params: Optional[PRParams] = None,
                      health: bool = False):
        """From-scratch static solve on the current snapshot: the one place
        the recipe lives (init vector, engine, params), in lock-step across
        __init__, static_reference, recompute, the audit and the ladder's
        recompute rung — in the session's rank layout (dense [n], or this
        rank's [n_loc] slice in mesh mode)."""
        params = params if params is not None else self.params
        if self.mesh is None:
            return static_pagerank(self.snap.dg,
                                   init_ranks(self.n, device=self.device),
                                   params, health=health)
        r0 = torch.full((self.snap.n_loc,), 1.0 / self.n,
                        dtype=torch.float64, device=self.device)
        return distributed_static_pagerank(self.mesh, self.snap.sg, r0,
                                           params, health=health)

    def _flatten(self, r: torch.Tensor) -> torch.Tensor:
        """Dense [n] ranks from the session's layout (in mesh mode an
        all-gather: every rank calls it)."""
        if self.mesh is None:
            return r
        return self.mesh.all_gather(r)[:self.n]

    def flat_ranks(self) -> torch.Tensor:
        """Current ranks as a dense [n] vector: `ranks` itself on one
        device, all-gathered in mesh mode (a collective)."""
        return self._flatten(self.ranks)

    def static_reference(self) -> torch.Tensor:
        """From-scratch static solve on the *current* snapshot, dense [n] —
        the verification anchor for the chained DF-P ranks. Does not touch
        session state."""
        return self._flatten(self._static_solve()[0])

    def topk(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k vertices by rank: (ids [k], ranks [k]), descending."""
        vals, ids = torch.topk(self.flat_ranks(), k)
        return ids.cpu().numpy(), vals.cpu().numpy()

    def recompute(self) -> torch.Tensor:
        """Full static recomputation on the current snapshot (re-sync /
        verification anchor); resets the session's rank state and appends
        an ``engine="recompute"`` record to ``history`` and bumps the
        ``session.recompute`` counter."""
        t0 = time.perf_counter()
        self.ranks, iters = self._static_solve()
        _sync(self.device)
        _obs().inc("session.recompute")
        self.history.append(BatchStats(
            batch_size=0, engine="recompute", iters=int(iters),
            ingest_s=0.0, snapshot=SnapshotStats(),
            solve_s=time.perf_counter() - t0))
        return self.ranks
