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
hand). Its multi-device mode (``mesh=``) and fault tolerance (``guard=``,
``journal_dir=``, ``checkpoint_every=``) come with later slices of the
port; until then each argument raises ``NotImplementedError`` rather than
being ignored.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.compact import df_pagerank_compact, dfp_pagerank_compact
from ..core.dynamic import df_pagerank, dfp_pagerank
from ..core.frontier import caps_for, merge_caps
from ..core.graph import BatchUpdate, Graph
from ..core.pagerank import PRParams, init_ranks, static_pagerank
from ..obs.flight import get_flight
from ..obs.hist import Histogram, SLOConfig, start_profiler, stop_profiler
from ..obs.spans import get_registry as _obs
from ..obs.trace import maybe_summary
from .delta import Delta, ingest
from .snapshot import DeviceSnapshot, SnapshotStats, _sync

__all__ = ["StreamSession", "BatchStats", "choose_engine",
           "frontier_estimate"]

#: session arguments of the JAX package that later slices of the port bring,
#: with the ROADMAP item each waits on
_LATER = {"mesh": "A7 (sharded engines)", "guard": "A5 (guard)",
          "journal_dir": "A5 (guard)", "checkpoint_every": "A5 (guard)"}


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

    @property
    def total_s(self) -> float:
        return (self.ingest_s + self.snapshot.host_s
                + self.snapshot.device_s + self.solve_s)


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
    """

    def __init__(self, g: Graph, params: Optional[PRParams] = None,
                 d_p: int = 64, tile: int = 256, engine: str = "auto",
                 prune: bool = True, compact_threshold: float = 0.015,
                 snapshot=None, mesh=None, trace: bool = False,
                 guard=None, slo: Optional[SLOConfig] = None,
                 journal_dir: Optional[str] = None,
                 checkpoint_every: int = 0, device=None, **snap_kw):
        given = dict(mesh=mesh, guard=guard, journal_dir=journal_dir,
                     checkpoint_every=checkpoint_every or None)
        for name, value in given.items():
            if value is not None:
                raise NotImplementedError(
                    f"StreamSession({name}=...) is not ported yet: "
                    f"ROADMAP {_LATER[name]}")
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
        self.slo = slo
        self.snap = snapshot if snapshot is not None else DeviceSnapshot(
            g, d_p=d_p, tile=tile, device=device, **snap_kw)
        self.ranks, self._init_iters = self._static_solve()
        self.history: List[BatchStats] = []
        #: never-shrink FrontierCaps across the stream (None until the
        #: first batch): a burst batch can only ever grow them
        self._caps = None
        #: sequence number of the last solved batch (noops don't count)
        self._batch_idx = 0
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

    @property
    def n(self) -> int:
        return self.snap.n

    @property
    def m(self) -> int:
        return self.snap.m

    @property
    def device(self) -> torch.device:
        return self.snap.device

    # -- the streaming API ---------------------------------------------------

    def apply(self, batch: BatchUpdate | Delta) -> torch.Tensor:
        """Apply Δ^t and return the new rank vector (on the device).

        A raw batch is validated and canonicalized (`ingest`, strict id
        checks); a `Delta` is taken as it is. `solve_s` times the span
        ``session.solve`` from inside it and ends in a synchronize on
        CUDA. An armed profiler capture encloses the snapshot pass and the
        solve; starting and stopping it falls outside every timed span."""
        obs = _obs()
        flight = get_flight()
        t0 = time.perf_counter()
        with obs.span("session.ingest"):
            delta = batch if isinstance(batch, Delta) else ingest(batch,
                                                                  self.n)
            db = delta.to_device(device=self.device) if delta.size else None
        ingest_s = time.perf_counter() - t0

        if delta.size == 0:
            # an empty Δ changes nothing: skip the snapshot pass and the
            # solve — the zero-cost no-op every upstream coalescer expects
            obs.inc("session.engine.noop")
            self.history.append(BatchStats(
                batch_size=0, engine="noop", iters=0, ingest_s=ingest_s,
                snapshot=SnapshotStats(), solve_s=0.0))
            return self.ranks

        seq = self._batch_idx + 1
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
        with obs.span("session.solve", annotate=True):
            t1 = time.perf_counter()
            (r, iters), summary = maybe_summary(
                self.solve(engine, self.ranks, db, caps, trace=self.trace),
                self.trace)
            iters = int(iters)
            _sync(self.device)
            solve_s = time.perf_counter() - t1
        self._maybe_capture_stop()

        self.ranks = r
        self._batch_idx = seq
        self.history.append(BatchStats(
            batch_size=delta.size, engine=engine, iters=iters,
            ingest_s=ingest_s, snapshot=snap_stats, solve_s=solve_s,
            trace=summary))
        self._solve_hist.add(solve_s)
        flight.emit("session.batch", seq=seq, engine=engine,
                    size=delta.size, iters=iters,
                    solve_us=round(solve_s * 1e6, 1), health=0,
                    escalations=0)
        self._check_slo()
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
        ``./profile``)."""
        self._capture_remaining = max(int(batches), 0)
        if log_dir is not None:
            self._capture_dir = log_dir

    def _capture_log_dir(self) -> str:
        if self._capture_dir is not None:
            return self._capture_dir
        if self.slo is not None and self.slo.capture_dir is not None:
            return self.slo.capture_dir
        return os.path.join(".", "profile")

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

    # -- engine/caps plumbing ------------------------------------------------

    def solve(self, engine: str, r_prev: torch.Tensor, db, caps,
              kernels: Optional[bool] = None, trace: bool = False):
        """One batch's DF(-P) solve on the current snapshot from `r_prev`:
        (r, iters), with the engine's TraceBuffer appended when `trace`.
        `apply` calls it; `kernels=False` repeats a batch's solve on the
        plain PyTorch path. Does not touch session state."""
        if engine == "compact":
            fn = dfp_pagerank_compact if self.prune else df_pagerank_compact
            return fn(self.snap, None, r_prev, db, self.params,
                      kernels=kernels, trace=trace)
        fn = dfp_pagerank if self.prune else df_pagerank
        return fn(self.snap, r_prev, db, self.params, frontier_caps=caps,
                  kernels=kernels, trace=trace)

    def _frontier_caps(self, est: int):
        """Frontier capacity plan for this batch — the running elementwise
        max over the stream (never-shrink). `frontier.caps_growth` counts
        the batches that grew it."""
        merged = merge_caps(self._caps, caps_for(self.snap.dg, est))
        if self._caps is not None and merged != self._caps:
            _obs().inc("frontier.caps_growth")
        self._caps = merged
        return merged

    def _choose_engine(self, delta: Delta) -> str:
        if self.engine != "auto":
            return self.engine
        return choose_engine(delta, self.snap._outdeg, self.n,
                             self.compact_threshold)

    def _static_solve(self, params: Optional[PRParams] = None):
        """From-scratch static solve on the current snapshot: the one place
        the recipe lives (init vector, engine, params)."""
        params = params if params is not None else self.params
        return static_pagerank(self.snap.dg,
                               init_ranks(self.n, device=self.device), params)

    def flat_ranks(self) -> torch.Tensor:
        """Current ranks as a dense [n] vector. Single-device, that is
        `ranks` itself."""
        return self.ranks

    def static_reference(self) -> torch.Tensor:
        """From-scratch static solve on the *current* snapshot — the
        verification anchor for the chained DF-P ranks. Does not touch
        session state."""
        return self._static_solve()[0]

    def topk(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k vertices by rank: (ids [k], ranks [k]), descending."""
        vals, ids = torch.topk(self.ranks, k)
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
