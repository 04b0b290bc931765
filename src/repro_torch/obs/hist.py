"""Log-bucketed latency histograms + SLO config + profiler capture hooks.

The paper's headline numbers are *latency distributions over batches*, yet
span stats only keep count/total/min/max — a p99-regressing engine choice
or a one-in-fifty slow rebuild is invisible in a mean. ``Histogram`` fixes
that with HDR-style log-spaced buckets: ``buckets_per_decade`` geometric
buckets per decade over ``[min_value, max_value)`` seconds, so relative
error is a constant ~``10^(1/bpd)`` (~6.6% at the default 36/decade) at any
magnitude, ``add`` is one ``math.log10`` + an integer increment (no
allocation, no sorting), and percentiles come from one cumulative walk at
report time.

``SLOConfig`` names the budget a ``StreamSession`` must hold (solve p99 in
microseconds) and what to do on breach: bump ``slo.breach.*`` counters,
emit a flight event, and arm a ``torch.profiler`` capture around the next
``capture_batches`` batches, so the kernel-level timeline of the *slow*
regime lands on disk without paying profiler overhead in the steady state.
Spans opened with ``annotate=True`` are ``torch.profiler.record_function``
ranges, so the ``solve.*`` / ``session.solve`` /
``snapshot.device_refresh`` names appear on that timeline around the CUDA
kernels they launch.

A copy of the JAX package's `repro.obs.hist`; the capture runs
``torch.profiler`` where JAX runs ``jax.profiler``.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import List, Optional, Sequence

import torch

__all__ = ["Histogram", "SLOConfig", "percentiles_from_samples",
           "start_profiler", "stop_profiler"]


class Histogram:
    """Log-bucketed histogram of nonnegative samples (seconds by default).

    Not thread-safe by itself — the owning ``Registry`` serializes access
    under its lock; standalone users on one thread need nothing.
    """

    __slots__ = ("min_value", "buckets_per_decade", "_counts", "count",
                 "total", "min", "max")

    def __init__(self, min_value: float = 1e-7, max_value: float = 1e4,
                 buckets_per_decade: int = 36):
        if not (0 < min_value < max_value):
            raise ValueError("need 0 < min_value < max_value")
        self.min_value = float(min_value)
        self.buckets_per_decade = int(buckets_per_decade)
        decades = math.log10(max_value / min_value)
        nb = int(math.ceil(decades * buckets_per_decade)) + 1
        self._counts: List[int] = [0] * nb
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = 0.0

    def _index(self, v: float) -> int:
        if v <= self.min_value:
            return 0
        i = int(math.log10(v / self.min_value) * self.buckets_per_decade)
        return min(i, len(self._counts) - 1)

    def _upper(self, i: int) -> float:
        """Upper bound of bucket ``i`` — the value a percentile reports
        (pessimistic by at most one bucket width)."""
        return self.min_value * 10.0 ** ((i + 1) / self.buckets_per_decade)

    def add(self, v: float) -> None:
        v = float(v)
        if not (v >= 0.0) or v != v:  # negatives / NaN: not a latency
            return
        self._counts[self._index(v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def merge(self, other: "Histogram") -> None:
        if (other.min_value != self.min_value
                or other.buckets_per_decade != self.buckets_per_decade
                or len(other._counts) != len(self._counts)):
            raise ValueError("histogram layouts differ")
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.total += other.total
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    def percentile(self, p: float) -> Optional[float]:
        """Value at percentile ``p`` in [0, 100]; None when empty. Clamped
        to the exact observed [min, max] so tiny sample counts never report
        a bucket bound outside the data."""
        if self.count == 0:
            return None
        target = max(1, int(math.ceil(self.count * p / 100.0)))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= target:
                return min(max(self._upper(i), self.min), self.max)
        return self.max  # pragma: no cover - counts always sum to count

    def as_dict(self) -> dict:
        """The percentile snapshot reports embed (seconds)."""
        if self.count == 0:
            return {"count": 0}
        return {"count": self.count,
                "p50_s": self.percentile(50),
                "p95_s": self.percentile(95),
                "p99_s": self.percentile(99),
                "max_s": self.max}


def percentiles_from_samples(samples: Sequence[float]) -> dict:
    """Exact {p50, p95, p99, max} (seconds) from a raw sample list — for
    callers that kept every per-batch latency and need no bucketing."""
    xs = sorted(float(s) for s in samples)
    if not xs:
        return {}

    def pick(p):
        return xs[min(len(xs) - 1,
                      max(0, int(math.ceil(len(xs) * p / 100.0)) - 1))]

    return {"p50_s": pick(50), "p95_s": pick(95), "p99_s": pick(99),
            "max_s": xs[-1]}


@dataclasses.dataclass(frozen=True)
class SLOConfig:
    """Latency SLO for a ``StreamSession``.

    The session feeds every solve's wall-clock into a per-session
    ``Histogram``; once ``min_samples`` have accumulated, a running p99
    above ``solve_p99_us`` is a breach: ``slo.breach.solve_p99`` increments
    every breaching batch, a ``slo.breach`` flight event is emitted, and —
    when ``capture_batches > 0`` — profiler capture is armed around the
    next N batches (one auto-capture per session; re-arm explicitly with
    ``session.arm_capture``)."""
    #: p99 budget for the per-batch solve wall-clock, microseconds
    solve_p99_us: float = float("inf")
    #: minimum solve samples before the p99 is judged (cold-start guard:
    #: the first batches carry the process's warm-up)
    min_samples: int = 20
    #: batches to run under ``torch.profiler`` after a breach (0 = off)
    capture_batches: int = 0
    #: trace output directory (None: ``./profile``)
    capture_dir: Optional[str] = None


# -- profiler capture (thin wrappers so tests can monkeypatch) --------------

#: the live capture, (profile, log_dir), or None: torch.profiler runs one
#: profile at a time in a process
_LIVE = None
_stamps = 0  # per-process trace counter (uniquifies same-second traces)


def start_profiler(log_dir: str) -> bool:
    """Start a ``torch.profiler`` capture (host ranges, and the CUDA
    kernels when a card is present) whose chrome trace `stop_profiler`
    writes into ``log_dir``. False when a profile is already live, this
    capture or anyone's (a second profile would start, and stopping it
    would end the first), or the profiler does not start: a failed capture
    must never take the stream down; the session then counts
    ``slo.capture.unavailable``."""
    global _LIVE
    if _LIVE is not None or torch.autograd._profiler_enabled():
        return False
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    try:
        prof = torch.profiler.profile(activities=acts, record_shapes=False)
        prof.start()
    except RuntimeError:  # e.g. a profile not started here is live
        return False
    _LIVE = (prof, log_dir)
    return True


def stop_profiler() -> bool:
    """Stop the live capture and write its chrome trace as
    ``<log_dir>/trace-<stamp>.json``; False when none is live or the
    trace cannot be written."""
    global _LIVE, _stamps
    if _LIVE is None:
        return False
    prof, log_dir = _LIVE
    _LIVE = None
    _stamps += 1
    stamp = f"{time.strftime('%Y%m%dT%H%M%S')}-{os.getpid()}-{_stamps:03d}"
    try:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir,
                                              f"trace-{stamp}.json"))
        return True
    except (RuntimeError, OSError):
        return False
