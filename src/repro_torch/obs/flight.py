"""Flight recorder: a bounded ring buffer of structured events.

Counters say *how many* times something happened but not *in what order*
or around which batches — the question after a failure is always "what
happened just before?". The flight recorder answers it: every interesting
host-side transition (batch applied, engine chosen, rebuild fallback,
quarantine, SLO breach, profiler capture) appends one ``FlightEvent`` — a
monotonic timestamp, a dotted ``kind`` (the span / counter registry's
naming scheme) and a small payload dict — into a fixed ring. Old events
are overwritten, never reallocated: memory is bounded, an ``emit`` is a
lock and two list writes, and the recorder is cheap enough to leave on.

Host-only: events come from the same call sites as the span registry, one
per *decision*, never per iteration (iteration telemetry is `obs.trace`'s
job).

Kill switch: ``REPRO_OBS_OFF=1`` (environment, read at import; or
``set_obs_enabled(False)`` in-process) turns ``emit`` and the span
histograms into no-ops. The switch is this package's own: it reads the
same variable as the JAX package's `repro.obs.flight` but keeps its own
state, so turning one off in-process leaves the other on.

A copy of the JAX package's `repro.obs.flight`.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional

__all__ = ["FlightEvent", "FlightRecorder", "get_flight", "reset_flight",
           "obs_enabled", "set_obs_enabled"]

_ENABLED = os.environ.get("REPRO_OBS_OFF", "") not in ("1", "true", "yes")


def obs_enabled() -> bool:
    """True unless the always-on layer is switched off (``REPRO_OBS_OFF=1``
    or :func:`set_obs_enabled`). Gates flight emits and span histograms;
    spans and counters themselves are never gated."""
    return _ENABLED


def set_obs_enabled(on: bool) -> None:
    """In-process override of the ``REPRO_OBS_OFF`` kill switch (to
    measure the layer on and off inside one process)."""
    global _ENABLED
    _ENABLED = bool(on)


class FlightEvent(NamedTuple):
    """One recorded event: global sequence number, monotonic timestamp,
    dotted kind, payload dict (small, JSON-serializable values only)."""
    seq: int
    ts: float
    kind: str
    data: dict

    def as_dict(self) -> dict:
        return {"seq": self.seq, "ts": self.ts, "kind": self.kind,
                "data": self.data}


class FlightRecorder:
    """Bounded, thread-safe ring buffer of :class:`FlightEvent`.

    ``capacity`` is fixed at construction; the ``seq`` counter is global and
    never resets inside one recorder's lifetime, so ``dropped`` (events
    overwritten by wraparound) is exact and gaps in a tail are visible.
    """

    def __init__(self, capacity: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: List[Optional[FlightEvent]] = [None] * self.capacity
        self._seq = 0
        self._by_kind: Dict[str, int] = {}

    def emit(self, kind: str, **data) -> None:
        """Record one event (no-op under ``REPRO_OBS_OFF``)."""
        if not _ENABLED:
            return
        ts = time.monotonic()
        with self._lock:
            seq = self._seq
            self._seq = seq + 1
            self._ring[seq % self.capacity] = FlightEvent(seq, ts, kind, data)
            self._by_kind[kind] = self._by_kind.get(kind, 0) + 1

    def __len__(self) -> int:
        with self._lock:
            return min(self._seq, self.capacity)

    @property
    def total(self) -> int:
        """Events ever emitted (>= len(self) once the ring wrapped)."""
        with self._lock:
            return self._seq

    @property
    def dropped(self) -> int:
        """Events overwritten by ring wraparound."""
        with self._lock:
            return max(0, self._seq - self.capacity)

    def events(self) -> List[FlightEvent]:
        """Chronological snapshot of the surviving window (oldest first)."""
        with self._lock:
            n = min(self._seq, self.capacity)
            start = self._seq - n
            out = [self._ring[i % self.capacity]
                   for i in range(start, self._seq)]
        return [e for e in out if e is not None]

    def tail(self, n: int) -> List[FlightEvent]:
        """The newest ``n`` events, chronological."""
        evs = self.events()
        return evs[-max(int(n), 0):]

    def summary(self) -> dict:
        """Small aggregate for reports: totals + per-kind counts."""
        with self._lock:
            return {"total": self._seq,
                    "dropped": max(0, self._seq - self.capacity),
                    "capacity": self.capacity,
                    "by_kind": dict(sorted(self._by_kind.items()))}

    def reset(self) -> None:
        with self._lock:
            self._ring = [None] * self.capacity
            self._seq = 0
            self._by_kind.clear()


_DEFAULT = FlightRecorder()


def get_flight() -> FlightRecorder:
    """The process-wide default recorder (as ``spans.get_registry``)."""
    return _DEFAULT


def reset_flight() -> None:
    _DEFAULT.reset()
