"""Host-side spans and monotonic counters.

The device-side story is `obs.trace`; this module covers everything the
host does around the solves: snapshot maintenance phases, engine choice,
rebuild fallbacks, scatter traffic. A ``Registry`` aggregates

  * **spans** — named wall-clock sections (count / total / min / max), used
    as ``with registry.span("snapshot.device_refresh"): ...``. With
    ``annotate=True`` a span is also a ``torch.profiler.record_function``
    range, so the same name encloses its CUDA kernels on the timeline of a
    live ``torch.profiler`` capture (`obs.hist.start_profiler`). A span
    times what its body waits for: the sessions and the snapshot end their
    device spans in a synchronize, the engines in their loop's last read.
  * **counters** — monotonic ``inc(name, v)`` accumulators (in-place edits
    vs rebuild fallbacks, rows/tiles scattered, migrations, per-engine
    batch counts...).

One process-wide default registry keeps instrumentation call sites
import-light (`get_registry()`); tests and benches that need isolation can
``reset_registry()`` or construct their own. It is this package's own: the
JAX package's `repro.obs` keeps a registry of its own.

Naming scheme: dotted paths, ``<subsystem>.<event>``, e.g.
``snapshot.apply_net_delta``, ``snapshot.rebuild``,
``session.engine.compact``, ``kernels.stream_scatter.calls``.

A copy of the JAX package's `repro.obs.spans`, with
``torch.profiler.record_function`` where JAX opens a
``jax.profiler.TraceAnnotation``.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

from torch.profiler import record_function

from .flight import obs_enabled
from .hist import Histogram

__all__ = ["SpanStats", "Registry", "Span", "get_registry", "reset_registry"]


class SpanStats:
    """Aggregate of one span name: count / total / min / max seconds."""

    __slots__ = ("count", "total_s", "min_s", "max_s")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.min_s = float("inf")
        self.max_s = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    def as_dict(self) -> dict:
        return {"count": self.count, "total_s": self.total_s,
                "min_s": self.min_s, "max_s": self.max_s,
                "mean_s": self.total_s / max(self.count, 1)}


class Registry:
    """Thread-safe span/counter sink; cheap enough to leave always-on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._spans: Dict[str, SpanStats] = {}
        self._counters: Dict[str, int] = {}
        #: per-span latency histograms (obs.hist) — the p50/p95/p99 source;
        #: fed alongside SpanStats unless REPRO_OBS_OFF gates them off
        self._hists: Dict[str, Histogram] = {}

    # -- counters ------------------------------------------------------------

    def inc(self, name: str, v: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + int(v)

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    # -- spans ---------------------------------------------------------------

    @contextmanager
    def span(self, name: str, annotate: bool = False):
        ann = record_function(name) if annotate else None
        if ann is not None:
            ann.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if ann is not None:
                ann.__exit__(None, None, None)
            with self._lock:
                st = self._spans.get(name)
                if st is None:
                    st = self._spans[name] = SpanStats()
                st.add(dt)
                if obs_enabled():
                    h = self._hists.get(name)
                    if h is None:
                        h = self._hists[name] = Histogram()
                    h.add(dt)

    def span_stats(self, name: str) -> Optional[SpanStats]:
        with self._lock:
            return self._spans.get(name)

    def span_hist(self, name: str) -> Optional[Histogram]:
        """The span's latency histogram (None before its first timed pass
        or when the always-on layer is off)."""
        with self._lock:
            return self._hists.get(name)

    def record_hist(self, name: str, seconds: float) -> None:
        """Feed one latency sample into ``name``'s histogram without timing
        a span (callers that already hold the wall-clock, e.g. per-batch
        session accounting)."""
        if not obs_enabled():
            return
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.add(seconds)

    # -- export --------------------------------------------------------------

    def report(self) -> dict:
        """{"spans": {name: {...}}, "counters": {name: n}} snapshot. Span
        entries carry p50_s/p95_s/p99_s from the attached histogram when
        one exists (always-on layer enabled)."""
        with self._lock:
            spans = {}
            for k, v in sorted(self._spans.items()):
                d = v.as_dict()
                h = self._hists.get(k)
                if h is not None and h.count:
                    hd = h.as_dict()
                    d.update(p50_s=hd["p50_s"], p95_s=hd["p95_s"],
                             p99_s=hd["p99_s"])
                spans[k] = d
            return {
                "spans": spans,
                "counters": dict(sorted(self._counters.items())),
            }

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()
            self._hists.clear()


class Span:
    """`with Span("name"):` against the default registry — the sugar the
    instrumentation call sites use."""

    def __init__(self, name: str, annotate: bool = False,
                 registry: Optional[Registry] = None):
        self.name = name
        self._cm = (registry or get_registry()).span(name, annotate=annotate)

    def __enter__(self):
        return self._cm.__enter__()

    def __exit__(self, *exc):
        return self._cm.__exit__(*exc)


_DEFAULT = Registry()


def get_registry() -> Registry:
    return _DEFAULT


def reset_registry() -> None:
    _DEFAULT.reset()
