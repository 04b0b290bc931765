"""repro_torch.obs — observability layer: iteration traces, spans, sinks,
gates.

The paper's headline claims are observability claims (iterations to
convergence, fraction of affected vertices per batch, the time split of a
batch); this subsystem makes every one of them inspectable:

  * `trace`  — fixed-shape ``TraceBuffer`` every engine fills with
    ``trace=True`` (no host read per iteration; ranks identical with
    tracing off or on);
  * `spans`  — host-side wall-clock spans + monotonic counters, optionally
    ``torch.profiler.record_function`` ranges around kernel launches;
  * `report` — ``RunReport`` structured sink (JSON / JSONL), schema
    ``repro.obs/bench-v2``;
  * `check`  — ``python -m repro_torch.obs.check`` regression gate diffing
    two bench reports;
  * `flight` — always-on bounded ring buffer of structured events (what
    happened, in order — the post-failure record counters can't give);
  * `hist`   — log-bucketed latency histograms (p50/p95/p99 per span),
    ``SLOConfig`` breach budgets + on-demand ``torch.profiler`` capture;
  * `postmortem` — failure bundles (flight tail + health + trace + registry
    snapshot), rendered by ``python -m repro_torch.obs.postmortem``.

The port of the JAX package's `repro.obs`, with the same public names. Its
registry, flight recorder and kill switch are this package's own.
"""
from .trace import (ENGINE_IDS, ENGINE_NAMES, TraceBuffer, maybe_summary,
                    trace_init, trace_record, trace_summary)
from .spans import Registry, Span, get_registry, reset_registry
from .report import RunReport, load_report, validate_report
from .flight import (FlightEvent, FlightRecorder, get_flight, obs_enabled,
                     reset_flight, set_obs_enabled)
from .hist import Histogram, SLOConfig, percentiles_from_samples
from .postmortem import load_bundle, write_bundle

__all__ = [
    "ENGINE_IDS", "ENGINE_NAMES", "TraceBuffer", "maybe_summary",
    "trace_init", "trace_record", "trace_summary",
    "Registry", "Span", "get_registry", "reset_registry",
    "RunReport", "load_report", "validate_report",
    "FlightEvent", "FlightRecorder", "get_flight", "reset_flight",
    "obs_enabled", "set_obs_enabled",
    "Histogram", "SLOConfig", "percentiles_from_samples",
    "write_bundle", "load_bundle",
]
