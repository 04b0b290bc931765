"""repro_torch.obs — observability. For now the iteration trace
(`trace`): a fixed-shape ``TraceBuffer`` that every engine fills with
``trace=True``, with no host read per iteration and ranks identical with
tracing off or on. The rest of the JAX package's `repro.obs` (spans,
counters, the flight recorder, histograms, reports, the gate, post-mortem
bundles) comes with a later slice of the port."""
from .trace import (ENGINE_IDS, ENGINE_NAMES, TraceBuffer, maybe_summary,
                    trace_init, trace_record, trace_summary)

__all__ = ["ENGINE_IDS", "ENGINE_NAMES", "TraceBuffer", "trace_init",
           "trace_record", "trace_summary", "maybe_summary"]
