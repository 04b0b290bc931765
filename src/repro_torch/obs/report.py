"""Structured sinks: the machine-readable side of every benchmark run.

``RunReport`` collects benchmark records (name, min/mean/std timing, parsed
derived metrics, optional iteration-trace summary), a span/counter snapshot
from the default `obs.spans` registry, and environment provenance, then
serializes to

  * one JSON document  — ``BENCH_obs.json``, the artifact
    ``python -m repro_torch.obs.check`` diffs, and
  * JSONL             — one object per line (header + one per benchmark),
    the append-friendly form for long-running collectors.

Schema ``repro.obs/bench-v2`` (validated by `validate_report`), the JAX
package's, so a report written by either package loads, validates and
gates in the other:

  {"schema": "repro.obs/bench-v2", "name": ..., "created_unix": ...,
   "env": {"torch": ..., "backend": "cuda"|"cpu", "device_count": ...,
           "device": <card name>|null},
   "spans": {...}, "counters": {...}, "flight": {...},
   "benchmarks": [
     {"name": str, "us_min": float, "us_mean": float, "us_std": float,
      "us_p50": float?, "us_p95": float?, "us_p99": float?, "us_max": float?,
      "derived": {str: str|float}, "trace": {...}|null}, ...]}

Span entries carry p50_s/p95_s/p99_s from the registry histograms;
benchmark records may carry ``us_p50/us_p95/us_p99`` tail-latency columns;
the header carries a ``flight`` recorder summary. ``load_report`` and
``validate_report`` also accept v1 documents (no percentile columns), so
the gate can diff a v2 run against a v1 baseline.

A copy of the JAX package's `repro.obs.report`; ``env`` names torch and
the card where JAX names jax, its backend and x64.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import List, Optional

import torch

__all__ = ["SCHEMA", "SCHEMA_V1", "RunReport", "load_report",
           "validate_report", "parse_derived"]

SCHEMA_V1 = "repro.obs/bench-v1"
SCHEMA = "repro.obs/bench-v2"
SCHEMAS = (SCHEMA, SCHEMA_V1)

#: optional per-record tail-latency columns (microseconds)
PCT_KEYS = ("us_p50", "us_p95", "us_p99", "us_max")


def parse_derived(derived: str) -> dict:
    """'k1=v1;k2=v2' (the CSV derived column) -> dict, numbers coerced."""
    out = {}
    for part in filter(None, derived.split(";")):
        if "=" not in part:
            out[part] = True
            continue
        k, v = part.split("=", 1)
        try:
            out[k] = float(v) if any(c in v for c in ".eE") or \
                v.lstrip("+-").isdigit() else v
        except ValueError:
            out[k] = v
    return out


def _env() -> dict:
    """Provenance of a report or a post-mortem bundle: the torch version,
    the backend the port runs on and the card."""
    cuda = torch.cuda.is_available()
    return {"torch": torch.__version__,
            "backend": "cuda" if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 0,
            "device": torch.cuda.get_device_name(0) if cuda else None}


@dataclasses.dataclass
class RunReport:
    """One benchmark run's structured output."""
    name: str = "bench"
    created_unix: float = dataclasses.field(default_factory=time.time)
    env: dict = dataclasses.field(default_factory=_env)
    benchmarks: List[dict] = dataclasses.field(default_factory=list)
    spans: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    flight: dict = dataclasses.field(default_factory=dict)

    def add(self, name: str, *, us_min: float, us_mean: float = None,
            us_std: float = None, us_p50: float = None, us_p95: float = None,
            us_p99: float = None, us_max: float = None,
            derived: Optional[dict] = None,
            trace: Optional[dict] = None) -> None:
        rec = {
            "name": name,
            "us_min": float(us_min),
            "us_mean": float(us_min if us_mean is None else us_mean),
            "us_std": float(0.0 if us_std is None else us_std),
            "derived": derived or {},
            "trace": trace,
        }
        for k, v in (("us_p50", us_p50), ("us_p95", us_p95),
                     ("us_p99", us_p99), ("us_max", us_max)):
            if v is not None:
                rec[k] = float(v)
        self.benchmarks.append(rec)

    def attach_registry(self, registry=None) -> None:
        """Snapshot the span/counter registry into the report."""
        if registry is None:
            from .spans import get_registry
            registry = get_registry()
        rep = registry.report()
        self.spans = rep["spans"]
        self.counters = rep["counters"]

    def attach_flight(self, recorder=None) -> None:
        """Snapshot the flight recorder's summary into the report."""
        if recorder is None:
            from .flight import get_flight
            recorder = get_flight()
        self.flight = recorder.summary()

    def to_dict(self) -> dict:
        return {"schema": SCHEMA, "name": self.name,
                "created_unix": self.created_unix, "env": self.env,
                "spans": self.spans, "counters": self.counters,
                "flight": self.flight, "benchmarks": self.benchmarks}

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1, allow_nan=False)
            f.write("\n")

    def write_jsonl(self, path: str) -> None:
        """Header line (everything but benchmarks) + one line per record."""
        head = self.to_dict()
        records = head.pop("benchmarks")
        head["kind"] = "header"
        with open(path, "w") as f:
            f.write(json.dumps(head, allow_nan=False) + "\n")
            for rec in records:
                f.write(json.dumps({"kind": "benchmark", **rec},
                                   allow_nan=False) + "\n")


def load_report(path: str) -> dict:
    """Load either serialized form back into a schema dict."""
    with open(path) as f:
        first = f.readline()
        doc = json.loads(first) if first.lstrip().startswith('{"') and \
            '"kind": "header"' in first else None
        if doc is not None:  # JSONL
            doc.pop("kind", None)
            doc["benchmarks"] = []
            for line in f:
                if not line.strip():
                    continue
                rec = json.loads(line)
                if rec.pop("kind", None) == "benchmark":
                    doc["benchmarks"].append(rec)
            return doc
        f.seek(0)
        return json.load(f)


def validate_report(doc: dict) -> List[str]:
    """Schema check; returns a list of problems (empty = valid)."""
    errs = []
    if not isinstance(doc, dict):
        return ["report is not an object"]
    if doc.get("schema") not in SCHEMAS:
        errs.append(f"schema not in {SCHEMAS!r}: {doc.get('schema')!r}")
    benches = doc.get("benchmarks")
    if not isinstance(benches, list):
        return errs + ["benchmarks is not a list"]
    for i, b in enumerate(benches):
        where = f"benchmarks[{i}]"
        if not isinstance(b, dict):
            errs.append(f"{where} is not an object")
            continue
        if not isinstance(b.get("name"), str) or not b.get("name"):
            errs.append(f"{where}.name missing")
        for k in ("us_min", "us_mean", "us_std"):
            if not isinstance(b.get(k), (int, float)):
                errs.append(f"{where}.{k} missing or non-numeric")
        for k in PCT_KEYS:  # v2 optional tail-latency columns
            if k in b and not isinstance(b[k], (int, float)):
                errs.append(f"{where}.{k} non-numeric")
        tr = b.get("trace")
        if tr is not None:
            if not isinstance(tr, dict):
                errs.append(f"{where}.trace is not an object")
            else:
                for k in ("engine", "iters", "linf_delta", "frontier"):
                    if k not in tr:
                        errs.append(f"{where}.trace.{k} missing")
    return errs
