"""Post-mortem bundles: everything needed to diagnose a dead stream.

When a stream fails, counters alone cannot reconstruct *what happened* —
the operator needs the ordered record. A bundle is one directory,
``postmortem-<stamp>/``, containing

  * ``bundle.json``  — reason, decoded health word (``describe_health``),
    the failing solve's TraceBuffer summary, the span/counter/histogram
    registry snapshot, the quarantine report, the last journal sequence
    number, SLO/flight summaries, and environment provenance;
  * ``flight.jsonl`` — the flight-recorder tail, one event per line
    (greppable without loading the JSON document).

``python -m repro_torch.obs.postmortem <dir>`` renders a bundle
human-readable; pass the parent directory to render the newest bundle
under it. Writing is best-effort by design: a post-mortem must never raise
through the failure path it is documenting (``write_bundle`` swallows
errors and returns None; the registry's ``postmortem.failed`` counts the
skip).

A copy of the JAX package's `repro.obs.postmortem`, with the same schema:
a bundle written by either package renders with the other's `render`.
The guarded `StreamSession` writes one when its escalation ladder runs out
of budget (``escalation_exhausted``) and when `restore` fails
(``restore_failed``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

from .report import _env

__all__ = ["SCHEMA", "write_bundle", "load_bundle", "render", "main"]

SCHEMA = "repro.obs/postmortem-v1"

#: flight events preserved in the bundle (the tail is what matters; the
#: ring itself may hold more)
TAIL = 256

_seq = 0  # per-process bundle counter (uniquifies same-second bundles)


def _stamp() -> str:
    global _seq
    _seq += 1
    return f"{time.strftime('%Y%m%dT%H%M%S')}-{os.getpid()}-{_seq:03d}"


def write_bundle(parent: str, *, reason: str, health: int = 0,
                 trace: Optional[dict] = None, registry=None, flight=None,
                 quarantine: Optional[dict] = None,
                 journal_seq: Optional[int] = None,
                 extra: Optional[dict] = None) -> Optional[str]:
    """Write one bundle directory under ``parent``; returns its path.

    ``registry`` / ``flight`` default to the process-wide instances. Never
    raises: on any failure the bundle is skipped and None returned (the
    stream's failure path must stay clear)."""
    from .flight import get_flight
    from .spans import get_registry
    try:
        from ..guard.health import describe_health, health_flags
        reg = registry if registry is not None else get_registry()
        fl = flight if flight is not None else get_flight()
        events = [e.as_dict() for e in fl.tail(TAIL)]
        doc = {
            "schema": SCHEMA,
            "reason": reason,
            "created_unix": time.time(),
            "env": _env(),
            "health": {"word": int(health),
                       "flags": list(health_flags(health)),
                       "describe": describe_health(health)},
            "journal_seq": journal_seq,
            "quarantine": quarantine,
            "trace": trace,
            "registry": reg.report(),
            "flight": {**fl.summary(), "tail": len(events)},
            "extra": extra or {},
        }
        path = os.path.join(parent, f"postmortem-{_stamp()}")
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "bundle.json"), "w") as f:
            json.dump(doc, f, indent=1, default=str)
            f.write("\n")
        with open(os.path.join(path, "flight.jsonl"), "w") as f:
            for e in events:
                f.write(json.dumps(e, default=str) + "\n")
        get_registry().inc("postmortem.bundles")
        get_flight().emit("postmortem.write", path=path, reason=reason)
        return path
    except Exception:
        try:
            get_registry().inc("postmortem.failed")
        except Exception:  # pragma: no cover
            pass
        return None


def _resolve(path: str) -> str:
    """Accept a bundle dir, or a parent holding ``postmortem-*`` dirs (the
    newest wins), or a direct ``bundle.json`` path."""
    if os.path.isfile(path):
        return os.path.dirname(path) or "."
    if os.path.isfile(os.path.join(path, "bundle.json")):
        return path
    cands = sorted(d for d in os.listdir(path)
                   if d.startswith("postmortem-")
                   and os.path.isfile(os.path.join(path, d, "bundle.json")))
    if not cands:
        raise FileNotFoundError(f"no post-mortem bundle under {path}")
    return os.path.join(path, cands[-1])


def load_bundle(path: str) -> dict:
    with open(os.path.join(_resolve(path), "bundle.json")) as f:
        return json.load(f)


def render(path: str, out=None) -> None:
    """Human-readable rendering of one bundle."""
    out = out or sys.stdout
    bdir = _resolve(path)
    doc = load_bundle(bdir)

    def w(line=""):
        print(line, file=out)

    w(f"post-mortem bundle: {bdir}")
    w(f"  schema   {doc.get('schema')}")
    w(f"  reason   {doc.get('reason')}")
    created = doc.get("created_unix")
    if created:
        w(f"  created  {time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(created))}")
    env = doc.get("env") or {}
    if env:
        w("  env      " + " ".join(f"{k}={v}" for k, v in env.items()))
    h = doc.get("health") or {}
    w(f"\nhealth: {h.get('describe', 'ok')} (word={h.get('word', 0)})")
    if doc.get("journal_seq") is not None:
        w(f"journal: last seq {doc['journal_seq']}")
    q = doc.get("quarantine")
    if q:
        w(f"quarantine: {q}")

    tr = doc.get("trace")
    if tr:
        w(f"\nfailing solve: engine={tr.get('engine')} "
          f"iters={tr.get('iters')} linf_final={tr.get('linf_final')} "
          f"frontier_peak={tr.get('frontier_peak')}")
        linf = [x for x in (tr.get("linf_delta") or []) if x is not None]
        if linf:
            head = ", ".join(f"{x:.3g}" for x in linf[:6])
            tail = f", ..., {linf[-1]:.3g}" if len(linf) > 6 else ""
            w(f"  linf series: [{head}{tail}]")

    reg = doc.get("registry") or {}
    counters = reg.get("counters") or {}
    if counters:
        w("\ncounters:")
        for k, v in counters.items():
            w(f"  {k:<40} {v}")
    spans = reg.get("spans") or {}
    if spans:
        w("\nspans (count / mean / p99 / max, ms):")
        for k, s in spans.items():
            p99 = s.get("p99_s")
            w(f"  {k:<32} {s['count']:>6}  {s['mean_s'] * 1e3:>9.3f}  "
              f"{(p99 * 1e3 if p99 is not None else float('nan')):>9.3f}  "
              f"{s['max_s'] * 1e3:>9.3f}")

    fl = doc.get("flight") or {}
    w(f"\nflight recorder: {fl.get('total', 0)} events "
      f"({fl.get('dropped', 0)} dropped, tail of {fl.get('tail', 0)} kept)")
    jl = os.path.join(bdir, "flight.jsonl")
    if os.path.isfile(jl):
        with open(jl) as f:
            events = [json.loads(line) for line in f if line.strip()]
        for e in events[-40:]:
            data = " ".join(f"{k}={v}" for k, v in (e.get("data") or {}).items())
            w(f"  [{e['seq']:>6}] {e['ts']:>12.6f} {e['kind']:<28} {data}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.postmortem",
        description="Render a post-mortem bundle human-readable.")
    p.add_argument("path", help="bundle dir, its parent, or bundle.json")
    args = p.parse_args(argv)
    try:
        render(args.path)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
