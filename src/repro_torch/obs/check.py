"""Regression gate: diff two ``BENCH_obs.json`` reports, fail on slowdowns.

    python -m repro_torch.obs.check CURRENT.json BASELINE.json [--threshold 0.10]
    python -m repro_torch.obs.check CURRENT.json --against seed [--threshold ...]

Exit codes: 0 clean, 1 regression (or schema failure / missing benchmark),
2 usage / IO error.

A benchmark regresses when ``us_mean`` grows by more than ``--threshold``
(fraction; default 0.10 = +10%) over the baseline, subject to a
``--min-us`` floor (default 50µs: sub-floor benches are timer noise).
Schema-v2 reports additionally gate ``us_p99`` where both sides carry it —
a tail regression fails even when the mean holds. Benchmarks present in
the baseline but absent from the current report fail the gate too — a
silently dropped bench is how regressions hide.

``--json`` replaces the human table with one machine-readable verdict
document ({"verdict", "failures", "benchmarks": [{name, status, ratio}]})
so CI can annotate a change without parsing log text; exit codes unchanged.

``--against seed`` resolves the committed machine-reference baseline
(``benchmarks/seed/BENCH_obs_seed.json``, override via ``$REPRO_BENCH_SEED``).
Cross-machine timing is not comparable at 10%, so pair ``--against seed``
with a catastrophic-only threshold; the strict default is for same-machine
before/after runs. A missing seed baseline passes with a warning unless
``--strict`` (first run bootstraps).

A copy of the JAX package's `repro.obs.check`: the same verdicts and exit
codes on the same reports, from either package.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from .report import load_report, validate_report

__all__ = ["main", "compare"]


def _seed_path() -> Path:
    env = os.environ.get("REPRO_BENCH_SEED")
    if env:
        return Path(env)
    # src/repro_torch/obs/check.py -> repo root is three levels above src/
    root = Path(__file__).resolve().parents[3]
    return root / "benchmarks" / "seed" / "BENCH_obs_seed.json"


def compare(current: dict, baseline: dict, threshold: float,
            min_us: float, only=()) -> tuple:
    """Returns (failures, lines, results): failure strings, a human diff
    table, and per-bench machine-readable verdicts (``--json``).

    ``only`` (name prefixes) restricts the gate to matching benchmarks on
    both sides — for partial runs that exercised a subset of the suite
    (e.g. test.sh gating just the frontier rows).

    Two gated metrics per benchmark: ``us_mean`` always, and ``us_p99``
    when BOTH reports carry it (schema v2) — a tail regression fails the
    gate even when the mean holds (the paper's claims are distributions,
    not means)."""
    failures, lines, results = [], [], []
    keep = ((lambda n: any(n.startswith(p) for p in only)) if only
            else (lambda n: True))
    cur = {b["name"]: b for b in current.get("benchmarks", [])
           if keep(b["name"])}
    base = {b["name"]: b for b in baseline.get("benchmarks", [])
            if keep(b["name"])}
    for name, b in sorted(base.items()):
        c = cur.get(name)
        if c is None:
            failures.append(f"missing benchmark: {name}")
            lines.append(f"  {name:<48} MISSING from current report")
            results.append({"name": name, "status": "missing"})
            continue
        b_us, c_us = float(b["us_mean"]), float(c["us_mean"])
        res = {"name": name, "status": "ok", "base_us": b_us, "cur_us": c_us,
               "ratio": c_us / max(b_us, 1e-9)}
        if b_us < min_us and c_us < min_us:
            lines.append(f"  {name:<48} {b_us:>10.1f} -> {c_us:>10.1f} us"
                         f"  (below {min_us:g}us floor, skipped)")
            res["status"] = "skipped"
            results.append(res)
            continue
        rel = (c_us - b_us) / max(b_us, 1e-9)
        mark = ""
        if rel > threshold:
            mark = "  REGRESSION"
            res["status"] = "regression"
            failures.append(
                f"{name}: {b_us:.1f}us -> {c_us:.1f}us (+{rel * 100:.1f}% "
                f"> {threshold * 100:.0f}%)")
        lines.append(f"  {name:<48} {b_us:>10.1f} -> {c_us:>10.1f} us"
                     f"  ({rel * +100:+.1f}%){mark}")
        if ("us_p99" in b and "us_p99" in c
                and float(b["us_p99"]) >= min_us):
            bp, cp = float(b["us_p99"]), float(c["us_p99"])
            relp = (cp - bp) / max(bp, 1e-9)
            res.update(base_p99_us=bp, cur_p99_us=cp,
                       p99_ratio=cp / max(bp, 1e-9))
            markp = ""
            if relp > threshold:
                markp = "  REGRESSION"
                res["status"] = "regression"
                failures.append(
                    f"{name}: p99 {bp:.1f}us -> {cp:.1f}us "
                    f"(+{relp * 100:.1f}% > {threshold * 100:.0f}%)")
            lines.append(f"  {name + ' (p99)':<48} {bp:>10.1f} -> "
                         f"{cp:>10.1f} us  ({relp * +100:+.1f}%){markp}")
        results.append(res)
    extra = sorted(set(cur) - set(base))
    for name in extra:
        lines.append(f"  {name:<48} (new, no baseline)")
        results.append({"name": name, "status": "new",
                        "cur_us": float(cur[name]["us_mean"])})
    return failures, lines, results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.check",
        description="Diff two BENCH_obs.json reports; fail on regressions.")
    p.add_argument("current", help="current BENCH_obs.json")
    p.add_argument("baseline", nargs="?", help="baseline BENCH_obs.json")
    p.add_argument("--against", choices=["seed"],
                   help="use the committed seed baseline")
    p.add_argument("--threshold", type=float, default=0.10,
                   help="max allowed us_mean growth fraction (default 0.10)")
    p.add_argument("--min-us", type=float, default=50.0,
                   help="ignore benches faster than this (timer noise)")
    p.add_argument("--strict", action="store_true",
                   help="fail (not warn) when the baseline file is missing")
    p.add_argument("--only", action="append", default=[],
                   help="gate only benchmarks whose name starts with this "
                        "prefix (repeatable); default: all")
    p.add_argument("--json", action="store_true",
                   help="print a machine-readable verdict document to "
                        "stdout instead of the table (exit codes unchanged)")
    args = p.parse_args(argv)

    def verdict(status, *, failures=(), results=(), error=None):
        """Emit the --json document (stdout); human output stays as-is."""
        if args.json:
            doc = {"verdict": status, "current": args.current,
                   "baseline": str(base_path) if base_path else None,
                   "threshold": args.threshold,
                   "failures": list(failures), "benchmarks": list(results)}
            if error is not None:
                doc["error"] = error
            print(json.dumps(doc, indent=1))

    base_path = None
    if (args.baseline is None) == (args.against is None):
        p.error("give exactly one of BASELINE or --against seed")
    base_path = Path(args.baseline) if args.baseline else _seed_path()

    try:
        current = load_report(args.current)
    except (OSError, ValueError) as e:
        verdict("error", error=f"cannot read current report: {e}")
        print(f"error: cannot read current report: {e}", file=sys.stderr)
        return 2
    errs = validate_report(current)
    if errs:
        verdict("fail", failures=[f"schema: {e}" for e in errs])
        print("current report fails schema validation:", file=sys.stderr)
        for e in errs:
            print(f"  {e}", file=sys.stderr)
        return 1

    if not base_path.exists():
        msg = f"baseline not found: {base_path}"
        if args.strict:
            verdict("error", error=msg)
            print(f"error: {msg}", file=sys.stderr)
            return 2
        verdict("pass", failures=[], results=[])
        print(f"warning: {msg} — nothing to gate against (bootstrap run)")
        return 0
    try:
        baseline = load_report(str(base_path))
    except (OSError, ValueError) as e:
        verdict("error", error=f"cannot read baseline: {e}")
        print(f"error: cannot read baseline: {e}", file=sys.stderr)
        return 2

    failures, lines, results = compare(current, baseline, args.threshold,
                                       args.min_us, only=tuple(args.only))
    if args.json:
        verdict("fail" if failures else "pass", failures=failures,
                results=results)
        return 1 if failures else 0
    print(f"repro_torch.obs.check: {args.current} vs {base_path} "
          f"(threshold +{args.threshold * 100:.0f}%)")
    for ln in lines:
        print(ln)
    if failures:
        print(f"\nFAIL: {len(failures)} regression(s)")
        for f in failures:
            print(f"  {f}")
        return 1
    print("\nOK: no regressions")
    return 0


if __name__ == "__main__":
    sys.exit(main())
