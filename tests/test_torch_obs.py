"""repro_torch.obs against the JAX package's repro.obs, on the CPU.

The same samples and documents (made from a numpy seed) go through both
packages. Bars:
  * `Histogram` (percentiles, merge, as_dict) and
    `percentiles_from_samples`: exactly equal — both are plain float math;
  * `check.compare` and `check.main`: the same verdicts, failures and exit
    codes on the same baseline/current pairs;
  * reports and post-mortem bundles written by either package load,
    validate and render in the other;
  * the flight ring, spans and the kill switch as `tests/test_obs2.py`
    holds JAX's, and each package's state its own.
"""
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
from repro.obs import check as jcheck  # noqa: E402
from repro.obs import postmortem as jpm  # noqa: E402
from repro.obs.report import SCHEMA_V1 as J_SCHEMA_V1  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.obs import check as tcheck  # noqa: E402
from repro_torch.obs import hist as thist  # noqa: E402
from repro_torch.obs import postmortem as tpm  # noqa: E402
from repro_torch.obs.report import SCHEMA, SCHEMA_V1, _env  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_obs():
    for pkg in (jobs, tobs):
        pkg.reset_registry()
        pkg.reset_flight()
        pkg.set_obs_enabled(True)
    yield
    for pkg in (jobs, tobs):
        pkg.reset_registry()
        pkg.reset_flight()
        pkg.set_obs_enabled(True)


def _samples(seed, k):
    """k latencies over seven decades (1e-7 .. 1 s), log-uniform, with a
    few exact zeros, bucket edges and garbage (NaN, negatives) mixed in."""
    rng = np.random.default_rng(seed)
    xs = list(10.0 ** rng.uniform(-7.5, 0.5, k))
    xs += [0.0, 1e-7, 1e-6, 1e4, 2e4, float("nan"), -1.0]
    rng.shuffle(xs)
    return xs


def test_public_names_match_the_jax_package():
    assert tobs.__all__ == jobs.__all__
    assert set(tcheck.__all__) == set(jcheck.__all__)
    assert set(tpm.__all__) == set(jpm.__all__)
    assert tpm.SCHEMA == jpm.SCHEMA and SCHEMA_V1 == J_SCHEMA_V1


# ---------------------------------------------------------------------------
# histograms: exactly the JAX package's numbers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,k,bpd", [(0, 1, 36), (1, 50, 36),
                                        (2, 1000, 36), (3, 400, 10)])
def test_histogram_matches_jax(seed, k, bpd):
    xs = _samples(seed, k)
    th = tobs.Histogram(buckets_per_decade=bpd)
    jh = jobs.Histogram(buckets_per_decade=bpd)
    for x in xs:
        th.add(x)
        jh.add(x)
    for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
        assert th.percentile(p) == jh.percentile(p)
    assert th.as_dict() == jh.as_dict()
    assert (th.count, th.total, th.min, th.max) == (jh.count, jh.total,
                                                    jh.min, jh.max)
    # merge: the same sums and percentiles
    xs2 = _samples(seed + 100, k)
    th2 = tobs.Histogram(buckets_per_decade=bpd)
    jh2 = jobs.Histogram(buckets_per_decade=bpd)
    for x in xs2:
        th2.add(x)
        jh2.add(x)
    th.merge(th2)
    jh.merge(jh2)
    assert th.as_dict() == jh.as_dict()
    assert th.total == jh.total


def test_histogram_empty_garbage_and_layouts():
    h = tobs.Histogram()
    assert h.percentile(99) is None and h.as_dict() == {"count": 0}
    h.add(float("nan"))
    h.add(-1.0)
    assert h.count == 0
    with pytest.raises(ValueError):
        h.merge(tobs.Histogram(buckets_per_decade=10))
    with pytest.raises(ValueError):
        tobs.Histogram(min_value=1.0, max_value=1.0)


@pytest.mark.parametrize("k", [0, 1, 2, 7, 100, 1001])
def test_percentiles_from_samples_match_jax(k):
    xs = [x for x in _samples(k, k) if x == x][:k]
    assert tobs.percentiles_from_samples(xs) == \
        jobs.percentiles_from_samples(xs)


# ---------------------------------------------------------------------------
# the flight recorder and the kill switch
# ---------------------------------------------------------------------------

def test_flight_ring_wraparound():
    fl = tobs.FlightRecorder(capacity=8)
    for i in range(20):
        fl.emit("tick", i=i)
    assert len(fl) == 8 and fl.total == 20 and fl.dropped == 12
    evs = fl.events()
    assert [e.seq for e in evs] == list(range(12, 20))
    assert [e.data["i"] for e in evs] == list(range(12, 20))
    assert [e.seq for e in fl.tail(3)] == [17, 18, 19]
    assert fl.summary() == {"total": 20, "dropped": 12, "capacity": 8,
                            "by_kind": {"tick": 20}}
    with pytest.raises(ValueError):
        tobs.FlightRecorder(capacity=0)


def test_flight_concurrent_writers():
    """Wraparound under concurrent emits: no lost counts, no duplicate or
    out-of-order seq numbers in the surviving window."""
    fl = tobs.FlightRecorder(capacity=64)
    threads, per = 8, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda t=t: [
            fl.emit(f"kind{t}", i=i) for i in range(per)])
            for t in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in ts)
    assert fl.total == threads * per
    assert fl.dropped == threads * per - 64
    seqs = [e.seq for e in fl.events()]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs) == 64
    assert sum(fl.summary()["by_kind"].values()) == threads * per


def test_kill_switch_is_the_port_s_own():
    """Off in the port: no emits, no span histograms (spans still time);
    the JAX package's switch stays on."""
    tobs.set_obs_enabled(False)
    assert not tobs.obs_enabled() and jobs.obs_enabled()
    tobs.get_flight().emit("tick")
    jobs.get_flight().emit("tick")
    assert tobs.get_flight().total == 0 and jobs.get_flight().total == 1
    reg = tobs.get_registry()
    with reg.span("toggle.span"):
        pass
    assert reg.span_hist("toggle.span") is None
    assert reg.span_stats("toggle.span").count == 1
    reg.record_hist("toggle.rec", 1.0)
    assert reg.span_hist("toggle.rec") is None
    tobs.set_obs_enabled(True)
    tobs.get_flight().emit("tick")
    assert tobs.get_flight().total == 1


def test_kill_switch_reads_the_jax_variable_at_import():
    code = ("import repro_torch.obs as o; "
            "print(o.obs_enabled())")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "REPRO_OBS_OFF": "1"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def test_registries_are_separate():
    tobs.get_registry().inc("only.port", 2)
    assert jobs.get_registry().counter("only.port") == 0
    assert tobs.get_registry().counter("only.port") == 2


@pytest.mark.parametrize("annotate", [False, True])
def test_spans_carry_percentiles(annotate):
    reg = tobs.Registry()
    for _ in range(10):
        with reg.span("pct.work", annotate=annotate):
            pass
    reg.inc("c", 3)
    rep = reg.report()
    s = rep["spans"]["pct.work"]
    assert s["count"] == 10 and rep["counters"] == {"c": 3}
    for k in ("p50_s", "p95_s", "p99_s"):
        assert isinstance(s[k], float) and s[k] >= 0.0
    assert s["p50_s"] <= s["p99_s"] <= s["max_s"] * 1.07
    assert s["min_s"] <= s["mean_s"] <= s["max_s"]
    reg.reset()
    assert reg.report() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("annotate", [False, True])
def test_spans_still_record_when_the_body_raises(annotate):
    """An annotated span nested in another: a raise inside closes both
    ranges (record_function's exit in `finally`) and records both spans;
    the profiler sees a balanced pair."""
    reg = tobs.get_registry()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pytest.raises(RuntimeError):
            with reg.span("outer.solve", annotate=annotate):
                with tobs.Span("inner.solve", annotate=annotate):
                    raise RuntimeError("boom")
        with reg.span("after", annotate=annotate):
            pass
    for name in ("outer.solve", "inner.solve", "after"):
        assert reg.span_stats(name).count == 1
        assert reg.span_hist(name).count == 1
    names = [e.name for e in prof.events()]
    for name in ("outer.solve", "inner.solve", "after"):
        assert (name in names) == annotate


# ---------------------------------------------------------------------------
# reports: either package's documents load and validate in the other
# ---------------------------------------------------------------------------

def _fill(pkg, rep):
    pkg.get_registry().inc("rows", 7)
    with pkg.get_registry().span("work"):
        pass
    pkg.get_flight().emit("roundtrip", n=1)
    rep.add("x/one", us_min=10.0, us_mean=12.0, us_std=1.0, us_p50=11.0,
            us_p95=14.0, us_p99=15.0, us_max=16.0,
            derived={"iters": 12.0}, trace={"engine": "dfp", "iters": 3,
                                             "linf_delta": [1e-3],
                                             "frontier": [5]})
    rep.add("x/two", us_min=5.0)
    rep.attach_registry()
    rep.attach_flight()


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("form", ["json", "jsonl"])
def test_reports_load_across_packages(tmp_path, writer, form):
    pkg = tobs if writer == "torch" else jobs
    rep = pkg.RunReport(name="t")
    _fill(pkg, rep)
    path = str(tmp_path / f"r.{form}")
    getattr(rep, f"write_{form}")(path)
    for reader in (tobs, jobs):
        doc = reader.load_report(path)
        assert doc["schema"] == SCHEMA
        assert reader.validate_report(doc) == []
        assert doc["counters"] == {"rows": 7}
        assert doc["flight"]["by_kind"] == {"roundtrip": 1}
        assert [b["name"] for b in doc["benchmarks"]] == ["x/one", "x/two"]
        one = doc["benchmarks"][0]
        assert one["us_p99"] == 15.0 and one["trace"]["engine"] == "dfp"
        assert "us_p99" not in doc["benchmarks"][1]
    assert tobs.load_report(path) == jobs.load_report(path)


def test_report_env_names_torch_and_the_device():
    env = tobs.RunReport().env
    assert env == _env()
    assert set(env) == {"torch", "backend", "device_count", "device"}
    assert "jax" not in env and env["torch"] == torch.__version__
    if not torch.cuda.is_available():
        assert env["backend"] == "cpu" and env["device"] is None


@pytest.mark.parametrize("doc", [
    {"schema": "nope", "benchmarks": []},
    {"schema": SCHEMA, "benchmarks": "x"},
    {"schema": SCHEMA, "benchmarks": [{"name": "", "us_min": "a"}]},
    {"schema": SCHEMA, "benchmarks": [
        {"name": "a", "us_min": 1, "us_mean": 1, "us_std": 0,
         "us_p99": "slow", "trace": {"engine": "x"}}]},
    {"schema": SCHEMA_V1, "benchmarks": [
        {"name": "a", "us_min": 1.0, "us_mean": 1.0, "us_std": 0.0}]},
    [],
])
def test_validate_report_matches_jax(doc):
    assert tobs.validate_report(doc) == jobs.validate_report(doc)


@pytest.mark.parametrize("s", ["", "a=1;b=2.5;c=x;flag", "k=1e-3;n=-4"])
def test_parse_derived_matches_jax(s):
    from repro.obs.report import parse_derived as jparse
    from repro_torch.obs.report import parse_derived
    assert parse_derived(s) == jparse(s)


# ---------------------------------------------------------------------------
# the gate: the same verdicts and exit codes as JAX's
# ---------------------------------------------------------------------------

def _doc(rows, schema=SCHEMA):
    return {"schema": schema, "name": "t", "created_unix": 0.0, "env": {},
            "spans": {}, "counters": {}, "flight": {},
            "benchmarks": [{"name": n, "us_min": m, "us_mean": m,
                            "us_std": 0.0, **extra} for n, m, extra in rows]}


# (name, baseline rows, current rows, baseline schema)
PAIRS = [
    ("clean", [("s/a", 100.0, {}), ("s/b", 200.0, {})],
     [("s/a", 101.0, {}), ("s/b", 190.0, {})], SCHEMA),
    ("mean_regression", [("s/a", 100.0, {})], [("s/a", 150.0, {})], SCHEMA),
    ("p99_only_regression", [("s/a", 100.0, {"us_p99": 200.0})],
     [("s/a", 100.0, {"us_p99": 400.0})], SCHEMA),
    ("p99_held", [("s/a", 100.0, {"us_p99": 200.0})],
     [("s/a", 100.0, {"us_p99": 200.0})], SCHEMA),
    ("v1_baseline", [("s/a", 100.0, {})],
     [("s/a", 100.0, {"us_p99": 9999.0})], SCHEMA_V1),
    ("missing_and_new", [("s/a", 100.0, {}), ("s/gone", 100.0, {})],
     [("s/a", 100.0, {}), ("s/new", 5.0, {})], SCHEMA),
    ("below_floor", [("s/tiny", 10.0, {})], [("s/tiny", 40.0, {})], SCHEMA),
]


@pytest.mark.parametrize("name,base,cur,schema", PAIRS,
                         ids=[p[0] for p in PAIRS])
@pytest.mark.parametrize("threshold", [0.1, 0.5])
def test_compare_matches_jax(name, base, cur, schema, threshold):
    b, c = _doc(base, schema), _doc(cur)
    for only in ((), ("s/a",)):
        got = tcheck.compare(c, b, threshold, 50.0, only=only)
        want = jcheck.compare(c, b, threshold, 50.0, only=only)
        assert got == want


@pytest.mark.parametrize("name,base,cur,schema", PAIRS,
                         ids=[p[0] for p in PAIRS])
def test_check_main_matches_jax(tmp_path, capsys, name, base, cur, schema):
    bp, cp = tmp_path / "base.json", tmp_path / "cur.json"
    bp.write_text(json.dumps(_doc(base, schema)))
    cp.write_text(json.dumps(_doc(cur)))
    rcs = []
    for extra in ([], ["--json"], ["--threshold", "0.6"]):
        argv = [str(cp), str(bp)] + extra
        rc_t = tcheck.main(argv)
        out_t = capsys.readouterr().out
        rc_j = jcheck.main(argv)
        out_j = capsys.readouterr().out
        assert rc_t == rc_j
        if extra == ["--json"]:
            assert json.loads(out_t) == json.loads(out_j)
        rcs.append(rc_t)
    failing = name in ("mean_regression", "p99_only_regression",
                       "missing_and_new")
    assert rcs[:2] == [int(failing)] * 2


def test_check_errors_and_seed_match_jax(tmp_path, capsys, monkeypatch):
    cur = tmp_path / "cur.json"
    cur.write_text(json.dumps(_doc([("s/a", 100.0, {})])))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "nope", "benchmarks": []}))
    cases = [
        [str(tmp_path / "absent.json"), str(cur)],          # 2: IO
        [str(bad), str(cur)],                               # 1: schema
        [str(cur), str(tmp_path / "absent.json")],          # 0: bootstrap
        [str(cur), str(tmp_path / "absent.json"), "--strict"],  # 2
        [str(cur), "--against", "seed", "--json"],          # missing benches
    ]
    # the committed seed, found from each package's own file
    assert tcheck._seed_path() == jcheck._seed_path()
    assert tcheck._seed_path().is_file()
    for argv in cases:
        rc_t = tcheck.main(argv)
        capsys.readouterr()
        assert rc_t == jcheck.main(argv), argv
        capsys.readouterr()
    monkeypatch.setenv("REPRO_BENCH_SEED", str(cur))
    assert tcheck._seed_path() == cur
    assert tcheck.main([str(cur), "--against", "seed"]) == 0
    capsys.readouterr()
    with pytest.raises(SystemExit):
        tcheck.main([str(cur)])      # neither BASELINE nor --against
    capsys.readouterr()


def test_check_cli_subprocess(tmp_path):
    bp, cp = tmp_path / "base.json", tmp_path / "cur.json"
    bp.write_text(json.dumps(_doc([("s/a", 100.0, {})])))
    cp.write_text(json.dumps(_doc([("s/a", 300.0, {})])))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.check", str(cp), str(bp),
         "--json"], capture_output=True, text=True, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")}, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert json.loads(proc.stdout)["verdict"] == "fail"


# ---------------------------------------------------------------------------
# post-mortem bundles: written by either package, rendered by both
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_bundles_render_across_packages(tmp_path, writer):
    import io
    pkg = tobs if writer == "torch" else jobs
    pkg.get_registry().inc("some.counter", 3)
    with pkg.get_registry().span("session.solve"):
        pass
    pkg.get_flight().emit("session.engine", seq=1, engine="dense", size=9)
    path = pkg.write_bundle(
        str(tmp_path), reason="manual", health=1 | 2,
        trace={"engine": "dfp", "iters": 3, "linf_final": 1e-12,
               "frontier_peak": 40, "linf_delta": [1e-3, 1e-6, 1e-12]},
        quarantine={"size": 4}, journal_seq=17)
    assert path is not None
    for mod in (tpm, jpm):
        doc = mod.load_bundle(str(tmp_path))     # newest under the parent
        assert doc["schema"] == tpm.SCHEMA and doc["reason"] == "manual"
        assert doc["health"]["describe"] == "max_iter+nonfinite"
        assert doc["health"]["flags"] == ["max_iter", "nonfinite"]
        assert doc["journal_seq"] == 17 and doc["quarantine"] == {"size": 4}
        assert doc["registry"]["counters"]["some.counter"] == 3
        buf = io.StringIO()
        mod.render(path, out=buf)
        text = buf.getvalue()
        for want in ("manual", "max_iter+nonfinite", "some.counter",
                     "session.solve", "session.engine", "engine=dfp"):
            assert want in text
    if writer == "torch":
        env = tpm.load_bundle(path)["env"]
        assert env == _env()
        assert tobs.get_registry().counter("postmortem.bundles") == 1
        assert [e.kind for e in tobs.get_flight().events()][-1] == \
            "postmortem.write"


def test_write_bundle_never_raises(tmp_path):
    assert tobs.write_bundle(str(tmp_path / "nope\0bad"), reason="x") is None
    assert tobs.get_registry().counter("postmortem.failed") == 1
    blocker = tmp_path / "a_file"
    blocker.write_text("")
    assert tobs.write_bundle(str(blocker), reason="x") is None
    assert tobs.get_registry().counter("postmortem.failed") == 2
    assert jobs.get_registry().counter("postmortem.failed") == 0


def test_postmortem_cli(tmp_path, capsys):
    path = tobs.write_bundle(str(tmp_path), reason="cli")
    assert tpm.main([str(tmp_path)]) == 0
    assert "cli" in capsys.readouterr().out
    assert tpm.main([str(tmp_path / "empty_nothing")]) == 2
    capsys.readouterr()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.postmortem",
         os.path.join(path, "bundle.json")], capture_output=True, text=True,
        cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "reason   cli" in proc.stdout


# ---------------------------------------------------------------------------
# the profiler capture wrappers (torch.profiler on the CPU here)
# ---------------------------------------------------------------------------

def test_profiler_capture_writes_one_chrome_trace(tmp_path):
    reg = tobs.Registry()
    assert thist.start_profiler(str(tmp_path))
    assert not thist.start_profiler(str(tmp_path / "second"))  # one live
    with reg.span("captured.range", annotate=True):
        torch.ones(8).sum()
    assert thist.stop_profiler()
    assert not thist.stop_profiler()                          # none live
    (trace,) = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert "captured.range" in names
    assert not (tmp_path / "second").exists()


def test_profiler_capture_is_unavailable_under_a_live_profile(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert not thist.start_profiler(str(tmp_path))
    assert thist._LIVE is None and not list(tmp_path.iterdir())
