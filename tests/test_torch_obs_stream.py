"""The port's instrumented streaming path against the JAX package's, on
the CPU.

The same graph and the same deltas (numpy, from a seed) go through
`repro.stream.StreamSession` and `repro_torch.stream.StreamSession(
device="cpu")`, each package's registry and flight recorder reset before.
Bars:
  * the counters `snapshot.*`, `session.*`, `frontier.*` (the fstats and
    `caps_growth`) and `layout.*` exactly equal, but for the names that
    differ by design (`DESIGN_DIFFERENCES`);
  * the flight events' kinds and their fields other than times, equal and
    in order;
  * one `solve.<engine>` span per driver call, under JAX's names;
  * `guard.quarantined*` equal after the same quarantining validation;
  * the SLO and capture state machine as JAX's, with the profiler
    wrappers monkeypatched as in `tests/test_obs2.py`, then one real
    `torch.profiler` capture.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.stream as js  # noqa: E402
import repro.stream.session as jsession  # noqa: E402
from repro.guard.validate import validate_batch as j_validate  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
import repro_torch.stream.session as tsession  # noqa: E402
from repro_torch.guard import validate_batch  # noqa: E402

CAPS = dict(d_p=8, tile=32)
N, M = 3000, 30000

#: counters whose meaning differs between the packages by design:
#: the JAX package counts scatters while `jit` traces (once per build,
#: rows padded to a power of two), the port per call; `frontier.retrace`
#: counts JAX re-traces, and the port has no `jit`
DESIGN_DIFFERENCES = ("kernels.stream_scatter.calls",
                      "kernels.stream_scatter.rows", "frontier.retrace")
#: flight fields that are times
TIMING_FIELDS = ("solve_us",)


def _reset():
    for pkg in (jobs, tobs):
        pkg.reset_registry()
        pkg.reset_flight()
        pkg.set_obs_enabled(True)


@pytest.fixture(autouse=True)
def _fresh_obs():
    _reset()
    yield
    _reset()


def _jbatch(b):
    return jc.BatchUpdate(del_src=b.del_src, del_dst=b.del_dst,
                          ins_src=b.ins_src, ins_dst=b.ins_dst)


def _empty():
    z = np.zeros(0, np.int32)
    return tc.BatchUpdate(z, z, z, z)


def _compared(counters):
    return {k: v for k, v in counters.items()
            if k not in DESIGN_DIFFERENCES
            and k.split(".")[0] in ("snapshot", "session", "frontier",
                                    "layout", "guard", "slo")}


def _events(pkg):
    return [(e.kind, {k: v for k, v in e.data.items()
                      if k not in TIMING_FIELDS})
            for e in pkg.get_flight().events()]


def _stream_batches(g):
    """an insert-only pair of edges (compact engine, small frontier caps),
    churn (dense engine; the caps grow), an empty batch (noop), a batch
    past the rebuild threshold, then churn on the rebuilt snapshot;
    `recompute` runs after the fourth."""
    small = tc.random_batch(g, 2 / g.m, insert_frac=1.0, seed=103)
    return [small, tc.random_batch(g, 2e-3, seed=101),
            tc.random_batch(g, 2e-3, seed=102), _empty(), "recompute",
            tc.random_batch(g, 0.06, seed=104),
            tc.random_batch(g, 2e-3, seed=105)]


@pytest.fixture(scope="module")
def streams():
    """Both sessions over the same deltas: each package's counters, flight
    events, histories and span counts, taken before the next test resets
    them."""
    _reset()
    g = tc.powerlaw_graph(N, M, seed=0)
    gj = jc.powerlaw_graph(N, M, seed=0)
    out = {}
    for name, pkg, sess in (
            ("torch", tobs, lambda: ts.StreamSession(g, device="cpu",
                                                     **CAPS)),
            ("jax", jobs, lambda: js.StreamSession(gj, **CAPS))):
        s = sess()
        for b in _stream_batches(g):
            if isinstance(b, str):
                s.recompute()
            else:
                s.apply(b if name == "torch" else _jbatch(b))
        rep = pkg.get_registry().report()
        out[name] = dict(counters=rep["counters"], spans=rep["spans"],
                         events=_events(pkg), history=list(s.history),
                         ranks=np.asarray(s.ranks), session=s)
    _reset()
    return out


def test_stream_counters_equal_jax(streams):
    t, j = streams["torch"]["counters"], streams["jax"]["counters"]
    # the run exercised what it claims to: both engines, a noop, a
    # recompute, one rebuild, growth of the frontier caps, in-place batches
    for name in ("session.engine.dense", "session.engine.compact",
                 "session.engine.noop", "session.recompute",
                 "snapshot.rebuild.batch_too_large",
                 "snapshot.inplace_batches", "frontier.caps_growth",
                 "frontier.iters",
                 "frontier.compact_iters", "layout.builds",
                 "snapshot.rows_touched", "snapshot.migrations"):
        assert t.get(name, 0) > 0, name
    assert _compared(t) == _compared(j)
    # the names the port leaves out are exactly the ones named
    assert set(j) - set(t) <= set(DESIGN_DIFFERENCES)
    assert set(t) - set(j) <= set(DESIGN_DIFFERENCES)
    assert t["kernels.stream_scatter.calls"] > 0


def test_stream_flight_sequence_equals_jax(streams):
    t, j = streams["torch"]["events"], streams["jax"]["events"]
    kinds = [k for k, _ in t]
    for kind in ("session.engine", "session.batch", "snapshot.rebuild"):
        assert kind in kinds
    assert t == j


def test_stream_spans_and_history_agree(streams):
    """The session's spans count what its history records, and
    `session.solve` times the same work as `BatchStats.solve_s`."""
    for side in ("torch", "jax"):
        sp, hist = streams[side]["spans"], streams[side]["history"]
        solved = [h for h in hist if h.engine in ("dense", "compact")]
        applied = [h for h in hist if h.engine != "recompute"]
        assert sp["session.solve"]["count"] == len(solved)
        assert sp["session.ingest"]["count"] == len(applied)
        assert sp["snapshot.device_refresh"]["count"] == sum(
            not h.snapshot.rebuilt for h in solved)
        assert sp["snapshot.rebuild"]["count"] == sum(
            h.snapshot.rebuilt for h in solved)
    sp = streams["torch"]["spans"]
    solve = [h.solve_s for h in streams["torch"]["history"]
             if h.engine in ("dense", "compact")]
    # the span encloses solve_s's clock reads and nothing more
    assert max(solve) <= sp["session.solve"]["max_s"] <= max(solve) + 1e-3
    pct = streams["torch"]["session"].solve_percentiles()
    assert pct["count"] == len(solve) and pct["max_s"] == max(solve)
    assert streams["torch"]["counters"]["snapshot.rows_touched"] == sum(
        h.snapshot.rows_touched for h in streams["torch"]["history"])


def test_stream_ranks_still_track_jax(streams):
    assert tc.l1_error(torch.from_numpy(streams["torch"]["ranks"]),
                       streams["jax"]["ranks"]) <= 1e-8


# ---------------------------------------------------------------------------
# one solve.<engine> span per driver call, under JAX's names
# ---------------------------------------------------------------------------

class Case:
    """One graph and one batch, staged in both packages."""

    def __init__(self, seed=0):
        g = tc.powerlaw_graph(300, 2500, seed=seed)
        gj = jc.powerlaw_graph(300, 2500, seed=seed)
        self.n = g.n
        self.dg = tc.device_graph(g, **CAPS, device="cpu")
        self.dg_j = jc.device_graph(gj, **CAPS)
        r, _ = jc.static_pagerank(self.dg_j, jc.init_ranks(g.n))
        self.r_prev = np.asarray(r)
        b = tc.random_batch(g, 0.02, seed=seed + 1)
        g2, g2j = tc.apply_batch(g, b), jc.apply_batch(gj, _jbatch(b))
        self.dg2 = tc.device_graph(g2, **CAPS, device="cpu")
        self.dg2_j = jc.device_graph(g2j, **CAPS)
        self.fwd = tc.forward_device_graph(g2, **CAPS, device="cpu")
        self.fwd_j = jc.forward_device_graph(g2j, **CAPS)
        self.db = tc.batch_to_device(b, g.n, device="cpu")
        self.db_j = jc.batch_to_device(_jbatch(b), g.n)
        self.est = b.size * 4


@pytest.fixture(scope="module")
def case():
    return Case()


def _call(pkg, case, engine, caps):
    torch_side = pkg is tc
    dg, dg_prev = ((case.dg2, case.dg) if torch_side
                   else (case.dg2_j, case.dg_j))
    fwd = case.fwd if torch_side else case.fwd_j
    db = case.db if torch_side else case.db_j
    r = case.r_prev if torch_side else jnp.asarray(case.r_prev)
    if engine == "static":
        return pkg.static_pagerank(dg, pkg.init_ranks(case.n)
                                   if not torch_side else
                                   pkg.init_ranks(case.n, device="cpu"))
    if engine == "nd":
        return pkg.nd_pagerank(dg, r)
    if engine == "dt":
        return pkg.dt_pagerank(dg, dg_prev, r, db)
    if engine.endswith("_compact"):
        fn = getattr(pkg, f"{engine[:-8]}_pagerank_compact")
        return fn(dg, fwd, r, db)
    fc = pkg.caps_for(dg, case.est) if caps else None
    return getattr(pkg, f"{engine}_pagerank")(dg, r, db, fwd=fwd,
                                              frontier_caps=fc)


ENGINES = ["static", "nd", "dt", "df", "dfp", "df_compact", "dfp_compact"]


@pytest.mark.parametrize("engine", ENGINES)
def test_one_solve_span_per_driver_call(case, engine):
    for pkg, obs in ((tc, tobs), (jc, jobs)):
        _call(pkg, case, engine, caps=False)
        spans = {k: v["count"] for k, v in
                 obs.get_registry().report()["spans"].items()
                 if k.startswith("solve.")}
        assert spans == {f"solve.{engine}": 1}, (pkg.__name__, spans)
    for _ in range(2):
        _call(tc, case, engine, caps=False)
    assert tobs.get_registry().span_stats(f"solve.{engine}").count == 3


@pytest.mark.parametrize("engine", ["df", "dfp"])
def test_frontier_stats_equal_jax(case, engine):
    """A compacted dense solve folds the same fstats into `frontier.*`."""
    _call(tc, case, engine, caps=True)
    _call(jc, case, engine, caps=True)
    t = tobs.get_registry().report()["counters"]
    j = jobs.get_registry().report()["counters"]
    assert t["frontier.iters"] > 0 and "frontier.active_rows.b0" in t
    assert {k: v for k, v in t.items() if k.startswith("frontier.")} == \
        {k: v for k, v in j.items()
         if k.startswith("frontier.") and k not in DESIGN_DIFFERENCES}
    assert tobs.get_registry().span_stats(f"solve.{engine}").count == 1


def test_layout_counters_equal_jax():
    for lay in (dict(d_p=8, tile=32), dict(d_p=64, tile=256),
                dict(d_p=0, tile=32)):
        tc.build_hybrid(tc.powerlaw_graph(500, 5000, seed=3), **lay)
        jc.build_hybrid(jc.powerlaw_graph(500, 5000, seed=3), **lay)
    t = tobs.get_registry().report()["counters"]
    assert t["layout.builds"] == 3
    assert t == jobs.get_registry().report()["counters"]


# ---------------------------------------------------------------------------
# quarantine counters
# ---------------------------------------------------------------------------

def test_quarantine_counters_equal_jax():
    n = 100
    b = tc.BatchUpdate(del_src=np.array([1, 200, -1], np.int64),
                       del_dst=np.array([2, 3, 4], np.int64),
                       ins_src=np.array([5, 6, 7, 8], np.int64),
                       ins_dst=np.array([6, 100, 9, 1000], np.int64))
    for _ in range(2):
        clean, rep = validate_batch(b, n, policy="quarantine")
        clean_j, rep_j = j_validate(_jbatch(b), n, policy="quarantine")
        assert rep.size == rep_j.size == 4
    validate_batch(clean, n, policy="quarantine")     # clean: not counted
    j_validate(clean_j, n, policy="quarantine")
    t = tobs.get_registry().report()["counters"]
    assert t == {"guard.quarantined": 8, "guard.quarantined_batches": 2}
    assert t == jobs.get_registry().report()["counters"]


# ---------------------------------------------------------------------------
# the SLO and capture state machine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_graphs():
    return (tc.random_graph(512, 4096, seed=0),
            jc.random_graph(512, 4096, seed=0))


def _patch_profiler(monkeypatch, module, calls):
    monkeypatch.setattr(module, "start_profiler",
                        lambda d: calls["start"].append(d) or True)
    monkeypatch.setattr(module, "stop_profiler",
                        lambda: calls.__setitem__("stop", calls["stop"] + 1)
                        or True)


def test_slo_breach_arms_one_capture_as_in_jax(small_graphs, monkeypatch):
    g, gj = small_graphs
    slo = dict(solve_p99_us=0.0, min_samples=1, capture_batches=2,
               capture_dir="ignored-dir")
    got = {}
    for name, module, pkg, make in (
            ("torch", tsession, tobs,
             lambda: ts.StreamSession(g, device="cpu",
                                      slo=tobs.SLOConfig(**slo))),
            ("jax", jsession, jobs,
             lambda: js.StreamSession(gj, slo=jobs.SLOConfig(**slo)))):
        calls = {"start": [], "stop": 0}
        _patch_profiler(monkeypatch, module, calls)
        sess = make()
        for seed in range(4):
            b = tc.random_batch(g, 16 / g.m, seed=seed)
            sess.apply(b if name == "torch" else _jbatch(b))
        counters = pkg.get_registry().report()["counters"]
        got[name] = dict(
            calls=calls,
            slo={k: v for k, v in counters.items() if k.startswith("slo.")},
            kinds=[e.kind for e in pkg.get_flight().events()
                   if e.kind.startswith("slo.")],
            count=sess.solve_percentiles()["count"])
    t = got["torch"]
    # one auto-arm per session: exactly one start/stop pair around the two
    # batches after the first breach
    assert t["calls"] == {"start": ["ignored-dir"], "stop": 1}
    assert t["slo"] == {"slo.breach.solve_p99": 4, "slo.capture.start": 1,
                        "slo.capture.stop": 1}
    assert t["count"] == 4
    assert t == got["jax"]


def test_arm_capture_rearms_and_unavailable_disarms(small_graphs,
                                                    monkeypatch):
    g, _ = small_graphs
    calls = {"start": [], "stop": 0}
    _patch_profiler(monkeypatch, tsession, calls)
    sess = ts.StreamSession(g, device="cpu",
                            slo=tobs.SLOConfig(solve_p99_us=1e12,
                                               min_samples=1))
    sess.arm_capture(1, log_dir="manual-dir")
    sess.apply(tc.random_batch(g, 16 / g.m, seed=2))
    assert calls == {"start": ["manual-dir"], "stop": 1}
    sess.arm_capture(2)                       # re-arm, the same directory
    for seed in (3, 4, 5):
        sess.apply(tc.random_batch(g, 16 / g.m, seed=seed))
    assert calls == {"start": ["manual-dir"] * 2, "stop": 2}
    reg = tobs.get_registry()
    assert reg.counter("slo.breach.solve_p99") == 0
    assert reg.counter("slo.capture.start") == 2
    # a profiler that will not start disarms the capture
    monkeypatch.setattr(tsession, "start_profiler", lambda d: False)
    sess.arm_capture(3)
    for seed in (6, 7):
        sess.apply(tc.random_batch(g, 16 / g.m, seed=seed))
    assert reg.counter("slo.capture.unavailable") == 1
    assert sess._capture_remaining == 0 and not sess._capture_active


def test_real_capture_holds_the_session_ranges(small_graphs, tmp_path):
    """One real torch.profiler capture on the CPU: a chrome trace in the
    SLO's directory whose ranges nest the engine's solve inside
    `session.solve`."""
    g, _ = small_graphs
    sess = ts.StreamSession(g, device="cpu", slo=tobs.SLOConfig(
        solve_p99_us=1.0, min_samples=2, capture_batches=1,
        capture_dir=str(tmp_path)))
    for seed in range(3):
        sess.apply(tc.random_batch(g, 16 / g.m, seed=seed))
    reg = tobs.get_registry()
    assert reg.counter("slo.capture.start") == 1
    assert reg.counter("slo.capture.stop") == 1
    assert reg.counter("slo.capture.unavailable") == 0
    (trace,) = tmp_path.glob("trace-*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events if e.get("ph") == "X"}
    solve = ranges["session.solve"]
    inner = [e for e in events if e.get("ph") == "X"
             and e["name"].startswith("solve.")]
    assert inner and all(
        solve["ts"] <= e["ts"] and e["ts"] + e["dur"] <= solve["ts"]
        + solve["dur"] for e in inner)
    assert "snapshot.device_refresh" in ranges
    assert not torch.autograd._profiler_enabled()


def test_slo_is_accepted(small_graphs):
    """`slo=` no longer raises (the other arguments of later slices still
    do: tests/test_torch_stream.py)."""
    g, _ = small_graphs
    sess = ts.StreamSession(g, device="cpu", slo=tobs.SLOConfig())
    assert sess.slo == tobs.SLOConfig()
    assert sess.solve_percentiles() == {"count": 0}
    sess.apply(tc.random_batch(g, 16 / g.m, seed=1))
    assert sess.solve_percentiles()["count"] == 1
    assert tobs.get_registry().counter("slo.breach.solve_p99") == 0
