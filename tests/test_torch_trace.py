"""repro_torch.obs.trace and ``trace=True`` on every engine, against the
JAX package's repro.obs.trace.

The load-bearing invariant is the reference's (tests/test_obs.py):
``trace=True`` fills a TraceBuffer but must not change a single bit of the
ranks or the iteration count. Each of the seven engines runs traced and
untraced in the port, on both of its sweeps (`kernels=False` and the
kernel composition over the kernels' plain versions), and traced in
`repro`. Bars:
  * ranks bit-identical, traced against untraced, iterations equal;
  * the `frontier`, `delta_n` and `pruned` series integer-equal to
    `repro`'s summary, and `linf` within 1e-12, where the iteration counts
    agree; near tau the JAX side's counts can change from run to run
    (ROADMAP C), so there the ranks are compared by tolerance (1e-10).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro.stream as js  # noqa: E402
from repro.core import compact as jcompact  # noqa: E402
from repro.obs import trace as jtrace  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch.core import compact as tcompact  # noqa: E402
from repro_torch.kernels import pull_sum_kernels  # noqa: E402
from repro_torch.obs import (ENGINE_IDS, ENGINE_NAMES,  # noqa: E402
                             maybe_summary, trace_init, trace_record,
                             trace_summary)

CPU = dict(device="cpu")
SOLVE_TOL = 1e-10
LINF_TOL = 1e-12
SERIES = ("frontier", "delta_n", "pruned")
KERNELS = pytest.mark.parametrize("kernels", [False, True],
                                  ids=["plain", "kernels"])
ENGINES = ["static", "nd", "dt", "df", "dfp", "df_compact", "dfp_compact"]


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# -- TraceBuffer primitives (mirrors of tests/test_obs.py) ---------------------

def test_engine_ids_match_repro():
    assert ENGINE_IDS == jtrace.ENGINE_IDS
    assert ENGINE_NAMES == jtrace.ENGINE_NAMES


def test_trace_init_sentinels_and_record():
    tb = trace_init(8, torch.float64, "dfp", device="cpu")
    assert int(tb.engine) == ENGINE_IDS["dfp"] and tb.cap == 8
    assert tb.linf.dtype == torch.float64 and tb.frontier.dtype == torch.int32
    assert bool(torch.isnan(tb.linf).all())
    assert bool((tb.frontier == -1).all())
    tb = trace_record(tb, 3, linf=0.5, frontier=7, delta_n=2, pruned=1)
    assert float(tb.linf[3]) == 0.5
    assert int(tb.frontier[3]) == 7
    assert int(tb.delta_n[3]) == 2 and int(tb.pruned[3]) == 1
    # untouched lanes keep their sentinels
    assert torch.isnan(tb.linf[0])
    assert int(tb.pruned[0]) == -1


def test_trace_record_takes_device_scalars():
    """Channels given as 0-d tensors (the engines' device-side counts) are
    cast into the channel's dtype."""
    tb = trace_init(4, torch.float64, "df", device="cpu")
    flags = torch.tensor([True, False, True, True])
    trace_record(tb, 1, linf=torch.tensor(0.125, dtype=torch.float64),
                 frontier=flags.sum(), delta_n=flags[:2].sum(),
                 pruned=flags.sum() - 1)
    assert tb.frontier.tolist() == [-1, 3, -1, -1]
    assert tb.delta_n.tolist() == [-1, 1, -1, -1]
    assert tb.pruned.tolist() == [-1, 2, -1, -1]
    assert tb.linf[1].item() == 0.125 and tb.frontier.dtype == torch.int32


def test_trace_record_out_of_cap_drops():
    tb = trace_init(4, torch.float64, "static", device="cpu")
    fresh = trace_init(4, torch.float64, "static", device="cpu")
    tb2 = trace_record(tb, 9, linf=1.0, frontier=1, delta_n=0, pruned=0)
    trace_record(tb, -1, linf=1.0, frontier=1, delta_n=0, pruned=0)
    assert torch.equal(tb2.frontier, fresh.frontier)
    assert bool(torch.isnan(tb2.linf).all())


def test_trace_summary_trims_and_sanitizes():
    tb = trace_init(6, torch.float64, "dfp_compact", device="cpu")
    tb = trace_record(tb, 0, linf=float("inf"), frontier=5, delta_n=1,
                      pruned=0)
    tb = trace_record(tb, 1, linf=0.25, frontier=3, delta_n=0, pruned=2)
    s = trace_summary(tb, 2)
    assert s["engine"] == "dfp_compact"
    assert s["iters"] == 2
    assert s["linf_delta"] == [None, 0.25]      # inf -> None (strict JSON)
    assert s["frontier"] == [5, 3]
    assert s["frontier_peak"] == 5 and s["frontier_final"] == 3
    assert s["linf_final"] == 0.25
    json.dumps(s, allow_nan=False)              # must be strict-JSON safe
    # the same records in repro give the same summary
    tj = jtrace.trace_init(6, jnp.float64, "dfp_compact")
    tj = jtrace.trace_record(tj, jnp.asarray(0), linf=jnp.inf, frontier=5,
                             delta_n=1, pruned=0)
    tj = jtrace.trace_record(tj, jnp.asarray(1), linf=0.25, frontier=3,
                             delta_n=0, pruned=2)
    assert s == jtrace.trace_summary(tj, 2)


def test_trace_summary_of_an_empty_solve():
    s = trace_summary(trace_init(3, torch.float64, "nd", device="cpu"), 0)
    assert s["iters"] == 0 and s["frontier"] == []
    assert s["frontier_peak"] == 0 and s["linf_final"] is None


def test_maybe_summary_passthrough():
    out, s = maybe_summary(("r", 3), False)
    assert out == ("r", 3) and s is None
    tb = trace_record(trace_init(4, torch.float64, "nd", device="cpu"), 0,
                      linf=0.1, frontier=2, delta_n=0, pruned=0)
    (r, it), s = maybe_summary(("r", 1, tb), True)
    assert r == "r" and it == 1 and s["engine"] == "nd"


# -- engine parity: trace on == trace off, series == repro's -------------------

class SmallCase:
    """tests/test_obs.py's small_case, staged in both packages."""

    def __init__(self):
        caps = dict(d_p=16, tile=64)
        g0 = tc.powerlaw_graph(800, 8000, seed=2)
        g0j = jc.powerlaw_graph(800, 8000, seed=2)
        b = tc.random_batch(g0, 0.003, seed=5)
        bj = jc.random_batch(g0j, 0.003, seed=5)
        g, gj = tc.apply_batch(g0, b), jc.apply_batch(g0j, bj)
        self.n = g.n
        self.t = dict(dg0=tc.device_graph(g0, **caps, **CPU),
                      dg=tc.device_graph(g, **caps, **CPU),
                      fwd=tc.forward_device_graph(g, **caps, **CPU),
                      db=tc.batch_to_device(b, g.n, **CPU))
        self.j = dict(dg0=jc.device_graph(g0j, **caps),
                      dg=jc.device_graph(gj, **caps),
                      fwd=jc.forward_device_graph(gj, **caps),
                      db=jc.batch_to_device(bj, g.n))
        r_prev, _ = jc.static_pagerank(self.j["dg0"], jc.init_ranks(g0.n))
        self.r_prev = np.asarray(r_prev)
        self._j_summary = {}

    def run(self, pkg, engine, **kw):
        c = self.t if pkg is tc else self.j
        r0 = self.r_prev if pkg is tc else jnp.asarray(self.r_prev)
        if engine == "static":
            init = (tc.init_ranks(self.n, **CPU) if pkg is tc
                    else jc.init_ranks(self.n))
            return pkg.static_pagerank(c["dg"], init, **kw)
        if engine == "nd":
            return pkg.nd_pagerank(c["dg"], r0, **kw)
        if engine == "dt":
            return pkg.dt_pagerank(c["dg"], c["dg0"], r0, c["db"], **kw)
        if engine.endswith("_compact"):
            return getattr(pkg, f"{engine.split('_')[0]}_pagerank_compact")(
                c["dg"], c["fwd"], r0, c["db"], **kw)
        return getattr(pkg, f"{engine}_pagerank")(c["dg"], r0, c["db"], **kw)

    def j_summary(self, engine):
        """repro's traced run of `engine`: (ranks, summary), run once."""
        if engine not in self._j_summary:
            r, it, tb = self.run(jc, engine, trace=True)
            self._j_summary[engine] = (np.asarray(r),
                                       jtrace.trace_summary(tb, it))
        return self._j_summary[engine]


@pytest.fixture(scope="module")
def small_case():
    return SmallCase()


def _assert_matches_repro(s, r, s_j, r_j):
    """Series integer-equal and linf to 1e-12 where the iteration counts
    agree; the ranks within 1e-10 either way."""
    assert _linf(r, r_j) <= SOLVE_TOL
    assert s["engine"] == s_j["engine"]
    if s["iters"] != s_j["iters"]:
        return
    for key in SERIES:
        assert s[key] == s_j[key], key
    for a, b in zip(s["linf_delta"], s_j["linf_delta"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert abs(a - b) <= LINF_TOL


def _parity(small_case, engine, **kw):
    r0, it0 = small_case.run(tc, engine, **kw)
    r1, it1, tb = small_case.run(tc, engine, trace=True, **kw)
    assert torch.equal(r0, r1)
    assert it0 == it1
    s = trace_summary(tb, it1)
    assert s["engine"] == engine and s["iters"] == it1 >= 1
    front = tb.frontier.numpy()
    assert np.all(front[:it1] >= 0)             # every lane written
    if it1 < tb.cap:
        assert front[it1] == -1                 # and nothing beyond
    r_j, s_j = small_case.j_summary(engine)
    _assert_matches_repro(s, r1, s_j, r_j)
    return s


@KERNELS
@pytest.mark.parametrize("engine", ENGINES)
def test_trace_parity_and_series_match_repro(small_case, kernels, engine):
    s = _parity(small_case, engine, kernels=kernels)
    if engine == "static":
        assert s["frontier"] == [small_case.n] * s["iters"]
        assert s["delta_n"] == s["pruned"] == [0] * s["iters"]
    if engine in ("nd", "dt"):
        assert s["delta_n"] == s["pruned"] == [0] * s["iters"]
    if engine.startswith("dfp"):
        assert all(p >= 0 for p in s["pruned"])
    if engine.endswith("_compact"):
        # the frontier series decays to a small tail (paper Fig. 3 shape)
        assert s["frontier"][-1] <= s["frontier_peak"]
    assert s["linf_final"] <= tc.PRParams().tau


@pytest.mark.parametrize("engine", ["static", "dfp"])
def test_staged_trace_parity(small_case, engine):
    """trace=True on the staged sweep: bit-identical ranks, and the same
    series as the fused sweep's trace."""
    s = _parity(small_case, engine, kernels=True,
                pull_sum_fn=pull_sum_kernels)
    _, it, tb = small_case.run(tc, engine, kernels=True, trace=True)
    fused = trace_summary(tb, it)
    if fused["iters"] == s["iters"]:
        for key in SERIES:
            assert s[key] == fused[key]


@pytest.mark.parametrize("prune", [False, True], ids=["df", "dfp"])
def test_compact_overflow_marks_the_dense_handoff(small_case, prune):
    """With headroom 1 the compact lists overflow: that iteration records
    linf = inf (None in the summary) and the dense finish appends after
    it, as in repro."""
    c, cj = small_case.t, small_case.j
    kw = dict(prune=prune, headroom=1)
    r0, it0 = tcompact._df_like_compact(c["dg"], c["fwd"],
                                        small_case.r_prev, c["db"],
                                        tc.PRParams(), **kw)
    r1, it1, tb, hw = tcompact._df_like_compact(
        c["dg"], c["fwd"], small_case.r_prev, c["db"], tc.PRParams(),
        trace=True, health=True, **kw)
    assert torch.equal(r0, r1) and it0 == it1 and int(hw) == 0
    s = trace_summary(tb, it1)
    assert s["linf_delta"].count(None) == 1
    k = s["linf_delta"].index(None)
    assert 0 <= k < it1 - 1                     # the dense finish ran on
    assert s["pruned"][k] == 0
    rj, itj, tbj = jcompact._df_like_compact(
        cj["dg"], cj["fwd"], jnp.asarray(small_case.r_prev), cj["db"],
        jc.PRParams(), trace=True, **kw)
    _assert_matches_repro(s, r1, jtrace.trace_summary(tbj, itj),
                          np.asarray(rj))


def test_traced_output_order_with_health_and_caps(small_case):
    """(r, iters, tb, health) with frontier caps: fstats stay internal."""
    c = small_case.t
    caps = tc.caps_for(c["dg"], 200)
    r0, it0 = tc.dfp_pagerank(c["dg"], small_case.r_prev, c["db"],
                              fwd=c["fwd"], frontier_caps=caps)
    r, it, tb, hw = tc.dfp_pagerank(c["dg"], small_case.r_prev, c["db"],
                                    fwd=c["fwd"], frontier_caps=caps,
                                    trace=True, health=True)
    assert torch.equal(r, r0) and it == it0 and int(hw) == 0
    s = trace_summary(tb, it)
    dense = trace_summary(tc.dfp_pagerank(c["dg"], small_case.r_prev,
                                          c["db"], trace=True)[2], it)
    for key in SERIES:
        assert s[key] == dense[key]


# -- the session -----------------------------------------------------------------

def _jbatch(b):
    return jc.BatchUpdate(del_src=b.del_src, del_dst=b.del_dst,
                          ins_src=b.ins_src, ins_dst=b.ins_dst)


@pytest.mark.parametrize("name", ["churn", "temporal"])
def test_session_trace_matches_repro_session(name):
    caps = dict(d_p=8, tile=32)
    if name == "churn":
        g = tc.powerlaw_graph(1000, 10000, seed=13)
        batches = ts.churn_workload(g, 2e-3, 3, seed=14)
        kw = dict(compact_threshold=0.5)
    else:
        g, batches = tc.temporal_stream(2000, 30000, n_batches=60, seed=12)
        batches, kw = batches[:3], {}
    gj = jc.build_graph(g.n, *g.edges())
    sess = ts.StreamSession(g, **caps, trace=True, **kw, **CPU)
    plain = ts.StreamSession(g, **caps, **kw, **CPU)
    sj = js.StreamSession(gj, **caps, trace=True, **kw)
    for b in batches:
        sess.apply(b)
        plain.apply(b)
        sj.apply(_jbatch(b))
        st, st_j = sess.history[-1], sj.history[-1]
        assert torch.equal(sess.ranks, plain.ranks)
        assert plain.history[-1].trace is None
        assert st.engine == st_j.engine
        assert st.trace["iters"] == st.iters
        assert st.trace["engine"] == {"dense": "dfp",
                                      "compact": "dfp_compact"}[st.engine]
        json.dumps(st.trace, allow_nan=False)
        _assert_matches_repro(st.trace, sess.ranks, st_j.trace,
                              np.asarray(sj.ranks))
    sess.apply(tc.BatchUpdate(*[np.zeros(0, np.int32)] * 4))
    assert sess.history[-1].engine == "noop"
    assert sess.history[-1].trace is None
