"""The port's guard (`repro_torch.guard`, the guarded `StreamSession`)
against the JAX package's, on the CPU.

Each single-device scenario of `tests/test_guard.py` runs through
`repro.stream`/`repro.guard` and through the port (``device="cpu"``) on
the same numpy-seeded graphs, batches and `ChaosMonkey` seeds, each
package's registry and flight recorder reset before. Every test asserts the
JAX test's own conditions on the port, and that every ``guard.*`` counter
and every ``guard.*`` flight event (paths by their last component, the
audit's ``l1`` within 1e-12) equals JAX's. Beside them: the exports and
`GuardConfig`, the chaos faults bit for bit, journals byte for byte (each
package's ``scan`` reading the other's file, torn tails included), and
checkpoint directories written by one package restored by the other.
"""
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro.guard as jg  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.stream as js  # noqa: E402
from repro.obs.postmortem import load_bundle as j_load_bundle  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.guard as tg  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch.guard import journal as tjournal  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

N, M = 512, 4096
#: chained DF-P against a from-scratch solve (tests/test_guard.py's bar)
L1_TOL = 1e-8
#: flight fields that are times, and fields that name a path
TIMING_FIELDS = ("solve_us",)
PATH_FIELDS = ("path", "dir")


class Side:
    """One package: its modules and how a scenario calls them."""

    def __init__(self, name, core, stream, guard, obs, **kw):
        self.name, self.core, self.stream = name, core, stream
        self.guard, self.obs, self.kw = guard, obs, kw

    def batch(self, b):
        return self.core.BatchUpdate(del_src=b.del_src, del_dst=b.del_dst,
                                     ins_src=b.ins_src, ins_dst=b.ins_dst)

    def session(self, g, **kw):
        return self.stream.StreamSession(g, **kw, **self.kw)

    def restore(self, d):
        return self.stream.StreamSession.restore(d, **self.kw)

    def init_ranks(self, n):
        return self.core.init_ranks(n, **self.kw)


JAX = Side("jax", jc, js, jg, jobs)
TORCH = Side("torch", tc, ts, tg, tobs, device="cpu")
SIDES = (JAX, TORCH)


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


def _guard_counters(side):
    return {k: v for k, v in side.obs.get_registry().report()[
        "counters"].items() if k.startswith("guard.")}


def _guard_events(side):
    out = []
    for e in side.obs.get_flight().events():
        if not e.kind.startswith("guard."):
            continue
        data = {k: (os.path.basename(v) if k in PATH_FIELDS else v)
                for k, v in e.data.items() if k not in TIMING_FIELDS}
        out.append((e.kind, data))
    return out


def _events_match(t, j):
    assert [k for k, _ in t] == [k for k, _ in j]
    for (_, a), (_, b) in zip(t, j):
        assert set(a) == set(b)
        for k in a:
            if k == "l1":
                assert abs(a[k] - b[k]) <= 1e-12, (a[k], b[k])
            else:
                assert a[k] == b[k], (k, a[k], b[k])


def both(scenario):
    """Run ``scenario(side)`` for JAX, then the port, each on fresh
    registries; returns {name: (result, guard counters, guard events)} and
    asserts the two packages' guard counters and events equal."""
    out = {}
    for side in SIDES:
        _reset()
        res = scenario(side)
        out[side.name] = (res, _guard_counters(side), _guard_events(side))
    _reset()
    assert out["torch"][1] == out["jax"][1]
    _events_match(out["torch"][2], out["jax"][2])
    return out


def _l1(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).sum())


def _empty_batch(side):
    z = np.zeros(0, np.int64)
    return side.core.BatchUpdate(del_src=z, del_dst=z, ins_src=z, ins_dst=z)


def _g(side):
    return side.core.random_graph(N, M, seed=0)


@pytest.fixture(scope="module")
def tstream_np():
    """The acceptance-scale temporal stream of tests/test_guard.py, as
    numpy arrays (each side builds its own graph from the same seed)."""
    return dict(n=2500, m=35000, n_batches=8, seed=3)


def _tstream(side, spec):
    return side.core.temporal_stream(spec["n"], spec["m"],
                                     n_batches=spec["n_batches"],
                                     seed=spec["seed"])


# ---------------------------------------------------------------------------
# the package surface
# ---------------------------------------------------------------------------

def test_exports_and_guard_config_equal_jax():
    assert tg.__all__ == jg.__all__
    assert dataclasses.asdict(tg.GuardConfig()) == dataclasses.asdict(
        jg.GuardConfig())
    kw = dict(policy="quarantine", mass_tol=1e-6, retry_budget=3,
              audit_every=4, audit_tol=1e-9, postmortem_dir="x")
    assert dataclasses.asdict(tg.GuardConfig(**kw)) == dataclasses.asdict(
        jg.GuardConfig(**kw))
    for cls in (tg.GuardConfig, jg.GuardConfig):
        with pytest.raises(ValueError, match="unknown guard policy"):
            cls(policy="ignore")
        with pytest.raises(dataclasses.FrozenInstanceError):
            cls().policy = "quarantine"


# ---------------------------------------------------------------------------
# chaos: the same seed, the same faults
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,k", [("out_of_range", 4), ("out_of_range", 2),
                                    ("dup_flood", 64)])
def test_chaos_corrupt_batch_equals_jax(mode, k):
    g = tc.random_graph(N, M, seed=0)
    b = tc.random_batch(g, 16 / M, seed=3)
    got = tg.ChaosMonkey(seed=1).corrupt_batch(b, N, mode=mode, k=k)
    want = jg.ChaosMonkey(seed=1).corrupt_batch(JAX.batch(b), N, mode=mode,
                                                k=k)
    for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
        a, w = getattr(got, f), getattr(want, f)
        assert a.dtype == w.dtype
        np.testing.assert_array_equal(a, w)
    with pytest.raises(ValueError, match="unknown corruption mode"):
        tg.ChaosMonkey().corrupt_batch(b, N, mode="zap")


@pytest.mark.parametrize("mode,k,idx", [("nan", 3, None), ("nan", 1, [3]),
                                        ("bitflip", 5, None),
                                        ("bitflip", 1, [2, 7])])
def test_chaos_poison_ranks_equals_jax(mode, k, idx):
    r = np.random.default_rng(0).random(1000) / 1000
    got = tg.ChaosMonkey(seed=4).poison_ranks(
        torch.from_numpy(r), mode=mode, k=k, idx=idx)
    want = jg.ChaosMonkey(seed=4).poison_ranks(jnp.asarray(r), mode=mode,
                                               k=k, idx=idx)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    assert got.device == torch.device("cpu")
    np.testing.assert_array_equal(got.numpy().view(np.uint64),
                                  np.asarray(want).view(np.uint64))
    assert not np.array_equal(got.numpy(), r)
    # a copy: the input is untouched
    assert np.isfinite(r).all()


def test_chaos_truncate_and_force_nonconvergence_equal_jax(tmp_path):
    paths = []
    for side, monkey in ((TORCH, tg.ChaosMonkey(seed=12)),
                         (JAX, jg.ChaosMonkey(seed=12))):
        p = tmp_path / side.name
        p.write_bytes(bytes(range(256)) * 4)
        paths.append((monkey.truncate_journal(str(p)), p.stat().st_size))
    assert paths[0] == paths[1] and 768 <= paths[0][0] < 1024

    class Holder:
        params = tc.PRParams(tau=1e-9)
    h = Holder()
    tg.ChaosMonkey().force_nonconvergence(h)
    assert h.params == tc.PRParams(tau=1e-9, max_iter=1)


# ---------------------------------------------------------------------------
# piece 1: ingest validation & quarantine
# ---------------------------------------------------------------------------

def test_validate_policies_equal_jax():
    def scenario(S):
        g = _g(S)
        chaos = S.guard.ChaosMonkey(seed=1)
        bad = chaos.corrupt_batch(_empty_batch(S), N, mode="out_of_range",
                                  k=4)
        with pytest.raises(S.guard.ValidationError):
            S.guard.validate_batch(bad, N)
        good = S.core.random_batch(g, 16, seed=3)
        bad = chaos.corrupt_batch(good, N, mode="out_of_range", k=4)
        clean, report = S.guard.validate_batch(bad, N, policy="quarantine")
        assert isinstance(report, S.guard.QuarantineReport)
        assert report.size == 4 and bool(report)
        # the clean remainder is exactly the original batch's pairs
        assert clean.ins_src.shape[0] == bad.ins_src.shape[0] - 4
        reg = S.obs.get_registry()
        assert reg.counter("guard.quarantined") == 4
        assert reg.counter("guard.quarantined_batches") == 1
        return clean, report

    out = both(scenario)
    (ct, rt), (cj, rj) = out["torch"][0], out["jax"][0]
    for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
        np.testing.assert_array_equal(getattr(ct, f), getattr(cj, f))
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))


@pytest.mark.parametrize("mangle", ["short", "float", "2d"])
def test_validate_structural_always_fatal(mangle):
    def scenario(S):
        b = S.core.random_batch(_g(S), 8, seed=4)
        B = S.core.BatchUpdate
        b = {"short": lambda: B(b.del_src, b.del_dst, b.ins_src[:-1],
                                b.ins_dst),
             "float": lambda: B(b.del_src, b.del_dst,
                                b.ins_src.astype(np.float64), b.ins_dst),
             "2d": lambda: B(b.del_src, b.del_dst, b.ins_src.reshape(1, -1),
                             b.ins_dst.reshape(1, -1))}[mangle]()
        for policy in ("raise", "quarantine"):
            with pytest.raises(S.guard.ValidationError):
                S.guard.validate_batch(b, N, policy=policy)

    both(scenario)


def test_ingest_rejects_aliasing_ids_and_coalesces_floods():
    def scenario(S):
        g = _g(S)
        bad = S.guard.ChaosMonkey(seed=2).corrupt_batch(
            S.core.random_batch(g, 8, seed=5), N, mode="out_of_range")
        with pytest.raises(S.guard.ValidationError):
            S.stream.ingest(bad, N)
        delta = S.stream.ingest(bad, N, policy="quarantine")
        assert delta.size > 0
        assert (delta.ins_dst >= 0).all() and (delta.ins_dst < N).all()
        flooded = S.guard.ChaosMonkey(seed=3).corrupt_batch(
            _empty_batch(S), N, mode="dup_flood", k=64)
        flood = S.stream.ingest(flooded, N)
        assert flood.ni == 1        # 64 copies of one pair -> one edge
        return delta, flood

    out = both(scenario)
    for a, b in zip(out["torch"][0], out["jax"][0]):
        for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# ---------------------------------------------------------------------------
# piece 2: the health word through the engine loops
# ---------------------------------------------------------------------------

def _solve_with_health(S, engine, g, params):
    """One engine loop with health=True (tests/test_guard.py's helper)."""
    dg = S.core.device_graph(g, d_p=16, tile=64, **S.kw)
    if engine == "static":
        return S.core.static_pagerank(dg, S.init_ranks(g.n), params,
                                      health=True)
    b = S.core.random_batch(g, 32, seed=9)
    delta = S.stream.ingest(b, g.n)
    g2 = S.core.apply_batch(g, b)
    r0, _ = S.core.static_pagerank(dg, S.init_ranks(g.n), S.core.PRParams())
    snap = S.stream.DeviceSnapshot(g2, d_p=16, tile=64, **S.kw)
    db = delta.to_device(**S.kw)
    if engine == "dense":
        return S.core.dfp_pagerank(snap, r0, db, params, health=True)
    return S.core.dfp_pagerank_compact(snap, None, r0, db, params,
                                       health=True)


@pytest.mark.parametrize("engine", ["static", "dense", "compact"])
def test_health_at_budget_exhaustion_and_final_sweep(engine):
    """H_MAX_ITER is set exactly when iters == max_iter AND the final L∞
    delta is still above tau; iters == max_iter alone does not trip."""
    def scenario(S):
        g = _g(S)
        P = S.core.PRParams
        r, iters, hw = _solve_with_health(S, engine, g, P())
        assert int(hw) == S.guard.HEALTH_OK, S.guard.describe_health(
            int(hw))
        assert int(iters) < P().max_iter
        _, it1, hw1 = _solve_with_health(S, engine, g, P(max_iter=1))
        assert int(it1) == 1
        assert int(hw1) & S.guard.H_MAX_ITER
        _, it2, hw2 = _solve_with_health(S, engine, g,
                                         P(max_iter=int(iters)))
        assert int(it2) == int(iters)
        assert int(hw2) == S.guard.HEALTH_OK
        return np.asarray(r), int(hw1)

    out = both(scenario)
    assert out["torch"][0][1] == out["jax"][0][1]
    assert _l1(out["torch"][0][0], out["jax"][0][0]) < 1e-10


def test_nan_poison_detected_in_one_sweep():
    """NaN > tau is False: a poisoned solve exits after ONE sweep with the
    nonfinite bit set instead of spinning to max_iter."""
    def scenario(S):
        g = _g(S)
        chaos = S.guard.ChaosMonkey(seed=5)
        dg = S.core.device_graph(g, d_p=16, tile=64, **S.kw)
        r0, _ = S.core.static_pagerank(dg, S.init_ranks(g.n),
                                       S.core.PRParams())
        b = S.core.random_batch(g, 16, seed=11)
        delta = S.stream.ingest(b, g.n)
        snap = S.stream.DeviceSnapshot(S.core.apply_batch(g, b), d_p=16,
                                       tile=64, **S.kw)
        r_bad = chaos.poison_ranks(r0, mode="nan", k=2)
        r, iters, hw = S.core.dfp_pagerank(snap, r_bad,
                                           delta.to_device(**S.kw),
                                           S.core.PRParams(), health=True)
        assert int(hw) & S.guard.H_NONFINITE
        assert int(iters) <= 2, int(iters)
        return np.flatnonzero(np.isnan(np.asarray(r_bad))), int(hw)

    out = both(scenario)
    np.testing.assert_array_equal(out["torch"][0][0], out["jax"][0][0])
    assert out["torch"][0][1] == out["jax"][0][1]


# ---------------------------------------------------------------------------
# the session: noop, recompute, ladder, audit, mass_tol
# ---------------------------------------------------------------------------

def test_empty_and_fully_quarantined_batches_are_noops():
    def scenario(S):
        g = _g(S)
        sess = S.session(g, guard=S.guard.GuardConfig())
        r_before = sess.ranks
        r = sess.apply(_empty_batch(S))
        st = sess.history[-1]
        assert st.engine == "noop" and st.batch_size == 0 and st.iters == 0
        assert st.snapshot.rows_touched == 0 and st.solve_s == 0.0
        assert r is r_before  # not even a copy
        assert S.obs.get_registry().counter("session.engine.noop") == 1
        assert sess._batch_idx == 0  # noops hold no sequence number
        sess = S.session(g, guard=S.guard.GuardConfig(policy="quarantine"))
        bad = S.guard.ChaosMonkey(seed=6).corrupt_batch(
            _empty_batch(S), N, mode="out_of_range", k=4)
        sess.apply(bad)
        st = sess.history[-1]
        assert st.engine == "noop" and st.quarantined == 4
        assert sess._last_quarantine == {"size": 4, "deletions": 0,
                                         "insertions": 4}
        return st.quarantined

    out = both(scenario)
    assert out["torch"][1] == {"guard.quarantined": 4,
                               "guard.quarantined_batches": 1}


def test_recompute_records_history_and_counter():
    def scenario(S):
        sess = S.session(_g(S))
        h0 = len(sess.history)
        sess.recompute()
        assert len(sess.history) == h0 + 1
        st = sess.history[-1]
        assert st.engine == "recompute" and st.iters > 0 and st.solve_s > 0
        assert S.obs.get_registry().counter("session.recompute") == 1
        assert _l1(sess.flat_ranks(), sess.static_reference()) < 1e-12
        return np.asarray(sess.ranks)

    out = both(scenario)
    assert _l1(out["torch"][0], out["jax"][0]) < 1e-10


def test_ladder_recovers_forced_nonconvergence(tstream_np):
    def scenario(S):
        base, batches = _tstream(S, tstream_np)
        sess = S.session(base, d_p=16, tile=64, guard=S.guard.GuardConfig())
        S.guard.ChaosMonkey(seed=7).force_nonconvergence(sess)
        sess.apply(batches[0])
        st = sess.history[-1]
        assert st.health & S.guard.H_MAX_ITER
        assert st.escalations >= 1
        obs = S.obs.get_registry()
        assert obs.counter("guard.unhealthy") == 1
        assert obs.counter("guard.health.max_iter") == 1
        assert obs.counter("guard.escalate.dense") == 1
        assert obs.counter("guard.escalate.success") == 1
        # recovery used the full-budget recovery params
        ref, _ = S.core.static_pagerank(sess.snap.dg, S.init_ranks(sess.n),
                                        sess.params._replace(max_iter=500))
        assert _l1(sess.flat_ranks(), ref) < L1_TOL
        return st.health, st.escalations, np.asarray(sess.ranks)

    out = both(scenario)
    assert out["torch"][0][:2] == out["jax"][0][:2]
    assert _l1(out["torch"][0][2], out["jax"][0][2]) < L1_TOL


def test_ladder_recovers_nan_poison():
    """The poisoned lane is read by the sweep: H_NONFINITE, the ladder
    recovers, and the failed attempt leaves the pre-solve ranks it retries
    from bit-unchanged."""
    def scenario(S):
        g = _g(S)
        sess = S.session(g, guard=S.guard.GuardConfig())
        sess.ranks = S.guard.ChaosMonkey(seed=8).poison_ranks(
            sess.ranks, mode="nan", k=1, idx=[3])
        r_pre = sess.ranks
        bits = np.asarray(r_pre).view(np.uint64).copy()
        sess.apply(S.core.random_batch(g, 16, seed=13))
        st = sess.history[-1]
        assert st.health & S.guard.H_NONFINITE
        assert st.escalations >= 1
        assert S.obs.get_registry().counter("guard.escalate.success") == 1
        assert _l1(sess.flat_ranks(), sess.static_reference()) < L1_TOL
        np.testing.assert_array_equal(np.asarray(r_pre).view(np.uint64),
                                      bits)
        return st.health, st.escalations

    out = both(scenario)
    assert out["torch"][0] == out["jax"][0]


def test_ladder_exhaustion_counted_and_bundled(tmp_path):
    """retry_budget=0 walks no rungs, reports exhaustion and writes an
    `escalation_exhausted` bundle that the JAX package's `load_bundle`
    reads, with the quarantine summary and the journal sequence."""
    def scenario(S):
        g = _g(S)
        pdir = tmp_path / S.name
        sess = S.session(g, guard=S.guard.GuardConfig(
            retry_budget=0, policy="quarantine", postmortem_dir=str(pdir)))
        S.guard.ChaosMonkey(seed=9).force_nonconvergence(sess)
        bad = S.guard.ChaosMonkey(seed=9).corrupt_batch(
            S.core.random_batch(g, 32, seed=14), N, k=2)
        sess.apply(bad)
        obs = S.obs.get_registry()
        assert obs.counter("guard.unhealthy") == 1
        assert obs.counter("guard.escalate.exhausted") == 1
        assert obs.counter("guard.escalate.success") == 0
        st = sess.history[-1]
        assert st.escalations == 0 and st.quarantined == 2
        (bundle,) = pdir.iterdir()
        return str(bundle)

    out = both(scenario)
    docs = {k: j_load_bundle(v[0]) for k, v in out.items()}
    t, j = docs["torch"], docs["jax"]
    assert t["reason"] == j["reason"] == "escalation_exhausted"
    assert t["health"] == j["health"] and t["health"]["flags"] == [
        "max_iter"]
    assert t["quarantine"] == j["quarantine"] == {
        "size": 2, "deletions": 0, "insertions": 2}
    assert t["journal_seq"] == j["journal_seq"] == 1
    assert t["extra"]["first_health"] == j["extra"]["first_health"]
    assert t["extra"]["rungs_walked"] == j["extra"]["rungs_walked"] == 0
    assert t["extra"]["slo"] == {"count": 0} == j["extra"]["slo"]
    kinds = {k: [json.loads(line)["kind"] for line in open(
        os.path.join(v[0], "flight.jsonl"))] for k, v in out.items()}
    assert kinds["torch"] == kinds["jax"]
    assert kinds["torch"][-1] == "guard.escalate.exhausted"
    # rendered by the port's command line
    buf = io.StringIO()
    tobs.postmortem.render(out["torch"][0], out=buf)
    assert "escalation_exhausted" in buf.getvalue()


def test_postmortem_dir_falls_back_to_the_environment(tmp_path, monkeypatch):
    g = tc.random_graph(N, M, seed=0)
    monkeypatch.setenv("REPRO_POSTMORTEM_DIR", str(tmp_path / "env"))
    sess = ts.StreamSession(g, guard=tg.GuardConfig(retry_budget=0),
                            device="cpu")
    assert sess._postmortem_dir() == str(tmp_path / "env")
    tg.ChaosMonkey().force_nonconvergence(sess)
    sess.apply(tc.random_batch(g, 32, seed=14))
    assert len(list((tmp_path / "env").iterdir())) == 1
    sess = ts.StreamSession(g, guard=tg.GuardConfig(), device="cpu",
                            journal_dir=str(tmp_path / "j"))
    assert sess._postmortem_dir() == str(tmp_path / "j")
    monkeypatch.delenv("REPRO_POSTMORTEM_DIR")
    assert ts.StreamSession(g, guard=tg.GuardConfig(),
                            device="cpu")._postmortem_dir() is None


def test_audit_resyncs_frozen_lane_corruption():
    """A finite bit-flip OUTSIDE the batch frontier survives the solve; the
    periodic drift audit catches and resyncs it."""
    def scenario(S):
        g = _g(S)
        sess = S.session(g, guard=S.guard.GuardConfig(
            audit_every=1, audit_tol=1e-8, mass_tol=1e30))
        sess.ranks = S.guard.ChaosMonkey(seed=10).poison_ranks(
            sess.ranks, mode="bitflip", k=1, idx=[2])
        sess.apply(S.core.random_batch(g, 8, seed=15))
        obs = S.obs.get_registry()
        assert obs.counter("guard.audit.runs") == 1
        assert obs.counter("guard.audit.resync") == 1
        assert _l1(sess.flat_ranks(), sess.static_reference()) < L1_TOL
        return np.asarray(sess.ranks)

    out = both(scenario)
    assert _l1(out["torch"][0], out["jax"][0]) < 1e-10


def test_mass_tol_override_reaches_watchdog():
    def scenario(S):
        g = _g(S)
        sess = S.session(g, guard=S.guard.GuardConfig(mass_tol=1e-12))
        sess.apply(S.core.random_batch(g, 16, seed=16))
        st = sess.history[-1]
        assert st.health & S.guard.H_MASS_DRIFT
        assert S.obs.get_registry().counter("guard.health.mass_drift") >= 1
        return st.health, st.escalations

    out = both(scenario)
    assert out["torch"][0] == out["jax"][0]


def test_unguarded_session_keeps_the_strict_ingest():
    g = tc.random_graph(N, M, seed=0)
    sess = ts.StreamSession(g, device="cpu")
    bad = tg.ChaosMonkey(seed=1).corrupt_batch(
        tc.random_batch(g, 8, seed=5), N)
    with pytest.raises(tg.ValidationError):
        sess.apply(bad)
    sess.apply(tc.random_batch(g, 8, seed=5))
    st = sess.history[-1]
    assert (st.health, st.escalations, st.quarantined) == (0, 0, 0)
    assert _guard_counters(TORCH) == {}


# ---------------------------------------------------------------------------
# piece 3: the journal
# ---------------------------------------------------------------------------

def _zigzag(pkg, n, k, seed):
    rng = np.random.default_rng(seed)
    return pkg.JournalRecord(
        seq=k, n=n,
        del_src=rng.integers(0, n, 3).astype(np.int32),
        del_dst=rng.integers(0, n, 3).astype(np.int32),
        ins_src=rng.integers(0, n, 5).astype(np.int32),
        ins_dst=rng.integers(0, n, 5).astype(np.int32))


def _write_journal(side, d, records=5):
    pkg = side.guard
    path = pkg.journal_path(str(d))
    j = pkg.DeltaJournal(path)
    for k in range(1, records + 1):
        j.append(_zigzag(pkg, N, k, k))
    j.close()
    return path


def test_journal_roundtrip_and_bytes_equal_jax(tmp_path):
    def scenario(S):
        path = _write_journal(S, tmp_path / S.name)
        out, truncated = S.guard.DeltaJournal.scan(path)
        assert not truncated and len(out) == 5
        for k, b in enumerate(out, 1):
            a = _zigzag(S.guard, N, k, k)
            assert a.seq == b.seq and a.n == b.n
            for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        return path

    out = both(scenario)
    t, j = (open(out[k][0], "rb").read() for k in ("torch", "jax"))
    assert t == j and len(t) == 5 * (32 + 4 * 16)
    assert out["torch"][1] == {"guard.journal.appends": 5,
                               "guard.journal.bytes": len(t)}
    assert tjournal.record_bytes(_zigzag(tg, N, 1, 1)) == 32 + 4 * 16


#: a record of `_zigzag` in the file: the 32-byte header and 16 int32s
RECORD = 32 + 4 * 16
#: where the journal of five records is cut, and the records that survive
CUTS = {"intact": (None, 5), "last_record": (5 * RECORD - 7, 4),
        "fourth_header": (3 * RECORD + 3, 3),
        "second_payload": (RECORD + 40, 1), "chaos": ("chaos", None)}


@pytest.mark.parametrize("cut", list(CUTS))
def test_journal_scans_read_each_other(tmp_path, cut):
    """Each package's scan reads the other's file, intact and torn (inside
    the last record, inside a header, inside a payload, or at the chaos
    injector's random cut)."""
    nbytes, survive = CUTS[cut]
    for writer, reader in ((TORCH, JAX), (JAX, TORCH)):
        path = _write_journal(writer, tmp_path / f"{writer.name}_to_"
                              f"{reader.name}")
        if nbytes == "chaos":
            writer.guard.ChaosMonkey(seed=11).truncate_journal(path)
        elif nbytes is not None:
            writer.guard.ChaosMonkey().truncate_journal(path, nbytes)
        _reset()
        got, t_trunc = reader.guard.DeltaJournal.scan(path)
        want, w_trunc = writer.guard.DeltaJournal.scan(path)
        assert t_trunc == w_trunc == (nbytes is not None)
        assert [r.seq for r in got] == [r.seq for r in want]
        if survive is not None:
            assert [r.seq for r in got] == list(range(1, survive + 1))
        for a, b in zip(got, want):
            for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert (reader.obs.get_registry().counter("guard.journal.truncated")
                == int(nbytes is not None))


# ---------------------------------------------------------------------------
# piece 3: checkpoints and restore
# ---------------------------------------------------------------------------

def _state_equal(a_snap, b_snap):
    A, ea = a_snap.state_dict()
    B, eb = b_snap.state_dict()
    assert set(A) == set(B)
    for k in A:
        assert np.array_equal(np.asarray(A[k]), np.asarray(B[k])), k
    assert ea == eb


def test_restore_bit_identical(tmp_path):
    """Kill-and-restore replay is BIT-identical — ranks and the full
    snapshot state (free-list order included)."""
    def scenario(S):
        d = str(tmp_path / S.name)
        sess = S.session(_g(S), guard=S.guard.GuardConfig(), journal_dir=d,
                         checkpoint_every=2)
        for i in range(5):
            sess.apply(S.core.random_batch(sess.snap.graph(), 32,
                                           seed=20 + i))
        sess.close()
        restored = S.restore(d)
        assert restored._batch_idx == sess._batch_idx == 5
        assert np.array_equal(np.asarray(sess.ranks),
                              np.asarray(restored.ranks))
        _state_equal(sess.snap, restored.snap)
        assert S.obs.get_registry().counter("guard.restores") == 1
        # and the restored session keeps streaming identically
        b = S.core.random_batch(sess.snap.graph(), 16, seed=99)
        r1, r2 = sess.apply(b), restored.apply(b)
        assert np.array_equal(np.asarray(r1), np.asarray(r2))
        return np.asarray(restored.ranks), sorted(os.listdir(d))

    out = both(scenario)
    assert out["torch"][0][1] == out["jax"][0][1]
    assert _l1(out["torch"][0][0], out["jax"][0][0]) < L1_TOL
    c = out["torch"][1]
    # checkpoints after batches 2 and 4, and the restored session's after
    # batch 6 (the closed one keeps no journal)
    assert c["guard.checkpoint.saves"] == 3 and c["guard.restores"] == 1


def test_restore_survives_torn_journal(tmp_path, tstream_np):
    """A torn tail is dropped; the restored session equals the session
    after the last intact batch, bit for bit, and its next append follows
    the last intact record."""
    def scenario(S):
        base, batches = _tstream(S, tstream_np)
        d = str(tmp_path / S.name)
        sess = S.session(base, d_p=16, tile=64, journal_dir=d,
                         checkpoint_every=3)
        ranks = []
        for b in batches[:5]:
            sess.apply(b)
            ranks.append(np.asarray(sess.ranks).copy())
        sess.close()
        size = os.path.getsize(S.guard.journal_path(d))
        S.guard.ChaosMonkey(seed=12).truncate_journal(
            S.guard.journal_path(d), nbytes=size - 3)
        restored = S.restore(d)
        assert restored._batch_idx == 4
        assert _l1(restored.flat_ranks(), restored.static_reference()) \
            < L1_TOL
        return restored, ranks, batches

    out = both(scenario)
    restored, ranks, batches = out["torch"][0]
    np.testing.assert_array_equal(restored.ranks.numpy(), ranks[3])
    assert _l1(restored.ranks, out["jax"][0][0].ranks) < L1_TOL
    # the port cut the torn tail: batch 5 again lands as record 5, and a
    # second restore replays it (JAX's session appends after the torn
    # bytes, so its second scan stops at the tear)
    d = str(tmp_path / "torch")
    restored.apply(batches[4])
    restored.close()
    recs, truncated = tg.DeltaJournal.scan(tg.journal_path(d))
    assert not truncated and [r.seq for r in recs] == [1, 2, 3, 4, 5]
    again = ts.StreamSession.restore(d, device="cpu")
    assert torch.equal(again.ranks, restored.ranks)
    np.testing.assert_array_equal(again.ranks.numpy(), ranks[4])


def test_restore_config_fidelity(tmp_path):
    def scenario(S):
        d = str(tmp_path / S.name)
        guard = S.guard.GuardConfig(policy="quarantine", retry_budget=3,
                                    audit_every=7)
        slo = S.obs.SLOConfig(min_samples=3)
        sess = S.session(_g(S), params=S.core.PRParams(
            tau_f=1e-9, tau_p=1e-9, max_iter=321), guard=guard, slo=slo,
            journal_dir=d, checkpoint_every=1, engine="dense", d_p=32,
            tile=128, hi_headroom=3.0)
        sess.apply(S.core.random_batch(_g(S), 8, seed=50))
        sess.close()
        restored = S.restore(d)
        assert restored.params == sess.params
        assert restored.guard == guard and restored.slo == slo
        assert restored.engine == "dense"
        assert restored._d_p == 32 and restored._tile == 128
        assert restored._session_config() == sess._session_config()
        return sess._session_config()

    out = both(scenario)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][0]["slo"]["solve_p99_us"] is None  # inf in JSON


def test_journal_write_ahead_ordering(tmp_path):
    """The journal record lands before the snapshot pass: a session killed
    right after apply() has every applied batch on disk, and one whose
    snapshot pass raised has that batch on disk too."""
    def scenario(S):
        d = str(tmp_path / S.name)
        sess = S.session(_g(S), journal_dir=d, checkpoint_every=0)
        for i in range(3):
            sess.apply(S.core.random_batch(sess.snap.graph(), 8,
                                           seed=60 + i))
        sess.close()
        recs, truncated = S.guard.DeltaJournal.scan(S.guard.journal_path(d))
        assert not truncated and [r.seq for r in recs] == [1, 2, 3]
        return recs

    out = both(scenario)
    for a, b in zip(out["torch"][0], out["jax"][0]):
        for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    # the port: a snapshot pass that raises leaves the record behind
    d = str(tmp_path / "crash")
    sess = ts.StreamSession(tc.random_graph(N, M, seed=0), journal_dir=d,
                            device="cpu")

    def crash(delta):
        raise RuntimeError("crash")
    sess.snap.apply = crash
    with pytest.raises(RuntimeError, match="crash"):
        sess.apply(tc.random_batch(tc.random_graph(N, M, seed=0), 8,
                                   seed=60))
    recs, _ = tg.DeltaJournal.scan(tg.journal_path(d))
    assert [r.seq for r in recs] == [1]


def test_restore_arguments_and_failures(tmp_path):
    g = tc.random_graph(N, M, seed=0)
    with pytest.raises(ValueError, match="no journal_dir"):
        ts.StreamSession(g, device="cpu").checkpoint()
    # nothing to restore: FileNotFoundError, and a restore_failed bundle
    d = tmp_path / "empty"
    d.mkdir()
    with pytest.raises(FileNotFoundError):
        ts.StreamSession.restore(str(d), device="cpu")
    (bundle,) = d.iterdir()
    assert j_load_bundle(str(bundle))["reason"] == "restore_failed"
    # a corrupted leaf: the checksum error, and a bundle beside it
    d = tmp_path / "corrupt"
    sess = ts.StreamSession(g, journal_dir=str(d), device="cpu")
    sess.apply(tc.random_batch(g, 8, seed=1))
    path = sess.checkpoint()
    sess.close()
    leaf = os.path.join(path, "leaf_00003.npy")
    data = bytearray(open(leaf, "rb").read())
    data[-1] ^= 0xFF
    open(leaf, "wb").write(bytes(data))
    with pytest.raises(IOError, match="checksum mismatch"):
        ts.StreamSession.restore(str(d), device="cpu")
    bundles = [p for p in d.iterdir() if p.name.startswith("postmortem-")]
    assert len(bundles) == 1
    doc = tobs.load_bundle(str(bundles[0]))
    assert doc["reason"] == "restore_failed"
    assert "checksum mismatch" in doc["extra"]["error"]
    assert [e.kind for e in tobs.get_flight().events()].count(
        "guard.checkpoint") == 1
    # a single-device checkpoint refuses a mesh, as JAX's restore does
    d = tmp_path / "single"
    sess = ts.StreamSession(g, journal_dir=str(d), device="cpu")
    sess.checkpoint()
    sess.close()
    with pytest.raises(ValueError, match="single-device: mesh= given"):
        ts.StreamSession.restore(str(d), mesh=object())


# ---------------------------------------------------------------------------
# state carried across: checkpoints of one package restored by the other
# ---------------------------------------------------------------------------

def _checkpointed_stream(S, d):
    """Five batches through a guarded, journaled session that checkpoints
    every second batch: the checkpoint holds batch 4, the journal five."""
    sess = S.session(_g(S), guard=S.guard.GuardConfig(policy="quarantine",
                                                     audit_every=2),
                     journal_dir=d, checkpoint_every=2)
    for i in range(5):
        sess.apply(S.core.random_batch(sess.snap.graph(), 32, seed=70 + i))
    sess.close()
    return sess


@pytest.mark.parametrize("writer,reader", [(JAX, TORCH), (TORCH, JAX)],
                         ids=["jax_to_torch", "torch_to_jax"])
def test_checkpoint_restored_by_the_other_package(tmp_path, writer, reader):
    d = str(tmp_path)
    live = _checkpointed_stream(writer, d)
    # each package's loader reads the manifest the other wrote
    arrays_w, extra_w, step_w = writer.guard.load_session_checkpoint(d)
    arrays_r, extra_r, step_r = reader.guard.load_session_checkpoint(d)
    assert step_w == step_r == 4 and extra_w == extra_r
    assert set(arrays_w) == set(arrays_r)
    for k in arrays_w:
        assert np.asarray(arrays_r[k]).flags.writeable
        np.testing.assert_array_equal(np.asarray(arrays_w[k]),
                                      np.asarray(arrays_r[k]))
    restored = reader.restore(d)
    assert restored._batch_idx == 5
    _state_equal(live.snap, restored.snap)
    assert _l1(restored.ranks, live.ranks) < L1_TOL
    assert restored._session_config() == live._session_config()
    assert restored.guard == reader.guard.GuardConfig(policy="quarantine",
                                                      audit_every=2)
    assert reader.obs.get_registry().counter("guard.restores") == 1


def test_train_checkpoints_read_each_other(tmp_path):
    tree = {"b": np.arange(6, dtype=np.int32).reshape(2, 3),
            "a": np.linspace(0, 1, 5), "m": np.array([True, False])}
    tckpt.save_checkpoint(str(tmp_path / "t"), 7, tree, extra={"x": 1})
    jckpt.save_checkpoint(str(tmp_path / "j"), 7, tree, extra={"x": 1})
    a, b = (json.loads((tmp_path / d / "step_0000000007"
                        / "manifest.json").read_text()) for d in ("t", "j"))
    assert a.pop("time") > 0 and b.pop("time") > 0
    assert a == b
    assert a["treedef"] == "PyTreeDef({'a': *, 'b': *, 'm': *})"
    assert a["n_leaves"] == 3 and a["extra"] == {"x": 1}
    for d in ("t", "j"):
        assert tckpt.latest_step(str(tmp_path / d)) == 7
        assert tckpt.list_checkpoints(str(tmp_path / d)) == [7]
        got, extra, step = tckpt.restore_checkpoint(str(tmp_path / d), tree)
        assert step == 7 and extra == {"x": 1}
        for k in tree:
            np.testing.assert_array_equal(got[k], tree[k])
            assert got[k].dtype == tree[k].dtype
        got, _, _ = jckpt.restore_checkpoint(str(tmp_path / d), tree)
        for k in tree:
            np.testing.assert_array_equal(np.asarray(got[k]), tree[k])
    # tensors go through the host
    tckpt.save_checkpoint(str(tmp_path / "tt"), 1,
                          {k: torch.from_numpy(v) for k, v in tree.items()})
    got, _, _ = tckpt.restore_checkpoint(str(tmp_path / "tt"), tree)
    for k in tree:
        np.testing.assert_array_equal(got[k], tree[k])
    assert tckpt.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"), tree)
    # any JAX tree, not only a flat dict (a list here; model trees in
    # tests/test_torch_train.py); a bfloat16 leaf restores into a tensor
    # template only, since numpy has no bfloat16 of its own
    tckpt.save_checkpoint(str(tmp_path / "x"), 1, [np.zeros(2)])
    got, _, _ = jckpt.restore_checkpoint(str(tmp_path / "x"),
                                         [jnp.zeros(2)])
    np.testing.assert_array_equal(np.asarray(got[0]), np.zeros(2))
    tckpt.save_checkpoint(str(tmp_path / "bf"), 1,
                          {"w": torch.ones(2, dtype=torch.bfloat16)})
    with pytest.raises(TypeError):
        tckpt.restore_checkpoint(str(tmp_path / "bf"),
                                 {"w": np.zeros(2, np.float32)})
