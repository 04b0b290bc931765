"""repro_torch engines and frontier machinery against the JAX package.

Static, ND, DT, DF and DF-P run in both packages on the same graph, ranks
and batch (crossing as numpy arrays). Each port engine runs both sweeps it
has on the CPU: the plain path (`kernels=False`) and the kernel
composition `update_ranks_kernel` over the kernels' plain versions
(`kernels=True`). Bars are the reference's own:
  * a whole solve against the same `repro` engine: <= 1e-10 L-inf;
  * chained DF-P against a from-scratch static solve: L1 < 1e-8
    (tests/test_engine_parity.py, with its tau_f = tau_p = 1e-9);
  * static against `numpy_pagerank`.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core.dynamic import _loop  # noqa: E402
from repro_torch.core.frontier import (FS_COMPACT, FS_ITERS,  # noqa: E402
                                       FS_OVERFLOW, FS_PULL)
from repro_torch.guard.health import (H_MAX_ITER, describe_health,  # noqa: E402
                                      health_word)

D_P, TILE = 8, 32
SOLVE_TOL = 1e-10
CPU = dict(device="cpu")
KERNELS = pytest.mark.parametrize("kernels", [False, True],
                                  ids=["plain", "kernels"])


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _t(a):
    return torch.tensor(np.asarray(a))


class Case:
    """One graph, one batch, staged in both packages."""

    def __init__(self, seed=0, frac=0.02):
        self.g = tc.powerlaw_graph(300, 2500, seed=seed)
        gj = jc.powerlaw_graph(300, 2500, seed=seed)
        self.dg = tc.device_graph(self.g, d_p=D_P, tile=TILE, **CPU)
        self.dg_j = jc.device_graph(gj, d_p=D_P, tile=TILE)
        r, _ = jc.static_pagerank(self.dg_j, jc.init_ranks(self.g.n))
        self.r_prev = np.asarray(r)
        self.b = tc.random_batch(self.g, frac, seed=seed + 1)
        bj = jc.random_batch(gj, frac, seed=seed + 1)
        self.g2 = tc.apply_batch(self.g, self.b)
        g2j = jc.apply_batch(gj, bj)
        self.dg2 = tc.device_graph(self.g2, d_p=D_P, tile=TILE, **CPU)
        self.dg2_j = jc.device_graph(g2j, d_p=D_P, tile=TILE)
        self.fwd = tc.forward_device_graph(self.g2, d_p=D_P, tile=TILE, **CPU)
        self.fwd_j = jc.forward_device_graph(g2j, d_p=D_P, tile=TILE)
        self.db = tc.batch_to_device(self.b, self.g.n, **CPU)
        self.db_j = jc.batch_to_device(bj, self.g.n)

    def caps(self, tiny=False):
        if tiny:          # 1-entry lists: every iteration overflows
            cb = (1,) * len(self.dg2.buckets)
            return (tc.FrontierCaps(bucket=cb, hi=1, tiles=1, dn=1),
                    jc.FrontierCaps(bucket=cb, hi=1, tiles=1, dn=1))
        est = self.b.size * 4
        return tc.caps_for(self.dg2, est), jc.caps_for(self.dg2_j, est)


@pytest.fixture(scope="module")
def case():
    return Case()


# ---------------------------------------------------------------------------
# static
# ---------------------------------------------------------------------------

@KERNELS
@pytest.mark.parametrize("layout", ["bucketed", "d_p0"])
def test_static_matches_repro_and_numpy(kernels, layout):
    d_p = D_P if layout == "bucketed" else 0
    g = tc.powerlaw_graph(300, 2500, seed=6)
    dg = tc.device_graph(g, d_p=d_p, tile=TILE, **CPU)
    r, iters = tc.static_pagerank(dg, tc.init_ranks(g.n, **CPU),
                                  kernels=kernels)
    rj, iters_j = jc.static_pagerank(
        jc.device_graph(jc.powerlaw_graph(300, 2500, seed=6), d_p=d_p,
                        tile=TILE), jc.init_ranks(g.n))
    assert iters == int(iters_j)
    assert _linf(r, rj) <= SOLVE_TOL
    ref, _ = tc.numpy_pagerank(g)
    assert tc.l1_error(r, ref) < 1e-9
    assert r.shape == (g.n,) and bool(torch.isfinite(r).all())


# ---------------------------------------------------------------------------
# ND, DT, DF, DF-P — the dense form
# ---------------------------------------------------------------------------

@KERNELS
@pytest.mark.parametrize("engine", ["nd", "dt", "df", "dfp"])
def test_dynamic_engines_dense_match_repro(case, kernels, engine):
    if engine == "nd":
        r, _ = tc.nd_pagerank(case.dg2, case.r_prev, kernels=kernels)
        rj, _ = jc.nd_pagerank(case.dg2_j, jnp.asarray(case.r_prev))
    elif engine == "dt":
        r, _ = tc.dt_pagerank(case.dg2, case.dg, case.r_prev, case.db,
                              kernels=kernels)
        rj, _ = jc.dt_pagerank(case.dg2_j, case.dg_j,
                               jnp.asarray(case.r_prev), case.db_j)
    else:
        t_fn = getattr(tc, f"{engine}_pagerank")
        j_fn = getattr(jc, f"{engine}_pagerank")
        r, _ = t_fn(case.dg2, case.r_prev, case.db, kernels=kernels)
        rj, _ = j_fn(case.dg2_j, jnp.asarray(case.r_prev), case.db_j)
    assert _linf(r, rj) <= SOLVE_TOL
    ref = tc.reference_pagerank(case.g2)
    assert tc.l1_error(r, ref) < 1e-4


# ---------------------------------------------------------------------------
# DF, DF-P with frontier caps (compacted lists, push expansion, fallback)
# ---------------------------------------------------------------------------

@KERNELS
@pytest.mark.parametrize("engine", ["df", "dfp"])
@pytest.mark.parametrize("caps_kind", ["fit", "tiny", "no_fwd"])
def test_frontier_caps_match_repro_and_dense(case, kernels, engine,
                                             caps_kind):
    caps_t, caps_j = case.caps(tiny=caps_kind == "tiny")
    fwd_t = None if caps_kind == "no_fwd" else case.fwd
    fwd_j = None if caps_kind == "no_fwd" else case.fwd_j
    t_fn = getattr(tc, f"{engine}_pagerank")
    j_fn = getattr(jc, f"{engine}_pagerank")
    r, iters = t_fn(case.dg2, case.r_prev, case.db, kernels=kernels,
                    fwd=fwd_t, frontier_caps=caps_t)
    rj, iters_j = j_fn(case.dg2_j, jnp.asarray(case.r_prev), case.db_j,
                       fwd=fwd_j, frontier_caps=caps_j)
    assert _linf(r, rj) <= SOLVE_TOL
    dense, iters_d = t_fn(case.dg2, case.r_prev, case.db, kernels=kernels)
    assert _linf(r, dense) <= SOLVE_TOL
    assert iters == iters_d == int(iters_j)


def test_overflow_iterations_run_the_dense_sweep(case):
    """With 1-entry caps the lists overflow (until pruning shrinks the
    frontier to one row): those iterations run the dense sweep and the
    push worklist falls back to the dense pull; the result still equals
    the solve whose lists always fit."""
    caps, _ = case.caps(tiny=True)
    dv, dn = tc.initial_affected(case.g.n, case.db.del_src, case.db.del_dst,
                                 case.db.ins_src)
    dv = tc.expand_affected(case.dg2, dv, dn)
    r, iters, fs = _loop(case.dg2, _t(case.r_prev), dv,
                         torch.zeros_like(dn), tc.PRParams(), expand=True,
                         prune=True, closed_form=True, fwd=case.fwd,
                         caps=caps)
    assert int(fs[FS_ITERS]) == iters == int(fs[FS_COMPACT] + fs[FS_OVERFLOW])
    assert int(fs[FS_OVERFLOW]) > iters // 2 and int(fs[FS_PULL]) > 0
    caps_fit, _ = case.caps()
    r2, iters2, fs2 = _loop(case.dg2, _t(case.r_prev), dv,
                            torch.zeros_like(dn), tc.PRParams(), expand=True,
                            prune=True, closed_form=True, fwd=case.fwd,
                            caps=caps_fit)
    assert int(fs2[FS_COMPACT]) == iters2 and int(fs2[FS_OVERFLOW]) == 0
    assert _linf(r, r2) <= SOLVE_TOL


# ---------------------------------------------------------------------------
# health words
# ---------------------------------------------------------------------------

@KERNELS
@pytest.mark.parametrize("engine", ["static", "nd", "dfp", "dfp_caps"])
def test_health_words_match_repro(case, kernels, engine):
    r0 = case.r_prev
    for params in (tc.PRParams(), tc.PRParams(max_iter=1)):
        pj = jc.PRParams(max_iter=params.max_iter)
        if engine == "static":
            out = tc.static_pagerank(case.dg2, r0, params, kernels=kernels,
                                     health=True)
            out_j = jc.static_pagerank(case.dg2_j, jnp.asarray(r0), pj,
                                       health=True)
        elif engine == "nd":
            out = tc.nd_pagerank(case.dg2, r0, params, kernels=kernels,
                                 health=True)
            out_j = jc.nd_pagerank(case.dg2_j, jnp.asarray(r0), pj,
                                   health=True)
        else:
            caps_t, caps_j = case.caps() if engine == "dfp_caps" else (None,
                                                                      None)
            out = tc.dfp_pagerank(case.dg2, r0, case.db, params,
                                  kernels=kernels, fwd=case.fwd,
                                  frontier_caps=caps_t, health=True)
            out_j = jc.dfp_pagerank(case.dg2_j, jnp.asarray(r0), case.db_j,
                                    pj, fwd=case.fwd_j,
                                    frontier_caps=caps_j, health=True)
        (r, iters, hw), (rj, iters_j, hw_j) = out, out_j
        assert int(hw) == int(hw_j)
        assert iters == int(iters_j)
        assert _linf(r, rj) <= SOLVE_TOL
        if params.max_iter == 1:
            assert int(hw) & H_MAX_ITER
        else:
            assert describe_health(int(hw)) == "ok"


def test_health_word_bits():
    d = torch.tensor(1e-3, dtype=torch.float64)
    one = torch.tensor(1.0, dtype=torch.float64)
    assert int(health_word(d, 500, one, tau=1e-10, max_iter=500)) == 1
    assert int(health_word(torch.tensor(float("nan"), dtype=torch.float64),
                           1, one, tau=1e-10, max_iter=500)) == 2
    assert int(health_word(d * 0, 3, one * 1.01, tau=1e-10,
                           max_iter=500)) == 4


# ---------------------------------------------------------------------------
# chained DF-P against from-scratch static solves
# ---------------------------------------------------------------------------

@KERNELS
@pytest.mark.parametrize("compact", [False, True], ids=["dense", "caps"])
def test_chained_dfp_tracks_static(kernels, compact):
    params = tc.PRParams(tau_f=1e-9, tau_p=1e-9)
    g = tc.powerlaw_graph(300, 2500, seed=30)
    r, _ = tc.static_pagerank(tc.device_graph(g, d_p=D_P, tile=TILE, **CPU),
                              tc.init_ranks(g.n, **CPU), params)
    for k in range(3):
        b = tc.random_batch(g, 0.01, seed=40 + k)
        g = tc.apply_batch(g, b)
        dg = tc.device_graph(g, d_p=D_P, tile=TILE, **CPU)
        kw = {}
        if compact:
            kw = dict(fwd=tc.forward_device_graph(g, d_p=D_P, tile=TILE,
                                                  **CPU),
                      frontier_caps=tc.caps_for(dg, b.size * 4))
        r, _, hw = tc.dfp_pagerank(dg, r, tc.batch_to_device(b, g.n, **CPU),
                                   params, kernels=kernels, health=True, **kw)
        scratch, _ = tc.static_pagerank(dg, tc.init_ranks(g.n, **CPU),
                                        params)
        assert int(hw) == 0
        assert tc.l1_error(r, scratch) < 1e-8


# ---------------------------------------------------------------------------
# frontier building blocks against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 16, 128, 600])
def test_stream_compact_matches_repro(k):
    flags = np.random.default_rng(k).random(517) < 0.13
    idx, cnt = tc.stream_compact(_t(flags), k, fill=999)
    idx_j, cnt_j = jc.stream_compact(jnp.asarray(flags), k, fill=999)
    assert int(cnt) == int(cnt_j) == int(flags.sum())
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    assert idx.dtype == torch.int32


def test_active_frontier_and_expansion_match_repro(case):
    rng = np.random.default_rng(5)
    dv = rng.random(case.g.n) < 0.05
    dn = rng.random(case.g.n) < 0.03
    caps_t, caps_j = case.caps()
    af = tc.active_frontier(case.dg2.buckets, case.dg2.hi_ids,
                            case.dg2.hi_rowmap, _t(dv), caps_t)
    af_j = jc.active_frontier(case.dg2_j.buckets, case.dg2_j.hi_ids,
                              case.dg2_j.hi_rowmap, jnp.asarray(dv), caps_j)
    for a, b in zip(af.bucket_sel + (af.hi_sel, af.tile_sel, af.bucket_counts,
                                     af.n_rows, af.n_tiles, af.overflow),
                    af_j.bucket_sel + (af_j.hi_sel, af_j.tile_sel,
                                       af_j.bucket_counts, af_j.n_rows,
                                       af_j.n_tiles, af_j.overflow)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    r = _t(case.r_prev)
    c = r / case.dg2.out_deg.double()
    s = tc.active_pull_sum(case.dg2.buckets, case.dg2.hi_ids,
                           case.dg2.hi_tiles, case.dg2.hi_tmask,
                           case.dg2.hi_rowmap, af, c, case.g.n)
    s_j = jc.active_pull_sum(case.dg2_j.buckets, case.dg2_j.hi_ids,
                             case.dg2_j.hi_tiles, case.dg2_j.hi_tmask,
                             case.dg2_j.hi_rowmap, af_j, jnp.asarray(c),
                             case.g.n)
    assert _linf(s, s_j) <= 1e-12
    for kn in (4, 64):
        marks, ovf = tc.push_expand(case.fwd, _t(dn), kn)
        marks_j, ovf_j = jc.push_expand(case.fwd_j, jnp.asarray(dn), kn)
        assert bool(ovf) == bool(ovf_j)
        np.testing.assert_array_equal(marks.numpy(), np.asarray(marks_j))
    for ct, cj in (case.caps(), case.caps(tiny=True)):
        got, st = tc.expand_frontier(case.dg2, case.fwd, _t(dv), _t(dn), ct)
        want, st_j = jc.expand_frontier(case.dg2_j, case.fwd_j,
                                        jnp.asarray(dv), jnp.asarray(dn), cj)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(st.numpy(), np.asarray(st_j))
    np.testing.assert_array_equal(
        tc.expand_affected(case.dg2, _t(dv), _t(dn)).numpy(),
        np.asarray(jc.expand_affected(case.dg2_j, jnp.asarray(dv),
                                      jnp.asarray(dn))))


def test_initial_affected_drops_padding_like_repro(case):
    db = tc.batch_to_device(case.b, case.g.n, pad_to=64, **CPU)
    db_j = jc.batch_to_device(case.b, case.g.n, pad_to=64)
    for a, b in zip(tc.initial_affected(case.g.n, db.del_src, db.del_dst,
                                        db.ins_src),
                    jc.initial_affected(case.g.n, db_j.del_src, db_j.del_dst,
                                        db_j.ins_src)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_capacity_plans_match_repro(case):
    for est in (0, 3, 40, 10 ** 6):
        assert tc.plan_capacity(est, case.g.n) == jc.plan_capacity(
            est, case.g.n)
        assert tuple(tc.caps_for(case.dg2, est)) == tuple(
            jc.caps_for(case.dg2_j, est))
    a = tc.FrontierCaps(bucket=(8, 4), hi=16, tiles=8, dn=32)
    b = tc.FrontierCaps(bucket=(4, 16), hi=8, tiles=64, dn=16)
    assert tc.merge_caps(a, b) == tc.FrontierCaps(bucket=(8, 16), hi=16,
                                                  tiles=64, dn=32)
    assert tc.merge_caps(None, b) == b
