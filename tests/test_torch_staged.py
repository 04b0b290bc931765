"""The staged sweep of repro_torch (`pull_sum_fn=`) against the JAX package.

`ell_pull`, `ell_bucket_pull`, `pull_sum_kernels` and `linf_delta` run on
the CPU, where each wrapper takes its plain PyTorch version (the CUDA
kernels are held against those same plain versions by `chip_smoke.py` on
the card); here each must agree with the Pallas kernel it ports, run in
interpret mode as the JAX package's own tests run it. Then every dense
engine runs with ``pull_sum_fn=pull_sum_kernels`` in both packages. Bars:
  * one pull: 1e-12 L-inf (tests/test_bucketed_parity.py's TOL);
  * `linf_delta`: exactly equal (a max of the same |a - b|), NaN kept;
  * a whole solve against the same `repro` engine: <= 1e-10 L-inf.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro.kernels as jk  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch.core.pagerank import update_ranks  # noqa: E402
from repro_torch.core.rank_step import rank_step  # noqa: E402
from repro_torch.kernels import (ell_bucket_pull, ell_pull,  # noqa: E402
                                 linf_delta, pull_sum_kernels)
from repro_torch.kernels import gather_plan  # noqa: E402
from repro_torch.kernels.ell_pull import (ell_pull_buckets,  # noqa: E402
                                          ell_pull_buckets_plain,
                                          ell_pull_plain)
from repro_torch.kernels.gather_plan import (CSR_TILE,  # noqa: E402
                                             GatherPlan, csr_plan, ell_kind,
                                             ell_plan, lanes_for)
from repro_torch.kernels.linf_delta import linf_delta_plain  # noqa: E402

D_P, TILE = 8, 32
TOL = 1e-12
SOLVE_TOL = 1e-10
CPU = dict(device="cpu")
VT = 128          # the Pallas row tile; the tables below are not multiples
KERNELS = pytest.mark.parametrize("kernels", [False, True],
                                  ids=["plain", "kernels"])
# one function object, so each jitted JAX engine compiles once per file
J_PULL = jk.pull_sum_kernels


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# ell_pull
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 2, 3, 8, 33])
def test_ell_pull_matches_pallas(width):
    """Random tables of 300 rows (not a multiple of the Pallas tile)."""
    rng = np.random.default_rng(width)
    n, rows = 500, 300
    c = rng.random(n)
    idx = rng.integers(0, n, (rows, width)).astype(np.int32)
    mask = (rng.random((rows, width)) < 0.7).astype(np.float32)
    got = ell_pull(_t(c), _t(idx), _t(mask))
    want = jk.ell_pull(jnp.asarray(c), jnp.asarray(idx), jnp.asarray(mask),
                       vt=VT, interpret=True)
    assert got.shape == (rows,)
    assert _linf(got, want) <= TOL


def test_ell_pull_per_bucket_matches_pallas():
    g = tc.powerlaw_graph(300, 2500, seed=0)
    lay = tc.build_hybrid(g, d_p=D_P, tile=TILE)
    assert len(lay.buckets) > 1
    assert any(b.idx.shape[0] % VT for b in lay.buckets)
    c = np.random.default_rng(1).random(g.n) / g.out_degree()
    for blk in lay.buckets:
        got = ell_pull(_t(c), _t(blk.idx), _t(blk.mask))
        want = jk.ell_pull(jnp.asarray(c), jnp.asarray(blk.idx),
                           jnp.asarray(blk.mask), vt=VT, interpret=True)
        assert _linf(got, want) <= TOL


def test_ell_pull_nan_reaches_the_rows_that_name_it():
    idx = torch.tensor([[0, 1], [1, 2], [2, 2]], dtype=torch.int32)
    mask = torch.tensor([[1, 0], [1, 1], [0, 0]], dtype=torch.float32)
    c = torch.tensor([float("nan"), 1.0, 2.0], dtype=torch.float64)
    out = ell_pull(c, idx, mask)
    assert torch.isnan(out[0]) and out[1] == 3.0 and out[2] == 0.0
    assert torch.equal(out.isnan(), ell_pull_plain(c, idx, mask).isnan())


# ---------------------------------------------------------------------------
# ell_bucket_pull and pull_sum_kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bucketed", "d_p0"])
def test_bucket_pull_and_pull_sum_kernels_match_repro(layout):
    d_p = D_P if layout == "bucketed" else 0
    g = tc.powerlaw_graph(300, 2500, seed=2)
    dg = tc.device_graph(g, d_p=d_p, tile=TILE, **CPU)
    dg_j = jc.device_graph(jc.powerlaw_graph(300, 2500, seed=2), d_p=d_p,
                           tile=TILE)
    assert (len(dg.buckets) > 1) == (layout == "bucketed")
    c = np.random.default_rng(3).random(g.n) / g.out_degree()
    got = ell_bucket_pull(_t(c), dg.buckets)
    want = jk.ell_bucket_pull(jnp.asarray(c), dg_j.buckets, vt=VT,
                              interpret=True)
    assert got.shape == (g.n,)
    assert _linf(got, want) <= TOL
    got = pull_sum_kernels(dg, _t(c))
    assert _linf(got, J_PULL(dg_j, jnp.asarray(c))) <= TOL
    assert _linf(got, tc.pull_sum(dg, _t(c))) <= TOL


def test_pull_sum_kernels_on_a_snapshot():
    """On a DeviceSnapshot's `.dg`, after in-place edits too."""
    g = tc.powerlaw_graph(400, 3000, seed=4)
    snap = ts.DeviceSnapshot(g, d_p=D_P, tile=TILE, **CPU)
    c = _t(np.random.default_rng(5).random(g.n))
    for step in range(3):
        ref = tc.device_graph(snap.graph(), d_p=D_P, tile=TILE, **CPU)
        assert _linf(pull_sum_kernels(snap.dg, c), tc.pull_sum(ref, c)) \
            <= TOL
        snap.apply(ts.ingest(tc.random_batch(snap.graph(), 0.02,
                                             seed=6 + step), g.n))


def _padded_layout(g):
    """d_p = D_P with 5 unused slots (row id n) in every bucket."""
    caps = tc.hybrid_caps(tc.build_hybrid(g, d_p=D_P, tile=TILE))
    return dict(d_p=D_P, tile=TILE, bucket_caps=tuple(
        c + 5 for c in caps["bucket_caps"]))


@pytest.mark.parametrize("layout", ["bucketed", "d_p0", "padded"])
def test_ell_pull_buckets_matches_pallas(layout):
    """The all-bucket entry (plain path here) against the JAX
    `ell_bucket_pull` (Pallas, interpret) over every bucket; the sink row
    n stays 0, even where the sentinel slots gather a NaN."""
    g = tc.powerlaw_graph(300, 2500, seed=2)
    kw = {"bucketed": dict(d_p=D_P, tile=TILE), "d_p0": dict(d_p=0, tile=TILE),
          "padded": _padded_layout(g)}[layout]
    lay = tc.build_hybrid(g, **kw)
    dg = tc.to_device(lay, **CPU)
    dg_j = jc.to_device(jc.build_hybrid(jc.powerlaw_graph(300, 2500, seed=2),
                                        **kw))
    c = np.random.default_rng(3).random(g.n) / g.out_degree()
    n = g.n
    if layout == "padded":
        assert all((blk.rows == n).any() for blk in lay.buckets)
        pad = lay.buckets[0]
        slot = int(np.flatnonzero(pad.rows == n)[0])
        c[int(pad.idx[slot, 0])] = np.nan
    got = ell_pull_buckets(_t(c), dg.buckets)
    want = np.asarray(jk.ell_bucket_pull(jnp.asarray(c), dg_j.buckets, vt=VT,
                                         interpret=True))
    assert got.shape == (n + 1,) and float(got[n]) == 0.0
    np.testing.assert_array_equal(got[:n].isnan().numpy(), np.isnan(want))
    live = ~np.isnan(want)
    assert _linf(got[:n].numpy()[live], want[live]) <= TOL
    assert torch.equal(got.nan_to_num(), ell_pull_buckets_plain(
        _t(c), dg.buckets).nan_to_num())
    assert torch.equal(ell_bucket_pull(_t(c), dg.buckets).nan_to_num(),
                       got[:n].nan_to_num())
    if layout == "d_p0":
        assert not dg.buckets and not bool(got.any())


def _generated_plans():
    """The plans the kernels instantiate: the rows X(kind, W, LANES, VEC)
    of the header `_build` generates (`gather_plan.header`), in kind
    order. The gather header itself lists none."""
    import pathlib
    import re
    src = (pathlib.Path(tc.__file__).resolve().parents[1] / "csrc"
           / "ell_gather.cuh").read_text()
    assert '#include "ell_plans.h"' in src
    assert "#define ELL_PLANS" not in src
    rows = re.findall(r"X\((\d+), (\d+), (\d+), (true|false)\)",
                      gather_plan.header())
    assert [int(k) for k, *_ in rows] == list(range(len(rows)))
    return [GatherPlan(int(w), int(ln), v == "true") for _, w, ln, v in rows]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("width", [1, 2, 3, 4, 6, 64])
def test_ell_plan_picks_an_instantiated_kernel(width, aligned):
    """The host's choice of the gather's path: a template at widths 1, 2,
    4 and 64 (at 4 and 64, with its 16-byte loads, only on an aligned
    table), the generic loop at lanes_for(width) otherwise; the kind the
    C entries get names that plan among those the kernels instantiate."""
    plan = ell_plan(width, aligned)
    want = {1: GatherPlan(1, 1, False), 2: GatherPlan(2, 1, False),
            3: GatherPlan(0, 2, False),
            4: GatherPlan(4, 1, True) if aligned else GatherPlan(0, 4, False),
            6: GatherPlan(0, 4, False),
            64: (GatherPlan(64, 16, True) if aligned
                 else GatherPlan(0, 32, False))}
    assert plan == want[width]
    if plan.width == 0:
        assert plan.lanes == lanes_for(width)
    table = _generated_plans()
    assert table == list(gather_plan.PLANS)
    assert table[ell_kind(width, aligned)] == plan
    for w in range(1, 130):
        p = ell_plan(w, aligned)
        assert p in table and 32 % p.lanes == 0 and p.width in (0, w)
        assert not p.vec or (aligned and w % 4 == 0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("tile", [8, 256])
def test_csr_plan_picks_the_template_at_tile_256(tile, aligned):
    assert CSR_TILE == 256
    assert f"kCsrTile = {CSR_TILE};" in gather_plan.header()
    want = (GatherPlan(256, 32, True) if tile == 256 and aligned
            else GatherPlan(0, 32, False))
    assert csr_plan(tile, aligned) == want


# ---------------------------------------------------------------------------
# linf_delta
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 2048, 2049, 5000])
def test_linf_delta_matches_pallas_exactly(n):
    rng = np.random.default_rng(n)
    a, b = rng.random(n), rng.random(n)
    got = linf_delta(_t(a), _t(b))
    assert got.dim() == 0 and got.dtype == torch.float64
    assert float(got) == float(jk.linf_delta(jnp.asarray(a), jnp.asarray(b),
                                             interpret=True))
    assert float(got) == float(np.max(np.abs(a - b)))


@pytest.mark.parametrize("side", ["a", "b"])
def test_linf_delta_keeps_nan(side):
    rng = np.random.default_rng(9)
    a, b = rng.random(3000), rng.random(3000)
    (a if side == "a" else b)[2100] = np.nan
    assert torch.isnan(linf_delta(_t(a), _t(b)))
    assert np.isnan(float(jk.linf_delta(jnp.asarray(a), jnp.asarray(b),
                                        interpret=True)))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 3, 1001])
def test_linf_delta_is_exact_at_short_lengths_and_on_offset_views(n,
                                                                   offset):
    """Short and odd lengths, and views one element (8 bytes) off the
    start, where the kernel reads a scalar head and tail around its 16-byte
    words."""
    rng = np.random.default_rng(100 + n)
    a, b = rng.random(n + 1), rng.random(n + 1)
    ta, tb = _t(a)[offset:offset + n], _t(b)[offset:offset + n]
    assert ta.storage_offset() == offset and ta.shape == (n,)
    aw, bw = a[offset:offset + n], b[offset:offset + n]
    got = linf_delta(ta, tb)
    assert float(got) == float(np.max(np.abs(aw - bw)))
    assert float(got) == float(jk.linf_delta(jnp.asarray(aw),
                                             jnp.asarray(bw),
                                             interpret=True))


def test_linf_delta_is_exact_on_views_at_different_offsets():
    """a one element off the start, b not: the kernel's 8-byte loop."""
    rng = np.random.default_rng(31)
    a, b = rng.random(2001), rng.random(2001)
    got = linf_delta(_t(a)[1:], _t(b)[:2000])
    assert float(got) == float(np.max(np.abs(a[1:] - b[:2000])))


@pytest.mark.parametrize("at", [0, -1])
def test_linf_delta_keeps_a_nan_at_the_head_or_tail_of_a_view(at):
    rng = np.random.default_rng(32)
    a, b = rng.random(1002), rng.random(1002)
    a[1:1001][at] = np.nan      # the scalar head or tail on the card
    assert torch.isnan(linf_delta(_t(a)[1:1001], _t(b)[1:1001]))


def test_new_wrappers_raise_where_they_have_no_kernel():
    m = torch.device("meta")
    v = torch.empty(4, dtype=torch.float64, device=m)
    idx = torch.zeros(4, 2, dtype=torch.int32, device=m)
    mask = torch.zeros(4, 2, dtype=torch.float32, device=m)
    with pytest.raises(ValueError, match="no kernel"):
        ell_pull(v, idx, mask)
    with pytest.raises(ValueError, match="no kernel"):
        linf_delta(v, v)
    empty = torch.zeros(0, dtype=torch.float64)
    with pytest.raises(RuntimeError):
        linf_delta(empty, empty)
    with pytest.raises(RuntimeError):
        linf_delta_plain(empty, empty)


# ---------------------------------------------------------------------------
# the staged sweep
# ---------------------------------------------------------------------------

def test_rank_step_takes_its_linf_from_outside():
    rng = np.random.default_rng(10)
    n = 200
    s, r = _t(rng.random(n) / n), _t(rng.random(n) / n)
    aff = _t(rng.random(n) < 0.6)
    deg = _t(rng.integers(1, 9, n).astype(np.int32))
    kw = dict(alpha=0.85, n_norm=n, tau_f=1e-6, tau_p=1e-6, prune=True,
              closed_form=True, track_frontier=True)
    calls = []

    def linf_fn(a, b):
        calls.append(1)
        return linf_delta(a, b)
    want = rank_step(s, r, aff, deg, **kw)
    got = rank_step(s, r, aff, deg, linf_fn=linf_fn, **kw)
    assert calls == [1]
    for x, y in zip(got, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("layout", ["bucketed", "d_p0"])
def test_staged_sweep_equals_the_fused_and_plain_sweeps(layout):
    g = tc.powerlaw_graph(300, 2500, seed=11)
    dg = tc.device_graph(g, d_p=D_P if layout == "bucketed" else 0,
                         tile=TILE, **CPU)
    rng = np.random.default_rng(12)
    r = _t(rng.random(g.n) / g.n + 0.5 / g.n)
    aff = _t(rng.random(g.n) < 0.7)
    kw = dict(alpha=0.85, tau_f=1e-6, tau_p=1e-6, prune=True,
              closed_form=True, track_frontier=True)
    plain = update_ranks(dg, r, aff, kernels=False, **kw)
    fused = update_ranks(dg, r, aff, kernels=True, **kw)
    for kernels in (False, True):
        staged = update_ranks(dg, r, aff, kernels=kernels,
                              pull_sum_fn=pull_sum_kernels, **kw)
        for want in (plain, fused):
            assert _linf(staged[0], want[0]) <= TOL
            assert torch.equal(staged[1], want[1])
            assert torch.equal(staged[2], want[2])
            assert abs(float(staged[3]) - float(want[3])) <= TOL
        assert float(staged[3]) == float((staged[0] - r).abs().max())


class Case:
    """One graph and one batch, staged in both packages."""

    def __init__(self, seed=0, frac=0.02):
        self.g = tc.powerlaw_graph(300, 2500, seed=seed)
        gj = jc.powerlaw_graph(300, 2500, seed=seed)
        self.dg = tc.device_graph(self.g, d_p=D_P, tile=TILE, **CPU)
        self.dg_j = jc.device_graph(gj, d_p=D_P, tile=TILE)
        r, _ = jc.static_pagerank(self.dg_j, jc.init_ranks(self.g.n))
        self.r_prev = np.asarray(r)
        b = tc.random_batch(self.g, frac, seed=seed + 1)
        bj = jc.random_batch(gj, frac, seed=seed + 1)
        g2, g2j = tc.apply_batch(self.g, b), jc.apply_batch(gj, bj)
        self.dg2 = tc.device_graph(g2, d_p=D_P, tile=TILE, **CPU)
        self.dg2_j = jc.device_graph(g2j, d_p=D_P, tile=TILE)
        self.fwd = tc.forward_device_graph(g2, d_p=D_P, tile=TILE, **CPU)
        self.fwd_j = jc.forward_device_graph(g2j, d_p=D_P, tile=TILE)
        self.db = tc.batch_to_device(b, self.g.n, **CPU)
        self.db_j = jc.batch_to_device(bj, self.g.n)
        self.size = b.size


@pytest.fixture(scope="module")
def case():
    return Case()


def _run(case, engine, kernels, *, torch_side: bool):
    """One engine with the kernel-backed pull in one package."""
    if torch_side:
        mod, pull = tc, dict(pull_sum_fn=pull_sum_kernels, kernels=kernels)
        dg, dg0, r0, db, fwd = (case.dg2, case.dg, case.r_prev, case.db,
                                case.fwd)
    else:
        mod, pull = jc, dict(pull_sum_fn=J_PULL)
        dg, dg0, r0, db, fwd = (case.dg2_j, case.dg_j,
                                jnp.asarray(case.r_prev), case.db_j,
                                case.fwd_j)
    if engine == "static":
        return mod.static_pagerank(dg, r0, **pull)
    if engine == "nd":
        return mod.nd_pagerank(dg, r0, **pull)
    if engine == "dt":
        return mod.dt_pagerank(dg, dg0, r0, db, **pull)
    name, _, caps_kind = engine.partition("_")
    fn = getattr(mod, f"{name}_pagerank")
    if not caps_kind:
        return fn(dg, r0, db, **pull)
    n_b = len(case.dg2.buckets)
    if caps_kind == "tiny":       # 1-entry lists: iterations overflow
        caps = mod.FrontierCaps(bucket=(1,) * n_b, hi=1, tiles=1, dn=1)
    else:
        caps = mod.caps_for(dg, case.size * 4)
    return fn(dg, r0, db, fwd=fwd, frontier_caps=caps, **pull)


@KERNELS
@pytest.mark.parametrize("engine", ["static", "nd", "dt", "df", "dfp",
                                    "df_fit", "dfp_fit", "df_tiny",
                                    "dfp_tiny"])
def test_engines_with_pull_sum_kernels_match_repro(case, kernels, engine):
    r, iters = _run(case, engine, kernels, torch_side=True)
    rj, iters_j = _run(case, engine, kernels, torch_side=False)
    assert _linf(r, rj) <= SOLVE_TOL
    assert r.shape == (case.g.n,) and bool(torch.isfinite(r).all())
    # the same solve on the fused sweep
    if engine == "static":
        ref, iters_f = tc.static_pagerank(case.dg2, case.r_prev,
                                          kernels=kernels)
        assert iters == iters_f
        assert _linf(r, ref) <= SOLVE_TOL


def test_staged_health_word_and_output_order(case):
    r, iters, tb, hw = tc.dfp_pagerank(
        case.dg2, case.r_prev, case.db, kernels=True,
        pull_sum_fn=pull_sum_kernels, trace=True, health=True)
    assert int(hw) == 0
    assert int(tb.engine) == 4 and 0 < iters < tb.cap
    rj, iters_j, hw_j = jc.dfp_pagerank(case.dg2_j, jnp.asarray(case.r_prev),
                                        case.db_j, pull_sum_fn=J_PULL,
                                        health=True)
    assert int(hw_j) == 0
    assert _linf(r, rj) <= SOLVE_TOL


@pytest.mark.parametrize("caps_kind", ["fit", "tiny"])
def test_only_overflow_iterations_take_the_staged_pull(case, caps_kind):
    """With frontier caps the staged pull runs exactly on the iterations
    whose lists overflow (the dense sweep), as in the JAX loop."""
    calls = []

    def counted(dg, c):
        calls.append(1)
        return pull_sum_kernels(dg, c)
    n_b = len(case.dg2.buckets)
    caps = (tc.FrontierCaps(bucket=(1,) * n_b, hi=1, tiles=1, dn=1)
            if caps_kind == "tiny" else tc.caps_for(case.dg2, case.size * 4))
    r, iters = tc.dfp_pagerank(case.dg2, case.r_prev, case.db, fwd=case.fwd,
                               frontier_caps=caps, pull_sum_fn=counted)
    if caps_kind == "fit":
        assert calls == []
    else:
        assert 0 < len(calls) <= iters
    ref, _ = tc.dfp_pagerank(case.dg2, case.r_prev, case.db)
    assert _linf(r, ref) <= SOLVE_TOL
