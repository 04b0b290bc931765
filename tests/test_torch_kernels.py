"""repro_torch kernel modules against the JAX package's Pallas kernels.

On the CPU every wrapper runs its plain PyTorch version (the CUDA kernels
are held against those same plain versions by `chip_smoke.py` on the
card); here each one must agree with the Pallas kernel it ports, run in
interpret mode as the JAX package's own tests run it. Bars are the
reference's: 1e-12 L-inf for one sweep (tests/test_bucketed_parity.py),
flags exactly equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro.kernels as jk  # noqa: E402
from repro.guard.health import H_NONFINITE as J_NONFINITE  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.guard.health import H_NONFINITE  # noqa: E402
from repro_torch.kernels import (_build, csr_block_pull, fused_ell_update,  # noqa: E402
                                 pr_update, pr_update_sweep,
                                 update_ranks_kernel)
from repro_torch.kernels.ell_bucket_pull import fused_ell_sweep  # noqa: E402
from repro_torch.kernels.ell_pull import (bucket_ints, ell_pull,  # noqa: E402
                                          ell_pull_buckets)
from repro_torch.kernels.gather_plan import PLANS, GatherPlan  # noqa: E402
from repro_torch.kernels.ref import linf_delta_ref, pr_update_ref  # noqa: E402
from repro_torch.sentinel import take_fill  # noqa: E402

D_P, TILE = 8, 32
TOL = 1e-12
STEP = dict(alpha=0.85, tau_f=1e-6, tau_p=1e-6, prune=True,
            closed_form=True)


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _t(a):
    return torch.tensor(np.asarray(a))


def _same_step(got, want):
    """(r_new, affected', delta_N, max) of one sweep: values to TOL, flags
    exactly."""
    assert _linf(got[0], want[0]) <= TOL
    np.testing.assert_array_equal(np.asarray(got[1]) > 0,
                                  np.asarray(want[1]) > 0)
    np.testing.assert_array_equal(np.asarray(got[2]) > 0,
                                  np.asarray(want[2]) > 0)
    assert abs(float(got[3]) - float(want[3])) <= TOL


def _setup(seed, **layout):
    g = tc.powerlaw_graph(300, 2500, seed=seed)
    lay = tc.build_hybrid(g, **(layout or dict(d_p=D_P, tile=TILE)))
    rng = np.random.default_rng(seed + 1)
    r = rng.random(g.n) / g.n + 1.0 / g.n
    aff = rng.random(g.n) < 0.7
    c = r / g.out_degree()
    return g, lay, rng, r, aff, c


def _with_active(cap, rng, extra=3):
    """A sorted random slot list padded with the sentinel `cap`."""
    k = max(1, cap // 3)
    sel = np.sort(rng.choice(cap, size=k, replace=False)).astype(np.int32)
    return np.concatenate([sel, np.full(extra, cap, np.int32)])


# ---------------------------------------------------------------------------
# fused_ell_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("active", [False, True])
def test_fused_ell_update_matches_pallas(active):
    g, lay, rng, r, aff, c = _setup(0)
    assert len(lay.buckets) > 1
    n = g.n
    deg = g.out_degree().astype(np.float64)
    pad = lambda x, v: np.concatenate([x, [v]])  # noqa: E731
    for blk in lay.buckets:
        ops = (c, blk.idx, blk.mask, pad(r, 1.0)[blk.rows],
               pad(deg, 1.0)[blk.rows], pad(aff.astype(np.float64), 0.0)
               [blk.rows])
        sel = _with_active(blk.cap, rng) if active else None
        kw = dict(inv_n=1.0 / n, **STEP)
        want = jk.fused_ell_update(*map(jnp.asarray, ops), **kw,
                                   active=None if sel is None
                                   else jnp.asarray(sel))
        got = fused_ell_update(*map(_t, ops), **kw,
                               active=None if sel is None else _t(sel))
        assert got[0].shape == want[0].shape
        _same_step(got, want)


# ---------------------------------------------------------------------------
# csr_block_pull
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile_sel", [False, True])
def test_csr_block_pull_matches_pallas(tile_sel):
    _, lay, rng, _, _, c = _setup(2)
    args = (c, lay.hi_tiles, lay.hi_tmask, lay.hi_rowmap)
    t_cap = lay.hi_tiles.shape[0]
    sel = _with_active(t_cap, rng) if tile_sel else None
    want = jk.csr_block_pull(*map(jnp.asarray, args), lay.n_hi_cap,
                             tile_sel=None if sel is None
                             else jnp.asarray(sel))
    got = csr_block_pull(*map(_t, args), lay.n_hi_cap,
                         tile_sel=None if sel is None else _t(sel))
    assert got.shape == (lay.n_hi_cap,)
    assert _linf(got, want) <= TOL
    if tile_sel:          # only the selected tiles' slots carry sums
        full = csr_block_pull(*map(_t, args), lay.n_hi_cap)
        assert float((got - full).abs().max()) > 0


# ---------------------------------------------------------------------------
# pr_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("closed_form", [False, True])
@pytest.mark.parametrize("prune", [False, True])
def test_pr_update_matches_pallas(closed_form, prune):
    n = 1000                                   # not a multiple of vt=256
    rng = np.random.default_rng(3)
    contrib = rng.random(n) / n
    r = rng.random(n) / n + 0.5 / n
    deg = rng.integers(1, 9, n).astype(np.float64)
    aff = (rng.random(n) < 0.6).astype(np.float64)
    kw = dict(alpha=0.85, inv_n=1.0 / n, tau_f=1e-3, tau_p=1e-3,
              prune=prune, closed_form=closed_form)
    ops = (contrib, r, deg, aff)
    want = jk.pr_update(*map(jnp.asarray, ops), vt=256, **kw)
    got = pr_update(*map(_t, ops), **kw)
    _same_step(got, want)
    assert 0 < int((got[2] > 0).sum()) < n     # the thresholds bite


# ---------------------------------------------------------------------------
# update_ranks_kernel: the three kernels composed
# ---------------------------------------------------------------------------

LAYOUTS = {"bucketed": dict(d_p=D_P, tile=TILE),
           "single": dict(d_p=D_P, tile=TILE, widths=(D_P,)),
           "d_p0": dict(d_p=0, tile=TILE)}


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_update_ranks_kernel_matches_repro_and_oracle(layout, active):
    g = tc.powerlaw_graph(250, 2000, seed=17)
    gj = jc.powerlaw_graph(250, 2000, seed=17)
    dg_t = tc.to_device(tc.build_hybrid(g, **LAYOUTS[layout]), device="cpu")
    dg_j = jc.to_device(jc.build_hybrid(gj, **LAYOUTS[layout]))
    rng = np.random.default_rng(18)
    r = rng.random(g.n) / g.n + 1.0 / g.n
    dv = rng.random(g.n) < (0.08 if active else 0.7)
    step = dict(STEP, track_frontier=True)
    af_t = af_j = None
    if active:
        est = int(dv.sum())
        af_t = tc.active_frontier(dg_t.buckets, dg_t.hi_ids, dg_t.hi_rowmap,
                                  _t(dv), tc.caps_for(dg_t, est))
        af_j = jc.active_frontier(dg_j.buckets, dg_j.hi_ids, dg_j.hi_rowmap,
                                  jnp.asarray(dv), jc.caps_for(dg_j, est))
        assert not bool(af_t.overflow)
    got = update_ranks_kernel(dg_t, _t(r), _t(dv), active=af_t, **step)
    want = jk.update_ranks_kernel(dg_j, jnp.asarray(r), jnp.asarray(dv),
                                  active=af_j, **step)
    _same_step(got, want)
    # the independent oracle: numpy pull + kernels/ref.py epilogue
    seg = np.repeat(np.arange(g.n), np.diff(g.t_offsets))
    contrib = np.bincount(seg, weights=(r / g.out_degree())[g.t_sources],
                          minlength=g.n)
    oracle = pr_update_ref(_t(contrib), _t(r), _t(g.out_degree()),
                           _t(dv.astype(np.float64)), inv_n=1.0 / g.n,
                           **STEP)
    _same_step(got, oracle)
    # and the plain engine path of the port
    _same_step(got, tc.update_ranks(dg_t, _t(r), _t(dv), kernels=False,
                                    **step))


# ---------------------------------------------------------------------------
# fused_ell_sweep: the low side of update_ranks_kernel through the row maps
# ---------------------------------------------------------------------------

def _padded(g, hi=0, **layout):
    """`build_hybrid` with 5 unused slots (row id n) in every bucket, and
    `hi` unused high slots (id n)."""
    caps = tc.hybrid_caps(tc.build_hybrid(g, **layout))
    kw = dict(layout, bucket_caps=tuple(c + 5 for c in caps["bucket_caps"]))
    if hi:
        kw["n_hi_cap"] = caps["n_hi_cap"] + hi
    return kw


SWEEP_LAYOUTS = dict(LAYOUTS, padded=None)


def _sweep_case(layout, active, hi_pad=0):
    """The inputs of `test_update_ranks_kernel_matches_repro_and_oracle`,
    plus the host layout; `padded` gives every bucket sentinel slots, and
    the high side `hi_pad` of them."""
    g = tc.powerlaw_graph(250, 2000, seed=17)
    gj = jc.powerlaw_graph(250, 2000, seed=17)
    kw = (LAYOUTS[layout] if layout != "padded"
          else _padded(g, hi=hi_pad, d_p=D_P, tile=TILE))
    lay = tc.build_hybrid(g, **kw)
    dg_t = tc.to_device(lay, device="cpu")
    dg_j = jc.to_device(jc.build_hybrid(gj, **kw))
    rng = np.random.default_rng(18)
    r = rng.random(g.n) / g.n + 1.0 / g.n
    dv = rng.random(g.n) < (0.08 if active else 0.7)
    af_t = af_j = None
    if active:
        est = int(dv.sum())
        af_t = tc.active_frontier(dg_t.buckets, dg_t.hi_ids, dg_t.hi_rowmap,
                                  _t(dv), tc.caps_for(dg_t, est))
        af_j = jc.active_frontier(dg_j.buckets, dg_j.hi_ids, dg_j.hi_rowmap,
                                  jnp.asarray(dv), jc.caps_for(dg_j, est))
        assert not bool(af_t.overflow)
    return g, lay, dg_t, dg_j, r, dv, af_t, af_j


def _live_rows(lay, sels, n):
    """[n + 1] mask of the vertex ids of every bucket's live slots (on the
    active list when there is one); id n is the unused slots' sentinel."""
    live = np.zeros(n + 1, bool)
    for bi, blk in enumerate(lay.buckets):
        slots = np.arange(blk.cap)
        if sels is not None:
            sel = sels[bi].numpy()
            slots = sel[sel < blk.cap]
        live[blk.rows[slots]] = True
    live[n] = False
    return live


def _sweep_outputs(n):
    """[n + 1] outputs holding a marker no sweep writes: -1, True, True."""
    return (torch.full((n + 1,), -1.0, dtype=torch.float64),
            torch.ones(n + 1, dtype=torch.bool),
            torch.ones(n + 1, dtype=torch.bool))


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("layout", sorted(SWEEP_LAYOUTS))
def test_fused_ell_sweep_matches_repro_on_the_low_side(layout, active):
    g, lay, dg_t, dg_j, r, dv, af_t, af_j = _sweep_case(layout, active)
    n = g.n
    want = jk.update_ranks_kernel(dg_j, jnp.asarray(r), jnp.asarray(dv),
                                  active=af_j, track_frontier=True, **STEP)
    sels = af_t.bucket_sel if active else None
    r_new, aff_new, dn = _sweep_outputs(n)
    dmax = fused_ell_sweep(_t(r) / dg_t.out_deg, dg_t.buckets, _t(r),
                           dg_t.out_deg, _t(dv), r_new, aff_new, dn,
                           bucket_sel=sels, inv_n=1.0 / n, **STEP)
    assert dmax.dim() == 0
    live = _live_rows(lay, sels, n)
    if layout == "padded":
        assert all((blk.rows == n).any() for blk in lay.buckets)
    if layout == "d_p0":           # no bucket: nothing runs, nothing moves
        assert not live.any() and float(dmax) == 0.0
        assert bool((r_new == -1.0).all()) and bool(aff_new.all())
        return
    assert live[:n].any()
    lv = torch.from_numpy(live[:n])
    got_r = r_new[:n][lv].numpy()
    want_r = np.asarray(want[0])[live[:n]]
    assert _linf(got_r, want_r) <= TOL
    np.testing.assert_array_equal(aff_new[:n][lv].numpy(),
                                  np.asarray(want[1])[live[:n]] > 0)
    np.testing.assert_array_equal(dn[:n][lv].numpy(),
                                  np.asarray(want[2])[live[:n]] > 0)
    want_max = np.max(np.abs(want_r - r[live[:n]]), initial=0.0)
    assert abs(float(dmax) - want_max) <= TOL


@pytest.mark.parametrize("active", [False, True])
def test_fused_ell_sweep_writes_nothing_for_sentinels(active):
    """Unused slots (row id n) and dead lanes of an active list (slot id
    cap_b) leave every output as it was, the sink row n included."""
    g, lay, dg_t, _, r, dv, af_t, _ = _sweep_case("padded", active)
    n = g.n
    sels = af_t.bucket_sel if active else None
    if active:
        assert any(bool((s == blk.cap).any())
                   for s, blk in zip(sels, lay.buckets))
    r_new, aff_new, dn = _sweep_outputs(n)
    fused_ell_sweep(_t(r) / dg_t.out_deg, dg_t.buckets, _t(r), dg_t.out_deg,
                    _t(dv), r_new, aff_new, dn, bucket_sel=sels,
                    inv_n=1.0 / n, **STEP)
    off = torch.from_numpy(~_live_rows(lay, sels, n))
    assert bool(off[n]) and bool((~off[:n]).any())
    assert bool((r_new[off] == -1.0).all())
    assert bool(aff_new[off].all()) and bool(dn[off].all())
    assert bool((r_new[~off] != -1.0).all())


def test_fused_ell_sweep_keeps_a_nan_rank_of_an_unaffected_row():
    g, lay, dg_t, _, r, _, _, _ = _sweep_case("bucketed", False)
    n = g.n
    v = int(lay.buckets[0].rows[0])
    r[v] = np.nan
    off = torch.zeros(n, dtype=torch.bool)
    r_new, aff_new, dn = _sweep_outputs(n)
    dmax = fused_ell_sweep(_t(r) / dg_t.out_deg, dg_t.buckets, _t(r),
                           dg_t.out_deg, off, r_new, aff_new, dn,
                           inv_n=1.0 / n, **STEP)
    assert torch.isnan(dmax) and torch.isnan(r_new[v])
    assert not bool(aff_new[v]) and not bool(dn[v])


# ---------------------------------------------------------------------------
# pr_update_sweep: the high side of update_ranks_kernel through the
# slot->vertex map
# ---------------------------------------------------------------------------

HI_PAD = 5          # unused high slots (id n) of the `padded` layout


def _hi_case(layout, active):
    """`_sweep_case` with 5 unused high slots in the `padded` layout and,
    when `active`, every other live high row flagged beside the 8% of
    rows; adds the high side's per-slot sums (`csr_block_pull`, over the
    active tiles when `active`) and its slot list."""
    g, lay, dg_t, dg_j, r, dv, af_t, af_j = _sweep_case(layout, active,
                                                        hi_pad=HI_PAD)
    if active:
        hi = lay.hi_ids[lay.hi_ids < g.n]
        dv[hi[::2]] = True
        est = int(dv.sum())
        af_t = tc.active_frontier(dg_t.buckets, dg_t.hi_ids, dg_t.hi_rowmap,
                                  _t(dv), tc.caps_for(dg_t, est))
        af_j = jc.active_frontier(dg_j.buckets, dg_j.hi_ids, dg_j.hi_rowmap,
                                  jnp.asarray(dv), jc.caps_for(dg_j, est))
        assert not bool(af_t.overflow)
    case = (g, lay, dg_t, dg_j, r, dv, af_t, af_j)
    c = _t(r) / dg_t.out_deg
    hi_sums = csr_block_pull(c, dg_t.hi_tiles, dg_t.hi_tmask, dg_t.hi_rowmap,
                             dg_t.n_hi_cap,
                             tile_sel=af_t.tile_sel if active else None)
    return case + (hi_sums, af_t.hi_sel if active else None)


def _live_hi_rows(lay, hi_sel, n):
    """[n + 1] mask of the vertex ids of the live high slots (on the list
    when there is one); id n is the unused slots' sentinel."""
    slots = np.arange(lay.n_hi_cap)
    if hi_sel is not None:
        sel = hi_sel.numpy()
        slots = sel[sel < lay.n_hi_cap]
    live = np.zeros(n + 1, bool)
    live[lay.hi_ids[slots]] = True
    live[n] = False
    return live


def _hi_sweep(hi_sums, dg_t, r, dv, hi_sel, prior, fn=None):
    """The high side into fresh marker outputs: (r_new, aff_new, dn,
    dmax)."""
    n = r.shape[0]
    outs = _sweep_outputs(n)
    dmax = (fn or pr_update_sweep)(
        hi_sums, dg_t.hi_ids, _t(r), dg_t.out_deg, _t(dv), *outs,
        hi_sel=hi_sel, prior=prior, inv_n=1.0 / n, **STEP)
    return outs + (dmax,)


def _per_slot_and_scatters(hi_sums, dg_t, r, dv, hi_sel, prior):
    """The high side as `update_ranks_kernel` composed it before the
    row-mapped entry: operands gathered per slot, the per-slot
    `pr_update`, its outputs scattered through the slot->vertex map into
    [n + 1] outputs (sentinel ids into row n), the max taken with the
    low side's."""
    n = r.shape[0]
    ids = dg_t.hi_ids
    if hi_sel is not None:
        ids = take_fill(dg_t.hi_ids, hi_sel, n)
        hi_sums = take_fill(hi_sums, hi_sel, 0.0)
    rh, ah, dh, ph = pr_update(
        hi_sums, take_fill(_t(r), ids, 1.0),
        take_fill(dg_t.out_deg, ids, 1).to(torch.float64),
        take_fill(_t(dv), ids, False).to(torch.float64), inv_n=1.0 / n,
        **STEP)
    r_new, aff_new, dn = _sweep_outputs(n)
    r_new[ids] = rh
    aff_new[ids] = ah > 0
    dn[ids] = dh > 0
    return r_new, aff_new, dn, torch.maximum(prior, ph)


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("layout", sorted(SWEEP_LAYOUTS))
def test_pr_update_sweep_matches_repro_on_the_high_side(layout, active):
    g, lay, dg_t, dg_j, r, dv, _, af_j, hi_sums, hi_sel = _hi_case(layout,
                                                                  active)
    n = g.n
    want = jk.update_ranks_kernel(dg_j, jnp.asarray(r), jnp.asarray(dv),
                                  active=af_j, track_frontier=True, **STEP)
    r_new, aff_new, dn, dmax = _hi_sweep(hi_sums, dg_t, r, dv, hi_sel,
                                         torch.zeros((), dtype=torch.float64))
    assert dmax.dim() == 0
    live = _live_hi_rows(lay, hi_sel, n)
    if layout == "padded":
        assert int((lay.hi_ids == n).sum()) >= HI_PAD
    if layout == "d_p0":           # every vertex on the high side
        assert live[:n].all() or active
    if active:
        assert bool((hi_sel == lay.n_hi_cap).any())     # dead lanes
    assert live[:n].any()
    lv = torch.from_numpy(live[:n])
    got_r = r_new[:n][lv].numpy()
    want_r = np.asarray(want[0])[live[:n]]
    assert _linf(got_r, want_r) <= TOL
    np.testing.assert_array_equal(aff_new[:n][lv].numpy(),
                                  np.asarray(want[1])[live[:n]] > 0)
    np.testing.assert_array_equal(dn[:n][lv].numpy(),
                                  np.asarray(want[2])[live[:n]] > 0)
    want_max = np.max(np.abs(want_r - r[live[:n]]), initial=0.0)
    assert abs(float(dmax) - want_max) <= TOL


@pytest.mark.parametrize("active", [False, True])
@pytest.mark.parametrize("layout", sorted(SWEEP_LAYOUTS))
def test_pr_update_sweep_equals_the_per_slot_entry_and_scatters(layout,
                                                                active):
    g, _, dg_t, _, r, dv, _, _, hi_sums, hi_sel = _hi_case(layout, active)
    n = g.n
    for prior in (0.0, 1.0):      # under and over the high side's max
        prior = torch.tensor(prior, dtype=torch.float64)
        got = _hi_sweep(hi_sums, dg_t, r, dv, hi_sel, prior)
        want = _per_slot_and_scatters(hi_sums, dg_t, r, dv, hi_sel, prior)
        for x, y in zip(got[:3], want[:3]):
            assert torch.equal(x[:n], y[:n])
        assert torch.equal(got[3], want[3])
    assert float(got[3]) == 1.0


@pytest.mark.parametrize("active", [False, True])
def test_pr_update_sweep_writes_nothing_off_the_list(active):
    """Low rows, unused high slots (id n), dead lanes of the list (slot id
    n_hi_cap) and high rows off the list leave every output as it was,
    the sink row n included."""
    g, lay, dg_t, _, r, dv, _, _, hi_sums, hi_sel = _hi_case("padded",
                                                            active)
    n = g.n
    r_new, aff_new, dn, _ = _hi_sweep(hi_sums, dg_t, r, dv, hi_sel, None)
    off = torch.from_numpy(~_live_hi_rows(lay, hi_sel, n))
    assert bool(off[n]) and bool((~off[:n]).any())
    if active:                    # some high rows are off the list
        assert bool(off[torch.from_numpy(lay.hi_ids[lay.hi_ids < n])].any())
    assert bool((r_new[off] == -1.0).all())
    assert bool(aff_new[off].all()) and bool(dn[off].all())
    assert bool((r_new[~off] != -1.0).all())


@pytest.mark.parametrize("where", ["rank", "prior"])
def test_a_nan_reaches_the_sweeps_dmax_through_the_high_side(where):
    g, lay, dg_t, _, r, dv, _, _, hi_sums, _ = _hi_case("bucketed", False)
    n = g.n
    prior = torch.tensor(0.0, dtype=torch.float64)
    if where == "rank":
        v = int(lay.hi_ids[0])
        r[v] = np.nan
        for flag in (False, True):    # affected or not: |NaN - NaN|
            dv[v] = flag
            got = _hi_sweep(hi_sums, dg_t, r, dv, None, prior)
            assert torch.isnan(got[3]) and torch.isnan(got[0][v])
        # ... and through the whole sweep
        d = update_ranks_kernel(dg_t, _t(r), _t(dv), track_frontier=True,
                                **STEP)[3]
        assert torch.isnan(d)
    else:
        prior = torch.tensor(np.nan, dtype=torch.float64)
        got = _hi_sweep(hi_sums, dg_t, r, dv, None, prior)
        assert torch.isnan(got[3]) and not bool(got[0][:n].isnan().any())


# ---------------------------------------------------------------------------
# NaN wins every max
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
def test_nan_rank_gives_nan_delta_and_nonfinite_bit(kernels):
    g = tc.powerlaw_graph(300, 2500, seed=21)
    gj = jc.powerlaw_graph(300, 2500, seed=21)
    r0 = np.full(g.n, 1.0 / g.n)
    r0[7] = np.nan
    dg_t = tc.device_graph(g, d_p=D_P, tile=TILE, device="cpu")
    r, iters, hw = tc.static_pagerank(dg_t, r0, kernels=kernels,
                                      health=True)
    rj, iters_j, hw_j = jc.static_pagerank(
        jc.device_graph(gj, d_p=D_P, tile=TILE), jnp.asarray(r0),
        health=True)
    assert iters == int(iters_j) == 1          # NaN > tau is False: one sweep
    assert int(hw) & H_NONFINITE and int(hw_j) & J_NONFINITE
    assert int(hw) == int(hw_j)
    # an unaffected NaN lane still reaches the sweep's max: |NaN - NaN|
    off = np.zeros(g.n, bool)
    d = tc.update_ranks(dg_t, _t(r0), _t(off), kernels=kernels,
                        track_frontier=True, **STEP)[3]
    dj = jc.update_ranks(jc.device_graph(gj, d_p=D_P, tile=TILE),
                         jnp.asarray(r0), jnp.asarray(off),
                         track_frontier=True, **STEP)[3]
    assert torch.isnan(d) and np.isnan(float(dj))


def test_linf_delta_ref_matches_repro_and_keeps_nan():
    from repro.kernels.ref import linf_delta_ref as j_linf_delta_ref
    rng = np.random.default_rng(4)
    a, b = rng.random(777), rng.random(777)
    assert float(linf_delta_ref(_t(a), _t(b))) == float(
        j_linf_delta_ref(jnp.asarray(a), jnp.asarray(b)))
    a[5] = np.nan
    assert torch.isnan(linf_delta_ref(_t(a), _t(b)))


# ---------------------------------------------------------------------------
# launch discipline (what can be checked without a card)
# ---------------------------------------------------------------------------

def test_wrappers_raise_on_devices_without_a_kernel():
    m = torch.device("meta")
    f64 = dict(dtype=torch.float64, device=m)
    c = torch.empty(10, **f64)
    idx = torch.zeros(4, 2, dtype=torch.int32, device=m)
    mask = torch.zeros(4, 2, dtype=torch.float32, device=m)
    v = torch.empty(4, **f64)
    kw = dict(inv_n=0.1, **STEP)
    with pytest.raises(ValueError, match="no kernel"):
        fused_ell_update(c, idx, mask, v, v, v, **kw)
    blk = tc.EllBlock(rows=idx[:, 0].contiguous(), idx=idx, mask=mask)
    deg = torch.ones(10, dtype=torch.int32, device=m)
    flags = torch.zeros(10, dtype=torch.bool, device=m)
    with pytest.raises(ValueError, match="no kernel"):
        fused_ell_sweep(c, (blk,), c, deg, flags, c.clone(), flags.clone(),
                        flags.clone(), **kw)
    with pytest.raises(ValueError, match="no kernel"):
        pr_update(v, v, v, v, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        csr_block_pull(c, idx, mask, idx[:, 0].contiguous(), 3)
    with pytest.raises(ValueError, match="no kernel"):
        ell_pull_buckets(c, (blk,))
    with pytest.raises(ValueError, match="no kernel"):
        ell_pull(c, idx, mask)


def test_pr_update_sweep_raises_where_it_has_no_kernel():
    m = torch.device("meta")
    v = torch.empty(10, dtype=torch.float64, device=m)
    ids = torch.zeros(4, dtype=torch.int32, device=m)
    deg = torch.ones(10, dtype=torch.int32, device=m)
    flags = torch.zeros(10, dtype=torch.bool, device=m)
    with pytest.raises(ValueError, match="no kernel"):
        pr_update_sweep(v[:4], ids, v, deg, flags, v.clone(), flags.clone(),
                        flags.clone(), inv_n=0.1, **STEP)


def _off_by(dtype, shape, nbytes):
    """A contiguous CPU tensor whose data starts `nbytes` past a 16-byte
    boundary."""
    numel = int(np.prod(shape))
    size = torch.empty((), dtype=dtype).element_size()
    buf = bytearray(numel * size + 32)
    base = torch.frombuffer(buf, dtype=torch.uint8).data_ptr()
    off = (16 - base % 16) % 16 + nbytes
    return torch.frombuffer(buf, dtype=dtype, offset=off,
                            count=numel).view(shape)


def test_tensor_checks_raise():
    cpu = torch.device("cpu")
    t = torch.zeros(4, 3, dtype=torch.float64)
    _build.check("x", t, torch.float64, (4, 3), cpu)
    with pytest.raises(TypeError):
        _build.check("x", t, torch.float32, (4, 3), cpu)
    with pytest.raises(ValueError, match="shape"):
        _build.check("x", t, torch.float64, (3, 4), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check("x", t.t(), torch.float64, (3, 4), cpu)
    with pytest.raises(ValueError, match="expected"):
        _build.check("x", t, torch.float64, (4, 3), torch.device("meta"))
    with pytest.raises(RuntimeError, match="error 700"):
        _build.launch_error("k", 700)
    # the gathers' tables: a table off its element size, or not contiguous,
    # is refused by both new entries' checks (`bucket_ints` for
    # ell_pull_buckets / ell_pull / the fused sweep, `check` for
    # csr_block_pull's tiles); one 4 bytes off a 16-byte boundary is taken
    # by the generic loop
    idx = _off_by(torch.int32, (6, 4), 0)
    mask = _off_by(torch.float32, (6, 4), 0)
    assert bucket_ints("t", cpu, idx, mask) == (
        6, 6, 4, PLANS.index(GatherPlan(4, 1, True)))
    assert bucket_ints("t", cpu, _off_by(torch.int32, (6, 4), 4), mask,
                       count=3) == (3, 6, 4, PLANS.index(GatherPlan(0, 4,
                                                                   False)))
    with pytest.raises(ValueError, match="misaligned"):
        bucket_ints("t", cpu, _off_by(torch.int32, (6, 4), 2), mask)
    with pytest.raises(ValueError, match="misaligned"):
        bucket_ints("t", cpu, idx, _off_by(torch.float32, (6, 4), 1))
    with pytest.raises(ValueError, match="contiguous"):
        bucket_ints("t", cpu, torch.zeros(4, 6, dtype=torch.int32).t(), mask)
    with pytest.raises(ValueError, match="bad slot table"):
        bucket_ints("t", cpu, idx[:0], mask[:0])
    tiles = _off_by(torch.int32, (3, 256), 2)
    with pytest.raises(ValueError, match="misaligned"):
        _build.check("hi_tiles", tiles, torch.int32, (3, 256), cpu)
    with pytest.raises(ValueError, match="contiguous"):
        _build.check("hi_tiles", torch.zeros(256, 3, dtype=torch.int32).t(),
                     torch.int32, (3, 256), cpu)
