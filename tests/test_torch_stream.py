"""repro_torch.stream against the JAX package's repro.stream, on the CPU.

The same deltas go through both packages' snapshots and sessions (batches
cross as numpy arrays). Bars:
  * `scatter_rows`, `ingest`, `validate_batch`, every snapshot mirror, free
    list and device tensor: exactly equal;
  * the engines on a snapshot: <= 1e-10 L-inf against the same `repro`
    engine, <= 1e-12 L1 against the port's own dense engine;
  * session ranks: L1 <= 1e-8 against the JAX session and against a
    from-scratch static solve (tests/test_stream.py's bar). Iteration
    counts are not compared: near tau they change from run to run.
On the CPU every kernel wrapper runs its plain PyTorch version; the CUDA
kernels are held against those by `chip_smoke.py` on the card.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro.stream as js  # noqa: E402
from repro.core import compact as jcompact  # noqa: E402
from repro.guard.validate import ValidationError as JValidationError  # noqa: E402
from repro.guard.validate import validate_batch as j_validate  # noqa: E402
from repro.kernels import scatter_rows as j_scatter_rows  # noqa: E402
import repro_torch.core as tc  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch.core import compact as tcompact  # noqa: E402
from repro_torch.core.pagerank import slot_tile_table  # noqa: E402
from repro_torch.guard import ValidationError, validate_batch  # noqa: E402
from repro_torch.kernels import ell_scatter_rows, scatter_rows  # noqa: E402
from repro_torch.kernels.stream_scatter import scatter_rows_batch  # noqa: E402

CAPS = dict(d_p=8, tile=32)
CPU = dict(device="cpu")
SOLVE_TOL = 1e-10
L1_TOL = 1e-8


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _empty():
    return np.zeros(0, np.int32)


def _batch(del_src=None, del_dst=None, ins_src=None, ins_dst=None):
    a = [np.asarray(x, np.int32) if x is not None else _empty()
         for x in (del_src, del_dst, ins_src, ins_dst)]
    return tc.BatchUpdate(*a)


def _jbatch(b):
    return jc.BatchUpdate(del_src=b.del_src, del_dst=b.del_dst,
                          ins_src=b.ins_src, ins_dst=b.ins_dst)


# ---------------------------------------------------------------------------
# scatter_rows (plain on the CPU) against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_scatter_rows_matches_pallas(dtype):
    rng = np.random.default_rng(11)
    dst = rng.integers(0, 100, (40, 8)).astype(dtype)
    rows = np.array([3, 17, 39, 3, 3], np.int32)   # pad: repeat row 0
    new = rng.integers(0, 100, (5, 8)).astype(dtype)
    new[3] = new[0]
    new[4] = new[0]
    want = j_scatter_rows(jnp.asarray(dst), jnp.asarray(rows),
                          jnp.asarray(new), interpret=True)
    t = torch.from_numpy(dst.copy())
    got = scatter_rows(t, torch.from_numpy(rows), torch.from_numpy(new))
    assert got is t                                  # written in place
    np.testing.assert_array_equal(t.numpy(), np.asarray(want))
    assert t.dtype == torch.from_numpy(dst).dtype


def test_ell_scatter_rows_matches_pallas_pair():
    rng = np.random.default_rng(12)
    idx = rng.integers(0, 50, (16, 4)).astype(np.int32)
    mask = (rng.random((16, 4)) < 0.5).astype(np.float32)
    rows = np.array([0, 15, 7, 0], np.int32)
    new_i = rng.integers(0, 50, (4, 4)).astype(np.int32)
    new_m = (rng.random((4, 4)) < 0.5).astype(np.float32)
    new_i[3], new_m[3] = new_i[0], new_m[0]
    wi, wm = js.snapshot._scatter_pair(
        jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(rows),
        jnp.asarray(new_i), jnp.asarray(new_m))
    from repro.kernels import ell_scatter_rows as j_pair
    pi, pm = j_pair(jnp.asarray(idx), jnp.asarray(mask), jnp.asarray(rows),
                    jnp.asarray(new_i), jnp.asarray(new_m), interpret=True)
    ti, tm = torch.from_numpy(idx.copy()), torch.from_numpy(mask.copy())
    gi, gm = ell_scatter_rows(ti, tm, torch.from_numpy(rows),
                              torch.from_numpy(new_i),
                              torch.from_numpy(new_m))
    assert gi is ti and gm is tm
    for want_i, want_m in ((wi, wm), (pi, pm)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(want_m))


def test_scatter_wrappers_never_fall_back_off_the_cpu():
    m = torch.device("meta")
    dst = torch.empty(8, 4, dtype=torch.int32, device=m)
    msk = torch.empty(8, 4, dtype=torch.float32, device=m)
    rows = torch.zeros(2, dtype=torch.int32, device=m)
    new = torch.empty(2, 4, dtype=torch.int32, device=m)
    new_m = torch.empty(2, 4, dtype=torch.float32, device=m)
    with pytest.raises(ValueError, match="no kernel"):
        scatter_rows(dst, rows, new)
    with pytest.raises(ValueError, match="no kernel"):
        ell_scatter_rows(dst, msk, rows, new, new_m)
    with pytest.raises(TypeError, match="int32 idx"):
        ell_scatter_rows(msk, dst, rows, new_m, new)


def test_next_pow2_is_exported_and_matches_repro():
    from repro_torch.stream import next_pow2
    assert "next_pow2" in ts.__all__
    for floor in (1, 2, 16, 64):
        for x in list(range(-2, 70)) + [1000, 1023, 1024, 1025, 2 ** 20 + 1]:
            assert next_pow2(x, floor) == js.next_pow2(x, floor), (x, floor)
    assert next_pow2(5) == js.next_pow2(5)


@pytest.mark.parametrize("pair", [False, True], ids=["single", "pair"])
def test_scatter_rows_batch_matches_pallas_table_by_table(pair):
    """One batched call over tables of widths 4, 8, 16, 64 and 256 (row
    counts and dtypes differing) against the Pallas kernels applied to
    each table in turn; every table repeats its first row id as a pad row
    with identical contents."""
    from repro.kernels import ell_scatter_rows as j_pair
    rng = np.random.default_rng(13)
    tables, wants = [], []
    for t, d in enumerate((4, 8, 16, 64, 256)):
        n_rows, k = 30 + 7 * t, 3 + t
        idx = rng.integers(0, 99, (n_rows, d)).astype(np.int32)
        mask = (rng.random((n_rows, d)) < 0.5).astype(np.float32)
        rows = rng.choice(n_rows, k, replace=False).astype(np.int32)
        rows = np.concatenate([rows, rows[:1]])
        new_i = rng.integers(0, 99, (k + 1, d)).astype(np.int32)
        new_m = (rng.random((k + 1, d)) < 0.5).astype(np.float32)
        new_i[-1], new_m[-1] = new_i[0], new_m[0]
        if pair:
            want = j_pair(*map(jnp.asarray, (idx, mask, rows, new_i, new_m)),
                          interpret=True)
            tables.append((torch.from_numpy(idx.copy()),
                           torch.from_numpy(mask.copy()),
                           torch.from_numpy(rows), torch.from_numpy(new_i),
                           torch.from_numpy(new_m)))
        else:                  # single tables, int32 and float32 in turn
            dst, new = (idx, new_i) if t % 2 == 0 else (mask, new_m)
            want = (j_scatter_rows(jnp.asarray(dst), jnp.asarray(rows),
                                   jnp.asarray(new), interpret=True),)
            tables.append((torch.from_numpy(dst.copy()), None,
                           torch.from_numpy(rows), torch.from_numpy(new),
                           None))
        wants.append(want)
    scatter_rows_batch(tables)
    for tab, want in zip(tables, wants):
        got = (tab[0],) if tab[1] is None else tab[:2]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scatter_rows_batch_plain_refuses_an_out_of_range_id():
    """The plain version raises on a row id outside [0, R) (the kernel
    drops that row, checked on the card); an empty batch does nothing."""
    dst = torch.zeros(6, 4, dtype=torch.int32)
    new = torch.ones(2, 4, dtype=torch.int32)
    for bad in (6, -7):
        with pytest.raises(IndexError):
            scatter_rows_batch([(dst, None, torch.tensor([1, bad],
                                                         dtype=torch.int32),
                                 new, None)])
    scatter_rows_batch([])


def test_scatter_rows_batch_never_falls_back_off_the_cpu():
    m = torch.device("meta")
    dst = torch.empty(8, 4, dtype=torch.int32, device=m)
    rows = torch.zeros(2, dtype=torch.int32, device=m)
    new = torch.empty(2, 4, dtype=torch.int32, device=m)
    with pytest.raises(ValueError, match="no kernel"):
        scatter_rows_batch([(dst, None, rows, new, None)])


# ---------------------------------------------------------------------------
# ingest + validation
# ---------------------------------------------------------------------------

def _same_delta(a, b):
    assert a.n == b.n
    for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y)


INGEST_CASES = {
    "dups_and_self_loops": _batch([1, 1, 3, 5], [2, 2, 3, 5], [4, 4, 6],
                                  [5, 5, 6]),
    "both_lists": _batch([1, 2, 7], [2, 3, 8], [1, 9, 2], [2, 9, 3]),
    "empty": _batch(),
}


@pytest.mark.parametrize("coalesce", ["del_first", "cancel"])
@pytest.mark.parametrize("case", sorted(INGEST_CASES) + ["random"])
def test_ingest_matches_repro(case, coalesce):
    if case == "random":
        g = tc.random_graph(60, 500, seed=2)
        b = tc.random_batch(g, 0.1, seed=3)
        b = tc.BatchUpdate(np.concatenate([b.del_src, b.ins_src[:5]]),
                           np.concatenate([b.del_dst, b.ins_dst[:5]]),
                           np.concatenate([b.ins_src, b.ins_src[:7]]),
                           np.concatenate([b.ins_dst, b.ins_dst[:7]]))
        n = g.n
    else:
        b, n = INGEST_CASES[case], 10
    d = ts.ingest(b, n, coalesce=coalesce)
    _same_delta(d, js.ingest(_jbatch(b), n, coalesce=coalesce))
    db, dbj = d.to_device(**CPU), js.ingest(_jbatch(b), n,
                                            coalesce=coalesce).to_device()
    for x, y in zip(db, dbj):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert d.to_device(pad_to=64, **CPU).ins_src.shape == (64,)


def test_ingest_rejects_a_bogus_coalesce_mode_like_repro():
    b = INGEST_CASES["both_lists"]
    with pytest.raises(ValueError):
        ts.ingest(b, 10, coalesce="bogus")
    with pytest.raises(ValueError):
        js.ingest(_jbatch(b), 10, coalesce="bogus")


BAD_BATCHES = {
    "out_of_range": _batch([1, 12], [2, 3], [4, -1, 5], [5, 6, 10]),
    "clean": _batch([1], [2], [3], [4]),
}


@pytest.mark.parametrize("policy", ["raise", "quarantine"])
@pytest.mark.parametrize("case", sorted(BAD_BATCHES))
def test_validate_batch_matches_repro(case, policy):
    b = BAD_BATCHES[case]
    try:
        want = j_validate(_jbatch(b), 10, policy=policy)
    except JValidationError as e:
        with pytest.raises(ValidationError) as got:
            validate_batch(b, 10, policy=policy)
        assert str(got.value) == str(e)
        return
    clean, rep = validate_batch(b, 10, policy=policy)
    for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
        np.testing.assert_array_equal(getattr(clean, f),
                                      getattr(want[0], f))
        np.testing.assert_array_equal(getattr(rep, f), getattr(want[1], f))
    assert rep.size == want[1].size and bool(rep) == bool(want[1])


@pytest.mark.parametrize("bad", ["shape", "length", "float", "policy"])
def test_validate_batch_structural_errors_match_repro(bad):
    b = {"shape": tc.BatchUpdate(np.zeros((2, 2), np.int32), _empty(),
                                 _empty(), _empty()),
         "length": _batch([1, 2], [3], None, None),
         "float": tc.BatchUpdate(np.zeros(1, np.float64),
                                 np.zeros(1, np.float64), _empty(),
                                 _empty()),
         "policy": _batch()}[bad]
    policy = "lenient" if bad == "policy" else "raise"
    err = ValueError if bad == "policy" else ValidationError
    jerr = ValueError if bad == "policy" else JValidationError
    with pytest.raises(err) as got:
        validate_batch(b, 10, policy=policy)
    with pytest.raises(jerr) as want:
        j_validate(_jbatch(b), 10, policy=policy)
    assert str(got.value) == str(want.value)


def test_graph_from_sorted_keys_identical():
    g = tc.powerlaw_graph(300, 2500, seed=5)
    src, dst = g.edges()
    keys = np.sort(tc.edge_keys(g.n, src, dst))
    a, b = tc.graph_from_sorted_keys(g.n, keys), \
        jc.graph_from_sorted_keys(g.n, keys)
    for f in ("offsets", "targets", "t_offsets", "t_sources"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, getattr(g, f))


# ---------------------------------------------------------------------------
# DeviceSnapshot: mirrors, free lists and device tensors against repro
# ---------------------------------------------------------------------------

MIRRORS = ("bucket_of", "slot_of", "hi_tiles", "hi_tmask", "hi_rowmap",
           "hi_ids", "is_low", "row_deg", "hi_slot")
DEVICE = ("bucket_of", "slot_of", "hi_tiles", "hi_tmask", "hi_rowmap",
          "hi_ids", "is_low")


def _eq(x, y, what):
    x, y = _np(x), _np(y)
    assert x.dtype == y.dtype, what
    np.testing.assert_array_equal(x, y, err_msg=what)


def _port_device_matches_mirrors(sp):
    """Every device tensor of both halves equals its own host mirror,
    including the slot->tile table and the two degree vectors."""
    for h in (sp._pull, sp._fwd):
        for bi in range(len(h.widths)):
            for f in ("bk_rows", "bk_idx", "bk_mask"):
                _eq(getattr(h, "dev_" + f)[bi], getattr(h, f)[bi], f)
        for f in DEVICE:
            _eq(getattr(h, "dev_" + f), getattr(h, f), f)
        tiles, off = slot_tile_table(h.hi_rowmap, h.hi_ids.shape[0])
        _eq(h.dev_hi_slot_tiles, tiles, "hi_slot_tiles")
        _eq(h.dev_hi_slot_off, off, "hi_slot_off")
    _eq(sp._dev_outdeg, sp._outdeg.astype(np.int32), "outdeg")
    _eq(sp._dev_indeg, sp._indeg.astype(np.int32), "indeg")
    for dg in (sp.dg, sp.fwd_dg):
        assert dg.hi_slot_tiles.shape == dg.hi_rowmap.shape


def _same_snapshot(sp, sj):
    """Port and JAX snapshots array-equal: keys, degrees, capacities, both
    halves' mirrors, free lists (in order) and device tensors."""
    _eq(sp._keys, sj._keys, "keys")
    _eq(sp._indeg, sj._indeg, "indeg")
    _eq(sp._outdeg, sj._outdeg, "outdeg")
    assert sp._caps == sj._caps
    for hp, hj in ((sp._pull, sj._pull), (sp._fwd, sj._fwd)):
        assert hp.widths == hj.widths
        for f in MIRRORS:
            _eq(getattr(hp, f), getattr(hj, f), f)
        for bi in range(len(hp.widths)):
            for f in ("bk_rows", "bk_idx", "bk_mask"):
                _eq(getattr(hp, f)[bi], getattr(hj, f)[bi], f)
                _eq(getattr(hp, "dev_" + f)[bi], getattr(hj, "dev_" + f)[bi],
                    "dev_" + f)
        for f in DEVICE:
            _eq(getattr(hp, "dev_" + f), getattr(hj, "dev_" + f), f)
        assert hp.free_bslots == hj.free_bslots
        assert hp.free_tiles == hj.free_tiles
        assert hp.free_slots == hj.free_slots
        assert hp.slot_tiles == hj.slot_tiles
        assert hp.migrations == hj.migrations
        assert hp.low_water == hj.low_water
    _eq(sp._dev_outdeg, sj._dev_outdeg, "dev_outdeg")
    _eq(sp._dev_indeg, sj._dev_indeg, "dev_indeg")
    _port_device_matches_mirrors(sp)


def _stats(st):
    d = dataclasses.asdict(st)
    del d["host_s"], d["device_s"]
    return d


def _hub_batches():
    """Twenty in-edges onto hub 7 in four batches (ELL -> tiles, tiles
    allocated), then nineteen deleted (tiles freed, back to the ELL)."""
    srcs = np.arange(8, 28, dtype=np.int32)
    out = [_batch(ins_src=srcs[k:k + 5], ins_dst=np.full(5, 7))
           for k in range(0, 20, 5)]
    out.append(_batch(del_src=srcs[:19], del_dst=np.full(19, 7)))
    return out


def _scenario(name):
    """(graph builder, snapshot kwargs, batch list, what must happen)."""
    no_rebuild = dict(rebuild_threshold=2.0, frag_budget=2.0)
    if name == "churn":
        g = tc.powerlaw_graph(800, 8000, seed=1)
        gg, bs = g, []
        for t in range(3):
            bs.append(tc.random_batch(gg, 0.01, seed=100 + t))
            gg = tc.apply_batch(gg, bs[-1])
        return (("powerlaw_graph", (800, 8000), dict(seed=1)), CAPS, bs)
    if name == "crossing":
        return (("build_graph", (64, np.array([0, 1], np.int32),
                                 np.array([2, 3], np.int32)), {}),
                dict(d_p=4, tile=8, low_water=2, **no_rebuild),
                _hub_batches())
    if name == "hysteresis":
        srcs = np.arange(8, 14, dtype=np.int32)
        return (("build_graph", (32, _empty(), _empty()), {}),
                dict(d_p=4, tile=8, low_water=1, **no_rebuild),
                [_batch(ins_src=srcs, ins_dst=np.full(6, 3)),
                 _batch(del_src=srcs[:3], del_dst=np.full(3, 3)),
                 _batch(ins_src=[1, 2], ins_dst=[9, 9])])
    if name == "capacity":
        srcs = np.unique(np.arange(1, 1 + 8 * 8 + 8) % 128)
        srcs = srcs[srcs != 5]
        return (("build_graph", (128, _empty(), _empty()), {}),
                dict(d_p=4, tile=8, hi_headroom=1.0, tile_headroom=1.0,
                     rebuild_threshold=1.1),
                [_batch(ins_src=srcs, ins_dst=np.full(srcs.size, 5)),
                 _batch(del_src=srcs[:4], del_dst=np.full(4, 5)),
                 _batch(ins_src=[3, 4], ins_dst=[6, 6])])
    assert name == "batch_too_large"
    g = tc.powerlaw_graph(500, 4000, seed=6)
    return (("powerlaw_graph", (500, 4000), dict(seed=6)),
            dict(CAPS, rebuild_threshold=0.01),
            [tc.random_batch(g, 0.2, seed=7), tc.random_batch(g, 1e-3, seed=8),
             tc.random_batch(g, 1e-3, seed=9)])


@pytest.mark.parametrize("name", ["churn", "crossing", "hysteresis",
                                  "capacity", "batch_too_large"])
def test_snapshot_matches_repro_after_every_batch(name):
    (builder, args, kw), snap_kw, batches = _scenario(name)
    g = getattr(tc, builder)(*args, **kw)
    sp = ts.DeviceSnapshot(g, **snap_kw, **CPU)
    sj = js.DeviceSnapshot(getattr(jc, builder)(*args, **kw), **snap_kw)
    _same_snapshot(sp, sj)
    stats, gg = [], g
    for b in batches:
        st = sp.apply(ts.ingest(b, g.n))
        stj = sj.apply(js.ingest(_jbatch(b), g.n))
        assert _stats(st) == _stats(stj)
        stats.append(st)
        _same_snapshot(sp, sj)
        gg = tc.apply_batch(gg, b)
        src, dst = gg.edges()
        _eq(sp._keys, np.sort(tc.edge_keys(g.n, src, dst)), "keys vs oracle")
    rebuilds = [s.rebuild_reason for s in stats if s.rebuilt]
    if name == "capacity":
        assert rebuilds and rebuilds[0].startswith("capacity")
        assert sp._caps["t_cap"] > 8
    elif name == "batch_too_large":
        assert rebuilds[:1] == ["batch_too_large"]
    else:
        assert rebuilds == []
    if name == "crossing":                    # up to the tiles and back
        assert not stats[1].rebuilt and bool(sp._pull.is_low[7])
        assert sum(s.migrations for s in stats) >= 2
        assert len(sp._pull.free_tiles) == sp._caps["t_cap"]
    if name == "hysteresis":                  # parked on the tile side
        assert not bool(sp._pull.is_low[3]) and sp.fragmentation() > 0.0
    # the maintained layouts pull exactly what a fresh build pulls
    c = torch.from_numpy(np.random.default_rng(3).random(g.n))
    d_p, tile = snap_kw["d_p"], snap_kw["tile"]
    for dg, ref in ((sp.dg, gg), (sp.fwd_dg, gg.transpose())):
        want = tc.pull_sum(tc.device_graph(ref, d_p=d_p, tile=tile, **CPU), c)
        assert _linf(tc.pull_sum(dg, c), want) <= 1e-12


def test_slot_tile_table_follows_tile_alloc_and_free():
    """The port's extra DeviceGraph fields track hi_rowmap through tile
    allocation and freeing (the kernel's per-slot sum reads them)."""
    sp = ts.DeviceSnapshot(tc.build_graph(64, np.array([0], np.int32),
                                          np.array([1], np.int32)),
                           d_p=4, tile=8, low_water=2, rebuild_threshold=2.0,
                           frag_budget=2.0, **CPU)
    seen = []
    for b in _hub_batches():
        sp.apply(ts.ingest(b, 64))
        tiles, off = slot_tile_table(sp._pull.hi_rowmap, sp.dg.n_hi_cap)
        _eq(sp.dg.hi_slot_tiles, tiles, "hi_slot_tiles")
        _eq(sp.dg.hi_slot_off, off, "hi_slot_off")
        seen.append(len(sp._pull.slot_tiles[int(sp._pull.hi_slot[7])])
                    if sp._pull.hi_slot[7] >= 0 else 0)
    assert max(seen) == 3 and seen[-1] == 0     # allocated, then all freed


def test_load_state_from_repro_state_dict():
    g = tc.powerlaw_graph(400, 3000, seed=24)
    gj = jc.powerlaw_graph(400, 3000, seed=24)
    sj = js.DeviceSnapshot(gj, **CAPS)
    for t in range(2):
        sj.apply(js.ingest(jc.random_batch(gj, 0.01, seed=30 + t), g.n))
    arrays, extra = sj.state_dict()
    sp = ts.DeviceSnapshot(g, **CAPS, **CPU)
    sp.load_state({k: np.asarray(v) for k, v in arrays.items()}, extra)
    _same_snapshot(sp, sj)
    mine, mine_extra = sp.state_dict()
    assert sorted(mine) == sorted(arrays) and mine_extra == extra
    for k in arrays:
        _eq(mine[k], arrays[k], k)
    b = tc.random_batch(g, 0.01, seed=40)
    assert _stats(sp.apply(ts.ingest(b, g.n))) == _stats(
        sj.apply(js.ingest(_jbatch(b), g.n)))
    _same_snapshot(sp, sj)


def test_snapshot_updates_earlier_device_graphs_in_place():
    g = tc.powerlaw_graph(300, 2500, seed=25)
    sp = ts.DeviceSnapshot(g, **CAPS, **CPU)
    before = sp.dg
    b = tc.random_batch(g, 0.01, seed=26)
    sp.apply(ts.ingest(b, g.n))
    now = sp.dg
    for x, y in zip(before.buckets, now.buckets):
        assert x.idx is y.idx and x.mask is y.mask and x.rows is y.rows
    assert before.hi_tiles is now.hi_tiles and before.out_deg is now.out_deg
    c = torch.from_numpy(np.random.default_rng(0).random(g.n))
    want = tc.pull_sum(tc.device_graph(tc.apply_batch(g, b), **CAPS, **CPU),
                       c)
    assert _linf(tc.pull_sum(before, c), want) <= 1e-12


def test_snapshot_and_session_stage_on_cuda_by_default():
    g = tc.powerlaw_graph(50, 200, seed=0)
    if torch.cuda.is_available():
        assert ts.DeviceSnapshot(g, **CAPS).dg.out_deg.is_cuda
        return
    for make in (lambda: ts.DeviceSnapshot(g, **CAPS),
                 lambda: ts.StreamSession(g, **CAPS)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# ---------------------------------------------------------------------------
# engines on a snapshot (the `.dg` / `.fwd_dg` inputs)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def snaps():
    g = tc.powerlaw_graph(400, 3000, seed=22)
    gj = jc.powerlaw_graph(400, 3000, seed=22)
    sp = ts.DeviceSnapshot(g, **CAPS, **CPU)
    sj = js.DeviceSnapshot(gj, **CAPS)
    r0, _ = tc.static_pagerank(sp, tc.init_ranks(g.n, **CPU))
    rj0, _ = jc.static_pagerank(sj, jc.init_ranks(g.n))
    b = tc.random_batch(g, 1e-2, seed=23)
    d, dj = ts.ingest(b, g.n), js.ingest(_jbatch(b), g.n)
    sp.apply(d)
    sj.apply(dj)
    return dict(g=g, sp=sp, sj=sj, r0=r0, rj0=rj0, db=d.to_device(**CPU),
                dbj=dj.to_device(), est=ts.frontier_estimate(d, sp._outdeg))


def test_drivers_accept_snapshot_directly():
    """tests/test_stream.py's test of the same name, on the port: the
    drivers take a snapshot for `dg` (and, compact, for `fwd`)."""
    g = tc.powerlaw_graph(400, 3000, seed=22)
    snap = ts.DeviceSnapshot(g, **CAPS, **CPU)
    r0 = tc.init_ranks(g.n, **CPU)
    r_snap, _ = tc.static_pagerank(snap, r0)
    r_dg, _ = tc.static_pagerank(tc.device_graph(g, **CAPS, **CPU), r0)
    assert torch.equal(r_snap, r_dg)
    b = tc.random_batch(g, 1e-3, seed=23)
    d = ts.ingest(b, g.n)
    snap.apply(d)
    db = d.to_device(**CPU)
    r1, _ = tc.dfp_pagerank(snap, r_dg, db)
    r2, _ = tc.dfp_pagerank_compact(snap, None, r_dg, db)
    r3, _ = tc.dfp_pagerank(snap, r_dg, db, frontier_caps=tc.caps_for(
        snap.dg, ts.frontier_estimate(d, snap._outdeg)))
    assert tc.l1_error(r1, r2) < 1e-12 and tc.l1_error(r1, r3) < 1e-12
    gj = jc.powerlaw_graph(400, 3000, seed=22)
    sj = js.DeviceSnapshot(gj, **CAPS)
    sj.apply(js.ingest(_jbatch(b), g.n))
    rj, _ = jcompact.dfp_pagerank_compact(
        sj, None, np.asarray(r_dg), js.ingest(_jbatch(b), g.n).to_device())
    assert _linf(r2, rj) <= SOLVE_TOL


def test_static_accepts_a_snapshot(snaps):
    r, _ = tc.static_pagerank(snaps["sp"], tc.init_ranks(snaps["g"].n, **CPU))
    rj, _ = jc.static_pagerank(snaps["sj"], jc.init_ranks(snaps["g"].n))
    r_dg, _ = tc.static_pagerank(snaps["sp"].dg,
                                 tc.init_ranks(snaps["g"].n, **CPU))
    assert _linf(r, rj) <= SOLVE_TOL
    assert torch.equal(r, r_dg)
    assert _linf(snaps["r0"], snaps["rj0"]) <= SOLVE_TOL


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("engine", ["dfp_caps", "dfp_compact", "df_compact"])
def test_dynamic_engines_accept_a_snapshot(snaps, engine, kernels):
    sp, sj, db, dbj = snaps["sp"], snaps["sj"], snaps["db"], snaps["dbj"]
    r0, rj0 = snaps["r0"], snaps["rj0"]
    prune = engine != "df_compact"
    dense = (tc.dfp_pagerank if prune else tc.df_pagerank)(sp, r0, db)[0]
    if engine == "dfp_caps":
        r, _, hw = tc.dfp_pagerank(sp, r0, db, kernels=kernels, health=True,
                                   frontier_caps=tc.caps_for(sp.dg,
                                                             snaps["est"]))
        rj, _, hwj = jc.dfp_pagerank(sj, rj0, dbj, health=True,
                                     frontier_caps=jc.caps_for(sj.dg,
                                                               snaps["est"]))
    else:
        fn, jfn = ((tc.dfp_pagerank_compact, jc.dfp_pagerank_compact)
                   if prune else
                   (tc.df_pagerank_compact, jc.df_pagerank_compact))
        r, _, hw = fn(sp, None, r0, db, kernels=kernels, health=True)
        rj, _, hwj = jfn(sj, None, rj0, dbj, health=True)
    assert _linf(r, rj) <= SOLVE_TOL
    assert tc.l1_error(r, dense) <= 1e-12
    assert int(hw) == int(hwj) == 0


@pytest.mark.parametrize("prune", [True, False], ids=["dfp", "df"])
def test_compact_overflow_hands_over_to_the_dense_finish(snaps, prune):
    """headroom=1 makes the active lists too short: the compact loop exits
    on its first overflow and the dense engine finishes, in both
    packages."""
    sp, sj = snaps["sp"], snaps["sj"]
    kw = dict(prune=prune, headroom=1, health=True)
    r, it, hw = tcompact._df_like_compact(sp.dg, sp.fwd_dg, snaps["r0"],
                                          snaps["db"], tc.PRParams(), **kw)
    rj, itj, hwj = jcompact._df_like_compact(sj.dg, sj.fwd_dg, snaps["rj0"],
                                             snaps["dbj"], jc.PRParams(),
                                             **kw)
    assert _linf(r, rj) <= SOLVE_TOL
    assert int(hw) == int(hwj) == 0
    dense = (tc.dfp_pagerank if prune else tc.df_pagerank)(
        sp, snaps["r0"], snaps["db"])[0]
    assert tc.l1_error(r, dense) <= 1e-12


def test_compact_engines_need_a_forward_layout(snaps):
    with pytest.raises(TypeError, match="fwd is required"):
        tc.dfp_pagerank_compact(snaps["sp"].dg, None, snaps["r0"],
                                snaps["db"])


# ---------------------------------------------------------------------------
# StreamSession + replay
# ---------------------------------------------------------------------------

def _workload(name):
    if name == "churn":
        g = tc.powerlaw_graph(1000, 10000, seed=13)
        return g, ts.churn_workload(g, 2e-3, 4, seed=14), dict(
            compact_threshold=0.5)
    base, batches = tc.temporal_stream(2000, 30000, n_batches=60, seed=12)
    return base, batches[:4], {}


@pytest.mark.parametrize("name", ["churn", "temporal"])
def test_session_matches_repro_session(name):
    g, batches, kw = _workload(name)
    gj = jc.build_graph(g.n, *g.edges())
    sess = ts.StreamSession(g, **CAPS, **kw, **CPU)
    sj = js.StreamSession(gj, **CAPS, **kw)
    assert _linf(sess.ranks, sj.ranks) <= SOLVE_TOL
    ranks, ranks_j = [], []
    recs = ts.replay(sess, batches, verify_every=1,
                     on_batch=lambda rec: ranks.append(sess.ranks.clone()))
    recs_j = js.replay(sj, [_jbatch(b) for b in batches], verify_every=1,
                       on_batch=lambda rec: ranks_j.append(
                           np.asarray(sj.ranks)))
    gg = g
    for b, rec, rec_j, r, rj in zip(batches, recs, recs_j, ranks, ranks_j):
        hp, hj = rec.stats, rec_j.stats
        assert hp.engine == hj.engine and hp.batch_size == hj.batch_size
        assert _stats(hp.snapshot) == _stats(hj.snapshot)
        assert not hp.snapshot.rebuilt
        assert tc.l1_error(r, rj) <= L1_TOL
        gg = tc.apply_batch(gg, b)
        ref, _ = tc.static_pagerank(tc.device_graph(gg, **CAPS, **CPU),
                                    tc.init_ranks(g.n, **CPU), sess.params)
        assert tc.l1_error(r, ref) <= L1_TOL
        assert rec.l1_vs_static <= L1_TOL and rec_j.l1_vs_static <= L1_TOL
        assert rec.total_s > 0
    engines = {h.engine for h in sess.history}
    assert engines == ({"compact"} if name == "churn" else {"dense"})


def test_session_engine_selection_and_override():
    g = tc.powerlaw_graph(600, 6000, seed=15)
    sess = ts.StreamSession(g, **CAPS, compact_threshold=0.5, **CPU)
    sess.apply(tc.random_batch(g, 1e-3, seed=16))
    assert sess.history[-1].engine == "compact"
    sess.apply(tc.random_batch(g, 0.2, seed=17))
    assert sess.history[-1].engine == "dense"
    for forced in ("dense", "compact"):
        s = ts.StreamSession(g, **CAPS, engine=forced, prune=False, **CPU)
        s.apply(tc.random_batch(g, 1e-3, seed=18))
        assert s.history[-1].engine == forced
    with pytest.raises(ValueError):
        ts.StreamSession(g, **CAPS, engine="warp", **CPU)
    s.apply(_batch())                       # an empty batch is a no-op
    assert s.history[-1].engine == "noop"
    r = s.recompute()
    assert s.history[-1].engine == "recompute"
    assert tc.l1_error(r, s.static_reference()) == 0.0


def test_flat_ranks_are_the_ranks_and_match_repro():
    g = tc.powerlaw_graph(600, 6000, seed=23)
    gj = jc.build_graph(g.n, *g.edges())
    sess = ts.StreamSession(g, **CAPS, **CPU)
    sj = js.StreamSession(gj, **CAPS)
    for k in range(3):
        r = sess.flat_ranks()
        assert r is sess.ranks and r.shape == (g.n,)
        assert _linf(r, sj.flat_ranks()) <= SOLVE_TOL
        b = tc.random_batch(g, 2e-3, seed=24 + k)
        sess.apply(b)
        sj.apply(_jbatch(b))


def test_refresh_scatters_every_table_in_one_call(monkeypatch):
    """A batch that edits rows sends every edited table of both halves and
    both degree vectors to one `scatter_rows_batch` call."""
    calls = []

    def spy(tables):
        calls.append(len(tables))
        scatter_rows_batch(tables)

    monkeypatch.setattr(ts.snapshot, "scatter_rows_batch", spy)
    g = tc.powerlaw_graph(600, 6000, seed=25)
    snap = ts.DeviceSnapshot(g, **CAPS, **CPU)
    for k in range(3):
        before = len(calls)
        stats = snap.apply(ts.ingest(tc.random_batch(g, 5e-3, seed=26 + k),
                                     g.n))
        assert not stats.rebuilt and stats.rows_touched > 0
        tables = sum(len(h.last_scatter) for h in (snap._pull, snap._fwd))
        assert calls[before:] == [tables + 2]
        _port_device_matches_mirrors(snap)


def test_session_topk_matches_argsort():
    g = tc.powerlaw_graph(500, 4000, seed=19)
    sess = ts.StreamSession(g, **CAPS, **CPU)
    sess.apply(tc.random_batch(g, 1e-3, seed=20))
    ids, vals = sess.topk(10)
    r = sess.ranks.numpy()
    np.testing.assert_array_equal(np.sort(ids), np.sort(np.argsort(-r)[:10]))
    np.testing.assert_array_equal(vals, r[ids])
    assert np.all(np.diff(vals) <= 0)


@pytest.mark.parametrize("arg,value,item", [
    ("mesh", object(), "A7"), ("guard", object(), "A5"),
    ("journal_dir", "journal", "A5"), ("checkpoint_every", 2, "A5")])
def test_session_arguments_of_later_slices_raise(arg, value, item):
    g = tc.powerlaw_graph(50, 200, seed=0)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ts.StreamSession(g, **CAPS, **{arg: value}, **CPU)


def test_session_rejects_out_of_range_ids():
    g = tc.powerlaw_graph(50, 200, seed=0)
    sess = ts.StreamSession(g, **CAPS, **CPU)
    with pytest.raises(ValidationError):
        sess.apply(_batch(ins_src=[1], ins_dst=[50]))


def test_replay_records_latency_and_error():
    base, batches = tc.temporal_stream(800, 10000, n_batches=20, seed=21)
    sess = ts.StreamSession(base, **CAPS, **CPU)
    recs = ts.replay(sess, batches[:4], verify_every=2)
    assert len(recs) == 4
    assert all(r.total_s > 0 for r in recs)
    assert recs[0].l1_vs_static is None and recs[1].l1_vs_static is not None
    assert all(r.l1_vs_static < L1_TOL for r in recs
               if r.l1_vs_static is not None)


@pytest.mark.parametrize("engine", ["dense", "compact"])
def test_session_solve_repeats_the_batch(engine):
    g = tc.powerlaw_graph(600, 6000, seed=22)
    sess = ts.StreamSession(g, **CAPS, engine=engine, **CPU)
    b = tc.random_batch(g, 2e-3, seed=23)
    r_prev = sess.ranks
    sess.apply(b)
    db = ts.ingest(b, g.n).to_device(**CPU)
    r, iters = sess.solve(engine, r_prev, db, sess._caps, kernels=False)
    assert torch.equal(r, sess.ranks) and iters == sess.history[-1].iters
    assert len(sess.history) == 1


def test_mixed_workload_and_its_command_line(capsys):
    from repro_torch.stream.__main__ import main
    g = tc.powerlaw_graph(2048, 16000, alpha=1.0, seed=0)
    work = ts.mixed_workload(g, 2e-3, seed=200)
    assert [k for k, _ in work] == ["churn"] * 3 + ["insert"] * 2
    assert all(b.del_src.size == 0 for _, b in work[3:])
    assert main(["--n", "2048", "--m", "16000", "--frac", "2e-3",
                 "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 6 and lines[0].startswith("n=2048")
    for line, (kind, b) in zip(lines[1:], work):
        assert f" {kind} |batch|={b.size} " in line
        assert float(line.rsplit(" ", 1)[1]) <= L1_TOL
