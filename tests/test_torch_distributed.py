"""repro_torch.core.distributed (the 1-D sharded engines, SPMD on
torch.distributed) against repro.core.distributed (shard_map).

The host layout is held array-equal to JAX's stacked build shard by shard,
in this process. The engines run on gloo ranks on the CPU (`run_ranks`,
a ``file://`` store under tmp_path, a deadline on every group), spawned
once per mesh shape for the module; the JAX references run once, in one
subprocess with 8 forced host devices (XLA fixes the device count at its
first init, as tests/test_distributed.py does), and write .npz files.
Bars: 1e-12 L∞ for one pull, 1e-10 L∞ for a solve against the same JAX
engine, 1e-15 between two meshes of the port.
"""
import os
import subprocess
import sys
import textwrap
import time

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jc
from repro.core import distributed as jd
from repro.core.dynamic import batch_to_device as j_batch
from repro.core.frontier import caps_for as j_caps_for
from repro.core.partition import partition_by_degree_jax

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core.mesh import run_ranks  # noqa: E402
from repro_torch.core.partition import (  # noqa: E402
    partition_by_degree_device)
from test_torch_mesh_workers import (  # noqa: E402
    _engines, _fail_on_rank_1, _hang_on_rank_1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, SEED = 500, 4000, 3
D_P, TILE = 8, 64
TOL_SWEEP = 1e-12
TOL_SOLVE = 1e-10

# ---------------------------------------------------------------------------
# the JAX references: one subprocess, 8 forced host devices
# ---------------------------------------------------------------------------

JAX_REF = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np, jax.numpy as jnp
    from repro.core import powerlaw_graph, random_batch, apply_batch
    from repro.core.dynamic import batch_to_device
    from repro.core.distributed import (build_sharded,
        distributed_static_pagerank, distributed_dfp_pagerank,
        initial_affected_sharded)
    from repro.obs.trace import trace_summary
    assert len(jax.devices()) == 8, jax.devices()
    out_dir = sys.argv[1]
    N, M, SEED, D_P, TILE = 500, 4000, 3, 8, 64
    g = powerlaw_graph(N, M, seed=SEED)
    b = random_batch(g, 0.01, seed=4)
    g2 = apply_batch(g, b)
    db = batch_to_device(b, g.n)
    for nd, shape in ((4, (2, 2)), (8, (4, 2))):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             devices=jax.devices()[:nd])
        sg = build_sharded(g, nd, d_p=D_P, tile=TILE)
        r0 = jnp.full((nd, sg.n_loc), 1.0 / g.n, jnp.float64)
        r, it, tb, hw = distributed_static_pagerank(mesh, sg, r0,
                                                    trace=True, health=True)
        st = trace_summary(tb, it)
        rk, itk = distributed_static_pagerank(mesh, sg, r0, delta_every=4)
        sg2 = build_sharded(g2, nd, d_p=D_P, tile=TILE)
        dv0, dn0 = initial_affected_sharded(nd, sg2.n_loc, db)
        rd, itd, tbd, hwd = distributed_dfp_pagerank(
            mesh, sg2, r, dv0, dn0, trace=True, health=True)
        sd = trace_summary(tbd, itd)
        np.savez(f"{out_dir}/jax_1d_nd{nd}.npz",
                 r=np.asarray(r), it=int(it), hw=int(hw),
                 linf=np.array(st["linf_delta"], float),
                 frontier=np.array(st["frontier"]),
                 rk=np.asarray(rk), itk=int(itk),
                 rd=np.asarray(rd), itd=int(itd), hwd=int(hwd),
                 d_linf=np.array(sd["linf_delta"], float),
                 d_frontier=np.array(sd["frontier"]),
                 d_delta_n=np.array(sd["delta_n"]),
                 d_pruned=np.array(sd["pruned"]))
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref_1d")
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", JAX_REF, str(out)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return {nd: dict(np.load(out / f"jax_1d_nd{nd}.npz")) for nd in (4, 8)}


# ---------------------------------------------------------------------------
# the port on gloo ranks: one spawned group per world size
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    store = tmp_path_factory.mktemp("store_1d")
    return {nd: run_ranks(_engines, nd, store_dir=str(store), timeout_s=120)
            for nd in (4, 8)}


# ---------------------------------------------------------------------------
# host layout and helpers, shard by shard against the stacked JAX build
# ---------------------------------------------------------------------------

def _assert_shard_equal(t, j, s):
    for bt, bj in zip(t.buckets, j.buckets):
        for f in ("rows", "idx", "mask"):
            np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                          np.asarray(getattr(bj, f))[s])
    for f in ("hi_pos", "hi_tiles", "hi_tmask", "hi_rowmap", "out_deg",
              "valid"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f))[s])
    tiles, off = tc.pagerank.slot_tile_table(np.asarray(j.hi_rowmap)[s],
                                             j.hi_pos.shape[1])
    np.testing.assert_array_equal(t.hi_slot_tiles.numpy(), tiles)
    np.testing.assert_array_equal(t.hi_slot_off.numpy(), off)


@pytest.mark.parametrize("n,m,nd", [(N, M, 1), (N, M, 3), (N, M, 4),
                                    (N, M, 8), (13, 40, 8)])
def test_build_sharded_shards_equal_jax_stacked_build(n, m, nd):
    gj = jc.powerlaw_graph(n, m, seed=SEED)
    gt = tc.powerlaw_graph(n, m, seed=SEED)
    sj = jd.build_sharded(gj, nd, d_p=D_P, tile=TILE)
    padding = 0
    for s in range(nd):
        st = td.build_sharded(gt, nd, d_p=D_P, tile=TILE, shard=s,
                              device="cpu")
        assert (st.nd, st.shard, st.n_true, st.n_loc) == (nd, s, n,
                                                          sj.n_loc)
        _assert_shard_equal(st, sj, s)
        assert td.sharded_caps(st) == jd.sharded_caps(sj)
        padding += int(not st.valid.any())
    # 13 vertices over 8 shards of 2: shards 7 holds padding alone
    assert padding == (1 if n == 13 else 0)


def test_build_sharded_at_given_caps_and_refusals():
    gt = tc.powerlaw_graph(N, M, seed=SEED)
    gj = jc.powerlaw_graph(N, M, seed=SEED)
    caps = jd.sharded_caps(jd.build_sharded(gj, 4, d_p=D_P, tile=TILE))
    big = dict(caps, hi_cap=2 * caps["hi_cap"], t_cap=2 * caps["t_cap"])
    sj = jd.build_sharded(gj, 4, **big)
    _assert_shard_equal(td.build_sharded(gt, 4, **big, shard=2,
                                         device="cpu"), sj, 2)
    with pytest.raises(ValueError, match="caps too small"):
        td.build_sharded(gt, 4, **dict(caps, t_cap=8), shard=0,
                         device="cpu")
    with pytest.raises(ValueError, match="shard 4 of 4"):
        td.build_sharded(gt, 4, d_p=D_P, tile=TILE, shard=4, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            td.build_sharded(gt, 4, d_p=D_P, tile=TILE, shard=0)


@pytest.mark.parametrize("band", [False, True])
def test_sharded_need_matches_jax(band):
    g = tc.powerlaw_graph(N, M, seed=SEED)
    indeg = g.in_degree()
    widths = tc.choose_bucket_widths(indeg, D_P)
    for nd in (1, 3, 8):
        n_loc = -(-g.n // nd)
        assert td.sharded_need(indeg, nd, n_loc, D_P, TILE, widths, band) \
            == jd.sharded_need(indeg, nd, n_loc, D_P, TILE, widths, band)


def test_shard_vector_and_unshard_vector_match_jax():
    x = np.random.default_rng(0).standard_normal(N)
    for nd in (1, 3, 8):
        stacked = np.asarray(jd.shard_vector(x, nd, fill=-1.0))
        for s in range(nd):
            np.testing.assert_array_equal(
                td.shard_vector(x, nd, s, fill=-1.0, device="cpu").numpy(),
                stacked[s])
        np.testing.assert_array_equal(td.unshard_vector(stacked, N),
                                      jd.unshard_vector(stacked, N))
        np.testing.assert_array_equal(
            td.unshard_vector(torch.tensor(stacked), N), x)


def test_initial_affected_sharded_matches_jax():
    gj = jc.powerlaw_graph(N, M, seed=SEED)
    b = jc.random_batch(gj, 0.02, seed=5)
    for nd in (3, 8):
        n_loc = -(-N // nd)
        dvj, dnj = jd.initial_affected_sharded(nd, n_loc,
                                               j_batch(b, N, pad_to=256))
        db = tc.batch_to_device(b, N, pad_to=256, device="cpu")
        for s in range(nd):
            dv, dn = td.initial_affected_sharded(nd, n_loc, db, s)
            np.testing.assert_array_equal(dv.numpy(), np.asarray(dvj)[s])
            np.testing.assert_array_equal(dn.numpy(), np.asarray(dnj)[s])


def test_partition_by_degree_device_matches_jax():
    deg = np.random.default_rng(1).integers(0, 200, 3001).astype(np.int32)
    for d_p in (0, 7, 64, 500):
        pj, nj = partition_by_degree_jax(jnp.asarray(deg), d_p)
        pt, nt = partition_by_degree_device(torch.from_numpy(deg), d_p)
        np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
        assert int(nt) == int(nj)
        assert pt.dtype == torch.int32


def test_local_pulls_match_jax_per_shard():
    gj = jc.powerlaw_graph(N, M, seed=SEED)
    gt = tc.powerlaw_graph(N, M, seed=SEED)
    nd = 4
    sj = jd.build_sharded(gj, nd, d_p=D_P, tile=TILE)
    rng = np.random.default_rng(2)
    c = rng.random(nd * sj.n_loc)
    x = (rng.random(nd * sj.n_loc) < 0.1).astype(np.float64)
    d = jd._as_dict(sj)
    for s in range(nd):
        loc = {k: (tuple(type(b)(*(a[s] for a in b)) for b in v)
                   if k == "buckets" else v[s]) for k, v in d.items()}
        st = td.build_sharded(gt, nd, d_p=D_P, tile=TILE, shard=s,
                              device="cpu")
        got = td.local_pull(st, torch.from_numpy(c))
        want = np.asarray(jd._local_pull(loc, jnp.asarray(c)))
        assert got.shape == (st.n_loc,)
        assert np.max(np.abs(got.numpy() - want)) <= TOL_SWEEP
        got = td.local_pull_max(st, torch.from_numpy(x))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jd._local_pull_max(loc, jnp.asarray(x))))


def test_pagerank_step_specs_waits_for_a9():
    with pytest.raises(NotImplementedError, match="A9"):
        td.pagerank_step_specs(None)


# ---------------------------------------------------------------------------
# the engines over 4 and 8 gloo ranks
# ---------------------------------------------------------------------------

def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("nd", [4, 8])
def test_static_matches_jax_distributed(port, jax_ref, nd):
    t, j = port[nd][0], jax_ref[nd]
    assert _linf(t["r"], j["r"].reshape(-1)[:N]) <= TOL_SOLVE
    assert t["it"] == int(j["it"])
    # every rank ends with the same iteration count and the gathered ranks
    for other in port[nd][1:]:
        assert other["it"] == t["it"]
        np.testing.assert_array_equal(other["r"], t["r"])
    # each rank returned its own slice
    n_loc = j["r"].shape[1]
    for s, other in enumerate(port[nd]):
        assert other["local"].shape == (n_loc,)
        assert _linf(other["local"], j["r"][s]) <= TOL_SOLVE


@pytest.mark.parametrize("nd", [4, 8])
def test_dfp_matches_jax_distributed(port, jax_ref, nd):
    t, j = port[nd][0], jax_ref[nd]
    assert _linf(t["rd"], j["rd"].reshape(-1)[:N]) <= TOL_SOLVE
    assert t["itd"] == int(j["itd"])
    assert tc.l1_error(t["rd"], tc.reference_pagerank(
        tc.apply_batch(tc.powerlaw_graph(N, M, seed=SEED),
                       tc.random_batch(tc.powerlaw_graph(N, M, seed=SEED),
                                       0.01, seed=4)))) < 1e-3


@pytest.mark.parametrize("nd", [4, 8])
def test_delta_every_checks_every_fourth_iteration(port, jax_ref, nd):
    t, j = port[nd][0], jax_ref[nd]
    assert t["itk"] % 4 == 0 and t["itk"] == int(j["itk"])
    assert _linf(t["rk"], j["rk"].reshape(-1)[:N]) <= TOL_SOLVE
    assert tc.l1_error(t["rk"], t["r"]) < 1e-9


@pytest.mark.parametrize("nd", [4, 8])
def test_trace_series_match_jax(port, jax_ref, nd):
    t, j = port[nd][0], jax_ref[nd]
    assert t["engine"] == "static_1d" and t["d_engine"] == "dfp_1d"
    np.testing.assert_allclose(t["linf"], j["linf"], rtol=0,
                               atol=TOL_SOLVE)
    np.testing.assert_array_equal(t["frontier"], j["frontier"])
    assert t["frontier"][0] == N
    np.testing.assert_allclose(t["d_linf"], j["d_linf"], rtol=0,
                               atol=TOL_SOLVE)
    for k in ("d_frontier", "d_delta_n", "d_pruned"):
        np.testing.assert_array_equal(t[k], j[k])
    for other in port[nd][1:]:
        assert other["linf"] == t["linf"] and other["d_pruned"] == \
            t["d_pruned"]


@pytest.mark.parametrize("nd", [4, 8])
def test_health_words_match_jax(port, jax_ref, nd):
    t, j = port[nd][0], jax_ref[nd]
    assert t["hw"] == int(j["hw"]) == 0
    assert t["hwd"] == int(j["hwd"]) == 0


def test_meshes_4x2_and_2x2x2_agree(port):
    for rank in port[8]:
        np.testing.assert_allclose(rank["r_222"], rank["local"], rtol=0,
                                   atol=1e-15)


@pytest.mark.parametrize("nd", [4, 8])
def test_caps_dfp_matches_jax_single_device_with_its_counters(port, nd):
    gj = jc.powerlaw_graph(N, M, seed=SEED)
    b = jc.random_batch(gj, 0.01, seed=4)
    g2 = jc.apply_batch(gj, b)
    dg = jc.device_graph(g2, d_p=D_P, tile=TILE)
    t = port[nd][0]
    from repro.obs import get_registry as j_registry, reset_registry as j_reset
    j_reset()
    rj, itj = jc.dfp_pagerank(dg, jnp.asarray(t["r"]), j_batch(b, N),
                              frontier_caps=j_caps_for(dg, N))
    jcnt = j_registry().report()["counters"]
    for name in ("caps", "tight"):
        got = t[name]
        assert _linf(got["r"], np.asarray(rj)) <= TOL_SOLVE
        assert _linf(got["r"], t["rd"]) <= TOL_SOLVE
        cnt = got["counters"]
        # the fstats are summed over the shards: each shard counts every
        # iteration once, compacted or not
        assert cnt["frontier.iters"] == nd * got["it"]
        assert cnt["frontier.compact_iters"] \
            + cnt["frontier.compaction_overflows"] == nd * got["it"]
        for other in port[nd][1:]:
            assert other[name]["counters"] == cnt
    # with room for every row no shard overflows, and the rows the shards
    # pulled, bucket by bucket, are the single-device solve's (the active
    # tiles are not: a layout's padding tiles name its last high slot)
    cnt = t["caps"]["counters"]
    assert t["caps"]["it"] == int(itj)
    assert cnt["frontier.compaction_overflows"] == 0
    assert jcnt["frontier.compaction_overflows"] == 0
    rows = [k for k in jcnt if k.startswith("frontier.active_rows")]
    assert len(rows) > 1
    for k in rows:
        assert cnt[k] == jcnt[k], k
    assert t["tight"]["counters"]["frontier.compaction_overflows"] > 0


def test_run_ranks_reports_a_failing_rank_and_a_hung_collective(tmp_path):
    with pytest.raises(RuntimeError, match="(?s)rank 1 failed.*on purpose"):
        run_ranks(_fail_on_rank_1, 2, store_dir=str(tmp_path),
                  timeout_s=30)
    # rank 0's barrier times out after 5 s, or (on a loaded host, where
    # starting the ranks eats into it) the group's 10 s deadline passes
    # first: either way the call fails and the group is torn down
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="rank 0 failed|did not finish within 10 s"):
        run_ranks(_hang_on_rank_1, 2, store_dir=str(tmp_path), timeout_s=5)
    assert time.monotonic() - t0 < 40
    assert list(tmp_path.iterdir()) == []     # no store file left behind
