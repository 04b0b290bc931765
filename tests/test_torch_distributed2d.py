"""repro_torch.core.distributed2d (the 2-D edge-partitioned engines, SPMD on
torch.distributed) against repro.core.distributed2d (shard_map).

`build_sharded_2d` is held array-equal to JAX's stacked build block by
block in this process; `pagerank_2d` and `dfp_2d` run on a (2, 2) mesh of
four gloo ranks on the CPU (`run_ranks`, a ``file://`` store under
tmp_path, a deadline) against JAX's on 4 forced host devices (one
subprocess writing an .npz). Bars: 1e-10 L∞ against the same JAX engine;
`row_cap` against the dense loop within the same bar (JAX's `row_cap` loop
does not trace under this container's jax, ROADMAP C2: its compacted
loop's stats carry is refused, as the 1-D one's).
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.core as jc
from repro.core import distributed2d as jd2

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
from repro_torch.core import distributed2d as td2  # noqa: E402
from repro_torch.core.mesh import run_ranks  # noqa: E402
from test_torch_mesh_workers import _engines_2d  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, SEED, D_P = 500, 4000, 3, 8
TOL_SOLVE = 1e-10

JAX_REF = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np, jax.numpy as jnp
    from repro.core import powerlaw_graph, random_batch, apply_batch
    from repro.core.distributed2d import build_sharded_2d, pagerank_2d, dfp_2d
    from repro.obs.trace import trace_summary
    assert len(jax.devices()) == 4, jax.devices()
    N, M, SEED, D_P = 500, 4000, 3, 8
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    g = powerlaw_graph(N, M, seed=SEED)
    sg = build_sharded_2d(g, 2, 2, d_p=D_P)
    rc, blk = sg.out_deg.shape
    r0 = jnp.full((rc, blk), 1.0 / g.n, jnp.float64)
    r, it, tb = pagerank_2d(mesh, sg, r0, trace=True)
    st = trace_summary(tb, it)
    b = random_batch(g, 0.01, seed=4)
    g2 = apply_batch(g, b)
    sg2 = build_sharded_2d(g2, 2, 2, d_p=D_P)
    n_pad = rc * blk
    dv = np.zeros(n_pad, bool); dn = np.zeros(n_pad, bool)
    dn[b.del_src] = True; dn[b.ins_src] = True; dv[b.del_dst] = True
    dv0 = jnp.asarray(dv.reshape(rc, -1))
    dn0 = jnp.asarray(dn.reshape(rc, -1))
    rd, itd, tbd = dfp_2d(mesh, sg2, r, dv0, dn0, trace=True)
    sd = trace_summary(tbd, itd)
    np.savez(sys.argv[1], r=np.asarray(r), it=int(it),
             linf=np.array(st["linf_delta"], float),
             frontier=np.array(st["frontier"]),
             rd=np.asarray(rd), itd=int(itd),
             d_linf=np.array(sd["linf_delta"], float),
             d_frontier=np.array(sd["frontier"]),
             d_delta_n=np.array(sd["delta_n"]),
             d_pruned=np.array(sd["pruned"]))
    print("OK")
""")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_ref_2d") / "jax_2d.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", JAX_REF, str(out)], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    return dict(np.load(out))


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    store = tmp_path_factory.mktemp("store_2d")
    return run_ranks(_engines_2d, 4, store_dir=str(store), timeout_s=120)


def _linf(a, b):
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b))))


@pytest.mark.parametrize("n,m", [(N, M), (13, 40)])
def test_build_sharded_2d_blocks_equal_jax(n, m):
    sj = jd2.build_sharded_2d(jc.powerlaw_graph(n, m, seed=SEED), 2, 2,
                              d_p=D_P)
    gt = tc.powerlaw_graph(n, m, seed=SEED)
    for b in range(4):
        st = td2.build_sharded_2d(gt, 2, 2, d_p=D_P, block=b, device="cpu")
        assert (st.n_true, st.r, st.c, st.block) == (n, 2, 2, b)
        for f in ("ell_idx", "ell_mask", "out_deg", "valid"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(sj, f))[b])
    with pytest.raises(ValueError, match="square"):
        td2.build_sharded_2d(gt, 2, 1, block=0, device="cpu")
    with pytest.raises(ValueError, match="block 4 of 4"):
        td2.build_sharded_2d(gt, 2, 2, block=4, device="cpu")


def test_pagerank_2d_matches_jax(port, jax_ref):
    t, j = port[0], jax_ref
    assert sorted(p["block"] for p in port) == [0, 1, 2, 3]
    assert _linf(t["r"], j["r"].reshape(-1)[:N]) <= TOL_SOLVE
    assert t["it"] == int(j["it"])
    assert tc.l1_error(t["r"], tc.reference_pagerank(
        tc.powerlaw_graph(N, M, seed=SEED))) < 1e-8
    assert t["engine"] == "static_2d"
    np.testing.assert_allclose(t["linf"], j["linf"], rtol=0, atol=TOL_SOLVE)
    np.testing.assert_array_equal(t["frontier"], j["frontier"])
    for other in port[1:]:
        np.testing.assert_array_equal(other["r"], t["r"])


def test_dfp_2d_matches_jax(port, jax_ref):
    t, j = port[0], jax_ref
    assert _linf(t["rd"], j["rd"].reshape(-1)[:N]) <= TOL_SOLVE
    assert t["itd"] == int(j["itd"])
    assert t["d_engine"] == "dfp_2d"
    np.testing.assert_allclose(t["d_linf"], j["d_linf"], rtol=0,
                               atol=TOL_SOLVE)
    for k in ("d_frontier", "d_delta_n", "d_pruned"):
        np.testing.assert_array_equal(t[k], j[k])


def test_row_cap_matches_dense_and_jax(port, jax_ref):
    t, j = port[0], jax_ref
    assert _linf(t["rr"], t["rd"]) <= TOL_SOLVE
    assert _linf(t["rr"], j["rd"].reshape(-1)[:N]) <= TOL_SOLVE
    assert t["itr"] == t["itd"] == int(j["itd"])
    cnt = t["counters"]
    # summed over the four devices, as JAX's psum over both axes
    assert cnt["frontier.iters"] == 4 * t["itr"]
    assert cnt["frontier.compact_iters"] \
        + cnt["frontier.compaction_overflows"] == 4 * t["itr"]
    assert cnt["frontier.compact_iters"] > 0
    assert 0 < cnt["frontier.active_rows"] <= 64 * cnt[
        "frontier.compact_iters"]
    for other in port[1:]:
        assert other["counters"] == cnt
        np.testing.assert_array_equal(other["rr"], t["rr"])


def test_three_dimensional_mesh_refused(port):
    assert all("2-dimensional mesh" in p["refused"] for p in port)
