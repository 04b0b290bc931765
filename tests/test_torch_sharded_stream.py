"""repro_torch.stream's mesh mode against repro.stream: the sharded
snapshot, the mesh StreamSession with its guard rung and checkpoints, and
train/elastic.py; also the snapshot faults C3 and C4 of ROADMAP.

The port runs on four gloo ranks on the CPU (`run_ranks`, a ``file://``
store under tmp_path, a deadline), spawned once for the module. JAX's
`ShardedSnapshot` runs in this process (it needs no mesh); JAX's mesh
sessions run in subprocesses with 4 forced host devices. A JAX mesh DF-P
with frontier caps cannot run under this container's jax (ROADMAP C2),
so the port's mesh session is held against JAX's single-device session,
and checkpoints cross the packages only where no JAX batch runs: a JAX
mesh checkpoint taken before its first batch restores in the port, and a
port mesh checkpoint taken after its last batch restores in JAX.
Bars: mirrors, free lists and device tables array-equal; ranks within L1
1e-8 of JAX's single-device session and of a from-scratch solve.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import repro.core as jc
import repro.stream as js
from repro.guard.journal import load_session_checkpoint as jckpt_load
from repro.train import checkpoint as jckpt
from repro.train import elastic as jel

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch.core.mesh import run_ranks  # noqa: E402
from repro_torch.guard import H_NONFINITE  # noqa: E402
from repro_torch.stream.snapshot import _HalfLayout  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import elastic as tel  # noqa: E402
from test_torch_mesh_workers import (  # noqa: E402
    BASE, D_P, ND, SNAP_KW, TILE, _base, _batches, _stats, _stream_rank)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# JAX mesh sessions (subprocesses, 4 forced host devices)
# ---------------------------------------------------------------------------

JAX_CHECKPOINT = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    from repro.core import powerlaw_graph
    from repro.stream import StreamSession
    assert len(jax.devices()) == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    g = powerlaw_graph(%(n)d, %(m)d, seed=%(seed)d)
    sess = StreamSession(g, mesh=mesh, d_p=%(d_p)d, tile=%(tile)d,
                         journal_dir=sys.argv[1])
    sess.checkpoint()
    sess.close()
    print("OK")
""" % dict(BASE, d_p=D_P, tile=TILE))

JAX_RESTORE = textwrap.dedent("""
    import sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.guard.journal import load_session_checkpoint
    from repro.stream import StreamSession
    assert len(jax.devices()) == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    sess = StreamSession.restore(sys.argv[1], mesh=mesh)
    arrays, extra, step = load_session_checkpoint(sys.argv[1])
    got, got_extra = sess.snap.state_dict()
    assert sorted(got) == sorted(k for k in arrays if k != "ranks")
    for k, v in got.items():
        np.testing.assert_array_equal(np.asarray(v), arrays[k], err_msg=k)
    assert got_extra == extra["snap"], (got_extra, extra["snap"])
    np.testing.assert_array_equal(np.asarray(sess.ranks), arrays["ranks"])
    assert sess._batch_idx == step == 2, step
    np.save(sys.argv[2], np.asarray(sess.flat_ranks()))
    print("OK")
""")


def _jax(script, *args, devices=4):
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["PYTHONPATH"] = "src"
    env["JAX_PLATFORMS"] = "cpu"
    run = subprocess.run([sys.executable, "-c", script, *map(str, args)],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "OK" in run.stdout


# ---------------------------------------------------------------------------
# the port: one spawned group of four gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port(tmp_path_factory):
    jax_ckpt = tmp_path_factory.mktemp("jax_mesh_ckpt")
    _jax(JAX_CHECKPOINT, jax_ckpt)
    port_ckpt = tmp_path_factory.mktemp("port_mesh_ckpt")
    store = tmp_path_factory.mktemp("store_stream")
    ranks = run_ranks(_stream_rank, ND, str(jax_ckpt), str(port_ckpt),
                      store_dir=str(store), timeout_s=180)
    return dict(ranks=ranks, jax_ckpt=str(jax_ckpt),
                port_ckpt=str(port_ckpt))


# ---------------------------------------------------------------------------
# the sharded snapshot against JAX's, shard by shard
# ---------------------------------------------------------------------------

def _jax_tables(sg, s):
    out = {f"b{b}.{f}": np.asarray(getattr(blk, f))[s]
           for b, blk in enumerate(sg.buckets) for f in ("rows", "idx",
                                                         "mask")}
    for f in ("hi_pos", "hi_tiles", "hi_tmask", "hi_rowmap", "out_deg",
              "valid"):
        out[f] = np.asarray(getattr(sg, f))[s]
    out["hi_slot_tiles"], out["hi_slot_off"] = tc.pagerank.slot_tile_table(
        out["hi_rowmap"], out["hi_pos"].shape[0])
    return out


@pytest.mark.parametrize("config", [0, 1])
def test_sharded_snapshot_equals_jax_after_every_batch(port, config):
    g = _base(jc)
    jsnap = js.ShardedSnapshot(g, nd=ND, d_p=D_P, tile=TILE,
                               **SNAP_KW[config])
    seqs = [r[f"snap{config}"] for r in port["ranks"]]
    batches = [None] + _batches(jc, js, g)
    migrations = 0
    for k, b in enumerate(batches):
        if b is not None:
            st = jsnap.apply(js.ingest(b, g.n))
            migrations += st.migrations
            for s in range(ND):
                assert seqs[s][k][2] == _stats(st), (k, s)
        for s in range(ND):
            state, tables, _ = seqs[s][k]
            want = jsnap._halves[s].state_dict(f"s{s}.")
            assert sorted(state) == sorted(want)
            for name, arr in want.items():
                np.testing.assert_array_equal(state[name], arr,
                                              err_msg=f"{k} {name}")
            jt = _jax_tables(jsnap.sg, s)
            assert sorted(tables) == sorted(jt)
            for name, arr in jt.items():
                np.testing.assert_array_equal(tables[name], arr,
                                              err_msg=f"{k} s{s} {name}")
    assert migrations > 0
    assert port["ranks"][0][f"caps{config}"] == jsnap._caps
    # the crossing batch moved rows from the ELL to the tiles and back
    crossing = [s[-1][0] for s in seqs]
    before = [s[-2][0] for s in seqs]
    moved = sum(int((a[f"s{s}.is_low"] != b[f"s{s}.is_low"]).sum())
                for s, (a, b) in enumerate(zip(crossing, before)))
    assert moved > 0


# ---------------------------------------------------------------------------
# the mesh session
# ---------------------------------------------------------------------------

def test_mesh_session_matches_jax_single_device_session(port):
    g = _base(jc)
    jsess = js.StreamSession(g, d_p=D_P, tile=TILE)
    t = port["ranks"][0]
    for k, b in enumerate(js.churn_workload(g, 0.004, 3, seed=21)):
        jsess.apply(b)
        want = np.asarray(jsess.flat_ranks())
        assert tc.l1_error(t["flats"][k], want) < 1e-8
        assert tc.l1_error(t["flats"][k], t["refs"][k]) < 1e-8
        assert t["engines"][k] == ("sharded", False, 0)
        for other in port["ranks"][1:]:
            np.testing.assert_array_equal(other["flats"][k], t["flats"][k])
    np.testing.assert_array_equal(t["topk"], jsess.topk(5)[0])


def test_sharded_rung_recovers_a_nan_batch(port):
    for r in port["ranks"]:
        nan = r["nan"]
        assert nan["healthy"] == 0
        assert nan["health"] & H_NONFINITE
        assert nan["escalations"] >= 1 and nan["sharded"] == 1
        assert nan["success"] == 1
        assert nan["l1"] < 1e-8


def test_jax_mesh_checkpoint_restores_in_the_port(port):
    arrays, extra, step = jckpt_load(port["jax_ckpt"])
    assert extra["session"]["mesh"] is True and step == 0
    for s, r in enumerate(port["ranks"]):
        got = r["restored"]
        assert got["step"] == 0
        for name, arr in got["state"].items():
            np.testing.assert_array_equal(arr, arrays[name], err_msg=name)
        np.testing.assert_array_equal(got["ranks"], arrays["ranks"][s])
    # one batch after the restore: the JAX single-device session's ranks
    g = _base(jc)
    jsess = js.StreamSession(g, d_p=D_P, tile=TILE)
    jsess.apply(js.churn_workload(g, 0.004, 1, seed=31)[0])
    assert tc.l1_error(port["ranks"][0]["restored"]["after"],
                       np.asarray(jsess.flat_ranks())) < 1e-8


def test_port_mesh_checkpoint_restores_in_jax(port, tmp_path):
    ranks = port["ranks"]
    # rank 0 wrote the checkpoint and the journal; every rank named it
    assert [r["port_ckpt"]["journals"] for r in ranks] == [True] + \
        [False] * (ND - 1)
    assert len({r["port_ckpt"]["path"] for r in ranks}) == 1
    arrays, extra, step = jckpt_load(port["port_ckpt"])
    assert extra["session"]["mesh"] is True and step == 2
    assert arrays["ranks"].shape == (ND, -(-BASE["n"] // ND))
    assert sorted(k for k in arrays if k.startswith("s3.")) \
        == sorted(f"s3.{k[3:]}" for k in arrays if k.startswith("s0."))
    out = tmp_path / "jax_flat.npy"
    _jax(JAX_RESTORE, port["port_ckpt"], out)
    np.testing.assert_array_equal(np.load(out), ranks[0]["port_ckpt"]["flat"])


# ---------------------------------------------------------------------------
# train/elastic.py
# ---------------------------------------------------------------------------

def test_elastic_resume_from_4_to_2_shards_equals_jax(port, tmp_path):
    flat = port["ranks"][0]["flats"][-1]
    n = flat.shape[0]
    dv = np.zeros(n, bool)
    dv[::7] = True
    tckpt.save_checkpoint(str(tmp_path), 3, {"r": flat, "dv": dv})
    g = _base(jc)
    sgj, rj, dvj = jel.elastic_pagerank_resume(g, str(tmp_path), 2, d_p=D_P,
                                               tile=TILE)
    gt = _base(tc)
    for s in range(2):
        sg, r, d = tel.elastic_pagerank_resume(gt, str(tmp_path), 2, d_p=D_P,
                                               tile=TILE, shard=s,
                                               device="cpu")
        assert (sg.nd, sg.shard) == (2, s)
        np.testing.assert_array_equal(r.numpy(), np.asarray(rj)[s])
        np.testing.assert_array_equal(d.numpy(), np.asarray(dvj)[s])
        for f in ("hi_pos", "hi_tiles", "hi_rowmap", "out_deg", "valid"):
            np.testing.assert_array_equal(getattr(sg, f).numpy(),
                                          np.asarray(getattr(sgj, f))[s])


def test_run_with_restarts_matches_jax(tmp_path):
    def run(mod, ckpt, sub):
        fails = {3, 7}

        def injector(step):
            if step in fails:
                fails.discard(step)
                raise RuntimeError(f"node lost at {step}")

        def step_fn(st):
            x = np.asarray(st.tree["x"]) * 1.5 + st.step
            return mod.RunState(step=st.step + 1, tree={"x": x},
                                extra={"seen": st.step})

        def init_fn():
            return mod.RunState(step=0, tree={"x": np.ones(4)}, extra={})
        return mod.run_with_restarts(step_fn, init_fn, str(ckpt / sub),
                                     total_steps=10, ckpt_every=2,
                                     fail_injector=injector)
    t = run(tel, tmp_path, "torch")
    j = run(jel, tmp_path, "jax")
    assert t.step == j.step == 10 and t.extra == j.extra
    np.testing.assert_array_equal(t.tree["x"], np.asarray(j.tree["x"]))
    assert tckpt.list_checkpoints(str(tmp_path / "torch")) == \
        jckpt.list_checkpoints(str(tmp_path / "jax"))


# ---------------------------------------------------------------------------
# C3 and C4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_restores_jax_checkpoint_made_with_scatter_impl(tmp_path, impl):
    g = jc.powerlaw_graph(500, 5000, seed=6)
    jsess = js.StreamSession(g, journal_dir=str(tmp_path), d_p=16, tile=64,
                             scatter_impl=impl)
    for b in js.churn_workload(g, 0.004, 2, seed=7):
        jsess.apply(b)
    jsess.checkpoint()
    jsess.apply(js.churn_workload(g, 0.004, 1, seed=8)[0])
    jsess.close()
    sess = ts.StreamSession.restore(str(tmp_path), device="cpu")
    assert sess.snap.scatter_impl == impl
    assert sess._snap_kw == {"scatter_impl": impl}
    assert sess._batch_idx == 3
    assert tc.l1_error(sess.flat_ranks(), np.asarray(jsess.flat_ranks())) \
        < 1e-8
    for name, arr in jsess.snap.state_dict()[0].items():
        np.testing.assert_array_equal(sess.snap.state_dict()[0][name],
                                      np.asarray(arr), err_msg=name)
    with pytest.raises(ValueError, match="scatter_impl"):
        ts.DeviceSnapshot(tc.powerlaw_graph(50, 300, seed=1),
                          scatter_impl="xla", device="cpu")


def test_low_water_clamps_to_d_p_like_jax():
    g = tc.powerlaw_graph(300, 3000, seed=2)
    lay = tc.build_hybrid(g, d_p=16, tile=64)
    half = _HalfLayout(lay, g.in_degree(), None, stage_device=False)
    assert half.low_water == 8
    half.low_water = 40
    assert half.low_water == 16
    half.low_water = 5
    assert half.low_water == 5
    assert _HalfLayout(lay, g.in_degree(), None, low_water=99,
                       stage_device=False).low_water == 16
    snap = ts.DeviceSnapshot(g, d_p=16, tile=64, low_water=99, device="cpu")
    assert snap._pull.low_water == snap._fwd.low_water == 16
    assert not hasattr(half, "dev_bk_idx")
    drained = half.drain_dirty()
    assert [s.size for s in drained["bucket_slots"]] == [0] * len(
        lay.widths) and not drained["side_dirty"]
