"""The per-rank bodies of the sharded-engine tests
(`test_torch_distributed.py`, `test_torch_distributed2d.py`,
`test_torch_sharded_stream.py`), and the graphs and batches they share
with those tests' JAX side. No tests here: each spawned gloo rank
(`repro_torch.core.mesh.run_ranks`) imports this module by name to find
its function, so it imports neither JAX nor `repro` (a rank then starts
in about half the time).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.core as tc  # noqa: E402
import repro_torch.stream as ts  # noqa: E402
from repro_torch.core import distributed as td  # noqa: E402
from repro_torch.core import distributed2d as td2  # noqa: E402
from repro_torch.core.mesh import build_mesh  # noqa: E402
from repro_torch.guard import ChaosMonkey, GuardConfig  # noqa: E402
from repro_torch.obs import get_registry, reset_registry  # noqa: E402

# test_torch_distributed.py, test_torch_distributed2d.py
N, M, SEED = 500, 4000, 3
D_P_1D, TILE_1D, D_P_2D = 8, 64, 8
# test_torch_sharded_stream.py
ND, D_P, TILE = 4, 16, 64
BASE = dict(n=1500, m=25000, seed=4)


# ---------------------------------------------------------------------------
# the 1-D engines
# ---------------------------------------------------------------------------

def _summary(tb, it):
    from repro_torch.obs.trace import trace_summary
    return trace_summary(tb, it)


def _engines(rank, world):
    """Everything a test below reads, computed on one rank of `world`
    gloo ranks (CPU tensors: the plain pulls)."""
    from repro_torch.core import (apply_batch, batch_to_device,
                                  powerlaw_graph, random_batch)
    g = powerlaw_graph(N, M, seed=SEED)
    b = random_batch(g, 0.01, seed=4)
    g2 = apply_batch(g, b)
    db = batch_to_device(b, g.n, device="cpu")
    shape = (2, 2) if world == 4 else (4, 2)
    mesh = build_mesh(shape, ("data", "model"), device="cpu")
    out = {}
    sg = td.build_sharded(g, world, d_p=D_P_1D, tile=TILE_1D,
                          shard=mesh.shard, device="cpu")
    r0 = torch.full((sg.n_loc,), 1.0 / g.n, dtype=torch.float64)
    r, it, tb, hw = td.distributed_static_pagerank(mesh, sg, r0, trace=True,
                                                   health=True)
    st = _summary(tb, it)
    rk, itk = td.distributed_static_pagerank(mesh, sg, r0, delta_every=4)
    sg2 = td.build_sharded(g2, world, d_p=D_P_1D, tile=TILE_1D,
                           shard=mesh.shard, device="cpu")
    dv0, dn0 = td.initial_affected_sharded(world, sg2.n_loc, db, mesh.shard)
    rd, itd, tbd, hwd = td.distributed_dfp_pagerank(
        mesh, sg2, r, dv0, dn0, trace=True, health=True)
    sd = _summary(tbd, itd)
    out.update(r=td.unshard_vector(r, g.n, mesh), it=it, hw=int(hw),
               linf=st["linf_delta"], frontier=st["frontier"],
               engine=st["engine"],
               rk=td.unshard_vector(rk, g.n, mesh), itk=itk,
               rd=td.unshard_vector(rd, g.n, mesh), itd=itd, hwd=int(hwd),
               d_engine=sd["engine"], d_linf=sd["linf_delta"],
               d_frontier=sd["frontier"], d_delta_n=sd["delta_n"],
               d_pruned=sd["pruned"], local=r.numpy())
    # the frontier-capped path: plenty of room (never overflows) and a
    # tight plan (some shards overflow some iterations)
    for name, est, room in (("caps", g.n, 16), ("tight", 1, 1)):
        reset_registry()
        caps = td.sharded_frontier_caps(sg2, est, headroom=room)
        rc, itc = td.distributed_dfp_pagerank(mesh, sg2, r, dv0, dn0,
                                              frontier_caps=caps)
        out[name] = dict(r=td.unshard_vector(rc, g.n, mesh), it=itc,
                         counters=get_registry().report()["counters"])
    if world == 8:
        # the same 1-D engine on a three-dimensional mesh: every axis as
        # one, so the same shards in the same order
        m3 = build_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
        r3, _ = td.distributed_static_pagerank(m3, sg, r0)
        out["r_222"] = r3.numpy()
    return out


# ---------------------------------------------------------------------------
# the 2-D engines
# ---------------------------------------------------------------------------

def _engines_2d(rank, world):
    """One rank of the (2, 2) mesh: every result a test below reads."""
    from repro_torch.obs.trace import trace_summary
    g = tc.powerlaw_graph(N, M, seed=SEED)
    b = tc.random_batch(g, 0.01, seed=4)
    g2 = tc.apply_batch(g, b)
    mesh = build_mesh((2, 2), ("data", "model"), device="cpu")
    blk_id = td2.block_of(mesh)
    sg = td2.build_sharded_2d(g, 2, 2, d_p=D_P_2D, block=blk_id, device="cpu")
    blk = sg.out_deg.shape[0]
    r0 = torch.full((blk,), 1.0 / g.n, dtype=torch.float64)
    r, it, tb = td2.pagerank_2d(mesh, sg, r0, trace=True)
    st = trace_summary(tb, it)
    sg2 = td2.build_sharded_2d(g2, 2, 2, d_p=D_P_2D, block=blk_id,
                               device="cpu")
    dv = np.zeros(4 * blk, bool)
    dn = np.zeros(4 * blk, bool)
    dn[b.del_src] = True
    dn[b.ins_src] = True
    dv[b.del_dst] = True
    lo = blk_id * blk
    dv0 = torch.from_numpy(dv[lo:lo + blk].copy())
    dn0 = torch.from_numpy(dn[lo:lo + blk].copy())
    rd, itd, tbd = td2.dfp_2d(mesh, sg2, r, dv0, dn0, trace=True)
    sd = trace_summary(tbd, itd)
    reset_registry()
    rr, itr = td2.dfp_2d(mesh, sg2, r, dv0, dn0, row_cap=64)
    cnt = get_registry().report()["counters"]
    refused = ""
    m3 = build_mesh((2, 2, 1), ("pod", "data", "model"), device="cpu")
    try:
        td2.block_of(m3)
    except ValueError as e:
        refused = str(e)
    return dict(block=blk_id, r=td.unshard_vector(r, N, mesh), it=it,
                engine=st["engine"], linf=st["linf_delta"],
                frontier=st["frontier"], d_engine=sd["engine"],
                rd=td.unshard_vector(rd, N, mesh), itd=itd,
                d_linf=sd["linf_delta"], d_frontier=sd["frontier"],
                d_delta_n=sd["delta_n"], d_pruned=sd["pruned"],
                rr=td.unshard_vector(rr, N, mesh), itr=itr, counters=cnt,
                refused=refused)


# ---------------------------------------------------------------------------
# the sharded snapshot and the mesh session
# ---------------------------------------------------------------------------

def _base(pkg):
    return pkg.powerlaw_graph(BASE["n"], BASE["m"], seed=BASE["seed"])


def _crossing_batch(g, d_p, make):
    """A batch that moves rows across d_p both ways: two new in-edges for
    three rows of in-degree d_p (they outgrow the ELL) and, for three rows
    just above d_p, deletions down to d_p // 2 (the low water mark)."""
    indeg = g.in_degree()
    ins_s, ins_d, del_s, del_d = [], [], [], []
    for v in np.nonzero(indeg == d_p)[0][:3].tolist():
        have = set(g.t_sources[g.t_offsets[v]:g.t_offsets[v + 1]].tolist())
        new = [u for u in range(g.n) if u not in have][:2]
        ins_s += new
        ins_d += [v] * len(new)
    for v in np.nonzero((indeg > d_p) & (indeg <= d_p + 4))[0][:3].tolist():
        srcs = g.t_sources[g.t_offsets[v]:g.t_offsets[v + 1]]
        srcs = srcs[srcs != v][:int(indeg[v]) - d_p // 2]
        del_s += srcs.tolist()
        del_d += [v] * srcs.size
    i32 = np.int32
    return make(del_src=np.array(del_s, i32), del_dst=np.array(del_d, i32),
                ins_src=np.array(ins_s, i32), ins_dst=np.array(ins_d, i32))


def _batches(core, stream, g):
    """The snapshot's batches, from either package's `core` and `stream`:
    three churn batches, then the crossing one."""
    out = list(stream.churn_workload(g, 0.004, 3, seed=9))
    return out + [_crossing_batch(g, D_P, core.BatchUpdate)]


SNAP_KW = ({}, dict(hi_headroom=1.0, tile_headroom=1.0, low_water=12))

def _tables(sg):
    out = {f"b{b}.{f}": getattr(blk, f).numpy().copy()
           for b, blk in enumerate(sg.buckets) for f in ("rows", "idx",
                                                         "mask")}
    for f in ("hi_pos", "hi_tiles", "hi_tmask", "hi_rowmap", "hi_slot_tiles",
              "hi_slot_off", "out_deg", "valid"):
        out[f] = getattr(sg, f).numpy().copy()
    return out


def _state(snap):
    """A copy of the shard's state (the mirrors are edited in place)."""
    return {k: np.array(v) for k, v in snap.shard_state().items()}


def _stats(st):
    return (st.rebuilt, st.rebuild_reason, st.rows_touched,
            st.tiles_touched, st.migrations, st.net_ins, st.net_del)


def _stream_rank(rank, world, jax_ckpt, port_ckpt):
    mesh = build_mesh((2, 2), ("data", "model"), device="cpu")
    out = {}
    g = _base(tc)
    # 1. the snapshot over the batches, in two configurations
    for c, kw in enumerate(SNAP_KW):
        snap = ts.ShardedSnapshot(g, mesh, d_p=D_P, tile=TILE, **kw)
        seq = [(_state(snap), _tables(snap.sg), None)]
        for b in _batches(tc, ts, g):
            st = snap.apply(ts.ingest(b, g.n))
            seq.append((_state(snap), _tables(snap.sg), _stats(st)))
        out[f"snap{c}"] = seq
        out[f"caps{c}"] = dict(snap._caps)
    # 2. the mesh session, batch by batch, against a from-scratch solve
    sess = ts.StreamSession(g, mesh=mesh, d_p=D_P, tile=TILE)
    flats, refs, engines = [], [], []
    for b in ts.churn_workload(g, 0.004, 3, seed=21):
        r = sess.apply(b)
        assert r.shape == (sess.snap.n_loc,)
        flats.append(sess.flat_ranks().numpy())
        refs.append(sess.static_reference().numpy())
        st = sess.history[-1]
        engines.append((st.engine, st.snapshot.rebuilt, st.health))
    out.update(flats=flats, refs=refs, engines=engines,
               topk=sess.topk(5)[0])
    # 3. the guard's sharded rung on a NaN batch
    gg = tc.random_graph(1024, 8192, seed=1)
    gs = ts.StreamSession(gg, mesh=mesh, d_p=D_P, tile=TILE,
                          guard=GuardConfig())
    gs.apply(tc.random_batch(gg, 0.004, seed=2))
    healthy = gs.history[-1].health
    if mesh.shard == 0:
        gs.ranks = ChaosMonkey(seed=3).poison_ranks(gs.ranks, mode="nan",
                                                    idx=[5])
    gs.apply(tc.random_batch(gs.snap.graph(), 0.002, seed=4))
    st = gs.history[-1]
    reg = get_registry()
    out["nan"] = dict(
        healthy=healthy, health=st.health, escalations=st.escalations,
        sharded=reg.counter("guard.escalate.sharded"),
        success=reg.counter("guard.escalate.success"),
        l1=tc.l1_error(gs.flat_ranks(), gs.static_reference()))
    # 4. restore the JAX mesh checkpoint, then one batch
    rs = ts.StreamSession.restore(jax_ckpt, mesh=mesh)
    out["restored"] = dict(state=_state(rs.snap),
                           tables=_tables(rs.snap.sg),
                           ranks=rs.ranks.numpy(), step=rs._batch_idx)
    rs.apply(ts.churn_workload(g, 0.004, 1, seed=31)[0])
    out["restored"]["after"] = rs.flat_ranks().numpy()
    rs.close()
    # 5. a journaled session of two batches, checkpointed after the last
    ps = ts.StreamSession(g, mesh=mesh, d_p=D_P, tile=TILE,
                          journal_dir=port_ckpt)
    for b in ts.churn_workload(g, 0.004, 2, seed=41):
        ps.apply(b)
    out["port_ckpt"] = dict(path=ps.checkpoint(), flat=ps.flat_ranks().numpy(),
                            journals=ps._journal is not None)
    ps.close()
    return out


# ---------------------------------------------------------------------------
# run_ranks itself: a failing rank, a hung collective
# ---------------------------------------------------------------------------

def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank


def _hang_on_rank_1(rank, world):
    """Rank 0 waits in a collective that rank 1 never joins."""
    import time

    if rank == 1:
        time.sleep(120)
    build_mesh((world,), ("x",), device="cpu").barrier()
    return rank
