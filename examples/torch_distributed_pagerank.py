"""Distributed PageRank on `repro_torch`, one process per shard: the 1-D
vertex partition and the beyond-paper 2-D edge partition, both validated
against the oracle, then a sharded StreamSession chaining DF-P over a live
update stream (the port of examples/distributed_pagerank.py).

  # four gloo ranks on the CPU
  PYTHONPATH=src torchrun --nproc-per-node 4 \\
      examples/torch_distributed_pagerank.py --device cpu
  # one rank on the card (NCCL)
  PYTHONPATH=src torchrun --nproc-per-node 1 \\
      examples/torch_distributed_pagerank.py

Every rank holds its shard and its slice of the ranks; `unshard_vector`
and the session's `flat_ranks` all-gather the dense vector. The 2-D part
runs when the world size is a square (1, 4, 9, ...). Only rank 0 prints.
"""
import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.core import (l1_error, powerlaw_graph,  # noqa: E402
                              reference_pagerank, temporal_stream)
from repro_torch.core.distributed import (  # noqa: E402
    build_sharded, distributed_static_pagerank, sharded_caps,
    unshard_vector)
from repro_torch.core.distributed2d import (block_of,  # noqa: E402
                                            build_sharded_2d, pagerank_2d)
from repro_torch.core.mesh import build_mesh, init_mesh  # noqa: E402
from repro_torch.stream import StreamSession, replay  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on a card, gloo on "
                         "the CPU; several ranks on one card need gloo)")
    args = ap.parse_args(argv)
    mesh = init_mesh(device=args.device, backend=args.backend)
    nd, dev = mesh.size, mesh.device
    say = print if mesh.rank == 0 else (lambda *a, **k: None)

    g = powerlaw_graph(2_000, 30_000, seed=1)
    ref = reference_pagerank(g)

    # 1-D: vertices over every rank; per iteration an all-gather of c
    # (V floats). Each shard is laid out by the same `build_hybrid_rows`
    # as the single-device hybrid, and the loop runs the same `rank_step`.
    sg = build_sharded(g, nd, d_p=16, tile=64, shard=mesh.shard, device=dev)
    r0 = torch.full((sg.n_loc,), 1.0 / g.n, dtype=torch.float64, device=dev)
    r1, it1 = distributed_static_pagerank(mesh, sg, r0)
    err1 = l1_error(unshard_vector(r1, g.n, mesh), ref)
    say(f"1-D over {nd} ranks ({mesh.backend}, {dev}): {it1} iters, "
        f"caps={sharded_caps(sg)}, L1 vs oracle = {err1:.2e}")

    # 2-D: edge blocks on an r x r mesh; per iteration a gather of V/r
    side = math.isqrt(nd)
    if side * side == nd:
        mesh2 = build_mesh((side, side), ("data", "model"), device=dev)
        sg2 = build_sharded_2d(g, side, side, d_p=8, block=block_of(mesh2),
                               device=dev)
        blk = sg2.out_deg.shape[0]
        r2, it2 = pagerank_2d(mesh2, sg2, torch.full(
            (blk,), 1.0 / g.n, dtype=torch.float64, device=dev))
        say(f"2-D on a {side}x{side} mesh: {it2} iters, L1 vs oracle = "
            f"{l1_error(unshard_vector(r2, g.n, mesh2), ref):.2e}")
    else:
        say(f"2-D skipped: {nd} ranks are not a square mesh")

    # sharded streaming: every rank maintains its shard of the layout in
    # place (touched rows only) and the batch's frontier is seeded on the
    # device
    base, batches = temporal_stream(4_000, 60_000, n_batches=6, seed=0)
    sess = StreamSession(base, mesh=mesh, d_p=16, tile=64)
    say(f"\nsharded stream: base {base.n} vertices / {base.m} edges over "
        f"{sess.snap.nd} shards (n_loc={sess.snap.n_loc}); warm start "
        f"{int(sess._init_iters)} iters")
    for rec in replay(sess, batches, verify_every=2):
        h = rec.stats
        err = ("" if rec.l1_vs_static is None
               else f"  L1 vs from-scratch: {rec.l1_vs_static:.2e}")
        say(f"batch {rec.t}: |Δ|={h.batch_size:5d}  engine={h.engine}"
            f"  iters={h.iters:3d}  rows_touched="
            f"{h.snapshot.rows_touched:4d}  rebuilt={h.snapshot.rebuilt}"
            f"{err}")
    ids, vals = sess.topk(5)
    say("\ntop-5 vertices by rank:")
    for i, v in zip(ids, vals):
        say(f"  vertex {i:5d}  rank {v:.6f}")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
