"""Replay the stream of `chip_smoke.py`'s phase 8 on a powerlaw graph:

    python -m repro_torch.stream --n 65536 --m 1048576 --tau 1e-10 \\
        --device cpu

builds `powerlaw_graph(n, m, alpha=1.0, seed)`, replays `mixed_workload`
(the phase's batches at the same n, m and seed) through a StreamSession at
the session's frontier tolerances and `--tau`, and prints each batch's
engine, iterations and L1 against a from-scratch solve.
"""
from __future__ import annotations

import argparse

from ..core.graph import powerlaw_graph
from ..core.pagerank import PRParams
from .replay import mixed_workload, replay
from .session import StreamSession


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n", type=int, default=65536)
    p.add_argument("--m", type=int, default=1048576)
    p.add_argument("--frac", type=float, default=1e-4)
    p.add_argument("--tau", type=float, default=1e-10,
                   help="the session's convergence tolerance")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    args = p.parse_args(argv)
    g = powerlaw_graph(args.n, args.m, alpha=1.0, seed=args.seed)
    sess = StreamSession(g, params=PRParams(tau=args.tau, tau_f=1e-9,
                                            tau_p=1e-9), device=args.device)
    work = mixed_workload(g, args.frac, seed=args.seed + 200)
    print(f"n={g.n} m={g.m} tau={args.tau} device={sess.device}")
    for (kind, _), rec in zip(work, replay(sess, [b for _, b in work],
                                           verify_every=1)):
        print(f"batch {rec.t + 1} {kind} |batch|={rec.stats.batch_size} "
              f"{rec.stats.engine} {rec.stats.iters} iters, L1 vs "
              f"from-scratch {rec.l1_vs_static:.3e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
