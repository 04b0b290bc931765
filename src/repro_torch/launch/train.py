"""Training launcher: the train loop for any --arch config, on one device
or on a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt run1
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen2-1.5b --smoke --device cpu --model-parallel 2

The JAX package's `repro.launch.train`, CUDA unless `--device` names
another. Under torchrun (or with a mesh flag) it builds the mesh as JAX's
launcher does: `--production-mesh` the (16, 16) mesh (with `--multi-pod`
(2, 16, 16)), else the local (world / `--model-parallel`,
`--model-parallel`) one; a world size the mesh does not fit raises
`ValueError`. One process without a mesh flag trains on one device. Rank
0 prints.
"""
from __future__ import annotations

import argparse
import os

from ..configs import get_config, smoke_config
from ..train.loop import train
from .mesh import make_local_mesh, make_production_mesh

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    mesh = None
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod,
                                    device=args.device)
    elif (args.multi_pod or args.model_parallel > 1
          or "WORLD_SIZE" in os.environ):
        mesh = make_local_mesh(args.model_parallel, device=args.device)
    lead = mesh is None or mesh.rank == 0
    if lead:
        where = (f"mesh={mesh.shape} backend={mesh.backend} "
                 f"device={mesh.device}" if mesh is not None else
                 f"device={args.device or 'cuda'}")
        print(f"arch={cfg.name} {where}")
    params, history = train(cfg, steps=args.steps, batch=args.batch,
                            seq=args.seq, ckpt_dir=args.ckpt,
                            ckpt_every=args.ckpt_every, mesh=mesh,
                            device=args.device)
    if lead:
        for h in history:
            print(h)
        print(f"final loss: {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
