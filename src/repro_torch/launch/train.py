"""Training launcher: the train loop for any --arch config on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128 --ckpt run1

The JAX package's `repro.launch.train` on one device, CUDA unless
`--device` names another. Its mesh flags (`--production-mesh`,
`--multi-pod`, `--model-parallel` above 1) wait for the sharded training
path (ROADMAP A9) and raise `NotImplementedError`.
"""
from __future__ import annotations

import argparse

from ..configs import get_config, smoke_config
from ..models.attention import later
from ..train.loop import train

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
    if args.production_mesh or args.multi_pod or args.model_parallel > 1:
        raise later("training on a mesh (--production-mesh, --multi-pod, "
                    "--model-parallel)")

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    print(f"arch={cfg.name} device={args.device or 'cuda'}")
    params, history = train(cfg, steps=args.steps, batch=args.batch,
                            seq=args.seq, ckpt_dir=args.ckpt,
                            ckpt_every=args.ckpt_every, device=args.device)
    for h in history:
        print(h)
    print(f"final loss: {history[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
