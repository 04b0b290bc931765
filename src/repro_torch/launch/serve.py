"""Serving launcher: prefill a batch of prompts, then batched greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
        --smoke --device cpu --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-9b
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --arch qwen2-1.5b --smoke --device cpu

The JAX package's `repro.launch.serve`: the prompts are
prefilled by stepping every token through `decode_step` (correct for every
cache kind; the fused `prefill_step` is the other entry point, and the
one that runs the flash_attention kernel), then greedy argmax decoding.
Weights are random, drawn from `seed`; prompts come from
`data.batch_for(cfg, batch, prompt_len, 0, seed)`, as in the JAX package:
token ids, or with `embed_inputs` (qwen2-vl-2b, musicgen-large, whose
frontends are stubs) frame or patch embeddings, stepped in one position
at a time, after which each generated token goes in as its `embed` row
(M-RoPE's three streams all at the step's position, as JAX's decode
gives them).
deepseek-v3-671b (MLA; its cache is the latent `ckv` and `krope`) is
served the same way; at full width it fits one card only cut by layers
(`dataclasses.replace(cfg, n_layers=5)`: 3 dense, 2 MoE layers, ≈ 53 GB
of bf16 weights).
The int8 KV cache is the config's `kv_cache_dtype="int8"`, reached by
`serve(dataclasses.replace(cfg, kv_cache_dtype="int8"), ...)` as in the
JAX dry run; there is no flag for it, as in JAX's launcher.

On a mesh (`serve(cfg, ..., mesh=)`, one process a rank): every rank
takes the whole batch of prompts, runs its rows on its heads
(`LMModel(cfg, mesh=)`; the decode cache is this rank's pieces in
`models.model.cache_specs`' layout) and gets the whole batch's logits,
the same bits on every rank, so every rank draws the same greedy tokens;
a generated token's `embed` row comes from the vocabulary-sharded
lookup. Under torchrun with more than one rank `main` builds
`launch.mesh.make_local_mesh()`, as JAX's `main` builds its local mesh;
rank 0 prints.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config, smoke_config
from ..data.pipeline import batch_for
from ..models import LMModel
from .mesh import make_local_mesh, world_size

__all__ = ["serve", "generate", "main"]


def generate(model: LMModel, prompts: np.ndarray, gen: int):
    """Greedy decoding after a stepped prefill of `prompts` with an
    already-built model: token ids [B, P], or embeddings [B, P, d] for a
    config with `embed_inputs`. Returns (generated tokens [B, gen] as
    numpy, tokens/s over the B * (P + gen) steps); on a mesh every rank
    passes the whole batch and gets the whole batch's tokens."""
    key = "embeddings" if model.cfg.embed_inputs else "tokens"
    B, prompt_len = prompts.shape[:2]
    total = prompt_len + gen
    cache = model.init_cache(B, total)
    inputs = torch.as_tensor(prompts, device=model.device)
    t0 = time.perf_counter()
    logits = None
    for t in range(prompt_len):
        logits, cache = model.decode_step(
            cache, {key: inputs[:, t:t + 1]}, t)
    out = []
    nxt = torch.argmax(logits[:, -1], dim=-1)
    for t in range(prompt_len, total):
        out.append(nxt)
        piece = (model.embed_rows(nxt[:, None])
                 if model.cfg.embed_inputs else nxt[:, None])
        logits, cache = model.decode_step(cache, {key: piece}, t)
        nxt = torch.argmax(logits[:, -1], dim=-1)
    toks = torch.stack(out, dim=1).cpu().numpy()   # waits for the device
    dt = time.perf_counter() - t0
    return toks, B * total / dt


def serve(cfg, *, batch: int, prompt_len: int, gen: int, mesh=None, seed=0,
          device=None):
    """Returns (generated tokens [B, gen], tokens/sec). On CUDA unless
    `device` names another (on a mesh, its device); raises without a
    card. On a mesh, this rank's part of the run: the tokens are the
    whole batch's on every rank."""
    model = LMModel(cfg, mesh=mesh, device=device, seed=seed)
    prompts = batch_for(cfg, batch, prompt_len, 0, seed)
    return generate(model, prompts["embeddings" if cfg.embed_inputs
                                   else "tokens"], gen)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    mesh = make_local_mesh(device=args.device) if world_size() > 1 \
        else None
    toks, tps = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                      gen=args.gen, mesh=mesh, device=args.device)
    if mesh is None or mesh.rank == 0:
        if mesh is not None:
            print(f"arch={cfg.name} mesh={mesh.shape} "
                  f"backend={mesh.backend} device={mesh.device}")
        print(f"generated {toks.shape} tokens at {tps:.1f} tok/s")
        print(toks[:, :12])


if __name__ == "__main__":
    main()
