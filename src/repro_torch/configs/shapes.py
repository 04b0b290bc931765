"""Assigned input-shape set for the LM-family architectures (40 cells).

A copy of the JAX package's `repro.configs.shapes`.

train_4k    : train_step,  seq 4096,    global_batch 256
prefill_32k : prefill_step, seq 32768,  global_batch 32
decode_32k  : decode_step (1 new token, KV cache of 32768), global_batch 128
long_500k   : decode_step (1 new token, state/cache at 524288), batch 1
              — sub-quadratic archs only (DESIGN.md §5)
"""
from __future__ import annotations

import dataclasses

from .base import ArchConfig

__all__ = ["ShapeSpec", "SHAPES", "shape_applies", "cells"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def shape_applies(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip(full-attn): quadratic/unbounded KV at 500k"
    return True, ""


def cells(configs: list[ArchConfig]) -> list[tuple[ArchConfig, ShapeSpec]]:
    return [(c, s) for c in configs for s in SHAPES.values()]
