"""Data pipeline: deterministic, seekable token streams.

Training at scale needs (a) a data source whose position is a pure function
of the step (so restart-from-checkpoint replays nothing and skips nothing),
(b) per-host sharding of the batch dimension, (c) zero-copy staging to
device. `SyntheticLM` generates a fixed-vocabulary Markov-ish stream on the
fly (CPU-cheap, infinite); `PackedFile` memory-maps a token file and serves
packed sequences. Both expose `batch_at(step)` — the seekable contract used
by the restart machinery.

A copy of the JAX package's `repro.data.pipeline`, which is numpy only:
the same seed gives the same tokens in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

__all__ = ["SyntheticLM", "PackedFile", "batch_for"]


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    embed_dim: Optional[int] = None     # audio/vlm stub: emit embeddings too
    mrope: bool = False

    def batch_at(self, step: int) -> dict:
        """Deterministic batch for a given step (seekable)."""
        rng = np.random.default_rng((self.seed, step))
        # cheap structured stream: mixture of ramps and repeats, not uniform
        base = rng.integers(0, self.vocab, (self.batch, self.seq // 2),
                            dtype=np.int32)
        tokens = np.concatenate([base, (base + 1) % self.vocab], axis=1)
        out = {}
        if self.embed_dim is None:
            out["tokens"] = tokens
        else:
            emb = rng.standard_normal((self.batch, self.seq,
                                       self.embed_dim)).astype(np.float32)
            out["embeddings"] = emb
            out["labels"] = tokens
        if self.mrope:
            pos = np.broadcast_to(np.arange(self.seq, dtype=np.int32),
                                  (self.batch, 3, self.seq)).copy()
            out["positions"] = pos
        return out


@dataclasses.dataclass
class PackedFile:
    """Memory-mapped int32 token file served as packed sequences."""
    path: str
    batch: int
    seq: int

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=np.int32, mode="r")
        self._per_step = self.batch * self.seq

    @property
    def n_steps(self) -> int:
        return self._data.shape[0] // self._per_step

    def batch_at(self, step: int) -> dict:
        lo = (step % self.n_steps) * self._per_step
        chunk = np.asarray(self._data[lo:lo + self._per_step])
        return {"tokens": chunk.reshape(self.batch, self.seq)}


def batch_for(cfg, B: int, S: int, step: int, seed: int = 0) -> dict:
    """Arch-aware synthetic batch (matches input_specs structurally)."""
    src = SyntheticLM(vocab=cfg.vocab, batch=B, seq=S, seed=seed,
                      embed_dim=cfg.d_model if cfg.embed_inputs else None,
                      mrope=cfg.rope == "mrope")
    return src.batch_at(step)
