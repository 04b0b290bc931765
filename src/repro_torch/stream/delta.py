"""Batch ingestion for the streaming engine: dedup, coalescing, padding.

A raw ``BatchUpdate`` may contain duplicate pairs, self-loop deletions (which
the paper's protocol never removes — self-loops are re-added with every
batch), and pairs present in both lists. ``ingest`` canonicalizes it into a
``Delta`` whose deletion/insertion sets are unique and disjoint, matching
``core.graph.apply_batch`` semantics exactly (deletions apply first, then
insertions; so a pair in both lists nets out to "ensure present" — i.e. a
plain insertion).

``Delta.to_device`` pads both sides to one shared power-of-two capacity
with the id-``n`` sentinel, which the engines drop. A copy of the JAX
package's `repro.stream.delta`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.dynamic import DeviceBatch, batch_to_device
from ..core.graph import BatchUpdate, edge_keys, keys_to_edges, next_pow2
from ..guard.validate import validate_batch

__all__ = ["Delta", "ingest", "next_pow2"]


@dataclasses.dataclass(frozen=True)
class Delta:
    """Canonical Δ^t: unique, disjoint deletion/insertion pairs (int32)."""

    n: int
    del_src: np.ndarray
    del_dst: np.ndarray
    ins_src: np.ndarray
    ins_dst: np.ndarray

    @property
    def nd(self) -> int:
        return int(self.del_src.shape[0])

    @property
    def ni(self) -> int:
        return int(self.ins_src.shape[0])

    @property
    def size(self) -> int:
        return self.nd + self.ni

    def to_device(self, pad_to: int | None = None, device=None
                  ) -> DeviceBatch:
        """Stage as a DeviceBatch, both sides padded to one pow2 capacity
        (on CUDA unless `device` names another)."""
        if pad_to is None:
            pad_to = next_pow2(max(self.nd, self.ni))
        b = BatchUpdate(del_src=self.del_src, del_dst=self.del_dst,
                        ins_src=self.ins_src, ins_dst=self.ins_dst)
        return batch_to_device(b, self.n, pad_to=pad_to, device=device)


def _unique_pairs(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    if src.size == 0:
        return np.zeros(0, np.int64)
    return np.unique(edge_keys(n, src, dst))


def ingest(batch: BatchUpdate, n: int, coalesce: str = "del_first",
           policy: str = "raise") -> Delta:
    """Canonicalize a BatchUpdate into a Delta.

    coalesce="del_first" (default) matches apply_batch: a pair in both lists
    is deleted then inserted, so it survives as an insertion. "cancel" treats
    the pair as insert-then-delete within the batch window (true temporal
    streams) and drops it from both sides.

    Every batch is validated first (`guard.validate`): ids outside [0, n)
    would silently alias other edges under the ``src*n + dst`` key encoding
    below. ``policy="raise"`` (default) rejects such batches with
    ``ValidationError``; ``policy="quarantine"`` drops the offending pairs
    and ingests the rest.
    """
    batch, _ = validate_batch(batch, n, policy=policy)
    dk = _unique_pairs(n, batch.del_src, batch.del_dst)
    ik = _unique_pairs(n, batch.ins_src, batch.ins_dst)
    if dk.size:  # self-loops are never deleted (paper §5.1.4)
        ds, dd = keys_to_edges(n, dk)
        dk = dk[ds != dd]
    both = np.intersect1d(dk, ik, assume_unique=True)
    if both.size:
        dk = np.setdiff1d(dk, both, assume_unique=True)
        if coalesce == "cancel":
            ik = np.setdiff1d(ik, both, assume_unique=True)
        elif coalesce != "del_first":
            raise ValueError(f"unknown coalesce mode: {coalesce!r}")
    ds, dd = keys_to_edges(n, dk)
    is_, id_ = keys_to_edges(n, ik)
    return Delta(n=n, del_src=ds, del_dst=dd, ins_src=is_, ins_dst=id_)
