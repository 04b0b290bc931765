"""Temporal-stream replayer: drive workloads through a StreamSession.

Feeds `temporal_stream` / `random_batch` workloads batch-by-batch through a
session, recording per-batch latency split into the lifecycle stages
(ingest / snapshot host / snapshot device / DF-P solve) plus optional
ground-truth error against a from-scratch static recompute — the paper's
§5.1.4 measurement protocol as a reusable harness (`python -m
repro_torch.stream` runs it from the command line).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Tuple

from ..core.graph import BatchUpdate, Graph, random_batch
from ..core.reference import l1_error
from .session import BatchStats, StreamSession

__all__ = ["ReplayRecord", "replay", "churn_workload", "mixed_workload"]


@dataclasses.dataclass
class ReplayRecord:
    """One batch of the replay: latency breakdown + optional L1 error."""
    t: int
    stats: BatchStats
    l1_vs_static: Optional[float] = None

    @property
    def total_s(self) -> float:
        return self.stats.total_s


def replay(session: StreamSession, batches: Iterable[BatchUpdate],
           verify_every: int = 0,
           on_batch: Optional[Callable[[ReplayRecord], None]] = None
           ) -> List[ReplayRecord]:
    """Apply `batches` in order; every `verify_every`-th batch (0 = never)
    also recomputes static PageRank from scratch on the maintained snapshot
    and records the L1 gap — the acceptance metric for incremental
    maintenance (ranks must track the from-scratch answer)."""
    records: List[ReplayRecord] = []
    for t, b in enumerate(batches):
        session.apply(b)
        err = None
        if verify_every and (t + 1) % verify_every == 0:
            err = l1_error(session.flat_ranks(), session.static_reference())
        rec = ReplayRecord(t=t, stats=session.history[-1], l1_vs_static=err)
        records.append(rec)
        if on_batch is not None:
            on_batch(rec)
    return records


def churn_workload(g: Graph, frac: float, n_batches: int,
                   insert_frac: float = 0.8, seed: int = 0
                   ) -> List[BatchUpdate]:
    """Uniformly-random churn batches (80/20 insert/delete, paper §5.1.4)
    against a fixed base graph — exercises deletions and degree crossings."""
    return [random_batch(g, frac, insert_frac=insert_frac, seed=seed + t)
            for t in range(n_batches)]


def mixed_workload(g: Graph, frac: float, n_churn: int = 3,
                   n_insert: int = 2, seed: int = 0
                   ) -> List[Tuple[str, BatchUpdate]]:
    """(kind, batch) pairs: `n_churn` churn batches of frac·|E|, then
    `n_insert` insert-only batches of about 1,000·n/2^22 uniform edges (a
    temporal stream's arrivals; 1,000 at n = 2^22)."""
    n_ins = max(1, round(1000 * g.n / 2 ** 22))
    out = [("churn", b) for b in churn_workload(g, frac, n_churn, seed=seed)]
    out += [("insert", random_batch(g, n_ins / g.m, insert_frac=1.0,
                                    seed=seed + 100 + k))
            for k in range(n_insert)]
    return out
