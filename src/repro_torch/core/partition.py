"""Alg. 4 — parallel vertex partitioning by degree (host numpy version).

The paper partitions vertex IDs into low-degree-first order with two
exclusive-prefix-sum passes; `build_hybrid` calls this when it (re)builds a
layout. A copy of the JAX package's numpy `partition_by_degree`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["partition_by_degree"]


def partition_by_degree(deg: np.ndarray, d_p: int):
    """Return (perm, n_low): vertex ids with deg<=d_p first, stable order.

    Mirrors Alg. 4: boolean buffer -> exclusive scan -> scatter, twice.
    """
    deg = np.asarray(deg)
    n = deg.shape[0]
    low = deg <= d_p
    bk = np.zeros(n + 1, dtype=np.int64)
    bk[1:] = np.cumsum(low)           # exclusive scan of low flags
    n_low = int(bk[n])
    perm = np.empty(n, dtype=np.int32)
    ids = np.arange(n, dtype=np.int32)
    perm[bk[:n][low]] = ids[low]
    bk2 = np.zeros(n + 1, dtype=np.int64)
    bk2[1:] = np.cumsum(~low)
    perm[n_low + bk2[:n][~low]] = ids[~low]
    return perm, n_low
