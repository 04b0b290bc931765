"""Alg. 4 — parallel vertex partitioning by degree.

The paper partitions vertex IDs into low-degree-first order with two
exclusive-prefix-sum passes. `partition_by_degree` is the host numpy
version `build_hybrid` calls when it (re)builds a layout;
`partition_by_degree_device` is the same scan formulation on tensors, on
whatever device they lie (the JAX package's `partition_by_degree_jax`).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["partition_by_degree", "partition_by_degree_device"]


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


def partition_by_degree_device(deg: torch.Tensor, d_p: int):
    """Alg. 4 on tensors (two exclusive scans and a scatter), on `deg`'s
    device. Returns (perm [n] int32, n_low 0-d int64 tensor)."""
    n = deg.shape[0]
    low = deg <= d_p
    lo, hi = low.long(), (~low).long()
    ids = torch.arange(n, dtype=torch.int32, device=deg.device)
    scan_low = torch.cumsum(lo, 0) - lo            # exclusive scans
    n_low = lo.sum()
    scan_hi = torch.cumsum(hi, 0) - hi
    pos = torch.where(low, scan_low, n_low + scan_hi)
    perm = torch.zeros(n, dtype=torch.int32, device=deg.device)
    perm[pos] = ids
    return perm, n_low
