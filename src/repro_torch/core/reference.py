"""Pure-numpy oracles for tests and error measurement (paper §5.1.5).

`reference_pagerank` is the paper's reference: Static PageRank on the updated
graph at an extremely low tolerance (τ = 1e-100, i.e. it always runs to the
500-iteration cap), used as ground truth for L1 error of every approach.
"""
from __future__ import annotations

import numpy as np

from .graph import Graph

__all__ = ["reference_pagerank", "numpy_pagerank", "l1_error"]


def numpy_pagerank(g: Graph, alpha: float = 0.85, tau: float = 1e-10,
                   max_iter: int = 500, r0: np.ndarray | None = None):
    """Pull-based synchronous power iteration in float64 (Eq. 1)."""
    n = g.n
    out_deg = g.out_degree().astype(np.float64)
    r = np.full(n, 1.0 / n) if r0 is None else np.asarray(r0, np.float64).copy()
    src = g.t_sources  # in-neighbors, CSR over t_offsets
    seg = np.repeat(np.arange(n), np.diff(g.t_offsets))
    it = 0
    for it in range(1, max_iter + 1):
        c = r / out_deg
        s = np.bincount(seg, weights=c[src], minlength=n)
        r_new = (1.0 - alpha) / n + alpha * s
        delta = np.max(np.abs(r_new - r))
        r = r_new
        if delta <= tau:
            break
    return r, it


def reference_pagerank(g: Graph, alpha: float = 0.85, max_iter: int = 500):
    return numpy_pagerank(g, alpha=alpha, tau=1e-100, max_iter=max_iter)[0]


def l1_error(r, ref) -> float:
    """Σ|r - ref| in float64; either side may be a numpy array or a tensor."""
    return float(np.sum(np.abs(_host(r) - _host(ref))))


def _host(x) -> np.ndarray:
    if hasattr(x, "detach"):              # a torch tensor, on any device
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)
