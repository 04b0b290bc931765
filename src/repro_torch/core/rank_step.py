"""The single shared ``updateRanks`` math (paper Alg. 3, Eq. 1 / Eq. 2).

One ``updateRanks()`` serves Static, ND, DT, DF and DF-P alike ("disable the
affected flags to utilize the same function for Static PageRank"). Every
plain-PyTorch engine path of this package takes the formulas from here and
supplies only its own pull. The CUDA kernels carry the same formulas in one
``__device__`` function (`csrc/epilogue.cuh`), shared by `fused_ell_update`
and `pr_update`.

The math itself, per vertex v with pulled contribution s = Σ R[u]/|out(u)|:

  Eq. 1 (plain):        R'[v] = (1-α)/N + α·s
  Eq. 2 (closed form):  R'[v] = ((1-α)/N + α·(s - R[v]/d_v)) / (1 - α/d_v)
                        — absorbs the guaranteed self-loop analytically.
  prune:   affected'[v] = affected[v] ∧ ¬(Δr/max(R,R') ≤ τ_p)
  δ_N:     rel > τ_f   (rel is 0 for unaffected vertices: R' == R there)
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

__all__ = ["teleport", "rank_value", "relative_change", "rank_step"]


def teleport(alpha: float, n_norm: int) -> float:
    """The (1-α)/N teleport constant (a Python float: f64 on every path).

    `n_norm` is the number of *real* vertices.
    """
    return (1.0 - alpha) / n_norm


def rank_value(s: torch.Tensor, r: torch.Tensor, d: torch.Tensor, *,
               alpha: float, c0: float, closed_form: bool) -> torch.Tensor:
    """Candidate new rank from the pulled in-neighbor sum `s`.

    `d` is the out-degree (≥ 1: self-loops are guaranteed), already in the
    rank dtype. `closed_form` selects Eq. 2 over Eq. 1.
    """
    if closed_form:
        return (c0 + alpha * (s - r / d)) / (1.0 - alpha / d)
    return c0 + alpha * s


def relative_change(r_new: torch.Tensor, r_old: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(|Δr|, |Δr| / max(r_new, r_old)) — the paper's pruning/frontier metric.

    `torch.maximum` propagates NaN, as `jnp.maximum` does."""
    dr = torch.abs(r_new - r_old)
    return dr, dr / torch.maximum(r_new, r_old)


def rank_step(s: torch.Tensor, r: torch.Tensor, affected: torch.Tensor,
              out_deg: torch.Tensor, *, alpha: float, n_norm: int,
              tau_f: float, tau_p: float, prune: bool, closed_form: bool,
              track_frontier: bool,
              linf_fn: Optional[Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """One dense-shaped synchronous rank sweep given the pulled sums `s`.

    Returns (r_new, affected', delta_N, linf_delta); the last is a 0-d
    tensor on r's device (NaN if any |Δr| is NaN: `torch.max` propagates
    it, which the health word relies on). `linf_fn(r_new, r)`, when
    given, computes that L∞ instead of ``torch.max(|Δr|)`` — the staged
    sweep passes the `linf_delta` kernel, which gives the same value.
    """
    d = out_deg.to(r.dtype)
    rv = rank_value(s, r, d, alpha=alpha, c0=teleport(alpha, n_norm),
                    closed_form=closed_form)
    r_new = torch.where(affected, rv, r)
    dr, rel = relative_change(r_new, r)
    if prune:
        affected = affected & ~(rel <= tau_p)
    if track_frontier:
        delta_n = rel > tau_f
    else:
        delta_n = torch.zeros_like(affected)
    linf = torch.max(dr) if linf_fn is None else linf_fn(r_new, r)
    return r_new, affected, delta_n, linf
