"""Numerical-health word: solve diagnostics computed on the device.

Every solve loop converges on the same two scalars — the L∞ rank delta of
the last sweep and the iteration counter — and the final rank vector is
already resident when the loop exits. The health word packs the three
failure modes a chained DF-P stream must tell apart from success into one
int32 bitmask computed from exactly those values:

  ``H_MAX_ITER``   the loop exited at ``max_iter`` with the L∞ delta still
                   above τ;
  ``H_NONFINITE``  NaN/Inf reached the ranks. A non-finite rank propagates
                   into the sweep's L∞ |Δr| reduction (every max reduction
                   of this package, the CUDA kernels' included, lets NaN
                   win; an unaffected poisoned lane yields
                   ``|NaN - NaN| = NaN`` too), and the rank-mass sum catches
                   anything the delta misses;
  ``H_MASS_DRIFT`` Σ R drifted from 1 beyond ``mass_tol``.

``NaN > τ`` is False, so a poisoned solve leaves its loop after the first
NaN sweep rather than spinning to ``max_iter``.

A torch copy of the JAX package's `repro.guard.health`.
"""
from __future__ import annotations

import torch

__all__ = ["HEALTH_OK", "H_MAX_ITER", "H_NONFINITE", "H_MASS_DRIFT",
           "MASS_TOL", "health_word", "rank_mass", "health_flags",
           "describe_health"]

HEALTH_OK = 0
H_MAX_ITER = 1 << 0     # exited at max_iter, delta still > tau
H_NONFINITE = 1 << 1    # NaN/Inf in the final delta or rank mass
H_MASS_DRIFT = 1 << 2   # |sum(R) - 1| > mass_tol

#: default rank-mass tolerance. DF/DF-P are *approximate* by design: an
#: unaffected vertex keeps its previous-graph rank, so a healthy chained
#: solve legitimately drifts Σ R by O(τ_f · |frontier boundary|). The
#: default sits two decades above τ_f = 1e-6 and well below real
#: corruption: the smallest exponent-bit flip doubles one rank.
MASS_TOL = 1e-4

_FLAG_NAMES = ((H_MAX_ITER, "max_iter"), (H_NONFINITE, "nonfinite"),
               (H_MASS_DRIFT, "mass_drift"))


def health_word(delta: torch.Tensor, iters, mass: torch.Tensor, *,
                tau: float, max_iter: int,
                mass_tol: float = MASS_TOL) -> torch.Tensor:
    """Pack the post-loop scalars into the int32 health bitmask.

    ``delta`` is the final L∞ |Δr| the loop converged on (a 0-d tensor),
    ``iters`` the iteration count, ``mass`` the Σ R of the final ranks.
    Returns a 0-d int32 tensor on delta's device.
    """
    bad_iter = (torch.as_tensor(iters, device=delta.device) >= max_iter) \
        & (delta > tau)
    nonfinite = ~(torch.isfinite(delta) & torch.isfinite(mass))
    drift = torch.abs(mass - 1.0) > mass_tol
    return (bad_iter.to(torch.int32) * H_MAX_ITER
            | nonfinite.to(torch.int32) * H_NONFINITE
            | drift.to(torch.int32) * H_MASS_DRIFT)


def rank_mass(r: torch.Tensor) -> torch.Tensor:
    """Σ R over the vertices."""
    return torch.sum(r)


def health_flags(word: int) -> tuple:
    """Decode a host-side word into its flag names, e.g. ('max_iter',)."""
    return tuple(name for bit, name in _FLAG_NAMES if int(word) & bit)


def describe_health(word: int) -> str:
    """Human-readable form: 'ok' or '+'-joined flag names."""
    return "+".join(health_flags(word)) or "ok"
