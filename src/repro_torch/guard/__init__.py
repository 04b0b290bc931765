"""repro_torch.guard — fault-tolerant streaming sessions.

The paper's DF-P protocol assumes clean batch streams and convergent
chained solves; a production stream session must survive malformed deltas,
numerically-poisoned or non-converging solves, and process crashes. This
package wraps the streaming lifecycle in four pieces:

  * ``validate``  — strict ingest validation with a raise-vs-quarantine
    policy knob (out-of-range ids would silently corrupt ``edge_keys``);
  * ``health``    — a health word every solve can return (converged at
    max_iter, NaN/Inf, rank-mass drift), computed on the device and
    consumed by the session's escalation ladder (a dense DF-P retry, or
    the sharded one on a mesh, then a static recompute);
  * ``journal``   — write-ahead delta journal + atomic session checkpoints;
    ``StreamSession.restore(dir)`` replays to bit-identical state;
  * ``chaos``     — seeded fault injector (corrupt deltas, NaN/bit-flip
    poisoning, forced non-convergence, torn journals) for tests and the
    card's smoke run.

``GuardConfig`` is the one knob object the session takes; ``guard=None``
keeps the ungated behaviour. A copy of the JAX package's `repro.guard`,
with the same exports.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from .validate import (POLICIES, QuarantineReport, ValidationError,
                       validate_batch)
from .health import (HEALTH_OK, H_MASS_DRIFT, H_MAX_ITER, H_NONFINITE,
                     MASS_TOL, describe_health, health_flags, health_word,
                     rank_mass)
from .journal import (DeltaJournal, JournalRecord, journal_path,
                      load_session_checkpoint, save_session_checkpoint)
from .chaos import ChaosMonkey

__all__ = [
    "GuardConfig",
    "POLICIES", "QuarantineReport", "ValidationError", "validate_batch",
    "HEALTH_OK", "H_MAX_ITER", "H_NONFINITE", "H_MASS_DRIFT", "MASS_TOL",
    "health_word", "rank_mass", "health_flags", "describe_health",
    "DeltaJournal", "JournalRecord", "journal_path",
    "save_session_checkpoint", "load_session_checkpoint",
    "ChaosMonkey",
]


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Fault-tolerance knobs for a ``StreamSession``.

    With a ``GuardConfig`` attached the session (a) applies the ingest
    ``policy`` to every raw batch, (b) asks every solve for its health word
    and walks the escalation ladder on any set bit, and (c) optionally
    audits chained drift against ``static_reference()`` every
    ``audit_every`` batches, resyncing when it exceeds ``audit_tol``.
    """
    #: ingest id-range policy: "raise" (strict) or "quarantine"
    policy: str = "raise"
    #: |Σ R - 1| tolerance for the H_MASS_DRIFT health bit
    mass_tol: float = MASS_TOL
    #: max escalation rungs attempted per batch (2 = retry + resync)
    retry_budget: int = 2
    #: run a drift audit every K applied batches (0 = never)
    audit_every: int = 0
    #: L1(chained, static_reference) threshold that triggers auto-resync
    audit_tol: float = 1e-8
    #: solve params for the recovery rungs; None = the session's params
    #: with the full default iteration budget restored (so a chaos-starved
    #: ``max_iter=1`` session still recovers with a real solve)
    recovery_params: Optional[object] = None
    #: where escalation-exhaustion post-mortem bundles land; None falls
    #: back to the session's journal_dir, then ``$REPRO_POSTMORTEM_DIR``
    #: (unset: no bundle is written)
    postmortem_dir: Optional[str] = None

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(f"unknown guard policy: {self.policy!r}")
