"""Ingest validation & quarantine, in front of the edge keying.

``edge_keys`` packs (src, dst) into ``src * n + dst`` — an id outside
``[0, n)`` silently aliases another edge's key (``dst = n`` collides with
``(src+1, 0)``; negative ids wrap through Python's floor semantics), so a
single malformed pair would corrupt the snapshot's sorted key set with no
error anywhere. This module puts a strict gate in front of the keying:

  * structural checks (always fatal): src/dst length mismatch, non-1-D
    arrays, non-integral dtypes — a batch whose *shape* is wrong is a
    programming error upstream, not streaming noise;
  * per-pair id-range checks, governed by ``policy``:
      - ``"raise"`` (the strict default `stream.ingest` applies): any
        out-of-range id raises ``ValidationError`` naming the offender;
      - ``"quarantine"``: offending pairs are *removed* from the batch and
        returned in a ``QuarantineReport`` for inspection — the stream
        keeps flowing on the clean remainder.

Every quarantining call counts ``guard.quarantined`` (pairs dropped) and
``guard.quarantined_batches`` in the `obs` registry.

A copy of the JAX package's `repro.guard.validate`. The checks are O(|Δ|)
vectorized numpy on the host side of ingest.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from ..core.graph import BatchUpdate
from ..obs.spans import get_registry as _obs

__all__ = ["ValidationError", "QuarantineReport", "validate_batch",
           "POLICIES"]

POLICIES = ("raise", "quarantine")


class ValidationError(ValueError):
    """A batch failed ingest validation under the strict policy."""


@dataclasses.dataclass(frozen=True)
class QuarantineReport:
    """What the quarantine removed from one batch (empty when clean)."""
    #: quarantined (src, dst) pairs per side, as given (pre-canonical)
    del_src: np.ndarray
    del_dst: np.ndarray
    ins_src: np.ndarray
    ins_dst: np.ndarray

    @property
    def size(self) -> int:
        return int(self.del_src.size + self.ins_src.size)

    def __bool__(self) -> bool:
        return self.size > 0


def _empty_report() -> QuarantineReport:
    z = np.zeros(0, np.int32)
    return QuarantineReport(z, z, z, z)


def _as_id_array(a, side: str, which: str) -> np.ndarray:
    """Structural gate: coerce to a 1-D integer ndarray or raise."""
    arr = np.asarray(a)
    if arr.ndim != 1:
        raise ValidationError(
            f"{side}.{which} must be 1-D, got shape {arr.shape}")
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
        # float ids are a corruption signature (a NaN-poisoned producer),
        # not a representation choice — reject even exact-integral floats
        raise ValidationError(
            f"{side}.{which} has non-integer dtype {arr.dtype}")
    return arr


def _side(src, dst, n: int, side: str) -> Tuple[np.ndarray, np.ndarray,
                                                np.ndarray]:
    src = _as_id_array(src, side, "src")
    dst = _as_id_array(dst, side, "dst")
    if src.shape[0] != dst.shape[0]:
        raise ValidationError(
            f"{side}: src/dst length mismatch ({src.shape[0]} vs "
            f"{dst.shape[0]})")
    bad = (src < 0) | (src >= n) | (dst < 0) | (dst >= n)
    return src, dst, bad


def validate_batch(batch: BatchUpdate, n: int, policy: str = "raise"
                   ) -> Tuple[BatchUpdate, QuarantineReport]:
    """Validate a raw ``BatchUpdate`` against vertex-id range ``[0, n)``.

    Returns ``(clean_batch, report)``. Structural violations always raise;
    id-range violations raise under ``policy="raise"`` and are stripped +
    reported under ``policy="quarantine"``.
    """
    if policy not in POLICIES:
        raise ValueError(f"unknown validation policy: {policy!r}")
    d_s, d_d, d_bad = _side(batch.del_src, batch.del_dst, n, "del")
    i_s, i_d, i_bad = _side(batch.ins_src, batch.ins_dst, n, "ins")
    n_bad = int(d_bad.sum()) + int(i_bad.sum())
    if n_bad == 0:
        return batch, _empty_report()
    if policy == "raise":
        side = "del" if d_bad.any() else "ins"
        s, d, bad = (d_s, d_d, d_bad) if d_bad.any() else (i_s, i_d, i_bad)
        j = int(np.nonzero(bad)[0][0])
        raise ValidationError(
            f"{n_bad} out-of-range vertex id(s) in batch (n={n}); first: "
            f"{side} pair ({int(s[j])}, {int(d[j])})")
    report = QuarantineReport(
        del_src=d_s[d_bad].astype(np.int32, copy=False),
        del_dst=d_d[d_bad].astype(np.int32, copy=False),
        ins_src=i_s[i_bad].astype(np.int32, copy=False),
        ins_dst=i_d[i_bad].astype(np.int32, copy=False))
    obs = _obs()
    obs.inc("guard.quarantined", n_bad)
    obs.inc("guard.quarantined_batches")
    clean = BatchUpdate(del_src=d_s[~d_bad], del_dst=d_d[~d_bad],
                        ins_src=i_s[~i_bad], ins_dst=i_d[~i_bad])
    return clean, report
