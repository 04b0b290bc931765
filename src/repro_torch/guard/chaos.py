"""Deterministic fault injection.

A recovery path that is never exercised is a recovery path that does not
work. ``ChaosMonkey`` is a seeded injector producing every fault class the
guard layer claims to survive:

  * ``corrupt_batch``    — splice out-of-range ids (negative and ≥ n) or a
                           duplicate flood into a valid ``BatchUpdate``
                           (exercises validate/quarantine);
  * ``poison_ranks``     — NaN-poison or bit-flip random lanes of a rank
                           vector (exercises the H_NONFINITE / H_MASS_DRIFT
                           watchdog bits and the escalation ladder);
  * ``force_nonconvergence`` — cap a session's per-batch solve budget at
                           ``max_iter=1`` (exercises H_MAX_ITER and the
                           recovery-params rungs);
  * ``truncate_journal`` — tear the journal file mid-record, as a crash
                           during ``append`` would (exercises ``scan``'s
                           longest-valid-prefix replay).

Everything is driven by one ``numpy`` Generator seeded at construction, so
a failing chaos test reproduces exactly. A copy of the JAX package's
`repro.guard.chaos` that draws in the same order: a seed gives the same
corrupted batch, lanes and flipped bits in both packages.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..core.graph import BatchUpdate

__all__ = ["ChaosMonkey"]


class ChaosMonkey:
    """Seeded fault injector for guard tests and benches."""

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    # -- delta corruption ----------------------------------------------------

    def corrupt_batch(self, batch: BatchUpdate, n: int,
                      mode: str = "out_of_range", k: int = 4
                      ) -> BatchUpdate:
        """Return a corrupted copy of ``batch``.

        ``out_of_range``: append ``k`` insertion pairs whose ids alias other
        edges' keys under ``src*n + dst`` (negative, == n, and far beyond n —
        the exact ids that used to corrupt ``edge_keys`` silently).
        ``dup_flood``: append one valid insertion pair repeated ``k`` times
        (must coalesce to a single edge, never multiply mass).
        """
        i_s = np.asarray(batch.ins_src, np.int64)
        i_d = np.asarray(batch.ins_dst, np.int64)
        if mode == "out_of_range":
            bad_s = self.rng.integers(0, n, size=k)
            bad_d = np.asarray(
                [n, -1, n + int(self.rng.integers(1, n)), -n])[:k]
            self.rng.shuffle(bad_d)
            i_s = np.concatenate([i_s, bad_s])
            i_d = np.concatenate([i_d, bad_d])
        elif mode == "dup_flood":
            u = int(self.rng.integers(0, n))
            v = int(self.rng.integers(0, n))
            i_s = np.concatenate([i_s, np.full(k, u, np.int64)])
            i_d = np.concatenate([i_d, np.full(k, v, np.int64)])
        else:
            raise ValueError(f"unknown corruption mode: {mode!r}")
        return BatchUpdate(del_src=np.asarray(batch.del_src, np.int64),
                           del_dst=np.asarray(batch.del_dst, np.int64),
                           ins_src=i_s, ins_dst=i_d)

    # -- rank poisoning ------------------------------------------------------

    def poison_ranks(self, ranks, mode: str = "nan", k: int = 1, idx=None):
        """Return a poisoned copy of a rank vector (any shape): a tensor on
        the input's device in its dtype (on the CPU for a numpy input).

        ``nan`` writes NaN into ``k`` random lanes; ``bitflip`` flips one
        random sign/exponent bit of ``k`` random lanes' float64 payload (may
        stay finite — that is the point: the mass-drift bit must catch it).
        ``idx`` pins the poisoned lanes (deterministic tests that need the
        corruption OUTSIDE the batch frontier: a lane the solve sweeps gets
        recomputed from its neighbors, i.e. PageRank self-heals it — only a
        frozen unaffected lane carries corruption through, which is exactly
        the case the mass-drift watchdog exists for). The flip runs on a
        host copy, as uint64 (torch has no uint64 shifts).
        """
        t = torch.as_tensor(ranks)
        r = t.detach().cpu().numpy().copy()
        flat = r.reshape(-1)
        if idx is None:
            idx = self.rng.choice(flat.size, size=min(k, flat.size),
                                  replace=False)
        else:
            idx = np.asarray(idx, np.int64)
        if mode == "nan":
            flat[idx] = np.nan
        elif mode == "bitflip":
            bits = flat[idx].view(np.uint64)
            # sign/exponent bits only, so the flip is consequential
            shift = self.rng.integers(52, 64, size=idx.size)
            flat[idx] = (bits ^ (np.uint64(1) << shift.astype(np.uint64))
                         ).view(np.float64)
        else:
            raise ValueError(f"unknown poison mode: {mode!r}")
        return torch.from_numpy(r).to(t.device)

    # -- solve-budget starvation --------------------------------------------

    def force_nonconvergence(self, session) -> None:
        """Cap the session's per-batch solve at one iteration. Recovery must
        come from the guard's ``recovery_params`` rungs, which keep the full
        budget."""
        session.params = session.params._replace(max_iter=1)

    # -- journal tearing -----------------------------------------------------

    def truncate_journal(self, path: str,
                         nbytes: Optional[int] = None) -> int:
        """Truncate the journal to ``nbytes`` (default: a random cut inside
        the final quarter — mid-record with high probability). Returns the
        new size."""
        size = os.path.getsize(path)
        if nbytes is None:
            lo = max(1, (3 * size) // 4)
            nbytes = int(self.rng.integers(lo, size))
        with open(path, "r+b") as f:
            f.truncate(nbytes)
        return nbytes
