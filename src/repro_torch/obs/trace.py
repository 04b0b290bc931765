"""Iteration-level telemetry: a fixed-shape trace filled by the solve loop.

Every engine's convergence loop is a Python loop that reads the device
once per iteration (the ``delta > τ`` test); the trace must add no read of
its own. So it is a ``TraceBuffer`` of ``[max_iter]``-shaped tensors on
the ranks' device, written once per iteration by `trace_record` from
device-side reductions (the counts are never brought to the host inside
the loop) and summarized on the host after the solve (`trace_summary`).

Invariant (tested): the rank math never reads the trace, so ``trace=True``
gives bit-identical ranks and iteration counts to ``trace=False``.

Per-iteration channels (the paper's Fig. 1-5 quantities):

  linf      L∞ |Δr| of the sweep — the convergence curve
  frontier  |{v : δ_V[v]}| entering the sweep (post-expansion) — the
            "fraction of vertices affected" series
  delta_n   |{v : δ_N[v]}| flagged for the next expansion
  pruned    vertices dropped from δ_V by the τ_p prune this iteration

A copy of the JAX package's `repro.obs.trace`, with the same engine ids
and summary keys. Where JAX returns a new buffer from ``.at[i].set``, this
one is written in place (`trace_record` returns the same buffer).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["ENGINE_IDS", "ENGINE_NAMES", "TraceBuffer", "trace_init",
           "trace_record", "trace_summary", "maybe_summary"]

# Stable engine ids (the TraceBuffer stores the id; summaries the name).
ENGINE_IDS = {
    "static": 0, "nd": 1, "dt": 2, "df": 3, "dfp": 4,
    "df_compact": 5, "dfp_compact": 6,
    "static_1d": 7, "dfp_1d": 8, "static_2d": 9, "dfp_2d": 10,
}
ENGINE_NAMES = {v: k for k, v in ENGINE_IDS.items()}


class TraceBuffer(NamedTuple):
    """Per-iteration telemetry, fixed shape [cap] (cap = params.max_iter)."""
    linf: torch.Tensor      # [cap] rank dtype; L-inf |dr| per iteration
    frontier: torch.Tensor  # [cap] int32; |affected| entering the sweep
    delta_n: torch.Tensor   # [cap] int32; |delta_N| flagged this iteration
    pruned: torch.Tensor    # [cap] int32; vertices pruned from affected
    engine: torch.Tensor    # []    int32; ENGINE_IDS value

    @property
    def cap(self) -> int:
        return self.linf.shape[0]


def trace_init(cap: int, dtype, engine: str, device=None) -> TraceBuffer:
    """Fresh buffer on `device` (CUDA unless named, as every staging call:
    `device.resolve_device`). Unwritten lanes stay at the -1 / NaN sentinels, so a summary truncated
    by a wrong iteration count is visibly wrong rather than silently
    zero."""
    device = resolve_device(device)

    def full(fill, dt):
        return torch.full((cap,), fill, dtype=dt, device=device)
    return TraceBuffer(
        linf=full(float("nan"), dtype), frontier=full(-1, torch.int32),
        delta_n=full(-1, torch.int32), pruned=full(-1, torch.int32),
        engine=torch.tensor(ENGINE_IDS[engine], dtype=torch.int32,
                            device=device))


def trace_record(tb: TraceBuffer, i: int, *, linf, frontier, delta_n,
                 pruned) -> TraceBuffer:
    """Write iteration i's channels in place and return `tb`. `i` is the
    host's iteration index; an out-of-cap write (only possible through a
    caller's offset arithmetic) does nothing, as JAX's drop mode. Each
    channel is a Python number or a 0-d tensor on the buffer's device
    (cast into the channel's dtype there: no host read)."""
    i = int(i)
    if 0 <= i < tb.cap:
        for chan, v in ((tb.linf, linf), (tb.frontier, frontier),
                        (tb.delta_n, delta_n), (tb.pruned, pruned)):
            chan[i] = v
    return tb


def _col(x: np.ndarray) -> list:
    """JSON-safe Python list (non-finite floats -> None: strict JSON has
    no Infinity/NaN; the inf lanes are the compact engine's overflow
    marker)."""
    return [None if isinstance(v, float) and not math.isfinite(v) else v
            for v in x.tolist()]


def trace_summary(tb: TraceBuffer, iters) -> dict:
    """Host-side summary of a completed solve: series trimmed to the
    actual iteration count, plus the derived scalars a report stores."""
    it = int(iters)
    linf = tb.linf[:it].cpu().numpy()
    frontier = tb.frontier[:it].cpu().numpy()
    finite = linf[np.isfinite(linf)]
    return {
        "engine": ENGINE_NAMES[int(tb.engine)],
        "iters": it,
        "linf_delta": _col(linf),
        "frontier": _col(frontier),
        "delta_n": _col(tb.delta_n[:it].cpu().numpy()),
        "pruned": _col(tb.pruned[:it].cpu().numpy()),
        "frontier_peak": int(frontier.max()) if it else 0,
        "frontier_final": int(frontier[-1]) if it else 0,
        "linf_final": float(finite[-1]) if finite.size else None,
    }


def maybe_summary(result, trace: bool) -> tuple:
    """Split an engine return into ((ranks, iters), summary-or-None).

    Engines return (r, iters) untraced and (r, iters, TraceBuffer) traced;
    callers that thread a ``trace`` flag through (StreamSession) use this
    to stay agnostic."""
    if not trace:
        return result, None
    r, iters, tb = result
    return (r, iters), trace_summary(tb, iters)
