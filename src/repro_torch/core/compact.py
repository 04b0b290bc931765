"""Frontier-compacted DF / DF-P: sweep only the affected vertices.

The paper's update kernels do `if not δ_V[v]: continue`. A masked dense
sweep still pays the full |V|·d_p gather; these engines restore the skip
with compaction, as the JAX package's `repro.core.compact` does:

  * affected vertex ids go into fixed-capacity active lists (K from the
    initial frontier, `plan_capacity`), and the rank pull gathers only
    those rows of the in-neighbor layout (`update_ranks_active`; on CUDA
    the kernels run over the lists);
  * frontier expansion walks the OUT-edges of flagged vertices through
    the forward layout (`push_expand`), as the paper's Alg. 5 does;
  * if the frontier ever outgrows K, the loop exits and the dense engine
    (`core.dynamic._loop`) finishes from the current state — correctness
    never depends on the capacity guess.

Where JAX runs a `lax.while_loop`, this is a Python loop with one host
read per iteration: the next iteration's expansion and compaction are
computed right after the sweep and their overflow flag is read together
with `delta > τ`.
"""
from __future__ import annotations

from typing import Optional

import torch

from .dynamic import DeviceBatch, _loop, _trace, solve_health
from .frontier import (FrontierCaps, active_frontier, initial_affected,
                       plan_capacity, push_expand, update_ranks_active)
from .graph import Graph, build_hybrid
from .pagerank import (DeviceGraph, PRParams, as_device_graph, as_ranks,
                       resolve_device, staged_forward, to_device)
from ..guard.health import rank_mass
from ..obs.trace import trace_record

__all__ = ["forward_device_graph", "dfp_pagerank_compact",
           "df_pagerank_compact"]


def forward_device_graph(g: Graph, d_p: int = 64, tile: int = 1024,
                         device=None, **caps) -> DeviceGraph:
    """Out-edge hybrid layout (the paper's 'Partition G' by out-degree):
    rows of the ELL are each vertex's OUT-neighbors."""
    dev = resolve_device(device)      # raise before the host build
    return to_device(build_hybrid(g.transpose(), d_p=d_p, tile=tile, **caps),
                     device=dev)


def _compact_loop(dg: DeviceGraph, fwd: DeviceGraph, r0, dv0, params,
                  k: int, kt: int, kn: int, prune: bool,
                  kernels: Optional[bool], tb=None):
    """The compacted Alg. 2 loop. Returns (r, dv, dn, delta, iters).

    An iteration whose lists overflow (a truncated bucket/hi/tile list, a
    push worklist over `kn`, or more than `k` active rows in total) commits
    nothing: the loop exits with the pre-iteration ranks, the expanded
    frontier and delta = +inf, the signal for the dense finish. As in the
    JAX loop that iteration is counted, and with `tb` it records
    linf = inf — the visible marker of the dense handoff."""
    dt = r0.dtype
    caps = FrontierCaps(
        bucket=tuple(min(k, int(b.rows.shape[0])) for b in dg.buckets),
        hi=min(k, dg.n_hi_cap), tiles=kt, dn=kn, fwd_tiles=0)
    kw = dict(alpha=params.alpha, tau_f=params.tau_f, tau_p=params.tau_p,
              prune=prune, closed_form=prune, track_frontier=True,
              kernels=kernels)

    def compact(dv, push_ovf=None):
        af = active_frontier(dg.buckets, dg.hi_ids, dg.hi_rowmap, dv, caps)
        ovf = af.overflow | (af.n_rows > k)
        return af, (ovf if push_ovf is None else ovf | push_ovf)

    r, dv = r0, dv0
    dn = torch.zeros_like(dv0)
    # finite sentinel: +inf is reserved for the capacity-overflow signal
    delta = torch.full((), torch.finfo(dt).max, dtype=dt, device=r.device)
    af, ovf = compact(dv)
    overflow = bool(ovf)
    iters = 0
    while iters < params.max_iter:
        dv_in = dv     # the frontier entering this sweep (trace)
        if overflow:
            delta = torch.full_like(delta, float("inf"))
        else:
            r, dv, dn, delta = update_ranks_active(dg, r, dv, af, **kw)
        if tb is not None:
            frontier = dv_in.sum()
            trace_record(tb, iters, linf=delta, frontier=frontier,
                         delta_n=dn.sum(),
                         pruned=frontier - dv.sum() if prune else 0)
        iters += 1
        if overflow or iters >= params.max_iter:
            break
        # paper line 16: expand this sweep's δ_N, compact, then the one read
        marks, push_ovf = push_expand(fwd, dn, kn)
        dv_next = dv | marks
        af, ovf = compact(dv_next, push_ovf)
        go_on, overflow = torch.stack([delta > params.tau, ovf]).tolist()
        if not go_on:
            break
        dv = dv_next
    return r, dv, dn, delta, iters


def _dense_finish(dg, r, dv, dn, params, prune, kernels, tb, i_off,
                  health):
    return _loop(dg, r, dv, dn, params, expand=True, prune=prune,
                 closed_form=prune, kernels=kernels, tb=tb, i_off=i_off,
                 health=health)


def _df_like_compact(dg, fwd, r_prev, batch: DeviceBatch, params: PRParams,
                     *, prune: bool, headroom: int = 16,
                     kernels: Optional[bool] = None, trace: bool = False,
                     health: bool = False):
    n = dg.n
    dv, dn = initial_affected(n, batch.del_src, batch.del_dst, batch.ins_src)
    # initial marking via the compacted out-edge walk (paper Alg. 5), not a
    # dense O(|E|) pull — the batch is tiny relative to the graph
    kn_init = plan_capacity(int(dn.sum()) + 1, n, headroom=2)
    dv = dv | push_expand(fwd, dn, kn_init)[0]
    k = plan_capacity(int(dv.sum()) + 1, n, headroom=headroom)
    # no tile compaction: affected hubs need their full tile lists
    kt = dg.hi_tiles.shape[0]
    r = as_ranks(r_prev, dg.device)
    tb = _trace(params, r, "dfp_compact" if prune else "df_compact", trace)
    r, dv, dn, delta, iters = _compact_loop(dg, fwd, r, dv, params, k, kt, k,
                                            prune, kernels, tb)
    if float(delta) > params.tau and iters < params.max_iter:
        # the frontier outgrew the capacity: the dense engine finishes with
        # the REMAINING budget, so its health word is the solve's, and
        # appends to the trace at the offset where the compact phase stopped
        rest = params._replace(max_iter=params.max_iter - iters)
        out = _dense_finish(dg, r, dv, dn, rest, prune, kernels, tb, iters,
                            health)
        return (out[0], iters + out[1]) + tuple(out[2:])
    out = [r, iters]
    if tb is not None:
        out.append(tb)
    if health:
        out.append(solve_health(delta, iters, rank_mass(r), params))
    return tuple(out)


def _stage_pair(dg, fwd):
    """Resolve (pull, forward) device graphs; a pre-staged snapshot exposing
    `.dg`/`.fwd_dg` (repro_torch.stream.DeviceSnapshot) may be passed as `dg`
    with fwd=None and supplies both orientations."""
    if fwd is None:
        fwd = staged_forward(dg)
        if fwd is None:
            raise TypeError("fwd is required unless dg is a snapshot "
                            "exposing .fwd_dg")
    return as_device_graph(dg), as_device_graph(fwd)


def dfp_pagerank_compact(dg, fwd=None, r_prev=None,
                         batch: DeviceBatch = None,
                         params: PRParams = PRParams(),
                         kernels: Optional[bool] = None,
                         health: bool = False, trace: bool = False):
    """Compacted DF-P (pruning, closed form Eq. 2). Returns (r, iters)
    [, obs.trace.TraceBuffer][, health word]. `kernels` picks the sweep as
    in `core.dynamic`."""
    dg, fwd = _stage_pair(dg, fwd)
    return _df_like_compact(dg, fwd, r_prev, batch, params, prune=True,
                            kernels=kernels, trace=trace, health=health)


def df_pagerank_compact(dg, fwd=None, r_prev=None,
                        batch: DeviceBatch = None,
                        params: PRParams = PRParams(),
                        kernels: Optional[bool] = None,
                        health: bool = False, trace: bool = False):
    """Compacted DF (no pruning, Eq. 1). See `dfp_pagerank_compact`."""
    dg, fwd = _stage_pair(dg, fwd)
    return _df_like_compact(dg, fwd, r_prev, batch, params, prune=False,
                            kernels=kernels, trace=trace, health=health)
