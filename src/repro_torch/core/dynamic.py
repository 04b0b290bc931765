"""Dynamic PageRank drivers: ND, DT, DF, DF-P (paper Alg. 2).

All five approaches share `update_ranks` (paper Alg. 3) and the convergence
loop shape of Alg. 1; they differ only in (a) rank initialization, (b) the
affected mask, and (c) frontier expansion/pruning — exactly the paper's
decomposition. Every driver is one Python loop (`_loop`) with one
device→host read per iteration.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .frontier import (FS_ACTIVE_ROWS, FS_ACTIVE_TILES, FS_COMPACT,
                       FS_EXPAND_WORK, FS_ITERS, FS_NB, FS_OVERFLOW, FS_PULL,
                       FS_PUSH, _mark, active_frontier, expand_affected,
                       expand_frontier, fstats_init, initial_affected,
                       publish_fstats, push_expand, reach_affected,
                       update_ranks_active)
from .pagerank import (DeviceGraph, PRParams, as_device_graph, as_ranks,
                       resolve_device, staged_forward, update_ranks)
from ..guard.health import MASS_TOL, health_word, rank_mass
from ..obs.trace import trace_init, trace_record

__all__ = ["DeviceBatch", "batch_to_device", "solve_health", "nd_pagerank",
           "dt_pagerank", "df_pagerank", "dfp_pagerank"]


class DeviceBatch(NamedTuple):
    """Batch update staged on the device, padded with id == n (dropped)."""
    del_src: torch.Tensor
    del_dst: torch.Tensor
    ins_src: torch.Tensor
    ins_dst: torch.Tensor


def batch_to_device(batch, n: int, pad_to: int | None = None,
                    device=None) -> DeviceBatch:
    dev = resolve_device(device)

    def pad(a, cap):
        a = np.asarray(a, np.int32)
        if cap is not None and a.shape[0] != cap:
            out = np.full(cap, n, np.int32)
            out[:a.shape[0]] = a
            a = out
        return torch.from_numpy(a).to(dev)
    return DeviceBatch(pad(batch.del_src, pad_to), pad(batch.del_dst, pad_to),
                       pad(batch.ins_src, pad_to), pad(batch.ins_dst, pad_to))


def solve_health(delta: torch.Tensor, iters, mass: torch.Tensor,
                 params: PRParams, mass_tol: float = MASS_TOL) -> torch.Tensor:
    """Health word of a finished solve loop (guard.health), from the final
    L∞ delta / iteration count / rank mass. A +inf delta (a loop that never
    swept) is clamped finite so it reads as H_MAX_ITER, not H_NONFINITE;
    NaN (real poisoning) passes through untouched."""
    delta = delta.clamp_max(torch.finfo(delta.dtype).max)
    return health_word(delta, iters, mass, tau=params.tau,
                       max_iter=params.max_iter, mass_tol=mass_tol)


def _loop(dg: DeviceGraph, r0: torch.Tensor, dv0: torch.Tensor,
          dn0: torch.Tensor, params: PRParams, *, expand: bool, prune: bool,
          closed_form: bool, kernels: Optional[bool] = None,
          pull_sum_fn=None, tb=None, i_off: int = 0, fwd=None, caps=None,
          fs0=None, health: bool = False, mass_tol: float = MASS_TOL):
    """Shared Alg. 2 loop. When `expand` is False the affected set is frozen
    (ND/DT); δ_N is then never produced (track_frontier=False).

    `caps` (core.frontier.FrontierCaps) switches on the compacted path:
    each iteration compacts δ_V into active gather lists and sweeps only
    those (`update_ranks_active`); a truncated list makes that one
    iteration run the dense sweep instead — an overflowed list is never
    used. With `fwd` (the forward hybrid layout) expansion goes push-style
    through the compacted δ_N worklist, falling back to the dense pull
    when the worklist overflows. `pull_sum_fn` makes every dense sweep the
    staged one (`update_ranks`); with `caps` that is the iterations whose
    lists overflow, as in the JAX loop.

    `tb` (obs.trace.TraceBuffer) switches on iteration telemetry: per
    sweep the L∞, the frontier δ_V that entered it (after expansion), the
    δ_N count and the vertices pruned, recorded at `i_off + i` — the
    offset lets the compact engine's dense finish append to the buffer its
    compact phase started. The counts stay on the device; the rank math
    never reads the trace.

    One host read per iteration: with `caps` the next iteration's
    expansion and compaction are computed right after the sweep, and
    `delta > τ` is read together with their overflow flags (when the loop
    then stops, that expansion is discarded). Only a push worklist that
    overflows costs a second read, for the list rebuilt after the dense
    expansion.

    Returns (r, iters)[, tb][, health word][, fstats] — fstats (the
    frontier.* accumulator) only with `caps`, always last.
    """
    kw = dict(alpha=params.alpha, tau_f=params.tau_f, tau_p=params.tau_p,
              prune=prune, closed_form=closed_form, track_frontier=expand,
              kernels=kernels)
    push = caps is not None and fwd is not None and expand
    fs = None
    host_fs = [0] * FS_NB
    if caps is not None:
        fs = fs0 if fs0 is not None else fstats_init(len(dg.buckets),
                                                     dg.device)

    def compact(dv):
        return active_frontier(dg.buckets, dg.hi_ids, dg.hi_rowmap, dv, caps)

    r, dv, dn = r0, dv0, dn0
    delta = torch.full((), float("inf"), dtype=r.dtype, device=r.device)
    af = compact(dv) if caps is not None else None
    overflow = bool(af.overflow) if caps is not None else False
    iters = 0
    while iters < params.max_iter:
        dv_in = dv     # the frontier entering this sweep (trace)
        if caps is not None and not overflow:
            r, dv, dn, delta = update_ranks_active(dg, r, dv, af, **kw)
            host_fs[FS_COMPACT] += 1
            fs[FS_ACTIVE_ROWS] += af.n_rows
            fs[FS_ACTIVE_TILES] += af.n_tiles
            fs[FS_NB:] += af.bucket_counts
        else:
            r, dv, dn, delta = update_ranks(dg, r, dv,
                                            pull_sum_fn=pull_sum_fn, **kw)
            host_fs[FS_OVERFLOW] += 1
        if tb is not None:
            frontier = dv_in.sum()
            trace_record(tb, i_off + iters, linf=delta, frontier=frontier,
                         delta_n=dn.sum() if expand else 0,
                         pruned=frontier - dv.sum() if prune else 0)
        iters += 1
        host_fs[FS_ITERS] += 1
        if iters >= params.max_iter:
            break
        if caps is None:
            if not delta.item() > params.tau:       # the one host read
                break
            if expand:
                dv = expand_affected(dg, dv, dn)
            continue
        # paper line 16: expand the frontier this sweep flagged, then
        # compact it, before the read that decides whether to go on
        reads = [delta > params.tau]
        dv_next = dv
        if push:
            marks, push_ovf = push_expand(fwd, dn, caps.dn, caps.fwd_tiles)
            dv_next = dv | marks
            reads.append(push_ovf)
        elif expand:
            dv_next = expand_affected(dg, dv, dn)
        af = compact(dv_next)
        reads.append(af.overflow)
        go_on, *flags = torch.stack(reads).tolist()  # the one host read
        if not go_on:
            break
        overflow = flags[-1]
        if push:
            fs[FS_EXPAND_WORK] += dn.sum(dtype=torch.int32)
        if push and flags[0]:
            # the worklist overflowed: its marks are incomplete, never used
            dv_next = expand_affected(dg, dv, dn)
            af = compact(dv_next)
            overflow = bool(af.overflow)
            host_fs[FS_PULL] += 1
        elif push:
            host_fs[FS_PUSH] += 1
        dv = dv_next

    out = [r, iters]
    if tb is not None:
        out.append(tb)
    if health:
        out.append(solve_health(delta, iters, rank_mass(r), params,
                                mass_tol))
    if caps is not None:
        fs[:FS_NB] += torch.tensor(host_fs, dtype=torch.int32,
                                   device=fs.device)
        out.append(fs)
    return tuple(out)


def _trace(params: PRParams, r: torch.Tensor, engine: str, trace: bool):
    """A fresh TraceBuffer for `engine` on r's device, or None."""
    return trace_init(params.max_iter, r.dtype, engine, r.device) \
        if trace else None


def nd_pagerank(dg, r_prev, params: PRParams = PRParams(),
                kernels: Optional[bool] = None, health: bool = False,
                pull_sum_fn=None, trace: bool = False):
    """Naive-dynamic: previous ranks as the initial guess, all vertices on.

    Every driver accepts a DeviceGraph (or a layout / Graph to stage, or a
    snapshot exposing `.dg`, e.g. `repro_torch.stream.DeviceSnapshot`), ranks
    as a tensor or numpy array, and `kernels` to pick the sweep (default:
    the CUDA kernels on a CUDA graph, the plain path on a CPU one);
    `pull_sum_fn` (e.g. `kernels.ops.pull_sum_kernels`) makes it the
    staged sweep (`core.pagerank.update_ranks`). ``trace=True`` appends
    an `obs.trace.TraceBuffer` (identical ranks and iterations to the
    untraced call); ``health=True`` appends the solve's guard.health word
    (0-d int32) after it.
    """
    dg = as_device_graph(dg)
    r = as_ranks(r_prev, dg.device)
    on = torch.ones(dg.n, dtype=torch.bool, device=dg.device)
    return _loop(dg, r, on, torch.zeros_like(on), params, expand=False,
                 prune=False, closed_form=False, kernels=kernels,
                 pull_sum_fn=pull_sum_fn, tb=_trace(params, r, "nd", trace),
                 health=health)


def dt_pagerank(dg, dg_prev, r_prev, batch: DeviceBatch,
                params: PRParams = PRParams(),
                kernels: Optional[bool] = None, health: bool = False,
                pull_sum_fn=None, trace: bool = False):
    """Dynamic Traversal (Desikan et al.): mark everything reachable from the
    updated vertices in G^{t-1} ∪ G^t, then iterate on that frozen set."""
    dg, dg_prev = as_device_graph(dg), as_device_graph(dg_prev)
    r = as_ranks(r_prev, dg.device)
    seeds = _mark(dg.n, batch.del_src, batch.del_dst, batch.ins_src,
                  batch.ins_dst)
    affected = reach_affected(dg, seeds) | reach_affected(dg_prev, seeds)
    return _loop(dg, r, affected, torch.zeros_like(seeds), params,
                 expand=False, prune=False, closed_form=False,
                 kernels=kernels, pull_sum_fn=pull_sum_fn,
                 tb=_trace(params, r, "dt", trace), health=health)


def _df_like(dg: DeviceGraph, r_prev, batch: DeviceBatch, params: PRParams,
             *, prune: bool, kernels=None, pull_sum_fn=None,
             trace: bool = False, fwd=None, caps=None, health: bool = False):
    n = dg.n
    dv, dn = initial_affected(n, batch.del_src, batch.del_dst, batch.ins_src)
    fs0 = None
    if caps is not None:
        fs0 = fstats_init(len(dg.buckets), dg.device)
    if caps is not None and fwd is not None:
        # paper line 9: initial expansion, via the compacted out-edge walk
        dv, est = expand_frontier(dg, fwd, dv, dn, caps)
        fs0[FS_EXPAND_WORK] += est[0]
        fs0[FS_PUSH] += est[1]
        fs0[FS_PULL] += est[2]
    else:
        dv = expand_affected(dg, dv, dn)  # paper line 9: initial expansion
    r = as_ranks(r_prev, dg.device)
    tb = _trace(params, r, "dfp" if prune else "df", trace)
    return _loop(dg, r, dv, torch.zeros_like(dn), params, expand=True,
                 prune=prune, closed_form=prune, kernels=kernels,
                 pull_sum_fn=pull_sum_fn, tb=tb, fwd=fwd, caps=caps, fs0=fs0,
                 health=health)


def _resolve_frontier(dg, fwd, frontier_caps):
    """(fwd DeviceGraph|None, caps) for the compacted path. Snapshots carry
    their own forward layout (`.fwd_dg`); with caps but no forward layout
    the loop still compacts the rank pull and keeps the dense expansion."""
    if frontier_caps is None:
        return None, None
    if fwd is None:
        fwd = staged_forward(dg)
    return (as_device_graph(fwd) if fwd is not None else None), frontier_caps


def _publish(out, caps):
    """Pop the fstats vector off a compacted driver's output, publish it,
    and return the (r, iters[, tb][, health]) shape."""
    if caps is None:
        return out
    *rest, fs = out
    publish_fstats(fs)
    return tuple(rest)


def df_pagerank(dg, r_prev, batch: DeviceBatch,
                params: PRParams = PRParams(),
                kernels: Optional[bool] = None, fwd=None, frontier_caps=None,
                health: bool = False, pull_sum_fn=None, trace: bool = False):
    """Dynamic Frontier: incremental expansion, no pruning (Eq. 1 update).

    `frontier_caps` (core.frontier.FrontierCaps / caps_for) switches on the
    compacted path — active gather lists + push expansion through `fwd`,
    full sweep only on capacity overflow; the same results either way.
    `pull_sum_fn`, `trace` and `health` as in `nd_pagerank`."""
    fwdd, caps = _resolve_frontier(dg, fwd, frontier_caps)
    out = _df_like(as_device_graph(dg), r_prev, batch, params, prune=False,
                   kernels=kernels, pull_sum_fn=pull_sum_fn, trace=trace,
                   fwd=fwdd, caps=caps, health=health)
    return _publish(out, caps)


def dfp_pagerank(dg, r_prev, batch: DeviceBatch,
                 params: PRParams = PRParams(),
                 kernels: Optional[bool] = None, fwd=None,
                 frontier_caps=None, health: bool = False,
                 pull_sum_fn=None, trace: bool = False):
    """Dynamic Frontier with Pruning: expansion + pruning, closed form Eq. 2.

    See `df_pagerank` for the `frontier_caps` compacted path."""
    fwdd, caps = _resolve_frontier(dg, fwd, frontier_caps)
    out = _df_like(as_device_graph(dg), r_prev, batch, params, prune=True,
                   kernels=kernels, pull_sum_fn=pull_sum_fn, trace=trace,
                   fwd=fwdd, caps=caps, health=health)
    return _publish(out, caps)
