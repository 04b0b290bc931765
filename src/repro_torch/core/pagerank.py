"""Static PageRank (paper Alg. 1) — synchronous, pull-based, atomics-free.

The device graph is the hybrid ELL + tiled-CSR layout of the *transpose*
graph (see core/graph.py). One sweep is `update_ranks`: on CUDA tensors it
runs the hand-written fused kernels (`kernels.ops.update_ranks_kernel`), on
CPU tensors the plain PyTorch pull below plus `core.rank_step`. With
``pull_sum_fn=`` (e.g. `kernels.ops.pull_sum_kernels`) it is the paper's
staged sweep instead: that pull, the rank update of `core.rank_step`, and
on CUDA the `linf_delta` kernel for the L∞. The solve loop is a Python
loop with one device→host read per iteration (the L∞ delta against τ), as
the paper's host loop does.

`update_ranks` is shared verbatim between Static / ND / DT / DF / DF-P (the
paper re-uses `updateRanks()` the same way, toggling the affected flags).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .graph import Graph, build_hybrid
from .rank_step import rank_step
from ..device import resolve_device
from ..guard.health import rank_mass
from ..obs.spans import get_registry
from ..obs.trace import trace_init, trace_record

__all__ = [
    "EllBlock", "DeviceGraph", "PRParams", "resolve_device", "to_device",
    "device_graph", "as_device_graph", "init_ranks", "pull_sum", "pull_max",
    "update_ranks", "static_pagerank",
]

ALPHA = 0.85
TAU = 1e-10
TAU_F = 1e-6
TAU_P = 1e-6
MAX_ITER = 500


class EllBlock(NamedTuple):
    """One degree bucket of the low side, staged on the device."""
    rows: torch.Tensor      # [cap_b] int32 (sentinel = n)
    idx: torch.Tensor       # [cap_b, w_b] int32
    mask: torch.Tensor      # [cap_b, w_b] f32

    @property
    def width(self) -> int:
        return self.idx.shape[1]


class DeviceGraph(NamedTuple):
    """Hybrid bucketed pull layout staged on the device.

    `hi_slot_tiles` / `hi_slot_off` are the tile lists of each high slot
    (CSR over slots, tiles in ascending order), built once from `hi_rowmap`
    so the `csr_block_pull` kernel can reduce per slot in a fixed order."""
    buckets: Tuple[EllBlock, ...]   # degree buckets, ascending width
    bucket_of: torch.Tensor   # [n] int32 (len(buckets) = CSR side)
    slot_of: torch.Tensor     # [n] int32 (slot within bucket / hi side)
    hi_ids: torch.Tensor      # [n_hi_cap] int32 (sentinel = n)
    hi_tiles: torch.Tensor    # [t_cap, tile] int32
    hi_tmask: torch.Tensor    # [t_cap, tile] f32
    hi_rowmap: torch.Tensor   # [t_cap] int32
    hi_slot_tiles: torch.Tensor  # [t_cap] int32 tile ids grouped by slot
    hi_slot_off: torch.Tensor    # [n_hi_cap + 1] int32
    is_low: torch.Tensor      # [n] bool
    out_deg: torch.Tensor     # [n] int32 (>=1: self-loops guaranteed)

    @property
    def n(self) -> int:
        return self.is_low.shape[0]

    @property
    def n_hi_cap(self) -> int:
        return self.hi_ids.shape[0]

    @property
    def device(self) -> torch.device:
        return self.out_deg.device


class PRParams(NamedTuple):
    alpha: float = ALPHA
    tau: float = TAU
    tau_f: float = TAU_F
    tau_p: float = TAU_P
    max_iter: int = MAX_ITER


def slot_tile_table(hi_rowmap: np.ndarray, n_hi_cap: int):
    """(tiles grouped by slot in ascending tile order, per-slot offsets):
    a stable argsort of the tile→slot map plus a prefix sum of its counts.
    No assumption that a slot's tiles are contiguous or sorted."""
    rowmap = np.asarray(hi_rowmap, np.int64)
    order = np.argsort(rowmap, kind="stable").astype(np.int32)
    off = np.zeros(n_hi_cap + 1, np.int32)
    np.cumsum(np.bincount(rowmap, minlength=n_hi_cap), out=off[1:])
    return order, off


def to_device(layout, device=None) -> DeviceGraph:
    """Stage a host hybrid layout. Accepts this package's `HybridLayout` or
    any object with the same numpy fields (the JAX package's
    `repro.core.graph.HybridLayout` is read this way, without importing it)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    slot_tiles, slot_off = slot_tile_table(layout.hi_rowmap,
                                           len(layout.hi_ids))
    return DeviceGraph(
        buckets=tuple(EllBlock(rows=t(b.rows), idx=t(b.idx), mask=t(b.mask))
                      for b in layout.buckets),
        bucket_of=t(layout.bucket_of), slot_of=t(layout.slot_of),
        hi_ids=t(layout.hi_ids), hi_tiles=t(layout.hi_tiles),
        hi_tmask=t(layout.hi_tmask), hi_rowmap=t(layout.hi_rowmap),
        hi_slot_tiles=t(slot_tiles), hi_slot_off=t(slot_off),
        is_low=t(layout.is_low), out_deg=t(layout.out_deg))


def device_graph(g: Graph, d_p: int = 64, tile: int = 1024, device=None,
                 **caps) -> DeviceGraph:
    dev = resolve_device(device)      # raise before the host build
    return to_device(build_hybrid(g, d_p=d_p, tile=tile, **caps), device=dev)


def as_device_graph(obj, device=None) -> DeviceGraph:
    """Coerce to a pull-side DeviceGraph: a DeviceGraph (identity), any
    pre-staged snapshot exposing `.dg` (`repro_torch.stream.DeviceSnapshot`),
    a host hybrid layout, or a Graph (default layout)."""
    if isinstance(obj, DeviceGraph):
        return obj
    staged = getattr(obj, "dg", None)
    if staged is not None:
        return staged
    if isinstance(obj, Graph):
        return device_graph(obj, device=device)
    if hasattr(obj, "buckets") and hasattr(obj, "hi_rowmap"):
        return to_device(obj, device=device)
    raise TypeError(f"cannot stage {type(obj).__name__} as a DeviceGraph")


def staged_forward(obj) -> Optional[DeviceGraph]:
    """The forward-orientation DeviceGraph a pre-staged snapshot carries
    (`.fwd_dg`), or None for anything else."""
    return getattr(obj, "fwd_dg", None)


def init_ranks(n: int, dtype=torch.float64, device=None) -> torch.Tensor:
    return torch.full((n,), 1.0 / n, dtype=dtype,
                      device=resolve_device(device))


def as_ranks(r, device: torch.device) -> torch.Tensor:
    """Ranks on `device`: a tensor is moved, anything else (a numpy array)
    is copied, so the caller's buffer is never aliased."""
    if isinstance(r, torch.Tensor):
        return r.to(device)
    return torch.tensor(np.asarray(r), device=device)


def use_kernels(r: torch.Tensor, kernels: Optional[bool]) -> bool:
    """The sweep an engine runs: the CUDA kernels for a CUDA tensor, the
    plain PyTorch path for a CPU one, unless the caller names it."""
    return r.is_cuda if kernels is None else bool(kernels)


# ---------------------------------------------------------------------------
# Plain pull primitives (single gather-reduce; one write per vertex)
# ---------------------------------------------------------------------------

def gather_rows(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """c[idx] for an index table of any shape (int32 ids)."""
    return c.index_select(0, idx.reshape(-1)).view(idx.shape)


def pull_sum(dg: DeviceGraph, c: torch.Tensor) -> torch.Tensor:
    """sum_{u in G'.row(v)} c[u] for every v — the paper's two rank kernels,
    in plain PyTorch.

    ELL side: per degree bucket, [cap_b, w_b] masked gather + row-sum,
    scattered once through the bucket's row map. CSR side: [t_cap, tile]
    masked gather + tile-sum + per-slot sum over the tile->slot map,
    scattered once into the dense result. Sentinel ids land in a sink row.
    """
    dt = c.dtype
    n = c.shape[0]
    out = c.new_zeros(n + 1)
    for blk in dg.buckets:
        sums = (gather_rows(c, blk.idx) * blk.mask.to(dt)).sum(1)
        out.index_add_(0, blk.rows, sums)
    tile_sums = (gather_rows(c, dg.hi_tiles) * dg.hi_tmask.to(dt)).sum(1)
    hi_per_slot = c.new_zeros(dg.n_hi_cap).index_add_(0, dg.hi_rowmap,
                                                      tile_sums)
    out.index_add_(0, dg.hi_ids, hi_per_slot)
    return out[:n]


def pull_max(dg: DeviceGraph, x: torch.Tensor) -> torch.Tensor:
    """max_{u in G'.row(v)} x[u] (x ≥ 0) — pull-based frontier expansion."""
    dt = x.dtype
    n = x.shape[0]
    out = x.new_zeros(n + 1)
    for blk in dg.buckets:
        rmax = (gather_rows(x, blk.idx) * blk.mask.to(dt)).amax(1)
        out.scatter_reduce_(0, blk.rows.long(), rmax, "amax")
    tile_max = (gather_rows(x, dg.hi_tiles) * dg.hi_tmask.to(dt)).amax(1)
    hi_per_slot = x.new_zeros(dg.n_hi_cap).scatter_reduce_(
        0, dg.hi_rowmap.long(), tile_max, "amax")
    out.scatter_reduce_(0, dg.hi_ids.long(), hi_per_slot, "amax")
    return out[:n]


# ---------------------------------------------------------------------------
# updateRanks (paper Alg. 3) — shared across all five approaches
# ---------------------------------------------------------------------------

def update_ranks(dg: DeviceGraph, r: torch.Tensor, affected: torch.Tensor,
                 *, alpha: float, tau_f: float, tau_p: float,
                 prune: bool, closed_form: bool, track_frontier: bool,
                 kernels: Optional[bool] = None, pull_sum_fn=None):
    """One synchronous rank sweep.

    Returns (r_new, affected', delta_N, linf_delta). With `affected`
    all-True, `prune=False`, `closed_form=False`, `track_frontier=False`
    this *is* the static kernel. `kernels` picks the sweep (`use_kernels`):
    the fused CUDA kernels, or the plain pull bound to `core.rank_step`.

    `pull_sum_fn(dg, c)` (`pull_sum`, `kernels.ops.pull_sum_kernels`)
    makes it the staged sweep: that pull, then `core.rank_step`, with the
    L∞ from the `linf_delta` kernel when `kernels` picks the kernels and
    from ``torch.max`` otherwise. The pull is the caller's choice either
    way.
    """
    kw = dict(alpha=alpha, tau_f=tau_f, tau_p=tau_p, prune=prune,
              closed_form=closed_form, track_frontier=track_frontier)
    on_kernels = use_kernels(r, kernels)
    if on_kernels and pull_sum_fn is None:
        from ..kernels.ops import update_ranks_kernel
        return update_ranks_kernel(dg, r, affected, **kw)
    linf_fn = None
    if on_kernels:
        from ..kernels.linf_delta import linf_delta as linf_fn
    s = (pull_sum_fn or pull_sum)(dg, r / dg.out_deg.to(r.dtype))
    return rank_step(s, r, affected, dg.out_deg, n_norm=dg.n,
                     linf_fn=linf_fn, **kw)


# ---------------------------------------------------------------------------
# Static PageRank driver (paper Alg. 1)
# ---------------------------------------------------------------------------

def static_pagerank(dg, r0, params: PRParams = PRParams(),
                    kernels: Optional[bool] = None, health: bool = False,
                    pull_sum_fn=None, trace: bool = False):
    """Power iteration to L∞ tolerance. Returns (ranks, n_iters); with
    ``trace=True`` an `obs.trace.TraceBuffer` of the per-iteration L∞ is
    appended (identical ranks either way, no host read per iteration);
    with ``health=True`` the solve's guard.health word (0-d int32 tensor)
    comes last. `r0` may be a numpy array or a tensor; it is moved to the
    graph's device. `dg` may be a DeviceGraph, a layout or a Graph.
    `kernels` and `pull_sum_fn` pick the sweep (`update_ranks`).

    The solve runs under the annotated span ``solve.static``: on a live
    ``torch.profiler`` capture its kernels fall inside that range, and the
    span ends after the loop's last read, so it times the device's work."""
    with get_registry().span("solve.static", annotate=True):
        return _static_pagerank(dg, r0, params, kernels, health,
                                pull_sum_fn, trace)


def _static_pagerank(dg, r0, params, kernels, health, pull_sum_fn, trace):
    dg = as_device_graph(dg)
    r = as_ranks(r0, dg.device)
    n = dg.n
    all_on = torch.ones(n, dtype=torch.bool, device=dg.device)
    delta = torch.full((), float("inf"), dtype=r.dtype, device=dg.device)
    tb = trace_init(params.max_iter, r.dtype, "static", dg.device) \
        if trace else None
    iters = 0
    while iters < params.max_iter:
        r, _, _, delta = update_ranks(
            dg, r, all_on, alpha=params.alpha, tau_f=params.tau_f,
            tau_p=params.tau_p, prune=False, closed_form=False,
            track_frontier=False, kernels=kernels, pull_sum_fn=pull_sum_fn)
        if tb is not None:
            trace_record(tb, iters, linf=delta, frontier=n, delta_n=0,
                         pruned=0)
        iters += 1
        if not delta.item() > params.tau:     # the one host read
            break
    out = [r, iters]
    if tb is not None:
        out.append(tb)
    if health:
        from .dynamic import solve_health
        out.append(solve_health(delta, iters, rank_mass(r), params))
    return tuple(out)
