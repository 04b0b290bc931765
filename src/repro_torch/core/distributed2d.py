"""2-D edge-partitioned PageRank (beyond the paper) on ``torch.distributed``.

The 1-D pull all-gathers the FULL contribution vector every iteration.
2-D SpMV blocking cuts that: on an (r × c) mesh, device (i, j) owns the
edge block with sources in row-range(i) and destinations in row-range(j);
per iteration it

  1. all-gathers c along 'model'  -> c_row [V/r]
  2. pulls its edge block         -> y_partial [V/c]
  3. psum-scatters y along 'data' -> its V/(r·c) piece of destination range j
  4. permutes (i,j)->(j,i) to return the piece to its owner
     (ownership is row-major block b = i·c + j).

Frontier expansion (the δ_N OR-pull) rides the same schedule with sum as OR
(flags are 0/1, so Σ>0 ⇔ ∨).

A port of the JAX package's `repro.core.distributed2d`, SPMD: each rank
holds its own block (`build_sharded_2d(..., block=b)`, array-equal to row
b of JAX's stacked build) and its owned [V/(r·c)] slice of the ranks, on
a two-dimensional ('data', 'model') mesh (JAX also runs a leading pod axis
redundantly; here such a mesh is refused). Each block is one ELL of
width d_p whose rows are its destinations; on CUDA tensors its pull is the
`ell_pull` kernel (the one-table entry: one bucket whose rows are
arange(V/r)), on CPU tensors its plain version. `row_cap` compaction and
the expansion pull's gathers stay plain tensor ops. Spans and trace kinds
``static_2d`` / ``dfp_2d`` are the JAX package's.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .frontier import (FS_ACTIVE_ROWS, FS_COMPACT, FS_ITERS, FS_NB,
                       FS_OVERFLOW, fstats_init, publish_fstats,
                       stream_compact)
from .graph import Graph
from .mesh import Mesh
from .pagerank import PRParams, as_ranks, gather_rows, resolve_device, \
    use_kernels
from .rank_step import rank_step
from ..obs.spans import get_registry
from ..obs.trace import trace_init, trace_record
from ..sentinel import take_fill

__all__ = ["Sharded2D", "build_sharded_2d", "pagerank_2d", "dfp_2d",
           "block_of"]


class Sharded2D(NamedTuple):
    """One device's edge block (b = i·c + j), staged on its device."""
    ell_idx: torch.Tensor    # [V/r, d_p] int32 — LOCAL col ids into c_row
    ell_mask: torch.Tensor   # [V/r, d_p] f32
    out_deg: torch.Tensor    # [V/rc] int32 (owned vertices, block b)
    valid: torch.Tensor      # [V/rc] bool
    n_true: int
    r: int
    c: int
    block: int

    @property
    def device(self) -> torch.device:
        return self.out_deg.device


def block_of(mesh: Mesh) -> int:
    """This rank's block b = i·c + j: (i, j) its coordinates on the
    ('data', 'model') mesh."""
    sizes = tuple(mesh.shape.values())
    if len(sizes) != 2:
        raise ValueError(f"the 2-D engines take a 2-dimensional mesh, not "
                         f"{sizes}")
    i, j = mesh.coord
    return i * sizes[1] + j


def build_sharded_2d(g: Graph, r: int, c: int, d_p: int = 8, *, block: int,
                     device=None) -> Sharded2D:
    """Host partitioner; builds and stages block `block` on `device` (CUDA
    unless named). Edge (u -> v) lands on device (u // (V/r), v // (V/r)).
    Per-destination degree within one block is ~deg/r, so the block is
    pure ELL with a small d_p, raised to the largest per-(block,
    destination) multiplicity of any block — computed over every block, so
    all ranks agree on the width."""
    if r != c:
        raise ValueError("the 2-D scheme assumes a square (data, model) mesh")
    dev = resolve_device(device)
    n = g.n
    rc = r * c
    if not 0 <= block < rc:
        raise ValueError(f"block {block} of {rc}")
    n_pad = ((n + rc - 1) // rc) * rc
    v_r = n_pad // r          # row/column range size
    blk = n_pad // rc

    src, dst = g.edges()
    i_of = np.minimum(src // v_r, r - 1)
    j_of = np.minimum(dst // v_r, c - 1)
    dev_of = i_of * c + j_of
    order = np.argsort(dev_of, kind="stable")
    src, dst, dev_of = src[order], dst[order], dev_of[order]
    starts = np.searchsorted(dev_of, np.arange(rc))
    ends = np.searchsorted(dev_of, np.arange(rc) + 1)

    need = 1
    for b in range(rc):
        s, e = starts[b], ends[b]
        if e > s:
            cnt = np.bincount(dst[s:e] - (dev_of[s:e] % c) * v_r,
                              minlength=v_r)
            need = max(need, int(cnt.max()))
    d_p = max(d_p, need)

    ell_idx = np.zeros((v_r, d_p), np.int32)
    ell_mask = np.zeros((v_r, d_p), np.float32)
    s, e = starts[block], ends[block]
    if e > s:
        i, j = block // c, block % c
        ld = dst[s:e] - j * v_r          # local destination row
        ls = src[s:e] - i * v_r          # local source (col into c_row)
        o = np.argsort(ld, kind="stable")
        lds, lss = ld[o], ls[o]
        pos = np.arange(lds.size) - np.searchsorted(lds, lds, side="left")
        ell_idx[lds, pos] = lss
        ell_mask[lds, pos] = 1.0

    deg = np.ones(blk, np.int32)
    valid = np.zeros(blk, bool)
    lo, hi = block * blk, min((block + 1) * blk, n)
    if hi > lo:
        deg[:hi - lo] = g.out_degree()[lo:hi]
        valid[:hi - lo] = True

    def t(a):
        return torch.from_numpy(a).to(dev)
    return Sharded2D(ell_idx=t(ell_idx), ell_mask=t(ell_mask),
                     out_deg=t(deg), valid=t(valid), n_true=n, r=r, c=c,
                     block=block)


def _block_pull(sg: Sharded2D, v_row: torch.Tensor,
                kernels: Optional[bool]) -> torch.Tensor:
    """The block's masked gather row-sum over every destination: the
    `ell_pull` kernel on CUDA, `ell_pull_plain` on the CPU."""
    if use_kernels(v_row, kernels):
        from ..kernels.ell_pull import ell_pull
        return ell_pull(v_row, sg.ell_idx, sg.ell_mask)
    from ..kernels.ell_pull import ell_pull_plain
    return ell_pull_plain(v_row, sg.ell_idx, sg.ell_mask)


def _solve_2d(mesh: Mesh, sg: Sharded2D, r0, dv0, dn0, params: PRParams, *,
              dfp: bool, engine: str, trace: bool = False,
              row_cap: Optional[int] = None, kernels: Optional[bool] = None):
    """The per-device loop of JAX's `_loop_2d`: the blocked pull schedule
    around `core.rank_step` on the owned slice. Frontier expansion runs at
    iteration 0 too, so δ_N may be seeded raw.

    ``row_cap`` compacts the rank pull's destination loop: the mesh-row's
    δ_V slice (the same transpose permute + row-axis all-gather the owned
    pieces use) is stream-compacted into a [row_cap] active-destination
    list, and the block's gather-reduce runs over those rows only; on
    overflow the full block runs that iteration (the collectives stay
    outside the choice, so devices may diverge). The expansion pull stays
    full-width: its output IS the new frontier. With ``row_cap`` the
    overflow flag is a second host read per iteration."""
    if block_of(mesh) != sg.block or \
            (sg.r, sg.c) != tuple(mesh.shape.values()):
        raise ValueError(f"block {sg.block} of a ({sg.r}, {sg.c}) split on "
                         f"mesh {mesh}")
    row_axis, col_axis = mesh.axis_names
    dev = sg.device
    rank = as_ranks(r0, dev)
    dt = rank.dtype
    deg = sg.out_deg.to(dt)
    valid = sg.valid
    v_r = sg.ell_idx.shape[0]
    # the transpose (i, j) <-> (j, i)
    i, j = mesh.coord
    partner = mesh.rank_at((j, i))

    def pull(vec_own, sel=None, ovf=False):
        """vec_own [blk] -> per-destination sums [v_r] -> own piece."""
        v_row = mesh.all_gather(vec_own, col_axis)
        if sel is None or ovf:
            part = _block_pull(sg, v_row, kernels)
        else:
            idx_s = take_fill(sg.ell_idx, sel, 0)
            msk_s = take_fill(sg.ell_mask, sel, 0.0)
            sums = (gather_rows(v_row, idx_s) * msk_s.to(dt)).sum(1)
            part = v_row.new_zeros(v_r + 1).index_add_(0, sel, sums)[:v_r]
        piece = mesh.psum_scatter(part, row_axis)
        return mesh.ppermute(piece, partner, partner)

    def dv_row_of(dv_own):
        """Owned δ_V pieces -> this mesh-row's destination-range slice."""
        dvp = mesh.ppermute(dv_own.to(torch.uint8), partner, partner)
        return mesh.all_gather(dvp, row_axis) > 0

    tb = trace_init(params.max_iter, dt, engine, dev) if trace else None
    fs = fstats_init(0, dev) if row_cap is not None else None
    host_fs = [0] * FS_NB
    kw = dict(alpha=params.alpha, n_norm=sg.n_true, tau_f=params.tau_f,
              tau_p=params.tau_p, prune=dfp, closed_form=dfp,
              track_frontier=dfp)
    dv, dn = dv0.to(dev), dn0.to(dev)
    it = 0
    while it < params.max_iter:
        if dfp:
            dv = (dv | (pull(dn.to(dt)) > 0)) & valid    # Σ>0 ⇔ OR
        dv_in = dv & valid
        if row_cap is not None:
            sel, cnt = stream_compact(dv_row_of(dv_in), row_cap, v_r)
            ovf = bool(cnt > row_cap)
            s = pull(rank / deg, sel, ovf)
            if ovf:
                host_fs[FS_OVERFLOW] += 1
            else:
                host_fs[FS_COMPACT] += 1
                fs[FS_ACTIVE_ROWS] += cnt
            host_fs[FS_ITERS] += 1
        else:
            s = pull(rank / deg)
        r_new, dv_new, dn_new, local = rank_step(s, rank, dv_in, sg.out_deg,
                                                 **kw)
        if dfp:
            dv, dn = dv_new, dn_new
        delta = mesh.all_max(local)
        if trace:
            n_in = dv_in.sum()
            counts = mesh.all_sum(torch.stack([
                n_in, dn_new.sum(), n_in - (dv_new & valid).sum()]
            ).to(torch.int32))
            trace_record(tb, it, linf=delta, frontier=counts[0],
                         delta_n=counts[1] if dfp else 0,
                         pruned=counts[2] if dfp else 0)
        rank = r_new
        it += 1
        if not delta.item() > params.tau:     # the one host read
            break
    out = [rank, it]
    if tb is not None:
        out.append(tb)
    if row_cap is not None:
        fs[:FS_NB] += torch.tensor(host_fs, dtype=torch.int32, device=dev)
        out.append(mesh.all_sum(fs))
    return tuple(out)


def pagerank_2d(mesh: Mesh, sg: Sharded2D, r0, params: PRParams = PRParams(),
                trace: bool = False, kernels: Optional[bool] = None):
    """Static PageRank on the 2-D split: r0 is this device's owned [V/rc]
    slice. Returns (ranks [V/rc], iters)[, TraceBuffer]."""
    with get_registry().span("solve.static_2d", annotate=True):
        on = torch.ones(sg.out_deg.shape[0], dtype=torch.bool,
                        device=sg.device)
        return _solve_2d(mesh, sg, r0, on, torch.zeros_like(on), params,
                         dfp=False, engine="static_2d", trace=trace,
                         kernels=kernels)


def dfp_2d(mesh: Mesh, sg: Sharded2D, r_prev, dv0, dn0,
           params: PRParams = PRParams(), trace: bool = False,
           row_cap: Optional[int] = None, kernels: Optional[bool] = None):
    """2-D DF-P. ``row_cap`` (a pow2) compacts each device's destination
    loop to its mesh-row's active δ_V rows — identical ranks,
    O(row_cap·d_p) local edge work, full-block fallback on overflow;
    ``frontier.*`` counters published on every rank."""
    with get_registry().span("solve.dfp_2d", annotate=True):
        out = _solve_2d(mesh, sg, r_prev, dv0, dn0, params, dfp=True,
                        engine="dfp_2d", trace=trace, row_cap=row_cap,
                        kernels=kernels)
    if row_cap is not None:
        *out, fs = out
        publish_fstats(fs)
        out = tuple(out)
    return out
