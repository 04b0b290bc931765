"""The degree-bucketed ELL low side: the pull-only ``ell_bucket_pull`` of
the staged sweep; ``fused_ell_sweep``, every bucket's pull and
``updateRanks`` epilogue in one launch through the row maps; and
``fused_ell_update``, the same over one bucket's pre-gathered operands.

``ell_bucket_pull`` runs the all-bucket `ell_pull` entry
(`ell_pull_buckets`: one launch writes every slot's sum at its row id
through the bucket's row map, and sentinel ids write nothing, where the
JAX package drops them).

``fused_ell_sweep`` is the low side of the fused sweep
(`ops.update_ranks_kernel`): one kernel gathers each live slot's in-edge
contributions AND applies the Alg. 3 epilogue (Eq. 1 / Eq. 2, DF-P
pruning, δ_N, L∞ partials), reading r, out_deg and affected at the slot's
vertex id and writing the new rank and both flags there in place, so each
rank is written once per sweep and no `contrib [n]` vector, gathered
operand or per-slot output makes a round trip through device memory. One
launch covers every bucket, one more folds the L∞ partials. Its plain
version is the glue the JAX package spells out around its per-bucket
kernel (sink rows, take-with-fill, scatters through the row map).

``fused_ell_update`` is the counterpart of the JAX kernel: one bucket's
operands pre-gathered at its row ids, per-slot outputs. It runs the same
kernel body with the identity row map.

On a CUDA tensor each wrapper launches the kernel in
`csrc/fused_ell_update.cu` (`fused_ell_update.launches` counts the sweep
kernels started: one per call, unless a layout holds more buckets than one
launch takes); on a CPU tensor it runs its plain version
(`kernels.ref.ell_pull_ref` then `kernels.ref.pr_update_ref` per bucket);
on any other device it raises.

Padding discipline: lanes past a bucket's live slots carry r = 1, deg = 1,
aff = 0, mask = 0 — contrib 0, rank unchanged, |Δr| = 0 — so they are
inert in every output, and the caller's sentinel row ids drop their
writes.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ell_pull import bucket_ints, ell_pull_buckets
from .gather_plan import lanes_for
from .ref import ell_pull_ref, pr_update_ref
from ..sentinel import take_fill, with_sink

__all__ = ["ell_bucket_pull", "fused_ell_update",
           "fused_ell_update_plain", "fused_ell_sweep",
           "fused_ell_sweep_plain", "lanes_for"]

_EPI = [_build.D] * 4 + [_build.I] * 2 + [ctypes.POINTER(ctypes.c_int),
                                          _build.P]
_SIG = {"fused_ell_grid": [_build.I, _build.P],
        "fused_ell_sweep": [_build.P, _build.I, _build.P, _build.P]
        + [_build.P] * 6 + [_build.I, _build.P] + _EPI,
        "fused_ell_update": [_build.P] * 12 + _EPI}


def ell_bucket_pull(c: torch.Tensor, buckets) -> torch.Tensor:
    """out[blk.rows[s]] = sum_j c[blk.idx[s, j]] * blk.mask[s, j] over
    every bucket, shape [n]; rows in no bucket stay 0. Each vertex lives
    in at most one bucket slot, so no two sums meet."""
    return ell_pull_buckets(c, buckets)[:c.shape[0]]


def fused_ell_update_plain(c, idx, mask, r_rows, deg_rows, aff_rows, *,
                           alpha, inv_n, tau_f, tau_p, prune, closed_form,
                           active=None):
    """The plain PyTorch version: the per-slot inputs read at `active`
    (dead lanes read the inert padding), masked gather row-sum, then the
    epilogue."""
    if active is not None:
        idx = take_fill(idx, active, 0)
        mask = take_fill(mask, active, 0.0)
        r_rows = take_fill(r_rows, active, 1.0)
        deg_rows = take_fill(deg_rows, active, 1.0)
        aff_rows = take_fill(aff_rows, active, 0.0)
    return pr_update_ref(ell_pull_ref(c, idx, mask), r_rows, deg_rows,
                         aff_rows, alpha=alpha, inv_n=inv_n, tau_f=tau_f,
                         tau_p=tau_p, prune=prune, closed_form=closed_form)


def fused_ell_update(c: torch.Tensor, idx: torch.Tensor, mask: torch.Tensor,
                     r_rows: torch.Tensor, deg_rows: torch.Tensor,
                     aff_rows: torch.Tensor, *, alpha: float, inv_n: float,
                     tau_f: float, tau_p: float, prune: bool,
                     closed_form: bool, active: torch.Tensor | None = None):
    """One-pass pull + updateRanks over one bucket's slot table.

    c: [n] contributions; idx/mask: [cap_b, w_b]; r/deg/aff: [cap_b] f64
    operands pre-gathered at the bucket's row ids (sentinel lanes carry
    r=1, deg=1, aff=0). Returns per-slot (r_new, affected', delta_n,
    linf_dr scalar) — the caller scatters the first three back through
    the row-id map.

    With `active` (a compacted [k] active-slot list, sentinel == cap_b —
    core.frontier.ActiveFrontier) every per-slot input is read at
    `active` (dead lanes read the inert padding above) and the returned
    vectors are [k]-shaped: edge work O(k · w_b).
    """
    kw = dict(alpha=alpha, inv_n=inv_n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)
    if c.device.type == "cpu":
        return fused_ell_update_plain(c, idx, mask, r_rows, deg_rows,
                                      aff_rows, active=active, **kw)
    return _launch_bucket(c, idx, mask, r_rows, deg_rows, aff_rows, active,
                          **kw)


def fused_ell_sweep_plain(c, buckets, r, out_deg, affected, r_new, aff_new,
                          dn, *, bucket_sel=None, bucket_fn=None, **kw):
    """The plain version of `fused_ell_sweep`: the per-bucket entry
    `bucket_fn` (default `fused_ell_update`) over operands gathered at
    each bucket's row ids, its outputs scattered back through the row
    map (sentinel ids into a sink row, dropped)."""
    n = r.shape[0]
    dt = r.dtype
    bucket_fn = fused_ell_update if bucket_fn is None else bucket_fn
    r_src, d_src, a_src = (with_sink(r, 1.0),
                           with_sink(out_deg.to(dt), 1.0),
                           with_sink(affected.to(dt), 0.0))
    outs = [with_sink(r_new[:n], 0.0), with_sink(aff_new[:n], False),
            with_sink(dn[:n], False)]
    dmax = r.new_zeros(())
    b_sel = (None,) * len(buckets) if bucket_sel is None else bucket_sel
    for blk, sel in zip(buckets, b_sel):
        rows = blk.rows if sel is None else take_fill(blk.rows, sel, n)
        rb, ab, db, pb = bucket_fn(
            c, blk.idx, blk.mask, r_src.index_select(0, blk.rows),
            d_src.index_select(0, blk.rows), a_src.index_select(0, blk.rows),
            active=sel, **kw)
        outs[0][rows] = rb
        outs[1][rows] = ab > 0
        outs[2][rows] = db > 0
        dmax = torch.maximum(dmax, pb)
    for dst, src in zip((r_new, aff_new, dn), outs):
        dst[:n].copy_(src[:n])
    return dmax


def fused_ell_sweep(c: torch.Tensor, buckets, r: torch.Tensor,
                    out_deg: torch.Tensor, affected: torch.Tensor,
                    r_new: torch.Tensor, aff_new: torch.Tensor,
                    dn: torch.Tensor, *, alpha: float, inv_n: float,
                    tau_f: float, tau_p: float, prune: bool,
                    closed_form: bool, bucket_sel=None) -> torch.Tensor:
    """The ELL low side of one fused sweep, written in place.

    c: [n] f64 contributions; `buckets`: the layout's EllBlocks; r [n]
    f64, out_deg [n] int32, affected [n] bool, read at each live slot's
    vertex id; r_new (f64), aff_new and dn (bool), [n] or longer,
    written at each live slot's vertex id and nowhere else. With
    `bucket_sel` (ActiveFrontier.bucket_sel: per bucket a [k_b] slot list,
    sentinel cap_b) only the listed slots run. Returns the max |Δr| over
    those rows, a 0-d tensor (NaN wins)."""
    kw = dict(alpha=alpha, inv_n=inv_n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)
    if c.device.type == "cpu":
        return fused_ell_sweep_plain(c, buckets, r, out_deg, affected, r_new,
                                     aff_new, dn, bucket_sel=bucket_sel,
                                     **kw)
    return _launch_sweep(c, buckets, r, out_deg, affected, r_new, aff_new,
                         dn, bucket_sel, **kw)


def _epi_args(alpha, inv_n, tau_f, tau_p, prune, closed_form, dev,
              launched):
    return (alpha, (1.0 - alpha) * inv_n, tau_f, tau_p, int(prune),
            int(closed_form), ctypes.byref(launched), _build.stream_ptr(dev))


def _check_table(name, dev, idx, mask, sel):
    """The C entries' ints of one bucket's table (`bucket_ints`), its work
    lanes the active list's length when there is one."""
    count = None
    if sel is not None:
        count = sel.shape[0]
        _build.check(f"{name} active", sel, torch.int32, (count,), dev)
    return bucket_ints(name, dev, idx, mask, count)


def _launch_sweep(c, buckets, r, out_deg, aff, r_new, aff_new, dn, b_sel,
                  **kw):
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ell_sweep: no kernel for device {dev}")
    n = r.shape[0]
    _build.check("fused_ell_sweep c", c, torch.float64, (n,), dev)
    _build.check("fused_ell_sweep r", r, torch.float64, (n,), dev)
    _build.check("fused_ell_sweep out_deg", out_deg, torch.int32, (n,), dev)
    _build.check("fused_ell_sweep affected", aff, torch.bool, (n,), dev)
    for name, t, dt in (("r_new", r_new, torch.float64),
                        ("aff_new", aff_new, torch.bool),
                        ("dn", dn, torch.bool)):
        _build.check_out(f"fused_ell_sweep {name}", t, dt, n, dev)
    if not buckets:
        return r.new_zeros(())
    b_sel = (None,) * len(buckets) if b_sel is None else b_sel
    ptrs, ints = [], []
    for blk, sel in zip(buckets, b_sel):
        cnt = _check_table("fused_ell_sweep", dev, blk.idx, blk.mask, sel)
        _build.check("fused_ell_sweep rows", blk.rows, torch.int32,
                     (cnt[1],), dev)
        ptrs += [blk.rows.data_ptr(), blk.idx.data_ptr(),
                 blk.mask.data_ptr(), 0 if sel is None else sel.data_ptr()]
        ints += cnt
    nb = len(buckets)
    c_ptrs = (ctypes.c_void_p * len(ptrs))(*ptrs)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    lib = _build.load("fused_ell_update", _SIG)
    grid = lib.fused_ell_grid(nb, c_ints)
    partials = torch.empty(grid + 1, dtype=torch.float64, device=dev)
    launched = ctypes.c_int(0)
    err = lib.fused_ell_sweep(
        c.data_ptr(), nb, c_ptrs, c_ints, r.data_ptr(), out_deg.data_ptr(),
        aff.data_ptr(), r_new.data_ptr(), aff_new.data_ptr(), dn.data_ptr(),
        n, partials.data_ptr(), *_epi_args(dev=dev, launched=launched, **kw))
    _build.launch_error("fused_ell_sweep", err)
    fused_ell_update.launches += launched.value
    return partials[grid]


def _launch_bucket(c, idx, mask, r, deg, aff, sel, **kw):
    dev = c.device
    if dev.type != "cuda":
        raise ValueError(f"fused_ell_update: no kernel for device {dev}")
    ints = _check_table("fused_ell_update", dev, idx, mask, sel)
    count, cap = ints[:2]
    _build.check("fused_ell_update c", c, torch.float64, (c.shape[0],), dev)
    for name, t in (("r", r), ("deg", deg), ("aff", aff)):
        _build.check(f"fused_ell_update {name}", t, torch.float64, (cap,),
                     dev)
    lib = _build.load("fused_ell_update", _SIG)
    c_ints = (ctypes.c_int * len(ints))(*ints)
    grid = lib.fused_ell_grid(1, c_ints)
    out = torch.empty((3, count), dtype=torch.float64, device=dev)
    partials = torch.empty(grid + 1, dtype=torch.float64, device=dev)
    launched = ctypes.c_int(0)
    err = lib.fused_ell_update(
        c.data_ptr(), idx.data_ptr(), mask.data_ptr(),
        0 if sel is None else sel.data_ptr(), c_ints,
        r.data_ptr(), deg.data_ptr(), aff.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), partials.data_ptr(),
        *_epi_args(dev=dev, launched=launched, **kw))
    _build.launch_error("fused_ell_update", err)
    fused_ell_update.launches += launched.value
    return out[0], out[1], out[2], partials[grid]


fused_ell_update.launches = 0
