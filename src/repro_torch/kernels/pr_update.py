"""``pr_update``: the Alg. 3 epilogue over pre-reduced in-edge sums.

Rank formula (Eq. 1 or the self-loop closed form Eq. 2), masked write,
DF-P pruning (τ_p), frontier flag δ_N (τ_f) and the L∞ |Δr| in one pass.

``pr_update_sweep`` is the high side of the fused sweep
(`ops.update_ranks_kernel`): over the high in-degree slots, whose sums come
from `csr_block_pull`, it reads r, out_deg and affected at each slot's
vertex id and writes the new rank and both flags there in place (over an
active list, only the listed slots run), and its fold starts from the low
side's max, so it returns the L∞ of the whole sweep. Sentinel ids (unused
slots, dead list lanes) write nothing. Its plain version,
`pr_update_sweep_plain`, is the glue the JAX package spells out around its
per-slot kernel (take-with-fill gathers, scatters through the slot→vertex
map).

``pr_update`` is the counterpart of the JAX kernel: operands gathered per
slot, per-slot outputs. It runs the same kernel body with the identity
map.

On a CUDA tensor each wrapper launches the kernel in `csrc/pr_update.cu`
(which shares its epilogue with `fused_ell_update`; `pr_update.launches`
counts the calls of either entry, each a kernel and its fold); on a CPU
tensor it runs its plain version (`kernels.ref.pr_update_ref`, per slot);
on any other device it raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import pr_update_ref
from ..sentinel import take_fill, with_sink

__all__ = ["pr_update", "pr_update_plain", "pr_update_sweep",
           "pr_update_sweep_plain"]

_EPI = [_build.D] * 4 + [_build.I, _build.I, _build.P]
_SIG = {"pr_update_grid": [_build.I],
        "pr_update": [_build.P] * 8 + [_build.I] + _EPI,
        "pr_update_sweep": [_build.P] * 3 + [_build.I] * 2 + [_build.P] * 6
        + [_build.I] + [_build.P] * 2 + _EPI}

pr_update_plain = pr_update_ref


def pr_update(contrib: torch.Tensor, r: torch.Tensor, out_deg: torch.Tensor,
              affected: torch.Tensor, *, alpha: float = 0.85,
              inv_n: float | None = None, tau_f: float = 1e-6,
              tau_p: float = 1e-6, prune: bool = True,
              closed_form: bool = True):
    """Returns (r_new, affected', delta_n, linf_dr); the flags are {0, 1}
    in `affected`'s dtype. The kernel takes f64 contiguous [n] tensors
    only (pad lanes: r = 1, deg = 1, affected = 0)."""
    n = r.shape[0]
    inv_n = 1.0 / n if inv_n is None else inv_n
    kw = dict(alpha=alpha, inv_n=inv_n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)
    if r.device.type == "cpu":
        return pr_update_plain(contrib, r, out_deg, affected, **kw)
    return _launch(contrib, r, out_deg, affected, **kw)


def pr_update_sweep_plain(hi_sums, hi_ids, r, out_deg, affected, r_new,
                          aff_new, dn, *, hi_sel=None, prior=None,
                          slot_fn=None, **kw):
    """The plain version of `pr_update_sweep`: the per-slot entry
    `slot_fn` (default `pr_update`) over operands gathered at each slot's
    vertex id (sentinel ids read the inert pad r = 1, deg = 1, aff = 0),
    its outputs scattered back through the slot→vertex map (sentinel ids
    into a sink row, dropped), its max taken with `prior`."""
    n = r.shape[0]
    dt = r.dtype
    slot_fn = pr_update if slot_fn is None else slot_fn
    ids = hi_ids
    if hi_sel is not None:
        ids = take_fill(hi_ids, hi_sel, n)
        hi_sums = take_fill(hi_sums, hi_sel, 0.0)
    rh, ah, dh, ph = slot_fn(
        hi_sums, take_fill(r, ids, 1.0), take_fill(out_deg, ids, 1).to(dt),
        take_fill(affected, ids, False).to(dt), **kw)
    outs = (with_sink(r_new[:n], 0.0), with_sink(aff_new[:n], False),
            with_sink(dn[:n], False))
    outs[0][ids] = rh
    outs[1][ids] = ah > 0
    outs[2][ids] = dh > 0
    for dst, src in zip((r_new, aff_new, dn), outs):
        dst[:n].copy_(src[:n])
    return ph if prior is None else torch.maximum(prior, ph)


def pr_update_sweep(hi_sums: torch.Tensor, hi_ids: torch.Tensor,
                    r: torch.Tensor, out_deg: torch.Tensor,
                    affected: torch.Tensor, r_new: torch.Tensor,
                    aff_new: torch.Tensor, dn: torch.Tensor, *, alpha: float,
                    inv_n: float, tau_f: float, tau_p: float, prune: bool,
                    closed_form: bool, hi_sel: torch.Tensor | None = None,
                    prior: torch.Tensor | None = None) -> torch.Tensor:
    """The high side of one fused sweep, written in place.

    hi_sums [n_hi_cap] f64 (`csr_block_pull`'s per-slot sums), hi_ids
    [n_hi_cap] int32 (vertex id per slot, sentinel n); r [n] f64, out_deg
    [n] int32, affected [n] bool, read at each live slot's vertex id;
    r_new (f64), aff_new and dn (bool), [n] or longer, written at each
    live slot's vertex id and nowhere else. With `hi_sel`
    (ActiveFrontier.hi_sel: a [k_h] slot list, sentinel n_hi_cap) only the
    listed slots run. Returns the max |Δr| over those rows and `prior` (a
    0-d f64 tensor, the low side's max; NaN wins) as a 0-d tensor."""
    kw = dict(alpha=alpha, inv_n=inv_n, tau_f=tau_f, tau_p=tau_p,
              prune=prune, closed_form=closed_form)
    if r.device.type == "cpu":
        return pr_update_sweep_plain(hi_sums, hi_ids, r, out_deg, affected,
                                     r_new, aff_new, dn, hi_sel=hi_sel,
                                     prior=prior, **kw)
    return _launch_sweep(hi_sums, hi_ids, r, out_deg, affected, r_new,
                         aff_new, dn, hi_sel, prior, **kw)


def _epi_args(alpha, inv_n, tau_f, tau_p, prune, closed_form, dev):
    return (alpha, (1.0 - alpha) * inv_n, tau_f, tau_p, int(prune),
            int(closed_form), _build.stream_ptr(dev))


def _launch(contrib, r, deg, aff, **kw):
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"pr_update: no kernel for device {dev}")
    n = r.shape[0]
    if n == 0:
        raise ValueError("pr_update: empty input")
    for name, t in (("contrib", contrib), ("r", r), ("out_deg", deg),
                    ("affected", aff)):
        _build.check(f"pr_update {name}", t, torch.float64, (n,), dev)
    lib = _build.load("pr_update", _SIG)
    grid = lib.pr_update_grid(n)
    out = torch.empty((3, n), dtype=torch.float64, device=dev)
    partials = torch.empty(grid + 1, dtype=torch.float64, device=dev)
    err = lib.pr_update(
        contrib.data_ptr(), r.data_ptr(), deg.data_ptr(), aff.data_ptr(),
        out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(),
        partials.data_ptr(), n, *_epi_args(dev=dev, **kw))
    _build.launch_error("pr_update", err)
    pr_update.launches += 1
    return out[0], out[1], out[2], partials[grid]


def _launch_sweep(sums, ids, r, deg, aff, r_new, aff_new, dn, sel, prior,
                  **kw):
    dev = r.device
    if dev.type != "cuda":
        raise ValueError(f"pr_update_sweep: no kernel for device {dev}")
    n = r.shape[0]
    cap = ids.shape[0]
    _build.check("pr_update_sweep hi_sums", sums, torch.float64, (cap,), dev)
    _build.check("pr_update_sweep hi_ids", ids, torch.int32, (cap,), dev)
    _build.check("pr_update_sweep r", r, torch.float64, (n,), dev)
    _build.check("pr_update_sweep out_deg", deg, torch.int32, (n,), dev)
    _build.check("pr_update_sweep affected", aff, torch.bool, (n,), dev)
    for name, t, dt in (("r_new", r_new, torch.float64),
                        ("aff_new", aff_new, torch.bool),
                        ("dn", dn, torch.bool)):
        _build.check_out(f"pr_update_sweep {name}", t, dt, n, dev)
    count = cap
    if sel is not None:
        count = sel.shape[0]
        _build.check("pr_update_sweep hi_sel", sel, torch.int32, (count,),
                     dev)
    if prior is not None:
        _build.check("pr_update_sweep prior", prior, torch.float64, (), dev)
    lib = _build.load("pr_update", _SIG)
    grid = lib.pr_update_grid(count)
    partials = torch.empty(grid + 1, dtype=torch.float64, device=dev)
    err = lib.pr_update_sweep(
        sums.data_ptr(), ids.data_ptr(), None if sel is None
        else sel.data_ptr(), count, cap, r.data_ptr(), deg.data_ptr(),
        aff.data_ptr(), r_new.data_ptr(), aff_new.data_ptr(), dn.data_ptr(),
        n, None if prior is None else prior.data_ptr(), partials.data_ptr(),
        *_epi_args(dev=dev, **kw))
    _build.launch_error("pr_update_sweep", err)
    pr_update.launches += 1
    return partials[grid]


pr_update.launches = 0
