"""Plain-PyTorch oracles for the CUDA kernels (the ``ref.py`` contract).

Each function computes what the corresponding kernel computes, with plain
tensor ops, on any device. The kernel modules build their plain versions
from these, which the wrappers run on CPU tensors and `chip_smoke.py`
holds each kernel against on the card.

`pr_update_ref` intentionally does NOT import `core.rank_step`: it is the
independent check on the engines' shared math, so sharing code here would
let a bug in `rank_step` cancel out.
"""
from __future__ import annotations

import math

import torch

__all__ = ["ell_pull_ref", "csr_block_pull_ref", "pr_update_ref",
           "linf_delta_ref", "flash_attention_ref"]


def _gather(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return c.index_select(0, idx.reshape(-1)).view(idx.shape)


def ell_pull_ref(c: torch.Tensor, ell_idx: torch.Tensor,
                 ell_mask: torch.Tensor) -> torch.Tensor:
    """sum_j c[idx[v, j]] * mask[v, j] — the lane-per-vertex pull."""
    return (_gather(c, ell_idx) * ell_mask.to(c.dtype)).sum(1)


def csr_block_pull_ref(c: torch.Tensor, hi_tiles: torch.Tensor,
                       hi_tmask: torch.Tensor, hi_rowmap: torch.Tensor,
                       n_rows: int) -> torch.Tensor:
    """Per-high-vertex tile sums accumulated by the tile->row map."""
    tile_sums = (_gather(c, hi_tiles) * hi_tmask.to(c.dtype)).sum(1)
    return c.new_zeros(n_rows).index_add_(0, hi_rowmap, tile_sums)


def pr_update_ref(contrib: torch.Tensor, r: torch.Tensor,
                  out_deg: torch.Tensor, affected: torch.Tensor, *,
                  alpha: float, inv_n: float, tau_f: float, tau_p: float,
                  prune: bool, closed_form: bool):
    """Fused rank update (Eq. 1 / Eq. 2) + prune + frontier flag + |Δr|.

    contrib[v] = sum_{u in in(v)} R[u]/|out(u)| (already reduced).
    Returns (r_new, affected', delta_n, max_abs_dr); the flags come back in
    `affected`'s dtype.
    """
    d = out_deg.to(r.dtype)
    c0 = (1.0 - alpha) * inv_n
    if closed_form:
        rv = (c0 + alpha * (contrib - r / d)) / (1.0 - alpha / d)
    else:
        rv = c0 + alpha * contrib
    aff = affected > 0
    r_new = torch.where(aff, rv, r)
    dr = torch.abs(r_new - r)
    rel = dr / torch.maximum(r_new, r)
    if prune:
        aff = aff & ~(rel <= tau_p)
    delta_n = rel > tau_f
    return (r_new, aff.to(affected.dtype), delta_n.to(affected.dtype),
            torch.max(dr))


def linf_delta_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(a - b))


def flash_attention_ref(q, k, v, *, causal=True):
    """Exact softmax attention. q [BH,S,D]; k,v [BH,T,D]."""
    s = torch.einsum("bqd,btd->bqt", q.float(), k.float()) \
        / math.sqrt(q.shape[-1])
    if causal:
        S, T = q.shape[1], k.shape[1]
        mask = (torch.arange(T, device=q.device)[None, :]
                <= torch.arange(S, device=q.device)[:, None])
        s = s.masked_fill(~mask[None], float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bqt,btd->bqd", w, v.float()).to(q.dtype)
