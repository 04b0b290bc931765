"""The rounding of the attention backward's plain version, on the CPU.

`flash_attention_bwd_plain(round_p=True)` defines what the tensor-core
backward kernels (`csrc/flash_attention_bwd.cu`, bf16 at D 64, 128 and
256) round: p to bf16 for the dV product and dS (after the soft-cap's
factor) to bf16 for the dK and dQ products, everything else f32. Here it
is held:

- against autograd through `flash_attention_bshd_plain(round_p=True)`
  within 2^-6 of each gradient's max |value| (the bar of
  tests/test_torch_train.py: Dr comes from the bf16 output where autograd
  differentiates the f32 one, and each gradient is rounded to bf16);
- against `jax.vjp` of the JAX package's `chunked_attention` in bf16 (the
  reference's own gradient: it rounds p for PV and dP = dO V^T to bf16,
  keeps dS f32, and rounds its results to bf16 at other places) within
  2^-5 of each gradient's max |value|, GQA with 6 query heads over 2 kv
  heads at D 64, inputs from one numpy seed; full attention is JAX's
  causal mask with every key before the queries (q_offset = T);
- without `round_p`, bit for bit against the f32 closed form the scalar
  kernels are held to (the formula as it stood before the rounding of dS
  was added), and in f32 `round_p` changes nothing.

Each case runs causal and full, at S 64 and 96 and a ragged S; the first
two also with gemma2's window and soft-cap, alone and together (causal, q
scaled by 3 so that scores reach the cap), against `chunked_attention(
window=, cap=)`'s VJP. MLA's widths (q/k 192 over v 128, the pair the
tensor-core backward also takes) run the same three holds, with one kv
head a query head (4 over 4: deepseek-v3's G = 1) causal and full at the
same lengths, and once with GQA (4 over 2).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models.attention import chunked_attention  # noqa: E402
from repro_torch.kernels.flash_attn import (  # noqa: E402
    NEG, flash_attention_bshd_plain, flash_attention_bwd,
    flash_attention_bwd_plain)

B, H, K, D = 2, 6, 2, 64
CASES = [(64, True), (64, False), (96, True), (96, False), (50, True),
         (50, False)]
CASE_IDS = [f"S{s}-{'causal' if c else 'full'}" for s, c in CASES]
# gemma2's window and soft-cap, alone and together (causal: JAX's
# chunked_attention is), q scaled by 3 so that scores reach the cap:
# (S, window, cap)
MOD_CASES = [(96, 24, None), (96, None, 2.0), (96, 24, 2.0), (50, 16, 1.5)]
MOD_IDS = [f"S{s}-causal" + (f"-w{w}" if w else "")
           + (f"-cap{c:g}" if c else "") for s, w, c in MOD_CASES]
GQA = (H, K, D, D)                  # (query heads, kv heads, q/k, v width)
# MLA's q/k width 192 over v width 128: G = 1 at every case, GQA once
MLA = [(s, c, (4, 4, 192, 128)) for s, c in CASES] + [(64, True,
                                                         (4, 2, 192, 128))]
MLA_IDS = [f"mla-{i}" for i in CASE_IDS] + ["mla-S64-causal-gqa"]
ALL = ([(s, c, None, None, GQA) for s, c in CASES]
       + [(s, True, w, c, GQA) for s, w, c in MOD_CASES]
       + [(s, c, None, None, w) for s, c, w in MLA])
ALL_IDS = CASE_IDS + MOD_IDS + MLA_IDS
F32 = [(s, c, GQA) for s, c in CASES] + MLA
F32_IDS = CASE_IDS + MLA_IDS
TOL_AUTOGRAD = 2.0 ** -6
TOL_JAX = 2.0 ** -5


def _inputs(S: int, dtype=torch.bfloat16, q_scale=1.0, widths=GQA):
    """q, k, v, do as `dtype` tensors from one numpy seed per length, q
    times `q_scale`, at `widths` (query heads, kv heads, q/k width, v
    width)."""
    h, kh, d, dv = widths
    rng = np.random.default_rng(1000 + S)
    shapes = ((B, S, h, d), (B, S, kh, d), (B, S, kh, dv), (B, S, h, dv))
    x = [rng.standard_normal(sh).astype(np.float32) for sh in shapes]
    x[0] = x[0] * np.float32(q_scale)
    return [torch.from_numpy(a).to(dtype) for a in x]


def _mod_inputs(S, cap, dtype=torch.bfloat16, widths=GQA):
    return _inputs(S, dtype, 1.0 if cap is None else 3.0, widths)


def _rel(got, want) -> float:
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("S,causal,window,cap,widths", ALL, ids=ALL_IDS)
def test_round_p_matches_autograd(S, causal, window, cap, widths):
    q, k, v, do = _mod_inputs(S, cap, widths=widths)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    kw = dict(causal=causal, window=window, cap=cap)
    o, lse = flash_attention_bshd_plain(q, k, v, round_p=True,
                                        return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    o.detach(), lse, do, round_p=True, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert _rel(g, w) <= TOL_AUTOGRAD


def _jax_grads(q, k, v, do, causal: bool, window=None, cap=None):
    """jax.vjp of chunked_attention in bf16 on the same values."""
    S, T = q.shape[1], k.shape[1]
    chunk = 32 if S % 32 == 0 else S
    q_offset = 0 if causal else T

    def to_jax(x):
        return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)

    def f(q_, k_, v_):
        return chunked_attention(q_, k_, v_, chunk=chunk, q_offset=q_offset,
                                 window=window, cap=cap)

    _, vjp = jax.vjp(f, to_jax(q), to_jax(k), to_jax(v))
    return [torch.from_numpy(np.array(g.astype(jnp.float32)))
            for g in vjp(to_jax(do))]


@pytest.mark.parametrize("S,causal,window,cap,widths", ALL, ids=ALL_IDS)
def test_round_p_near_jax_bf16_vjp(S, causal, window, cap, widths):
    q, k, v, do = _mod_inputs(S, cap, widths=widths)
    kw = dict(causal=causal, window=window, cap=cap)
    o, lse = flash_attention_bshd_plain(q, k, v, round_p=True,
                                        return_lse=True, **kw)
    got = flash_attention_bwd_plain(q, k, v, o, lse, do, round_p=True, **kw)
    want = _jax_grads(q, k, v, do, causal, window, cap)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        assert bool(torch.isfinite(g.float()).all())
        assert _rel(g, w) <= TOL_JAX


def _bwd_f32_reference(q, k, v, o, lse, do, causal):
    """The f32 closed form as the scalar kernels' oracle computed it before
    round_p also rounded dS: the same operations in the same order."""
    B_, S, H_, D_ = q.shape
    T, K_, Dv_ = k.shape[1], k.shape[2], v.shape[3]
    G = H_ // K_
    scale = 1.0 / math.sqrt(D_)
    qf = q.float().reshape(B_, S, K_, G, D_)
    dof = do.float().reshape(B_, S, K_, G, Dv_)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    if causal:
        allow = torch.arange(T)[None, :] <= torch.arange(S)[:, None]
        s = torch.where(allow, s, NEG)
    p = torch.exp(s - lse.reshape(B_, K_, G, S, 1))
    dr = (do.float() * o.float()).sum(-1)
    dr = dr.permute(0, 2, 1).reshape(B_, K_, G, S, 1)
    ds = p * (torch.einsum("bskgd,btkd->bkgst", dof, vf) - dr)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    return (dq.reshape(B_, S, H_, D_).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize("S,causal,widths", F32, ids=F32_IDS)
def test_f32_unchanged_bit_for_bit(S, causal, widths):
    q, k, v, do = _inputs(S, torch.float32, widths=widths)
    o, lse = flash_attention_bshd_plain(q, k, v, causal=causal,
                                        return_lse=True)
    want = _bwd_f32_reference(q, k, v, o, lse, do, causal)
    for round_p in (False, True):      # in f32 the rounding is the identity
        got = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        round_p=round_p)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)


@pytest.mark.parametrize("S,causal", CASES, ids=CASE_IDS)
def test_round_p_rounds_p_and_ds_only(S, causal):
    """bf16 inputs: without round_p the products take the f32 p and dS
    (the reference above); with it they differ, and by no more than the
    bf16 rounding of p and dS can move them."""
    q, k, v, do = _inputs(S)
    o, lse = flash_attention_bshd_plain(q, k, v, causal=causal, round_p=True,
                                        return_lse=True)
    want = _bwd_f32_reference(q, k, v, o, lse, do, causal)
    plain = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    rounded = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        round_p=True)
    for a, w, r in zip(plain, want, rounded):
        assert torch.equal(a, w)
        assert not torch.equal(r, w)
        assert _rel(r, w) <= 2.0 ** -6


def test_cpu_calls_launch_nothing():
    """On CPU tensors the wrapper runs the plain version: no launch of
    either design is counted."""
    q, k, v, do = _inputs(64)
    o, lse = flash_attention_bshd_plain(q, k, v, round_p=True,
                                        return_lse=True)
    before = (flash_attention_bwd.launches, flash_attention_bwd.launches_tc)
    got = flash_attention_bwd(q, k, v, o, lse, do)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (flash_attention_bwd.launches,
            flash_attention_bwd.launches_tc) == before

