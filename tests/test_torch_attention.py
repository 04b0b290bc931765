"""repro_torch's attention kernel, attention, layers and configs against the
JAX package, on the CPU.

The same inputs, made with numpy from a seed, go through both packages in
f32. Bars:
  * `flash_attention` (on the CPU its plain version, the online softmax
    the CUDA kernel computes) against the Pallas kernel in interpret mode
    and against `flash_attention_ref`: 2e-5, the bar of
    tests/test_kernels.py's sweep;
  * `chunked_attention` (GQA, window, soft-cap): 1e-5;
  * norms, RoPE, M-RoPE and the MLPs: 1e-6 (M-RoPE on three distinct
    position streams laid out as Qwen2-VL lays out text and an image
    grid, `grid_positions`: equal streams cannot show a wrong section
    split, and with them M-RoPE is RoPE exactly);
  * configs: `dataclasses.asdict` equal;
  * the plain version with a sliding window and a tanh soft-cap (gemma2's
    local and global layers) against `chunked_attention`: 2e-5 in f32;
  * the int8 KV cache: `quantize_kv` codes equal to JAX's, scales within
    f32 rounding; `attn_decode` on an int8 cache within 1e-5, its codes
    within one step;
  * the plain version with `round_p=True` (the tensor-core kernel's
    rounding: p to bf16 before PV) in bf16 against JAX's bf16
    `chunked_attention`, which rounds p so: per element 2^-8 max|v| +
    2^-7 |want| (a p weight that rounds to the other neighbouring bf16
    value under another blocking or summation order moves the output by at
    most 2^-8 of that weight times |v|, and the weights of a row sum to 1;
    the output's own rounding adds one bf16 ulp), and a mean |diff| of at
    most 1e-4, which the f32-p plain version misses;
  * the plain versions with v narrower than q and k (MLA's q/k width 192
    over v width 128, and the smoke config's 24 over 16) against
    `chunked_attention`: f32 at 2e-5, bf16 with `round_p` at the bar
    above.
The CUDA kernels themselves are held against the plain version on the
card by `chip_smoke.py` (phase 9).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attn import flash_attention as j_flash  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels import flash_attn as tflash  # noqa: E402
from repro_torch.kernels.flash_attn import (  # noqa: E402
    flash_attention, flash_attention_bshd, flash_attention_bshd_plain,
    flash_attention_plain, tensor_core_path)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

KERNEL_TOL = 2e-5
ATTN_TOL = 1e-5
LAYER_TOL = 1e-6
ARCHS = ("qwen2-1.5b", "smollm-360m", "qwen3-4b", "gemma2-9b",
         "recurrentgemma-2b", "rwkv6-1.6b", "qwen2-vl-2b", "musicgen-large",
         "dbrx-132b", "deepseek-v3-671b")


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def grid_positions(B, n_text, grid, n_after):
    """M-RoPE position ids [B, 3, S] (int32) laid out as Qwen2-VL lays out
    text, one image and text: `n_text` text tokens at i on all three
    streams (t, h, w); then the image's grid of h x w patches in one
    frame, patch (r, c) at t = s, h = s + r, w = s + c (s = n_text); then
    `n_after` text tokens from the largest position + 1 on."""
    h, w = grid
    s = n_text
    rows, cols = np.divmod(np.arange(h * w), w)
    image = np.stack([np.full(h * w, s), s + rows, s + cols])
    nxt = s + max(h, w)
    pos = np.concatenate([np.broadcast_to(np.arange(s), (3, s)), image,
                          np.broadcast_to(np.arange(nxt, nxt + n_after),
                                          (3, n_after))], axis=1)
    return np.broadcast_to(pos, (B,) + pos.shape).astype(np.int32).copy()


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# -- the kernel ----------------------------------------------------------------

@pytest.mark.parametrize("S,T,D,bq,bk", [(64, 64, 16, 16, 16),
                                         (128, 128, 32, 64, 32),
                                         (32, 32, 8, 32, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_ref(S, T, D, bq, bk, causal):
    """tests/test_kernels.py's sweep: the port (plain on the CPU) against
    the Pallas kernel in interpret mode and against the exact softmax."""
    rng = np.random.default_rng(S + T + D)
    q, k, v = _normal(rng, 4, S, D), _normal(rng, 4, T, D), \
        _normal(rng, 4, T, D)
    before = flash_attention.launches
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    assert flash_attention.launches == before      # no kernel on the CPU
    assert got.dtype == torch.float32 and got.shape == (4, S, D)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    _close(got, j_flash(jq, jk, jv, bq=bq, bk=bk, causal=causal), KERNEL_TOL)
    _close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal),
           KERNEL_TOL)
    _close(tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal),
           jref.flash_attention_ref(jq, jk, jv, causal=causal), KERNEL_TOL)


@pytest.mark.parametrize("S,T,causal", [(100, 100, True), (37, 300, False),
                                        (300, 37, True), (1, 5, True)])
def test_flash_attention_plain_ragged(S, T, causal):
    """Lengths off every block size: the plain online softmax equals the
    exact softmax (the card checks the kernel at S = T = 1000)."""
    rng = np.random.default_rng(S * 7 + T)
    q, k, v = (torch.from_numpy(a) for a in (
        _normal(rng, 3, S, 32), _normal(rng, 3, T, 32), _normal(rng, 3, T, 32)))
    got = flash_attention_plain(q, k, v, causal=causal)
    _close(got, tref.flash_attention_ref(q, k, v, causal=causal), KERNEL_TOL)
    assert bool(torch.isfinite(got).all())


def test_flash_attention_bf16_plain_keeps_f32_statistics():
    """bf16 in, bf16 out; the statistics are f32, so the result is the
    exact softmax of the bf16 inputs rounded once."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 96, 64)).to(torch.bfloat16)
               for _ in range(3))
    got = flash_attention_plain(q, k, v)
    want = tref.flash_attention_ref(q.float(), k.float(), v.float())
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of values |x| < 4: half an ulp is 2^-8 * 2 = 2^-7
    _close(got.float(), want, 2.0 ** -7)


@pytest.mark.parametrize("H,K", [(4, 2), (4, 4), (6, 1)])
def test_flash_attention_bshd_maps_kv_heads(H, K):
    """The model-layout entry (q head h reads kv head h // (H // K))
    against the model's own chunked schedule, both in f32."""
    rng = np.random.default_rng(H * 10 + K)
    B, S, D = 2, 64, 16
    q = torch.from_numpy(_normal(rng, B, S, H, D))
    k = torch.from_numpy(_normal(rng, B, S, K, D))
    v = torch.from_numpy(_normal(rng, B, S, K, D))
    got = flash_attention_bshd(q, k, v)
    assert got.shape == (B, S, H, D)
    _close(got, tattn.chunked_attention(q, k, v, chunk=16), KERNEL_TOL)
    _close(got, jattn.chunked_attention(jnp.asarray(q.numpy()),
                                        jnp.asarray(k.numpy()),
                                        jnp.asarray(v.numpy()), chunk=16),
           KERNEL_TOL)


@pytest.mark.parametrize("S,chunk,D", [(100, 128, 64), (300, 150, 128),
                                       (384, 128, 64)])
def test_round_p_plain_matches_jax_chunked_attention_bf16(S, chunk, D):
    """The tensor-core kernel's oracle (p rounded to bf16 before PV, the
    row sum from the f32 p) against the model's own bf16 attention, with
    GQA (6 heads over 2) and lengths off the kernel's 128-row tiles."""
    rng = np.random.default_rng(S + D)
    B, H, K = 2, 6, 2
    q, k, v = (torch.from_numpy(_normal(rng, B, S, h, D)).to(torch.bfloat16)
               for h in (H, K, K))
    got = flash_attention_bshd_plain(q, k, v, round_p=True)
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, H, D)
    want = jattn.chunked_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (q, k, v)), chunk=chunk)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    bar = 2.0 ** -8 * float(v.float().abs().max()) + 2.0 ** -7 * want.abs()
    d = (got.float() - want).abs()
    assert bool((d <= bar).all()) and float(d.mean()) <= 1e-4
    # p kept in f32 is a different rounding: it misses the mean bar
    d32 = (flash_attention_bshd_plain(q, k, v).float() - want).abs()
    assert float(d32.mean()) > 1e-4


def _bf16_bar_ok(got, want, v):
    """The tensor-core kernel's bar: per element 2^-8 max|v| + 2^-7 |want|,
    mean |diff| <= 1e-4."""
    bar = 2.0 ** -8 * float(v.float().abs().max()) + 2.0 ** -7 * want.abs()
    d = (got.float() - want).abs()
    return bool((d <= bar).all()) and float(d.mean()) <= 1e-4


@pytest.mark.parametrize("D,window,cap", [(16, 24, 5.0), (16, 24, None),
                                          (16, None, 5.0), (256, 40, 50.0),
                                          (256, None, 50.0)])
def test_plain_window_and_cap_match_jax_chunked_attention(D, window, cap):
    """gemma2's attention kinds in the kernel's oracle: the soft-cap on the
    scaled scores, then the causal and window masks, as the model's
    `chunked_attention` (S > window, so the window masks). q is scaled so
    that the scores reach the cap. f32 at 2e-5; bf16 with `round_p` at
    the tensor-core bar."""
    rng = np.random.default_rng(D + (window or 0))
    B, S, H, K = 2, 96, 4, 2
    scale = 3.0 if D == 16 else 40.0
    q = _normal(rng, B, S, H, D) * scale
    k, v = _normal(rng, B, S, K, D), _normal(rng, B, S, K, D)
    kw = dict(window=window, cap=cap)
    got = flash_attention_bshd_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                                     **kw)
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   chunk=32, **kw)
    _close(got, want, KERNEL_TOL)
    # the window and the cap change the result: neither is a no-op here
    plain = flash_attention_bshd_plain(*(torch.from_numpy(a)
                                         for a in (q, k, v)))
    assert float((got - plain).abs().max()) > 1e-2
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_bshd_plain(tq, tk, tv, round_p=True, **kw)
    want = jattn.chunked_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (tq, tk, tv)), chunk=32, **kw)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and _bf16_bar_ok(got, want, tv)


@pytest.mark.parametrize("D,Dv,H,K,S,chunk", [(24, 16, 4, 4, 96, 32),
                                               (24, 16, 6, 2, 70, 35),
                                               (192, 128, 2, 2, 160, 64)])
def test_plain_narrow_v_matches_jax_chunked_attention(D, Dv, H, K, S, chunk):
    """MLA's attention in the kernel's oracle: q/k width D over v width
    Dv (the smoke config's 24 / 16 and the full config's 192 / 128; MLA
    has one kv head a query head, GQA is taken too), scale 1/sqrt(D).
    Both entries in f32 against the model's `chunked_attention` at 2e-5;
    bf16 with `round_p` at the tensor-core bar."""
    rng = np.random.default_rng(D + Dv + S)
    B = 2
    q, k = _normal(rng, B, S, H, D), _normal(rng, B, S, K, D)
    v = _normal(rng, B, S, K, Dv)
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   chunk=chunk)
    got = flash_attention_bshd_plain(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (B, S, H, Dv)
    _close(got, want, KERNEL_TOL)
    if H == K:                        # the [BH, S, D] entry: one kv head each
        def bh(a):
            return torch.from_numpy(a).permute(0, 2, 1, 3).reshape(
                B * H, S, a.shape[-1])
        got = flash_attention(bh(q), bh(k), bh(v))
        assert got.shape == (B * H, S, Dv)
        _close(got.reshape(B, H, S, Dv).permute(0, 2, 1, 3), want,
               KERNEL_TOL)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = flash_attention_bshd_plain(tq, tk, tv, round_p=True)
    want = jattn.chunked_attention(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (tq, tk, tv)), chunk=chunk)
    want = torch.from_numpy(np.array(want.astype(jnp.float32)))
    assert got.dtype == torch.bfloat16 and _bf16_bar_ok(got, want, tv)


def test_flash_attention_entries_take_window_and_cap():
    """The [BH, S, D] entry and the model-layout one pass the window and
    the cap to the plain version on the CPU; the heads of one kv head
    agree with the [BH, S, D] entry."""
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 70, 1, 32) * 4)
               for _ in range(3))
    kw = dict(window=20, cap=3.0)
    got = flash_attention_bshd(q, k, v, **kw)
    _close(got, tattn.chunked_attention(q, k, v, chunk=35, **kw), KERNEL_TOL)
    _close(flash_attention(q[:, :, 0], k[:, :, 0], v[:, :, 0], **kw),
           got[:, :, 0], 0.0)


def test_flash_attention_fn_refuses_what_the_backward_lacks():
    """FlashAttentionFn differentiates the window, the soft-cap and head
    width 256 (gemma2's layers): on CPU tensors its output, with and
    without a gradient, is the plain forward's exactly, and its backward
    gives autograd's gradients through the plain forward.
    The same on the CPU at MLA's q/k width 192 over v width 128, where the
    plain backward takes the narrower v. What it still refuses is a device
    without a kernel: on `meta`, with a gradient and with the window, the
    cap or width 256, the call reaches the kernel's device check and
    raises before any launch, as does the backward itself; and so, since
    the backward kernels take 192 / 128 too (MLA's training), does a
    gradient there, in the Function's forward and in the backward, as the
    forward without a gradient does."""
    assert tflash.HEAD_DIMS == (16, 32, 64, 128, 256)
    assert tflash.V_PAIRS == ((192, 128),)
    assert not hasattr(tflash, "BWD_HEAD_DIMS")
    rng = np.random.default_rng(22)
    for D, Dv, window, cap in ((16, 16, 8, None), (16, 16, None, 5.0),
                               (16, 16, 8, 5.0), (256, 256, 8, 5.0),
                               (192, 128, None, None)):
        q, k, v = (torch.from_numpy(_normal(rng, 1, 40, h, d) * 3)
                   .requires_grad_() for h, d in ((2, D), (1, D), (1, Dv)))
        do = torch.from_numpy(_normal(rng, 1, 40, 2, Dv))
        out = tflash.FlashAttentionFn.apply(q, k, v, True, window, cap)
        ref = flash_attention_bshd_plain(q, k, v, window=window, cap=cap)
        _close(out.detach(), ref.detach(), 0.0)
        with torch.no_grad():
            _close(tflash.FlashAttentionFn.apply(q, k, v, True, window, cap),
                   ref.detach(), 0.0)
        got = torch.autograd.grad(out, (q, k, v), do)
        want = torch.autograd.grad(ref, (q, k, v), do)
        for g, w in zip(got, want):
            _close(g, w, KERNEL_TOL * float(w.abs().max()))
    m = torch.empty(1, 8, 2, 256, device="meta", requires_grad=True)
    lse = torch.empty(1, 2, 8, device="meta")
    for args in ((m, m, m, True, 8, None), (m, m, m, True, None, 5.0),
                 (m, m, m, True)):
        before = (flash_attention.launches,
                  tflash.flash_attention_bwd.launches)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tflash.FlashAttentionFn.apply(*args)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tflash.flash_attention_bwd(m, m, m, m, lse, m, window=8, cap=5.0)
        assert (flash_attention.launches,
                tflash.flash_attention_bwd.launches) == before
    mq = torch.empty(1, 8, 2, 192, device="meta", requires_grad=True)
    mv = torch.empty(1, 8, 2, 128, device="meta", requires_grad=True)
    before = (flash_attention.launches, tflash.flash_attention_bwd.launches)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash.FlashAttentionFn.apply(mq, mq, mv, True)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash.flash_attention_bwd(mq, mq, mv, mv, lse, mv)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash.FlashAttentionFn.apply(mq.detach(), mq.detach(), mv.detach(),
                                      True)
    assert (flash_attention.launches,
            tflash.flash_attention_bwd.launches) == before


def test_flash_attention_bwd_checks_mla_shapes_before_the_device():
    """flash_attention_bwd at MLA's q/k width 192 over v width 128: with o
    and do of v's width the call is one the kernels take and reaches the
    device check (on `meta`, no kernel); o or do of q's width, and a pair
    outside `V_PAIRS` (q/k 256 over v 128), raise ValueError naming the
    shape before it. None launches anything."""
    def meta(*shape):
        return torch.empty(*shape, device="meta")

    q, k, v = meta(1, 8, 4, 192), meta(1, 8, 4, 192), meta(1, 8, 4, 128)
    o, lse = meta(1, 8, 4, 128), meta(1, 4, 8)
    before = (tflash.flash_attention_bwd.launches,
              tflash.flash_attention_bwd.launches_tc)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash.flash_attention_bwd(q, k, v, o, lse, o)
    wide = meta(1, 8, 4, 192)
    with pytest.raises(ValueError, match=r"o is \(1, 8, 4, 192\), "
                                         r"expected \(1, 8, 4, 128\)"):
        tflash.flash_attention_bwd(q, k, v, wide, lse, o)
    with pytest.raises(ValueError, match=r"do is \(1, 8, 4, 192\)"):
        tflash.flash_attention_bwd(q, k, v, o, lse, wide)
    q2, k2 = meta(1, 8, 4, 256), meta(1, 8, 4, 256)
    with pytest.raises(ValueError, match="a pair not in"):
        tflash.flash_attention_bwd(q2, k2, v, o, lse, o)
    assert (tflash.flash_attention_bwd.launches,
            tflash.flash_attention_bwd.launches_tc) == before


@pytest.mark.parametrize("causal", [True, False])
def test_round_p_is_the_identity_in_f32(causal):
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 200, h, 32))
               for h in (4, 2, 2))
    assert torch.equal(
        flash_attention_bshd_plain(q, k, v, causal=causal, round_p=True),
        flash_attention_bshd_plain(q, k, v, causal=causal))
    qh, kh, vh = (x[:, :, 0] for x in (q, k, v))
    assert torch.equal(
        flash_attention_plain(qh, kh, vh, causal=causal, round_p=True),
        flash_attention_plain(qh, kh, vh, causal=causal))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
def test_tensor_core_path_is_bf16_at_64_and_128(dtype, D):
    """bf16 at D 64, 128 and gemma2's 256 runs on the tensor cores; f32 and
    the narrow widths on the scalar kernel."""
    assert tensor_core_path(dtype, D) == (dtype == torch.bfloat16
                                          and D in (64, 128, 256))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tensor_core_path_takes_the_mla_pair(dtype):
    """bf16 at q/k width 192 over v width 128 (MLA's) runs on the tensor
    cores, f32 on the scalar kernel; no other pair of widths is taken, and
    192 is no width of its own."""
    assert tensor_core_path(dtype, 192, 128) == (dtype == torch.bfloat16)
    assert tensor_core_path(dtype, 128, 128) == (dtype == torch.bfloat16)
    for D, Dv in ((192, 192), (256, 128), (192, 64), (128, 64)):
        assert not tensor_core_path(dtype, D, Dv)


def test_tma_operands_are_aligned_or_copied():
    """The tensor-core kernel's tensor maps need a 16-byte aligned base and
    strides of whole 16 bytes; a size-1 dimension gets its contiguous
    stride. A tensor that misses either is copied, and only for that
    kernel."""
    flat = torch.zeros(2 * 10 * 3 * 64 + 8, dtype=torch.bfloat16)
    off = flat[1:1 + 2 * 10 * 3 * 64].view(2, 10, 3, 64)     # 2-byte offset
    assert off.data_ptr() % 16 and off.is_contiguous()
    fixed = tflash._operand(off, True)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, off)
    assert tflash._operand(off, False) is off
    ok = torch.zeros(2, 10, 3, 64, dtype=torch.bfloat16)
    assert tflash._operand(ok, True) is ok
    assert tflash._strides(ok) == (1920, 192, 64)
    one = torch.zeros(5, 7, 64, dtype=torch.bfloat16).unsqueeze(2)
    assert tflash._strides(one) == (448, 64, 64)
    odd = torch.zeros(2, 10, 3, 68, dtype=torch.bfloat16)[..., :64]
    assert tflash._operand(odd, True).stride() == (1920, 192, 64, 1)
    assert tflash._operand(odd, False) is odd


def test_flash_attention_raises_off_cpu_and_cuda():
    q = torch.empty(2, 64, 16, device="meta")
    before = flash_attention.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention_bshd(q[:, :, None], q[:, :, None], q[:, :, None])
    assert flash_attention.launches == before


def test_bf16_at_tensor_core_widths_counts_no_launch_off_cuda():
    """On the CPU a bf16 call at D = 128 runs the plain version with f32 p
    (as the Pallas kernel) and counts no launch; on another device it
    raises before counting."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(_normal(rng, 1, 70, h, 128)).to(
        torch.bfloat16) for h in (2, 1, 1))
    before = flash_attention.launches, flash_attention.launches_tc
    assert torch.equal(flash_attention_bshd(q, k, v),
                       flash_attention_bshd_plain(q, k, v))
    m = torch.empty(2, 64, 128, device="meta", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(m, m, m)
    assert (flash_attention.launches, flash_attention.launches_tc) == before


# -- chunked attention ---------------------------------------------------------

@pytest.mark.parametrize("window,cap", [(None, None), (8, None), (None, 5.0),
                                        (8, 5.0)])
def test_chunked_attention_matches_jax(window, cap):
    rng = np.random.default_rng(11)
    B, S, H, K, D = 2, 64, 4, 2, 16
    q, k, v = _normal(rng, B, S, H, D), _normal(rng, B, S, K, D), \
        _normal(rng, B, S, K, D)
    got = tattn.chunked_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                  chunk=16, window=window, cap=cap)
    want = jattn.chunked_attention(*(jnp.asarray(a) for a in (q, k, v)),
                                   chunk=16, window=window, cap=cap)
    assert got.shape == (B, S, H, D)
    _close(got, want, ATTN_TOL)


# -- the int8 KV cache --------------------------------------------------------

def test_quantize_kv_matches_jax():
    """Codes equal to JAX's (round half to even, the division kept), scales
    within f32 rounding, dequantized values equal; rows of zeros (the
    1e-6 floor) and exact halves included. A cache that is not int8 gets
    x in its dtype and no scale."""
    rng = np.random.default_rng(23)
    x = _normal(rng, 2, 5, 3, 16) * rng.uniform(0.01, 20.0, (2, 5, 3, 1))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0, :6] = [127.0, 0.5, 1.5, 2.5, -2.5, -0.5]
    x[0, 1, 0, 6:] = 0.0
    tq, ts = tattn.quantize_kv(torch.from_numpy(x),
                               {"k": torch.zeros(1, dtype=torch.int8)})
    jq, js = jattn.quantize_kv(jnp.asarray(x),
                               {"k": jnp.zeros(1, jnp.int8)})
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq[0, 1, 0, :6].tolist() == [127, 0, 2, 2, -2, 0]
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2.0 ** -23,
                               atol=0)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = tattn.dequantize_kv(tq, ts, dt)
        want = jattn.dequantize_kv(jq, js, jdt)
        assert got.dtype == dt
        _close(got.float(), np.asarray(want.astype(jnp.float32)), 1e-6)
    same, none = tattn.quantize_kv(torch.from_numpy(x),
                                   {"k": torch.zeros(1, dtype=torch.bfloat16)})
    assert none is None and same.dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["attn", "attn_local"])
def test_attn_decode_int8_matches_jax(kind):
    """One layer's decode on an int8 cache (gemma2's smoke shapes: window
    16, soft-cap) for 24 positions, so the local cache's rolling slot
    wraps: outputs within 1e-5 of JAX's, codes within one step, scales
    within f32 rounding, at every position."""
    jcfg = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("gemma2-9b")),
        kv_cache_dtype="int8")
    tcfg = dataclasses.replace(
        tconfigs.smoke_config(tconfigs.get_config("gemma2-9b")),
        kv_cache_dtype="int8")
    rng = np.random.default_rng(24)
    d, H, K, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd
    p = {"wq": _normal(rng, d, H, hd), "wk": _normal(rng, d, K, hd),
         "wv": _normal(rng, d, K, hd), "wo": _normal(rng, H, hd, d)}
    p = {n: a / np.float32(np.sqrt(a.shape[0])) for n, a in p.items()}
    B, steps = 2, 24
    T = tcfg.window if kind == "attn_local" else steps
    tcache = tattn.init_kv_cache(tcfg, kind, B, T, torch.float32)
    jcache = jattn.init_kv_cache(jcfg, kind, B, T, jnp.float32)
    assert {n: (t.dtype, tuple(t.shape)) for n, t in tcache.items()} == {
        n: (getattr(torch, str(a.dtype)), a.shape) for n, a in jcache.items()}
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    for pos in range(steps):
        x = _normal(rng, B, 1, d)
        to, tcache2 = tattn.attn_decode(torch.from_numpy(x), tp, tcfg, kind,
                                        tcache, pos)
        jo, jcache = jattn.attn_decode(jnp.asarray(x), jp, jcfg, kind,
                                       jcache, pos)
        assert tcache2 is tcache                       # written in place
        _close(to, jo, ATTN_TOL)
        for n in ("k", "v"):
            codes = tcache[n].numpy().astype(np.int32)
            assert np.abs(codes - np.asarray(jcache[n])).max() <= 1
            np.testing.assert_allclose(tcache[n + "_scale"].numpy(),
                                       np.asarray(jcache[n + "_scale"]),
                                       rtol=1e-6, atol=0)


# -- layers --------------------------------------------------------------------

def test_norms_match_jax():
    rng = np.random.default_rng(5)
    x, w, b = _normal(rng, 3, 7, 48), _normal(rng, 48), _normal(rng, 48)
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    _close(tlayers.rmsnorm(tx, tw), jlayers.rmsnorm(jnp.asarray(x),
                                                    jnp.asarray(w)), LAYER_TOL)
    _close(tlayers.layernorm(tx, tw, tb),
           jlayers.layernorm(*(jnp.asarray(a) for a in (x, w, b))), LAYER_TOL)
    for kind in ("rmsnorm", "layernorm"):
        tp = tlayers.norm_init(kind, 48, torch.float32)
        jp = jlayers.norm_init(kind, 48, jnp.float32)
        assert sorted(tp) == sorted(jp)
        _close(tlayers.apply_norm(kind, tx, tp),
               jlayers.apply_norm(kind, jnp.asarray(x), jp), LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_apply_rope_matches_jax(theta):
    rng = np.random.default_rng(6)
    x = _normal(rng, 2, 40, 3, 32)
    pos = np.broadcast_to(np.arange(40), (2, 40)) + 7
    got = tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                             theta)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    _close(got, want, LAYER_TOL)
    _close(tlayers.rope_freqs(32, theta), jlayers.rope_freqs(32, theta), 0.0)


# (head width, sections): the smoke configs' and qwen2-vl-2b's
MROPE = [(16, (2, 3, 3)), (128, (16, 24, 24))]


@pytest.mark.parametrize("hd,sections", MROPE)
def test_mrope_apply_matches_jax(hd, sections):
    rng = np.random.default_rng(hd)
    pos = grid_positions(2, 5, (4, 6), 7)
    x = _normal(rng, 2, pos.shape[-1], 3, hd)
    assert not (pos[:, 0] == pos[:, 1]).all()
    assert not (pos[:, 1] == pos[:, 2]).all()
    got = tlayers.mrope_apply(torch.from_numpy(x), torch.from_numpy(pos),
                              1_000_000.0, sections)
    want = jlayers.mrope_apply(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0,
                               sections)
    _close(got, want, LAYER_TOL)
    with pytest.raises(ValueError, match="sections"):
        tlayers.mrope_apply(torch.from_numpy(x), torch.from_numpy(pos),
                            1e6, (1, 3, 3))


@pytest.mark.parametrize("hd,sections", MROPE)
def test_mrope_with_equal_streams_is_rope(hd, sections):
    """Three equal streams: exactly `apply_rope` (the case a test on
    `batch_for`'s positions sees); the grid's streams move the image's
    rows, which a section split must reach."""
    rng = np.random.default_rng(hd + 1)
    x = torch.from_numpy(_normal(rng, 2, 40, 3, hd))
    pos = torch.arange(40).expand(2, 40) + 3
    got = tlayers.mrope_apply(x, pos[:, None].expand(2, 3, 40), 1e6,
                              sections)
    assert torch.equal(got, tlayers.apply_rope(x, pos, 1e6))
    grid = torch.from_numpy(grid_positions(2, 5, (4, 6), 11))
    other = tlayers.mrope_apply(x, grid, 1e6, sections)
    flat = tlayers.apply_rope(x, grid[:, 0], 1e6)
    assert torch.equal(other[:, :5], flat[:, :5])      # text: t = h = w
    assert not torch.allclose(other[:, 5:29], flat[:, 5:29])


def test_attn_with_mrope_matches_jax():
    """qwen2-vl's attention layer (smoke shapes, sections (2, 3, 3)) on
    grid positions: attn_apply within 1e-5 of JAX's; then attn_decode,
    whose step gives all three streams its position, at every position
    of an 8-token prompt."""
    jcfg = jconfigs.smoke_config(jconfigs.get_config("qwen2-vl-2b"))
    tcfg = tconfigs.smoke_config(tconfigs.get_config("qwen2-vl-2b"))
    rng = np.random.default_rng(27)
    d, H, K, hd = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads, tcfg.hd
    p = {"wq": _normal(rng, d, H, hd), "wk": _normal(rng, d, K, hd),
         "wv": _normal(rng, d, K, hd), "wo": _normal(rng, H, hd, d)}
    p = {n: a / np.float32(np.sqrt(a.shape[0])) for n, a in p.items()}
    p.update(bq=_normal(rng, H, hd), bk=_normal(rng, K, hd),
             bv=_normal(rng, K, hd))
    tp = {n: torch.from_numpy(a) for n, a in p.items()}
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    pos = grid_positions(2, 6, (3, 5), 9)
    x = _normal(rng, 2, pos.shape[-1], d)
    to, (tk, _) = tattn.attn_apply(torch.from_numpy(x), tp, tcfg, "attn",
                                   torch.from_numpy(pos))
    jo, (jk, _) = jattn.attn_apply(jnp.asarray(x), jp, jcfg, "attn",
                                   jnp.asarray(pos))
    _close(to, jo, ATTN_TOL)
    _close(tk, jk, ATTN_TOL)
    B, steps = 2, 8
    tcache = tattn.init_kv_cache(tcfg, "attn", B, steps, torch.float32)
    jcache = jattn.init_kv_cache(jcfg, "attn", B, steps, jnp.float32)
    for t in range(steps):
        xt = _normal(rng, B, 1, d)
        to, tcache = tattn.attn_decode(torch.from_numpy(xt), tp, tcfg,
                                       "attn", tcache, t)
        jo, jcache = jattn.attn_decode(jnp.asarray(xt), jp, jcfg, "attn",
                                       jcache, t)
        _close(to, jo, ATTN_TOL)
    _close(tcache["k"], jcache["k"], ATTN_TOL)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_apply_matches_jax(kind):
    rng = np.random.default_rng(7)
    x = _normal(rng, 2, 5, 24)
    names = ("wg", "wu", "wd") if kind != "gelu" else ("wu", "wd")
    p = {n: _normal(rng, *((40, 24) if n == "wd" else (24, 40))) * 0.2
         for n in names}
    got = tlayers.mlp_apply(torch.from_numpy(x),
                            {n: torch.from_numpy(a) for n, a in p.items()},
                            kind)
    want = jlayers.mlp_apply(jnp.asarray(x),
                             {n: jnp.asarray(a) for n, a in p.items()}, kind)
    _close(got, want, LAYER_TOL)
    init = tlayers.mlp_init(24, 40, kind, torch.float32,
                            generator=torch.Generator().manual_seed(0))
    assert {n: tuple(a.shape) for n, a in init.items()} == \
        {n: a.shape for n, a in p.items()}


def test_positions_and_softcap_match_jax():
    pos = np.arange(12)
    _close(tlayers.sinusoidal_positions(torch.from_numpy(pos), 16),
           jlayers.sinusoidal_positions(jnp.asarray(pos), 16), LAYER_TOL)
    x = np.linspace(-40, 40, 101).astype(np.float32)
    _close(tlayers.softcap(torch.from_numpy(x), 30.0),
           jlayers.softcap(jnp.asarray(x), 30.0), LAYER_TOL)
    tx = torch.from_numpy(x)
    assert tlayers.softcap(tx, None) is tx


def test_dense_init_is_a_truncated_fan_in_normal():
    g = torch.Generator().manual_seed(0)
    w = tlayers.dense_init((512, 256), dtype=torch.float32, generator=g)
    std = 1.0 / np.sqrt(512)
    assert float(w.abs().max()) <= 2.0 * std + 1e-7
    # the standard deviation of N(0, 1) cut at ±2 is 0.8796
    assert abs(float(w.std()) / std - 0.8796) < 0.01
    w2 = tlayers.dense_init((512, 256), dtype=torch.float32,
                            generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, w2)
    assert tlayers.dense_init((4, 3, 2), in_axis_size=6, dtype=torch.bfloat16,
                              generator=g).dtype == torch.bfloat16


# -- configs -------------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_jax(name):
    tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(tconfigs.smoke_config(tcfg)) == \
        dataclasses.asdict(jconfigs.smoke_config(jcfg))
    assert tcfg.layer_kinds() == jcfg.layer_kinds() and tcfg.hd == jcfg.hd


def test_config_classes_match_jax_field_for_field():
    for t, j in ((tconfigs.ArchConfig, jconfigs.ArchConfig),
                 (tconfigs.MoECfg, jconfigs.MoECfg),
                 (tconfigs.MLACfg, jconfigs.MLACfg),
                 (tconfigs.RecCfg, jconfigs.RecCfg)):
        assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
            [(f.name, f.default) for f in dataclasses.fields(j)]
    assert set(tconfigs.list_configs()) == set(ARCHS)
    assert set(ARCHS) <= set(jconfigs.list_configs())
