"""``flash_attention``: causal (or full) softmax attention with an online
softmax, every statistic in f32 and the output in the input's type — the
kernel of the LM's prefill. Beside the Pallas kernel's function it takes
what the model's `chunked_attention` computes: a sliding window (`window`:
a key is allowed only when qpos − kpos < window) and a tanh soft-cap
(`cap`: scores s / sqrt(D) become cap · tanh(s / (sqrt(D) cap)) before the
mask), as gemma2's local and global layers need.

Two entries share one CUDA source (`csrc/flash_attention.cu`) and its
launch counts:

- `flash_attention(q, k, v, causal=, window=, cap=)` keeps the Pallas
  kernel's signature, q [BH, S, D] and k, v [BH, T, D];
- `flash_attention_bshd(q, k, v, causal=, window=, cap=)` takes the
  model's q [B, S, H, D] and k, v [B, T, K, D] (H a multiple of K:
  grouped-query attention). The kernel reads them through their strides
  and maps q head h to kv head h // (H // K) itself, so nothing is
  repeated; `attn_apply` reaches the kernel here.

v may be narrower than q and k in one pair, `V_PAIRS`: q/k width 192
over v width 128, MLA's (DeepSeek-V3's `qk_nope_dim` 128 + `qk_rope_dim`
64, `v_head_dim` 128; `mla_apply` reaches the kernel there). The scale is
1/sqrt of q's width and the output takes v's: [B, S, H, Dv]. The kernels
are instantiated for the pair itself, not padded to 256 (which would do
1.6x the products and write 2x the output).

The source holds two kernels (`tensor_core_path` says which one a call
takes):

- bf16 at head widths 64, 128 and 256, and at the pair 192 / 128: the
  Hopper kernel (TMA-fed K/V ring, `wgmma` on the tensor cores; 64-row
  K/V tiles at 256; at 192 / 128 a head's q tiles launched side by side,
  so that they share its K/V in L2). Under a
  window it loads and computes only the K/V tiles some row of its q tile
  may see. It rounds p to bf16 before the PV product, as the model's
  `chunked_attention` does, and keeps the row sum from the f32 p. Its
  tensor maps need 16-byte aligned bases and strides; a tensor that
  misses that is copied first. `flash_attention.launches_tc` counts its
  launches;
- f32 (the pair 192 / 128 too), and bf16 at widths 16 and 32: the
  scalar kernel, p in f32.

`flash_attention.launches` counts every launch of either. On a CUDA tensor
the wrapper launches a kernel; on a CPU tensor it runs the plain version
(`flash_attention_plain`, the same online softmax in plain PyTorch, over
kv blocks of 128 as the Pallas kernel; `round_p=True` rounds p as the
tensor-core kernel does); on any other device it raises. Any S, T >= 1
(under a window, S <= T: every row keeps a key).
With `return_lse=True` either kernel also writes each query row's
log-sum-exp, f32 [B, H, S] in natural-log units.

The gradient (the Pallas kernel has none; JAX differentiates
`chunked_attention`): `FlashAttentionFn` is the autograd Function that
`attn_apply` runs on CUDA tensors. Its forward asks for `lse` only when a
gradient is wanted and then saves q, k, v, o and lse (and the window and
cap); its backward launches `flash_attention_bwd`
(`csrc/flash_attention_bwd.cu`), which recomputes p from `lse` with the
forward's window and soft-cap (the cap's derivative 1 - t^2 joins dS).
Its source holds two designs, chosen by `tensor_core_path` as the
forward's are:

- bf16 at head widths 64, 128 and 256, and at the pair 192 / 128: the
  Hopper kernels (TMA rings, `wgmma`; a dK/dV kernel per (batch, query
  head, k tile) writing f32 per-head partials into a scratch of
  B T H (D + Dv) floats that a small kernel sums over each kv head's
  query heads in a fixed order, and a dQ kernel; at 256 and at 192 / 128
  their own layouts: 64-row tiles, the two consumer warpgroups splitting
  dK from dV and the k tiles of dQ, and at 192 / 128 a head's tiles
  launched side by side, so that they share its tiles in L2; the wrapper
  allocates the scratch at the size the library's
  `flash_attention_bwd_work` gives).
  Under a window they visit only the tiles some allowed pair lies in. The
  tensor cores take bf16 operands, so p is rounded to bf16 for dV and dS
  for dK and dQ: `flash_attention_bwd_plain(round_p=True)` rounds the
  same. `flash_attention_bwd.launches_tc` counts these calls;
- f32 (the pair 192 / 128 too), and bf16 at widths 16 and 32: the scalar
  kernels, all in f32.

The backward takes the calls the forward takes (`V_PAIRS` included:
MLA's training); dq and dk have q's width, dv, o and do v's.

`flash_attention_bwd.launches` counts every call (each launches its
design's kernels together). On CPU tensors both halves run their plain
versions; `flash_attention_bwd_plain` is the closed form and the kernels'
oracle.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

__all__ = ["flash_attention", "flash_attention_bshd", "flash_attention_plain",
           "flash_attention_bshd_plain", "flash_attention_bwd",
           "flash_attention_bwd_plain", "FlashAttentionFn",
           "tensor_core_path", "NEG", "HEAD_DIMS", "TC_HEAD_DIMS",
           "V_PAIRS"]

NEG = -2.0 ** 30      # large finite mask value: a masked score gives exp 0
HEAD_DIMS = (16, 32, 64, 128, 256)
TC_HEAD_DIMS = (64, 128, 256)   # bf16 widths of the tensor-core kernels
V_PAIRS = ((192, 128),)   # (q/k width, narrower v width): MLA's, both dtypes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_L = ctypes.c_longlong
_SIG = {"flash_attention": [_build.P] * 5 + [_build.I] * 8 + [_L] * 9
        + [_build.I, _build.I, ctypes.c_float, _build.P]}
_SIG_BWD = {"flash_attention_bwd": [_build.P] * 10 + [_build.I] * 8
            + [_L] * 9 + [_build.I, _build.I, ctypes.c_float, _build.P],
            "flash_attention_bwd_work": [_build.I] * 7
            + [ctypes.POINTER(_L)]}


def tensor_core_path(dtype: torch.dtype, head_dim: int,
                     v_dim: int = None) -> bool:
    """Whether a call in `dtype` at q/k width `head_dim` and v width `v_dim`
    (`head_dim` unless given) takes the tensor-core kernel (the C entry
    dispatches on the same values)."""
    v_dim = head_dim if v_dim is None else v_dim
    if dtype != torch.bfloat16:
        return False
    if v_dim == head_dim:
        return head_dim in TC_HEAD_DIMS
    return (head_dim, v_dim) in V_PAIRS


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window=None, cap=None,
                          round_p: bool = False, return_lse: bool = False):
    """The kernel's function in plain PyTorch: q [BH, S, D], k [BH, T, D],
    v [BH, T, Dv] (Dv = D, or narrower: MLA's); an online softmax over kv
    blocks of 128 rows (the Pallas kernel's bk) with the running max, sum
    and accumulator in f32, masked scores at NEG.
    As `chunked_attention`: the scores s / sqrt(D) are soft-capped to
    cap · tanh(s / (sqrt(D) cap)) when `cap` is given, then a key is masked
    when it lies in the future (`causal`) or `window` or more positions
    back. p stays f32 for the PV product; with `round_p` it is first
    rounded to q's dtype, as the tensor-core kernel and `chunked_attention`
    round it (the row sum still from the f32 p; the identity in f32). Returns
    [BH, S, Dv] in q's dtype, and with `return_lse` also each row's
    log-sum-exp m + log l, f32 [BH, S]."""
    BH, S, D = q.shape
    T, Dv = k.shape[1], v.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    qpos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((BH, S, 1), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, S, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, S, Dv), dtype=torch.float32, device=q.device)
    for j0 in range(0, T, 128):
        kj = k[:, j0:j0 + 128].float()
        vj = v[:, j0:j0 + 128].float()
        s = torch.einsum("bqd,btd->bqt", qf, kj) * scale
        if cap is not None:
            s = torch.tanh(s / cap) * cap
        kpos = torch.arange(j0, j0 + kj.shape[1], device=q.device)[None]
        if causal:
            s = torch.where(kpos <= qpos, s, NEG)
        if window is not None:
            s = torch.where(qpos - kpos < window, s, NEG)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        pv = p.to(q.dtype).float() if round_p else p
        acc = acc * corr + torch.einsum("bqt,btd->bqd", pv, vj)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    out = (acc / den).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(den))[..., 0]
    return out


def _heads_first(x: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B * H, S, D]."""
    B, S, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, S, D)


def flash_attention_bshd_plain(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window=None, cap=None, round_p: bool = False,
                               return_lse: bool = False):
    """`flash_attention_plain` on the model's layout: q [B, S, H, D], k
    [B, T, K, D], v [B, T, K, Dv] with the kv heads repeated G = H // K
    times (q head h reads kv head h // G). Returns [B, S, H, Dv] (and with
    `return_lse` the row log-sum-exp, f32 [B, H, S])."""
    B, S, H, _ = q.shape
    G = H // k.shape[2]
    Dv = v.shape[-1]
    out = flash_attention_plain(
        _heads_first(q), _heads_first(k.repeat_interleave(G, dim=2)),
        _heads_first(v.repeat_interleave(G, dim=2)), causal=causal,
        window=window, cap=cap, round_p=round_p, return_lse=return_lse)
    if return_lse:
        out, lse = out
        return (out.reshape(B, H, S, Dv).permute(0, 2, 1, 3),
                lse.reshape(B, H, S))
    return out.reshape(B, H, S, Dv).permute(0, 2, 1, 3)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window=None, cap=None,
                              round_p: bool = False):
    """The backward in closed form, plain PyTorch with every product in
    f32: q [B, S, H, D], k [B, T, K, D], v [B, T, K, Dv], o, do [B, S, H,
    Dv], lse f32 [B, H, S] (the forward's; Dv = D, or MLA's narrower v). The logits are the forward's: X = S / sqrt(D), soft-capped
    to cap · t with t = tanh(X / cap) when `cap` is given, masked (P = 0,
    as the forward's NEG gives exp 0) where a key lies in the future
    (`causal`) or `window` or more positions back. With P = exp(logit -
    lse), Dr = rowsum(do * o), dS = P * (do V^T - Dr), times the cap's
    derivative 1 - t^2 when capped: dV = P^T do, dK = dS^T Q / sqrt(D),
    dQ = dS K / sqrt(D), the G query heads of a kv head summed into its dK
    and dV. With `round_p` the products take what the tensor-core kernel
    gives its tensor cores: P rounded to q's dtype for dV (the p the
    tensor-core forward weighed V by) and dS (after the cap's factor)
    rounded to q's dtype for dK and dQ; S, dP, P and dS stay f32 until
    then (dP is not rounded before the subtraction, where JAX's bf16 VJP
    of `chunked_attention` rounds it), and the identity in f32. Without it
    everything is f32, the scalar kernel's arithmetic. Dr comes from the
    output the forward returned, so in bf16 this is not the exact
    derivative of the rounded forward. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qf = q.float().reshape(B, S, K, G, D)
    dof = do.float().reshape(B, S, K, G, Dv)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bskgd,btkd->bkgst", qf, kf) * scale
    if cap is not None:
        t = torch.tanh(s / cap)
        s = t * cap
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    if causal:
        s = torch.where(kpos <= qpos, s, NEG)
    if window is not None:
        s = torch.where(qpos - kpos < window, s, NEG)
    p = torch.exp(s - lse.reshape(B, K, G, S, 1))
    dr = (do.float() * o.float()).sum(-1)                   # [B, S, H]
    dr = dr.permute(0, 2, 1).reshape(B, K, G, S, 1)
    ds = p * (torch.einsum("bskgd,btkd->bkgst", dof, vf) - dr)
    if cap is not None:
        ds = ds * (1 - t * t)
    if round_p:
        p, ds = p.to(q.dtype).float(), ds.to(q.dtype).float()
    dv = torch.einsum("bkgst,bskgd->btkd", p, dof)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qf) * scale
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale
    return (dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window=None,
                    cap=None) -> torch.Tensor:
    """q [BH, S, D], k/v [BH, T, D] (the Pallas kernel's signature; one kv
    head per q head; v may be [BH, T, Dv] for a pair of `V_PAIRS`).
    Returns [BH, S, Dv] in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap)
    return _launch(q.unsqueeze(2), k.unsqueeze(2), v.unsqueeze(2),
                   causal, window, cap).squeeze(2)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window=None, cap=None,
                         return_lse: bool = False):
    """q [B, S, H, D], k [B, T, K, D], v [B, T, K, Dv] (Dv = D, or a pair
    of `V_PAIRS`), H a multiple of K. Returns a contiguous [B, S, H, Dv]
    in q's dtype (and with `return_lse` the row log-sum-exp, f32 [B, H,
    S])."""
    if q.device.type == "cpu":
        return flash_attention_bshd_plain(q, k, v, causal=causal,
                                          window=window, cap=cap,
                                          return_lse=return_lse)
    return _launch(q, k, v, causal, window, cap, return_lse)


def _shapes(q, k, v):
    """Raise unless q [B, S, H, D], k [B, T, K, D] and v [B, T, K, Dv] are
    shapes the kernels take (Dv = D of `HEAD_DIMS`, or a pair of
    `V_PAIRS`)."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or H % K or S < 1 or T < 1:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not fit "
                         f"k/v {tuple(k.shape)}")
    if Dv == D and D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head width {D} not in "
                         f"{HEAD_DIMS}")
    if Dv != D and (D, Dv) not in V_PAIRS:
        raise ValueError(f"flash_attention: q/k width {D} over v width "
                         f"{Dv}, a pair not in {V_PAIRS}")


def _check(q, k, v, window=None, cap=None):
    """Raise unless q, k, v are tensors on one CUDA device that the kernels
    take; returns whether the call takes the tensor-core path."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {dev}")
    _shapes(q, k, v)
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype}, expected "
                        f"float32 or bfloat16")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"flash_attention: {name} is {t.dtype} on "
                             f"{t.device}, q {q.dtype} on {dev}")
    if window is not None and (int(window) != window or window < 1
                               or S > T):
        raise ValueError(f"flash_attention: window {window} (a positive "
                         f"int, with S {S} <= T {T})")
    if cap is not None and not cap > 0:
        raise ValueError(f"flash_attention: soft-cap {cap}, expected > 0")
    return tensor_core_path(q.dtype, D, Dv)


def _launch(q, k, v, causal, window=None, cap=None, return_lse=False):
    tc = _check(q, k, v, window, cap)
    dev = q.device
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    q, k, v = (_operand(t, tc) for t in (q, k, v))
    out = torch.empty((B, S, H, Dv), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=dev)
           if return_lse else None)
    lib = _build.load("flash_attention", _SIG)
    err = lib.flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        _DTYPES[q.dtype], B, H, K, S, T, D, Dv, *_strides(q), *_strides(k),
        *_strides(v), int(causal), int(window or 0), float(cap or 0.0),
        _build.stream_ptr(dev))
    _build.launch_error("flash_attention", err)
    flash_attention.launches += 1
    flash_attention.launches_tc += tc
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool = True,
                        window=None, cap=None):
    """(dq, dk, dv) of `flash_attention_bshd(q, k, v, causal=, window=,
    cap=)`: q [B, S, H, D], k [B, T, K, D], v [B, T, K, Dv] (Dv = D, or a
    pair of `V_PAIRS`), o and do [B, S, H, Dv], lse f32 [B, H, S] from the
    forward. On a CUDA tensor one call launches the backward kernels (the
    tensor-core design where `tensor_core_path` says so, rounding as
    `flash_attention_bwd_plain(round_p=True)`; else the scalar one, all
    f32); on a CPU tensor it runs `flash_attention_bwd_plain`; anything
    else raises. Returns contiguous gradients in the inputs' dtype, dv of
    v's width."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, cap=cap)
    # the shapes first, so that a call no kernel takes raises as such on
    # any device
    _shapes(q, k, v)
    B, S, H, D = q.shape
    T, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("o", o), ("do", do)):
        if tuple(t.shape) != (B, S, H, Dv):
            raise ValueError(f"flash_attention_bwd: {name} is "
                             f"{tuple(t.shape)}, expected {(B, S, H, Dv)}")
    tc = _check(q, k, v, window, cap)
    dev = q.device
    for name, t in (("o", o), ("do", do)):
        if t.device != dev:
            raise ValueError(f"flash_attention_bwd: {name} is on "
                             f"{t.device}, q on {dev}")
    o, do = o.to(q.dtype).contiguous(), do.to(q.dtype).contiguous()
    _build.check("flash_attention_bwd lse", lse, torch.float32, (B, H, S),
                 dev)
    q, k, v = (_operand(t, tc) for t in (q, k, v))
    lib = _build.load("flash_attention_bwd", _SIG_BWD)
    floats = _L()
    lib.flash_attention_bwd_work(_DTYPES[q.dtype], B, H, S, T, D, Dv,
                                 ctypes.byref(floats))
    work = torch.empty(floats.value, dtype=torch.float32, device=dev)
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, T, K, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, T, K, Dv), dtype=q.dtype, device=dev)
    err = lib.flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), work.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _DTYPES[q.dtype], B, H, K, S, T, D, Dv,
        *_strides(q), *_strides(k), *_strides(v), int(causal),
        int(window or 0), float(cap or 0.0), _build.stream_ptr(dev))
    _build.launch_error("flash_attention_bwd", err)
    flash_attention_bwd.launches += 1
    flash_attention_bwd.launches_tc += tc
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention_bshd(q, k, v, causal=, window=, cap=)` with a
    gradient: `FlashAttentionFn.apply(q, k, v, causal, window, cap)`. The
    forward writes the row log-sum-exp only when an input wants a gradient
    (as it does again when `torch.utils.checkpoint` recomputes it) and
    saves q, k, v, o and lse; the backward is `flash_attention_bwd` with
    the same causal flag, window and cap (v may be narrower: a pair of
    `V_PAIRS`)."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None, cap=None):
        want = any(ctx.needs_input_grad[:3])
        out = flash_attention_bshd(q, k, v, causal=causal, window=window,
                                   cap=cap, return_lse=want)
        ctx.causal, ctx.window, ctx.cap = causal, window, cap
        if not want:
            return out
        out, lse = out
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do,
                                         causal=ctx.causal,
                                         window=ctx.window, cap=ctx.cap)
        return dq, dk, dv, None, None, None


def _strides(t: torch.Tensor) -> tuple:
    """The (batch, row, head) strides of a [B, S, H, D] tensor in elements,
    a dimension of size 1 given its contiguous stride (it is never
    stepped, and a TMA stride must be a multiple of 16 bytes)."""
    st, n = [], t.shape[-1]
    for d in (2, 1, 0):
        st.append(t.stride(d) if t.shape[d] > 1 else n)
        n *= t.shape[d]
    return tuple(reversed(st))


def _operand(t: torch.Tensor, tc: bool) -> torch.Tensor:
    """`t` as the kernel reads it: the last dimension contiguous and, for
    the tensor-core kernel's tensor maps, a 16-byte aligned base and
    strides that are multiples of 16 bytes; a tensor that misses either is
    copied."""
    if t.stride(-1) != 1:
        return t.contiguous()
    if tc and (t.data_ptr() % 16
               or any(s * t.element_size() % 16 for s in _strides(t))):
        return t.clone(memory_format=torch.contiguous_format)
    return t


flash_attention.launches = 0
flash_attention.launches_tc = 0
flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0
