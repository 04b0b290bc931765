"""repro_torch's LM training path against the JAX package, on the CPU.

- `flash_attention_bwd_plain` (the closed-form backward, the CUDA
  kernel's oracle) against autograd through `flash_attention_bshd_plain`:
  causal and full, S = T and ragged, GQA with H / K in {1, 2, 3}, D in
  {16, 64, 256}, and gemma2's window and soft-cap alone and together
  (the cap's derivative 1 - t^2 in dS). f32 within 1e-5 of each
  gradient's max |value| (the closed form is exact; only f32 rounding
  differs). bf16 within 2^-6 of it: the
  plain backward takes Dr = rowsum(dO * O) from the bf16 output, while
  autograd differentiates the f32 output before its rounding, so Dr is
  off by up to 2^-8 |O| |dO| per term, and both round each gradient to
  bf16 (2^-8 relative).
- `FlashAttentionFn` on CPU tensors against autograd through
  `chunked_attention` at the model's chunking, within 1e-5 of the max.
- `LMModel.loss` and one `train_step` against `repro.models.LMModel`
  (jit) for the smoke configs of qwen2-1.5b, smollm-360m, qwen3-4b,
  gemma2-9b (two layers: gemma2's local, window 16, and global, with both
  soft-caps, the post-norms and the untied head), recurrentgemma-2b (its
  pattern of two RG-LRU layers and a local one, then its suffix of two
  RG-LRU layers), rwkv6-1.6b (two layers), qwen2-vl-2b (M-RoPE on
  distinct grid position streams; embedding inputs, whose unread `embed`
  leaf gets JAX's zero gradient), musicgen-large (embedding inputs) and
  dbrx-132b (MoE, its aux loss in the loss at 0.01x; Adafactor with bf16
  gradient accumulation; the JAX weights carried over) and
  deepseek-v3-671b (MLA, autograd through `chunked_attention` on the CPU;
  three dense layers, then MoE with the sigmoid router and a shared
  expert; Adafactor as dbrx's), f32: loss, aux
  and grad_norm within 1e-5 relative; every gradient
  leaf within 1e-5 of its max |value| (sums in another order); after
  the step m within 1e-5 and v within 2e-5 of their leaves' max (v is
  g², so its relative error doubles); the
  weights within 1e-6 plus lr x min(2, 2 d / (|g| + eps)) per element,
  where d is the gradient's bar and g JAX's clipped gradient: AdamW's
  first step is lr g / (|g| + eps), about lr sign(g), which moves by up to
  2 lr where |g| is within d of 0 and by d / |g| elsewhere. Also two
  microbatches (B = 4), a bf16 copy (below) and Adafactor: its update
  divides each gradient entry by a factored RMS of its row and column, so
  entries far below their column's scale (RoPE's slow dimensions of the k
  bias) carry their rounding into the update (JAX's own update moves the
  k bias by 2e-3 of its max between the two packages' gradients). So its
  gradients are held as above and its weights and factors, within 1e-5 of
  each leaf's max, against JAX's update of the port's gradients
  (qwen2-1.5b; and the two recurrent families, whose nested and f32
  leaves Adafactor keys by the same paths).
- rwkv6's f32 gradients in both packages against the same model's
  gradients in f64 (the port's, with `.float()` keeping f64): the
  witness that they differ by rounding, which card-against-host checks
  of the wkv at larger sizes rely on.
- The loop against `train_step` driven by hand and on a one-rank mesh,
  the launcher (gemma2's smoke config too), the mesh flags in a world of
  one process; remat keeps no layer's (k, v) and changes no gradient.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
import repro.optim as jopt  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.data import batch_for  # noqa: E402
from repro_torch.kernels.flash_attn import (  # noqa: E402
    FlashAttentionFn, flash_attention_bshd_plain, flash_attention_bwd,
    flash_attention_bwd_plain)
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import LMModel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    jax_tree, opt_state_from_jax, params_from_jax, unstack_jax_tree)
from repro_torch.train import train as ttrain  # noqa: E402
from test_torch_attention import grid_positions  # noqa: E402

CPU = dict(device="cpu")
ARCHS = ("qwen2-1.5b", "smollm-360m", "qwen3-4b", "gemma2-9b",
         "recurrentgemma-2b", "rwkv6-1.6b", "qwen2-vl-2b", "musicgen-large",
         "dbrx-132b", "deepseek-v3-671b")
TOL = 1e-5
LR, EPS = 3e-4, 1e-8            # adamw_update's defaults in both packages


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _rel(got, want):
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max() / want.abs().max())


# -- the attention backward ----------------------------------------------------

# (S, T, H, K, D, causal, window, cap): gemma2's window and soft-cap alone
# and together, at D 16, 64 and 256 (q scaled by 3 where capped, so that
# scores reach the cap)
BWD_CASES = [
    (40, 40, 4, 4, 16, True, None, None),
    (40, 40, 4, 2, 64, True, None, None),
    (33, 33, 6, 2, 16, True, None, None),
    (24, 37, 3, 1, 16, False, None, None),
    (37, 24, 6, 2, 64, False, None, None),
    (50, 50, 6, 3, 16, False, None, None),
    (40, 40, 4, 2, 16, True, 8, None), (40, 40, 4, 2, 64, True, None, 2.0),
    (33, 33, 6, 2, 256, True, 12, 1.5), (48, 48, 4, 4, 256, True, None, 2.0),
    (36, 36, 4, 1, 256, True, 7, None), (30, 30, 6, 3, 64, True, 5, 1.5),
    (50, 50, 6, 3, 16, False, 10, 2.0)]


def _bwd_id(case):
    """The case's id: the first six values (as pytest names them), then
    the window and cap where given."""
    *head, window, cap = case
    if window is not None:
        head.append(f"w{window}")
    if cap is not None:
        head.append(f"cap{cap:g}")
    return "-".join(str(x) for x in head)


@pytest.mark.parametrize("S,T,H,K,D,causal,window,cap", BWD_CASES,
                         ids=[_bwd_id(c) for c in BWD_CASES])
def test_bwd_plain_matches_autograd(S, T, H, K, D, causal, window, cap):
    rng = np.random.default_rng(S * T + H + D)
    qs = 1.0 if cap is None else 3.0
    q = torch.from_numpy(qs * _normal(rng, 2, S, H, D)).requires_grad_()
    k = torch.from_numpy(_normal(rng, 2, T, K, D)).requires_grad_()
    v = torch.from_numpy(_normal(rng, 2, T, K, D)).requires_grad_()
    do = torch.from_numpy(_normal(rng, 2, S, H, D))
    kw = dict(causal=causal, window=window, cap=cap)
    o, lse = flash_attention_bshd_plain(q, k, v, return_lse=True, **kw)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    o.detach(), lse, do, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= TOL


@pytest.mark.parametrize("round_p", [False, True])
def test_bwd_plain_bf16_near_autograd(round_p):
    rng = np.random.default_rng(7)
    q, k, v, do = (torch.from_numpy(_normal(rng, 2, 48, h, 64)).to(
        torch.bfloat16) for h in (6, 2, 2, 6))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    o, lse = flash_attention_bshd_plain(q, k, v, round_p=round_p,
                                        return_lse=True)
    want = torch.autograd.grad(o, (q, k, v), do)
    got = flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                    o.detach(), lse, do, round_p=round_p)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and _rel(g, w) <= 2.0 ** -6


def test_lse_is_the_rows_logsumexp():
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(_normal(rng, 2, 70, h, 16)) for h in (4, 2, 2))
    _, lse = flash_attention_bshd_plain(q, k, v, return_lse=True)
    s = torch.einsum("bshd,bthd->bhst", q, k.repeat_interleave(2, 2)) / 4.0
    s = s.masked_fill(torch.ones(70, 70, dtype=torch.bool).triu(1), -1e30)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_flash_attention_fn_matches_chunked_attention_grads():
    """On CPU tensors the Function runs the plain forward and backward;
    its gradients are chunked_attention's (autograd) at chunk 32."""
    rng = np.random.default_rng(9)
    qkv = [torch.from_numpy(_normal(rng, 2, 64, h, 16)).requires_grad_()
           for h in (4, 2, 2)]
    do = torch.from_numpy(_normal(rng, 2, 64, 4, 16))
    launches = flash_attention_bwd.launches
    got_o = FlashAttentionFn.apply(*qkv, True)
    got = torch.autograd.grad(got_o, qkv, do)
    want_o = tattn.chunked_attention(*qkv, chunk=32)
    want = torch.autograd.grad(want_o, qkv, do)
    assert _rel(got_o.detach(), want_o.detach()) <= TOL
    for g, w in zip(got, want):
        assert _rel(g, w) <= TOL
    assert flash_attention_bwd.launches == launches     # no kernel here


def test_flash_attention_fn_raises_off_cpu_and_cuda():
    q = torch.empty(1, 8, 2, 16, device="meta", requires_grad=True)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        FlashAttentionFn.apply(q, q, q, True)
    m = torch.empty(1, 8, 2, 16, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention_bwd(m, m, m, m, lse, m)


# -- loss and train_step against JAX -------------------------------------------

def _cfgs(name, layers=2, **kw):
    """Both packages' smoke configs of `name` with `layers` layers in its
    repeated pattern (at least one repeat: gemma2's local and global
    alternate), between its prefix and suffix."""
    out = []
    for c in (tconfigs, jconfigs):
        cfg = c.smoke_config(c.get_config(name))
        reps = max(1, layers // len(cfg.pattern))
        out.append(dataclasses.replace(
            cfg, n_layers=len(cfg.prefix) + reps * len(cfg.pattern)
            + len(cfg.suffix), repeats=reps, **kw))
    return tuple(out)


def _carry(name, key=0, **kw):
    tcfg, jcfg = _cfgs(name, **kw)
    jm = JLMModel(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.key(key))
    model = LMModel(tcfg, **CPU)
    model.params.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    return model, jm, jp, tcfg


def _flat(tree, cfg):
    return {k: np.asarray(v, dtype=np.float32)
            for k, v in unstack_jax_tree(tree, cfg).items()}


def _leaves_close(got: dict, want: dict, tol):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].detach().float().numpy()
        np.testing.assert_allclose(g, w, rtol=0, err_msg=k,
                                   atol=tol * max(np.abs(w).max(), 1e-30))


def _check_step(model, jm, jp, tcfg, B, S=32):
    """One loss, its gradients and one train_step in both packages (M-RoPE
    on grid positions: 4 text tokens, a 4 x 6 image, 4 text tokens)."""
    batch = batch_for(tcfg, B, S, 0, seed=1)
    if "positions" in batch:
        batch["positions"] = grid_positions(B, 4, (4, 6), S - 28)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jmet), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        jp, jb)
    tl, tmet = model.loss(batch)
    weights = dict(model.params.named_parameters())
    grads = torch.autograd.grad(tl, list(weights.values()), allow_unused=True)
    # embed_inputs: the loss reads no `embed`; JAX's gradient there is 0
    assert [k for k, g in zip(weights, grads) if g is None] == (
        ["embed"] if tcfg.embed_inputs else [])
    tg = {k: torch.zeros_like(w) if g is None else g
          for (k, w), g in zip(weights.items(), grads)}
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=TOL)
    np.testing.assert_allclose(float(tmet["loss"].detach()),
                               float(jmet["loss"]),
                               rtol=TOL)
    np.testing.assert_allclose(float(tmet["aux"].detach()),
                               float(jmet["aux"]), rtol=TOL)
    assert (float(jmet["aux"]) > 0) == (tcfg.moe is not None)
    jgf = _flat(jg, tcfg)
    _leaves_close(tg, jgf, TOL)
    jopt = jm.init_opt(jp)
    jnew, jstate, jm_ = jax.jit(jm.train_step)(jp, jopt, jb)
    topt, tm = model.train_step(model.init_opt(), batch)
    for key in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tm[key]), float(jm_[key]),
                                   rtol=TOL, atol=1e-30)
    return jnew, jstate, float(jm_["grad_norm"]), topt, tg


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_train_step_match_jax(name):
    """AdamW's state and weights against JAX's step; dbrx's Adafactor as
    `_adafactor_step` holds it (its 4-D expert leaves factored over their
    last two axes, the pattern stacked)."""
    model, jm, jp, tcfg = _carry(name)
    if tcfg.optimizer == "adafactor":
        _adafactor_step(name, 0, "pattern.0.ffn.wg",
                        (2, tcfg.moe.n_experts, tcfg.d_model), carried=(
                            model, jm, jp, tcfg))
        return
    jnew, jstate, _, topt, _ = _check_step(model, jm, jp, tcfg, B=2)
    assert int(topt.step) == int(jstate.step) == 1
    _leaves_close(topt.m, _flat(jstate.m, tcfg), TOL)
    _leaves_close(topt.v, _flat(jstate.v, tcfg), 2 * TOL)
    # the weights: AdamW's first step is about lr sign(g), see the docstring
    g_c = _flat(jstate.m, tcfg)             # 0.1 g_c: m holds the clipped g
    want = _flat(jnew, tcfg)
    for k, p in model.params.state_dict().items():
        g = np.abs(g_c[k]) / 0.1
        d = TOL * g.max()
        bar = 1e-6 + LR * np.minimum(2.0, 2 * d / (g + EPS))
        diff = np.abs(p.numpy() - want[k])
        assert (diff <= bar).all(), (k, float((diff - bar).max()))


def _grads_f64(model, tcfg, batch):
    """The port's loss gradients with every tensor in f64: the f32 model's
    weights widened, and `.float()` (the f32 casts of the norms, gates
    and recurrences) leaving f64 tensors f64. The witness for the f32
    gradients' rounding."""
    m64 = LMModel(tcfg, **CPU)
    m64.params.load_state_dict(model.params.state_dict())
    m64.params.double()
    to_f32 = torch.Tensor.float
    torch.Tensor.float = (lambda t, *a, **k: t if t.dtype == torch.float64
                          else to_f32(t, *a, **k))
    try:
        loss, _ = m64.loss(batch)
        weights = dict(m64.params.named_parameters())
        return dict(zip(weights, torch.autograd.grad(
            loss, list(weights.values()))))
    finally:
        torch.Tensor.float = to_f32


def test_rwkv6_f32_gradients_are_rounding_of_f64():
    """The witness that rwkv6's f32 gradients differ only by rounding: at
    the data of test_loss_and_train_step_match_jax, the port's and JAX's
    f32 gradient leaves each lie within 2e-5 of the same model's
    gradients in f64 (of the f64 leaf's max; at the smoke widths the
    decays start at 1 - 2.5e-3, so each leaf is an almost undamped sum
    with cancellation, and both packages' f32 rounding comes to about
    1e-5), and the f64 gradients of two chunkings agree to 1e-10."""
    name = "rwkv6-1.6b"
    model, jm, jp, tcfg = _carry(name)
    batch = batch_for(tcfg, 2, 32, 0, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jg = _flat(jax.jit(jax.grad(lambda p: jm.loss(p, jb)[0]))(jp), tcfg)
    loss, _ = model.loss(batch)
    weights = dict(model.params.named_parameters())
    tg = dict(zip(weights, torch.autograd.grad(loss, list(weights.values()))))
    g64 = _grads_f64(model, tcfg, batch)
    half = dataclasses.replace(tcfg, rec=dataclasses.replace(
        tcfg.rec, chunk=tcfg.rec.chunk // 2))
    g64_half = _grads_f64(model, half, batch)
    worst = {"port": 0.0, "jax": 0.0, "port-jax": 0.0, "f64 chunks": 0.0}
    for k, w in g64.items():
        w = w.numpy()
        top = max(np.abs(w).max(), 1e-300)
        for what, err in (("port", tg[k].numpy() - w), ("jax", jg[k] - w),
                          ("port-jax", tg[k].numpy() - jg[k]),
                          ("f64 chunks", g64_half[k].numpy() - w)):
            worst[what] = max(worst[what], float(np.abs(err).max() / top))
    print("rwkv6 gradient leaves, max |err| / max |f64|:", worst)
    assert worst["f64 chunks"] <= 1e-10, worst
    assert worst["port"] <= 2e-5, worst
    assert worst["jax"] <= 2e-5, worst
    assert worst["port-jax"] <= TOL, worst


def test_train_step_accumulates_two_microbatches():
    model, jm, jp, tcfg = _carry("smollm-360m", key=1)
    assert tcfg.microbatch == 2
    _check_step(model, jm, jp, tcfg, B=4)


def test_adafactor_train_step_matches_jax():
    _adafactor_step("qwen2-1.5b", 2, "pattern.0.ln1.w")


@pytest.mark.parametrize("name,path", [
    ("recurrentgemma-2b", "pattern.0.mix.lam"),
    ("rwkv6-1.6b", "pattern.0.mix.mu.r")])
def test_adafactor_train_step_matches_jax_recurrent(name, path):
    """The same for the recurrent families: their nested (`mu.r`) and f32
    (`lam`) leaves, and recurrentgemma's unstacked suffix."""
    _adafactor_step(name, 5, path)


def _adafactor_step(name, key, path, vr_shape=None, carried=None):
    """One Adafactor train_step; its weights and factors against JAX's
    update of the port's gradients, rounded first to the config's
    `grad_accum_dtype` as both packages' accumulators round them. `path`'s
    row factor has `vr_shape` (default: the pattern's repeats, a vector
    leaf's)."""
    model, jm, jp, tcfg = carried or _carry(name, key=key,
                                            optimizer="adafactor")
    _, _, gn, topt, tg = _check_step(model, jm, jp, tcfg, B=2)
    assert gn == 0.0 and type(topt).__name__ == "AdafactorState"
    # JAX's update of the port's gradients (see the docstring)
    acc = getattr(torch, tcfg.grad_accum_dtype)
    g_tree = jax_tree({k: v.to(acc).float().numpy() for k, v in tg.items()},
                      tcfg, np.stack)
    jnew, jstate, _ = jax.jit(jopt.adafactor_update)(
        jax.tree.map(jnp.asarray, g_tree), jm.init_opt(jp), jp)
    _leaves_close(dict(model.params.state_dict()), _flat(jnew, tcfg), TOL)
    # keyed by the JAX tree's paths, the pattern stacked (its factors and
    # update clip span the layer axis)
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    assert topt.vr[path].shape == (vr_shape or (tcfg.repeats,))
    for got, w in ((topt.vr, want.vr), (topt.vc, want.vc)):
        _leaves_close(got, {k: v.numpy() for k, v in w.items()}, TOL)


def test_bf16_train_step_near_jax():
    """bf16 weights and activations: the two frameworks round at other
    places (XLA fuses an op chain and rounds once, PyTorch rounds every
    op's output), so the loss agrees to 2^-6 relative (a few bf16 ulps
    through two layers into the f32 head) and each gradient leaf to 0.1
    of its max |value| (bf16 products and sums, 8 significant bits, over
    B x S = 64 rows). The step's weights stay bf16 and its state f32."""
    model, jm, jp, tcfg = _carry("qwen2-1.5b", key=3, dtype="bfloat16")
    batch = batch_for(tcfg, 2, 32, 0, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, _), jg = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(jp, jb)
    tl, _ = model.loss(batch)
    weights = dict(model.params.named_parameters())
    tg = dict(zip(weights, torch.autograd.grad(tl, list(weights.values()))))
    np.testing.assert_allclose(float(tl.detach()), float(jl),
                               rtol=2.0 ** -6)
    _leaves_close(tg, _flat(jg, tcfg), 0.1)
    topt, tm = model.train_step(model.init_opt(), batch)
    assert np.isfinite(float(tm["loss"])) and float(tm["grad_norm"]) > 0
    assert all(p.dtype == torch.bfloat16 for p in model.params.parameters())
    assert all(m.dtype == torch.float32 for m in topt.m.values())


def test_remat_keeps_no_layer_cache_and_same_gradients():
    """Under autograd each block runs under torch.utils.checkpoint and
    forward_full keeps no (k, v); the gradients equal those of the same
    stack run without remat (a cache asked for turns remat off)."""
    model, _, _, tcfg = _carry("qwen3-4b", key=4)
    batch = {"tokens": torch.from_numpy(batch_for(tcfg, 2, 32, 0)["tokens"])}
    logits, caches, _ = ttfm.forward_full(model.params, tcfg, batch)
    assert caches is None
    w = list(model.params.parameters())
    g_remat = torch.autograd.grad(logits.sum(), w)
    logits2, caches2, _ = ttfm.forward_full(model.params, tcfg, batch,
                                            want_cache=True)
    assert len(caches2) == tcfg.n_layers
    for a, b in zip(g_remat, torch.autograd.grad(logits2.sum(), w)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the loop and the launcher -------------------------------------------------

def test_loop_steps_as_train_step_and_mesh_raises():
    """`train` is `train_step` on `batch_for`'s step-indexed batches from
    a model of the same seed: the same losses, bit for bit, logged every
    `log_every` steps and at the last. On a one-rank mesh (a process
    group of this process alone) the loop trains the same model within
    f32 rounding; a mesh larger than the world raises `ValueError` naming
    the world size (`test_torch_lm_mesh.py` trains on meshes of 2 and 4
    ranks)."""
    tcfg, _ = _cfgs("smollm-360m", layers=1)
    params, hist = ttrain(tcfg, steps=5, batch=2, seq=32, log_every=2,
                          seed=3, **CPU)
    assert [h["step"] for h in hist] == [2, 4, 5]
    assert set(hist[0]) == {"loss", "aux", "grad_norm", "step", "sec"}
    model = LMModel(tcfg, seed=3, **CPU)
    opt, losses = model.init_opt(), []
    for step in range(5):
        opt, m = model.train_step(opt, batch_for(tcfg, 2, 32, step, seed=3))
        losses.append(float(m["loss"]))
    assert [h["loss"] for h in hist] == [losses[1], losses[3], losses[4]]
    for a, b in zip(params.parameters(), model.params.parameters()):
        assert torch.equal(a, b)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    with pytest.raises(ValueError, match="world size 1"):
        make_local_mesh(2, device="cpu")
    mesh = make_local_mesh(1, device="cpu")
    try:
        assert mesh.shape == {"data": 1, "model": 1}
        mparams, mhist = ttrain(tcfg, steps=5, batch=2, seq=32, log_every=2,
                                seed=3, mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert [h["step"] for h in mhist] == [2, 4, 5]
    for h, w in zip(mhist, hist):
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(h[k], w[k], rtol=1e-6, atol=1e-30)
    for a, b in zip(mparams.parameters(), params.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_launcher_smoke_on_cpu(capsys):
    tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--steps", "3",
                  "--batch", "2", "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=qwen2-1.5b-smoke device=cpu" in out
    assert "final loss:" in out


def test_launcher_smoke_gemma2_on_cpu(capsys):
    """gemma2's smoke config (window 16, both soft-caps, post-norms, the
    untied head) through the launcher at a length past its window."""
    tlaunch.main(["--arch", "gemma2-9b", "--smoke", "--steps", "3",
                  "--batch", "2", "--seq", "40", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "arch=gemma2-9b-smoke device=cpu" in out
    assert "final loss:" in out


@pytest.mark.parametrize("flags", [["--production-mesh"],
                                   ["--production-mesh", "--multi-pod"],
                                   ["--model-parallel", "2"]])
def test_launcher_mesh_flags_raise(flags):
    """The mesh flags build a mesh of the world's ranks: one process is
    not a (16, 16), a (2, 16, 16) or a (0.5, 2) mesh (under 4 ranks
    `--model-parallel 2` trains: `test_torch_lm_mesh.py`)."""
    with pytest.raises(ValueError, match=r"world size (is )?1\b"):
        tlaunch.main(["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
                      *flags])


def test_training_defaults_to_cuda():
    tcfg, _ = _cfgs("smollm-360m", layers=1)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain(tcfg, steps=1, batch=2, seq=32)
