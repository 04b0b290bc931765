"""repro_torch's multi-head latent attention (DeepSeek-V3's MLA) against the
JAX package's `repro.models.attention`, on the CPU.

The same inputs, made with numpy from a seed, and the JAX package's
weights go through both packages in f32, at deepseek-v3-671b's smoke
widths (q/k width 24 = 16 + 8 over v width 16) and at the full config's
head widths (192 = 128 + 64 over 128) with narrow ranks and model width.
Bars: 1e-5 (`TOL`) for `mla_apply` (the output and its latent cache) and
for `mla_decode` at every position (its output and the cache it writes in
place); `init_mla_cache`'s names, dtypes and shapes equal to JAX's. The
port's own parity: the absorbed-matrix decode against the decompressed
full-sequence attention, position by position. `convert` carries every
MLA leaf and the shared expert both ways under JAX's tree paths. One
Adafactor `train_step` with bf16 gradient sums at 192 / 128 on the 3
dense layers that `chip_smoke.py` trains on the card, against JAX's, at
tests/test_torch_train.py's bars. On the CPU `mla_apply` runs
`chunked_attention`; the CUDA kernels at 192 / 128 (forward and
backward) are held against their plain versions on the card by
`chip_smoke.py` (phase 16).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import LMModel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    jax_paths, jax_tree, opt_state_from_jax, params_from_jax, params_to_jax,
    unstack_paths)

TOL = 1e-5
ARCH = "deepseek-v3-671b"
# the full config's head widths at narrow ranks: (q_lora_rank, kv_lora_rank,
# qk_nope_dim, qk_rope_dim, v_head_dim)
WIDE = (32, 16, 128, 64, 128)


def _cfgs(widths=None, **changes):
    """(port config, JAX config): deepseek-v3-671b's smoke config, its MLA
    widths replaced by `widths` where given."""
    out = []
    for c in (tconfigs, jconfigs):
        cfg = c.smoke_config(c.get_config(ARCH))
        if widths is not None:
            changes["mla"] = c.MLACfg(*widths)
        out.append(dataclasses.replace(cfg, **changes))
    return tuple(out)


def _weights(jcfg, key):
    """The JAX package's MLA weights (numpy) and the port's copy."""
    jp = jax.tree.map(np.asarray, jattn.mla_init(jax.random.key(key), jcfg,
                                                 jnp.float32))
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("widths", [None, WIDE], ids=["smoke", "wide"])
def test_mla_apply_matches_jax(widths):
    """The full-sequence pass: the output and the latent cache (ckv
    [B, S, r], k_rope [B, S, rope]); S = 64 spans two attention chunks."""
    tcfg, jcfg = _cfgs(widths)
    rng = np.random.default_rng(1)
    B, S = 2, 64
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jp, tp = _weights(jcfg, 0)
    jo, (jckv, jkr) = jattn.mla_apply(jnp.asarray(x), jp, jcfg,
                                      jnp.asarray(pos))
    to, (tckv, tkr) = tattn.mla_apply(torch.from_numpy(x), tp, tcfg,
                                      torch.from_numpy(pos).long())
    assert to.shape == (B, S, tcfg.d_model)
    assert tckv.shape == (B, S, tcfg.mla.kv_lora_rank)
    assert tkr.shape == (B, S, tcfg.mla.qk_rope_dim)
    for g, w in ((to, jo), (tckv, jckv), (tkr, jkr)):
        _close(g, w)


@pytest.mark.parametrize("widths", [None, WIDE], ids=["smoke", "wide"])
def test_mla_decode_matches_jax_at_every_position(widths):
    """The absorbed-matrix decode, one position at a time over a cache of
    T = 12: every step's output, and the cache (written in place) after
    the last step."""
    tcfg, jcfg = _cfgs(widths)
    rng = np.random.default_rng(2)
    B, T = 2, 12
    x = rng.standard_normal((B, T, tcfg.d_model)).astype(np.float32)
    jp, tp = _weights(jcfg, 1)
    jc = jattn.init_mla_cache(jcfg, B, T, jnp.float32)
    tc = tattn.init_mla_cache(tcfg, B, T, torch.float32)
    step = jax.jit(jattn.mla_decode, static_argnums=2)
    for t in range(T):
        jo, jc = step(jnp.asarray(x[:, t:t + 1]), jp, jcfg, jc,
                      jnp.asarray(t, jnp.int32))
        to, tc2 = tattn.mla_decode(torch.from_numpy(x[:, t:t + 1]), tp, tcfg,
                                   tc, t)
        assert tc2 is tc and to.shape == (B, 1, tcfg.d_model)
        _close(to, jo)
    for n in ("ckv", "krope"):
        _close(tc[n], jc[n])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_mla_cache_matches_jax(dtype):
    tcfg, jcfg = _cfgs(WIDE)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jc = jattn.init_mla_cache(jcfg, 3, 40, jdt)
    tc = tattn.init_mla_cache(tcfg, 3, 40, dtype, device="cpu")
    assert {n: (str(t.dtype)[6:], tuple(t.shape)) for n, t in tc.items()} \
        == {n: (str(a.dtype), a.shape) for n, a in jc.items()}
    assert all(not t.any() for t in tc.values())


@pytest.mark.parametrize("widths", [None, WIDE], ids=["smoke", "wide"])
def test_absorbed_decode_is_the_decompressed_attention(widths):
    """The port's own parity, as JAX's smoke test holds it for the model:
    decode at position t (wk_b folded into q, wv_b after the softmax, over
    the latent cache) gives the full-sequence pass's output at t (k and v
    decompressed per head), and the cache it fills is that pass's latent."""
    tcfg, _ = _cfgs(widths)
    gen = torch.Generator().manual_seed(3)
    p = {k: v.detach() for k, v in
         tattn.mla_init(tcfg, torch.float32, generator=gen).items()}
    # RMSNorm weights are stored as scale - 1: make them matter
    p["qn"] = 0.3 * torch.randn(p["qn"].shape, generator=gen)
    p["kvn"] = 0.3 * torch.randn(p["kvn"].shape, generator=gen)
    B, S = 2, 20
    x = torch.randn(B, S, tcfg.d_model, generator=gen)
    full, (ckv, kr) = tattn.mla_apply(
        x, p, tcfg, torch.arange(S).expand(B, S))
    cache = tattn.init_mla_cache(tcfg, B, S, torch.float32)
    for t in range(S):
        o, _ = tattn.mla_decode(x[:, t:t + 1], p, tcfg, cache, t)
        _close(o[:, 0], full[:, t])
    _close(cache["ckv"], ckv)
    _close(cache["krope"], kr)


def test_mla_leaves_round_trip_through_convert():
    """deepseek-v3-671b's smoke model with its pattern repeated twice (3
    `mla_dense` layers, then 2 `mla_moe`): every leaf of the JAX tree
    (the MLA projections and norms, the dense MLP, the router, the experts
    and the shared expert) lands in the port's state dict and comes back
    equal, with JAX's tree paths (the pattern stacked) through
    `jax_paths` and `unstack_paths`."""
    tcfg, jcfg = _cfgs(n_layers=5, repeats=2)
    jp = jax.tree.map(np.asarray,
                      JLMModel(jcfg).init_params(jax.random.key(4)))
    sd = params_from_jax(jp, tcfg)
    model = LMModel(tcfg, device="cpu")
    model.params.load_state_dict(sd)
    mix = {k.split(".")[-1] for k in sd if k.startswith("blocks.0.mix.")}
    assert mix == {"wq_a", "qn", "wq_b", "wkv_a", "kvn", "wk_b", "wv_b",
                   "wo"}
    assert {k[len("blocks.4.ffn."):] for k in sd
            if k.startswith("blocks.4.ffn.")} == {
        "router", "wg", "wu", "wd", "shared.wg", "shared.wu", "shared.wd"}
    back = params_to_jax(model.params.state_dict(), tcfg)
    want = {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(p): leaf for p, leaf in
           jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    paths = jax_paths(dict(model.params.state_dict()), tcfg)
    assert tuple(paths["pattern.0.ffn.shared.wg"].shape) == \
        jp["pattern"][0]["ffn"]["shared"]["wg"].shape
    assert tuple(paths["prefix.2.mix.wk_b"].shape) == \
        jp["prefix"][2]["mix"]["wk_b"].shape
    for k, t in unstack_paths(paths, tcfg).items():
        assert torch.equal(t, sd[k]), k


def test_mla_gradients_match_jax():
    """On the CPU autograd differentiates `chunked_attention` inside
    `mla_apply`, as JAX does: the gradients of every MLA weight and of the
    input, within 1e-5 of each one's max |value|."""
    tcfg, jcfg = _cfgs(WIDE)
    rng = np.random.default_rng(5)
    B, S = 2, 40
    x = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((B, S, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jp, tp = _weights(jcfg, 2)

    def jloss(p, x):
        return jnp.sum(jattn.mla_apply(x, p, jcfg, jnp.asarray(pos))[0] * r)

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_() for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tattn.mla_apply(tx, tp, tcfg, torch.from_numpy(pos).long())
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                [tx] + list(tp.values()))
    for name, g, w in zip(["x"] + list(tp), grads, [jgx] + [jg[k]
                                                         for k in tp]):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, err_msg=name,
                                   atol=TOL * np.abs(w).max())


def test_adafactor_train_step_at_full_head_widths_matches_jax():
    """One train_step of deepseek-v3-671b's smoke config at the full
    config's head widths (WIDE: q/k 192 over v 128) in the layout
    chip_smoke.py trains on the card, its 3 mla_dense layers alone (the
    pattern repeated 0 times: JAX keeps its stacked leaves with a layer
    axis of 0, which the port does not hold; the pattern's kind and `moe`
    set to what no layer reads, a dense kind and none, since JAX traces
    the pattern's initialiser even at 0 repeats and `_check_step` holds a
    MoE config to a nonzero aux loss), with its own optimizer
    (Adafactor) and bf16 gradient sums, against
    `repro.models.LMModel.train_step` at tests/test_torch_train.py's bars
    (`_check_step`: loss and every gradient leaf within 1e-5; the weights
    and factors within 1e-5 of each leaf's max against JAX's update of the
    port's gradients rounded to bf16, as both packages' accumulators round
    them). The MoE layers' step at the smoke widths is
    tests/test_torch_train.py's."""
    from test_torch_train import _check_step, _flat, _leaves_close
    import repro.optim as jopt

    tcfg, jcfg = _cfgs(WIDE, n_layers=3, repeats=0, moe=None,
                       pattern=("mla_dense",))
    assert (tcfg.optimizer, tcfg.grad_accum_dtype) == ("adafactor",
                                                       "bfloat16")
    jm = JLMModel(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.key(6))
    model = LMModel(tcfg, device="cpu")
    model.params.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    assert model.params.kinds == ("mla_dense",) * 3
    _, _, gn, topt, tg = _check_step(model, jm, jp, tcfg, B=2)
    assert gn == 0.0 and type(topt).__name__ == "AdafactorState"
    g_tree = jax_tree({k: v.to(torch.bfloat16).float().numpy()
                       for k, v in tg.items()}, tcfg, np.stack)
    g_tree["pattern"] = jax.tree.map(np.zeros_like, jp["pattern"])
    jnew, jstate, _ = jax.jit(jopt.adafactor_update)(
        jax.tree.map(jnp.asarray, g_tree), jm.init_opt(jp), jp)
    _leaves_close(dict(model.params.state_dict()), _flat(jnew, tcfg), TOL)
    want = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    assert topt.vr["prefix.0.mix.wq_b"].shape == (32, tcfg.n_heads)
    # JAX's factors of its empty pattern leaves: a row factor of 0 entries
    held = {k for k, v in want.vr.items() if v.numel()}
    for got, w in ((topt.vr, want.vr), (topt.vc, want.vc)):
        _leaves_close(got, {k: w[k].numpy() for k in held}, TOL)
