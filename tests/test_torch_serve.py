"""repro_torch's LM serving path (LMModel, forward_full, decode_step, the
serve loop) against the JAX package, on the CPU, at the smoke configs of
qwen2-1.5b, smollm-360m, qwen3-4b, gemma2-9b (local and global layers,
soft-caps, sandwich norms), recurrentgemma-2b (RG-LRU and local
attention, a suffix after the pattern), rwkv6-1.6b (RWKV-6), qwen2-vl-2b
(M-RoPE; embedding inputs), musicgen-large (embedding inputs, sinusoidal
positions, layernorm, GELU), dbrx-132b (MoE) and deepseek-v3-671b (MLA:
three `mla_dense` layers, then `mla_moe` with its sigmoid router and
shared expert; the prefill decompresses k and v, decode is the
absorbed-matrix form over the latent cache), with the bf16 and the int8
KV cache, MLA's latent cache and the recurrent layers' f32 states.

The JAX package's weights (`repro.models.LMModel(cfg).init_params(
jax.random.key(k))`) are carried into the port by `params_from_jax`, and
the same `batch_for` inputs go through both, in f32 (for M-RoPE the
full-sequence forward takes distinct position streams, `grid_positions`;
`batch_for`'s three equal streams are what a decode step gives, so the
prefill-against-decode checks keep them). Bars: logits and
caches within 1e-5 (the prefill's attention is `chunked_attention` on the
CPU; the CUDA kernel is held against its plain version on the card by
`chip_smoke.py`); greedy tokens exactly equal. Also the guards: every
family reaches the kernels' device check (on `meta`, before any launch),
MLA's training too, and nothing is put on the CPU unless asked.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.launch.serve import serve as j_serve  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core.frontier import fstats_init  # noqa: E402
from repro_torch.data import batch_for  # noqa: E402
from repro_torch.kernels import flash_attn as tflash  # noqa: E402
from repro_torch.launch.serve import generate, serve  # noqa: E402
from repro_torch.models import LMModel  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttfm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.obs import trace_init  # noqa: E402
from test_torch_attention import grid_positions  # noqa: E402

TOL = 1e-5
ARCHS = ("qwen2-1.5b", "smollm-360m", "qwen3-4b", "gemma2-9b",
         "recurrentgemma-2b", "rwkv6-1.6b", "qwen2-vl-2b", "musicgen-large",
         "dbrx-132b", "deepseek-v3-671b")
CPU = dict(device="cpu")


def _key(cfg):
    """The batch key of the model's inputs."""
    return "embeddings" if cfg.embed_inputs else "tokens"


def _inputs(batch, cfg, to):
    """The model's inputs out of a `batch_for` batch (tokens or
    embeddings, and M-RoPE's positions), each leaf through `to`."""
    keys = [_key(cfg)] + (["positions"] if "positions" in batch else [])
    return {k: to(batch[k]) for k in keys}


def _piece(batch, cfg, t):
    """Position t's decode input (numpy)."""
    return {_key(cfg): batch[_key(cfg)][:, t:t + 1]}


# repeats of the pattern in the tests' models: two, but one for
# recurrentgemma, whose pattern (rec, rec, attn_local) and suffix (rec,
# rec) give every kind and both layer groups in five layers
LAYERS = {"recurrentgemma-2b": 1}


def _cfgs(name, layers=None, **changes):
    """(port config, JAX config): the architecture's smoke config with its
    pattern repeated `layers` times (LAYERS, else 2) between its prefix
    and suffix (and `changes` to its fields)."""
    layers = LAYERS.get(name, 2) if layers is None else layers
    out = []
    for c in (tconfigs, jconfigs):
        smoke = c.smoke_config(c.get_config(name))
        out.append(dataclasses.replace(
            smoke, n_layers=len(smoke.prefix) + layers * len(smoke.pattern)
            + len(smoke.suffix), repeats=layers, **changes))
    return tuple(out)


def _port_cfg(jcfg):
    """A port ArchConfig with every field of a JAX one (for the families
    the port does not register)."""
    kw = {}
    for f in dataclasses.fields(jcfg):
        v = getattr(jcfg, f.name)
        if dataclasses.is_dataclass(v):
            v = getattr(tconfigs, type(v).__name__)(**dataclasses.asdict(v))
        kw[f.name] = v
    return tconfigs.ArchConfig(**kw)


def _carry(name, key, layers=None, **changes):
    """(port model on the CPU, JAX model, JAX params, port config, JAX
    config), the port's weights carried from the JAX ones."""
    tcfg, jcfg = _cfgs(name, layers, **changes)
    jm = JLMModel(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.key(key))
    model = LMModel(tcfg, **CPU)
    model.params.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    return model, jm, jp, tcfg, jcfg


def _jlayer(jcache, layer, cfg):
    """Layer `layer`'s cache out of JAX's caches (prefix and suffix
    lists, the pattern's stacked over its repeats): a dict of arrays, or
    forward_full's (k, v)."""
    pre, pat, reps, _ = cfg.layer_kinds()
    i = layer - len(pre)
    if i < 0:
        return jcache["prefix"][layer]
    if i >= reps * len(pat):
        return jcache["suffix"][i - reps * len(pat)]
    c = jcache["pattern"][i % len(pat)]
    if isinstance(c, dict):
        return {n: a[i // len(pat)] for n, a in c.items()}
    return tuple(a[i // len(pat)] for a in c)


# the recurrent layers' f32 states: RWKV's wkv state sums its tokens
# almost undamped (decays 1 - 2.5e-3 at init) and reaches |s| ~ 40 at the
# smoke widths, where an f32 ulp is 4e-6 and the two packages' states
# differ by a few ulps (2.8e-5 after 64 tokens). So a state is held
# within TOL of its max |value| (the train tests' form), every other
# tensor within TOL elementwise.
STATES = {"h", "conv", "s", "x_tm", "x_cm"}


def _cache_close(got, want):
    """One layer's cache: a full sequence's (k, v) or MLA's (ckv, k_rope),
    or a decode cache's dict of k/v, MLA's ckv/krope or recurrent state
    (a tuple is named after the dict it is held against)."""
    names = next((list(c) for c in (want, got) if isinstance(c, dict)),
                 ["k", "v"])
    if isinstance(want, tuple):
        want = dict(zip(names, want))
    if isinstance(got, tuple):
        got = dict(zip(names, got))
    assert set(got) == set(want)
    for n in want:
        if n in STATES:
            w = np.asarray(want[n])
            np.testing.assert_allclose(
                np.asarray(got[n].detach()), w, rtol=0, err_msg=n,
                atol=TOL * max(1.0, float(np.abs(w).max())))
        else:
            _close(got[n], want[n])


def _close(got, want, tol=TOL):
    # the weights are trainable: forward_full outside the serving steps'
    # no_grad returns tensors that autograd records
    got, want = (x.detach() if isinstance(x, torch.Tensor) else x
                 for x in (got, want))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


# -- weights -------------------------------------------------------------------

def test_params_from_jax_carries_every_leaf():
    model, _, jp, tcfg, _ = _carry("qwen2-1.5b", 0, layers=3)
    sd = model.params.state_dict()
    # embed, unembed, lnf.w; per block ln1, 4 weights + 3 biases, ln2, 3 MLP
    assert len(sd) == 3 + tcfg.n_layers * 12
    np.testing.assert_array_equal(sd["embed"].numpy(), np.asarray(jp["embed"]))
    np.testing.assert_array_equal(sd["lnf.w"].numpy(),
                                  np.asarray(jp["lnf"]["w"]))
    for layer in range(tcfg.n_layers):
        for grp, leaf in (("mix", "wq"), ("mix", "bk"), ("ffn", "wd"),
                          ("ln2", "w")):
            np.testing.assert_array_equal(
                sd[f"blocks.{layer}.{grp}.{leaf}"].numpy(),
                np.asarray(jp["pattern"][0][grp][leaf][layer]))


def test_params_from_jax_raises_on_a_missing_or_extra_leaf():
    tcfg, jcfg = _cfgs("qwen3-4b")
    tree = jax.tree.map(np.asarray,
                        JLMModel(jcfg).init_params(jax.random.key(0)))
    del tree["pattern"][0]["mix"]["qn"]
    with pytest.raises(ValueError, match="missing.*qn"):
        params_from_jax(tree, tcfg)
    tree = jax.tree.map(np.asarray,
                        JLMModel(jcfg).init_params(jax.random.key(0)))
    tree["lnf"]["b"] = np.zeros(tcfg.d_model, np.float32)
    with pytest.raises(ValueError, match="extra.*lnf.b"):
        params_from_jax(tree, tcfg)
    tree = jax.tree.map(np.asarray,
                        JLMModel(jcfg).init_params(jax.random.key(0)))
    tree["unembed"] = tree["unembed"][:, :-1]
    with pytest.raises(ValueError, match="unembed has shape"):
        params_from_jax(tree, tcfg)


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("name", ARCHS)
def test_forward_full_matches_jax(name):
    """Logits, the MoE aux loss and every layer's cache, (k, v) or
    recurrent state; S = 64 spans two attention chunks and eight RWKV
    chunks of the smoke config. M-RoPE on grid positions (8 text tokens,
    a 6 x 8 image, 8 text tokens)."""
    model, _, jp, tcfg, jcfg = _carry(name, 1)
    batch = batch_for(tcfg, 2, 64, 0, seed=5)
    if "positions" in batch:
        batch["positions"] = grid_positions(2, 8, (6, 8), 8)
    jl, jc, jaux = jax.jit(jtfm.forward_full, static_argnums=1,
                           static_argnames="want_cache")(
        jp, jcfg, _inputs(batch, tcfg, jnp.asarray), want_cache=True)
    tl, tc, aux = ttfm.forward_full(
        model.params, tcfg, _inputs(batch, tcfg, torch.from_numpy),
        want_cache=True)
    assert tl.shape == (2, 64, tcfg.vocab) and tl.dtype == torch.float32
    assert aux.dtype == torch.float32
    assert (float(aux.detach()) > 0) == (tcfg.moe is not None)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), rtol=TOL)
    _close(tl, jl)
    assert len(tc) == tcfg.n_layers
    for layer, c in enumerate(tc):
        _cache_close(c, _jlayer(jc, layer, jcfg))


@pytest.mark.parametrize("name", ARCHS)
def test_decode_step_matches_jax_at_every_position(name):
    model, jm, jp, tcfg, jcfg = _carry(name, 2)
    B, S = 2, 16
    batch = batch_for(tcfg, B, S, 0, seed=6)
    jcache = jtfm.init_cache(jcfg, B, S)
    tcache = model.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    for t in range(S):
        piece = _piece(batch, tcfg, t)
        jl, jcache = step(jp, jcache,
                          {k: jnp.asarray(v) for k, v in piece.items()},
                          jnp.asarray(t, jnp.int32))
        tl, tcache2 = model.decode_step(tcache, piece, t)
        assert tcache2 is tcache                # written in place
        assert tl.shape == (B, 1, tcfg.vocab)
        _close(tl, jl)
    for layer, c in enumerate(tcache):
        _cache_close(c, _jlayer(jcache, layer, jcfg))


@pytest.mark.parametrize("name", ["qwen2-1.5b", "gemma2-9b"])
def test_int8_decode_step_matches_jax(name):
    """kv_cache_dtype="int8" (the JAX dry run's decode option): logits
    within 1e-5 of JAX's at every position, every layer's codes within one
    step and scales within 1e-5 (the bar the bf16 caches' k and v are held
    to: two layers of products summed in other orders). 24 positions, so
    gemma2's local caches (window 16) roll."""
    model, jm, jp, tcfg, jcfg = _carry(name, 8, kv_cache_dtype="int8")
    B, S = 2, 24
    toks = batch_for(tcfg, B, S, 0, seed=8)["tokens"]
    jcache = jtfm.init_cache(jcfg, B, S)
    tcache = model.init_cache(B, S)
    step = jax.jit(jm.decode_step)
    for t in range(S):
        jl, jcache = step(jp, jcache, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                          jnp.asarray(t, jnp.int32))
        tl, tcache = model.decode_step(tcache, {"tokens": toks[:, t:t + 1]},
                                       t)
        _close(tl, jl)
    for layer, c in enumerate(tcache):
        jc = _jlayer(jcache, layer, jcfg)
        assert c["k"].dtype == torch.int8 and c["k_scale"].dtype == \
            torch.float32
        for n in ("k", "v"):
            d = c[n].numpy().astype(np.int32) - np.asarray(jc[n], np.int32)
            assert np.abs(d).max() <= 1
            np.testing.assert_allclose(c[n + "_scale"].numpy(),
                                       np.asarray(jc[n + "_scale"]),
                                       rtol=TOL, atol=0)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_step_matches_stepped_decode(name):
    """The port's own parity (tests/test_models_smoke.py's, at 1e-5): the
    fused prefill's last logits and caches against the stepped decode;
    and they are forward_full's last position. M-RoPE on `batch_for`'s
    equal streams, which is what a decode step gives; dbrx's MoE at the
    smoke config's capacity factor of 8, which drops no token."""
    tcfg, _ = _cfgs(name)
    model = LMModel(tcfg, seed=3, **CPU)
    B, S = 2, 16
    batch = batch_for(tcfg, B, S, 0, seed=7)
    last, caches = model.prefill_step(batch)
    full, _, _ = ttfm.forward_full(model.params, tcfg,
                                   _inputs(batch, tcfg, torch.from_numpy))
    assert last.shape == (B, tcfg.vocab)
    _close(last, full[:, -1])
    cache = model.init_cache(B, S)
    for t in range(S):
        logits, cache = model.decode_step(cache, _piece(batch, tcfg, t), t)
    _close(logits[:, 0], last)
    for got, c in zip(caches, cache):
        _cache_close(got, {n: t.numpy() for n, t in c.items()})


def test_models_with_one_seed_are_equal_and_other_seeds_differ():
    tcfg, _ = _cfgs("smollm-360m")
    a, b, c = (LMModel(tcfg, seed=s, **CPU) for s in (4, 4, 5))
    for (k, x), y, z in zip(a.state_dict().items(), b.state_dict().values(),
                            c.state_dict().values()):
        assert torch.equal(x, y), k
    assert not torch.equal(a.params.embed, c.params.embed)
    # trainable weights; the serving steps record no graph
    assert all(p.requires_grad for p in a.parameters())
    last, caches = a.prefill_step(batch_for(tcfg, 1, 4, 0))
    assert not last.requires_grad and not caches[0][0].requires_grad


# -- serving -------------------------------------------------------------------

@pytest.mark.parametrize("name,seed", [("smollm-360m", 0), ("qwen3-4b", 3),
                                       ("qwen2-1.5b", 1), ("gemma2-9b", 2),
                                       ("recurrentgemma-2b", 9),
                                       ("rwkv6-1.6b", 10),
                                       ("qwen2-vl-2b", 11),
                                       ("musicgen-large", 12),
                                       ("dbrx-132b", 13),
                                       ("deepseek-v3-671b", 14)])
def test_serve_tokens_equal_jax(name, seed):
    """repro.launch.serve draws its weights from jax.random.key(seed); the
    port's loop, given those weights and the same prompts (embeddings for
    qwen2-vl-2b and musicgen-large, whose generated tokens go back in as
    their `embed` rows), produces the same greedy tokens."""
    B, P, G = 2, 8, 6
    want, _ = j_serve(_cfgs(name)[1], batch=B, prompt_len=P, gen=G,
                      seed=seed)
    model, *_ = _carry(name, seed)
    prompts = batch_for(model.cfg, B, P, 0, seed)[_key(model.cfg)]
    got, tps = generate(model, prompts, G)
    assert got.shape == (B, G) and tps > 0
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name,seed", [("qwen2-1.5b", 6), ("gemma2-9b", 7)])
def test_serve_tokens_equal_jax_with_the_int8_cache(name, seed):
    """The same with kv_cache_dtype="int8" in both packages: equal greedy
    tokens over a prompt and generation (20 positions) longer than
    gemma2's smoke window of 16, so its local caches roll."""
    B, P, G = 2, 12, 8
    want, _ = j_serve(_cfgs(name, kv_cache_dtype="int8")[1], batch=B,
                      prompt_len=P, gen=G, seed=seed)
    model, *_ = _carry(name, seed, kv_cache_dtype="int8")
    prompts = batch_for(model.cfg, B, P, 0, seed)["tokens"]
    got, _ = generate(model, prompts, G)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("name", ARCHS)
def test_serve_logits_equal_jax_under_teacher_forcing(name):
    """Every step of the serve loop (stepped prefill, then decode) on one
    token sequence: logits within 1e-5, so a near-tie in the argmax cannot
    hide a difference."""
    model, jm, jp, tcfg, jcfg = _carry(name, 4)
    B, P, G = 2, 8, 6
    key = _key(tcfg)
    prompts = batch_for(tcfg, B, P, 0, 4)[key]
    toks, _ = generate(model, prompts, G)
    if tcfg.embed_inputs:       # the generated tokens go in as embed rows
        seq = np.concatenate([prompts, np.asarray(jp["embed"])[toks]],
                             axis=1)
    else:
        seq = np.concatenate([prompts, toks], axis=1)
    jcache = jtfm.init_cache(jcfg, B, P + G)
    tcache = model.init_cache(B, P + G)
    step = jax.jit(jm.decode_step)
    for t in range(P + G):
        jl, jcache = step(jp, jcache, {key: jnp.asarray(seq[:, t:t + 1])},
                          jnp.asarray(t, jnp.int32))
        tl, tcache = model.decode_step(tcache, {key: seq[:, t:t + 1]}, t)
        _close(tl, jl)
        if t >= P - 1 and t < P + G - 1:       # the loop's greedy choice
            np.testing.assert_array_equal(
                np.asarray(tl[:, -1].argmax(-1)), toks[:, t + 1 - P])


def test_serve_is_deterministic_and_in_vocab():
    tcfg, _ = _cfgs("qwen3-4b")
    a, tps = serve(tcfg, batch=2, prompt_len=8, gen=4, seed=3, **CPU)
    b, _ = serve(tcfg, batch=2, prompt_len=8, gen=4, seed=3, **CPU)
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 4) and a.min() >= 0 and a.max() < tcfg.vocab
    assert tps > 0


# -- guards --------------------------------------------------------------------

def _leaves(tree, prefix=""):
    """A nested dict of arrays -> {"a.b": array} (state-dict keys)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _mla_on_meta(cfg, grad: bool):
    """An MLA layer's full-sequence pass on `meta` (no kernel there), its
    weights wanting a gradient or not."""
    p = {k: v.to("meta").requires_grad_(grad) for k, v in
         ttfm.init_block(cfg, "mla_dense", generator=torch.Generator(),
                         device="meta")["mix"].items()}
    x = torch.empty(1, 8, cfg.d_model, device="meta")
    pos = torch.zeros(1, 8, dtype=torch.int64, device="meta")
    return tattn.mla_apply(x, p, cfg, pos)


@pytest.mark.parametrize("name,what", [("deepseek-v3-671b", "MLA")])
def test_unported_families_raise(name, what):
    """Every family is served and trained now: MLA's training too, whose
    backward kernel takes q/k width 192 over v width 128. deepseek-v3-
    671b's model and caches build (the full config's 61 layers on
    `meta`); on `meta` an MLA layer reaches the kernel's device check
    (no kernel there) before any launch, with a gradient and without, at
    the full config's widths and at the smoke config's: nothing refuses
    the family itself any more."""
    cfg = _port_cfg(jconfigs.smoke_config(jconfigs.get_config(name)))
    full = tconfigs.get_config(name)
    assert (full.mla is not None) == (what == "MLA")
    LMModel(cfg, **CPU)
    assert len(ttfm.init_cache(cfg, 1, 4, **CPU)) == cfg.n_layers
    params = ttfm.init_params(full, generator=torch.Generator(),
                              device="meta")
    assert len(params.blocks) == 61 and params.kinds[:4] == (
        "mla_dense",) * 3 + ("mla_moe",)
    assert params.blocks[3]["ffn"]["wg"].shape == (256, 7168, 2048)
    before = (tflash.flash_attention.launches,
              tflash.flash_attention_bwd.launches)
    for c in (full, cfg):
        for grad in (True, False):
            with pytest.raises(ValueError, match="no kernel for device meta"):
                _mla_on_meta(c, grad)
    assert (tflash.flash_attention.launches,
            tflash.flash_attention_bwd.launches) == before


def test_unported_options_raise():
    """The int8 KV cache is ported: its model builds and its caches have
    JAX's layout (codes int8, scales f32 [B, T, K, 1]; local layers
    clamped to the window). MLA and its layer kinds are ported too: MLA's
    latent cache has JAX's layout ({"ckv" [B, T, r], "krope" [B, T,
    rope]}), and `init_block` gives each MLA kind JAX's leaves; and
    `flash_attention_bwd` takes q/k width 192 over v width 128: on `meta`
    it reaches the kernel's device check before any launch."""
    tcfg, jcfg = _cfgs("gemma2-9b", kv_cache_dtype="int8")
    LMModel(tcfg, **CPU)
    _layouts_equal(tcfg, jcfg, 2, 40)
    assert ttfm.init_cache(tcfg, 2, 40, **CPU)[0]["k"].shape[1] == tcfg.window
    mcfg, mjcfg = _cfgs("deepseek-v3-671b")
    assert {n for c in _layouts_equal(mcfg, mjcfg, 2, 40) for n in c} == \
        {"ckv", "krope"}
    jp = jax.tree.map(np.asarray,
                      JLMModel(mjcfg).init_params(jax.random.key(0)))
    for kind, jblock in (("mla_dense", jp["prefix"][0]),
                         ("mla_moe", jax.tree.map(lambda a: a[0],
                                                  jp["pattern"][0]))):
        block = ttfm.init_block(mcfg, kind, generator=torch.Generator())
        assert {k: tuple(v.shape) for k, v in block.state_dict().items()} \
            == {k: v.shape for k, v in _leaves(jblock).items()}
    m = torch.empty(1, 8, 2, 192, device="meta")
    mv = torch.empty(1, 8, 2, 128, device="meta")
    lse = torch.empty(1, 2, 8, device="meta")
    before = tflash.flash_attention_bwd.launches
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tflash.flash_attention_bwd(m, m, mv, mv, lse, mv)
    assert tflash.flash_attention_bwd.launches == before


def _layouts_equal(tcfg, jcfg, B, T):
    """init_cache of both packages: every layer's names, dtypes and
    shapes equal."""
    tcache = ttfm.init_cache(tcfg, B, T, **CPU)
    jcache = jtfm.init_cache(jcfg, B, T)
    assert len(tcache) == tcfg.n_layers
    for layer, c in enumerate(tcache):
        jc = _jlayer(jcache, layer, jcfg)
        assert {n: (str(t.dtype)[6:], tuple(t.shape)) for n, t in c.items()} \
            == {n: (str(a.dtype), a.shape) for n, a in jc.items()}
    return tcache


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "rwkv6-1.6b"])
def test_recurrent_cache_layouts_match_jax(name):
    """The recurrent layers' f32 states ({"h", "conv"}, {"s", "x_tm",
    "x_cm"}) and recurrentgemma's windowed k/v in bf16 have JAX's names,
    dtypes and shapes; their size does not grow with the context."""
    tcfg, jcfg = _cfgs(name, dtype="bfloat16")
    small = _layouts_equal(tcfg, jcfg, 2, 40)
    assert {n for c in small for n in c} == (
        {"h", "conv", "k", "v"} if name == "recurrentgemma-2b"
        else {"s", "x_tm", "x_cm"})

    def nbytes(cache):
        return sum(t.numel() * t.element_size() for c in cache
                   for t in c.values())

    assert nbytes(ttfm.init_cache(tcfg, 1, 4096, **CPU)) == nbytes(
        ttfm.init_cache(tcfg, 1, tcfg.window or 16, **CPU))


def test_local_and_softcap_kinds_run_on_cpu_and_their_backward_raises_off_it():
    """gemma2's kinds (local window, soft-caps, post-norms) run on the CPU
    through chunked_attention and match the JAX model there. Off the CPU
    the kernel and its backward take the window, the soft-cap and head
    width 256: with a gradient or without, each call reaches the kernel
    (here, on `meta`, its device check, which raises before any launch);
    nothing raises NotImplementedError any more."""
    jcfg = jconfigs.smoke_config(jconfigs.get_config("gemma2-9b"))
    tcfg = _port_cfg(jcfg)
    jp = JLMModel(jcfg).init_params(jax.random.key(0))
    model = LMModel(tcfg, **CPU)
    model.params.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    toks = batch_for(tcfg, 2, 32, 0, seed=1)["tokens"]
    jl, _, _ = jtfm.forward_full(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl, _, _ = ttfm.forward_full(model.params, tcfg,
                                 {"tokens": torch.from_numpy(toks)})
    _close(tl, jl)
    x = torch.empty(1, 8, tcfg.d_model, device="meta")
    pos = torch.zeros(1, 8, dtype=torch.int64, device="meta")
    p = {k: v.to("meta") for k, v in model.params.blocks[0]["mix"].items()}
    assert p["wq"].requires_grad
    plain = dataclasses.replace(tcfg, attn_softcap=None, window=None)
    wide = dataclasses.replace(plain, head_dim=256)
    d, H, K = tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads
    pw = {n: torch.empty(shape, device="meta", requires_grad=True)
          for n, shape in (("wq", (d, H, 256)), ("wk", (d, K, 256)),
                           ("wv", (d, K, 256)), ("wo", (H, 256, d)))}
    cases = (("attn_local", tcfg, p), ("attn_global", tcfg, p),
             ("attn_local", dataclasses.replace(tcfg, attn_softcap=None), p),
             ("attn_global", wide, pw))
    before = tflash.flash_attention.launches
    for kind, cfg, w in cases:
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tattn.attn_apply(x, w, cfg, kind, pos)
        with torch.no_grad(), pytest.raises(
                ValueError, match="no kernel for device meta"):
            tattn.attn_apply(x, w, cfg, kind, pos)
    assert tflash.flash_attention.launches == before
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tattn.attn_apply(x, p, plain, "attn_global", pos)


def test_nothing_lands_on_the_cpu_unless_asked():
    """LMModel, serve, trace_init and fstats_init put their tensors on CUDA
    unless given a device; with no card they raise, as resolve_device."""
    tcfg, _ = _cfgs("smollm-360m")
    calls = (lambda: LMModel(tcfg).params.embed,
             lambda: serve(tcfg, batch=1, prompt_len=2, gen=1),
             lambda: trace_init(4, torch.float64, "static").linf,
             lambda: fstats_init(3))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            assert isinstance(out, tuple) or out.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert trace_init(4, torch.float64, "static", device="cpu").linf.device \
        == torch.device("cpu")
    assert fstats_init(3, device="cpu").device == torch.device("cpu")
