"""repro_torch.models.ssm (RWKV-6 and RG-LRU) against repro.models.ssm, on
the CPU, at the smoke configs' widths in f32.

The same numpy-seeded inputs and the JAX package's own weights
(`rwkv_init` / `rglru_init` from `jax.random.key`, carried over as
tensors) go through both packages; every output and state within 1e-5
(both compute in f32; only the order of sums differs: the port composes
RG-LRU's monoid in doubling steps where JAX runs `associative_scan`).
Chunk-size invariance of the port's own time mix is held at the JAX
test's bars (tests/test_recurrence.py: another chunking reassociates the
decays' sums). Also: the nested leaves (RWKV's `mu` and `lora_b`) through
`models.convert` and Adafactor's paths, the f32 leaves of a bf16 model,
and a finite gradient through the masked decay ratios where an unmasked
exponent overflows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import LMModel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    jax_paths, params_from_jax, params_to_jax, unstack_paths)
from repro_torch.optim import adafactor_init  # noqa: E402

TOL = 1e-5
RWKV, REC = "rwkv6-1.6b", "recurrentgemma-2b"


def _cfgs(name, **rec):
    """(port, JAX) smoke configs of `name`, `rec` replacing RecCfg
    fields."""
    out = []
    for c in (tconfigs, jconfigs):
        cfg = c.smoke_config(c.get_config(name))
        if rec:
            cfg = dataclasses.replace(cfg, rec=dataclasses.replace(cfg.rec,
                                                                   **rec))
        out.append(cfg)
    return tuple(out)


def _t(tree):
    """A JAX dict of leaves (nested) as tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
        return
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _both(a):
    return torch.from_numpy(a), jnp.asarray(a)


def _weights(name, key, init, **rec):
    tcfg, jcfg = _cfgs(name, **rec)
    jp = init(jax.random.key(key), jcfg, jnp.float32)
    return tcfg, jcfg, jp, _t(jp)


def _tree(jcfg, seed):
    """A tree of the JAX model's structure, shapes and dtypes
    (`jax.eval_shape` of its init) with numpy-seeded values: the leaves
    differ from one another, so a misplaced one shows."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(JLMModel(jcfg).init_params, jax.random.key(0))
    return jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        a.dtype), shapes)


# the JAX functions, compiled once a shape (the configs are static)
_j_wkv = jax.jit(jssm._wkv_chunk)
_j_time_mix = jax.jit(jssm.rwkv_time_mix, static_argnums=2)
_j_channel_mix = jax.jit(jssm.rwkv_channel_mix)
_j_rwkv_decode = jax.jit(jssm.rwkv_decode, static_argnums=2)
_j_conv = jax.jit(jssm._causal_conv)
_j_rglru = jax.jit(jssm.rglru_apply, static_argnums=2)
_j_rglru_decode = jax.jit(jssm.rglru_decode, static_argnums=2)


# -- RWKV-6 --------------------------------------------------------------------

def _t_wkv_chunk(r, k, v, wlog, u, s0):
    """JAX's `_wkv_chunk` in the port: `_wkv_chunks` of one chunk."""
    o, s1 = tssm._wkv_chunks(r[:, None], k[:, None], v[:, None],
                             wlog[:, None], u, s0)
    return o[:, 0], s1


@pytest.mark.parametrize("C,H,dk", [(4, 2, 4), (8, 3, 8), (16, 1, 16)])
def test_wkv_chunk_matches_jax(C, H, dk):
    rng = np.random.default_rng(C + H)
    B = 2
    r, k, v = (_normal(rng, B, C, H, dk) for _ in range(3))
    wlog = -2.0 * rng.random((B, C, H, dk)).astype(np.float32)
    u = _normal(rng, H, dk)
    s0 = _normal(rng, B, H, dk, dk, scale=0.1)
    args = [_both(a) for a in (r, k, v, wlog, u, s0)]
    jo, js = _j_wkv(*(a[1] for a in args))
    to, ts = _t_wkv_chunk(*(a[0] for a in args))
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("chunk", [8, 4, 2])
def test_rwkv_time_mix_matches_jax(chunk, carry):
    """A 48-token sequence in chunks of 8, 4 or 2 (24 chunks: the port
    computes 16 side by side, then the other 8), from a zero state or
    from a carried token and wkv state."""
    tcfg, jcfg, jp, tp = _weights(RWKV, 0, jssm.rwkv_init, chunk=chunk)
    rng = np.random.default_rng(chunk + carry)
    B, S, d = 2, 48, tcfg.d_model
    H = d // tcfg.rec.head_dim
    x = _both(_normal(rng, B, S, d))
    kw_t, kw_j = {}, {}
    if carry:
        xp = _both(_normal(rng, B, d))
        s0 = _both(_normal(rng, B, H, tcfg.rec.head_dim, tcfg.rec.head_dim,
                           scale=0.1))
        kw_t = dict(x_prev=xp[0], s0=s0[0])
        kw_j = dict(x_prev=xp[1], s0=s0[1])
    jo, (jx, js) = _j_time_mix(x[1], jp, jcfg, **kw_j)
    to, (tx, ts) = tssm.rwkv_time_mix(x[0], tp, tcfg, **kw_t)
    _close(to, jo)
    _close(tx, jx)
    _close(ts, js)


def test_rwkv_time_mix_is_chunk_size_invariant():
    """The port's own chunks of 8 against 4 (tests/test_recurrence.py's
    bars: another chunking sums the decays in another order)."""
    tcfg8, _, _, tp = _weights(RWKV, 1, jssm.rwkv_init)
    tcfg4 = dataclasses.replace(tcfg8, rec=dataclasses.replace(tcfg8.rec,
                                                               chunk=4))
    x = torch.from_numpy(_normal(np.random.default_rng(3), 2, 16,
                                 tcfg8.d_model))
    o8, (_, s8) = tssm.rwkv_time_mix(x, tp, tcfg8)
    o4, (_, s4) = tssm.rwkv_time_mix(x, tp, tcfg4)
    np.testing.assert_allclose(o8.numpy(), o4.numpy(), atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(s8.numpy(), s4.numpy(), atol=1e-3, rtol=1e-3)


def test_rwkv_time_mix_refuses_a_ragged_chunk():
    tcfg, _, _, tp = _weights(RWKV, 2, jssm.rwkv_init)
    x = torch.zeros(1, 12, tcfg.d_model)          # chunk 8
    with pytest.raises(ValueError, match="multiple of the chunk 8"):
        tssm.rwkv_time_mix(x, tp, tcfg)


@pytest.mark.parametrize("carry", [False, True])
def test_rwkv_channel_mix_matches_jax(carry):
    tcfg, jcfg, jp, tp = _weights(RWKV, 3, jssm.rwkv_init)
    rng = np.random.default_rng(4 + carry)
    x = _both(_normal(rng, 2, 16, tcfg.d_model))
    xp = _both(_normal(rng, 2, tcfg.d_model)) if carry else (None, None)
    jo, jx = _j_channel_mix(x[1], jp, x_prev=xp[1])
    to, tx = tssm.rwkv_channel_mix(x[0], tp, x_prev=xp[0])
    _close(to, jo)
    _close(tx, jx)


def test_rwkv_decode_matches_jax_and_the_time_mix():
    """Eight steps from the zero state: each step's output and state
    equal JAX's, and the stepped outputs the full-sequence time mix's."""
    tcfg, jcfg, jp, tp = _weights(RWKV, 4, jssm.rwkv_init)
    B, S = 2, 8
    x = _normal(np.random.default_rng(5), B, S, tcfg.d_model)
    jst, tst = jssm.rwkv_init_state(jcfg, B), tssm.rwkv_init_state(tcfg, B)
    _close(tst, jst)
    outs = []
    for t in range(S):
        xt = _both(x[:, t:t + 1])
        jo, jst = _j_rwkv_decode(xt[1], jp, jcfg, jst)
        to, tst = tssm.rwkv_decode(xt[0], tp, tcfg, tst)
        _close(to, jo)
        _close(tst, jst)
        outs.append(to)
    full, (_, s_fin) = tssm.rwkv_time_mix(torch.from_numpy(x), tp, tcfg)
    _close(torch.cat(outs, 1), full.numpy())
    _close(tst["s"], s_fin.numpy())


def test_masked_ratio_gradient_is_finite_where_the_exponent_overflows():
    """Decays of -60 a token: for t <= s the unmasked exponent reaches 420,
    past f32's exp. The outputs still equal JAX's (its where masks them),
    and the port's gradients are finite, where JAX's are NaN (0 x inf in
    exp's gradient)."""
    rng = np.random.default_rng(6)
    B, C, H, dk = 1, 8, 2, 4
    r, k, v = (_normal(rng, B, C, H, dk) for _ in range(3))
    wlog = np.full((B, C, H, dk), -60.0, np.float32)
    u = _normal(rng, H, dk)
    s0 = _normal(rng, B, H, dk, dk, scale=0.1)
    jargs = [jnp.asarray(a) for a in (r, k, v, wlog, u, s0)]
    targs = [torch.from_numpy(a).requires_grad_() for a in
             (r, k, v, wlog, u, s0)]
    jo, js = _j_wkv(*jargs)
    to, ts = _t_wkv_chunk(*targs)
    _close(to, jo)
    _close(ts, js)
    jg = jax.jit(jax.grad(lambda w: jssm._wkv_chunk(
        *jargs[:3], w, *jargs[4:])[0].sum()))(jargs[3])
    assert np.isnan(np.asarray(jg)).any()      # what the port avoids
    grads = torch.autograd.grad((to.sum() + ts.sum()), targs)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# -- RG-LRU --------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    rng = np.random.default_rng(7 + with_state)
    B, S, w, cw = 2, 9, 16, 4
    u = _both(_normal(rng, B, S, w))
    wt = _both(_normal(rng, cw, w))
    b = _both(_normal(rng, w))
    st = _both(_normal(rng, B, cw - 1, w)) if with_state else (None, None)
    jo, js = _j_conv(u[1], wt[1], b[1], st[1])
    to, ts = tssm._causal_conv(u[0], wt[0], b[0], st[0])
    _close(to, jo)
    _close(ts, js)


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches_jax_and_stepped_decode(with_state):
    """A 12-token sequence (so 4 doubling steps) from the zero state or a
    carried one: output and final state against JAX's, then against the
    port's own rglru_decode stepped over the same tokens."""
    tcfg, jcfg, jp, tp = _weights(REC, 8 + with_state, jssm.rglru_init)
    rng = np.random.default_rng(9 + with_state)
    B, S = 2, 12
    x = _normal(rng, B, S, tcfg.d_model)
    w = tcfg.rec.lru_width
    st0 = ({"h": _normal(rng, B, w),
            "conv": _normal(rng, B, tcfg.rec.conv_width - 1, w)}
           if with_state else None)
    jo, jst = _j_rglru(jnp.asarray(x), jp, jcfg,
                       None if st0 is None else _jnp(st0))
    to, tst = tssm.rglru_apply(torch.from_numpy(x), tp, tcfg,
                               None if st0 is None else _t(st0))
    _close(to, jo)
    _close(tst, jst)
    st = (tssm.rglru_init_state(tcfg, B) if st0 is None else _t(st0))
    _close(tssm.rglru_init_state(tcfg, B), jssm.rglru_init_state(jcfg, B))
    outs = []
    for t in range(S):
        o, st = tssm.rglru_decode(torch.from_numpy(x[:, t:t + 1]), tp, tcfg,
                                  st)
        outs.append(o)
    _close(torch.cat(outs, 1), to.numpy())
    _close(st, {k: v.numpy() for k, v in tst.items()})


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_rglru_decode_matches_jax():
    tcfg, jcfg, jp, tp = _weights(REC, 10, jssm.rglru_init)
    B = 2
    x = _normal(np.random.default_rng(11), B, 5, tcfg.d_model)
    jst, tst = jssm.rglru_init_state(jcfg, B), tssm.rglru_init_state(tcfg, B)
    for t in range(x.shape[1]):
        xt = _both(x[:, t:t + 1])
        jo, jst = _j_rglru_decode(xt[1], jp, jcfg, jst)
        to, tst = tssm.rglru_decode(xt[0], tp, tcfg, tst)
        _close(to, jo)
        _close(tst, jst)


# -- weights: nested leaves, dtypes, Adafactor's paths -------------------------

@pytest.mark.parametrize("name", [RWKV, REC])
def test_nested_leaves_round_trip_through_convert(name):
    """Every leaf of the JAX tree (RWKV's `mu.r`, `lora_b.w`, ...) lands in
    the port's state dict and comes back equal; `jax_paths` gives JAX's
    tree paths with the pattern stacked, and `unstack_paths` inverts it."""
    tcfg, jcfg = _cfgs(name)
    tcfg, jcfg = (dataclasses.replace(c, n_layers=c.n_layers
                                      + len(c.pattern), repeats=2)
                  for c in (tcfg, jcfg))
    jp = _tree(jcfg, 12)
    model = LMModel(tcfg, device="cpu")
    sd = params_from_jax(jp, tcfg)
    model.params.load_state_dict(sd)
    back = params_to_jax(model.params.state_dict(), tcfg)
    want = {jax.tree_util.keystr(p): leaf for p, leaf in
            jax.tree_util.tree_leaves_with_path(jp)}
    got = {jax.tree_util.keystr(p): leaf for p, leaf in
           jax.tree_util.tree_leaves_with_path(back)}
    assert set(got) == set(want)
    assert sum(a.size for a in want.values()) == sum(
        t.numel() for t in sd.values())
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    paths = jax_paths(dict(model.params.state_dict()), tcfg)
    jpaths = {".".join(str(getattr(q, "key", getattr(q, "idx", q)))
                       for q in p): leaf for p, leaf in
              jax.tree_util.tree_leaves_with_path(jp)}
    assert set(paths) == set(jpaths)
    for k, leaf in paths.items():
        np.testing.assert_array_equal(leaf.numpy(), jpaths[k], err_msg=k)
    flat = unstack_paths(paths, tcfg)
    assert set(flat) == set(sd)
    for k, t in flat.items():
        assert torch.equal(t, sd[k]), k
    if name == RWKV:
        assert sd["blocks.1.mix.mu.r"].shape == (tcfg.d_model,)
        assert paths["pattern.0.mix.lora_b.w"].shape == (2, 32, tcfg.d_model)
        state = adafactor_init(paths)
        assert state.vr["pattern.0.mix.mu.r"].shape == (2,)
        assert state.vc["pattern.0.mix.lora_b.w"].shape == (2, tcfg.d_model)


@pytest.mark.parametrize("name", [RWKV, REC])
def test_bf16_model_keeps_the_f32_leaves(name):
    """RWKV's w0 and u and RG-LRU's ba, bi and lam are f32 in a bf16
    model, as in JAX; the JAX bf16 tree carries over leaf for leaf."""
    tcfg, jcfg = (dataclasses.replace(c, dtype="bfloat16")
                  for c in _cfgs(name))
    jp = _tree(jcfg, 13)
    sd = params_from_jax(jp, tcfg)
    model = LMModel(tcfg, device="cpu")
    model.params.load_state_dict(sd)
    f32 = {"w0", "u", "ba", "bi", "lam"}
    jflat = {jax.tree_util.keystr(p): leaf.dtype for p, leaf in
             jax.tree_util.tree_leaves_with_path(jp)}
    assert {str(d) for d in jflat.values()} == {"float32", "bfloat16"}
    for k, t in model.params.state_dict().items():
        want = torch.float32 if k.split(".")[-1] in f32 else torch.bfloat16
        assert t.dtype == want, k
    back = params_to_jax(model.params.state_dict(), tcfg)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jp),
                            jax.tree.leaves(back)):
        np.testing.assert_array_equal(a.astype(np.float32), b,
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [RWKV, REC])
def test_prefill_states_own_their_storage(name, dtype):
    """A recurrent layer's state from `prefill_step` is a tensor of its own
    ([B, w], [B, cw-1, w], [B, H, dk, dk], [B, d] bytes), not a view that
    keeps the layer's [B, S, ·] activations alive: the state stays the
    same size however long the prompt was."""
    tcfg, _ = _cfgs(name)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    model = LMModel(tcfg, seed=5, device="cpu")
    B, S = 2, 32
    tokens = np.random.default_rng(14).integers(0, tcfg.vocab, (B, S))
    _, caches = model.prefill_step({"tokens": tokens.astype(np.int32)})
    want = {"rec": {"h", "conv"}, "rwkv": {"s", "x_tm", "x_cm"}}
    n = 0
    for kind, cache in zip(model.params.kinds, caches):
        if kind not in want:
            continue
        assert set(cache) == want[kind]
        for k, t in cache.items():
            assert t.dtype == torch.float32, (kind, k)
            assert t.untyped_storage().nbytes() == t.numel() * 4, (kind, k)
            n += 1
    assert n > 0
