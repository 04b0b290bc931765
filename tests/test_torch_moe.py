"""repro_torch's MoE layer (`models/moe.py`) against the JAX package's
`repro.models.moe`, on the CPU.

The same router and expert weights, made with numpy from a seed, go
through both packages in f32 at the smoke config's dims (d_model 64, 4
experts, top-2, expert width 32). Bars: outputs within 1e-5 (the same
sums in another order), the aux loss within 1e-6 relative, gradients
within 1e-5 of each leaf's max |value|.

Token drops: at dbrx's capacity factor of 1.25 an expert can receive more
tokens than its capacity and drops the lowest gates. The smoke config's
factor of 8 never drops, so the overflow cases here lower the factor and
assert that an expert overflowed and that both packages kept the same
tokens (the gates are distinct, so the choice is unique). The spare
slots of an expert that is not full take zero-gate tokens, which
`torch.topk` and XLA's `top_k` may pick differently: they add 0, so the
tests compare values and the kept (nonzero-gate) tokens, not indices.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

TOL = 1e-5
D, E, FF = 64, 4, 32


def _moes(**changes):
    """(port MoECfg, JAX MoECfg): dbrx's smoke MoE config with `changes`."""
    jm = dataclasses.replace(
        jconfigs.smoke_config(jconfigs.get_config("dbrx-132b")).moe,
        **changes)
    return tconfigs.MoECfg(**dataclasses.asdict(jm)), jm


def _weights(seed, shared=0):
    """Router and experts as numpy f32 (a nested "shared" MLP with
    `shared` experts' width)."""
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    p = {"router": normal(D, E, scale=0.3), "wg": normal(E, D, FF, scale=0.2),
         "wu": normal(E, D, FF, scale=0.2), "wd": normal(E, FF, D, scale=0.2)}
    if shared:
        p["shared"] = {"wg": normal(D, FF * shared, scale=0.2),
                       "wu": normal(D, FF * shared, scale=0.2),
                       "wd": normal(FF * shared, D, scale=0.2)}
    return p


def _tree(p, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in p.items()}


def _kept(gates, C):
    """Each expert's kept tokens: those of its top-C by gate whose gate is
    nonzero (numpy [N, E] gates)."""
    out = []
    for e in range(gates.shape[1]):
        order = np.argsort(-gates[:, e], kind="stable")[:C]
        out.append(sorted(int(i) for i in order if gates[i, e] > 0))
    return out


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("n,top_k,factor,experts", [
    (1, 4, 1.25, 16), (4, 4, 1.25, 16), (16384, 4, 1.25, 16),
    (4096, 4, 1.25, 16), (80, 2, 8.0, 4), (80, 2, 0.5, 4), (7, 8, 1.0, 256),
    (65536, 8, 1.25, 256)])
def test_capacity_matches_jax(n, top_k, factor, experts):
    tm, jm = _moes(top_k=top_k, capacity_factor=factor, n_experts=experts)
    assert tmoe.capacity(n, tm) == jmoe.capacity(n, jm)
    assert tmoe.capacity(n, tm) % 8 == 0 and tmoe.capacity(n, tm) >= 8


@pytest.mark.parametrize("factor,overflow", [(8.0, False), (1.0, True),
                                             (0.5, True)])
def test_moe_apply_matches_jax(factor, overflow):
    """Outputs and aux at the smoke dims, B 2 x 40 tokens; with a factor
    under which experts overflow, the same tokens kept as in JAX."""
    tm, jm = _moes(capacity_factor=factor)
    p = _weights(1)
    x = np.random.default_rng(2).standard_normal((2, 40, D)).astype(
        np.float32)
    jo, jaux = jmoe.moe_apply(jnp.asarray(x), _tree(p, jnp.asarray), jm)
    to, taux = tmoe.moe_apply(torch.from_numpy(x),
                              _tree(p, torch.from_numpy), tm)
    assert to.shape == x.shape and to.dtype == torch.float32
    assert taux.dtype == torch.float32 and taux.shape == ()
    _close(to, jo)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    # the routing and the kept tokens
    N = x.shape[0] * x.shape[1]
    C = min(tmoe.capacity(N, tm), N)
    assert C == min(jmoe.capacity(N, jm), N)
    tg, _ = tmoe._route(torch.from_numpy(x).reshape(N, D),
                        _tree(p, torch.from_numpy), tm)
    jg, _ = jmoe._route(jnp.asarray(x).reshape(N, D), _tree(p, jnp.asarray),
                        jm)
    tg, jg = tg.numpy(), np.asarray(jg)
    np.testing.assert_allclose(tg, jg, atol=TOL, rtol=TOL)
    assert ((tg > 0) == (jg > 0)).all()
    nz = tg[tg > 0]
    assert len(np.unique(nz)) == len(nz)          # distinct gates
    routed = (tg > 0).sum(axis=0)
    assert (routed > C).any() == overflow, (routed, C)
    assert _kept(tg, C) == _kept(jg, C)
    # the port's own dispatch keeps those tokens
    vals, idx = torch.topk(torch.from_numpy(tg).T, C, dim=-1)
    got = [sorted(int(i) for i, v in zip(ix, vs) if v > 0)
           for ix, vs in zip(idx.tolist(), vals.tolist())]
    assert got == _kept(tg, C)
    if overflow:        # a dropped token's output lacks that expert's term
        assert sum(len(k) for k in got) < int((tg > 0).sum())


@pytest.mark.parametrize("factor", [8.0, 0.5])
def test_moe_apply_gradients_match_jax(factor):
    """Gradients of sum(out * r) + 0.01 aux with respect to x and every
    leaf (the router through the gates and the aux loss), with and
    without dropped tokens."""
    tm, jm = _moes(capacity_factor=factor)
    p = _weights(3)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 40, D)).astype(np.float32)
    r = rng.standard_normal((2, 40, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = jmoe.moe_apply(x, p, jm)
        return jnp.sum(out * r) + 0.01 * aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(_tree(p, jnp.asarray),
                                               jnp.asarray(x))
    tp = _tree(p, lambda a: torch.from_numpy(a).requires_grad_())
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = tmoe.moe_apply(tx, tp, tm)
    loss = torch.sum(out * torch.from_numpy(r)) + 0.01 * aux
    names = sorted(tp)
    grads = torch.autograd.grad(loss, [tx] + [tp[k] for k in names])
    for got, want in zip(grads, [jgx] + [jgp[k] for k in names]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=TOL * np.abs(want).max())


def test_moe_decode_capacity_is_the_batch():
    """A decode step routes B tokens, one a sequence: C = min(capacity(B),
    B) = B, every routed token kept; the output matches JAX's and each
    token's output equals the same token's in a batch of its own."""
    tm, jm = _moes(capacity_factor=1.25)
    p = _weights(5)
    x = np.random.default_rng(6).standard_normal((4, 1, D)).astype(
        np.float32)
    assert min(tmoe.capacity(4, tm), 4) == 4
    to, _ = tmoe.moe_apply(torch.from_numpy(x), _tree(p, torch.from_numpy),
                           tm)
    jo, _ = jmoe.moe_apply(jnp.asarray(x), _tree(p, jnp.asarray), jm)
    _close(to, jo)
    for b in range(4):
        one, _ = tmoe.moe_apply(torch.from_numpy(x[b:b + 1]),
                                _tree(p, torch.from_numpy), tm)
        _close(one, to[b:b + 1].numpy())


def test_group_routing_shared_experts_and_fp8_dispatch_match_jax():
    """DeepSeek-V3's refinements, which no registered config of the port
    reaches yet: sigmoid scores, node-limited routing (2 groups of 2
    experts, the top 1 kept), a shared expert, and the dispatch rounded
    through float8_e4m3fn."""
    tm, jm = _moes(router="sigmoid", n_groups=2, group_top=1, n_shared=1,
                   dispatch_dtype="float8_e4m3fn")
    p = _weights(7, shared=1)
    x = np.random.default_rng(8).standard_normal((2, 24, D)).astype(
        np.float32)
    jo, jaux = jmoe.moe_apply(jnp.asarray(x), _tree(p, jnp.asarray), jm)
    to, taux = tmoe.moe_apply(torch.from_numpy(x),
                              _tree(p, torch.from_numpy), tm)
    _close(to, jo)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    g, _ = tmoe._route(torch.from_numpy(x).reshape(-1, D),
                       _tree(p, torch.from_numpy), tm)
    used = (g.reshape(-1, 2, 2) > 0).any(-1).sum(-1)
    assert bool((used == 1).all())               # one group a token


def test_moe_init_layout_matches_jax():
    """Leaf names, shapes and dtypes: the router f32 in a bf16 layer, the
    experts stacked on a leading expert axis; the shared MLP nested."""
    tm, jm = _moes(n_shared=2)
    tp = tmoe.moe_init(D, tm, torch.bfloat16,
                       generator=torch.Generator().manual_seed(0))
    jp = jmoe.moe_init(jax.random.key(0), D, jm, jnp.bfloat16)

    def layout(p, dtype_name):
        return {k: layout(v, dtype_name) if isinstance(v, dict)
                else (tuple(v.shape), dtype_name(v)) for k, v in p.items()}

    assert layout(tp, lambda t: str(t.dtype)[6:]) == \
        layout(jp, lambda a: str(a.dtype))
    assert tp["router"].dtype == torch.float32


def test_combine_adds_the_experts_in_ascending_order():
    """In bf16 a token's output is its expert terms added in ascending
    expert order with a rounding after each add (JAX's scatter-add
    order), and two calls give the same bits."""
    tm, _ = _moes(capacity_factor=0.5)
    p = _tree(_weights(9), lambda a: torch.from_numpy(a))
    p = {k: v if k == "router" else v.to(torch.bfloat16)
         for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (2, 40, D)).astype(np.float32)).to(torch.bfloat16)
    out, _ = tmoe.moe_apply(x, p, tm)
    again, _ = tmoe.moe_apply(x, p, tm)
    assert torch.equal(out, again)
    N = 80
    xf = x.reshape(N, D)
    gates, _ = tmoe._route(xf, p, tm)
    C = min(tmoe.capacity(N, tm), N)
    vals, idx = torch.topk(gates.T, C, dim=-1)
    ye = tmoe._expert_ffn(xf[idx], p) * vals[..., None].to(torch.bfloat16)
    want = torch.zeros(N, D, dtype=torch.bfloat16)
    for e in range(E):
        for c in range(C):
            t = int(idx[e, c])
            want[t] = (want[t].float() + ye[e, c].float()).to(torch.bfloat16)
    assert torch.equal(out.reshape(N, D), want)
