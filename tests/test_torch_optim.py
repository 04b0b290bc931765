"""repro_torch.optim against repro.optim on the same random trees (numpy,
seeded), on the CPU: AdamW with the clip idle and active, Adafactor on
factored (rank >= 2) and vector leaves, and the int8 compression with
error feedback.

Bars: the updated parameters and states within 1e-6 of each leaf's max
|value| (f32 element-wise arithmetic in the same order; XLA and PyTorch
may round a division or a reduction differently in the last place), the
global gradient norm within 1e-6 relative (the sum over leaves runs in
another order), int8 codes exactly equal and scales within f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.optim as jopt  # noqa: E402
import repro_torch.optim as topt  # noqa: E402

TOL = 1e-6
SHAPES = {"embed": (40, 8), "ffn.wd": (3, 16, 8), "ln.w": (8,),
          "mix.bq": (2, 4), "scalarish": (1,)}


def _tree(rng, scale=1.0, shapes=SHAPES):
    return {k: (scale * rng.standard_normal(s)).astype(np.float32)
            for k, s in shapes.items()}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _close(got, want, tol=TOL):
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        bar = tol * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, atol=bar, rtol=0, err_msg=k)


def test_all_matches_jax():
    assert topt.__all__ == jopt.__all__
    assert topt.AdamWState._fields == jopt.AdamWState._fields
    assert topt.AdafactorState._fields == jopt.AdafactorState._fields


@pytest.mark.parametrize("gscale", [1e-3, 10.0])     # clip idle / active
def test_adamw_matches_jax(gscale):
    rng = np.random.default_rng(0)
    params = _tree(rng, 0.5)
    tstate, jstate = topt.adamw_init(_t(params)), jopt.adamw_init(_j(params))
    tp, jp = _t(params), _j(params)
    for step in range(3):
        grads = _tree(rng, gscale)
        tp, tstate, tgn = topt.adamw_update(_t(grads), tstate, tp)
        jp, jstate, jgn = jax.jit(jopt.adamw_update)(_j(grads), jstate, jp)
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=TOL)
        assert (float(jgn) > 1.0) == (gscale > 1)
        assert int(tstate.step) == int(jstate.step) == step + 1
        assert tstate.step.dtype == torch.int32
        for got, want in ((tp, jp), (tstate.m, jstate.m),
                          (tstate.v, jstate.v)):
            _close(got, want)
        assert all(v.dtype == torch.float32 for v in tstate.m.values())


def test_adamw_keeps_bf16_params_and_f32_state():
    rng = np.random.default_rng(1)
    params = _tree(rng, 0.5)
    tp = {k: v.to(torch.bfloat16) for k, v in _t(params).items()}
    jp = {k: v.astype(jnp.bfloat16) for k, v in _j(params).items()}
    grads = _tree(rng, 0.1)
    tnew, ts, _ = topt.adamw_update(_t(grads), topt.adamw_init(tp), tp)
    jnew, js, _ = jax.jit(jopt.adamw_update)(_j(grads), jopt.adamw_init(jp),
                                             jp)
    for k in params:
        assert tnew[k].dtype == torch.bfloat16
        assert ts.m[k].dtype == ts.v[k].dtype == torch.float32
        # the same f32 value rounded once to bf16: equal but where the f32
        # results straddle a bf16 rounding boundary (one bf16 ulp)
        w = np.asarray(jnew[k].astype(jnp.float32))
        np.testing.assert_allclose(tnew[k].float().numpy(), w,
                                   atol=2.0 ** -8 * np.abs(w).max(), rtol=0)
    _close(ts.v, js.v)


def test_clip_by_global_norm_matches_jax():
    rng = np.random.default_rng(2)
    grads = _tree(rng, 3.0)
    tg, tn = topt.clip_by_global_norm(_t(grads), 1.0)
    jg, jn = jopt.clip_by_global_norm(_j(grads), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=TOL)
    _close(tg, jg)


def test_adafactor_matches_jax():
    rng = np.random.default_rng(3)
    params = _tree(rng, 0.5)
    tstate = topt.adafactor_init(_t(params))
    jstate = jopt.adafactor_init(_j(params))
    for k in params:        # factored leaves keep rows and columns only
        assert tuple(tstate.vr[k].shape) == jstate.vr[k].shape
        assert tuple(tstate.vc[k].shape) == jstate.vc[k].shape
    tp, jp = _t(params), _j(params)
    for step in range(3):
        grads = _tree(rng, 0.2)
        tp, tstate, tgn = topt.adafactor_update(_t(grads), tstate, tp)
        jp, jstate, jgn = jax.jit(jopt.adafactor_update)(_j(grads), jstate,
                                                         jp)
        assert float(tgn) == float(jgn) == 0.0
        for got, want in ((tp, jp), (tstate.vr, jstate.vr),
                          (tstate.vc, jstate.vc)):
            _close(got, want)


def test_compression_with_error_feedback_matches_jax():
    rng = np.random.default_rng(4)
    grads = _tree(rng, 2.0)
    tq, ts = topt.compress_grads(_t(grads))
    jq, js = jopt.compress_grads(_j(grads))
    for k in grads:
        assert tq[k].dtype == torch.int8
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=1e-7)
    _close(topt.decompress_grads(tq, ts), jopt.decompress_grads(jq, js))
    tres, jres = topt.ef_init(_t(grads)), jopt.ef_init(_j(grads))
    for _ in range(3):
        g = _tree(rng, 2.0)
        tq, ts, tres = topt.ef_apply(_t(g), tres)
        jq, js, jres = jopt.ef_apply(_j(g), jres)
        for k in g:
            np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
        _close(tres, jres)
