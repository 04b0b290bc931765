"""repro_torch's MoE kinds on a mesh against the JAX package, on the CPU.

`attn_moe` (dbrx-132b) and `mla_moe` (deepseek-v3-671b) without
`pure_dp`, as JAX's specs lay them out: the experts over 'data', each
expert's d_ff over 'model', deepseek's shared expert and the attention
heads over 'model'. One group of 2 gloo ranks and one of 4
(`run_ranks`, in a thread while the JAX side compiles; rank bodies
`moe_mesh_cases` in `test_torch_lm_mesh_workers.py`, which imports no
JAX), at the smoke widths (d_model 64, 4 experts of width 32, top 2):

- One MoE layer alone (`models.moe.moe_apply` with the mesh's
  `ShardCtx`) on (1, 2) and (2, 2) with `seq_parallel`, on (2, 1) and on
  (4, 1), where the microbatch's 2 rows are whole on every rank (the
  backward of the experts' gather keeps this rank's piece there, and
  sums the rows' parts where they are split), for dbrx's MoE and for
  deepseek's (its shared expert, its sigmoid router), at a capacity
  factor of 1 under which experts overflow: each rank's output, the aux
  loss and the gradients of x, the router and each rank's pieces of the
  experts (summed over the ranks as `LMModel._reduce` sums them: an
  expert's gradient is not summed over 'data') against
  `repro.models.moe.moe_apply` on one device at 1e-5 of their max; the
  gates every rank routes by are the same bits on every rank, within
  1e-5 of JAX's, and keep the same tokens.
- `train(mesh=)` at `test_torch_lm_mesh.py`'s bars (its docstring) from
  a JAX step-0 checkpoint, two steps each against JAX's `train_step` on
  one device, for dbrx and deepseek with f32 gradient sums and for dbrx
  with its bf16 sums: on (1, 2) with `seq_parallel`, on (2, 1), on (2, 2)
  with `zero1` and `seq_parallel` and on (4, 1).
- `prefill_step` / `decode_step` / `init_cache` and the greedy tokens at
  `test_torch_lm_mesh_serve.py`'s bars (its docstring): dbrx on (1, 2)
  with `seq_parallel` and on (2, 2), and with the int8 cache on both;
  deepseek on (2, 2), its latent whole and with `shard_cache_t`; the
  tokens equal to `repro.launch.serve.serve`'s. `launch.serve.main` of
  dbrx under 2 ranks (its local mesh (2, 1): the experts over 'data')
  prints the tokens of the port's `serve` on one device.
"""
import dataclasses
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.train.checkpoint import save_checkpoint  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.core.mesh import run_ranks  # noqa: E402
from repro_torch.launch.serve import serve as t_serve  # noqa: E402
from repro_torch.models import shard as sh  # noqa: E402
from test_torch_lm_mesh import _check_run, _jbatch_at  # noqa: E402
from test_torch_lm_mesh_serve import (_At, _check_case,  # noqa: E402
                                      _jax_params, _jax_run)
from test_torch_lm_mesh_workers import moe_mesh_cases, smoke_cfg  # noqa: E402
from test_torch_moe import _kept  # noqa: E402

TOL = 1e-5
D, E, FF = 64, 4, 32            # the smoke configs' MoE widths
LAYER_S = 16

# one MoE layer: (variant, mesh shape, flags, B)
LAYERS2 = [(v, shape, flags, 2) for v in ("dbrx-132b", "deepseek-v3-671b")
           for shape, flags in (((1, 2), dict(seq_parallel=True)),
                                ((2, 1), {}))]
LAYERS4 = [(v, shape, flags, 2) for v in ("dbrx-132b", "deepseek-v3-671b")
           for shape, flags in (((2, 2), dict(seq_parallel=True)),
                                ((4, 1), {}))]
# train(mesh=): (variant, flags, mesh shape)
TRAIN_VARIANTS = ("dbrx-132b", "deepseek-v3-671b", "dbrx-bf16")
TRAIN2 = [(v, flags, shape) for v in TRAIN_VARIANTS
          for flags, shape in ((dict(seq_parallel=True), (1, 2)),
                               ({}, (2, 1)))]
TRAIN4 = [(v, flags, shape) for v in TRAIN_VARIANTS
          for flags, shape in ((dict(zero1=True, seq_parallel=True), (2, 2)),
                               ({}, (4, 1)))]
# serving: (JAX run: variant, B, prompt, generated, seed)
RUNS = {
    "dbrx": ("dbrx-132b", 4, 8, 4, 41),
    "dbrx-int8": ("dbrx-int8", 4, 8, 4, 42),
    "deepseek": ("deepseek-v3-671b", 4, 8, 4, 43),
}
# (JAX run, the port's flags, mesh shape)
SERVE2 = [("dbrx", dict(seq_parallel=True), (1, 2)),
          ("dbrx-int8", {}, (1, 2))]
SERVE4 = [("dbrx", {}, (2, 2)), ("dbrx-int8", dict(seq_parallel=True), (2, 2)),
          ("deepseek", {}, (2, 2)),
          ("deepseek", dict(shard_cache_t=True), (2, 2))]
LAUNCH = (2, 4, 3)              # the launcher's batch, prompt, generated
LAUNCH_ARGV = ["--arch", "dbrx-132b", "--smoke", "--device", "cpu",
               "--batch", str(LAUNCH[0]), "--prompt-len", str(LAUNCH[1]),
               "--gen", str(LAUNCH[2])]


def _layer_id(c):
    variant, shape, flags, B = c
    return "-".join([variant, "x".join(map(str, shape))]
                    + sorted(k for k, v in flags.items() if v))


def _case_id(c):
    name, flags, shape = c
    return "-".join([name, "x".join(map(str, shape))]
                    + sorted(k for k, v in flags.items() if v))


def _layer_inputs(c) -> dict:
    """The layer's whole leaves (numpy f32; deepseek's with its shared
    expert), x and the loss's weights r, from a seed."""
    variant, shape, flags, B = c
    rng = np.random.default_rng(len(variant) + 10 * shape[0] + shape[1])

    def normal(*dims, scale=1.0):
        return (scale * rng.standard_normal(dims)).astype(np.float32)

    p = {"router": normal(D, E, scale=0.3),
         "wg": normal(E, D, FF, scale=0.2), "wu": normal(E, D, FF, scale=0.2),
         "wd": normal(E, FF, D, scale=0.2)}
    if variant.startswith("deepseek"):
        p["shared"] = {"wg": normal(D, FF, scale=0.2),
                       "wu": normal(D, FF, scale=0.2),
                       "wd": normal(FF, D, scale=0.2)}
    return dict(kind="layer", variant=variant, shape=shape, flags=flags,
                moe=dict(capacity_factor=1.0), p=p,
                x=normal(B, LAYER_S, D), r=normal(B, LAYER_S, D))


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """Per training variant: JAX's model and its step 0, also as a
    checkpoint directory (`test_torch_lm_mesh.py`'s)."""
    out = {}
    for v in TRAIN_VARIANTS:
        cfg = smoke_cfg(jconfigs, v)
        jm = JLMModel(cfg)
        params = jm.init_params(jax.random.key(0))
        opt = jm.init_opt(params)
        d = tmp_path_factory.mktemp(f"jax0-{v}")
        save_checkpoint(str(d), 0, (params, opt))
        out[v] = dict(cfg=cfg, jm=jm, state0=(params, opt), ckpt0=d)
    return out


@pytest.fixture(scope="module")
def spawned(jax_init, tmp_path_factory):
    """Every case's inputs, and the two groups of gloo ranks (2, then 4)
    run in a thread while the JAX side compiles: (thread, {world:
    (cases, per-rank results)}, {run: `_jax_params`})."""
    params = {name: _jax_params(name, RUNS) for name in RUNS}
    groups = {}
    for world, layers, trains, serves in ((2, LAYERS2, TRAIN2, SERVE2),
                                          (4, LAYERS4, TRAIN4, SERVE4)):
        cases = [_layer_inputs(c) for c in layers]
        for variant, flags, shape in trains:
            d = tmp_path_factory.mktemp(_case_id((variant, flags, shape)))
            shutil.copytree(jax_init[variant]["ckpt0"], d,
                            dirs_exist_ok=True)
            cases.append(dict(kind="train", variant=variant, flags=flags,
                              shape=shape, steps=[1, 2], ckpt=str(d)))
        for run, flags, shape in serves:
            variant, B, P, G, seed = RUNS[run]
            cases.append(dict(kind="serve", variant=variant, flags=flags,
                              shape=shape, B=B, P=P, G=G, seed=seed,
                              state=params[run][3]))
        if world == 2:
            cases.append(dict(kind="launch", argv=LAUNCH_ARGV))
        groups[world] = cases
    store = tmp_path_factory.mktemp("store")
    out = {}

    def work():
        try:
            for world, cases in groups.items():
                out[world] = (cases, run_ranks(
                    moe_mesh_cases, world, cases, store_dir=str(store),
                    timeout_s=240))
        except BaseException as e:       # raised by the tests that wait
            out["error"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t, out, params


def _joined(spawned, world):
    t, out, _ = spawned
    t.join()
    if "error" in out:
        raise out["error"]
    return out[world]


@pytest.fixture(scope="module")
def world2(spawned):
    return _joined(spawned, 2)


@pytest.fixture(scope="module")
def world4(spawned):
    return _joined(spawned, 4)


def _results(world, pred):
    """The per-rank results of the one case of `world` that `pred`
    picks."""
    cases, got = world
    i = [j for j, c in enumerate(cases) if pred(c)]
    assert len(i) == 1, i
    return cases[i[0]], [g[i[0]] for g in got]


# -- one MoE layer ------------------------------------------------------------

def _jax_layer(c):
    """JAX's one device: (out, aux, gates, gradient of x, of each leaf by
    its dotted path)."""
    jm = dataclasses.replace(smoke_cfg(jconfigs, c["variant"]).moe,
                             **c["moe"])
    p = jax.tree.map(jnp.asarray, c["p"])
    r = jnp.asarray(c["r"])

    def loss(p, x):
        out, aux = jmoe.moe_apply(x, p, jm)
        return jnp.sum(out * r) + 0.01 * aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(c["x"]))
    N = c["x"].shape[0] * c["x"].shape[1]
    gates, _ = jmoe._route(jnp.asarray(c["x"]).reshape(N, D), p, jm)
    flat = {k: np.asarray(v) for k, v in gp.items() if k != "shared"}
    flat.update({f"shared.{k}": np.asarray(v)
                 for k, v in gp.get("shared", {}).items()})
    C = min(jmoe.capacity(N, jm), N)
    return (np.asarray(out), float(aux), np.asarray(gates), np.asarray(gx),
            flat, C)


def _mine(full, r, shape):
    """This rank's rows (where they are split) and positions (under
    sequence parallelism) of a [B, S, ...] array."""
    at = _At(shape, r["coord"])
    t = torch.from_numpy(np.array(full))
    if r["ndp"] > 1:
        t = sh.shard_of(t, sh.P("data"), at)
    if r["sp"]:
        t = sh.shard_of(t, sh.P(None, "model"), at)
    return t.numpy()


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=TOL * max(np.abs(want).max(), 1e-30))


def _check_layer(c, rs):
    out, aux, gates, gx, grads, C = _jax_layer(c)
    shape = c["shape"]
    # the experts overflow at a capacity factor of 1: tokens are dropped
    assert ((gates > 0).sum(axis=0) > C).any()
    for i, r in enumerate(rs):
        what = f"rank {i} {r['coord']}"
        assert r["split"]["expert"] and r["split"]["ffn_expert"], r["split"]
        assert r["split"]["shared"] == ("shared" in c["p"])
        np.testing.assert_array_equal(r["gates"], rs[0]["gates"])
        _close(r["gates"], gates, what)
        assert ((r["gates"] > 0) == (gates > 0)).all(), what
        assert _kept(r["gates"], C) == _kept(gates, C), what
        _close(r["out"], _mine(out, r, shape), f"{what} out")
        np.testing.assert_allclose(r["aux"], aux, rtol=1e-6, err_msg=what)
        _close(r["gx"], _mine(gx, r, shape), f"{what} dx")
        assert set(r["grads"]) == set(grads)
        at = _At(shape, r["coord"])
        for k, g in grads.items():
            want = sh.shard_of(torch.from_numpy(np.array(g)), r["specs"][k],
                               at).numpy()
            assert r["grads"][k].shape == want.shape, (what, k)
            np.testing.assert_allclose(
                r["grads"][k], want, rtol=0, err_msg=f"{what} d{k}",
                atol=TOL * np.abs(g).max())
        # each rank holds its experts and its d_ff columns of them
        n_data, n_model = shape
        assert r["grads"]["wg"].shape == (E // n_data, D, FF // n_model)
        assert r["grads"]["wd"].shape == (E // n_data, FF // n_model, D)


@pytest.mark.parametrize("case", LAYERS2, ids=[_layer_id(c) for c in LAYERS2])
def test_moe_layer_on_two_ranks_matches_jax(case, world2):
    variant, shape, flags, _ = case
    c, rs = _results(world2, lambda x: x["kind"] == "layer" and (
        x["variant"], x["shape"]) == (variant, shape))
    _check_layer(c, rs)


@pytest.mark.parametrize("case", LAYERS4, ids=[_layer_id(c) for c in LAYERS4])
def test_moe_layer_on_four_ranks_matches_jax(case, world4):
    variant, shape, flags, _ = case
    c, rs = _results(world4, lambda x: x["kind"] == "layer" and (
        x["variant"], x["shape"]) == (variant, shape))
    _check_layer(c, rs)


# -- train(mesh=) -------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(jax_init, spawned):
    """Per training variant: `train_step` (jit) and its step 1 on one
    device."""
    out = {}
    for v, r in jax_init.items():
        step = jax.jit(r["jm"].train_step)
        p1, o1, m1 = step(*r["state0"], _jbatch_at(r["cfg"], 0))
        out[v] = dict(r, step=step, state1=(p1, o1),
                      hist1={k: float(x) for k, x in m1.items()})
    return out


def _check_train(case, world, jax_ref):
    variant, flags, shape = case
    c, rs = _results(world, lambda x: x["kind"] == "train" and (
        x["variant"], x["flags"], x["shape"]) == case)
    _check_run(jax_ref[variant], c, rs)


@pytest.mark.parametrize("case", TRAIN2, ids=[_case_id(c) for c in TRAIN2])
def test_train_on_two_ranks_matches_jax(case, jax_ref, world2):
    _check_train(case, world2, jax_ref)


@pytest.mark.parametrize("case", TRAIN4, ids=[_case_id(c) for c in TRAIN4])
def test_train_on_four_ranks_matches_jax(case, jax_ref, world4):
    _check_train(case, world4, jax_ref)


# -- serving ------------------------------------------------------------------

@pytest.fixture(scope="module")
def serve_ref(spawned):
    """Per JAX run: `test_torch_lm_mesh_serve.py`'s `_jax_run`."""
    return {name: _jax_run(spawned[2][name], *RUNS[name][1:])
            for name in RUNS}


def _check_serve(case, world, serve_ref):
    run, flags, shape = case
    variant = RUNS[run][0]
    _, rs = _results(world, lambda x: x["kind"] == "serve" and (
        x["variant"], x["flags"], x["shape"]) == (variant, flags, shape))
    _check_case(case, rs, serve_ref[run], RUNS)


@pytest.mark.parametrize("case", SERVE2, ids=[_case_id(c) for c in SERVE2])
def test_serve_on_two_ranks_matches_jax(case, serve_ref, world2):
    _check_serve(case, world2, serve_ref)


@pytest.mark.parametrize("case", SERVE4, ids=[_case_id(c) for c in SERVE4])
def test_serve_on_four_ranks_matches_jax(case, serve_ref, world4):
    _check_serve(case, world4, serve_ref)


def test_launcher_serves_a_moe_arch_under_two_ranks(world2):
    """`launch.serve.main` of dbrx's smoke config under 2 ranks: the
    local mesh (2, 1) puts the experts over 'data'; rank 0 prints the
    tokens `serve` gives on one device from the same seed (the mesh draws
    the one-device weights and cuts them)."""
    _, printed = _results(world2, lambda x: x["kind"] == "launch")
    B, P, G = LAUNCH
    toks, _ = t_serve(tconfigs.smoke_config(tconfigs.get_config("dbrx-132b")),
                      batch=B, prompt_len=P, gen=G, seed=0, device="cpu")
    assert "arch=dbrx-132b-smoke mesh={'data': 2, 'model': 1} " \
        "backend=gloo device=cpu" in printed[0]
    assert f"generated ({B}, {G}) tokens" in printed[0]
    assert str(toks[:, :12]) in printed[0], (printed[0], toks)
    assert all(p == "" for p in printed[1:])
