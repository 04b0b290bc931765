"""repro_torch's LM on a mesh against the JAX package, on the CPU.

- The sharding specs: `param_specs`, `zero1_specs`, the optimizer state's
  specs (`opt_specs`, what `LMModel.opt_partition` returns),
  `batch_specs`, `cache_specs` and `input_specs` of the port against
  JAX's, on a `jax.sharding.AbstractMesh` and the port's stand-in
  (`launch.mesh.abstract_mesh`) of the same shape: all ten configs at
  full size on (16, 16), (2, 16, 16), (2, 2) and (4, 1), with `zero1`,
  `pure_dp` and `shard_cache_t` on and off, every `SHAPES` entry. The
  port keys the weights by layer: a JAX stacked leaf's spec is the
  port's with the scan axis (None) in front; Adafactor's state is keyed
  by JAX's paths and equal as it is. ZeRO-1 of AdamW's per-layer state is
  JAX's rule on the per-layer leaf, so where JAX's stacked leaf splits
  its layer axis the port splits the layer's first free dimension.
- `train(mesh=)` on gloo CPU ranks (`run_ranks`) from a checkpoint that
  the JAX package wrote (its `init_params`, step 0), two steps of B 4 x
  S 32 (two microbatches), against JAX's `train_step` (jit) on one
  device: loss, aux and grad_norm within 1e-5 relative each step; the
  checkpoint rank 0 writes at step 2, read by the JAX package's
  `restore_checkpoint`: AdamW's m within 1e-5 and v within 2e-5 of their
  leaves' max, the weights within 1e-5 of their max plus lr x min(2,
  2 d / (|g_s| + eps)) for each step s, where g_s is JAX's clipped
  gradient of step s and d 1e-5 of its max (AdamW's update is about lr
  sign(g): an entry whose gradient is within the bar of 0 may move by
  up to 2 lr either way). Meshes (2, 1), (1, 2), (2, 2) and (1, 4), with
  `zero1` and `seq_parallel`, the smoke configs of qwen2-1.5b, gemma2-9b
  (window and soft-caps), qwen3-4b (q/k norms), qwen2-vl-2b (M-RoPE,
  embedding inputs) and three head layouts: 3 heads that 'model' leaves
  whole, 12 q heads over 2 kv heads (3 a rank on 4, over one kv head)
  and 12 over 3 (6 a rank on 2, over kv heads 0,0,0,0,1,1).
- Tensor parallelism over 'model' for the recurrent kinds and MLA:
  recurrentgemma-2b (RG-LRU beside local attention) on (1, 2) and, with
  `zero1` and `seq_parallel`, on (2, 2); rwkv6-1.6b on (1, 2) and on
  (1, 4) with `seq_parallel`; an rwkv6 of 3 wkv heads 32 wide at
  d_model 96 on (1, 4), where 'model' cuts every head; deepseek's MLA
  over a dense MLP ("deepseek-mla", Adafactor, f32 sums) on (1, 2) with
  `seq_parallel` and on (2, 2) with `zero1` too.
- `pure_dp` on (2, 1) for rwkv6, recurrentgemma, dbrx (MoE, Adafactor)
  and deepseek (MLA, MoE, Adafactor): the MoE layers route the whole
  microbatch (the MoE kinds over 'model' and their experts over 'data'
  are in `test_torch_lm_mesh_moe.py`). Adafactor's weights and factors
  within 1e-5 of their max.
  dbrx and deepseek sum their gradients in bf16, where a rank's f32 part
  rounds to another bf16 value than the whole sum now and then: they are
  held with f32 sums, and dbrx with its bf16 sums too, at bf16's bar
  (the factors within 2^-6 of their max, the weights within 2^-5 of
  JAX's largest move).
- Checkpoints across the packages and mesh shapes: every run above
  resumes JAX's step 0; a (2, 2) run's step 2 resumes on (1, 4) and a
  (2, 1) run's in `repro.train.train`, each to step 3 against JAX's.
- The refusal that waits for ROADMAP A9 (RWKV-6 where 'model' divides
  d_model but not d_ff); the launcher under 4 ranks
  builds its (2, 2) mesh from `--model-parallel 2`.
- A vocabulary that 'model' does not divide (`embed`/`unembed` whole);
  a mesh model's fresh shards equal to the one-device draw's pieces; the
  backend each rank's placement picks from its host's ranks and cards.
"""
import dataclasses
import shutil
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
import repro.models.model as jmodel  # noqa: E402
from repro.data.pipeline import batch_for as jbatch_for  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
from repro.train import train as jtrain  # noqa: E402
from repro.train.checkpoint import (restore_checkpoint,  # noqa: E402
                                    save_checkpoint)
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models.model as tmodel  # noqa: E402
from repro_torch.core.mesh import run_ranks  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh, placement  # noqa: E402
from repro_torch.models.convert import jax_paths  # noqa: E402
from test_torch_lm_mesh_workers import (B, S, launcher,  # noqa: E402
                                        smoke_cfg, train_cases)

TOL = 1e-5
LR, EPS = 3e-4, 1e-8            # adamw_update's defaults in both packages
ARCHS = ("qwen2-1.5b", "smollm-360m", "qwen3-4b", "gemma2-9b",
         "recurrentgemma-2b", "rwkv6-1.6b", "qwen2-vl-2b", "musicgen-large",
         "dbrx-132b", "deepseek-v3-671b")
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 2), ("data", "model")), ((4, 1), ("data", "model")))


# -- the specs -----------------------------------------------------------------

def _name(k) -> str:
    for attr in ("key", "idx", "name"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _paths(tree) -> dict:
    """A JAX tree of specs, shapes or arrays -> {dotted path: leaf}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {".".join(_name(k) for k in path): leaf for path, leaf in leaves}


def _stack_equal(specs):
    """A pattern slot's per-layer specs, equal over its repeats, as its
    stacked leaf's."""
    assert all(s == specs[0] for s in specs), specs
    return (None,) + tuple(specs[0])


def _stacked(cfg, specs: dict) -> dict:
    return {k: tuple(v) for k, v in
            jax_paths(specs, cfg, _stack_equal).items()}


def _jax_specs(tree) -> dict:
    return {k: tuple(v) for k, v in _paths(tree).items()}


def _per_layer(cfg, tree) -> list:
    """JAX's cache tree (prefix, stacked pattern, suffix) -> one dict a
    layer, a pattern leaf without its scan axis; leaves are specs or
    shape structs."""
    pre, pat, reps, suf = cfg.layer_kinds()

    def cut(x):
        if isinstance(x, PartitionSpec):
            return tuple(x)[1:]
        return (tuple(x.shape[1:]), x.dtype.name)

    def whole(x):
        if isinstance(x, PartitionSpec):
            return tuple(x)
        return (tuple(x.shape), x.dtype.name)

    out = [{k: whole(v) for k, v in d.items()} for d in tree["prefix"]]
    for _ in range(reps):
        for slot in tree["pattern"]:
            out.append({k: cut(v) for k, v in slot.items()})
    out += [{k: whole(v) for k, v in d.items()} for d in tree["suffix"]]
    return out


def _port_cache(specs, abstract) -> list:
    return [{k: tuple(s[k]) for k in s} for s in specs], \
        [{k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
          for k, v in d.items()} for d in abstract]


def _batch(shapes, specs):
    return ({k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
             for k, v in shapes.items()}, {k: tuple(v) for k, v in
                                           specs.items()})


def _jbatch(shapes, specs):
    return ({k: (tuple(v.shape), v.dtype.name) for k, v in shapes.items()},
            {k: tuple(v) for k, v in specs.items()})


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_jax(arch):
    jcfg0, tcfg0 = jconfigs.get_config(arch), tconfigs.get_config(arch)
    jm = JLMModel(jcfg0)
    jabs = jm.abstract_params()
    jstate = jax.eval_shape(jm.init_opt, jabs)
    tabs = tmodel.abstract_params(tcfg0)
    # the per-layer leaves as JAX shape structs, for ZeRO-1's rule
    jflat = {k: jax.ShapeDtypeStruct(tuple(v.shape), jnp.float32)
             for k, v in tabs.items()}
    scan_split = 0
    for shape, axes in MESHES:
        jmesh, tmesh = AbstractMesh(shape, axes), abstract_mesh(shape, axes)
        for zero1 in (False, True):
            for pure_dp in (False, True):
                jcfg = dataclasses.replace(jcfg0, zero1=zero1,
                                           pure_dp=pure_dp)
                tcfg = dataclasses.replace(tcfg0, zero1=zero1,
                                           pure_dp=pure_dp)
                what = (arch, shape, zero1, pure_dp)
                jps = jmodel.param_specs(jcfg, jabs, jmesh)
                tps = tmodel.param_specs(tcfg, tabs, tmesh)
                assert _stacked(tcfg, tps) == _jax_specs(jps), what
                jz = jmodel.zero1_specs(jcfg, jps, jabs, jmesh)
                tz = tmodel.zero1_specs(
                    tcfg, jax_paths(tps, tcfg, _stack_equal),
                    jax_paths(tabs, tcfg), tmesh)
                assert {k: tuple(v) for k, v in tz.items()} == \
                    _jax_specs(jz), what
                jo = jmodel._state_specs(
                    jcfg, jz if zero1 else jps, jstate)
                to = tmodel.opt_specs(tcfg, tps, tmesh, tabs)
                assert tuple(to.step) == tuple(jo.step) == ()
                if tcfg.optimizer == "adafactor":
                    for f in ("vr", "vc"):
                        assert {k: tuple(v) for k, v in
                                getattr(to, f).items()} == \
                            _jax_specs(getattr(jo, f)), (what, f)
                    continue
                assert to.m == to.v
                # AdamW's per-layer state: JAX's ZeRO-1 rule on each leaf
                want = jmodel.zero1_specs(
                    jcfg, {k: PartitionSpec(*v) for k, v in tps.items()},
                    jflat, jmesh) if zero1 else tps
                assert {k: tuple(v) for k, v in to.m.items()} == \
                    {k: tuple(v) for k, v in want.items()}, what
                # ... which is JAX's stacked spec wherever that leaves the
                # layer axis whole
                got, jspec = _stacked(tcfg, to.m), _jax_specs(jo.m)
                for k, w in jspec.items():
                    if k.startswith("pattern.") and w[0] is not None:
                        assert zero1, (what, k)
                        scan_split += 1
                    else:
                        assert got[k] == w, (what, k)
        for pure_dp in (False, True):
            for sct in (False, True):
                jcfg = dataclasses.replace(jcfg0, pure_dp=pure_dp,
                                           shard_cache_t=sct)
                tcfg = dataclasses.replace(tcfg0, pure_dp=pure_dp,
                                           shard_cache_t=sct)
                for B_ in (128, 3):
                    assert _batch(*tmodel.batch_specs(tcfg, tmesh, B_, 64)) \
                        == _jbatch(*jmodel.batch_specs(jcfg, jmesh, B_, 64))
                for sh in jconfigs.SHAPES.values():
                    tsh = tconfigs.SHAPES[sh.name]
                    assert dataclasses.asdict(tsh) == dataclasses.asdict(sh)
                    assert tconfigs.shape_applies(tcfg, tsh) == \
                        jconfigs.shape_applies(jcfg, sh)
                    jin, jsp = jmodel.input_specs(jcfg, sh, jmesh)
                    tin, tsp = tmodel.input_specs(tcfg, tsh, tmesh)
                    assert _batch(tin["batch"], tsp["batch"]) == \
                        _jbatch(jin["batch"], jsp["batch"])
                    if sh.kind != "decode":
                        continue
                    specs, shapes = _port_cache(tsp["cache"], tin["cache"])
                    assert specs == _per_layer(jcfg, jsp["cache"]), \
                        (arch, shape, pure_dp, sct, sh.name)
                    assert shapes == _per_layer(jcfg, jin["cache"])
                    assert tuple(tsp["pos"]) == tuple(jsp["pos"]) == ()
                    assert tuple(tin["pos"].shape) == ()
    # AdamW's layer axis splits in JAX wherever (2, 2)'s data axis
    # divides it; Adafactor's state is JAX's as it is
    reps = tcfg0.layer_kinds()[2]
    assert (scan_split > 0) == (tcfg0.optimizer == "adamw"
                                and reps % 2 == 0), scan_split


def test_shape_cells_equal_jax():
    cfgs = [tconfigs.get_config(a) for a in ARCHS]
    got = [(c.name, s.name) for c, s in tconfigs.cells(cfgs)]
    want = [(c.name, s.name) for c, s in jconfigs.cells(
        [jconfigs.get_config(a) for a in ARCHS])]
    assert got == want and len(got) == 40


# -- training on gloo ranks ----------------------------------------------------

# (variant, flags, mesh shape); every run starts from JAX's step 0
CASES2 = [
    ("qwen2-1.5b", dict(zero1=True), (2, 1)),
    ("gemma2-9b", {}, (2, 1)),
    ("qwen3-4b", dict(zero1=True, seq_parallel=True), (2, 1)),
    ("qwen2-vl-2b", {}, (2, 1)),
    ("heads3", dict(zero1=True), (2, 1)),
    ("qwen2-1.5b", dict(seq_parallel=True), (1, 2)),
    ("gemma2-9b", dict(seq_parallel=True), (1, 2)),
    ("qwen3-4b", {}, (1, 2)),
    ("qwen2-vl-2b", dict(seq_parallel=True), (1, 2)),
    ("heads3", dict(seq_parallel=True), (1, 2)),
    ("h12k3", dict(seq_parallel=True), (1, 2)),
    ("rwkv6-1.6b", dict(pure_dp=True, zero1=True), (2, 1)),
    ("recurrentgemma-2b", dict(pure_dp=True), (2, 1)),
    ("dbrx-132b", dict(pure_dp=True, zero1=True), (2, 1)),
    ("deepseek-v3-671b", dict(pure_dp=True), (2, 1)),
    ("dbrx-bf16", dict(pure_dp=True), (2, 1)),
    ("vocab511", dict(zero1=True, seq_parallel=True), (1, 2)),
    ("recurrentgemma-2b", {}, (1, 2)),
    ("rwkv6-1.6b", {}, (1, 2)),
    ("deepseek-mla", dict(seq_parallel=True), (1, 2)),
]
CASES4 = [
    ("qwen2-1.5b", dict(zero1=True, seq_parallel=True), (2, 2)),
    ("gemma2-9b", dict(zero1=True, seq_parallel=True), (2, 2)),
    ("qwen3-4b", dict(seq_parallel=True), (2, 2)),
    ("qwen2-vl-2b", dict(zero1=True), (2, 2)),
    ("heads3", dict(zero1=True, seq_parallel=True), (2, 2)),
    ("qwen2-1.5b", dict(seq_parallel=True), (1, 4)),
    ("gemma2-9b", {}, (1, 4)),
    ("qwen3-4b", dict(seq_parallel=True), (1, 4)),
    ("qwen2-vl-2b", {}, (1, 4)),
    ("h12", dict(seq_parallel=True), (1, 4)),
    ("heads3", {}, (1, 4)),
    ("recurrentgemma-2b", dict(zero1=True, seq_parallel=True), (2, 2)),
    ("rwkv6-1.6b", dict(seq_parallel=True), (1, 4)),
    ("rwkv-hd32", {}, (1, 4)),
    ("deepseek-mla", dict(zero1=True, seq_parallel=True), (2, 2)),
]
# (variant, flags, mesh shape): 'model' above 1 for RWKV-6 where it
# divides d_model but not d_ff (the MoE kinds over 'model' and their
# experts over 'data': `test_torch_lm_mesh_moe.py`)
REFUSED = [("rwkv-f129", {}, (1, 2))]
# (variant, flags, mesh shape): a mesh model's fresh shards against the
# one-device draw
INIT = [("h12k3", {}, (1, 2)), ("qwen2-1.5b", dict(zero1=True), (2, 2))]
VARIANTS = sorted({c[0] for c in CASES2 + CASES4})
LAUNCH = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
          "--model-parallel", "2", "--steps", "2", "--batch", "4",
          "--seq", "32"]


def _case_id(c):
    variant, flags, shape = c
    return "-".join([variant, "x".join(map(str, shape))]
                    + sorted(k for k, v in flags.items() if v))


def _jbatch_at(cfg, step):
    return {k: jnp.asarray(x) for k, x in jbatch_for(cfg, B, S, step,
                                                     0).items()}


@pytest.fixture(scope="module")
def jax_init(tmp_path_factory):
    """Per variant: JAX's model and its step 0, also as a checkpoint
    directory."""
    out = {}
    for v in VARIANTS:
        cfg = smoke_cfg(jconfigs, v)
        jm = JLMModel(cfg)
        params = jm.init_params(jax.random.key(0))
        opt = jm.init_opt(params)
        d = tmp_path_factory.mktemp(f"jax0-{v}")
        save_checkpoint(str(d), 0, (params, opt))
        out[v] = dict(cfg=cfg, jm=jm, state0=(params, opt), ckpt0=d)
    return out


def _runs(jax_init, tmp_path_factory, cases):
    runs = []
    for c in cases:
        d = tmp_path_factory.mktemp(_case_id(c))
        shutil.copytree(jax_init[c[0]]["ckpt0"], d, dirs_exist_ok=True)
        runs.append(dict(variant=c[0], flags=c[1], shape=c[2],
                         steps=[1, 2], ckpt=str(d)))
    return runs


@pytest.fixture(scope="module")
def spawned(jax_init, tmp_path_factory):
    """The two groups of gloo ranks (2, then 4), run in a thread while
    the JAX side compiles: {world: (runs, per-rank results)}."""
    runs2 = _runs(jax_init, tmp_path_factory, CASES2)
    runs2 += [dict(variant=c[0], flags=c[1], shape=c[2], steps=[1],
                   ckpt=None) for c in REFUSED]
    runs2 += [dict(variant=c[0], flags=c[1], shape=c[2], init=True)
              for c in INIT if c[2] == (1, 2)]
    runs4 = _runs(jax_init, tmp_path_factory, CASES4)
    runs4 += [dict(variant=c[0], flags=c[1], shape=c[2], init=True)
              for c in INIT if c[2] == (2, 2)]
    # the (2, 2) qwen2 run's step 2 resumed on (1, 4) to step 3; then the
    # launcher
    runs4.append(dict(runs4[0], shape=(1, 4), steps=[3]))
    runs4.append(dict(argv=LAUNCH))
    store = tmp_path_factory.mktemp("store")
    out = {}

    def work():
        try:
            for world, runs in ((2, runs2), (4, runs4)):
                out[world] = (runs, run_ranks(train_cases, world, runs,
                                              store_dir=str(store),
                                              timeout_s=240))
        except BaseException as e:       # raised by the tests that wait
            out["error"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    return t, out


@pytest.fixture(scope="module")
def jax_ref(jax_init, spawned):
    """Per variant: `train_step` (jit) and its step 1 on one device."""
    out = {}
    for v, r in jax_init.items():
        step = jax.jit(r["jm"].train_step)
        p1, o1, m1 = step(*r["state0"], _jbatch_at(r["cfg"], 0))
        out[v] = dict(r, step=step, state1=(p1, o1),
                      hist1={k: float(x) for k, x in m1.items()})
    return out


def _joined(spawned, world):
    t, out = spawned
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


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what,
                               atol=tol * max(np.abs(want).max(), 1e-30))


# rwkv6's wkv recurrence carries the sums' order further into its
# gradients (`test_torch_train.py::test_rwkv6_f32_gradients_are_rounding_
# of_f64`; `chip_smoke.py`'s TOL_TRAIN_RWKV): its state within 1e-4
STATE_TOL = {"rwkv6-1.6b-smoke": 1e-4}


def _check_step(ref, ckpt, step, hist, before):
    """The mesh's step `step` (its checkpoint, its history on every rank)
    against JAX's one step from the same state, `before` ((params, opt),
    JAX's or read from the mesh's checkpoint of the step before)."""
    cfg = ref["cfg"]
    hist = [[{k: v for k, v in h.items() if k != "sec"} for h in r]
            for r in hist]
    assert all(h == hist[0] for h in hist), "histories differ over ranks"
    assert [h["step"] for h in hist[0]] == [step]
    p, o, m = ref["step"](*before, _jbatch_at(cfg, step - 1))
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(hist[0][0][k], float(m[k]), rtol=TOL,
                                   atol=1e-30, err_msg=k)
    (params, opt), _, got_step = restore_checkpoint(ckpt, (p, o), step)
    assert got_step == step and int(opt.step) == step
    got_o, want_o = _paths(opt), _paths(o)
    got_p, want_p = _paths(params), _paths(p)
    if cfg.optimizer == "adafactor":
        if cfg.grad_accum_dtype == "float32":
            for k in want_o:
                _close(got_o[k], want_o[k], TOL, k)
            for k in want_p:
                _close(got_p[k], want_p[k], TOL, k)
            return
        # bf16 sums: a gradient entry one bf16 step (2^-8 of it) apart,
        # its square 2^-7, a factor's mean of them as much; the update u
        # (JAX's, from the weights it moved) as much again
        for k in want_o:
            _close(got_o[k], want_o[k], 2.0 ** -6, k)
        p0 = _paths(before[0])
        for k, w in want_p.items():
            u = np.abs(np.asarray(w, np.float32)
                       - np.asarray(p0[k], np.float32)).max()
            _close(got_p[k], w, 0, k) if u == 0 else np.testing.assert_allclose(
                np.asarray(got_p[k], np.float32), np.asarray(w, np.float32),
                rtol=0, atol=TOL * np.abs(w).max() + 2.0 ** -5 * u,
                err_msg=k)
        return
    tol = STATE_TOL.get(cfg.name, TOL)
    for k in want_o:
        _close(got_o[k], want_o[k], 2 * tol if k.startswith("v.") else tol,
               k)
    # the weights: AdamW's update is about lr sign(g) (the docstring), g
    # here the bias-corrected first moment (step 1's clipped gradient)
    for k, w in want_p.items():
        g = np.abs(np.asarray(want_o["m." + k])) / (1 - 0.9 ** step)
        bar = 1e-6 + LR * np.minimum(2.0, 2 * tol * g.max() / (g + EPS))
        diff = np.abs(np.asarray(got_p[k], np.float32)
                      - np.asarray(w, np.float32))
        assert (diff <= bar).all(), (k, float((diff - bar).max()))


def _check_run(ref, run, hist):
    """Both steps of a run: step 1 from JAX's step 0, step 2 from the
    mesh's own step 1."""
    for h, w in zip(hist[0][0], [ref["hist1"]]):
        for k in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(h[k], w[k], rtol=TOL, atol=1e-30)
    _check_step(ref, run["ckpt"], 1, [r[0] for r in hist],
                restore_checkpoint(str(ref["ckpt0"]), ref["state1"], 0)[0])
    before, _, _ = restore_checkpoint(run["ckpt"], ref["state1"], 1)
    _check_step(ref, run["ckpt"], 2, [r[1] for r in hist], before)


@pytest.mark.parametrize("case", CASES2, ids=[_case_id(c) for c in CASES2])
def test_train_on_two_ranks_matches_jax(case, jax_ref, world2):
    runs, got = world2
    i = CASES2.index(case)
    _check_run(jax_ref[case[0]], runs[i], [g[i] for g in got])


@pytest.mark.parametrize("case", CASES4, ids=[_case_id(c) for c in CASES4])
def test_train_on_four_ranks_matches_jax(case, jax_ref, world4):
    runs, got = world4
    i = CASES4.index(case)
    _check_run(jax_ref[case[0]], runs[i], [g[i] for g in got])


@pytest.mark.parametrize("case", REFUSED, ids=[_case_id(c) for c in REFUSED])
def test_uncovered_meshes_raise_naming_a9(case, world2):
    _, got = world2
    i = len(CASES2) + REFUSED.index(case)
    for g in got:
        assert isinstance(g[i], str) and "ROADMAP A9" in g[i], g[i]
    assert "tensor parallelism" in got[0][i]


@pytest.mark.parametrize("case", INIT, ids=[_case_id(c) for c in INIT])
def test_mesh_init_draws_the_one_device_weights(case, request):
    """Each layer drawn whole and cut to this rank's shards before the
    next is drawn: the shards are the one-device draw's pieces, bit for
    bit."""
    world = case[2][0] * case[2][1]
    runs, got = request.getfixturevalue(f"world{world}")
    i = [r.get("init") and (r["variant"], r["shape"]) for r in runs].index(
        (case[0], case[2]))
    assert [g[i] for g in got] == [0.0] * world


def test_checkpoint_resumes_on_another_mesh_shape(jax_ref, world4):
    """A (2, 2) run's step-2 checkpoint, resumed on (1, 4): its step 3 as
    JAX's step from the same checkpoint."""
    runs, got = world4
    i = next(j for j, r in enumerate(runs) if r.get("steps") == [3])
    ref = jax_ref["qwen2-1.5b"]
    before, _, _ = restore_checkpoint(runs[i]["ckpt"], ref["state1"], 2)
    _check_step(ref, runs[i]["ckpt"], 3, [g[i][0] for g in got], before)


def test_jax_resumes_a_mesh_checkpoint(jax_ref, world2, tmp_path):
    """`repro.train.train` resumes the (2, 1) qwen2 run's step 2: its step
    3 as JAX's `train_step` from the same checkpoint."""
    runs, _ = world2
    shutil.copytree(runs[0]["ckpt"], tmp_path, dirs_exist_ok=True)
    ref = jax_ref["qwen2-1.5b"]
    _, hist = jtrain(ref["cfg"], steps=3, batch=B, seq=S,
                     ckpt_dir=str(tmp_path), log_every=1)
    before, _, _ = restore_checkpoint(runs[0]["ckpt"], ref["state1"], 2)
    _, _, m = ref["step"](*before, _jbatch_at(ref["cfg"], 2))
    assert [h["step"] for h in hist] == [3]
    for k in ("loss", "aux", "grad_norm"):
        np.testing.assert_allclose(hist[0][k], float(m[k]), rtol=TOL,
                                   atol=1e-30, err_msg=k)


def test_launcher_builds_the_mesh_under_four_ranks(world4):
    _, got = world4
    printed = [g[-1] for g in got]
    assert "arch=qwen2-1.5b-smoke mesh={'data': 2, 'model': 2} " \
        "backend=gloo device=cpu" in printed[0]
    assert "final loss:" in printed[0]
    assert all(p == "" for p in printed[1:])


# (WORLD_SIZE, LOCAL_WORLD_SIZE or None, LOCAL_RANK, cards on this host,
#  device asked for, the placement wanted)
PLACES = [(256, 8, 5, 8, None, ("cuda:5", None)),
          (512, 8, 7, 8, "cuda", ("cuda:7", None)),
          (4, 4, 3, 4, None, ("cuda:3", None)),
          (4, 4, 3, 1, None, ("cuda:0", "gloo")),
          (256, 16, 9, 8, None, ("cuda:1", "gloo")),
          (4, None, 2, 1, None, ("cuda:0", "gloo")),
          (256, 8, 5, 8, "cpu", ("cpu", None))]


@pytest.mark.parametrize("place", PLACES)
def test_placement_decides_the_backend_from_this_host(place, monkeypatch):
    """NCCL (None) wherever this host's ranks have a card each, however
    many hosts the world spans; gloo where ranks share a card. No group is
    joined."""
    world, on_host, local, cards, device, want = place
    monkeypatch.setenv("WORLD_SIZE", str(world))
    monkeypatch.setenv("LOCAL_RANK", str(local))
    if on_host is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", str(on_host))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert placement(device) == want
