"""The port's training checkpoints against the JAX package's, on the CPU.

- A bf16 model's (params, AdamW state) round-trips bit for bit.
- The port writes JAX's leaves in JAX's `tree_flatten` order, the pattern
  axis stacked and bf16 as a uint16 view: for the same weights and state
  the two packages' manifests are equal but for `time` (treedef, shapes,
  dtypes and checksums), and JAX restores the port's bf16 leaves.
- Cross-package resume, both ways (smollm-360m smoke, f32): one package
  trains to step 2 with a checkpoint; from copies of the directory the
  port's `train` and JAX's `train` each go on to step 4. Their loss and
  grad-norm histories agree within 1e-5 relative, and the final weights
  within 1e-5 of each leaf's max |value| (f32 sums in another order; the
  resumed steps' moments are not AdamW's first, sign-like ones). The same
  for gemma2-9b's smoke config (window 16, the post-norm leaves pn1/pn2,
  the untied unembed), whose manifest names those leaves. The manifests
  of rwkv6-1.6b (nested leaves) and recurrentgemma-2b (f32 leaves in a
  bf16 model, a suffix) equal JAX's too, and so do those of dbrx-132b
  (Adafactor's factors of the stacked 4-D expert leaves, the f32 router
  in a bf16 model), qwen2-vl-2b and musicgen-large (an `embed` leaf the
  loss does not read). dbrx's smoke config resumes across the packages
  both ways too (Adafactor over the 4-D expert leaves), with its
  gradients accumulated in f32 there: in bf16 the two packages' f32
  gradients, equal to 1e-6, round to neighbouring bf16 values at a few
  entries, and Adafactor carries such a flip (2^-8 of the entry) into
  the weights at about 3e-6, past this file's bar;
  tests/test_torch_train.py holds the bf16 accumulation itself.
- `fail_at` restart (the counterpart of tests/test_checkpoint.py::
  test_train_restart_continues) and the weight and state conversions.
"""
import dataclasses
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
import repro.optim as jopt  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train import train as jtrain  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.data import batch_for  # noqa: E402
from repro_torch.models import LMModel  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    opt_state_from_jax, opt_state_to_jax, params_from_jax, params_to_jax,
    unstack_jax_tree)
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import train as ttrain  # noqa: E402
from repro_torch.train.loop import (restore_train_state,  # noqa: E402
                                    save_train_state)

CPU = dict(device="cpu")
TOL = 1e-5
RUN = dict(batch=2, seq=32, ckpt_every=2, log_every=1)


def _cfgs(name, **kw):
    """Both packages' smoke configs of `name` with 2 layers in its repeated
    pattern (at least one repeat: gemma2's local and global alternate),
    between its prefix and suffix."""
    out = []
    for c in (tconfigs, jconfigs):
        cfg = c.smoke_config(c.get_config(name))
        reps = max(1, 2 // len(cfg.pattern))
        out.append(dataclasses.replace(
            cfg, n_layers=len(cfg.prefix) + reps * len(cfg.pattern)
            + len(cfg.suffix), repeats=reps, **kw))
    return tuple(out)


def _bits_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k].cpu(), b[k].cpu()), k


def test_bf16_train_state_round_trips_bit_for_bit(tmp_path):
    tcfg, _ = _cfgs("qwen2-1.5b", dtype="bfloat16")
    model = LMModel(tcfg, seed=1, **CPU)
    opt, _ = model.train_step(model.init_opt(), batch_for(tcfg, 2, 32, 0))
    save_train_state(str(tmp_path), 1, model, opt)
    other = LMModel(tcfg, seed=2, **CPU)
    got, step = restore_train_state(str(tmp_path), other, other.init_opt())
    assert step == 1
    _bits_equal(dict(other.params.state_dict()),
                dict(model.params.state_dict()))
    assert got.step.dtype == torch.int32 and int(got.step) == 1
    _bits_equal(got.m, opt.m)
    _bits_equal(got.v, opt.v)
    man = json.loads((tmp_path / "step_0000000001" / "manifest.json"
                      ).read_text())
    dtypes = {f["dtype"] for f in man["files"].values()}
    assert dtypes == {"bfloat16", "float32", "int32"}


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_manifest_equals_jax_and_jax_reads_bf16(tmp_path, optimizer):
    _manifests_equal(tmp_path, "qwen3-4b", optimizer)


@pytest.mark.parametrize("name,optimizer", [
    ("rwkv6-1.6b", "adamw"), ("rwkv6-1.6b", "adafactor"),
    ("recurrentgemma-2b", "adafactor")])
def test_recurrent_manifests_equal_jax(tmp_path, name, optimizer):
    """The same for the recurrent families' trees: RWKV's nested leaves
    (mix.mu.r, mix.lora_b.w), the f32 leaves of a bf16 model (w0, u; ba,
    bi, lam) and recurrentgemma's unstacked suffix, in JAX's leaf order."""
    man = _manifests_equal(tmp_path, name, optimizer)
    assert {"float32", "bfloat16"} <= {f["dtype"]
                                       for f in man["files"].values()}


@pytest.mark.parametrize("name", ["dbrx-132b", "qwen2-vl-2b",
                                  "musicgen-large"])
def test_moe_and_embedding_input_manifests_equal_jax(tmp_path, name):
    """dbrx's tree (the router f32 [d, E] and the experts [E, d, F]
    stacked to [L, E, d, F]; Adafactor's row and column factors of those
    leaves) and the embedding-input configs' (their `embed` leaf kept, as
    in JAX), each with its config's optimizer."""
    tcfg, _ = _cfgs(name)
    man = _manifests_equal(tmp_path, name, tcfg.optimizer)
    if tcfg.moe is not None:
        shapes = {tuple(f["shape"]) for f in man["files"].values()}
        L, E, d, F = 2, tcfg.moe.n_experts, tcfg.d_model, \
            tcfg.moe.d_ff_expert
        assert {(L, E, d, F), (L, E, F, d), (L, d, E), (L, E, d),
                (L, E, F)} <= shapes


@pytest.mark.parametrize("first", ["jax", "port"])
def test_dbrx_resume_across_packages(tmp_path, first):
    _check_resumed(*sum(_run_both(tmp_path, first, "dbrx-132b",
                                  grad_accum_dtype="float32"), ()))


def _manifests_equal(tmp_path, name, optimizer):
    """JAX's weights and fresh optimizer state of `name` in bf16,
    checkpointed by each package: the manifests equal but for `time`, and
    JAX restores the port's leaves. Returns the port's manifest."""
    tcfg, jcfg = _cfgs(name, dtype="bfloat16", optimizer=optimizer)
    jm = JLMModel(jcfg)
    jp = jax.jit(jm.init_params)(jax.random.key(0))
    jstate = jm.init_opt(jp)
    jckpt.save_checkpoint(str(tmp_path / "j"), 3, (jp, jstate))
    model = LMModel(tcfg, **CPU)
    model.params.load_state_dict(
        params_from_jax(jax.tree.map(np.asarray, jp), tcfg))
    opt = opt_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg)
    save_train_state(str(tmp_path / "t"), 3, model, opt)
    a, b = (json.loads((tmp_path / d / "step_0000000003" / "manifest.json"
                        ).read_text()) for d in ("t", "j"))
    assert a.pop("time") > 0 and b.pop("time") > 0
    assert a == b
    got, _, _ = jckpt.restore_checkpoint(str(tmp_path / "t"), (jp, jstate))
    for x, y in zip(jax.tree.leaves(got), jax.tree.leaves((jp, jstate))):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(np.asarray(x, np.float32),
                                      np.asarray(y, np.float32))
    return a


def _run_both(root, first, name="smollm-360m", **kw):
    """`first` ("jax" or "port") trains `name`'s smoke config (with `kw`
    changed) to step 2 with a checkpoint; then both packages resume copies
    of it to step 4. Returns ((port history, port weights), (JAX history,
    JAX weights))."""
    tcfg, jcfg = _cfgs(name, **kw)
    base = root / "base"
    if first == "jax":
        jtrain(jcfg, steps=2, ckpt_dir=str(base), **RUN)
    else:
        ttrain(tcfg, steps=2, ckpt_dir=str(base), **RUN, **CPU)
    for d in ("t", "j"):
        shutil.copytree(base, root / d)
    tparams, thist = ttrain(tcfg, steps=4, ckpt_dir=str(root / "t"), **RUN,
                            **CPU)
    jparams, jhist = jtrain(jcfg, steps=4, ckpt_dir=str(root / "j"), **RUN)
    return ((thist, dict(tparams.state_dict())),
            (jhist, {k: np.asarray(v) for k, v in
                     unstack_jax_tree(jparams, tcfg).items()}))


def _check_resumed(thist, tw, jhist, jw):
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] == [3, 4]
    for t, j in zip(thist, jhist):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(t[key], j[key], rtol=TOL)
    assert set(tw) == set(jw)
    for k, w in jw.items():
        np.testing.assert_allclose(tw[k].numpy(), w, rtol=0, err_msg=k,
                                   atol=TOL * np.abs(w).max())


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(tmp_path, first):
    _check_resumed(*sum(_run_both(tmp_path, first), ()))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_gemma2_resume_across_packages(tmp_path, first):
    """gemma2's tree (post-norm leaves pn1/pn2, the untied unembed, a local
    and a global layer stacked on the pattern axis) resumes across the
    packages both ways, as smollm-360m's does; the first package's
    manifest names those leaves."""
    runs = _run_both(tmp_path, first, "gemma2-9b")
    _check_resumed(*sum(runs, ()))
    man = (tmp_path / "base" / "step_0000000002" / "manifest.json"
           ).read_text()
    for leaf in ("pn1", "pn2", "unembed"):
        assert leaf in man, leaf


def test_train_restart_continues(tmp_path):
    tcfg, _ = _cfgs("smollm-360m")
    tcfg = dataclasses.replace(tcfg, n_layers=1, repeats=1)
    with pytest.raises(RuntimeError, match="injected failure at step 4"):
        ttrain(tcfg, steps=6, batch=2, seq=32, ckpt_dir=str(tmp_path),
               ckpt_every=2, log_every=1, fail_at=4, **CPU)
    assert tckpt.latest_step(str(tmp_path)) == 4
    params, hist = ttrain(tcfg, steps=6, batch=2, seq=32,
                          ckpt_dir=str(tmp_path), ckpt_every=2, log_every=1,
                          **CPU)
    assert [h["step"] for h in hist] == [5, 6]
    assert np.isfinite(hist[-1]["loss"])
    # the restarted run's weights are those of one run without the failure
    ref, _ = ttrain(tcfg, steps=6, batch=2, seq=32, log_every=1, **CPU)
    _bits_equal(dict(params.state_dict()), dict(ref.state_dict()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_conversions_round_trip(dtype):
    tcfg, jcfg = _cfgs("qwen2-1.5b", dtype=dtype)
    jp = jax.tree.map(np.asarray,
                      JLMModel(jcfg).init_params(jax.random.key(5)))
    sd = params_from_jax(jp, tcfg)
    back = params_to_jax(sd, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for x, y in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert x.dtype == np.float32 and x.shape == y.shape
        np.testing.assert_array_equal(x, np.asarray(y, np.float32))
    rng = np.random.default_rng(0)
    for init in (jopt.adamw_init, jopt.adafactor_init):
        state = jax.tree.map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32)
            if a.dtype == np.float32 else np.asarray(7, np.int32),
            init(jax.tree.map(jnp.asarray, jp)))
        port = opt_state_from_jax(state, tcfg)
        assert int(port.step) == 7
        again = opt_state_to_jax(port, tcfg)
        assert type(again).__name__ == type(state).__name__
        assert jax.tree.structure(tuple(again)) == jax.tree.structure(
            tuple(state))
        for x, y in zip(jax.tree.leaves(tuple(again)),
                        jax.tree.leaves(tuple(state))):
            np.testing.assert_array_equal(x, y)
