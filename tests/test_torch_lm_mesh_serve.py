"""repro_torch serving on a mesh against the JAX package, on the CPU.

`LMModel(cfg, mesh=).prefill_step` / `.decode_step` / `.init_cache` and
`launch.serve.serve(..., mesh=)` on gloo CPU ranks (`run_ranks`: one
group of 2 ranks and one of 4, spawned in a thread while the JAX side
compiles; rank bodies in `test_torch_lm_mesh_workers.py`, which imports
no JAX), each rank holding its shards of the weights that JAX's
`init_params(jax.random.key(seed))` draws (`params_from_jax`, then
`load_full`), the smoke configs in f32. Against JAX's one device:

- every decode step's logits (the prompt stepped in, then the greedy
  tokens), on every rank, against JAX's `decode_step` (jit) on the same
  sequence, within `test_torch_serve.py`'s 1e-5;
- `prefill_step`'s last logits against JAX's `prefill_step`, and each
  rank's (k, v) (or state) against the same pieces of JAX's: this rank's
  rows and kv heads (all of them where 'model' does not divide K);
- each rank's decode cache after the last step against
  `shard_of(JAX's cache, cache_specs)`: heads over 'model', or T over
  'model' with `shard_cache_t` (where 'model' divides the layer's T),
  with the f32 and the int8 cache (codes within one step, scales within
  1e-5, as `test_int8_decode_step_matches_jax`); the pieces' shapes are
  the specs' (no rank allocates a whole T), and no collective of the
  steps returns a tensor as large as one layer's whole cache;
- the greedy tokens equal to `repro.launch.serve.serve`'s, and the same
  on every rank.

Cases: qwen2-1.5b on (2, 2), on (1, 2) with `seq_parallel` (the prefill
takes its last position from the last 'model' rank) and on (1, 4) with
`shard_cache_t` (T over 4 ranks); 12 q heads over 2 kv heads on (1, 4)
(3 a rank over one kv head, the cache's K whole) and over 3 on (1, 2)
(kv heads 0,0,0,0,1,1); gemma2-9b (window 16, passed by the 20
positions, so its local caches roll; soft-caps) on (1, 2), and with the
int8 cache and `shard_cache_t` on (2, 2) and on (1, 2) at T 19, which
'model' does not divide for the global layers (whole there, split for
the local layers' 16); qwen2-vl-2b (M-RoPE; embedding inputs, the
generated tokens' rows from the vocabulary-sharded `embed`) on (2, 2);
a vocabulary of 511 that 'model' 2 leaves whole; a batch of 3 that
(2, 1) does not divide (every rank runs every row); `pure_dp` on (2, 1)
for rwkv6, recurrentgemma, dbrx (MoE: routing over the gathered rows)
and deepseek (MLA, MoE); the MoE kinds over 'model' and their experts
over 'data' are in `test_torch_lm_mesh_moe.py`. The recurrent kinds and
MLA over 'model', each rank's state its piece in `cache_specs`' layout
after the prefill too:
recurrentgemma on (1, 2) and with `zero1` and `seq_parallel` on (2, 2);
rwkv6 on (1, 2) and (1, 4), and with 3 wkv heads of 32 at d_model 96
on (1, 4), where 'model' cuts every head (the state whole on every rank);
deepseek's MLA over a dense MLP on (1, 2) and (2, 2) (heads over
'model', the latent cache whole) and with `shard_cache_t` on (1, 2)
(the latent's T over 'model'). `serve(mesh=)` of an RWKV-6 whose d_ff
'model' 2 does not divide beside a d_model that it does still raises
naming ROADMAP A9, and `launch.serve.main` under 2 ranks builds its
`make_local_mesh()`.
"""
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.configs as jconfigs  # noqa: E402
from repro.data.pipeline import batch_for as jbatch_for  # noqa: E402
from repro.launch.serve import serve as j_serve  # noqa: E402
from repro.models import LMModel as JLMModel  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
import repro_torch.configs as tconfigs  # noqa: E402
import repro_torch.models.model as tmodel  # noqa: E402
import repro_torch.models.transformer as ttfm  # noqa: E402
from repro_torch.core.mesh import run_ranks  # noqa: E402
from repro_torch.launch.mesh import abstract_mesh  # noqa: E402
from repro_torch.models import shard as sh  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from test_torch_lm_mesh_workers import serve_cases, smoke_cfg  # noqa: E402
from test_torch_serve import STATES, _jlayer  # noqa: E402

TOL = 1e-5
AXES = ("data", "model")

# (JAX run: variant, B, prompt, generated, seed) -> the JAX side is run
# once for each
RUNS = {
    "qwen2": ("qwen2-1.5b", 4, 10, 6, 21),
    "qwen2-b3": ("qwen2-1.5b", 3, 10, 6, 22),
    "h12": ("h12", 4, 10, 6, 23),
    "h12k3": ("h12k3", 4, 10, 6, 24),
    "gemma2": ("gemma2-9b", 2, 12, 8, 25),
    "gemma2-int8": ("gemma2-int8", 2, 12, 8, 26),
    "gemma2-int8-t19": ("gemma2-int8", 2, 12, 7, 27),
    "qwen2-vl": ("qwen2-vl-2b", 4, 10, 6, 28),
    "vocab511": ("vocab511", 4, 10, 6, 29),
    "rwkv6": ("rwkv6-1.6b", 4, 8, 4, 30),
    "recurrentgemma": ("recurrentgemma-2b", 4, 8, 4, 31),
    "dbrx": ("dbrx-132b", 4, 8, 4, 32),
    "deepseek": ("deepseek-v3-671b", 4, 8, 4, 33),
    "deepseek-mla": ("deepseek-mla", 4, 8, 4, 34),
    "rwkv-hd32": ("rwkv-hd32", 4, 8, 4, 35),
}
# (JAX run, the port's flags, mesh shape)
CASES2 = [
    ("qwen2", dict(seq_parallel=True), (1, 2)),
    ("h12k3", {}, (1, 2)),
    ("gemma2", {}, (1, 2)),
    ("gemma2-int8-t19", dict(shard_cache_t=True), (1, 2)),
    ("vocab511", {}, (1, 2)),
    ("qwen2-b3", {}, (2, 1)),
    ("rwkv6", dict(pure_dp=True), (2, 1)),
    ("recurrentgemma", dict(pure_dp=True), (2, 1)),
    ("dbrx", dict(pure_dp=True), (2, 1)),
    ("deepseek", dict(pure_dp=True), (2, 1)),
    ("recurrentgemma", {}, (1, 2)),
    ("rwkv6", {}, (1, 2)),
    ("deepseek-mla", {}, (1, 2)),
    ("deepseek-mla", dict(shard_cache_t=True), (1, 2)),
]
CASES4 = [
    ("qwen2", {}, (2, 2)),
    ("qwen2", dict(shard_cache_t=True), (1, 4)),
    ("h12", {}, (1, 4)),
    ("gemma2-int8", dict(shard_cache_t=True), (2, 2)),
    ("qwen2-vl", {}, (2, 2)),
    ("recurrentgemma", dict(zero1=True, seq_parallel=True), (2, 2)),
    ("rwkv6", {}, (1, 4)),
    ("rwkv-hd32", {}, (1, 4)),
    ("deepseek-mla", {}, (2, 2)),
]
# (variant, flags, mesh shape, B, prompt, generated): RWKV-6 where 'model'
# divides d_model but not d_ff, the one LM case that still waits for A9
REFUSED = ("rwkv-f129", {}, (1, 2), 4, 8, 4)
LAUNCH = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu", "--batch",
          "2", "--prompt-len", "4", "--gen", "3"]


def _case_id(c):
    run, flags, shape = c
    return "-".join([run, "x".join(map(str, shape))]
                    + sorted(k for k, v in flags.items() if v))


class _At:
    """A mesh's shape and one rank's coordinate: what `shard.shard_of`
    reads."""

    def __init__(self, shape, coord):
        self.axis_names = AXES
        self.shape = dict(zip(AXES, shape))
        self.coord = tuple(coord)

    def index(self, dims) -> int:
        dims = dims if isinstance(dims, tuple) else (dims,)
        idx = 0
        for d in dims:
            idx = idx * self.shape[d] + self.coord[AXES.index(d)]
        return idx


def _jax_params(name, runs=RUNS):
    """(JAX config, JAX model, the weights `repro.launch.serve.serve`
    draws, the port's whole state) of a JAX run."""
    variant, _, _, _, seed = runs[name]
    jcfg = smoke_cfg(jconfigs, variant)
    jm = JLMModel(jcfg)
    jp = jm.init_params(jax.random.key(seed))
    state = params_from_jax(jax.tree.map(np.asarray, jp),
                            smoke_cfg(tconfigs, variant))
    return jcfg, jm, jp, state


def _runs(params, cases):
    out = []
    for run, flags, shape in cases:
        variant, B, P, G, seed = RUNS[run]
        out.append(dict(variant=variant, flags=flags, shape=shape, B=B,
                        P=P, G=G, seed=seed, state=params[run][3]))
    return out


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The JAX weights of every run, and the two groups of gloo ranks (4,
    then 2), run in a thread that starts each group as soon as its
    weights are drawn, while the JAX side draws the rest and compiles:
    (thread, {world: per-rank results}, {run: `_jax_params`})."""
    store = tmp_path_factory.mktemp("store")
    params, out = {}, {}
    ready = {4: threading.Event(), 2: threading.Event()}
    variant, flags, shape, B, P, G = REFUSED
    extra = {2: [dict(variant=variant, flags=flags, shape=shape, B=B, P=P,
                      G=G, seed=0, serve_only=True),
                 dict(argv=LAUNCH)], 4: []}
    cases = {4: CASES4, 2: CASES2}

    def work():
        try:
            for world in (4, 2):
                ready[world].wait()
                out[world] = run_ranks(
                    serve_cases, world,
                    _runs(params, cases[world]) + extra[world],
                    store_dir=str(store), timeout_s=240)
        except BaseException as e:       # raised by the tests that wait
            out["error"] = e

    t = threading.Thread(target=work, daemon=True)
    t.start()
    for world in (4, 2):
        for run, _, _ in cases[world]:
            if run not in params:
                params[run] = _jax_params(run)
        ready[world].set()
    return t, out, params


@pytest.fixture(scope="module")
def jax_ref(spawned):
    """Per JAX run: `repro.launch.serve.serve`'s tokens, JAX's
    `prefill_step` on the prompts, and its `decode_step` (jit) logits at
    every position of the prompts and those tokens, with the cache after
    the last."""
    return {name: _jax_run(spawned[2][name], *RUNS[name][1:])
            for name in RUNS}


def _jax_run(params, B, P, G, seed) -> dict:
    """One JAX run (`params`: `_jax_params`' tuple) on B prompts of P
    tokens and G generated ones."""
    jcfg, jm, jp, _ = params
    toks, _ = j_serve(jcfg, batch=B, prompt_len=P, gen=G, seed=seed)
    toks = np.asarray(toks)
    batch = jbatch_for(jcfg, B, P, 0, seed)
    key = "embeddings" if jcfg.embed_inputs else "tokens"
    inputs = {k: jnp.asarray(v) for k, v in batch.items()
              if k in (key, "positions")}
    last, pcache = jax.jit(jm.prefill_step)(jp, inputs)
    more = np.asarray(jp["embed"])[toks] if jcfg.embed_inputs else toks
    seq = np.concatenate([batch[key], more], axis=1)
    cache = jtfm.init_cache(jcfg, B, P + G)
    step = jax.jit(jm.decode_step)
    logits = []
    for t in range(P + G):
        lg, cache = step(jp, cache, {key: jnp.asarray(seq[:, t:t + 1])},
                         jnp.asarray(t, jnp.int32))
        logits.append(np.asarray(lg))
    return dict(cfg=jcfg, toks=toks, last=np.asarray(last), prefill=pcache,
                logits=logits, cache=cache)


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


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _piece(full, spec, at):
    return sh.shard_of(torch.from_numpy(np.array(full)), spec, at).numpy()


def _leaf_close(got, want, name, what):
    """One cache leaf: a recurrent state within TOL of its max, int8 codes
    within one step, the rest (k / v, int8 scales, MLA's latent) within
    TOL."""
    if got.dtype == np.int8:
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() \
            <= 1, what
    elif name in STATES:
        np.testing.assert_allclose(
            got, want, rtol=0, err_msg=what,
            atol=TOL * max(1.0, float(np.abs(want).max())))
    elif name.endswith("_scale"):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=0, err_msg=what)
    else:
        _close(got, want, what)


def _prefill_spec(tcfg, shape, B, leaf_ndim, name):
    """This rank's piece of a prefill cache leaf: its rows (`_dp_or_none`)
    and, for attention's k / v over 'model' above 1, its kv heads where
    'model' divides them."""
    mesh = abstract_mesh(shape, AXES)
    dp = tmodel._dp_or_none(mesh, B, tcfg)
    heads = None
    if name in ("k", "v") and not tcfg.pure_dp and shape[1] > 1 \
            and tcfg.n_kv_heads % shape[1] == 0:
        heads = "model"
    return sh.P(dp, None, heads, None)[:leaf_ndim] if name in ("k", "v") \
        else sh.P(dp, *([None] * (leaf_ndim - 1)))


def _check_case(case, got, ref, runs=RUNS):
    """Every rank of one case against JAX's one device (a recurrent
    state after the prefill as `serving_cache_specs` lays it out)."""
    run, flags, shape = case
    variant, B, P, G, _ = runs[run]
    tcfg = smoke_cfg(tconfigs, variant, **flags)
    T = P + G
    mesh = abstract_mesh(shape, AXES)
    _, specs = tmodel.cache_specs(tcfg, mesh, B, T)
    states = tmodel.serving_cache_specs(tcfg, mesh, B, T)
    kinds = ttfm.layer_kinds(tcfg)
    jcfg = ref["cfg"]
    for r in got:
        at = _At(shape, r["coord"])
        np.testing.assert_array_equal(r["toks"], ref["toks"])
        for t, (g, w) in enumerate(zip(r["logits"], ref["logits"])):
            assert g.shape == (B, 1, tcfg.vocab)
            _close(g, w, f"logits at position {t}")
        assert r["last"].shape == (B, tcfg.vocab)
        _close(r["last"], ref["last"], "prefill logits")
        for layer, c in enumerate(r["prefill"]):
            want = _jlayer(ref["prefill"], layer, jcfg)
            names = list(c) if isinstance(c, dict) else \
                list(want) if isinstance(want, dict) else \
                ["ckv", "krope"] if kinds[layer].startswith("mla") \
                else ["k", "v"]
            if isinstance(want, tuple):
                want = dict(zip(names, want))
            if isinstance(c, tuple):
                c = dict(zip(names, c))
            assert set(c) == set(want), layer
            for n in want:
                w = np.asarray(want[n])
                spec = states[layer][n] if n in STATES else \
                    _prefill_spec(tcfg, shape, B, w.ndim, n)
                _leaf_close(c[n], _piece(w, spec, at), n,
                            f"prefill layer {layer} {n}")
        for layer, c in enumerate(r["cache"]):
            want = _jlayer(ref["cache"], layer, jcfg)
            assert set(c) == set(want), layer
            for n, w in want.items():
                piece = _piece(w, specs[layer][n], at)
                assert c[n].shape == piece.shape, (layer, n)
                _leaf_close(c[n], piece, n, f"cache layer {layer} {n}")


@pytest.mark.parametrize("case", CASES2, ids=[_case_id(c) for c in CASES2])
def test_serve_on_two_ranks_matches_jax(case, jax_ref, world2):
    i = CASES2.index(case)
    _check_case(case, [g[i] for g in world2], jax_ref[case[0]])


@pytest.mark.parametrize("case", CASES4, ids=[_case_id(c) for c in CASES4])
def test_serve_on_four_ranks_matches_jax(case, jax_ref, world4):
    i = CASES4.index(case)
    _check_case(case, [g[i] for g in world4], jax_ref[case[0]])


SPLIT_T = [c for c in CASES2 + CASES4 if c[1].get("shard_cache_t")]


@pytest.mark.parametrize("case", SPLIT_T, ids=[_case_id(c) for c in SPLIT_T])
def test_no_rank_holds_or_gathers_a_whole_t(case, world2, world4):
    """With `shard_cache_t` each rank's attention cache holds T / 'model'
    positions of every kv head where 'model' divides the layer's T (the
    whole T where it does not), an MLA layer's latent T / 'model'
    positions, and no collective of the decode steps returns a tensor as
    large as one layer's whole k cache (latent cache) of this rank's
    rows."""
    run, flags, shape = case
    variant, B, P, G, _ = RUNS[run]
    cfg = smoke_cfg(tconfigs, variant, **flags)
    world, cases = (world2, CASES2) if case in CASES2 else (world4, CASES4)
    i = cases.index(case)
    T, tp = P + G, shape[1]
    rows = B // shape[0] if B % shape[0] == 0 else B
    split = 0
    kinds = ttfm.layer_kinds(cfg)
    mla = kinds[0].startswith("mla")
    whole = rows * T * (cfg.mla.kv_lora_rank if mla
                        else cfg.n_kv_heads * cfg.hd)
    for g in world:
        r = g[i]
        for layer, (kind, c) in enumerate(zip(kinds, r["cache"])):
            Tk = min(T, cfg.window) if kind == "attn_local" else T
            want_t = Tk // tp if Tk % tp == 0 else Tk
            split += Tk % tp == 0
            if mla:
                assert c["ckv"].shape == (rows, want_t,
                                          cfg.mla.kv_lora_rank), layer
                assert c["krope"].shape[1] == want_t
                continue
            assert c["k"].shape == (rows, want_t, cfg.n_kv_heads, cfg.hd), \
                (layer, kind, c["k"].shape)
            assert c["k_scale" if "k_scale" in c else "k"].shape[1] == want_t
        assert r["largest"] < whole
    assert split > 0


def test_serve_of_an_unported_kind_over_model_raises_naming_a9(world2):
    i = len(CASES2)
    for g in world2:
        assert isinstance(g[i], str) and "ROADMAP A9" in g[i], g[i]
        assert "tensor parallelism" in g[i]


def test_launcher_builds_the_local_mesh_under_two_ranks(world2):
    printed = [g[-1] for g in world2]
    assert "arch=qwen2-1.5b-smoke mesh={'data': 2, 'model': 1} " \
        "backend=gloo device=cpu" in printed[0]
    assert "generated (2, 3) tokens" in printed[0]
    assert all(p == "" for p in printed[1:])


def test_serve_specs_are_cache_specs_but_for_pure_dp():
    """`serving_cache_specs` (what `LMModel.init_cache` lays out on a
    mesh) is `cache_specs` where weights are split, and under `pure_dp`
    splits only the rows (JAX's specs name 'model' twice there when it is
    above 1)."""
    cfg = smoke_cfg(tconfigs, "qwen2-1.5b")
    for shape in ((2, 2), (1, 4), (4, 1)):
        mesh = abstract_mesh(shape, AXES)
        for sct in (False, True):
            c = dataclasses.replace(cfg, shard_cache_t=sct)
            assert tmodel.serving_cache_specs(c, mesh, 4, 16) == \
                tmodel.cache_specs(c, mesh, 4, 16)[1]
            pd = dataclasses.replace(c, pure_dp=True)
            got = tmodel.serving_cache_specs(pd, mesh, 4, 16)
            assert all(tuple(s)[1:] == (None,) * (len(s) - 1)
                       and s[0] == ("data", "model")
                       for layer in got for s in layer.values())
