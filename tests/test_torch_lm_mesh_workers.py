"""The per-rank bodies of `test_torch_lm_mesh.py`,
`test_torch_lm_mesh_serve.py` and `test_torch_lm_mesh_moe.py` and the
configs they share with their JAX sides. No tests here: each spawned gloo rank
(`repro_torch.core.mesh.run_ranks`) imports this module by name to find
its function, so it imports neither JAX nor `repro`.
"""
import contextlib
import dataclasses
import io

import pytest

torch = pytest.importorskip("torch")

import repro_torch.configs as tconfigs  # noqa: E402

B, S = 4, 32            # the global batch: two microbatches of 2 rows

# (case name -> (arch, its layers, changes to the smoke config)); the
# 3-head case leaves every attention leaf whole on 'model' (`_sanitize`),
# "h12" puts 3 q heads over one kv head on each of 4 'model' ranks (k / v
# whole), "h12k3" 6 q heads over kv heads (0,0,0,0,1,1) on each of 2;
# recurrentgemma keeps its pattern without its suffix and deepseek one of
# its dense layers before its MoE one (for the JAX side's compile time);
# dbrx and deepseek sum gradients in bf16, where a rank's f32 part rounds
# to another bf16 value than the whole sum in about one entry in a
# thousand: their f32 variants are held at 1e-5, "dbrx-bf16" at bf16's
# bar; "vocab511" has a vocabulary that 'model' 2 does not divide, so
# `embed` and `unembed` stay whole; "gemma2-int8" has the int8 KV cache;
# "rwkv-hd32" has 3 wkv heads of 32 at d_model 96, 24 columns a rank on
# 'model' 4, which cuts every head (a change given as a function of the
# config, as `rec` is each package's own dataclass); "deepseek-mla" is
# deepseek's MLA over a dense MLP alone; "rwkv-f129" has a d_ff that
# 'model' 2 does not divide beside a d_model that it does; "dbrx-int8" is
# dbrx with the int8 KV cache
VARIANTS = {
    "qwen2-1.5b": ("qwen2-1.5b", 2, {}),
    "gemma2-9b": ("gemma2-9b", 2, {}),
    "qwen3-4b": ("qwen3-4b", 2, {}),
    "qwen2-vl-2b": ("qwen2-vl-2b", 2, {}),
    "heads3": ("qwen2-1.5b", 2, dict(n_heads=3, n_kv_heads=1)),
    "h12": ("qwen2-1.5b", 1, dict(n_heads=12, n_kv_heads=2)),
    "h12k3": ("qwen2-1.5b", 1, dict(n_heads=12, n_kv_heads=3)),
    "rwkv6-1.6b": ("rwkv6-1.6b", 2, {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", 3, dict(suffix=())),
    "dbrx-132b": ("dbrx-132b", 1, dict(grad_accum_dtype="float32")),
    "deepseek-v3-671b": ("deepseek-v3-671b", 1, dict(
        prefix=("mla_dense",), grad_accum_dtype="float32")),
    "dbrx-bf16": ("dbrx-132b", 1, {}),
    "vocab511": ("qwen2-1.5b", 2, dict(vocab=511)),
    "gemma2-int8": ("gemma2-9b", 2, dict(kv_cache_dtype="int8")),
    "rwkv-hd32": ("rwkv6-1.6b", 2, dict(
        d_model=96, rec=lambda c: dataclasses.replace(c.rec, head_dim=32))),
    "deepseek-mla": ("deepseek-v3-671b", 2, dict(
        prefix=(), pattern=("mla_dense",), grad_accum_dtype="float32")),
    "rwkv-f129": ("rwkv6-1.6b", 2, dict(d_ff=129)),
    "dbrx-int8": ("dbrx-132b", 1, dict(kv_cache_dtype="int8")),
}


def smoke_cfg(configs, variant: str, **flags):
    """`configs` (either package's) smoke config of `variant` with its
    layers in the repeated pattern (at least one repeat) between its
    prefix and suffix, and `flags` (zero1, seq_parallel, pure_dp)."""
    arch, layers, kw = VARIANTS[variant]
    cfg = configs.smoke_config(configs.get_config(arch))
    cfg = dataclasses.replace(cfg, **{k: v(cfg) if callable(v) else v
                                      for k, v in kw.items()})
    reps = max(1, layers // len(cfg.pattern))
    return dataclasses.replace(
        cfg, n_layers=len(cfg.prefix) + reps * len(cfg.pattern)
        + len(cfg.suffix), repeats=reps, **flags)


def train_cases(rank, world, cases):
    """Each case on this rank, in order: `train(mesh=)` to each step of
    `steps` in turn, each a fresh call that resumes the checkpoint of the
    one before (its histories), or the message of the
    `NotImplementedError` it raised; or, for a case with `argv`, what the
    launcher printed; or, for a case with `init`, the largest difference
    between this rank's freshly drawn shards and the same pieces of the
    one-device draw. A case: dict(variant, flags, shape, steps, ckpt),
    its mesh ("data", "model")."""
    from repro_torch.core.mesh import build_mesh
    from repro_torch.train import train

    out = []
    for c in cases:
        if "argv" in c:
            out.append(launcher(rank, world, c["argv"]))
            continue
        cfg = smoke_cfg(tconfigs, c["variant"], **c["flags"])
        mesh = build_mesh(c["shape"], ("data", "model"), device="cpu")
        if c.get("init"):
            out.append(init_gap(cfg, mesh))
            continue
        try:
            out.append([train(cfg, steps=s, batch=B, seq=S,
                              ckpt_dir=c["ckpt"], mesh=mesh,
                              log_every=1)[1] for s in c["steps"]])
        except NotImplementedError as e:
            out.append(str(e))
    return out


def launcher(rank, world, argv):
    """`repro_torch.launch.train.main(argv)` on this rank: what it
    printed."""
    from repro_torch.launch import train as tlaunch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        tlaunch.main(argv)
    return buf.getvalue()


def init_gap(cfg, mesh) -> float:
    """The largest difference between this rank's shards as a mesh model
    draws them (cut layer by layer) and the same pieces of one device's
    draw from the same seed."""
    from repro_torch.models import LMModel
    from repro_torch.models import shard as sh

    one = LMModel(cfg, device="cpu", seed=3).params.state_dict()
    model = LMModel(cfg, mesh=mesh, seed=3)
    gap = 0.0
    for k, p in model.params.state_dict().items():
        want = sh.shard_of(one[k], model.pspecs[k], mesh)
        assert p.shape == want.shape, k
        gap = max(gap, float((p.float() - want.float()).abs().max()))
    return gap


# -- serving on a mesh (`test_torch_lm_mesh_serve.py`) -------------------------

def serve_cases(rank, world, cases):
    """Each case on this rank, in order, on its ("data", "model") mesh:
    what `_serve_one` returns, or the message of the
    `NotImplementedError` it raised; for a case with `argv`, what
    `repro_torch.launch.serve.main` printed."""
    from repro_torch.core.mesh import build_mesh

    out = []
    for c in cases:
        if "argv" in c:
            out.append(serve_launcher(c["argv"]))
            continue
        cfg = smoke_cfg(tconfigs, c["variant"], **c["flags"])
        mesh = build_mesh(c["shape"], ("data", "model"), device="cpu")
        try:
            out.append(_serve_one(cfg, mesh, c))
        except NotImplementedError as e:
            out.append(str(e))
    return out


def _np(x):
    return x.detach().cpu().numpy()


def _serve_one(cfg, mesh, c) -> dict:
    """The JAX weights (`c["state"]`, whole) loaded into this rank's
    shards; then `prefill_step` on the prompts (its last logits and each
    layer's cache), `generate` (the greedy tokens), and the decode steps
    of the prompts and those tokens from `init_cache` (every step's
    logits, the cache's pieces after the last, and the largest tensor a
    collective returned during them)."""
    from repro_torch.data import batch_for
    from repro_torch.launch.serve import generate
    from repro_torch.models import LMModel

    if c.get("serve_only"):
        from repro_torch.launch.serve import serve
        return serve(cfg, batch=c["B"], prompt_len=c["P"], gen=c["G"],
                     mesh=mesh, seed=c["seed"])[0]
    model = LMModel(cfg, mesh=mesh)
    model.load_full(c["state"])
    key = "embeddings" if cfg.embed_inputs else "tokens"
    B, P, G = c["B"], c["P"], c["G"]
    batch = batch_for(cfg, B, P, 0, c["seed"])
    inputs = {k: v for k, v in batch.items() if k in (key, "positions")}
    last, caches = model.prefill_step(inputs)
    toks, _ = generate(model, batch[key], G)
    if cfg.embed_inputs:
        seq = torch.cat([torch.as_tensor(batch[key]),
                         model.embed_rows(toks)], dim=1)
    else:
        seq = torch.cat([torch.as_tensor(batch[key]),
                         torch.as_tensor(toks)], dim=1)
    largest = [0]
    for name in ("all_gather", "all_sum"):
        fn = getattr(mesh, name)

        def seen(*a, _fn=fn, **kw):
            got = _fn(*a, **kw)
            largest[0] = max(largest[0], got.numel())
            return got
        setattr(mesh, name, seen)
    cache = model.init_cache(B, P + G)
    logits = []
    for t in range(P + G):
        lg, cache = model.decode_step(cache, {key: seq[:, t:t + 1]}, t)
        logits.append(_np(lg))
    return dict(
        coord=tuple(mesh.coord), last=_np(last), toks=toks,
        prefill=[tuple(_np(a) for a in c_) if isinstance(c_, tuple)
                 else {n: _np(a) for n, a in c_.items()} for c_ in caches],
        logits=logits, largest=largest[0],
        cache=[{n: _np(a) for n, a in c_.items()} for c_ in cache])


def serve_launcher(argv):
    """`repro_torch.launch.serve.main(argv)` on this rank: what it
    printed."""
    from repro_torch.launch import serve as slaunch

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        slaunch.main(argv)
    return buf.getvalue()


# -- one MoE layer, training and serving of the MoE kinds on a mesh
#    (`test_torch_lm_mesh_moe.py`) ---------------------------------------------

def moe_mesh_cases(rank, world, cases):
    """Each case on this rank, in order, by its "kind": "layer"
    (`moe_layer`), "train" (`train_cases`), "serve" (`serve_cases`) or
    "launch" (`serve_launcher` of its argv)."""
    out = []
    for c in cases:
        kind = c["kind"]
        if kind == "layer":
            out.append(moe_layer(c))
        elif kind == "train":
            out.append(train_cases(rank, world, [c])[0])
        elif kind == "serve":
            out.append(serve_cases(rank, world, [c])[0])
        else:
            out.append(serve_launcher(c["argv"]))
    return out


def moe_layer(c) -> dict:
    """One MoE layer of `c["variant"]` (its MoE config changed by
    `c["moe"]`) through `models.moe.moe_apply` on this rank of a
    ("data", "model") mesh of `c["shape"]`, with `c["flags"]`: the whole
    leaves `c["p"]` (numpy) cut to this rank's shards by the model's
    specs, x `c["x"]` [B, S, d] cut to this rank's rows and (under
    sequence parallelism) positions, the loss sum(out * r) + 0.01 aux
    (aux counted once over the dp axes, as `transformer.loss_fn` counts
    it). Returns this rank's output, aux, the gates each rank routed by,
    the gradient of its x and of each leaf's shard, summed over the ranks
    as `LMModel._reduce` sums a microbatch's, and what it holds."""
    from repro_torch.core.mesh import build_mesh
    from repro_torch.models import LMModel
    from repro_torch.models import moe as tmoe
    from repro_torch.models import shard as sh
    from repro_torch.models import transformer as ttfm

    cfg = smoke_cfg(tconfigs, c["variant"], optimizer="adamw", **c["flags"])
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **c["moe"]))
    mesh = build_mesh(c["shape"], ("data", "model"), device="cpu")
    model = LMModel(cfg, mesh=mesh)
    i = next(j for j, k in enumerate(ttfm.layer_kinds(cfg))
             if k.endswith("_moe"))
    x_all = torch.from_numpy(c["x"])
    B, S, _ = x_all.shape
    ctx = model._ctx(S, model._split(B))
    leaves = {}
    for path, full in _flat(c["p"]).items():
        key = f"blocks.{i}.ffn.{path}"
        leaves[key] = sh.shard_of(torch.from_numpy(full), model.pspecs[key],
                                  mesh).clone().requires_grad_()
    p = _nest({k.split(".ffn.")[1]: v for k, v in leaves.items()})
    x = ctx.local_seq(ctx.rows(x_all)).clone().requires_grad_()
    r = ctx.local_seq(ctx.rows(torch.from_numpy(c["r"])))
    gates = []
    route = tmoe._route

    def spy(*a, **kw):
        got = route(*a, **kw)
        gates.append(got[0].detach().numpy())
        return got
    tmoe._route = spy
    try:
        out, aux = tmoe.moe_apply(x, p, cfg.moe, ctx=ctx)
    finally:
        tmoe._route = route
    loss = torch.sum(out * r) + 0.01 * aux / ctx.ndp
    got = torch.autograd.grad(loss, [x] + list(leaves.values()))
    grads = {k: model._reduce(k, g, ctx).numpy()
             for k, g in zip(leaves, got[1:])}
    return dict(coord=tuple(mesh.coord), ndp=ctx.ndp, sp=ctx.sp,
                out=out.detach().numpy(), aux=float(aux.detach()),
                gates=gates[0],
                gx=got[0].numpy(), grads={k.split(".ffn.")[1]: g
                                          for k, g in grads.items()},
                specs={k.split(".ffn.")[1]: tuple(model.pspecs[k])
                       for k in leaves}, split=dict(ctx.split),
                x_shape=tuple(x.shape))


def _flat(tree, pre=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}."))
        else:
            out[pre + k] = v
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        *path, leaf = k.split(".")
        d = out
        for name in path:
            d = d.setdefault(name, {})
        d[leaf] = v
    return out
