"""LMModel: the public step API (serving and training).

The JAX package's `repro.models.LMModel` as an `nn.Module` that owns its
weights (`self.params`, a `transformer.LMParams`), so the steps take no
`params` argument; each returns what the JAX step returns:

- `prefill_step(batch)` -> (logits [B, V] at the last position, caches:
  one (k, v) [B, S, K, hd] pair per attention layer, one (ckv [B, S, r],
  k_rope [B, S, rope]) pair per MLA layer, and each recurrent layer's
  final f32 state, {"h", "conv"} for RG-LRU or {"s", "x_tm", "x_cm"} for
  RWKV-6, as `init_cache` lays it out). On CUDA tensors every attention
  layer runs the `flash_attention` kernel (an MLA layer its q/k width 192
  over v width 128 instance); the recurrences and
  the MoE layers' routing, expert products and combine are plain PyTorch
  on every device. The head (`lnf`, `unembed`)
  runs on the last position only: the same values as the JAX step's
  `logits[:, -1]`, without its [B, S, V] f32 tensor;
- `decode_step(cache, batch, pos)` -> (logits [B, 1, V], cache), the cache
  (bf16, or int8 codes and scales with `kv_cache_dtype="int8"`; MLA's
  latent {"ckv", "krope"}, read by the absorbed-matrix decode in plain
  PyTorch) written in place at `pos`, each recurrent layer's state
  replaced in place;
- `loss(batch)` -> (loss + 0.01 aux, {"loss", "aux"}), differentiable
  (aux: the MoE layers' summed load-balance loss, 0 without MoE);
- `train_step(opt_state, batch)` -> (opt_state, {"loss", "aux",
  "grad_norm"}): gradients of `min(cfg.microbatch, B)`-row microbatches
  summed in `cfg.grad_accum_dtype` and divided by their count, then one
  AdamW or Adafactor update (`cfg.optimizer`) written into `self.params`
  in place; the metrics are the microbatches' means, as in JAX. A leaf
  the loss does not read (`embed` under `embed_inputs`) gets a zero
  gradient, as JAX's autodiff gives it. AdamW's
  state is keyed like the weights; Adafactor's, whose factors and update
  clipping span a stacked leaf, by the JAX tree's paths with the pattern
  stacked (`convert.jax_paths`). On CUDA
  tensors every attention layer runs the `flash_attention` kernel
  twice (the forward and its recomputation under remat) and its backward
  kernel once a microbatch (with gemma2's window, soft-cap and head width
  256 too; an MLA layer at q/k width 192 over v width 128).

Inputs are dicts of tensors or numpy arrays ({"tokens": [B, S] int}, or
with `embed_inputs` {"embeddings": [B, S, d], "labels": [B, S] int}, and
{"positions": [B, 3, S] int} for M-RoPE, as `data.batch_for` gives
them), moved to the model's device. One device: `zero1`, `seq_parallel` and `pure_dp`
act on a mesh only, so they change nothing there (as in JAX with
`mesh=None`).

The sharding rules (JAX's, see DESIGN.md §4): mesh axes ('pod', 'data',
'model') or ('data', 'model'); batch over the dp axes, heads, d_ff and
the vocabulary over 'model', MoE experts over 'data' with the expert d_ff
over 'model'; a dimension the axis does not divide stays whole
(`_sanitize`). `param_specs`, `zero1_specs`, `batch_specs`, `cache_specs`
and `input_specs` are JAX's functions on the port's leaves: the weights
are keyed like `LMParams.state_dict()` (one leaf a layer, so a JAX
stacked leaf's spec without its leading scan None), Adafactor's state by
the JAX tree's paths (`convert.jax_paths`), whose specs keep that None.
They read only a mesh's `shape` (axis -> size) and `axis_names`.

Training on a mesh (`LMModel(cfg, mesh=...)`, one process a rank, SPMD
on `torch.distributed`): each rank holds its shards of the weights by
`param_specs` and, with `cfg.zero1`, of the gradient sums and the
optimizer state by `zero1_specs`. `train_step` takes the global batch
(the same on every rank) and keeps JAX's microbatches: microbatch i is
global rows [i mb, (i + 1) mb), split over the dp axes (whole on every
rank where they do not divide it, as `_dp_or_none`). The layers run
their collectives themselves (`models.shard`): tensor parallelism over
'model' for the dense attention kinds (each rank's heads and d_ff
columns, the vocabulary-parallel embedding and loss), for RG-LRU and
RWKV-6 (each rank's `lru_width`, d_model and d_ff columns, `models.ssm`)
and for MLA (each rank's heads, the latent whole), sequence parallelism
between the layers with `cfg.seq_parallel`; a MoE layer gathers the
microbatch's rows over the dp axes, since its routing and capacity span
them, runs this rank's experts (over 'data') on its d_ff columns (over
'model') and gathers the experts' outputs over 'data' (`models.moe`).
Each microbatch's gradients are summed in their own dtype, as
GSPMD sums JAX's partial products, over the dp axes (and over 'model'
for a whole leaf each rank reads only in part: the norms under sequence
parallelism, and every whole leaf of a token mixer that 'model' splits,
such as qwen3's q/k norms, the k/v weights of heads that 'model' does
not divide, MLA's latent projections, RG-LRU's gates' biases or RWKV-6's
token-shift LoRA; an expert's gradient is not summed over 'data', which
holds other experts), reduce-scattered into the ZeRO-1 layout with
`zero1`, and the optimizer's statistics that span a sharded dimension
are reduced over its axes. The result is JAX's single-device step up to
the order of sums. RWKV-6 over a 'model' axis that divides only one of its d_model
and d_ff waits for ROADMAP A9 and raises. ZeRO-1 of AdamW's
per-layer state splits a layer's first free dimension where JAX's
stacked leaf may split the layer axis (the same share a rank).

Serving on a mesh covers the same configs: `prefill_step` and
`decode_step` take the whole batch (each rank runs its rows, all of
them where the dp axes do not divide B, on its heads or columns) and
return JAX's global logits, every row over the whole vocabulary, the
same bits on every rank (`shard.ShardCtx.whole_logits`); `init_cache`
allocates this rank's pieces of the decode cache in `cache_specs`'
layout (heads over 'model', or T over 'model' with `shard_cache_t` for
attention's k / v and MLA's latent; a recurrent state's heads or
columns; only the rows under `pure_dp`), which `decode_step` writes in
place; `prefill_step`'s caches are this rank's rows and kv heads, MLA's
latent whole, a recurrent state in `cache_specs`' layout.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ArchConfig
from ..device import resolve_device
from ..optim import (AdafactorState, AdamWState, adafactor_init,
                     adafactor_update, adamw_init, adamw_update)
from . import shard as sh
from . import transformer as tfm
from .attention import later
from .convert import jax_paths, unstack_paths
from .shard import P

__all__ = ["LMModel", "P", "abstract_params", "param_specs", "zero1_specs",
           "opt_specs", "input_specs", "batch_specs", "cache_specs",
           "serving_cache_specs", "dp_axes"]

def dp_axes(mesh, cfg: Optional[ArchConfig] = None) -> tuple:
    if cfg is not None and cfg.pure_dp:
        return tuple(mesh.axis_names)
    return tuple(a for a in mesh.axis_names if a != "model")


def _local_shape(shape: tuple, spec, mesh) -> tuple:
    """A leaf's shape cut to one rank's piece by its spec."""
    return tuple(n // sh.entry_size(mesh, e) for n, e in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


def _dp_or_none(mesh, B: int, cfg: Optional[ArchConfig] = None):
    dp = dp_axes(mesh, cfg)
    size = 1
    for a in dp:
        size *= mesh.shape[a]
    return dp if B % size == 0 else None


# ---------------------------------------------------------------------------
# Parameter sharding rules (path + shape pattern matched)
# ---------------------------------------------------------------------------

def _leaf_spec(names: list, leaf_ndim: int) -> P:
    name = names[-1]
    stacked = "pattern" in names            # scan axis prepended
    nd = leaf_ndim - (1 if stacked else 0)

    def out(*spec):
        assert len(spec) == nd, (names, leaf_ndim, spec)
        return P(*(((None,) if stacked else ()) + spec))

    moe_ctx = "ffn" in names and nd == 3    # stacked expert weights
    if name == "embed":
        return P("model", None)
    if name == "unembed":
        return P(None, "model")
    if name in ("wq", "wk", "wv") and nd == 3:
        return out(None, "model", None)
    if name == "wo" and nd == 3:
        return out("model", None, None)
    if name in ("bq", "bk", "bv") and nd == 2:
        return out("model", None)
    if name in ("wq_b", "wk_b", "wv_b"):
        return out(None, "model", None)
    if name in ("wg", "wu"):
        return out("data", None, "model") if moe_ctx else out(None, "model")
    if name == "wd":
        return out("data", "model", None) if moe_ctx else out("model", None)
    if name in ("wr", "wk", "wv", "wg", "cm_wk", "cm_wr", "wx", "wy",
                "wa", "wi") and nd == 2:
        return out(None, "model")
    if name in ("wo", "cm_wv") and nd == 2:
        return out("model", None)
    if name == "u" and nd == 2:             # rwkv bonus [H, dk]
        return out(None, None)
    # everything else (norms, biases, router, loras, conv, lambda): replicated
    return P(*([None] * leaf_ndim))


def _sanitize(spec: P, shape, mesh) -> P:
    """Drop sharding on dims the mesh axis size does not divide (e.g. 15 GQA
    heads over model=16 -> replicate)."""
    if mesh is None:
        return spec
    out = []
    for i, s in enumerate(spec):
        if s is None:
            out.append(None)
            continue
        axes = s if isinstance(s, tuple) else (s,)
        size = 1
        for a in axes:
            size *= mesh.shape[a]
        out.append(s if shape[i] % size == 0 else None)
    return P(*out)


def param_specs(cfg: ArchConfig, abstract_params: dict, mesh=None) -> dict:
    """{leaf key: P} for a flat dict of leaves keyed by their dotted paths
    (the port's state-dict keys, or JAX's paths with the pattern
    stacked)."""
    def spec(key, leaf):
        if cfg.pure_dp:   # small models: replicate weights, batch everywhere
            return P(*([None] * leaf.dim()))
        return _sanitize(_leaf_spec(key.split("."), leaf.dim()), leaf.shape,
                         mesh)
    return {k: spec(k, v) for k, v in abstract_params.items()}


def zero1_specs(cfg: ArchConfig, pspecs: dict, abstract: dict, mesh) -> dict:
    """ZeRO-1: additionally shard a replicated-or-spare dim over 'data'
    (over ALL axes under pure_dp). Applied to the grad accumulator and
    optimizer state (not params)."""
    zaxes = tuple(mesh.axis_names) if cfg.pure_dp else ("data",)
    dsize = 1
    for a in zaxes:
        dsize *= mesh.shape[a]

    def used(s):
        return "data" in ((s,) if not isinstance(s, tuple) else s) \
            if s is not None else False

    def upd(ps, leaf):
        spec = list(tuple(ps)) + [None] * (leaf.dim() - len(tuple(ps)))
        if any(used(s) for s in spec):
            return P(*spec)          # expert weights already shard over data
        for i, s in enumerate(spec):
            if s is None and leaf.shape[i] % dsize == 0 and \
                    leaf.shape[i] >= dsize:
                spec[i] = zaxes if len(zaxes) > 1 else zaxes[0]
                break
        return P(*spec)

    return {k: upd(pspecs[k], abstract[k]) for k in pspecs}


def abstract_params(cfg: ArchConfig) -> dict:
    """The whole model's leaves as meta tensors, keyed like
    `LMParams.state_dict()`."""
    return tfm.init_params(cfg, generator=torch.Generator(),
                           device="meta").state_dict()


def _stack_spec(specs: list) -> P:
    """A pattern slot's per-layer specs as its stacked leaf's: the scan
    axis first, whole."""
    return P(None, *specs[0])


def opt_specs(cfg: ArchConfig, pspecs: dict, mesh=None, abstract=None):
    """The optimizer state's specs for the weights' `pspecs`: AdamW's keyed
    like the weights, Adafactor's by the JAX tree's paths (the pattern
    stacked); with `cfg.zero1` on a mesh, by `zero1_specs`. `abstract`:
    `abstract_params(cfg)` where the caller has it."""
    if abstract is None:
        abstract = abstract_params(cfg)
    if cfg.optimizer == "adafactor":
        pspecs = jax_paths(pspecs, cfg, _stack_spec)
        abstract = jax_paths(abstract, cfg)
        state = adafactor_init(abstract)
    else:
        state = adamw_init(abstract)
    if cfg.zero1 and mesh is not None:
        pspecs = zero1_specs(cfg, pspecs, abstract, mesh)
    return _state_specs(cfg, pspecs, state)


def _state_specs(cfg: ArchConfig, pspecs: dict, abstract_state):
    """Optimizer state: m/v (or vr/vc) inherit param specs, truncated to the
    factored shapes for adafactor; scalars replicated."""
    if cfg.optimizer == "adafactor":
        vr = {k: P(*tuple(pspecs[k])[:l.dim()])
              for k, l in abstract_state.vr.items()}
        vc = {k: P(*(tuple(pspecs[k])[:l.dim() - 1] + tuple(pspecs[k])[-1:]))
              if l.dim() > 1 else P(*([None] * l.dim()))
              for k, l in abstract_state.vc.items()}
        return type(abstract_state)(step=P(), vr=vr, vc=vc)
    return type(abstract_state)(step=P(), m=dict(pspecs), v=dict(pspecs))


# ---------------------------------------------------------------------------
# Batch / cache specs (meta-tensor factories for the dry-run)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ArchConfig, mesh, B: int, S: int, *, decode=False):
    """Returns (dict of meta tensors, dict of P)."""
    dp = _dp_or_none(mesh, B, cfg)
    dt = getattr(torch, cfg.dtype)
    shapes, specs = {}, {}
    if cfg.embed_inputs:
        shapes["embeddings"] = _meta((B, S, cfg.d_model), dt)
        specs["embeddings"] = P(dp, None, None)
        if not decode:
            shapes["labels"] = _meta((B, S), torch.int32)
            specs["labels"] = P(dp, None)
    else:
        shapes["tokens"] = _meta((B, S), torch.int32)
        specs["tokens"] = P(dp, None)
    if cfg.rope == "mrope":
        shapes["positions"] = _meta((B, 3, S), torch.int32)
        specs["positions"] = P(dp, None, None)
    return shapes, specs


def cache_specs(cfg: ArchConfig, mesh, B: int, T: int):
    """(the decode cache as meta tensors, one dict a layer as
    `transformer.init_cache` lays it out; their specs)."""
    dp = _dp_or_none(mesh, B, cfg)
    abstract = tfm.init_cache(cfg, B, T, device="meta")

    def spec(name, leaf):
        base: tuple
        if name in ("k", "v", "k_scale", "v_scale"):
            if cfg.shard_cache_t:
                base = (dp, "model", None, None)
            else:
                base = (dp, None, "model", None)
        elif name in ("ckv", "krope"):
            base = (dp, "model", None) if cfg.shard_cache_t \
                else (dp, None, None)
        elif name == "s":                    # rwkv state [B,H,dk,dv]
            base = (dp, "model", None, None)
        elif name in ("x_tm", "x_cm"):
            base = (dp, None)
        elif name == "h":
            base = (dp, "model")
        elif name == "conv":
            base = (dp, None, "model")
        else:
            base = tuple([None] * leaf.dim())
        return _sanitize(P(*base[:leaf.dim()]), leaf.shape, mesh)

    return abstract, [{k: spec(k, v) for k, v in layer.items()}
                      for layer in abstract]


def serving_cache_specs(cfg: ArchConfig, mesh, B: int, T: int) -> list:
    """The decode cache's specs that a mesh serves with: `cache_specs`',
    but under `pure_dp` (no tensor parallelism) only the rows split (JAX's
    specs name 'model' twice there when it is above 1)."""
    _, specs = cache_specs(cfg, mesh, B, T)
    if cfg.pure_dp:
        specs = [{n: P(s[0], *([None] * (len(s) - 1)))
                  for n, s in layer.items()} for layer in specs]
    return specs


def input_specs(cfg: ArchConfig, shape, mesh):
    """Meta-tensor stand-ins + specs for one (arch, shape) cell.

    train:   (batch,)
    prefill: (batch,)
    decode:  (cache, batch, pos)  — one new token against a T=seq_len cache
    """
    if shape.kind in ("train", "prefill"):
        b, s = batch_specs(cfg, mesh, shape.global_batch, shape.seq_len)
        return {"batch": b}, {"batch": s}
    b, bs = batch_specs(cfg, mesh, shape.global_batch, 1, decode=True)
    cache, cs = cache_specs(cfg, mesh, shape.global_batch, shape.seq_len)
    pos = _meta((), torch.int32)
    return ({"cache": cache, "batch": b, "pos": pos},
            {"cache": cs, "batch": bs, "pos": P()})


# ---------------------------------------------------------------------------
# Model wrapper
# ---------------------------------------------------------------------------

_NORMS = ("ln1", "ln2", "pn1", "pn2", "lnf")


class LMModel(nn.Module):
    """Step functions for one architecture on one device (CUDA unless
    `device` names another; raises without a card), or on this rank of
    `mesh` (on the mesh's device unless `device` names another)."""

    def __init__(self, cfg: ArchConfig, mesh=None, device=None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self._cache_layout = None       # a mesh's last init_cache
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        if mesh is not None:
            self._plan()
        self.params = self.init_params(seed)

    # ---- params ----------------------------------------------------------
    def init_params(self, seed: int) -> tfm.LMParams:
        """Fresh weights drawn from `seed` on the model's device (on a
        mesh: drawn in the one-device order, `embed`, `unembed` and each
        layer cut to this rank's shards before the next is drawn, so no
        rank holds more than one of them whole at a time)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        keep = None
        if self.mesh is not None:
            def keep(key, t):
                return sh.shard_of(t, self.pspecs[key], self.mesh).clone()
        return tfm.init_params(self.cfg, generator=gen, device=self.device,
                               keep=keep)

    def abstract_params(self) -> dict:
        return abstract_params(self.cfg)

    def param_partition(self) -> dict:
        return param_specs(self.cfg, self.abstract_params(), self.mesh)

    def opt_partition(self, pspecs: dict):
        return opt_specs(self.cfg, pspecs, self.mesh)

    def init_cache(self, B: int, T: int) -> list:
        """The decode cache for B rows and positions [0, T); on a mesh,
        this rank's pieces of it in `cache_specs`' layout (only they are
        allocated), which `decode_step` then expects."""
        if self.mesh is None:
            return tfm.init_cache(self.cfg, B, T, device=self.device)
        specs = serving_cache_specs(self.cfg, self.mesh, B, T)

        def local(i, name, shape):
            return _local_shape(shape, specs[i][name], self.mesh)
        cache = tfm.init_cache(self.cfg, B, T, device=self.device,
                               local=local)
        # a rank cannot tell a piece of T from a whole T by its shape:
        # decode_step reads the layout from here
        self._cache_layout = (B, T, [
            {n: tuple(t.shape) for n, t in c.items()} for c in cache], [
            any(n in sp and sp[n][1] is not None for n in ("k", "ckv"))
            for sp in specs])
        return cache

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _rows(self, b: dict):
        """(the layers' view of the mesh for a serving step on batch `b`,
        this rank's rows of it, the batch's B)."""
        x = b["embeddings" if self.cfg.embed_inputs else "tokens"]
        ctx = self._ctx(x.shape[1], self._split(x.shape[0]))
        return ctx, {k: ctx.rows(v) for k, v in b.items()}, x.shape[0]

    @torch.no_grad()
    def prefill_step(self, batch):
        """(logits [B, V] at the last position, caches). On a mesh: the
        whole batch in, each rank runs its rows (all of them where the dp
        axes do not divide B) on its heads; the logits are the whole
        batch's over the whole vocabulary on every rank, the caches this
        rank's rows and kv heads."""
        if self.mesh is None:
            logits, caches, _ = tfm.forward_full(
                self.params, self.cfg, self._batch(batch), want_cache=True,
                last_only=True)
            return logits[:, -1], caches
        ctx, rows, _ = self._rows(self._batch(batch))
        logits, caches, _ = tfm.forward_full(
            self.params, self.cfg, rows, want_cache=True, last_only=True,
            ctx=ctx)
        return logits[:, -1], caches

    @torch.no_grad()
    def decode_step(self, cache, batch, pos: int):
        """(logits [B, 1, V], cache), the cache written in place. On a
        mesh: the whole batch in, the logits the whole batch's on every
        rank; `cache` this rank's pieces as `init_cache` made them."""
        if self.mesh is None:
            return tfm.forward_decode(self.params, self.cfg, cache,
                                      self._batch(batch), int(pos))
        ctx, rows, B = self._rows(self._batch(batch))
        return tfm.forward_decode(self.params, self.cfg, cache, rows,
                                  int(pos), ctx=ctx,
                                  t_split=self._t_split(cache, B))

    def _t_split(self, cache: list, B: int) -> list:
        """For each layer, whether its cache's T is over 'model'; the
        pieces must have the shapes of this model's last `init_cache`."""
        layout = self._cache_layout
        shapes = [{n: tuple(t.shape) for n, t in c.items()} for c in cache]
        if layout is None or layout[0] != B or layout[2] != shapes:
            raise ValueError(
                f"decode_step on a mesh takes this rank's pieces of the "
                f"model's last init_cache(B, T) (B {B}; "
                f"{'none made' if layout is None else layout[:2]})")
        return layout[3]

    def embed_rows(self, tokens) -> torch.Tensor:
        """`embed` rows of `tokens` (whole rows on every rank of a mesh:
        over a vocabulary sharded on 'model' each rank looks up the ids
        it owns and the rows are summed over 'model')."""
        tokens = torch.as_tensor(tokens, device=self.device)
        table = self.params.embed.detach()
        if self.mesh is None:
            return table[tokens.long()]
        with torch.no_grad():
            return self._ctx(1, 1).embed(table, tokens)

    # ---- the mesh ----------------------------------------------------------
    def _plan(self) -> None:
        """The specs of this mesh, and what 'model' and 'data' split
        (`_split_flags`)."""
        cfg, mesh = self.cfg, self.mesh
        abstract = self.abstract_params()
        self.pspecs = param_specs(cfg, abstract, mesh)
        self.tp = 1 if cfg.pure_dp else mesh.shape.get("model", 1)
        kinds = tfm.layer_kinds(cfg)
        self.state_specs = self.opt_partition(self.pspecs)
        # the gradients' layout: the weights', Adafactor's keyed by its
        # stacked paths; then ZeRO-1's
        if cfg.optimizer == "adafactor":
            self.gspecs = jax_paths(self.pspecs, cfg, _stack_spec)
            abstract = jax_paths(abstract, cfg)
        else:
            self.gspecs = self.pspecs
        z = self.zspecs = (zero1_specs(cfg, self.gspecs, abstract, mesh)
                           if cfg.zero1 else dict(self.gspecs))
        # the state laid out like the gradients: the same as its specs but
        # for a 2-D leaf's column factor, which JAX keeps whole over an
        # axis that shards the leaf's columns
        self.compute_specs = self.state_specs
        if cfg.optimizer == "adafactor":
            self.compute_specs = type(self.state_specs)(
                step=P(), vr={k: P(*(z[k][:-1] if len(z[k]) > 1 else z[k]))
                              for k in z},
                vc={k: P(*(z[k][:-2] + z[k][-1:])) if len(z[k]) > 1
                    else P(None) for k in z})
        self._flags = self._split_flags(kinds)

    def _split_flags(self, kinds: list) -> dict:
        """What 'model' splits, read from the specs of the first layer of
        each mixer (every such layer's are alike): attention's q heads, kv
        heads and the MLP's d_ff, RG-LRU's `lru_width`, RWKV-6's d_model
        and d_ff columns, MLA's heads, the experts' and the shared
        expert's d_ff; the vocabulary; and whether 'data' splits the
        experts. Raises for RWKV-6 where 'model' divides only one of its
        d_model and d_ff (ROADMAP A9)."""
        def split(key, axis="model"):
            return key in self.pspecs and axis in sh.spec_axes(
                self.pspecs[key])

        def first(pred, leaf, axis="model"):
            i = next((i for i, k in enumerate(kinds) if pred(k)), None)
            return i is not None and split(f"blocks.{i}.{leaf}", axis)

        def mixer(name):
            return lambda k: tfm.KIND_MIXER[k] == name

        def moe(k):
            return k.endswith("_moe")

        rwkv = (first(mixer("rwkv"), "mix.wr"),
                first(mixer("rwkv"), "mix.cm_wk"))
        if rwkv[0] != rwkv[1]:
            # a time mix split by d_model columns beside a channel mix
            # whole over d_ff, or the other way round
            raise later("tensor parallelism over 'model' for RWKV-6 where "
                        "'model' divides only one of d_model and d_ff")
        return dict(attn=first(mixer("attn"), "mix.wq"),
                    kv=first(mixer("attn"), "mix.wk"),
                    ffn=first(lambda k: not moe(k)
                              and tfm.KIND_MIXER[k] != "rwkv", "ffn.wu"),
                    vocab=split("embed"),
                    rec=first(mixer("rec"), "mix.wx"),
                    rwkv=rwkv[0],
                    mla=first(mixer("mla"), "mix.wq_b"),
                    ffn_expert=first(moe, "ffn.wu"),
                    shared=first(moe, "ffn.shared.wu"),
                    expert=first(moe, "ffn.wg", "data"))

    def _ctx(self, S: int, ndp_rows: int) -> sh.ShardCtx:
        """The layers' view of the mesh for a microbatch of S positions
        whose rows are split `ndp_rows` ways over the dp axes."""
        sp = (self.cfg.seq_parallel and not self.cfg.pure_dp
              and self.tp > 1 and S % self.tp == 0)
        dp = dp_axes(self.mesh, self.cfg) if ndp_rows > 1 else ()
        return sh.ShardCtx(self.mesh, self.cfg, tp=self.tp, sp=sp,
                           dp_axes=dp, ndp=ndp_rows, split=self._flags)

    def _model_partial(self, key: str, ctx: sh.ShardCtx) -> bool:
        """Whether each 'model' rank's gradient of a whole leaf is a part
        of it: a norm on the sequence-parallel residual stream, or a leaf
        of a token mixer that 'model' splits, which each rank reads for
        its own heads or columns only (qwen3's q/k norms, the k/v weights
        of heads 'model' does not divide, MLA's latent projections and
        norms, RG-LRU's convolution, biases and Λ, RWKV-6's token-shift
        LoRA, decay, bonus and group norm). `key` is a weights' key
        ("blocks.3.mix.mu.r") or, for Adafactor, a JAX path
        ("pattern.0.mix.wq_a")."""
        if ctx.tp == 1 or "model" in sh.spec_axes(self.gspecs[key]):
            return False
        parts = key.split(".")
        if len(parts) < 2:            # embed, unembed: whole, read whole
            return False
        if parts[-2] in _NORMS:
            return ctx.sp
        return parts[2] == "mix" and ctx.sharded(
            tfm.KIND_MIXER[self._kind_of(parts)])

    def _kind_of(self, parts: list) -> str:
        """The layer kind of a block's key: "blocks.i...", or a JAX path
        "prefix.i...", "pattern.j..." (slot j of the pattern) or
        "suffix.i..."."""
        i = int(parts[1])
        if parts[0] == "blocks":
            return tfm.layer_kinds(self.cfg)[i]
        pre, pat, _, suf = self.cfg.layer_kinds()
        return {"prefix": pre, "pattern": pat, "suffix": suf}[parts[0]][i]

    def _split(self, mb: int) -> int:
        """The ways a microbatch's rows split over the dp axes (1: every
        rank takes them all)."""
        dp = _dp_or_none(self.mesh, mb, self.cfg)
        return 1 if dp is None else sh.entry_size(self.mesh, dp)

    def gathered_params(self, leaf=lambda t: t) -> dict:
        """Every leaf whole, keyed like the weights, each passed through
        `leaf` as it is gathered (on a mesh every rank takes part and rank
        0 gets the leaves, on its host; the others get None)."""
        if self.mesh is None:
            return {k: leaf(p.detach()) for k, p in
                    self.params.state_dict().items()}
        return {k: leaf(sh.gather_root(p.detach(), self.pspecs[k],
                                       self.mesh))
                for k, p in self.params.state_dict().items()}

    @torch.no_grad()
    def load_full(self, state_dict: dict) -> None:
        """Whole leaves (keyed like the weights) into this rank's
        shards."""
        for k, p in self.params.state_dict().items():
            full = state_dict[k]
            if self.mesh is not None:
                full = sh.shard_of(full, self.pspecs[k], self.mesh)
            p.copy_(full)

    def abstract_opt(self):
        """The whole optimizer state as meta tensors, keyed as `init_opt`
        keys it."""
        w = self.abstract_params()
        if self._adafactor():
            return adafactor_init(jax_paths(w, self.cfg))
        return adamw_init(w)

    def opt_shard(self, state):
        """A whole optimizer state (keyed as `init_opt` keys it) -> this
        rank's shards on the model's device (on one device, the state as
        it is)."""
        if self.mesh is None:
            return state
        specs = self.state_specs

        def piece(v, spec):
            return sh.shard_of(v, spec, self.mesh).to(self.device,
                                                      copy=True)

        return type(state)(state.step.to(self.device), *(
            {k: piece(v, sp[k]) for k, v in d.items()}
            for d, sp in zip(state[1:], specs[1:])))

    def opt_gather(self, state, leaf=lambda t: t):
        """An optimizer state of this rank's shards -> whole leaves, each
        passed through `leaf` as it is gathered (on rank 0, as
        `gathered_params`)."""
        if self.mesh is None:
            return type(state)(leaf(state.step),
                               *({k: leaf(v) for k, v in d.items()}
                                 for d in state[1:]))
        specs = self.state_specs
        step = state.step.cpu() if self.mesh.rank == 0 else None
        return type(state)(leaf(step), *(
            {k: leaf(sh.gather_root(v, sp[k], self.mesh))
             for k, v in d.items()}
            for d, sp in zip(state[1:], specs[1:])))

    # ---- training ---------------------------------------------------------
    def _weights(self) -> dict:
        return dict(self.params.named_parameters())

    def _adafactor(self) -> bool:
        return self.cfg.optimizer == "adafactor"

    def init_opt(self):
        """Fresh optimizer state for `cfg.optimizer` over the weights (on
        a mesh, this rank's shards of it)."""
        w = {k: p.detach() for k, p in self._weights().items()}
        if self._adafactor():
            w = jax_paths(w, self.cfg)
        if self.mesh is None:
            return adafactor_init(w) if self._adafactor() else adamw_init(w)
        w = {k: sh.slice_extra(v, self.gspecs[k], self.zspecs[k], self.mesh)
             for k, v in w.items()}
        state = adafactor_init(w) if self._adafactor() else adamw_init(w)
        return self._relayout(state, to_specs=True)

    def _relayout(self, state, to_specs: bool):
        """An optimizer state of this rank's shards from the gradients'
        layout to its specs' (`to_specs`), or back."""
        mesh = self.mesh
        if self.compute_specs is self.state_specs:
            return state
        out = []
        for d, sp, cp in zip(state[1:], self.state_specs[1:],
                             self.compute_specs[1:]):
            if to_specs:
                out.append({k: sh.gather(v, cp[k], mesh, from_spec=sp[k])
                            for k, v in d.items()})
            else:
                out.append({k: sh.slice_extra(v, sp[k], cp[k], mesh)
                            for k, v in d.items()})
        return type(state)(state.step, *out)

    def loss(self, batch):
        """(loss + 0.01 aux, {"loss", "aux"}) over the whole batch; on a
        mesh the first is this rank's part of the objective (its rows'
        share; the gradients summed over the ranks are the loss's) and the
        metrics are the whole batch's."""
        b = self._batch(batch)
        if self.mesh is None:
            return tfm.loss_fn(self.params, self.cfg, b)
        B = b["embeddings" if self.cfg.embed_inputs else "tokens"].shape[0]
        S = b["embeddings" if self.cfg.embed_inputs else "tokens"].shape[1]
        ctx = self._ctx(S, self._split(B))
        total, metrics = tfm.loss_fn(self.params, self.cfg,
                                     {k: ctx.rows(v) for k, v in b.items()},
                                     ctx=ctx)
        loss = metrics["loss"].detach()
        if ctx.ndp > 1:
            loss = self.mesh.all_sum(loss, ctx.dp_axes)
        return total, {"loss": loss, "aux": metrics["aux"].detach()}

    def train_step(self, opt_state, batch):
        cfg = self.cfg
        b = self._batch(batch)
        B = b["embeddings" if cfg.embed_inputs else "tokens"].shape[0]
        mb = min(cfg.microbatch, B)
        if B % mb:
            raise ValueError(f"batch {B} is not a multiple of the "
                             f"microbatch {mb}")
        n_micro = B // mb
        acc_dt = getattr(torch, cfg.grad_accum_dtype)
        if self.mesh is not None:
            return self._mesh_step(opt_state, b, mb, n_micro, acc_dt)
        weights = self._weights()
        acc, losses, auxes = None, [], []
        for i in range(n_micro):
            micro = {k: v[i * mb:(i + 1) * mb] for k, v in b.items()}
            total, metrics = tfm.loss_fn(self.params, cfg, micro)
            grads = torch.autograd.grad(total, list(weights.values()),
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, weights.values())]
            if acc is None:
                acc = [g.to(acc_dt) for g in grads]
            else:
                for a, g in zip(acc, grads):
                    a += g.to(acc_dt)
            del grads, total
            losses.append(metrics["loss"].detach())
            auxes.append(metrics["aux"].detach())
        grads = {k: a.div_(n_micro) for k, a in zip(weights, acc)}
        del acc
        params = {k: p.detach() for k, p in weights.items()}
        if self._adafactor():
            new, opt_state, gn = adafactor_update(
                jax_paths(grads, cfg), opt_state, jax_paths(params, cfg))
            new = unstack_paths(new, cfg)
        else:
            new, opt_state, gn = adamw_update(grads, opt_state, params)
        del grads, params
        with torch.no_grad():
            for k, p in weights.items():
                p.copy_(new.pop(k))
        return opt_state, {"loss": torch.stack(losses).mean(),
                           "aux": torch.stack(auxes).mean(),
                           "grad_norm": gn}

    def _mesh_step(self, opt_state, b, mb, n_micro, acc_dt):
        """`train_step` on this rank: its rows of each microbatch; each
        microbatch's gradient summed over the ranks in its own dtype (as
        GSPMD sums the partial products of JAX's step) into the ZeRO-1
        layout, then added in `grad_accum_dtype`; the optimizer on this
        rank's shards."""
        cfg = self.cfg
        S = b["embeddings" if cfg.embed_inputs else "tokens"].shape[1]
        ctx = self._ctx(S, self._split(mb))
        weights = self._weights()
        acc, losses, auxes = None, [], []
        for i in range(n_micro):
            micro = {k: ctx.rows(v[i * mb:(i + 1) * mb])
                     for k, v in b.items()}
            total, metrics = tfm.loss_fn(self.params, cfg, micro, ctx=ctx)
            grads = torch.autograd.grad(total, list(weights.values()),
                                        allow_unused=True)
            grads = {k: torch.zeros_like(p) if g is None else g
                     for (k, p), g in zip(weights.items(), grads)}
            del total
            if self._adafactor():
                grads = jax_paths(grads, cfg)
            grads = {k: self._reduce(k, grads.pop(k), ctx).to(acc_dt)
                     for k in list(grads)}
            if acc is None:
                acc = grads
            else:
                for k, g in grads.items():
                    acc[k] += g
            del grads
            losses.append(metrics["loss"].detach())
            auxes.append(metrics["aux"].detach())
        grads = {k: acc.pop(k).div_(n_micro) for k in list(acc)}
        opt_state, gn = self._sharded_update(grads, opt_state)
        loss = torch.stack(losses)
        if ctx.ndp > 1:
            loss = self.mesh.all_sum(loss, ctx.dp_axes)
        return opt_state, {"loss": loss.mean(),
                           "aux": torch.stack(auxes).mean(),
                           "grad_norm": gn}

    @torch.no_grad()
    def _reduce(self, k: str, g: torch.Tensor, ctx) -> torch.Tensor:
        """This rank's part of leaf k's gradient (the weights' layout) ->
        the sum over the ranks, this rank's piece of the ZeRO-1 layout."""
        mesh = self.mesh
        gs, zs = self.gspecs[k], self.zspecs[k]
        if self._model_partial(k, ctx):
            g = mesh.all_sum(g, "model")
        if not ctx.dp_axes:
            return sh.slice_extra(g, gs, zs, mesh).contiguous()
        # summed over the dp axes that neither ZeRO-1 adds (a
        # reduce-scatter) nor the leaf's own spec holds: an expert's
        # gradient on its 'data' rank is already the sum over the rows
        held = set(sh.spec_axes(zs))
        rest = tuple(a for a in ctx.dp_axes if a not in held)
        if rest:
            g = mesh.all_sum(g, rest)
        return sh.scatter_sum(g, gs, zs, mesh)

    @torch.no_grad()
    def _sharded_update(self, grads: dict, opt_state):
        """The optimizer on this rank's shards of the gradients, the state
        and the weights (the ZeRO-1 layout), the new weights all-gathered
        back to `param_specs`."""
        cfg, mesh = self.cfg, self.mesh
        weights = self._weights()
        params = {k: p.detach() for k, p in weights.items()}
        if self._adafactor():
            params = jax_paths(params, cfg)
        shards = {k: sh.slice_extra(params[k], self.gspecs[k],
                                    self.zspecs[k], mesh) for k in grads}
        del params
        if self._adafactor():
            new, opt_state, gn = adafactor_update(
                grads, self._relayout(opt_state, to_specs=False), shards,
                stats=_ShardStats(self))
            opt_state = self._relayout(opt_state, to_specs=True)
        else:
            new, opt_state, gn = adamw_update(grads, opt_state, shards,
                                              norm=self._global_norm)
        del grads, shards
        new = {k: sh.gather(v, self.zspecs[k], mesh, from_spec=self.gspecs[k])
               for k, v in new.items()}
        if self._adafactor():
            new = unstack_paths(new, cfg)
        for k, p in weights.items():
            p.copy_(new.pop(k))
        return opt_state, gn

    def _global_norm(self, grads: dict) -> torch.Tensor:
        """AdamW's global gradient norm over the ranks' shards, each
        element counted once (a leaf whole over an axis is counted by the
        rank at coordinate 0 of it)."""
        parts = [torch.sum(torch.square(g.float())) for k, g in grads.items()
                 if sh.owner(self.zspecs[k], self.mesh)]
        total = torch.stack(parts).sum() if parts else torch.zeros(
            (), device=self.device)
        return torch.sqrt(self.mesh.all_sum(total))


class _ShardStats:
    """Adafactor's means over the dimensions of a leaf's shards: a sum
    over this rank's piece, reduced over the axes that shard that
    dimension, over the whole dimension's length."""

    def __init__(self, model: LMModel):
        self.mesh, self.specs = model.mesh, model.zspecs

    def mean(self, key, x, dim, leaf_dim, keepdim=False):
        entry = self.specs[key][leaf_dim]
        k = sh.entry_size(self.mesh, entry)
        s = torch.sum(x, dim=dim, keepdim=keepdim)
        if k > 1:
            s = self.mesh.all_sum(s, sh.entry_axes(entry))
        return s / (x.shape[dim] * k)

    def mean_all(self, key, x):
        axes = sh.spec_axes(self.specs[key])
        s = torch.sum(x)
        n = x.numel()
        if axes:
            s = self.mesh.all_sum(s, tuple(a for a in self.mesh.axis_names
                                           if a in axes))
            n *= sh.entry_size(self.mesh, axes)
        return s / n
