"""Shards of the LM's tensors on a mesh, and the collectives its layers run.

The JAX package states where each tensor lives (`with_sharding_constraint`
and the specs of `models.model`) and GSPMD inserts the collectives. The
port is SPMD on `torch.distributed`: each rank holds its shards and the
layers call the collectives themselves. This module holds:

- `P`, a partition spec: one entry per dimension, an axis name, a tuple of
  axis names (row-major over them, in mesh order) or None;
- `shard_of` / `gather` / `slice_extra`: a full leaf sliced to this rank's
  piece by its spec, and the pieces gathered back (`gather_root`: on rank
  0 only, as a checkpoint needs them);
- the autograd-aware collectives over one mesh dimension (forward,
  backward): `copy_to` (identity, all-reduce) and `reduce_from`
  (all-reduce, identity) around a column- and a row-parallel product;
  `gather_seq` (all-gather, reduce-scatter) and `scatter_seq`
  (reduce-scatter, all-gather) for sequence parallelism; `gather_rep`
  (all-gather, keep this rank's piece) and `slice_seq` (keep this rank's
  piece, all-gather) around a product that every rank computes whole;
  `gather_sum` (all-gather a feature dimension, reduce-scatter) for the
  input of a product whose weight's columns 'model' splits, read whole
  by each rank for its own output columns (RG-LRU's gates, RWKV-6's
  decay LoRA, a wkv head that 'model' cuts);
- `enter_pair`: one gather of a sublayer's input as two views, one read
  for this rank's columns (its gradient a part, summed) and one read
  whole (its gradient whole, kept), as a MoE layer reads its input for
  the experts' d_ff columns and for the router;
- `ShardCtx`, what a layer needs to know of the mesh for one microbatch.

Every collective goes through `core.mesh.Mesh`, so gloo ranks on a card
copy through host memory.
"""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["P", "entry_axes", "entry_size", "spec_axes", "owner",
           "shard_of", "gather", "gather_root", "slice_extra",
           "scatter_sum", "copy_to",
           "reduce_from", "gather_seq", "scatter_seq", "gather_rep",
           "slice_seq", "gather_sum", "enter_pair", "ShardCtx"]


class P(tuple):
    """A partition spec: `P("model", None)`, like
    `jax.sharding.PartitionSpec` (which also holds a one-axis tuple entry
    as that axis's name)."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry (none for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def entry_size(mesh, entry) -> int:
    n = 1
    for a in entry_axes(entry):
        n *= mesh.shape[a]
    return n


def _piece(t: torch.Tensor, dim: int, mesh, entry) -> torch.Tensor:
    k = entry_size(mesh, entry)
    if k == 1:
        return t
    n = t.shape[dim] // k
    return t.narrow(dim, mesh.index(entry_axes(entry)) * n, n)


def shard_of(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's piece of a full leaf (a view)."""
    for dim, entry in enumerate(spec):
        full = _piece(full, dim, mesh, entry)
    return full


def slice_extra(local: torch.Tensor, spec, to_spec, mesh) -> torch.Tensor:
    """A leaf held by `spec` sliced further to `to_spec`, which shards a
    dimension that `spec` leaves whole (ZeRO-1's extra axis)."""
    for dim, (a, b) in enumerate(zip(spec, to_spec)):
        if a is None and b is not None:
            local = _piece(local, dim, mesh, b)
    return local


def _gather_dim(x: torch.Tensor, dim: int, mesh, entry) -> torch.Tensor:
    axes = entry_axes(entry)
    if entry_size(mesh, entry) == 1:
        return x
    if dim == 0:
        return mesh.all_gather(x.contiguous(), axes)
    out = mesh.all_gather(x.movedim(dim, 0).contiguous(), axes)
    return out.movedim(0, dim)


def _scatter_dim(x: torch.Tensor, dim: int, mesh, entry) -> torch.Tensor:
    """Sum over the axes of `entry` and keep this rank's piece of `dim`."""
    axes = entry_axes(entry)
    if entry_size(mesh, entry) == 1:
        return x
    if dim == 0:
        return mesh.psum_scatter(x.contiguous(), axes)
    out = mesh.psum_scatter(x.movedim(dim, 0).contiguous(), axes)
    return out.movedim(0, dim).contiguous()


def gather(local: torch.Tensor, spec, mesh, from_spec=None) -> torch.Tensor:
    """The inverse of `shard_of` (every rank gets the full leaf); with
    `from_spec`, the inverse of `slice_extra` (back to `from_spec`)."""
    for dim, entry in enumerate(spec):
        if entry is None or (from_spec is not None
                             and from_spec[dim] is not None):
            continue
        local = _gather_dim(local, dim, mesh, entry)
    return local


def gather_root(local: torch.Tensor, spec, mesh):
    """The whole leaf on the host of rank 0 (None on the others): each
    rank sends its piece once, and a leaf no axis shards is rank 0's own
    (no collective)."""
    if not spec_axes(spec):
        return local.cpu() if mesh.rank == 0 else None
    pieces = mesh.gather_to(local)
    if pieces is None:
        return None
    sizes = [entry_size(mesh, e) for e in spec]
    full = torch.empty([n * k for n, k in zip(local.shape, sizes)],
                       dtype=local.dtype)
    for r, piece in enumerate(pieces):
        coord = dict(zip(mesh.axis_names, mesh.coord_of(r)))
        view = full
        for dim, e in enumerate(spec):
            idx = 0
            for a in entry_axes(e):
                idx = idx * mesh.shape[a] + coord[a]
            n = local.shape[dim]
            view = view.narrow(dim, idx * n, n)
        view.copy_(piece)
    return full


def scatter_sum(x: torch.Tensor, spec, to_spec, mesh) -> torch.Tensor:
    """Sum `x` (held by `spec`) over the axes that `to_spec` adds, keeping
    this rank's piece of each such dimension (a reduce-scatter)."""
    for dim, (a, b) in enumerate(zip(spec, to_spec)):
        if a is None and b is not None:
            x = _scatter_dim(x, dim, mesh, b)
    return x


# ---------------------------------------------------------------------------
# autograd-aware collectives over one mesh dimension
# ---------------------------------------------------------------------------

class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_sum(g, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_dim(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter_dim(g, ctx.dim, ctx.mesh, ctx.axis), None, None, None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _scatter_dim(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.mesh, ctx.axis), None, None, None


class _GatherRep(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _gather_dim(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return (_piece(g, ctx.dim, ctx.mesh, ctx.axis).contiguous(), None,
                None, None)


class _SliceSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _piece(x, dim, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_dim(g, ctx.dim, ctx.mesh, ctx.axis), None, None, None


def copy_to(x, mesh, axis):
    """Identity; the backward all-reduces over `axis` (the input of a
    column-parallel product)."""
    return _CopyTo.apply(x, mesh, axis)


def reduce_from(x, mesh, axis):
    """All-reduce over `axis`; the backward is the identity (the output
    of a row-parallel product, or a sum whose every term is needed)."""
    return _ReduceFrom.apply(x, mesh, axis)


def gather_seq(x, mesh, axis, dim=1):
    """All-gather `dim` over `axis`; the backward reduce-scatters (each
    rank's gradient of the whole is a part of the sum)."""
    return _GatherSeq.apply(x, mesh, axis, dim)


def scatter_seq(x, mesh, axis, dim=1):
    """Reduce-scatter `dim` over `axis`; the backward all-gathers."""
    return _ScatterSeq.apply(x, mesh, axis, dim)


def gather_rep(x, mesh, axis, dim=1):
    """All-gather `dim` over `axis` for a product every rank computes
    whole; the backward keeps this rank's piece of the (equal) gradient."""
    return _GatherRep.apply(x, mesh, axis, dim)


def slice_seq(x, mesh, axis, dim=1):
    """This rank's piece of `dim` of a tensor every rank holds whole; the
    backward all-gathers the pieces' gradients."""
    return _SliceSeq.apply(x, mesh, axis, dim)


def gather_sum(x, mesh, axis, dim=-1):
    """All-gather a feature dimension `dim` over `axis` for a product that
    each rank computes for its own output columns only: each rank's
    gradient of the whole is a part of the sum, so the backward
    reduce-scatters (not `gather_rep`'s piece of an equal gradient)."""
    return _GatherSeq.apply(x, mesh, axis, dim)


class _EnterPair(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        y = _gather_dim(x, dim, mesh, axis)
        return y, y.view_as(y)

    @staticmethod
    def backward(ctx, g_part, g_whole):
        # an unused view's gradient comes as zeros: every rank runs the
        # same collectives
        g = _scatter_dim(g_part, ctx.dim, ctx.mesh, ctx.axis)
        return (g + _piece(g_whole, ctx.dim, ctx.mesh, ctx.axis),
                None, None, None)


def enter_pair(x, mesh, axis, dim=1):
    """All-gather `dim` over `axis` once, as two views of the result:
    (one read by each rank for its own columns, whose backward
    reduce-scatters as `gather_seq`'s; one read whole by every rank alike,
    whose backward keeps this rank's piece as `gather_rep`'s). The
    input's gradient is the sum of the two."""
    return _EnterPair.apply(x, mesh, axis, dim)


# ---------------------------------------------------------------------------
# the layers' view of the mesh
# ---------------------------------------------------------------------------

class ShardCtx:
    """What the layers need of the mesh for one microbatch of S tokens.

    - `tp`: the "model" axis's size when it splits heads, d_ff and the
      vocabulary (1 under `pure_dp`, where "model" is a data axis);
    - `sp`: sequence parallelism (`cfg.seq_parallel`, not `pure_dp`,
      S divisible by `tp`): the residual stream holds this rank's S / tp
      positions between the layers;
    - `dp_axes`, `ndp`: the data axes and their size when the microbatch's
      rows are split over them, else ((), 1);
    - `split`: whether the specs put "model" on each part, by name:
      "attn" the q heads, "kv" the kv heads, "ffn" d_ff, "vocab" the
      vocabulary, "rec" RG-LRU's `lru_width`, "rwkv" RWKV-6's d_model and
      d_ff columns, "mla" MLA's heads, "ffn_expert" the experts' d_ff,
      "shared" the shared expert's d_ff; and "expert": whether they put
      "data" on the experts (`_sanitize` leaves a dimension whole that
      its axis does not divide).
    """

    def __init__(self, mesh, cfg, *, tp: int, sp: bool, dp_axes: tuple,
                 ndp: int, split: dict):
        self.mesh, self.cfg = mesh, cfg
        self.tp, self.sp = tp, sp
        self.dp_axes, self.ndp = dp_axes, ndp
        self.split = split
        self.m = mesh.index("model") if tp > 1 else 0

    def sharded(self, mixer: str) -> bool:
        """Whether 'model' splits a token mixer's weights ("attn", "mla",
        "rec" or "rwkv", `transformer.KIND_MIXER`'s names)."""
        return self.tp > 1 and self.split[mixer]

    # -- around a sublayer ---------------------------------------------------

    def enter(self, x, sharded: bool):
        """The sublayer's input: the whole sequence; under `sharded` each
        rank's gradient of it is a part that the backward sums."""
        if self.tp == 1:
            return x
        if not self.sp:
            return copy_to(x, self.mesh, "model") if sharded else x
        if sharded:
            return gather_seq(x, self.mesh, "model")
        return gather_rep(x, self.mesh, "model")

    def enter_pair(self, x):
        """The sublayer's input twice, for a sublayer that reads it both
        for this rank's columns and whole (a MoE layer's experts and
        shared expert over d_ff columns, its router whole): (`enter(x,
        True)`, `enter(x, False)`) from one collective."""
        if self.tp == 1:
            return x, x
        if not self.sp:
            return copy_to(x, self.mesh, "model"), x
        return enter_pair(x, self.mesh, "model")

    def leave(self, y, sharded: bool):
        """The sublayer's output back on the residual stream: summed over
        "model" under `sharded`, this rank's positions under `sp`."""
        if self.tp == 1:
            return y
        if not self.sp:
            return reduce_from(y, self.mesh, "model") if sharded else y
        if sharded:
            return scatter_seq(y, self.mesh, "model")
        return slice_seq(y, self.mesh, "model")

    def local_seq(self, x, dim=1):
        """This rank's positions of a tensor that needs no gradient."""
        if not self.sp:
            return x
        return _piece(x, dim, self.mesh, "model")

    # -- attention's kv heads ------------------------------------------------

    def kv_heads(self, n_heads_local: int):
        """Under sharded q heads and whole k / v heads: `kv_map`. None
        when k / v are sharded like q or nothing is."""
        if self.tp == 1 or not self.split["attn"] or self.split["kv"]:
            return None
        return self.kv_map(n_heads_local)

    def kv_map(self, n_heads_local: int):
        """(the first and one past the last kv head this rank's q heads
        read, the index of each q head's kv head among them when they do
        not group evenly, else None)."""
        cfg = self.cfg
        G = cfg.n_heads // cfg.n_kv_heads
        h0 = self.m * n_heads_local if self.split["attn"] else 0
        ids = [(h0 + i) // G for i in range(n_heads_local)]
        lo, hi = ids[0], ids[-1] + 1
        kl = hi - lo
        gl = n_heads_local // kl if n_heads_local % kl == 0 else 0
        regular = gl and all(k - lo == i // gl for i, k in enumerate(ids))
        return lo, hi, None if regular else [k - lo for k in ids]

    # -- the vocabulary ------------------------------------------------------

    def embed(self, table, tokens):
        """Rows of the embedding: over a vocabulary sharded on "model",
        each rank looks up the ids it owns (zeros for the rest) and the
        results are summed over "model" (under `sp`, each rank keeps its
        positions of the sum)."""
        if self.tp == 1:
            return table[tokens.long()]
        if not self.split["vocab"]:
            x = table[tokens.long()]
            return slice_seq(x, self.mesh, "model") if self.sp else x
        n = table.shape[0]
        lo = self.m * n
        t = tokens.long() - lo
        own = (t >= 0) & (t < n)
        x = table[t.clamp(0, n - 1)] * own[..., None].to(table.dtype)
        if self.sp:
            return scatter_seq(x, self.mesh, "model")
        return reduce_from(x, self.mesh, "model")

    def cross_entropy(self, logits, tgt):
        """Per-token (logsumexp - label logit) of f32 logits [B, S', V']
        against labels [B, S']: over a vocabulary sharded on "model" the
        row max and the sum of exponentials are reduced over "model", and
        the rank that owns a label supplies its logit."""
        if self.tp == 1 or not self.split["vocab"]:
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, tgt[..., None])[..., 0]
            return lse - ll
        n = logits.shape[-1]
        lo = self.m * n
        m = self.mesh.all_max(logits.detach().amax(dim=-1), "model")
        se = torch.exp(logits - m[..., None]).sum(dim=-1)
        lse = m + torch.log(reduce_from(se, self.mesh, "model"))
        t = tgt - lo
        own = (t >= 0) & (t < n)
        ll = torch.gather(logits, -1, t.clamp(0, n - 1)[..., None])[..., 0]
        ll = reduce_from(ll * own.to(ll.dtype), self.mesh, "model")
        return lse - ll

    # -- serving -------------------------------------------------------------

    def gather_heads(self, x, dim: int = 2):
        """Every rank's heads of `x` (dimension `dim`) over 'model', in
        rank order: the whole head dimension."""
        return _gather_dim(x, dim, self.mesh, "model")

    def own(self, x, dim: int = -1):
        """This rank's piece of `dim` (its heads, its columns) of a leaf
        or tensor every rank holds whole (a view; the gradient of a leaf
        read so is a part of the sum over 'model',
        `LMModel._model_partial`)."""
        return _piece(x, dim, self.mesh, "model")

    # -- the feature columns of a mixer that 'model' splits ------------------

    def gather_cols(self, x):
        """The whole last dimension of x from every rank's columns, for a
        product each rank takes for its own output columns
        (`gather_sum`: the backward sums the ranks' parts)."""
        return gather_sum(x, self.mesh, "model", dim=-1)

    def merge_softmax(self, m, l, o):
        """Attention's partial statistics over this rank's positions (row
        max m [...], sum of exponentials l [...], unnormalised output o
        [..., Dv], f32) merged over 'model' into the normalised output:
        every rank gathers the partials and folds them in rank order, so
        every rank gets the same bits."""
        k = self.tp
        parts = self.mesh.all_gather(
            torch.cat([m[..., None], l[..., None], o], dim=-1)[None],
            "model")
        ms, ls, os_ = parts[..., 0], parts[..., 1], parts[..., 2:]
        mx = ms[0]
        for r in range(1, k):
            mx = torch.maximum(mx, ms[r])
        tot_l = torch.zeros_like(l)
        tot_o = torch.zeros_like(o)
        for r in range(k):
            w = torch.exp(ms[r] - mx)
            tot_l = tot_l + ls[r] * w
            tot_o = tot_o + os_[r] * w[..., None]
        return tot_o / tot_l[..., None]

    def last_position(self, x):
        """x[:, -1:] of the whole sequence: under `sp`, the last rank of
        'model' holds it and every rank gets its copy."""
        if not self.sp:
            return x[:, -1:]
        got = self.mesh.all_gather(x[:, -1:].contiguous(), "model")
        return got[-x.shape[0]:]

    def whole_logits(self, logits):
        """Logits [B', s, V'] of this rank's rows and vocabulary shard ->
        the whole batch's over the whole vocabulary, the same bits on
        every rank: the vocabulary gathered over 'model' (each shard
        computed by one rank), or, where 'model' leaves it whole, model
        rank 0's copy; then the rows gathered over the data axes."""
        if self.tp > 1:
            if self.split["vocab"]:
                logits = _gather_dim(logits, logits.dim() - 1, self.mesh,
                                     "model")
            else:
                logits = self.mesh.all_gather(logits[None].contiguous(),
                                              "model")[0]
        if self.ndp > 1:
            logits = self.mesh.all_gather(logits.contiguous(), self.dp_axes)
        return logits

    # -- the data axes -------------------------------------------------------

    def gather_rows(self, x):
        """The whole microbatch's rows (MoE's routing and capacity span
        them): an all-gather over the data axes whose backward sums."""
        if self.ndp == 1:
            return x
        return gather_seq(x, self.mesh, self.dp_axes, dim=0)

    def rows(self, x):
        """This rank's rows of the whole microbatch (a view)."""
        if self.ndp == 1:
            return x
        return _piece(x, 0, self.mesh, self.dp_axes)

    # -- the experts over 'data' ---------------------------------------------

    def experts_in(self, x):
        """The experts' input, every row of the microbatch, for this rank's
        experts: where every rank holds all the rows (`ndp` 1), each rank's
        gradient of them covers its experts only, and the backward sums
        over 'data' (where the rows are split, `gather_rows`' backward
        sums them)."""
        if self.ndp > 1:
            return x
        return copy_to(x, self.mesh, "data")

    def experts_out(self, ye):
        """This rank's experts' outputs [E / nd, C, d] -> every expert's
        [E, C, d], in 'data' order. The backward: where the rows are
        split over the dp axes, each rank's gradient covers its own rows
        and the pieces are summed (a reduce-scatter); where every rank
        holds them all, each holds the same gradient and keeps its
        piece."""
        if self.ndp > 1:
            return gather_sum(ye, self.mesh, "data", dim=0)
        return gather_rep(ye, self.mesh, "data", dim=0)


def spec_axes(spec: Sequence) -> tuple:
    """Every mesh axis a spec shards over."""
    out = []
    for e in spec:
        out.extend(entry_axes(e))
    return tuple(out)


def owner(spec, mesh) -> bool:
    """Whether this rank holds the copy of its piece of a leaf that a sum
    over every element counts: coordinate 0 on each axis the spec leaves
    the leaf whole over."""
    used = set(spec_axes(spec))
    return all(c == 0 for a, c in zip(mesh.axis_names, mesh.coord)
               if a not in used)
