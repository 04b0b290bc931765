"""repro_torch host builders and staging against the JAX package.

The port keeps its own numpy copy of `repro.core.graph` (importing the
original pulls in JAX). Same seed, same arrays: generators, batches,
apply_batch and every hybrid layout must be array-identical. Also: the
port imports neither `jax` nor `repro` (an AST scan), and staging defaults
to CUDA, raising where there is none.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jc  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.core.pagerank import slot_tile_table  # noqa: E402
from repro_torch.kernels.ell_bucket_pull import lanes_for  # noqa: E402

D_P, TILE = 8, 32
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _same_graph(a, b):
    assert a.n == b.n
    for f in ("offsets", "targets", "t_offsets", "t_sources"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _same_layout(a, b):
    """Every field of two host layouts (HybridLayout / HybridRows) equal."""
    assert type(a).__name__ == type(b).__name__
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "buckets":
            assert len(x) == len(y)
            for bx, by in zip(x, y):
                assert bx.width == by.width
                for g in ("rows", "idx", "mask"):
                    np.testing.assert_array_equal(getattr(bx, g),
                                                  getattr(by, g))
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y, f.name


# ---------------------------------------------------------------------------
# generators, batches, apply_batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gen,kw", [
    ("random_graph", dict(n=300, m=2500, seed=3)),
    ("powerlaw_graph", dict(n=300, m=2500, seed=0)),
    ("powerlaw_graph", dict(n=500, m=4000, alpha=1.0, seed=5)),
])
def test_generators_identical(gen, kw):
    _same_graph(getattr(jc, gen)(**kw), getattr(tc, gen)(**kw))


def test_random_batch_and_apply_batch_identical():
    gj, gt = jc.powerlaw_graph(300, 2500, seed=1), tc.powerlaw_graph(
        300, 2500, seed=1)
    for k in range(3):
        bj = jc.random_batch(gj, 0.02, seed=10 + k)
        bt = tc.random_batch(gt, 0.02, seed=10 + k)
        for f in ("del_src", "del_dst", "ins_src", "ins_dst"):
            np.testing.assert_array_equal(getattr(bj, f), getattr(bt, f))
        assert bj.size == bt.size
        gj, gt = jc.apply_batch(gj, bj), tc.apply_batch(gt, bt)
        _same_graph(gj, gt)


def test_temporal_stream_identical():
    bj, lj = jc.temporal_stream(400, 5000, 4, seed=2)
    bt, lt = tc.temporal_stream(400, 5000, 4, seed=2)
    _same_graph(bj, bt)
    assert len(lj) == len(lt)
    for x, y in zip(lj, lt):
        np.testing.assert_array_equal(x.ins_src, y.ins_src)
        np.testing.assert_array_equal(x.ins_dst, y.ins_dst)


@pytest.mark.parametrize("n,dtype", [(7, np.int32), (5, np.int64),
                                     (3, np.int32)])
def test_add_self_loops_identical(n, dtype):
    from repro.core.graph import add_self_loops as j_add_self_loops
    rng = np.random.default_rng(n)
    m = 0 if n == 3 else 11
    src, dst = (rng.integers(0, n, m).astype(dtype) for _ in range(2))
    got = tc.graph.add_self_loops(n, src, dst)
    want = j_add_self_loops(n, src, dst)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)
    assert "add_self_loops" in tc.graph.__all__


def test_key_and_ragged_primitives_identical():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 50, 40), rng.integers(0, 50, 40)
    keys = tc.edge_keys(50, src, dst)
    np.testing.assert_array_equal(keys, jc.edge_keys(50, src, dst))
    for a, b in zip(tc.keys_to_edges(50, keys), jc.keys_to_edges(50, keys)):
        np.testing.assert_array_equal(a, b)
    counts = rng.integers(0, 5, 20)
    np.testing.assert_array_equal(tc.ragged_positions(counts),
                                  jc.ragged_positions(counts))
    from repro.core.graph import next_pow2
    for x in (0, 1, 15, 17, 1000):
        assert tc.next_pow2(x) == next_pow2(x)


def test_sort_based_unique_and_isin_match_numpy():
    from repro_torch.core.graph import _isin, _sorted_unique
    rng = np.random.default_rng(7)
    for size, hi in ((0, 5), (1, 5), (50, 5), (1000, 10 ** 12)):
        a = rng.integers(0, hi, size)
        np.testing.assert_array_equal(_sorted_unique(a), np.unique(a))
        for b in (a[: size // 3], rng.integers(0, hi, 7), a[:0]):
            np.testing.assert_array_equal(_isin(a, b), np.isin(a, b))


def test_bucket_choice_and_partition_identical():
    g = tc.powerlaw_graph(500, 4000, seed=4)
    deg = g.in_degree()
    for d_p in (0, 8, 13, 64):
        w = tc.choose_bucket_widths(deg, d_p)
        assert w == jc.choose_bucket_widths(deg, d_p)
        if w:
            assert (tc.bucket_band_counts(deg, w, d_p)
                    == jc.bucket_band_counts(deg, w, d_p))
        pt, lt = tc.partition_by_degree(deg, d_p)
        pj, lj = jc.partition_by_degree(deg, d_p)
        np.testing.assert_array_equal(pt, pj)
        assert lt == lj


# ---------------------------------------------------------------------------
# hybrid layouts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["bucketed", "single", "d_p0", "forward"])
def test_build_hybrid_identical(layout):
    gj, gt = jc.powerlaw_graph(300, 2500, seed=6), tc.powerlaw_graph(
        300, 2500, seed=6)
    kw = {"bucketed": dict(d_p=D_P, tile=TILE),
          "single": dict(d_p=D_P, tile=TILE, widths=(D_P,)),
          "d_p0": dict(d_p=0, tile=TILE),
          "forward": dict(d_p=D_P, tile=TILE)}[layout]
    if layout == "forward":
        gj, gt = gj.transpose(), gt.transpose()
    lj, lt = jc.build_hybrid(gj, **kw), tc.build_hybrid(gt, **kw)
    _same_layout(lj, lt)
    assert tc.hybrid_caps(lt) == jc.hybrid_caps(lj)
    assert tc.layout_slot_stats(lt) == jc.layout_slot_stats(lj)


def test_build_hybrid_rows_fixed_caps_identical():
    g = tc.powerlaw_graph(300, 2500, seed=8)
    lay = tc.build_hybrid(g, d_p=D_P, tile=TILE)
    caps = tc.hybrid_caps(lay)
    caps = dict(caps, n_hi_cap=caps["n_hi_cap"] + 3, t_cap=caps["t_cap"] + 5,
                bucket_caps=tuple(c + 6 for c in caps["bucket_caps"]))
    del caps["d_p"], caps["tile"]
    _same_layout(
        jc.build_hybrid_rows(g.t_offsets, g.t_sources, d_p=D_P, tile=TILE,
                             n_rows=g.n + 4, **caps),
        tc.build_hybrid_rows(g.t_offsets, g.t_sources, d_p=D_P, tile=TILE,
                             n_rows=g.n + 4, **caps))


def test_to_device_reads_a_repro_layout():
    """`to_device` takes the JAX package's HybridLayout by its fields and
    stages exactly what it stages for its own layout."""
    lj = jc.build_hybrid(jc.powerlaw_graph(300, 2500, seed=9), d_p=D_P,
                         tile=TILE)
    lt = tc.build_hybrid(tc.powerlaw_graph(300, 2500, seed=9), d_p=D_P,
                         tile=TILE)
    a, b = tc.to_device(lj, device="cpu"), tc.to_device(lt, device="cpu")
    assert len(a.buckets) == len(b.buckets) == len(lt.buckets)
    for x, y in zip(a.buckets, b.buckets):
        for tx, ty in zip(x, y):
            assert torch.equal(tx, ty)
    for tx, ty in zip(a[1:], b[1:]):
        assert torch.equal(tx, ty)
    assert b.hi_tiles.dtype == torch.int32 and b.hi_tmask.dtype == torch.float32


def test_slot_tile_table_groups_tiles_by_slot_in_order():
    rowmap = np.array([2, 0, 2, 1, 0, 2, 3], np.int32)   # not sorted
    tiles, off = slot_tile_table(rowmap, 5)
    np.testing.assert_array_equal(off, [0, 2, 3, 6, 7, 7])
    np.testing.assert_array_equal(tiles, [1, 4, 3, 0, 2, 5, 6])
    for s in range(5):
        assert np.all(rowmap[tiles[off[s]:off[s + 1]]] == s)
        assert np.all(np.diff(tiles[off[s]:off[s + 1]]) > 0)


def test_lanes_per_row_divide_the_warp():
    assert [lanes_for(w) for w in (1, 2, 4, 8, 16, 32, 64, 48, 3)] == \
        [1, 1, 4, 8, 16, 32, 32, 32, 2]


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------

def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py",
              ROOT / "examples" / "torch_distributed_pagerank.py",
              ROOT / "examples" / "torch_train_lm.py"]
    files += sorted((ROOT / "scripts").glob("*.py"))
    files += [ROOT / "tests" / "test_torch_lm_mesh_workers.py",
              ROOT / "tests" / "test_torch_mesh_workers.py"]
    assert len(files) > 10
    # the sharded engines, their mesh and the elastic resume are scanned
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for mod in ("core/mesh.py", "core/distributed.py",
                "core/distributed2d.py", "stream/sharded.py",
                "train/elastic.py", "train/loop.py", "optim/adamw.py",
                "optim/adafactor.py", "optim/compress.py",
                "launch/train.py", "models/moe.py", "models/layers.py",
                "configs/qwen2_vl_2b.py", "configs/musicgen_large.py",
                "configs/dbrx_132b.py", "configs/deepseek_v3_671b.py",
                "configs/shapes.py", "launch/mesh.py", "models/shard.py",
                "models/model.py"):
        assert f"src/repro_torch/{mod}" in names, mod
    for f in files:
        bad = {m for m in _imported_roots(f) if m in ("jax", "jaxlib",
                                                      "repro")}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_staging_defaults_to_cuda_and_never_drops_to_cpu():
    g = tc.powerlaw_graph(50, 200, seed=0)
    lay = tc.build_hybrid(g, d_p=D_P, tile=TILE)
    b = tc.random_batch(g, 0.1, seed=1)
    calls = (lambda: tc.init_ranks(g.n), lambda: tc.to_device(lay),
             lambda: tc.device_graph(g, d_p=D_P, tile=TILE),
             lambda: tc.batch_to_device(b, g.n),
             lambda: tc.forward_device_graph(g, d_p=D_P, tile=TILE))
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            t = out if isinstance(out, torch.Tensor) else out[-1]
            assert t.is_cuda
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
    assert tc.init_ranks(g.n, device="cpu").device.type == "cpu"
