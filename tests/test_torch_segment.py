"""The PyTorch port's numpy helpers, stream generator, numpy oracle and
import boundary, held against the JAX package.

The port keeps its own copies of the JAX package's numpy-only helpers
(it may not import that package, whose __init__ imports JAX): here each
copy must give np.array_equal results on the same inputs.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench
from gelly_streaming_tpu.ops import host_triangles as jax_host
from gelly_streaming_tpu.ops import segment as jax_seg
from gelly_streaming_tpu_torch.core.platform import resolve_device
from gelly_streaming_tpu_torch.ops import host_triangles as port_host
from gelly_streaming_tpu_torch.ops import segment as port_seg
from gelly_streaming_tpu_torch.utils.streams import make_stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(a, b):
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 100, 4096, 4097, 65537])
def test_bucket_size(n):
    assert port_seg.bucket_size(n) == jax_seg.bucket_size(n)


@pytest.mark.parametrize("size,fill", [(5, 0), (9, -1), (16, 3)])
def test_pad_to(size, fill):
    arr = np.arange(5, dtype=np.int32)
    _equal(port_seg.pad_to(arr, size, fill), jax_seg.pad_to(arr, size, fill))
    rows = np.arange(10, dtype=np.int64).reshape(5, 2)
    _equal(port_seg.pad_to(rows, size, fill),
           jax_seg.pad_to(rows, size, fill))


@pytest.mark.parametrize("n,eb", [(0, 8), (16, 8), (37, 8), (1000, 256)])
def test_window_stack(n, eb):
    rng = np.random.default_rng(n)
    src = rng.integers(0, 50, n)
    dst = rng.integers(0, 50, n)
    _equal(port_seg.window_stack(src, dst, eb, sentinel=64),
           jax_seg.window_stack(src, dst, eb, sentinel=64))


def test_stack_window_list_and_rows():
    rng = np.random.default_rng(1)
    wins = [(rng.integers(0, 30, m), rng.integers(0, 30, m))
            for m in (0, 3, 16, 11)]
    _equal(port_seg.stack_window_list(wins, 16, 32),
           jax_seg.stack_window_list(wins, 16, 32))
    _equal(port_seg.stack_window_rows(wins, 8, 16, 32),
           jax_seg.stack_window_rows(wins, 8, 16, 32))
    too_long = wins + [(np.zeros(17, np.int64), np.ones(17, np.int64))]
    with pytest.raises(ValueError):
        port_seg.stack_window_list(too_long, 16, 32)


@pytest.mark.parametrize("at,hi", [(0, 8), (8, 13), (0, 1), (3, 6)])
def test_pad_window_chunk(at, hi):
    _w, s, d, valid = port_seg.window_stack(
        np.arange(13 * 4), np.arange(13 * 4)[::-1], 4, sentinel=99)
    _equal(port_seg.pad_window_chunk(s, d, valid, at, hi, 8, 4, 99),
           jax_seg.pad_window_chunk(s, d, valid, at, hi, 8, 4, 99))


def test_intern():
    a = np.array([900, -3, 7, 900, 12])
    b = np.array([7, 7, 5])
    _equal(port_seg.intern(a, b), jax_seg.intern(a, b))


@pytest.mark.parametrize("edges,verts,seed", [(1000, 64, 7), (4096, 65536, 7),
                                              (777, 300, 3)])
def test_make_stream_matches_bench(edges, verts, seed):
    ps, pd = make_stream(edges, verts, seed=seed)
    bs, bd = bench.make_stream(edges, verts, seed=seed)
    _equal((ps, pd), (bs, bd))


@pytest.mark.parametrize("seed", range(4))
def test_host_triangles_matches_jax_package(seed):
    rng = np.random.default_rng(seed)
    # self-loops and duplicates among 40 ids
    src, dst = rng.integers(0, 40, 600), rng.integers(0, 40, 600)
    if seed == 3:   # negative and huge ids take the compression path
        src, dst = (src - 20) * (1 << 34), (dst - 20) * (1 << 34)
    assert port_host.window_count(src, dst) == jax_host.window_count(
        src, dst)
    assert port_host.count_stream(src, dst, 128) == jax_host.count_stream(
        src, dst, 128)
    wins = [(src[:100], dst[:100]), (src[100:], dst[100:])]
    assert port_host.count_windows(wins) == jax_host.count_windows(wins)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (this one has JAX loaded by conftest):
    importing every module of the port (the summary, GNN, dense
    triangle and tenant cohort paths' among them), and chip_smoke, loads
    neither `jax` nor `gelly_streaming_tpu`. The compact wire and the
    ingress pipeline, numpy-only modules in the JAX package too, are the
    port's own copies."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import gelly_streaming_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith(('jax.', 'jaxlib'))\n"
        "             or n == 'gelly_streaming_tpu'\n"
        "             or n.startswith('gelly_streaming_tpu.'))\n"
        "assert not bad, bad\n"
        "for m in ('ops.unionfind', 'ops.host_summary',\n"
        "          'ops.window_summary', 'ops.scan_analytics',\n"
        "          'ops.staging', 'ops.gnn_window', 'ops.gnn_round',\n"
        "          'ops.dense_triangles', 'ops.cohort_summary',\n"
        "          'core.tenancy', 'ops.compact_ingress',\n"
        "          'ops.ingress_pipeline'):\n"
        "    assert 'gelly_streaming_tpu_torch.' + m in sys.modules, m\n"
        "print('clean', len([n for n in sys.modules\n"
        "                    if n.startswith('gelly_streaming_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("clean")
    assert int(out.stdout.split()[1]) >= 24


# ---- the fold/reduce half (ops/segment.py :51-211 of the JAX package) ----

def _segments(seed, n_seg=23):
    """Sorted segment ids of very unequal lengths (one hub segment of
    hundreds of edges, many of one or two), with segment ids absent."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 3, n_seg)
    lens[5] = 400
    lens[n_seg - 1] = 1
    seg = np.repeat(np.arange(n_seg), lens).astype(np.int32)
    vals = rng.integers(-100, 100, len(seg)).astype(np.int64)
    return seg, vals, n_seg


def _jnp_fns():
    import jax.numpy as jnp
    return {"add": (torch.add, jnp.add),
            "max": (torch.maximum, jnp.maximum),
            "take_right": (lambda a, b: b, lambda a, b: b),
            "affine": (lambda a, b: a * 3 - b, lambda a, b: a * 3 - b)}


@pytest.mark.parametrize("fn", ["add", "max", "take_right", "affine"])
@pytest.mark.parametrize("seed", [0, 1])
def test_segmented_reduce_matches_jax(fn, seed):
    """The stepped fold in arrival order (a non-commutative and a
    non-associative fn included) equals the JAX lax.scan fold."""
    seg, vals, n_seg = _segments(seed)
    pf, jf = _jnp_fns()[fn]
    got, gh = port_seg.segmented_reduce(pf, seg, vals, n_seg, "cpu")
    want, wh = jax_seg.segmented_reduce(jf, seg, vals, n_seg)
    np.testing.assert_array_equal(gh, np.asarray(wh))
    np.testing.assert_array_equal(got[gh], np.asarray(want)[gh])
    assert got.dtype == np.asarray(want).dtype


@pytest.mark.parametrize("fn", ["add", "max", "take_right"])
@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_segmented_reduce_associative_matches_jax(fn, dtype):
    seg, vals, n_seg = _segments(2)
    vals = vals.astype(dtype) / (7 if dtype == np.float64 else 1)
    pf, jf = _jnp_fns()[fn]
    got, gh = port_seg.segmented_reduce_associative(pf, seg, vals, n_seg,
                                                    "cpu")
    want, wh = jax_seg.segmented_reduce_associative(jf, seg, vals, n_seg)
    np.testing.assert_array_equal(gh, np.asarray(wh))
    if fn == "add" and dtype == np.float64:
        np.testing.assert_allclose(got[gh], np.asarray(want)[gh],
                                   rtol=1e-5)
    else:
        np.testing.assert_array_equal(got[gh], np.asarray(want)[gh])
    slow, sh = port_seg.segmented_reduce(pf, seg, vals, n_seg, "cpu")
    np.testing.assert_array_equal(sh, gh)


def test_segmented_fold_tree_matches_jax():
    """A tuple accumulator folding (vertex, neighbor, value) fields over
    unequal segments: every lane of every segment equals the JAX fold;
    a segment with no edges reports has_any False."""
    import jax.numpy as jnp
    seg, vals, n_seg = _segments(3)
    nbr = (vals * 7) % 31
    fields = (seg.astype(np.int64), nbr, vals)
    fold_p = lambda acc, v, u, x: (v, acc[1] * 2 + x - u, acc[2] + 1)  # noqa
    init_p = tuple(torch.tensor(0, dtype=torch.int32) for _ in range(3))
    init_j = tuple(jnp.zeros((), jnp.int32) for _ in range(3))
    got, gh = port_seg.segmented_fold(fold_p, init_p, seg, fields, n_seg,
                                      "cpu")
    want, wh = jax_seg.segmented_fold(fold_p, init_j, seg, fields, n_seg)
    np.testing.assert_array_equal(gh, np.asarray(wh))
    assert not gh.all()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[gh], np.asarray(w)[gh])
    empty, eh = port_seg.segmented_fold(fold_p, init_p, seg[:0],
                                        tuple(f[:0] for f in fields), 4,
                                        "cpu")
    assert not eh.any() and len(empty) == 3


@pytest.mark.parametrize("kind", ["sum", "min", "max", "count"])
def test_segment_reduce_matches_jax(kind):
    import jax.numpy as jnp
    rng = np.random.default_rng(4)
    ids = rng.integers(0, 12, 200).astype(np.int32)
    ids[:5] = 40                       # out of range: dropped
    vals = rng.integers(-50, 50, 200).astype(np.int32)
    got = port_seg.segment_reduce(torch.from_numpy(vals),
                                  torch.from_numpy(ids), 16, kind)
    want = jax_seg.segment_reduce(jnp.asarray(vals), jnp.asarray(ids), 16,
                                  kind)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_degree_update_matches_jax():
    import jax.numpy as jnp
    state = np.arange(9, dtype=np.int32)
    src = np.array([0, 1, 8, 8], np.int32)
    dst = np.array([2, 2, 8, 3], np.int32)
    got = port_seg.degree_update(torch.from_numpy(state.copy()),
                                 torch.from_numpy(src), torch.from_numpy(dst))
    want = jax_seg.degree_update(jnp.asarray(state.copy()),
                                 jnp.asarray(src), jnp.asarray(dst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert port_seg.warm_stream_buckets(None) is None
