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
