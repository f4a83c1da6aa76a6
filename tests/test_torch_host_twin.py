"""The port's host twins (gelly_streaming_tpu_torch/parallel/host_twin.py)
against the JAX package's twins, the port's single-chip summary engine
and the port's sharded engines on a one-rank gloo mesh in this process:
outputs and the carried state bit-equal (the sentinel slots as the
module docstring says), states handed off both ways, and the twin run
with every device path poisoned. The multi-rank hand-offs are in
tests/test_torch_sharded.py."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gelly_streaming_tpu.parallel import host_twin as jax_twin
from gelly_streaming_tpu_torch import StreamSummaryEngine, kernels
from gelly_streaming_tpu_torch.ops import staging
from gelly_streaming_tpu_torch.parallel import host_twin, mesh, sharded
from gelly_streaming_tpu_torch.utils import checkpoint

_MADE_GROUP = []


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def one():
    """The one-rank gloo mesh of this process."""
    if not dist.is_initialized():
        _MADE_GROUP.append(True)
    yield mesh.make_mesh(device="cpu")
    if _MADE_GROUP and dist.is_initialized():
        dist.destroy_process_group()
        _MADE_GROUP.clear()


def _edges(rng, v, n):
    return (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32))


def _clique_stream(seed: int, n: int, v: int, eb: int, at: int):
    rng = np.random.default_rng(seed)
    src, dst = _edges(rng, v, n)
    u, w = np.triu_indices(30, k=1)
    src[at * eb:(at + 1) * eb] = (u + 1)[:eb]
    dst[at * eb:(at + 1) * eb] = (w + 1)[:eb]
    return src, dst


def test_window_engine_twin_matches_jax_twin_and_sharded(one):
    rng = np.random.default_rng(3)
    vb = 64
    tw, jt = host_twin.HostWindowEngine(vb), jax_twin.HostWindowEngine(vb)
    sh = sharded.ShardedWindowEngine(one, num_vertices_bucket=vb)
    for i in range(3):   # carried state across windows
        s, d = _edges(rng, 50, 200)
        got = [e.degrees(s, d) for e in (tw, jt, sh)]
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[2])
        got = [e.cc_labels(s, d, carry=i > 0) for e in (tw, jt, sh)]
        np.testing.assert_array_equal(got[0], got[1])
        np.testing.assert_array_equal(got[0], got[2])
        got = [e.bipartite(s, d) for e in (tw, jt, sh)]
        for a, b, c in zip(*got):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    mine, theirs = tw.state_dict(), jt.state_dict()
    assert mine.keys() == theirs.keys() and mine["mesh_shape"] is None
    for key in ("degree_state", "labels", "bip_labels"):
        np.testing.assert_array_equal(mine[key], theirs[key])


def test_window_engine_state_hands_off_both_ways(one):
    rng = np.random.default_rng(4)
    vb = 64
    sh = sharded.ShardedWindowEngine(one, num_vertices_bucket=vb)
    s, d = _edges(rng, 50, 300)
    sh.degrees(s, d)
    sh.cc_labels(s, d)
    sh.bipartite(s, d)
    assert sh.state_dict()["mesh_shape"] == [1]
    tw = host_twin.HostWindowEngine.from_sharded(sh)
    s2, d2 = _edges(rng, 50, 300)
    np.testing.assert_array_equal(sh.cc_labels(s2, d2), tw.cc_labels(s2, d2))
    np.testing.assert_array_equal(sh.degrees(s2, d2), tw.degrees(s2, d2))
    # twin → mesh, and the JAX twin's state into the port's twin
    back = sharded.ShardedWindowEngine(one, num_vertices_bucket=vb)
    back.load_state_dict(tw.state_dict())
    jt = jax_twin.HostWindowEngine(vb)
    jt.load_state_dict(tw.state_dict())
    tw2 = host_twin.HostWindowEngine(vb)
    tw2.load_state_dict(jt.state_dict())
    s3, d3 = _edges(rng, 50, 200)
    want = tw.cc_labels(s3, d3)
    np.testing.assert_array_equal(back.cc_labels(s3, d3), want)
    np.testing.assert_array_equal(tw2.cc_labels(s3, d3), want)
    with pytest.raises(ValueError, match="vertex bucket mismatch"):
        host_twin.HostWindowEngine(32).load_state_dict(tw.state_dict())


def test_triangle_kernel_twin_matches_jax_twin_and_sharded(one):
    rng = np.random.default_rng(5)
    k = sharded.ShardedTriangleWindowKernel(one, edge_bucket=256,
                                            vertex_bucket=64)
    tw = host_twin.HostTriangleWindowKernel.from_sharded(k)
    jt = jax_twin.HostTriangleWindowKernel(k.eb, k.vb)
    assert (tw.eb, tw.vb) == (k.eb, k.vb)
    s, d = _edges(rng, 60, 1000)
    want = tw.count_stream(s, d)
    assert want == jt.count_stream(s, d) == k.count_stream(s, d)
    wins = [_edges(rng, 60, n) for n in (5, 100, 256)]
    assert tw.count_windows(wins) == jt.count_windows(wins) \
        == k.count_windows(wins)
    with pytest.raises(ValueError, match="exceeds edge bucket"):
        tw.count(np.zeros(tw.eb + 1, np.int32), np.ones(tw.eb + 1, np.int32))


def test_summary_twin_matches_jax_twin_and_both_engines(one):
    eb, v = 256, 200
    src, dst = _clique_stream(23, 1536 + 41, v, eb, 2)
    host = host_twin.HostSummaryEngine(eb, v)
    want = host.process(src, dst)
    jt = jax_twin.HostSummaryEngine(eb, v)
    assert jt.process(src, dst) == want
    single = StreamSummaryEngine(eb, v, k_bucket=8, device="cpu")
    assert single.process(src, dst) == want
    sh = sharded.ShardedSummaryEngine(one, eb, v, k_bucket=8)
    assert sh.process(src, dst) == want
    # every carry bit-equal, the sentinels included
    for other in (jt.state_dict(), single.state_dict(), sh.state_dict()):
        for a, b in zip(host.state_dict()["carry"], other["carry"]):
            np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(host.state(), sh.state()):
        np.testing.assert_array_equal(a, b)


def test_summary_twin_resumes_sharded_mid_stream(one):
    eb, v = 256, 200
    src, dst = _clique_stream(11, 2048, v, eb, 5)
    want = host_twin.HostSummaryEngine(eb, v).process(src, dst)
    sh = sharded.ShardedSummaryEngine(one, eb, v, k_bucket=8)
    head = sh.process(src[:1024], dst[:1024])
    tw = host_twin.HostSummaryEngine.from_sharded(sh)
    off = tw.resume_offset()
    assert off == 1024
    assert head + tw.process(src[off:], dst[off:]) == want
    # the JAX twin resumes from the port's sharded state as well
    jt = jax_twin.HostSummaryEngine.from_state(sh.state_dict())
    assert head + jt.process(src[off:], dst[off:]) == want


def test_summary_twin_needs_no_device(monkeypatch, tmp_path):
    """The twin runs with every kernel library and every staging copy
    poisoned, a checkpoint saved and resumed included."""
    eb, v = 256, 200
    src, dst = _clique_stream(2, 1024, v, eb, 1)
    want = host_twin.HostSummaryEngine(eb, v).process(src, dst)

    def poisoned(*_a, **_k):
        raise AssertionError("the host twin reached a device path")

    monkeypatch.setattr(kernels, "library", poisoned)
    monkeypatch.setattr(staging.ChunkStager, "put", poisoned)
    tw = host_twin.HostSummaryEngine(eb, v)
    head = tw.process(src[:512], dst[:512])
    path = str(tmp_path / "twin.ckpt")
    checkpoint.save(path, tw.state_dict())
    again = host_twin.HostSummaryEngine(eb, v)
    assert again.try_resume(path)
    assert head + again.process(src[512:], dst[512:]) == want
