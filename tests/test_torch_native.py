"""The port's native host runtime (gelly_streaming_tpu_torch/native: a
copy of native/ingest.cpp built by its own loader into _build/), its
interner, file sources, checkpoint files, numpy snapshot tier, delta
wire and the triangle stream tiers, held against the JAX package's on
the same bytes and arrays. Every output is an integer: equality."""

import threading

import numpy as np
import pytest
import torch

from gelly_streaming_tpu import native as jax_native
from gelly_streaming_tpu.ops import delta_egress as jax_delta
from gelly_streaming_tpu.ops import host_snapshot as jax_host_snapshot
from gelly_streaming_tpu.utils import checkpoint as jax_checkpoint
from gelly_streaming_tpu.utils import interning as jax_interning
from gelly_streaming_tpu_torch import TriangleWindowKernel, forced_sync
from gelly_streaming_tpu_torch import native
from gelly_streaming_tpu_torch.io import sources
from gelly_streaming_tpu_torch.ops import delta_egress, host_snapshot
from gelly_streaming_tpu_torch.ops import host_triangles
from gelly_streaming_tpu_torch.utils import checkpoint, interning

TEXT = (b"1 2 100\n3\t4\t200\n\nbad line\n5 6\n-7 8 300\n1 2 100 label\n"
        b"3 4 200 x y z\n5 6x 300\n7 8\r\n9 10 400\r\n11 12")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_library_builds_into_the_ports_build_dir():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    path = native.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "gelly_streaming_tpu_torch"


def test_makefile_and_source_are_the_jax_packages():
    import pathlib

    for name in ("ingest.cpp", "Makefile"):
        ours = pathlib.Path(native.__file__).with_name(name).read_bytes()
        theirs = pathlib.Path(jax_native.__file__).with_name(
            name).read_bytes()
        assert ours == theirs


@pytest.mark.parametrize("form", ["native", "python"])
def test_parse_matches_jax(form):
    parse = (native.parse_edge_bytes if form == "native"
             else native._parse_edge_bytes_py)
    got = parse(TEXT)
    want = jax_native.parse_edge_bytes(TEXT)
    for g, w in zip(got, want):
        assert g.dtype == np.int64
        np.testing.assert_array_equal(g, w)


def test_parse_file_and_load_edge_arrays(tmp_path):
    rng = np.random.default_rng(0)
    rows = np.stack([rng.integers(-5, 1 << 40, 2000),
                     rng.integers(0, 1 << 40, 2000), np.arange(2000)], 1)
    p = tmp_path / "e.txt"
    p.write_text("".join("%d %d %d\n" % tuple(r) for r in rows))
    for got in (native.parse_edge_file(str(p)),
                sources.load_edge_arrays(str(p))):
        for g, w in zip(got, jax_native.parse_edge_file(str(p))):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("size", [1, 7, 100, 1000])
def test_assign_windows_matches_jax(size):
    ts = np.array([0, 1, 99, 100, 250, 999, 1000, 12345, 10 ** 12])
    want = jax_native.assign_windows(ts, size)
    np.testing.assert_array_equal(native.assign_windows(ts, size), want)
    np.testing.assert_array_equal(ts - np.mod(ts, size), want)


@pytest.mark.parametrize("kind", ["native", "python"])
def test_interner_slots_match_jax(kind):
    rng = np.random.default_rng(1)
    ours = (native.NativeInterner() if kind == "native"
            else interning.IncrementalInterner())
    theirs = jax_interning.IncrementalInterner()
    for n in (0, 10, 500, 3000):
        ids = rng.integers(-(1 << 40), 1 << 40, n) // 7
        ids[: n // 2] = rng.integers(0, 50, n // 2)
        np.testing.assert_array_equal(ours.intern_array(ids),
                                      theirs.intern_array(ids))
        assert len(ours) == len(theirs)
    slots = np.arange(len(ours), dtype=np.int32)
    np.testing.assert_array_equal(np.asarray(ours.ids_of(slots), np.int64),
                                  np.asarray(theirs.ids_of(slots)))
    assert ours.id_of(3) == theirs.id_of(3)


@pytest.mark.parametrize("sync", [False, True])
def test_parallel_intern_arrays_matches_sequential_jax(sync):
    rng = np.random.default_rng(2)
    arrays = [rng.integers(0, 400, n) * 3 for n in (50, 0, 300, 1, 900)]
    seq = jax_interning.IncrementalInterner()
    want = [seq.intern_array(a) for a in arrays]
    interner = interning.make_interner(arrays[0])
    assert isinstance(interner, native.NativeInterner)
    if sync:
        with forced_sync():
            dense, sizes = interning.parallel_intern_arrays(interner,
                                                            arrays)
    else:
        dense, sizes = interning.parallel_intern_arrays(interner, arrays)
    for d, w in zip(dense, want):
        np.testing.assert_array_equal(d, w)
    assert sizes[-1] == len(seq) and sizes == sorted(sizes)


def _windows(rng, num_w, vb, lens=None):
    lens = lens or [int(rng.integers(1, 60)) for _ in range(num_w)]
    s = np.concatenate([rng.integers(0, vb, n) for n in lens])
    d = np.concatenate([rng.integers(0, vb, n) for n in lens])
    offs = np.concatenate([[0], np.cumsum(lens)])
    return s.astype(np.int32), d.astype(np.int32), offs


@pytest.mark.parametrize("analytics", [(1, 1, 1), (1, 0, 0), (0, 1, 0),
                                       (0, 0, 1), (0, 1, 1)])
def test_snapshot_windows_native_and_host_match_jax(analytics):
    rng = np.random.default_rng(3)
    vb = 64
    s, d, offs = _windows(rng, 9, 40)
    carry0 = (rng.integers(0, 5, vb).astype(np.int32),
              np.arange(vb, dtype=np.int32),
              np.arange(2 * vb, dtype=np.int32))
    # a carried forest: a few earlier joins
    carry0[1][[5, 9, 33]] = [2, 2, 7]
    carry0[2][[vb + 3, 70]] = [1, 1]

    def run(fold):
        carry = [c.copy() if on else None
                 for c, on in zip(carry0, analytics)]
        return fold(s, d, offs, vb, *carry), carry

    want, want_carry = run(jax_host_snapshot.snapshot_windows)
    for fold in (host_snapshot.snapshot_windows, native.snapshot_windows,
                 jax_native.snapshot_windows):
        got, got_carry = run(fold)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        for g, w in zip(got_carry, want_carry):
            if w is not None:
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("eb", [1, 16, 64, 1000])
def test_triangle_count_stream_matches_jax(eb):
    rng = np.random.default_rng(4)
    src = rng.integers(0, 60, 2500)
    dst = rng.integers(0, 60, 2500)
    want = jax_native.triangle_count_stream(src, dst, eb)
    np.testing.assert_array_equal(native.triangle_count_stream(src, dst,
                                                               eb), want)
    np.testing.assert_array_equal(host_triangles.count_stream(src, dst,
                                                              eb), want)


@pytest.mark.parametrize("tier", ["device", "host", "native"])
@pytest.mark.parametrize("sync", [False, True])
def test_stream_tiers_agree(tier, sync):
    rng = np.random.default_rng(5)
    vb, eb = 128, 64
    src = rng.integers(0, vb, 1500).astype(np.int32)
    dst = rng.integers(0, vb, 1500).astype(np.int32)
    src[:40], dst[:40] = 7, np.arange(40) + 20      # a hub past kb
    want = host_triangles.count_stream(src, dst, eb)
    kern = TriangleWindowKernel(eb, vb, k_bucket=8, device="cpu",
                                stream_tier=tier)
    windows = [(src[i:i + n], dst[i:i + n])
               for i, n in ((0, 64), (64, 1), (65, 0), (65, 30))]
    if sync:
        with forced_sync():
            got = kern.count_stream(src, dst)
            got_w = kern.count_windows(windows)
    else:
        got = kern.count_stream(src, dst)
        got_w = kern.count_windows(windows)
    assert got == want
    assert got_w == host_triangles.count_windows(windows)


def test_stream_tier_is_checked(monkeypatch):
    with pytest.raises(ValueError):
        TriangleWindowKernel(64, 128, device="cpu", stream_tier="gpu")
    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native"):
        TriangleWindowKernel(64, 128, device="cpu", stream_tier="native")


@pytest.mark.parametrize("eb,vb,cap", [(8, 64, None), (64, 64, None),
                                       (8, 64, 3), (8, 64, 0),
                                       (8, 64, 1000)])
def test_egress_cap_and_wire_match_jax(eb, vb, cap, monkeypatch):
    if cap is None:
        monkeypatch.delenv("GS_EGRESS_CAP", raising=False)
    else:
        monkeypatch.setenv("GS_EGRESS_CAP", str(cap))
    want_cap = jax_delta.egress_cap(eb, vb)
    assert delta_egress.egress_cap(eb, vb, cap) == max(1, want_cap)
    rng = np.random.default_rng(6)
    mask = rng.random(vb) < 0.2
    vals = rng.integers(0, 99, vb).astype(np.int32)
    for c in (1, 5, vb):
        got = delta_egress.compact_changed(torch.from_numpy(mask),
                                           torch.from_numpy(vals), c, 0)
        want = jax_delta.compact_changed(mask, vals, c, 0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    mirror = np.zeros(vb, np.int32)
    k, idx, v = (np.asarray(x) for x in
                 jax_delta.compact_changed(mask, vals, vb, 0))
    delta_egress.apply_delta(mirror, k, idx, v)
    np.testing.assert_array_equal(mirror, np.where(mask, vals, 0))


def test_checkpoint_files_cross_packages(tmp_path):
    tree = {"a": np.arange(5, dtype=np.int64), "n": None, "f": 1.5,
            "l": [np.zeros(0, np.int32), "x", (1, True)], 3: {"k": 2}}
    for save, restore in ((checkpoint.save, jax_checkpoint.restore),
                          (jax_checkpoint.save, checkpoint.restore)):
        path = str(tmp_path / ("c-%s.npz" % save.__module__))
        save(path, tree)
        save(path, dict(tree, f=2.5))
        got = restore(path)
        prev = restore(checkpoint.prev_path(path))
        assert got["f"] == 2.5 and prev["f"] == 1.5
        np.testing.assert_array_equal(got["a"], tree["a"])
        assert got["l"][1:] == ["x", (1, True)] and got[3] == {"k": 2}
        assert got["n"] is None


def test_checkpoint_damage_and_rotation(tmp_path):
    path = str(tmp_path / "c.npz")
    assert checkpoint.load_latest(path) is None
    checkpoint.save(path, {"g": 1})
    checkpoint.save(path, {"g": 2})
    with open(path, "r+b") as f:
        f.truncate(20)
    with pytest.raises(checkpoint.CheckpointCorrupt) as e:
        checkpoint.restore(path)
    assert e.value.path == path
    tree, used = checkpoint.load_latest(path)
    assert tree == {"g": 1} and used == checkpoint.prev_path(path)
    with open(checkpoint.prev_path(path), "wb") as f:
        f.write(b"junk")
    with pytest.raises(checkpoint.CheckpointCorrupt):
        checkpoint.load_latest(path)
    with pytest.raises(TypeError):
        checkpoint.save(path, {"bad": object()})


def test_checkpoint_policy():
    now = [0.0]
    pol = checkpoint.CheckpointPolicy(every_n_windows=4, every_seconds=10,
                                      clock=lambda: now[0])
    assert pol.enabled() and not pol.due(3)
    assert pol.due(4)
    pol.mark(4)
    assert not pol.due(7)
    now[0] = 11.0
    assert pol.due(7)
    with pytest.raises(ValueError):
        checkpoint.CheckpointPolicy(every_n_windows=-1)
    assert not checkpoint.CheckpointPolicy().enabled()


@pytest.mark.parametrize("chunk_bytes,prefetch", [(1, 0), (7, 2),
                                                  (64, 1), (1 << 20, 2)])
def test_iter_edge_chunks_cover_the_file(tmp_path, chunk_bytes, prefetch):
    p = tmp_path / "e.txt"
    p.write_bytes(TEXT)
    parts = list(sources.iter_edge_chunks(str(p), chunk_bytes, prefetch))
    got = [np.concatenate([part[i] for part in parts]) for i in range(3)]
    for g, w in zip(got, jax_native.parse_edge_bytes(TEXT)):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        list(sources.iter_edge_chunks(str(p), 0))


def test_iter_edge_chunks_abandoned_and_error(tmp_path):
    p = tmp_path / "e.txt"
    p.write_text("".join("%d %d\n" % (i, i + 1) for i in range(5000)))
    it = sources.iter_edge_chunks(str(p), 64, prefetch=2)
    first = next(it)
    assert first[0][0] == 0
    it.close()      # the producer stops
    with pytest.raises(FileNotFoundError):
        list(sources.iter_edge_chunks(str(tmp_path / "missing"), 64))


def test_tail_edge_file(tmp_path):
    p = tmp_path / "tail.txt"
    p.write_text("1 2\n3 4\n5")
    stop = threading.Event()
    got = []
    for src, _dst, _ts in sources.tail_edge_file(str(p), stop, 4,
                                                 poll_s=0.01):
        got.extend(src.tolist())
        if len(got) >= 2:
            with open(p, "a") as f:
                f.write(" 6\n7 8")
            stop.set()
    assert got == [1, 3, 5, 7]
