"""The port's write-ahead journal (gelly_streaming_tpu_torch/utils/wal.py)
against the JAX package's utils/wal.py, and the summary engines' journal
hooks (enable_wal, seal_wal, resume_and_replay) against the JAX
engine's.

Each case of tests/test_wal.py runs on both modules, and the journals
the two write for the same appends are compared byte for byte: the
on-disk format is shared, so a journal written by either package
replays in the other, also through the engines (equal carries and
summaries, both ways). Recovery after a kill inside a call (a fatal
injected fault) gives the uninterrupted run's windows and carry, on the
scan engine of both wires and on the resident engine."""

import os

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.utils import checkpoint as jax_ckpt
from gelly_streaming_tpu.utils import wal as jax_wal
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch.ops.resident_engine import \
    ResidentSummaryEngine
from gelly_streaming_tpu_torch.utils import checkpoint
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import wal

MODULES = {"jax": jax_wal, "torch": wal}


@pytest.fixture(autouse=True)
def _one_torch_thread(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in ("GS_WAL", "GS_WAL_FSYNC_S", "GS_WAL_RETAIN",
                 "GS_WAL_SEGMENT_BYTES", "GS_LATENCY", "GS_SANITIZE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=sorted(MODULES))
def mod(request):
    return MODULES[request.param]


def _edges(n, seed=0, dtype=np.int32, hi=100):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, hi, n).astype(dtype),
            rng.integers(0, hi, n).astype(dtype))


def _segment_bytes(directory):
    return [open(os.path.join(directory, f), "rb").read()
            for f in sorted(os.listdir(directory))]


# ----------------------------------------------------------------------
# the journal module
# ----------------------------------------------------------------------
def test_same_appends_write_the_same_bytes(tmp_path, monkeypatch):
    """Every record kind and id width, rotation included: the two
    packages' segment files are equal byte for byte."""
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    dirs = {}
    for name, m in MODULES.items():
        w = m.WriteAheadLog(str(tmp_path / name))
        for i in range(12):
            s, d = _edges(40 + i, seed=i,
                          dtype=np.int64 if i % 3 == 0 else np.int32)
            ts = np.arange(len(s), dtype=np.int64) * 7 if i % 2 else None
            w.append("t%d" % (i % 2), s, d, ts)
        w.append("t0", np.array([1, 2], np.int16),
                 np.array([3, 4], np.int16))   # canonicalized to int64
        w.seal()
        dirs[name] = _segment_bytes(w.dir)
    assert len(dirs["torch"]) > 1
    assert dirs["torch"] == dirs["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_journal_replays_across_packages(tmp_path, writer, reader):
    w = MODULES[writer].WriteAheadLog(str(tmp_path / "j"))
    s1, d1 = _edges(10, 1)
    s2, d2 = _edges(6, 2, dtype=np.int64)
    w.append("a", s1, d1, np.arange(10, dtype=np.int64))
    w.append("b", s2, d2)
    w.append("a", s2, d2)
    w.close()
    r = MODULES[reader]
    got = list(r.replay(w.dir, {"a": 4}))
    want = list(MODULES[writer].replay(w.dir, {"a": 4}))
    assert [(t, st) for t, st, *_ in got] == [("a", 4), ("b", 0),
                                              ("a", 10)]
    for g, x in zip(got, want):
        assert g[:2] == x[:2]
        for a, b in zip(g[2:], x[2:]):
            if a is None:
                assert b is None
            else:
                np.testing.assert_array_equal(a, b)
    assert r.scan(w.dir)["offsets"] == {"a": 16, "b": 6}
    # the reader appends after the writer's records
    w2 = r.WriteAheadLog(w.dir)
    assert w2.append("a", s1, d1) == (16, 26)
    w2.close()


def test_append_offsets_and_straddling_trim(tmp_path, mod):
    w = mod.WriteAheadLog(str(tmp_path / "j"))
    s, d = _edges(10, 3)
    assert w.append("t1", s, d) == (0, 10)
    assert w.append("t1", s[:5], d[:5]) == (10, 15)
    assert w.offsets() == {"t1": 15}
    w.close()
    (tid, start, rs, rd, ts), *_rest = mod.replay(w.dir, {"t1": 4})
    assert (tid, start, ts) == ("t1", 4, None)
    np.testing.assert_array_equal(rs, s[4:])
    np.testing.assert_array_equal(rd, d[4:])
    assert list(mod.replay(w.dir, {"t1": 15})) == []


@pytest.mark.parametrize("damage", ["truncate", "crc", "header"])
def test_torn_tail_falls_back_one_record(tmp_path, mod, damage):
    w = mod.WriteAheadLog(str(tmp_path / "j"))
    s, d = _edges(8, 4)
    w.append("t", s, d)
    w.append("t", s, d)
    w.close()
    seg = os.path.join(w.dir, sorted(os.listdir(w.dir))[-1])
    data = bytearray(open(seg, "rb").read())
    if damage == "truncate":
        data = data[:-5]
    elif damage == "crc":
        data[-1] ^= 0xFF
    else:
        data += b"\x01\x02"                     # a partial record header
    open(seg, "wb").write(bytes(data))
    info = mod.scan(w.dir)
    assert info["torn"] is not None
    assert info["offsets"] == {"t": 16 if damage == "header" else 8}
    # reopening quarantines the torn bytes and continues in a new segment
    w2 = mod.WriteAheadLog(w.dir)
    w2.append("t", s, d)
    w2.close()
    assert mod.scan(w.dir)["torn"] is None


@pytest.mark.parametrize("damage", ["crc", "gap"])
def test_mid_journal_damage_and_seq_gap_raise_typed(tmp_path, mod,
                                                    monkeypatch, damage):
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    w = mod.WriteAheadLog(str(tmp_path / "j"))
    for i in range(30):
        w.append("t", *_edges(60, i))
    w.close()
    segs = sorted(os.listdir(w.dir))
    assert len(segs) > 2
    if damage == "crc":
        first = os.path.join(w.dir, segs[0])
        data = bytearray(open(first, "rb").read())
        data[20] ^= 0xFF
        open(first, "wb").write(bytes(data))
        match = "mid-journal"
    else:
        os.unlink(os.path.join(w.dir, segs[1]))
        match = "sequence gap"
    with pytest.raises(mod.WalCorrupt, match=match):
        mod.scan(w.dir)


def test_seal_fsync_batching_and_retention(tmp_path, mod, monkeypatch):
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    monkeypatch.setenv("GS_WAL_FSYNC_S", "3600")
    w = mod.WriteAheadLog(str(tmp_path / "j"))
    for i in range(20):
        w.append("t", *_edges(50, i))
    segs_before = len(os.listdir(w.dir))
    cursor = mod.RetentionCursor()
    assert cursor.flushed(w, "t", 500) == 0     # disarmed: keeps all
    monkeypatch.setenv("GS_WAL_RETAIN", "1")
    assert cursor.flushed(w, "t", 600) == 0     # first flush: floor 0
    removed = cursor.flushed(w, "t", 900)
    assert removed > 0 and len(os.listdir(w.dir)) == segs_before - removed
    assert min(st for _t, st, *_x in mod.replay(w.dir)) <= 600
    w.seal()
    assert mod.scan(w.dir)["sealed"]
    with pytest.raises(ValueError, match="sealed"):
        w.append("t", *_edges(1))


# ----------------------------------------------------------------------
# the engines' journal hooks
# ----------------------------------------------------------------------
EB, VB = 64, 64


def _jax_engine(eb=EB, vb=VB, kb=16):
    return jax_scan.StreamSummaryEngine(eb, vb, k_bucket=kb,
                                        ingress="standard")


def _carry(eng):
    return [np.asarray(x) for x in eng.state_dict()["carry"]]


def test_gs_wal_zero_disarms_enable_wal(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_WAL", "0")
    eng = StreamSummaryEngine(EB, VB, device="cpu")
    assert eng.enable_wal(str(tmp_path / "j")) is False
    eng.process(*_edges(2 * EB, 5, hi=VB))
    assert not os.path.exists(tmp_path / "j")


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_engine_journal_replays_across_packages(tmp_path, writer):
    """A journal and checkpoint written by one package's engine recover
    in the other's: equal summaries and carries, both ways, and the
    engines' journals are byte-identical for the same calls."""
    src, dst = _edges(10 * EB, 6, hi=VB)
    cut = 4 * EB
    mk = {"jax": _jax_engine,
          "torch": lambda: StreamSummaryEngine(EB, VB, k_bucket=16,
                                               device="cpu")}
    ck = {"jax": jax_ckpt, "torch": checkpoint}
    want_eng = mk["torch"]()
    want = want_eng.process(src, dst)
    jdir = {}
    for name in mk:
        eng = mk[name]()
        eng.enable_wal(str(tmp_path / ("wal_" + name)), tenant="t7")
        eng.process(src[:cut], dst[:cut])
        ck[name].save(str(tmp_path / ("ck_" + name)), eng.state_dict())
        eng.process(src[cut:], dst[cut:])
        eng._wal.close()
        jdir[name] = eng._wal_dir
    assert _segment_bytes(jdir["jax"]) == _segment_bytes(jdir["torch"])
    reader = "torch" if writer == "jax" else "jax"
    rec = mk[reader]()
    rec.enable_wal(jdir[writer], tenant="t7")
    got = rec.resume_and_replay(str(tmp_path / ("ck_" + writer)))
    assert got == want[4:]
    for a, b in zip(_carry(rec), _carry(want_eng)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["standard", "compact", "resident"])
def test_kill_inside_a_call_recovers_exactly(tmp_path, kind):
    """A fatal fault at a chunk's prep kills the second call mid-way;
    the auto-checkpoint of the first call and the journal's suffix
    recover every window of the second call and the carry."""
    eb, vb = 32, 64

    def make():
        if kind == "resident":
            return ResidentSummaryEngine(eb, vb, device="cpu",
                                         superbatch=4)
        eng = StreamSummaryEngine(eb, vb, device="cpu", ingress=kind)
        eng.MAX_WINDOWS = 4         # several chunks a call
        return eng

    # calls of whole chunks (a super-batch is 8 windows here): a ragged
    # chunk's padding joins the cover's two sentinel slots, which no
    # summary reads, so the carries compare bit for bit only at equal
    # chunking
    src, dst = _edges(40 * eb, 8, hi=vb)
    cut = 16 * eb
    ref = make()
    want = ref.process(src, dst)
    ckpt = str(tmp_path / "ck.npz")
    eng = make()
    eng.enable_wal(str(tmp_path / "wal"))
    eng.enable_auto_checkpoint(ckpt, every_n_windows=8)
    assert eng.process(src[:cut], dst[:cut]) == want[:16]
    with faults.inject(faults.FaultSpec(site="prep", on_call=3,
                                        fatal=True)):
        with pytest.raises(faults.InjectedFault):
            eng.process(src[cut:], dst[cut:])
    rec = make()
    rec.enable_wal(str(tmp_path / "wal"))
    got = rec.resume_and_replay(ckpt)
    assert rec.windows_done == 40 and got == want[16:]
    for a, b in zip(_carry(rec), _carry(ref)):
        np.testing.assert_array_equal(a, b)
