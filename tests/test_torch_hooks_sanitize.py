"""The port's admission sanitizer and dead-letter journal
(gelly_streaming_tpu_torch/utils/sanitize.py) against the JAX package's
utils/sanitize.py, on the cases of tests/test_sanitize.py: equal reports
(accepted arrays, keep masks, reason counts), equal typed refusals,
byte-identical dead-letter segments that replay in either package, and
the summary engines' armed admission (the `admit` fault site, then the
sanitizer, before the journal) against the JAX engine's."""

import os

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.utils import faults as jax_faults
from gelly_streaming_tpu.utils import sanitize as jax_sanitize
from gelly_streaming_tpu_torch import SlidingSummaryEngine
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch.utils import faults
from gelly_streaming_tpu_torch.utils import sanitize

MODULES = {"jax": jax_sanitize, "torch": sanitize}
EB, VB = 64, 128


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for name in ("GS_SANITIZE", "GS_DLQ_DIR", "GS_DLQ_RETAIN",
                 "GS_MAX_BATCH_EDGES", "GS_WAL_SEGMENT_BYTES"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    for m in MODULES.values():
        m.reset()
    yield
    for m in MODULES.values():
        m.reset()
    torch.set_num_threads(threads)


def _batches():
    """Adversarial batches: every reason code, floats, NaN/inf, huge
    and negative ids, object arrays, uint64, a duplicate flood."""
    rng = np.random.default_rng(5)
    yield (np.array([1, -5, 2 ** 40, 130, 3, 3, float("nan"),
                     float("inf"), 2.5, 7] + [9] * 12),
           np.array([2, 1, 1, 1, 3, 4, 1.0, 2.0, 1.0, 8] + [11] * 12))
    yield (np.array(["1", "x", str(2 ** 70), "-3", "5"], dtype=object),
           np.array(["2", "3", "4", "5", "5"], dtype=object))
    yield (np.array([2 ** 63 + 5, 4, 7], np.uint64),
           np.array([1, 2, 7], np.uint64))
    yield (rng.integers(-(1 << 40), 1 << 40, 64),
           rng.integers(-200, 200, 64))
    s = rng.integers(0, VB, 300).astype(np.int32)
    d = rng.integers(0, VB, 300).astype(np.int32)
    s[:40], d[:40] = 3, 4                      # a duplicate flood
    yield s, d


def _same_report(a, b):
    np.testing.assert_array_equal(a.src, b.src)
    np.testing.assert_array_equal(a.dst, b.dst)
    np.testing.assert_array_equal(a.keep, b.keep)
    assert (a.accepted, a.rejected, a.reasons) == \
        (b.accepted, b.rejected, b.reasons)
    assert a.wire_fields() == b.wire_fields()


@pytest.mark.parametrize("mode", ["on", "strict"])
@pytest.mark.parametrize("vb", [VB, None])
def test_reports_match_jax(monkeypatch, mode, vb):
    monkeypatch.setenv("GS_SANITIZE", mode)
    for src, dst in _batches():
        got = sanitize.sanitize(src, dst, vb, tenant="t", offset=10)
        want = jax_sanitize.sanitize(src, dst, vb, tenant="t", offset=10)
        _same_report(got, want)
        if vb is not None:
            assert (got.src >= 0).all() and (got.src < vb).all()


@pytest.mark.parametrize("case", ["length", "overflow"])
def test_whole_batch_refusals_typed(monkeypatch, tmp_path, case):
    monkeypatch.setenv("GS_SANITIZE", "on")
    monkeypatch.setenv("GS_MAX_BATCH_EDGES", "4")
    src, dst = (np.arange(5), np.arange(4)) if case == "length" \
        else (np.arange(6), np.arange(6))
    errs = {}
    for name, m in MODULES.items():
        dlq = m.DeadLetterJournal(str(tmp_path / name))
        with pytest.raises(m.BatchRejected) as ei:
            m.sanitize(src, dst, VB, tenant="t", dlq=dlq)
        errs[name] = (ei.value.tenant, ei.value.reason, ei.value.size,
                      ei.value.limit, str(ei.value))
        dlq.close()
    assert errs["torch"] == errs["jax"]
    assert errs["torch"][1] == ("length_mismatch" if case == "length"
                                else "batch_overflow")


def test_off_mode_is_inert_and_resolves_no_dlq(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_DLQ_DIR", str(tmp_path / "dlq"))
    assert not sanitize.enabled() and sanitize.resolve_dlq() is None
    monkeypatch.setenv("GS_SANITIZE", "on")
    j = sanitize.resolve_dlq()
    assert j is sanitize.resolve_dlq() and j.dir == str(tmp_path / "dlq")


def test_dlq_bytes_equal_and_replay_across_packages(monkeypatch,
                                                    tmp_path):
    monkeypatch.setenv("GS_SANITIZE", "strict")
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    for name, m in MODULES.items():
        dlq = m.DeadLetterJournal(str(tmp_path / name))
        off = 0
        for _ in range(8):              # enough to rotate segments
            for src, dst in _batches():
                rep = m.sanitize(src, dst, VB, tenant="t%d" % (off % 3),
                                 origin="engine", offset=off, dlq=dlq)
                off += rep.accepted + rep.rejected
        dlq.close()
    segs = {n: sorted(os.listdir(tmp_path / n)) for n in MODULES}
    assert segs["torch"] == segs["jax"] and len(segs["torch"]) > 1
    for f in segs["torch"]:
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()
    for reader in MODULES.values():
        for writer in MODULES:
            a = list(reader.replay(str(tmp_path / writer)))
            b = list(jax_sanitize.replay(str(tmp_path / "jax")))
            assert [(r["tenant"], r["origin"], r["reason"]) for r in a] \
                == [(r["tenant"], r["origin"], r["reason"]) for r in b]
            for x, y in zip(a, b):
                for k in ("offsets", "src", "dst"):
                    np.testing.assert_array_equal(x[k], y[k])
        assert reader.scan(str(tmp_path / "torch")) == \
            jax_sanitize.scan(str(tmp_path / "jax"))


@pytest.mark.parametrize("name", sorted(MODULES))
def test_dlq_rotation_retention_and_torn_tail(monkeypatch, tmp_path,
                                              name):
    m = MODULES[name]
    monkeypatch.setenv("GS_WAL_SEGMENT_BYTES", "4096")
    monkeypatch.setenv("GS_DLQ_RETAIN", "2")
    dlq = m.DeadLetterJournal(str(tmp_path / "d"))
    for i in range(40):
        dlq.append("t", "engine", "id_negative", np.arange(50) + 50 * i,
                   -np.ones(50, np.int64), np.ones(50, np.int64))
    assert len(os.listdir(dlq.dir)) <= 3
    assert dlq.status()["records"] == 40
    dlq.close()
    last = os.path.join(dlq.dir, sorted(os.listdir(dlq.dir))[-1])
    data = open(last, "rb").read()
    open(last, "wb").write(data[:-9])
    kept = list(m.replay(dlq.dir))
    assert kept and kept[-1]["offsets"][-1] < 40 * 50 - 1


# ----------------------------------------------------------------------
# the engines' admission
# ----------------------------------------------------------------------
def _poisoned(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.integers(0, VB, n).astype(np.int64)
    d = rng.integers(0, VB, n).astype(np.int64)
    s[::37] = VB + 3
    d[5::41] = -1
    s[7] = 2 ** 40
    return s, d


@pytest.mark.parametrize("mode", ["on", "strict"])
def test_engine_armed_matches_jax_engine_and_dlq(monkeypatch, tmp_path,
                                                 mode):
    """Poisoned batches through both packages' engines: equal summaries
    and carries, and byte-identical dead-letter journals."""
    monkeypatch.setenv("GS_SANITIZE", mode)
    port = StreamSummaryEngine(EB, VB, k_bucket=16, device="cpu")
    jeng = jax_scan.StreamSummaryEngine(EB, VB, k_bucket=16,
                                        ingress="standard")
    s, d = _poisoned(7 * EB + 5, 0)
    for eng, m, name in ((port, sanitize, "torch"),
                         (jeng, jax_sanitize, "jax")):
        monkeypatch.setenv("GS_DLQ_DIR", str(tmp_path / name))
        m.reset()
        eng._summ = eng.process(s, d)
        m.reset()
    assert port._summ == jeng._summ
    for a, b in zip(port.state_dict()["carry"], jeng.state_dict()["carry"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port._fed_edges == jeng._fed_edges
    for f in sorted(os.listdir(tmp_path / "jax")):
        assert (tmp_path / "torch" / f).read_bytes() == \
            (tmp_path / "jax" / f).read_bytes()


def test_admit_fault_poisons_upstream_of_the_sanitizer(monkeypatch):
    """A `call` spec at the `admit` site garbles the arrays before the
    sanitizer sees them: the armed engine rejects exactly what it
    garbled, as the JAX engine does."""
    monkeypatch.setenv("GS_SANITIZE", "on")
    src = np.arange(4 * EB, dtype=np.int32) % VB
    dst = (np.arange(4 * EB, dtype=np.int32) * 7 + 1) % VB

    def poison(payload):
        tenant, s, d = payload
        s = np.array(s, np.int64)
        s[::9] = -4
        return tenant, s, d

    outs = {}
    for name, eng, f in (
            ("torch", StreamSummaryEngine(EB, VB, k_bucket=16,
                                          device="cpu"), faults),
            ("jax", jax_scan.StreamSummaryEngine(
                EB, VB, k_bucket=16, ingress="standard"), jax_faults)):
        with f.inject(f.FaultSpec(site="admit", action="call",
                                  fn=poison)) as plan:
            outs[name] = eng.process(src, dst)
        assert plan.fired == [("admit", 1, "call")]
        assert eng._fed_edges == len(src)
    assert outs["torch"] == outs["jax"]
    assert len(outs["torch"]) == -(-(len(src) - len(src[::9])) // EB)


def test_sliding_engine_sanitizes_before_its_panes(monkeypatch):
    monkeypatch.setenv("GS_SANITIZE", "on")
    s, d = _poisoned(6 * 32, 4)
    rep = sanitize.sanitize(s, d, VB)
    armed = SlidingSummaryEngine(64, VB, slide=32, device="cpu")
    got = armed.process(s, d)
    monkeypatch.setenv("GS_SANITIZE", "off")
    clean = SlidingSummaryEngine(64, VB, slide=32, device="cpu")
    assert got == clean.process(rep.src.astype(np.int32),
                                rep.dst.astype(np.int32))
