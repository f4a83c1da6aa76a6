"""Every engine on the slice's path, disarmed and with every host hook
armed (the flight recorder, metrics, latency, provenance, the sanitizer
with its dead-letter journal, the cost observatory, the write-ahead
journal): results and carries bit-equal, the same kernel launches, and
the hooks' records present. On the triangle stream (both wires), the
summary engine (both wires), the sliding engine, the GNN engine, the
resident summary engine (both wires) and the GNN resident engine; and a
journal written by the scan engine replayed into the resident engine
gives the scan twin's carry."""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu_torch import SlidingSummaryEngine
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch import TriangleWindowKernel
from gelly_streaming_tpu_torch import kernels
from gelly_streaming_tpu_torch.ops.gnn_window import GnnResidentEngine
from gelly_streaming_tpu_torch.ops.gnn_window import GnnSummaryEngine
from gelly_streaming_tpu_torch.ops.resident_engine import \
    ResidentSummaryEngine
from gelly_streaming_tpu_torch.utils import checkpoint
from gelly_streaming_tpu_torch.utils import costmodel
from gelly_streaming_tpu_torch.utils import latency
from gelly_streaming_tpu_torch.utils import metrics
from gelly_streaming_tpu_torch.utils import provenance
from gelly_streaming_tpu_torch.utils import sanitize
from gelly_streaming_tpu_torch.utils import telemetry

EB, VB = 32, 64
_HOOKS = ("GS_TELEMETRY", "GS_METRICS", "GS_LATENCY", "GS_PROVENANCE",
          "GS_PROVENANCE_DIR", "GS_SANITIZE", "GS_DLQ_DIR", "GS_COSTMODEL",
          "GS_TRACE_DIR")


def _reset():
    for m in (telemetry, metrics, latency, provenance, sanitize,
              costmodel):
        m.reset()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    for k in _HOOKS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    _reset()
    yield
    _reset()
    torch.set_num_threads(threads)


def _arm(monkeypatch, tmp_path):
    for k in ("GS_TELEMETRY", "GS_METRICS", "GS_LATENCY", "GS_PROVENANCE",
              "GS_COSTMODEL"):
        monkeypatch.setenv(k, "1")
    monkeypatch.setenv("GS_SANITIZE", "on")
    monkeypatch.setenv("GS_PROVENANCE_DIR", str(tmp_path / "prov"))
    monkeypatch.setenv("GS_DLQ_DIR", str(tmp_path / "dlq"))
    monkeypatch.setenv("GS_TRACE_DIR", str(tmp_path / "trace"))
    _reset()


def _stream(windows, seed=0):
    rng = np.random.default_rng(seed)
    n = windows * EB + 5
    return (rng.integers(0, VB, n).astype(np.int32),
            rng.integers(0, VB, n).astype(np.int32))


def _make(kind):
    if kind.startswith("triangles"):
        k = TriangleWindowKernel(EB, VB, device="cpu",
                                 ingress=kind.split("-")[1])
        k.MAX_STREAM_WINDOWS = 8
        return k
    if kind.startswith("summary"):
        e = StreamSummaryEngine(EB, VB, device="cpu",
                                ingress=kind.split("-")[1])
        e.MAX_WINDOWS = 8
        return e
    if kind == "sliding":
        return SlidingSummaryEngine(2 * EB, VB, slide=EB, device="cpu")
    if kind.startswith("resident"):
        return ResidentSummaryEngine(EB, VB, device="cpu", superbatch=16,
                                     ingress=kind.split("-")[1])
    if kind == "gnn":
        e = GnnSummaryEngine(EB, VB, feature_dim=8, device="cpu")
        e.MAX_WINDOWS = 8
        return e
    return GnnResidentEngine(EB, VB, feature_dim=8, device="cpu",
                             superbatch=16)


def _run(kind, eng, src, dst, tmp_path=None):
    if kind.startswith("triangles"):
        return eng.count_stream(src, dst), ()
    if tmp_path is not None and hasattr(eng, "enable_wal"):
        eng.enable_wal(str(tmp_path / "wal"))
    out = eng.process(src, dst)
    inner = getattr(eng, "inner", eng)
    return out, tuple(np.asarray(c) for c in
                      inner.state_dict()["carry"])


KINDS = ["triangles-standard", "triangles-compact", "summary-standard",
         "summary-compact", "sliding", "gnn", "resident-standard",
         "resident-compact", "gnn_resident"]


@pytest.mark.parametrize("kind", KINDS)
def test_armed_equals_disarmed(monkeypatch, tmp_path, kind):
    src, dst = _stream(40, seed=KINDS.index(kind))
    kernels.reset_launches()
    want, want_carry = _run(kind, _make(kind), src, dst)
    launches = dict(kernels.LAUNCHES)
    _arm(monkeypatch, tmp_path)
    kernels.reset_launches()
    got, carry = _run(kind, _make(kind), src, dst, tmp_path)
    assert got == want
    for a, b in zip(carry, want_carry):
        np.testing.assert_array_equal(a, b)
    assert kernels.LAUNCHES == launches
    names = {r["name"] for r in telemetry.records()}
    assert {"ingress.chunk", "ingress.prep", "ingress.h2d",
            "ingress.dispatch", "ingress.finalize"} <= names
    engine = ("triangle_stream" if kind.startswith("triangles")
              else type(getattr(_make(kind), "inner", _make(kind)))
              .__name__)
    marked = sum(v for (n, lab), v in metrics.counters().items()
                 if n == "gs_windows_finalized_total"
                 and ("engine", engine) in lab)
    assert marked == len(want)
    if not kind.startswith("triangles"):
        assert len(latency.recent()) == len(want)
        provenance.reset()
        recs = provenance.scan(str(tmp_path / "prov"))["records"]
        assert [r["window"] for r in recs] == list(range(len(want)))
    assert {r["program"] for r in costmodel.report()} <= set(
        kernels.KERNELS)
    assert costmodel.report()


def test_tuned_rounds_record_their_span(monkeypatch):
    """A tuned call records one round span per measurement round with
    its arm and edges (the JAX engines' `triangles.round`,
    `fused_scan.round`); a static call records none."""
    monkeypatch.setenv("GS_TELEMETRY", "1")
    monkeypatch.setenv("GS_TUNE_CACHE", "0")
    monkeypatch.setenv("GS_AUTOTUNE", "1")
    src, dst = _stream(300)
    for eng, name in ((TriangleWindowKernel(EB, VB, device="cpu"),
                       "triangles.round"),
                      (StreamSummaryEngine(EB, VB, device="cpu"),
                       "fused_scan.round")):
        telemetry.reset()
        if name == "triangles.round":
            eng.count_stream(src, dst)
        else:
            eng.process(src, dst)
        rounds = [r for r in telemetry.records() if r["name"] == name]
        assert rounds and sum(r["a"]["edges"] for r in rounds) == \
            -(-len(src) // EB) * EB
        assert all({"window", "wb", "ingress"} <= set(r["a"])
                   for r in rounds)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    telemetry.reset()
    StreamSummaryEngine(EB, VB, device="cpu").process(src, dst)
    assert not [r for r in telemetry.records()
                if r["name"].endswith(".round")]


@pytest.mark.parametrize("wire", ["standard", "compact"])
def test_scan_journal_replays_into_the_resident_engine(tmp_path, wire):
    src, dst = _stream(48, seed=11)
    src, dst = src[:48 * EB], dst[:48 * EB]
    scan = StreamSummaryEngine(EB, VB, device="cpu", ingress=wire)
    scan.enable_wal(str(tmp_path / "wal"))
    scan.process(src[:16 * EB], dst[:16 * EB])
    checkpoint.save(str(tmp_path / "ck"), scan.state_dict())
    want = scan.process(src[16 * EB:], dst[16 * EB:])
    scan._wal.close()
    res = ResidentSummaryEngine(EB, VB, device="cpu", superbatch=16,
                                ingress=wire)
    res.enable_wal(str(tmp_path / "wal"))
    assert res.resume_and_replay(str(tmp_path / "ck")) == want
    for a, b in zip(res.state_dict()["carry"], scan.state_dict()["carry"]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gnn_knobs_read_where_arguments_are_none(monkeypatch):
    monkeypatch.setenv("GS_GNN_F", "12")
    monkeypatch.setenv("GS_GNN_ACT", "abs")
    eng = GnnSummaryEngine(EB, VB, device="cpu")
    assert (eng.F, eng.act) == (12, "abs")
    eng = GnnSummaryEngine(EB, VB, feature_dim=4, activation="relu",
                           device="cpu")
    assert (eng.F, eng.act) == (4, "relu")
    from gelly_streaming_tpu.ops import gnn_window as jax_gnn
    jeng = jax_gnn.GnnSummaryEngine(EB, VB)
    assert (jeng.F, jeng.act) == (12, "abs")
