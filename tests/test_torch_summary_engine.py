"""The port's summary engines (gelly_streaming_tpu_torch/ops/
scan_analytics.py) on device="cpu", held against the JAX package's
`StreamSummaryEngine` in both forms (the XLA scan body, and the
`_window_call` kernel in interpret mode under GS_PALLAS_WINDOW=on), its
numpy twin `parallel/host_twin.HostSummaryEngine`, and the port's own
numpy oracle `ops/host_summary.py`.

The JAX engine's defaults read committed evidence files, so its K and
wire are pinned (k_bucket=port.kb, ingress="standard", GS_AUTOTUNE=0).
Every summary and every carry slot is an integer or a bool: equality,
no tolerance, the `state_dict` carry bit for bit.
"""

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.ops import pallas_window as pw
from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.parallel.host_twin import HostSummaryEngine
from gelly_streaming_tpu_torch import SlidingSummaryEngine
from gelly_streaming_tpu_torch import StreamSummaryEngine
from gelly_streaming_tpu_torch.ops import host_summary, host_triangles
from gelly_streaming_tpu_torch.utils.streams import make_stream


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch thread a test: the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _no_autotune(monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "0")


@pytest.fixture(params=["xla", "pallas_interpret"])
def jax_engine(request, monkeypatch):
    """build(port_engine) -> the JAX engine at the same buckets."""
    if request.param == "xla":
        monkeypatch.delenv("GS_PALLAS_WINDOW", raising=False)
    else:
        monkeypatch.setenv("GS_PALLAS_WINDOW", "on")
    pw._reset_pallas_window()

    def build(port):
        eng = jax_scan.StreamSummaryEngine(port.eb, port.vb,
                                           k_bucket=port.kb,
                                           ingress="standard")
        assert eng._pallas == (request.param == "pallas_interpret")
        return eng

    yield build
    pw._reset_pallas_window()


def _stream(n, v, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32))


def _port(eb, vb, kb=0):
    return StreamSummaryEngine(eb, vb, k_bucket=kb, device="cpu")


def _assert_carry_equal(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype == np.int32
        np.testing.assert_array_equal(x, y)


def test_engine_matches_jax_ragged_tail(jax_engine):
    """All four analytics with a ragged last window (a padded chunk of 8
    windows): summaries and the state_dict equal to the JAX engine's,
    HostSummaryEngine's and the numpy oracle's."""
    src, dst = _stream(5 * 256 - 37, 200)
    port = _port(256, 256)
    out = port.process(src, dst)
    jax_eng = jax_engine(port)
    assert out == jax_eng.process(src, dst)
    host = HostSummaryEngine(256, 256)
    assert out == host.process(src, dst)
    oracle, ocarry = host_summary.summarize_stream(src, dst, 256, 256)
    assert out == oracle
    state = port.state_dict()
    for other in (jax_eng.state_dict(), host.state_dict()):
        assert {k: v for k, v in state.items() if k != "carry"} == {
            k: v for k, v in other.items() if k != "carry"}
        _assert_carry_equal(state["carry"], other["carry"])
    _assert_carry_equal(state["carry"], ocarry)
    assert state["carry"][2][2 * 256 + 1] == 256     # the sentinel join
    assert any(s["triangles"] for s in out)
    assert any(s["odd_cycle"] for s in out)
    deg, labels, odd = port.state()
    jdeg, jlabels, jodd = jax_eng.state()
    for g, w in ((deg, jdeg), (labels, jlabels), (odd, jodd)):
        np.testing.assert_array_equal(g, w)


def test_engine_calls_in_edge_bucket_multiples(jax_engine):
    """Several process() calls in eb multiples, then a ragged last one,
    equal one call over the whole stream; a further call is refused."""
    src, dst = make_stream(7 * 128 - 5, 256, seed=4)
    port = _port(128, 256)
    parts = [port.process(src[a:b], dst[a:b])
             for a, b in ((0, 256), (256, 640), (640, len(src)))]
    whole = _port(128, 256).process(src, dst)
    assert sum(parts, []) == whole
    assert port.windows_done == 7 and port.resume_offset() == 7 * 128
    jax_eng = jax_engine(port)
    assert whole == jax_eng.process(src, dst)
    _assert_carry_equal(port.state_dict()["carry"],
                        jax_eng.state_dict()["carry"])
    with pytest.raises(ValueError, match="closed a partial window"):
        port.process(src[:128], dst[:128])
    assert port.process(src[:0], dst[:0]) == []
    port.reset()
    assert port.process(src, dst) == whole


def test_k14_overflow_redone_exactly(jax_engine):
    """The K14 clique window at kb=8 overflows the summary body's
    counter and is recounted exactly: 364 triangles from the clique."""
    u, v = np.triu_indices(14, k=1)
    src, dst = _stream(3 * 128, 128, seed=5)
    src[128:128 + len(u)], dst[128:128 + len(v)] = u, v
    port = _port(128, 128, kb=8)
    redone = []
    redo = port._redo
    port._redo = lambda s, d: redone.append(len(s)) or redo(s, d)
    out = port.process(src, dst)
    assert redone == [128]
    want = [host_triangles.window_count(src[a:a + 128], dst[a:a + 128])
            for a in range(0, len(src), 128)]
    assert [s["triangles"] for s in out] == want
    assert want[1] >= 364
    assert out == jax_engine(port).process(src, dst)
    assert out == HostSummaryEngine(128, 128).process(src, dst)


def test_multi_chunk_stream_matches_host_twins():
    """70 windows: one full chunk of 64, then 6 padded to 8. A stream of
    exactly 64 full windows pads nothing, so the cover's sentinels stay
    apart."""
    src, dst = make_stream(70 * 16 - 3, 32, seed=6)
    port = _port(16, 32, kb=8)
    out = port.process(src, dst)
    host = HostSummaryEngine(16, 32)
    assert out == host.process(src, dst)
    oracle, ocarry = host_summary.summarize_stream(src, dst, 16, 32)
    assert out == oracle
    _assert_carry_equal(port.state_dict()["carry"],
                        host.state_dict()["carry"])
    _assert_carry_equal(port.state_dict()["carry"], ocarry)
    assert port.state_dict()["carry"][2][2 * 32 + 1] == 32
    full = _port(16, 32, kb=8)
    assert full.process(src[:64 * 16], dst[:64 * 16]) == out[:64]
    assert full.state_dict()["carry"][2][2 * 32 + 1] == 2 * 32 + 1
    _assert_carry_equal(full.state_dict()["carry"],
                        host_summary.summarize_stream(
                            src[:64 * 16], dst[:64 * 16], 16, 32)[1])


def test_resume_across_packages_both_ways():
    """A JAX engine's state_dict() loads into the port, which finishes
    the stream equal to an uninterrupted JAX run; the port's loads into
    the JAX engine and into HostSummaryEngine, which finish it equal."""
    src, dst = _stream(6 * 128 - 11, 200, seed=7)
    cut = 3 * 128
    whole_eng = jax_scan.StreamSummaryEngine(128, 256, k_bucket=16,
                                             ingress="standard")
    whole = whole_eng.process(src, dst)

    jax_first = jax_scan.StreamSummaryEngine(128, 256, k_bucket=16,
                                             ingress="standard")
    head = jax_first.process(src[:cut], dst[:cut])
    port = _port(128, 256, kb=16)
    port.load_state_dict(jax_first.state_dict())
    off = port.resume_offset()
    assert off == cut
    assert head + port.process(src[off:], dst[off:]) == whole
    _assert_carry_equal(port.state_dict()["carry"],
                        whole_eng.state_dict()["carry"])

    port_first = _port(128, 256, kb=16)
    head = port_first.process(src[:cut], dst[:cut])
    state = port_first.state_dict()
    for other in (jax_scan.StreamSummaryEngine(128, 256, k_bucket=16,
                                               ingress="standard"),
                  HostSummaryEngine(128, 256)):
        other.load_state_dict(state)
        assert head + other.process(src[cut:], dst[cut:]) == whole
        _assert_carry_equal(other.state_dict()["carry"],
                            whole_eng.state_dict()["carry"])


def test_engine_refusals(monkeypatch):
    port = _port(64, 64)
    with pytest.raises(ValueError, match="outside"):
        port.process(np.array([0, 64]), np.array([1, 2]))
    with pytest.raises(ValueError, match="outside"):
        port.process(np.array([-1, 3]), np.array([1, 2]))
    # the JAX rule: a compact pin where ids may not fit uint16 raises
    with pytest.raises(ValueError, match="compact ingress is lossy"):
        StreamSummaryEngine(64, 1 << 17, device="cpu", ingress="compact")
    with pytest.raises(ValueError, match="unknown ingress"):
        StreamSummaryEngine(64, 64, device="cpu", ingress="narrow")
    state = port.state_dict()
    with pytest.raises(ValueError, match="bucket mismatch"):
        _port(128, 64).load_state_dict(state)
    bad = dict(state, carry=(state["carry"][0],
                             np.roll(state["carry"][1], 1),
                             state["carry"][2]))
    with pytest.raises(ValueError, match="equal or smaller"):
        port.load_state_dict(bad)
    with pytest.raises(ValueError, match="wal_offset"):
        port.load_state_dict(dict(state, wal_offset=64))
    port.load_state_dict(dict(state, autotune={"ignored": True}))
    port.warm_fallback()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        StreamSummaryEngine(64, 64)


def test_sliding_engine_matches_jax():
    """Pane-composed sliding windows (4 panes of 32 per 128-edge window)
    with a ragged last pane, equal to the JAX engine's; a resume from a
    mid-ring state_dict emits the same windows."""
    src, dst = _stream(9 * 32 - 5, 100, seed=8)
    port = SlidingSummaryEngine(128, 128, slide=32, k_bucket=8,
                                device="cpu")
    out = port.process(src, dst)
    jax_eng = jax_scan.SlidingSummaryEngine(128, 128, slide=32, k_bucket=8)
    assert out == jax_eng.process(src, dst)
    assert len(out) == 9 and port.windows_done == 9

    head = SlidingSummaryEngine(128, 128, slide=32, k_bucket=8,
                                device="cpu")
    first = head.process(src[:5 * 32], dst[:5 * 32])
    resumed = jax_scan.SlidingSummaryEngine(128, 128, slide=32, k_bucket=8)
    resumed.load_state_dict(head.state_dict())
    off = head.resume_offset()
    assert first + resumed.process(src[off:], dst[off:]) == out
    with pytest.raises(ValueError, match="power of two"):
        SlidingSummaryEngine(128, 128, slide=48, device="cpu")
