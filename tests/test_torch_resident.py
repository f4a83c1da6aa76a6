"""The port's resident tier (gelly_streaming_tpu_torch/ops/
resident_engine.py, GnnResidentEngine, the driver's
snapshot_tier="resident") on device="cpu", where the super-batches run
the plain versions eagerly (a CUDA graph needs the card), held against
the JAX package's resident engines and driver and against the port's own
scan tier: summaries, carries, GNN slabs and driver results bit for bit,
on both wires, over chunked calls; ResidentState.grow's layout; bucket
growth re-keying the tuner; the ingest ring, the mailbox and the knobs;
the tuners' checkpoint keys loading into either package.

The JAX tests' demotion, metrics and mesh cases belong to ROADMAP steps
1.8 and 1.10. Every test gets its own tuning cache and one torch
thread; sizes stay small (eb ≤ 256, vb ≤ 1024, super-batches ≤ 16)."""

import threading

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core import driver as jax_driver_mod
from gelly_streaming_tpu.ops import gnn_window as jax_gnn
from gelly_streaming_tpu.ops import pallas_window as pw
from gelly_streaming_tpu.ops import resident_engine as jax_res
from gelly_streaming_tpu.utils import checkpoint as jax_checkpoint
from gelly_streaming_tpu_torch import (GnnResidentEngine, GnnSummaryEngine,
                                       StreamingAnalyticsDriver,
                                       StreamSummaryEngine, forced_sync)
from gelly_streaming_tpu_torch.core import driver as driver_mod
from gelly_streaming_tpu_torch.ops import gnn_window as gw
from gelly_streaming_tpu_torch.ops import resident_engine
from gelly_streaming_tpu_torch.ops.resident_engine import (
    IngestRing, Mailbox, ResidentState, ResidentSummaryEngine)
from gelly_streaming_tpu_torch.utils import checkpoint

KNOBS = ("GS_AUTOTUNE", "GS_AUTOTUNE_ROUND", "GS_AUTOTUNE_EXPLORE",
         "GS_RESIDENT", "GS_RESIDENT_SPB", "GS_RESIDENT_SLOTS",
         "GS_PALLAS_WINDOW", "GS_GNN_PALLAS", "GS_EGRESS_CAP")


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TUNE_CACHE", str(tmp_path / "tune"))
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    pw._reset_pallas_window()
    jax_res._reset_resident()
    jax_driver_mod._reset_snapshot_tier()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    pw._reset_pallas_window()
    jax_res._reset_resident()
    jax_driver_mod._reset_snapshot_tier()


def _stream(n, v, seed=9):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, n).astype(np.int32),
            rng.integers(0, v, n).astype(np.int32))


def _carry_equal(a, b):
    for x, y in zip(a, b):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _port(eb=128, vb=256, **kw):
    kw.setdefault("superbatch", 8)
    return ResidentSummaryEngine(eb, vb, device="cpu", **kw)


# ----------------------------------------------------------------------
# the summary engine
# ----------------------------------------------------------------------
@pytest.mark.parametrize("wire", [None, "standard"])
@pytest.mark.parametrize("tuner", ["0", "1"])
def test_engine_matches_jax_and_scan(monkeypatch, wire, tuner):
    """Against the JAX ResidentSummaryEngine (same wire, same
    super-batch) and the port's scan engine: every summary and the carry.
    The stream's last window is ragged, so every form joins the cover's
    sentinels and the carries agree on every slot."""
    monkeypatch.setenv("GS_AUTOTUNE", tuner)
    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", "2")
    monkeypatch.setenv("GS_AUTOTUNE_ROUND", "1")
    src, dst = _stream(45 * 128 + 77, 200)
    port = _port(ingress=wire)
    assert port.ingress == (wire or "compact")
    got = port.process(src, dst)
    jax_eng = jax_res.ResidentSummaryEngine(128, 256, k_bucket=port.kb,
                                            ingress=wire, superbatch=8)
    assert jax_eng.ingress == port.ingress
    assert jax_eng.process(src.copy(), dst.copy()) == got
    _carry_equal(port.state_dict()["carry"], jax_eng.state_dict()["carry"])
    scan = StreamSummaryEngine(128, 256, device="cpu")
    assert scan.process(src, dst) == got
    _carry_equal(port.state_dict()["carry"], scan.state_dict()["carry"])
    if tuner == "1":
        assert port._tuner.space == {"wb": [2, 4, 8],
                                     "ingress": [port.ingress]}
        assert port._tuner._round > 1


def test_warm_leaves_the_carry_alone(monkeypatch):
    """Whole windows only: the JAX tuned engine's warm chunk joins the
    cover's two sentinels in its live carry (slot 2vb+1 reads vb), the
    port's warms a throwaway carry, so it keeps the static path's carry.
    Every summary and every other slot agree."""
    monkeypatch.setenv("GS_AUTOTUNE", "1")
    src, dst = _stream(40 * 128, 200, seed=4)
    port = _port()
    got = port.process(src, dst)
    jax_eng = jax_res.ResidentSummaryEngine(128, 256, k_bucket=port.kb,
                                            superbatch=8)
    assert jax_eng.process(src.copy(), dst.copy()) == got
    mine, theirs = port.state_dict()["carry"], jax_eng.state_dict()["carry"]
    _carry_equal(mine[:2], theirs[:2])
    vb = 256
    np.testing.assert_array_equal(mine[2][:2 * vb + 1],
                                  theirs[2][:2 * vb + 1])
    assert (mine[2][2 * vb + 1], theirs[2][2 * vb + 1]) == (2 * vb + 1, vb)
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    static = _port()
    assert static.process(src, dst) == got
    _carry_equal(static.state_dict()["carry"], mine)


def test_pipelined_equals_forced_sync_and_resumes(monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    src, dst = _stream(40 * 128, 200, seed=6)
    eng = _port()
    want = eng.process(src, dst)
    eng.reset()
    with forced_sync():
        assert eng.process(src, dst) == want
    # a state_dict at a super-batch boundary, resumed in either package
    eng.reset()
    head = eng.process(src[:16 * 128], dst[:16 * 128])
    state = eng.state_dict()
    fresh = _port()
    fresh.load_state_dict(state)
    assert head + fresh.process(src[16 * 128:], dst[16 * 128:]) == want
    jax_eng = jax_res.ResidentSummaryEngine(128, 256, k_bucket=eng.kb,
                                            superbatch=8)
    jax_eng.load_state_dict(state)
    assert jax_eng.process(src[16 * 128:].copy(),
                           dst[16 * 128:].copy()) == want[16:]
    scan = StreamSummaryEngine(128, 256, device="cpu")
    scan.load_state_dict(jax_eng.state_dict())
    assert scan.windows_done == 40
    _carry_equal(scan.state_dict()["carry"], fresh.state_dict()["carry"])


def test_resident_state_matches_jax():
    st = ResidentState.fresh(4)
    jst = jax_res.ResidentState.fresh(4)
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a, b)
    for s in (st, jst):
        s.degrees[:4] = [3, 1, 0, 2]
        s.labels[:4] = [0, 0, 2, 2]
        s.cover[1] = 4 + 1 + 0               # into the (-) half
    grown = ResidentState.grow(st, 4, 8)
    for a, b in zip(grown, jax_res.ResidentState.grow(jst, 4, 8)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert grown.cover[1] == 8 + 1 + 0 and grown.cover[8] == 8
    assert grown.labels[4:].tolist() == [4, 5, 6, 7, 8]
    live = _port(64, 256).resident_state()
    assert all(isinstance(t, torch.Tensor) for t in live)
    for a, b in zip(live.to_host(), jax_res.ResidentState.fresh(256)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shrink"):
        ResidentState.grow(st, 8, 4)


def test_grown_carry_matches_jax():
    """A carried state grown mid-stream, engine against engine."""
    src, dst = _stream(20 * 64, 250, seed=8)
    eng = _port(64, 256)
    eng.process(src[:10 * 64], dst[:10 * 64])
    jax_eng = jax_res.ResidentSummaryEngine(64, 256, k_bucket=eng.kb,
                                            superbatch=8)
    jax_eng.process(src[:10 * 64].copy(), dst[:10 * 64].copy())
    eng.grow_vertex_bucket(1024)
    jax_eng.grow_vertex_bucket(1024)
    _carry_equal(eng.state_dict()["carry"], jax_eng.state_dict()["carry"])
    assert eng.process(src[10 * 64:], dst[10 * 64:]) == jax_eng.process(
        src[10 * 64:].copy(), dst[10 * 64:].copy())


def test_growth_rekeys_tuner_and_keeps_parity(monkeypatch):
    src, dst = _stream(32 * 64, 200, seed=2)
    full = _port(64, 512).process(src, dst)
    eng = _port(64, 256)
    head = eng.process(src[:16 * 64], dst[:16 * 64])
    tuner = eng._ensure_tuner()
    tuner.record(tuner.best(), 1000, 0.01)
    rounds, old_key = tuner.state_dict()["round"], tuner.key
    eng.grow_vertex_bucket(512)
    assert eng.vb == 512 and eng.windows_done == 16
    assert eng._tuner is tuner and tuner.key != old_key
    assert "vb=512" in tuner.key
    assert tuner.state_dict()["round"] == rounds
    assert head + eng.process(src[16 * 64:], dst[16 * 64:]) == full
    eng.grow_vertex_bucket(256)               # never shrinks
    assert eng.vb == 512


def test_growth_past_uint16_repins_and_pins_survive():
    eng = _port(64, 65536)
    assert eng.ingress == "compact"
    tuner = eng._ensure_tuner()
    tuner.record(tuner.best(), 1000, 0.01)
    eng.grow_vertex_bucket(2 * 65536)
    assert eng.ingress == "standard"
    assert tuner.space["ingress"] == ["standard"]
    assert tuner.incumbent["ingress"] == "standard"
    pinned = _port(64, 256, ingress="standard")
    pinned.grow_vertex_bucket(512)
    assert pinned.ingress == "standard" and pinned._pinned_ingress
    compact = _port(64, 1024, ingress="compact")
    compact.grow_vertex_bucket(2 * 65536)
    assert compact.ingress == "standard" and compact._pinned_ingress
    jax_eng = jax_res.ResidentSummaryEngine(64, 256, ingress="standard")
    jax_eng.grow_vertex_bucket(512)
    assert jax_eng.ingress == pinned.ingress


# ----------------------------------------------------------------------
# ring, mailbox, knobs
# ----------------------------------------------------------------------
def test_ingest_ring_bounds_and_order():
    ring = IngestRing(slots=2)
    assert ring.submit(lambda item: item * 10, 0, 0)
    assert ring.submit(lambda item: item * 10, 1, 1)
    assert ring.full and not ring.submit(lambda item: item, 2, 2)
    assert len(ring) == 2
    assert ring.pop(1) is None                # FIFO: the head is 0
    fut, item = ring.pop(0)
    assert (fut.result(), item) == (0, 0)
    assert ring.submit(lambda item: item * 10, 2, 2)
    ring.drain()
    assert len(ring) == 0 and ring.pop(1) is None
    with forced_sync():                       # declined: built inline
        assert not IngestRing(slots=2).submit(lambda item: item, 0, 0)


def test_mailbox_put_get_close_and_shed():
    box = Mailbox(capacity=2)
    assert box.put(1) and box.put(2)
    assert not box.put(3) and box.dropped == 1     # full: shed
    assert len(box) == 2 and box.get(timeout=0) == 1
    assert box.get(timeout=0) == 2
    assert box.get(timeout=0.01) is None           # empty: timeout
    got = []
    waiter = threading.Thread(target=lambda: got.append(box.get()))
    waiter.start()
    box.put(7)
    waiter.join(5)
    assert got == [7]
    box.put(8)
    box.close()
    assert box.closed and not box.put(9) and box.dropped == 2
    assert box.get() == 8 and box.get() is None    # drained, then None
    blocked = []
    late = Mailbox()
    t = threading.Thread(target=lambda: blocked.append(late.get()))
    t.start()
    late.close()
    t.join(5)
    assert blocked == [None]
    assert Mailbox(capacity=0).capacity == 1


def test_superbatch_and_slot_knobs(monkeypatch):
    assert resident_engine.resident_spb(4096) == 256
    assert resident_engine.ring_slots() == 2
    monkeypatch.setenv("GS_RESIDENT_SPB", "100")
    assert resident_engine.resident_spb(4096) == \
        jax_res.resident_spb(4096) == 128
    assert ResidentSummaryEngine(64, 256, device="cpu").MAX_WINDOWS == 128
    assert GnnResidentEngine(64, 256, feature_dim=8,
                             device="cpu").MAX_WINDOWS == 128
    monkeypatch.setenv("GS_RESIDENT_SLOTS", "5")
    eng = _port(64, 256)
    assert resident_engine.ring_slots() == 5 == IngestRing().slots
    assert eng.INGEST_SLOTS == 5 and eng._ring.slot_count == 6
    monkeypatch.setenv("GS_RESIDENT_SLOTS", "0")   # clamped at 1
    assert resident_engine.ring_slots() == 1 == eng.INGEST_SLOTS


def test_resolve_pins(monkeypatch):
    assert not resident_engine.resolve_resident()
    assert driver_mod.resolve_snapshot_tier() == "scan"
    monkeypatch.setenv("GS_RESIDENT", "on")
    assert resident_engine.resolve_resident()
    assert driver_mod.resolve_snapshot_tier() == "resident"
    drv = StreamingAnalyticsDriver(window_ms=0, device="cpu")
    assert drv.snapshot_tier == "resident"
    # an explicit tier wins over the pin
    assert StreamingAnalyticsDriver(window_ms=0, device="cpu",
                                    snapshot_tier="scan").snapshot_tier \
        == "scan"
    for pin in ("off", "auto"):
        monkeypatch.setenv("GS_RESIDENT", pin)
        assert not resident_engine.resolve_resident()
    assert not resident_engine.resolve_resident_cohort()


# ----------------------------------------------------------------------
# the GNN engine
# ----------------------------------------------------------------------
def _gnn_setup(eng, F, vb):
    rng = np.random.RandomState(3)
    keep = rng.random_sample((F, F)) < 2.0 / F
    eng.set_weights(rng.randint(-3, 4, (F, F)) * keep / 32,
                    rng.randint(-8, 9, F) / 32)
    eng.load_feature_units(gw.default_features(vb, F, seed=5))
    return eng


@pytest.mark.parametrize("F,act", [(16, "relu"), (8, "abs")])
def test_gnn_resident_matches_jax(monkeypatch, F, act):
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    src, dst = _stream(37 * 128 + 50, 256, seed=1)
    port = _gnn_setup(GnnResidentEngine(128, 256, feature_dim=F,
                                        activation=act, device="cpu",
                                        superbatch=16), F, 256)
    assert port.MAX_WINDOWS == 16
    got = port.process(src, dst)
    jax_eng = _gnn_setup(jax_gnn.GnnResidentEngine(
        128, 256, feature_dim=F, activation=act, superbatch=16), F, 256)
    assert jax_eng.process(src.copy(), dst.copy()) == got
    np.testing.assert_array_equal(port.state_dict()["carry"][0],
                                  np.asarray(jax_eng.state_dict()["carry"][0]))
    scan = _gnn_setup(GnnSummaryEngine(128, 256, feature_dim=F,
                                       activation=act, device="cpu"), F, 256)
    assert scan.process(src, dst) == got
    np.testing.assert_array_equal(port.state(), scan.state())
    # state_dict leaves the slab live, and resumes in either package
    port.reset()
    _gnn_setup(port, F, 256)
    head = port.process(src[:16 * 128], dst[:16 * 128])
    state = port.state_dict()
    assert port.process(src[16 * 128:], dst[16 * 128:]) == got[16:]
    back = _gnn_setup(jax_gnn.GnnResidentEngine(
        128, 256, feature_dim=F, activation=act, superbatch=16), F, 256)
    back.load_state_dict(state)
    assert head + back.process(src[16 * 128:].copy(),
                               dst[16 * 128:].copy()) == got
    fresh = GnnResidentEngine(128, 256, feature_dim=F, activation=act,
                              device="cpu", superbatch=16)
    fresh.load_state_dict(jax_eng.state_dict())
    np.testing.assert_array_equal(fresh.state(), port.state())


# ----------------------------------------------------------------------
# the driver's resident tier
# ----------------------------------------------------------------------
def _results(results):
    return [(r.window_start, r.num_edges, r.triangles, r.vertex_ids.tolist(),
             r.degrees.tolist(), r.cc_labels.tolist(),
             r.bipartite_odd.tolist(),
             tuple(None if getattr(r, f) is None else
                   tuple(np.asarray(x).tolist() for x in getattr(r, f))
                   for f in ("delta_degrees", "delta_cc",
                             "delta_bipartite")))
            for r in results]


def _driver_stream(n=40 * 128, v=300, seed=9):
    src, dst = _stream(n, v, seed)
    return src.astype(np.int64) * 7 + 2, dst.astype(np.int64) * 7 + 2


CUTS = ((0, 11), (11, 30), (30, 40))


@pytest.mark.parametrize("egress", ["full", "delta"])
@pytest.mark.parametrize("emit_deltas", [False, True])
@pytest.mark.parametrize("tuner", ["0", "1"])
def test_driver_resident_matches_jax_and_scan(monkeypatch, egress,
                                              emit_deltas, tuner):
    """Over chunked calls (the vertex bucket grows 64 -> 512): equal to
    the JAX driver under GS_RESIDENT=on and to the port's scan tier."""
    monkeypatch.setenv("GS_AUTOTUNE", tuner)
    monkeypatch.setenv("GS_AUTOTUNE_ROUND", "1")
    monkeypatch.setenv("GS_RESIDENT_SPB", "8")
    src, dst = _driver_stream()
    kw = dict(window_ms=0, edge_bucket=128, vertex_bucket=64,
              emit_deltas=emit_deltas)
    monkeypatch.setenv("GS_RESIDENT", "on")
    jax_drv = jax_driver_mod.StreamingAnalyticsDriver(egress=egress, **kw)
    want, got, scan = [], [], []
    port = StreamingAnalyticsDriver(device="cpu", egress=egress, **kw)
    other = StreamingAnalyticsDriver(device="cpu", snapshot_tier="scan",
                                     **kw)
    assert port.snapshot_tier == "resident"
    for lo, hi in CUTS:
        part = slice(lo * 128, hi * 128)
        want += jax_drv.run_arrays(src[part], dst[part])
        got += port.run_arrays(src[part], dst[part])
        scan += other.run_arrays(src[part], dst[part])
    assert jax_drv._resident_now and port.vb == jax_drv.vb == 512
    assert _results(got) == _results(want) == _results(scan)
    assert (port._resident_tuner is None) == (tuner == "0")


def test_driver_resident_resumes_inside_a_call(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    monkeypatch.setenv("GS_RESIDENT_SPB", "8")
    src, dst = _driver_stream()
    kw = dict(window_ms=0, edge_bucket=128, vertex_bucket=512,
              snapshot_tier="resident", device="cpu")
    want = StreamingAnalyticsDriver(**kw).run_arrays(src, dst)
    path = str(tmp_path / "driver.npz")
    first = StreamingAnalyticsDriver(**kw)
    first.enable_auto_checkpoint(path, every_n_windows=32)
    first.run_arrays(src, dst)
    second = StreamingAnalyticsDriver(**kw)
    assert second.try_resume(path) and second.windows_done == 32
    rest = second.run_arrays(src[32 * 128:], dst[32 * 128:])
    assert _results(rest) == _results(want[32:])
    # and into the JAX driver's scan tier
    jax_drv = jax_driver_mod.StreamingAnalyticsDriver(
        window_ms=0, edge_bucket=128, vertex_bucket=512,
        snapshot_tier="scan", egress="full")
    jax_drv.load_state_dict(jax_checkpoint.restore(path))
    assert _results(jax_drv.run_arrays(src[32 * 128:], dst[32 * 128:])) \
        == _results(want[32:])


def test_driver_tuner_keys_load_both_ways(monkeypatch, tmp_path):
    """"autotune_resident" (and "autotune", beside it) through the
    checkpoint file format into the JAX driver and back."""
    monkeypatch.setenv("GS_AUTOTUNE_ROUND", "1")
    monkeypatch.setenv("GS_RESIDENT_SPB", "16")
    src, dst = _driver_stream()
    kw = dict(window_ms=0, edge_bucket=128, vertex_bucket=512)
    port = StreamingAnalyticsDriver(device="cpu", snapshot_tier="resident",
                                    **kw)
    port.run_arrays(src, dst)
    port._ensure_scan_tuner().record({"wb": 64}, 1000, 0.01)
    state = port.state_dict()
    assert state["autotune_resident"] == port._resident_tuner.state_dict()
    assert state["autotune"] == port._scan_tuner.state_dict()
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, state)
    jax_drv = jax_driver_mod.StreamingAnalyticsDriver(
        snapshot_tier="resident", egress="full", **kw)
    jax_drv.load_state_dict(jax_checkpoint.restore(path))
    assert jax_drv._resident_tuner.state_dict() == state["autotune_resident"]
    assert jax_drv._scan_tuner.state_dict() == state["autotune"]
    jax_drv._resident_tuner.record(jax_drv._resident_tuner.best(), 500, 0.01)
    jax_path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(jax_path, jax_drv.state_dict())
    back = StreamingAnalyticsDriver(device="cpu", snapshot_tier="resident",
                                    **kw)
    back.load_state_dict(checkpoint.restore(jax_path))
    assert back._resident_tuner.state_dict() == \
        jax_drv._resident_tuner.state_dict()
    assert back._scan_tuner.state_dict() == jax_drv._scan_tuner.state_dict()
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    off = StreamingAnalyticsDriver(device="cpu", snapshot_tier="resident",
                                   **kw)
    off.load_state_dict(checkpoint.restore(jax_path))
    assert off._resident_tuner is None and off._scan_tuner is None


def test_driver_growth_rekeys_resident_tuner(monkeypatch):
    monkeypatch.setenv("GS_RESIDENT_SPB", "8")
    drv = StreamingAnalyticsDriver(window_ms=0, edge_bucket=128,
                                   vertex_bucket=256, device="cpu",
                                   snapshot_tier="resident")
    tuner = drv._ensure_resident_tuner()
    tuner.record(tuner.best(), 1000, 0.01)
    rounds, old_key = tuner.state_dict()["round"], tuner.key
    src, dst = _driver_stream(n=12 * 128, v=2000, seed=3)
    drv.run_arrays(src, dst)
    assert drv.vb > 256
    assert drv._resident_tuner is tuner and tuner.key != old_key
    assert "vb=%d" % drv.vb in tuner.key
    assert tuner.state_dict()["round"] >= rounds
