"""The port's online dispatch tuner (gelly_streaming_tpu_torch/ops/
autotune.py) held against the JAX package's (ops/autotune.py): the same
decisions on the same recorded timings, the cache and the state_dict
both ways; and the engines that use it on device="cpu": the triangle
stream's counts and the summary engine's summaries and carry identical
with the tuner on and off and equal to the JAX package's (its static
path, K and wire pinned: its defaults read committed evidence files),
pinned knobs freezing their dimension, and the engines' and the driver's
checkpoints carrying the tuner into either package.

Every test gets its own tuning cache (GS_TUNE_CACHE under tmp_path) and
one torch thread."""

import json
import os

import numpy as np
import pytest
import torch

from gelly_streaming_tpu.core.driver import (
    StreamingAnalyticsDriver as JaxDriver)
from gelly_streaming_tpu.ops import autotune as jax_autotune
from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu.utils import checkpoint as jax_checkpoint
from gelly_streaming_tpu_torch import (StreamingAnalyticsDriver,
                                       StreamSummaryEngine,
                                       TriangleWindowKernel)
from gelly_streaming_tpu_torch.ops import autotune
from gelly_streaming_tpu_torch.utils import checkpoint


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.setenv("GS_TUNE_CACHE", str(tmp_path / "tune"))
    for name in ("GS_AUTOTUNE", "GS_AUTOTUNE_ROUND",
                 "GS_AUTOTUNE_EXPLORE"):
        monkeypatch.delenv(name, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stream(n, v, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, n)
    dst = (src + 1 + rng.integers(0, v - 1, n)) % v
    return src.astype(np.int32), dst.astype(np.int32)


def _pair(space, initial, margin=1.05):
    """The port's tuner and the JAX one over one space, each with its
    own cache file (distinct backends)."""
    return (autotune.DispatchTuner("t:eb=8:vb=8", space, initial,
                                   margin=margin, backend="cpu"),
            jax_autotune.DispatchTuner("t:eb=8:vb=8", space, initial,
                                       margin=margin, backend="jax"))


def _tuner(**kw):
    kw.setdefault("key", "t:eb=8:vb=8")
    kw.setdefault("space", {"wb": [2, 4, 8]})
    kw.setdefault("initial", {"wb": 8})
    return autotune.DispatchTuner(**kw)


# ----------------------------------------------------------------------
# the tuner, against the JAX one
# ----------------------------------------------------------------------
SPACES = [
    ({"wb": [2, 4, 8]}, {"wb": 8}),
    ({"wb": [16, 32, 64], "ingress": ["standard", "compact"]},
     {"wb": 64, "ingress": "standard"}),
    ({"wb": [16, 32, 64], "kb": [32, 128], "ingress": ["standard",
                                                       "compact"]},
     {"wb": 32, "kb": 32, "ingress": "compact"}),
]


@pytest.mark.parametrize("space,initial", SPACES)
@pytest.mark.parametrize("explore", ["2", "3", "5"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_same_decisions_as_jax(monkeypatch, space, initial, explore, seed):
    """Both tuners pick each round's arm; the arms agree, each gets the
    same (edges, seconds), and the incumbents, timelines and states
    agree after every round."""
    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", explore)
    rng = np.random.default_rng(seed)
    mine, theirs = _pair(space, initial)
    speed = {json.dumps(a, sort_keys=True): rng.uniform(0.5, 2.0)
             for a in _all_arms(space)}
    for _ in range(40):
        arm = mine.next_round()
        assert arm == theirs.next_round()
        edges = int(rng.integers(1, 10 ** 6))
        seconds = float(edges / (1e6 * speed[json.dumps(arm, sort_keys=True)]
                                 * rng.uniform(0.9, 1.1)))
        mine.record(arm, edges, seconds)
        theirs.record(arm, edges, seconds)
        assert mine.best() == theirs.best()
        assert mine.state_dict() == theirs.state_dict()
    assert [(e["round"], e["action"], e["arm"]) for e in mine.timeline] == \
        [(e["round"], e["action"], e["arm"]) for e in theirs.timeline]
    assert mine.summary()["promotions"] == theirs.summary()["promotions"]


def _all_arms(space):
    arms = [{}]
    for k, vs in space.items():
        arms = [dict(a, **{k: v}) for a in arms for v in vs]
    return arms


def test_zero_rounds_are_ignored_by_both():
    mine, theirs = _pair({"wb": [2, 4, 8]}, {"wb": 8})
    for t in (mine, theirs):
        t.record({"wb": 4}, 0, 1.0)
        t.record({"wb": 4}, 100, 0.0)
    assert mine.state_dict() == theirs.state_dict() == _tuner().state_dict()


def test_exploit_by_default_explore_on_cadence(monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", "3")
    t = _tuner()
    seen = []
    for _ in range(6):
        arm = t.next_round()
        seen.append(arm["wb"])
        t.record(arm, 1000, 1.0)
    assert seen[0] == seen[1] == 8 and seen[2] != 8
    assert t.best() == {"wb": 8}


def test_promotion_needs_margin_and_two_observations():
    t = _tuner(margin=1.05)
    t.record({"wb": 8}, 1000, 1.0)
    t.record({"wb": 4}, 3000, 1.0)
    assert t.best() == {"wb": 8}          # one lucky draw: no promotion
    t.record({"wb": 4}, 3000, 1.0)
    assert t.best() == {"wb": 4}
    t.record({"wb": 2}, 3100, 1.0)
    t.record({"wb": 2}, 3100, 1.0)
    assert t.best() == {"wb": 4}          # under the 1.05 margin
    assert [e["action"] for e in t.timeline] == [
        "exploit", "explore", "promote", "explore", "explore"]


def test_cache_round_trip_seed_and_space(tmp_path):
    t = _tuner()
    t.record({"wb": 8}, 1000, 1.0)
    t.record({"wb": 4}, 4000, 1.0)
    t.record({"wb": 4}, 4000, 1.0)
    t.save()
    path = autotune.cache_path("cpu")
    assert path == str(tmp_path / "tune" / "tuning_cpu.json")
    assert json.load(open(path))["t:eb=8:vb=8"]["arm"] == {"wb": 4}
    t2 = _tuner()
    assert t2.best() == {"wb": 4}
    assert t2.timeline[0]["action"] == "cache_seed"
    # a cached arm outside the space seeds nothing; another backend's
    # cache is another file
    assert _tuner(space={"wb": [8, 16]}, initial={"wb": 16}).best() == \
        {"wb": 16}
    assert _tuner(backend="cuda").best() == {"wb": 8}


def test_cache_file_is_the_jax_format(tmp_path):
    """A cache written by either tuner seeds the other (same file
    layout; the port keeps its own directory and backend names)."""
    t = _tuner()
    t.record({"wb": 8}, 1000, 1.0)
    t.record({"wb": 2}, 9000, 1.0)
    t.record({"wb": 2}, 9000, 1.0)
    t.save()
    assert jax_autotune.load_cached_best("t:eb=8:vb=8", "cpu")["arm"] == \
        {"wb": 2}


def test_cache_disabled_and_corrupt(monkeypatch, tmp_path):
    monkeypatch.setenv("GS_TUNE_CACHE", "0")
    assert autotune.cache_path("cpu") == ""
    t = _tuner()
    t.record({"wb": 8}, 1000, 1.0)
    t.save()                                  # a no-op
    assert autotune.load_cached_best("t:eb=8:vb=8", "cpu") is None
    monkeypatch.setenv("GS_TUNE_CACHE", str(tmp_path / "corrupt"))
    os.makedirs(tmp_path / "corrupt")
    for text in ("{not json", "[1, 2]", '{"t:eb=8:vb=8": {"arm": 3}}'):
        with open(autotune.cache_path("cpu"), "w") as f:
            f.write(text)
        assert autotune.load_cached_best("t:eb=8:vb=8", "cpu") is None
        assert _tuner().best() == {"wb": 8}
    t.save()                                  # repairs the file
    assert autotune.load_cached_best("t:eb=8:vb=8", "cpu") is not None


def test_state_dict_loads_both_ways():
    mine, theirs = _pair({"wb": [2, 4, 8]}, {"wb": 8})
    for i, t in enumerate((mine, theirs)):
        for j in range(5):
            arm = t.next_round()
            t.record(arm, 1000 + 300 * j * (i + 1), 1.0)
    a, b = _pair({"wb": [2, 4, 8]}, {"wb": 8})
    a.load_state_dict(theirs.state_dict())
    b.load_state_dict(mine.state_dict())
    assert a.state_dict() == theirs.state_dict()
    assert b.state_dict() == mine.state_dict()
    # an incumbent outside the current space is dropped
    c = _tuner(space={"wb": [16, 32]}, initial={"wb": 32})
    c.load_state_dict(mine.state_dict())
    assert c.best() == {"wb": 32}


def test_rekey_matches_jax():
    mine, theirs = _pair({"wb": [2, 4, 8]}, {"wb": 8})
    for t in (mine, theirs):
        t.record({"wb": 8}, 1000, 1.0)
        t.record({"wb": 4}, 5000, 1.0)
        t.record({"wb": 4}, 5000, 1.0)
        t.rekey("t:eb=8:vb=16", space={"wb": [4, 8, 16]},
                initial={"wb": 16})
    assert mine.best() == theirs.best() == {"wb": 4}
    assert mine.state_dict() == theirs.state_dict()
    with pytest.raises(ValueError, match="rekey"):
        mine.rekey("t:x", space={"wb": [32]})


def test_initial_outside_space_rejected():
    with pytest.raises(ValueError, match="outside"):
        _tuner(initial={"wb": 3})
    with pytest.raises(ValueError, match="outside"):
        _tuner(initial={"kb": 8})


# ----------------------------------------------------------------------
# RoundPlan: the engines' one chunk loop
# ----------------------------------------------------------------------
def test_round_plan_static_is_one_round_of_chunks():
    plan = autotune.RoundPlan(10, {"wb": 4, "ingress": "standard"})
    chunks = list(plan)
    assert [(c.seq, c.at, c.hi, c.round) for c in chunks] == [
        (0, 0, 4, 0), (1, 4, 8, 0), (2, 8, 10, 0)]
    assert all(c.arm == {"wb": 4, "ingress": "standard"} for c in chunks)


def test_round_plan_overlaps_rounds_and_keeps_the_explore_schedule(
        monkeypatch):
    """The pipeline draws round r+1's first chunk (and so decides its
    arm) before round r's last chunk is finalized: no drain between
    rounds. The explore schedule counts the rounds in flight, so it is
    the one of a caller that records each round before the next."""
    from gelly_streaming_tpu_torch.ops import ingress_pipeline

    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", "2")
    tuner = autotune.DispatchTuner("t:plan", {"wb": [1, 2]}, {"wb": 2},
                                   margin=1e9, backend="cpu")
    decided = []
    plan = autotune.RoundPlan(24, {"wb": 2}, tuner, round_len=2,
                              on_round=lambda arm, w: decided.append(
                                  (arm["wb"], w)))
    log = []

    def prep(ch):
        log.append(("prep", ch.seq, ch.round))
        return ch

    def finalize(ch):
        log.append(("fin", ch.seq, ch.round))
        plan.done(ch, (ch.hi - ch.at) * 10)

    ingress_pipeline.run_pipeline(plan, prep, lambda ch: ch,
                                  lambda ch: ch, finalize, workers=2)
    plan.close()
    for r in range(len(decided) - 1):
        first_next = min(i for i, e in enumerate(log)
                         if e[0] == "prep" and e[2] == r + 1)
        last_fin = max(i for i, e in enumerate(log)
                       if e[0] == "fin" and e[2] == r)
        assert first_next < last_fin
    assert decided == [(2, 4), (1, 2)] * 4
    assert [e["action"] for e in tuner.timeline] == [
        "exploit", "explore"] * 4
    assert [e[1] for e in log if e[0] == "fin"] \
        == list(range(16))


def test_round_plan_frozen_under_forced_sync():
    from gelly_streaming_tpu_torch import forced_sync

    tuner = autotune.DispatchTuner("t:frozen", {"wb": [1, 2]}, {"wb": 2},
                                   backend="cpu")
    with forced_sync():
        plan = autotune.RoundPlan(9, {"wb": 2}, tuner, round_len=2)
        for ch in plan:
            plan.done(ch, 1)
        plan.close()
    assert tuner._round == 0 and tuner.timeline == []


# ----------------------------------------------------------------------
# the engines: the same results at every arm
# ----------------------------------------------------------------------
def test_triangle_counts_identical_on_off_and_jax(monkeypatch):
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    k0 = TriangleWindowKernel(256, 1024, device="cpu")
    n_w = 2 * k0.MAX_STREAM_WINDOWS + 3
    src, dst = _stream(n_w * 256, 1024)
    static = k0.count_stream(src, dst)
    assert k0.tuner is None
    want = jax_tri.TriangleWindowKernel(
        256, 1024, k_bucket=k0.kb, ingress="standard")._count_stream_device(
        src, dst)
    assert static == [int(c) for c in want]
    monkeypatch.setenv("GS_AUTOTUNE", "1")
    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", "2")
    monkeypatch.setenv("GS_AUTOTUNE_ROUND", "1")
    k = TriangleWindowKernel(256, 1024, device="cpu")
    for _ in range(3):
        assert k.count_stream(src, dst) == static
    tried = {json.dumps(e["arm"], sort_keys=True) for e in k.tuner.timeline}
    assert k.tuner._round > 0 and len(tried) > 1
    # a short stream runs the static path
    k2 = TriangleWindowKernel(256, 1024, device="cpu")
    k2.count_stream(src[:256 * 8], dst[:256 * 8])
    assert k2.tuner is None


def test_pinned_knobs_freeze_dimensions():
    k = TriangleWindowKernel(256, 1024, k_bucket=8, ingress="standard",
                             device="cpu")
    space = k._tuner_space()
    assert space == {"wb": [16, 32, 64], "kb": [8],
                     "ingress": ["standard"]}
    free = TriangleWindowKernel(256, 1024, device="cpu")._tuner_space()
    assert free["ingress"] == ["standard", "compact"]
    assert free["kb"] == sorted(set(
        TriangleWindowKernel(256, 1024,
                             device="cpu")._escalation_ladder()[:3]))
    wide = TriangleWindowKernel(256, 1 << 17, device="cpu")._tuner_space()
    assert wide["ingress"] == ["standard"]       # ids past uint16
    jax_free = jax_tri.TriangleWindowKernel(256, 1024, k_bucket=free["kb"][0])
    assert jax_free._tuner_space()["ingress"] == free["ingress"]
    eng = StreamSummaryEngine(256, 1024, ingress="compact", device="cpu")
    assert eng._ensure_tuner().space["ingress"] == ["compact"]
    eng = StreamSummaryEngine(256, 1024, device="cpu")
    assert eng._ensure_tuner().space == {
        "wb": [16, 32, 64], "ingress": ["standard", "compact"]}


def test_forced_sync_freezes_the_tuner(monkeypatch):
    from gelly_streaming_tpu_torch import forced_sync

    src, dst = _stream(140 * 64, 256, seed=5)
    eng = StreamSummaryEngine(64, 256, device="cpu")
    with forced_sync():
        eng.process(src, dst)
    assert eng._tuner is not None and eng._tuner._round == 0
    assert eng._tuner.timeline == []


@pytest.mark.parametrize("wire", [None, "compact"])
def test_summaries_identical_on_off_and_jax(monkeypatch, wire):
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    src, dst = _stream(150 * 64 + 21, 512, seed=7)
    static = StreamSummaryEngine(64, 512, ingress=wire, device="cpu")
    want = static.process(src, dst)
    jax_eng = jax_scan.StreamSummaryEngine(64, 512, k_bucket=static.kb,
                                           ingress="standard")
    assert jax_eng.process(src, dst) == want
    monkeypatch.setenv("GS_AUTOTUNE", "1")
    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", "2")
    monkeypatch.setenv("GS_AUTOTUNE_ROUND", "1")
    eng = StreamSummaryEngine(64, 512, ingress=wire, device="cpu")
    for _ in range(2):
        eng.reset()
        assert eng.process(src, dst) == want
        # the port warms arms on a throwaway carry: the carry is the
        # static path's bit for bit
        for a, b in zip(eng.state_dict()["carry"],
                        static.state_dict()["carry"]):
            np.testing.assert_array_equal(a, b)
    assert eng._tuner._round > 0


def test_engine_checkpoint_carries_the_tuner_both_ways(monkeypatch,
                                                       tmp_path):
    """An engine checkpoint with "autotune", through the checkpoint file
    format, into a fresh port engine and into the JAX engine (and the
    JAX engine's into the port's): the same tuning state, and the rest of
    the stream equal."""
    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", "2")
    monkeypatch.setenv("GS_AUTOTUNE_ROUND", "1")
    src, dst = _stream(200 * 64, 512, seed=9)
    cut = 140 * 64
    eng = StreamSummaryEngine(64, 512, ingress="standard", device="cpu")
    head = eng.process(src[:cut], dst[:cut])
    state = eng.state_dict()
    assert state["autotune"] == eng._tuner.state_dict()
    path = str(tmp_path / "engine.npz")
    checkpoint.save(path, state)
    jax_eng = jax_scan.StreamSummaryEngine(64, 512, k_bucket=eng.kb,
                                           ingress="standard")
    jax_eng.load_state_dict(jax_checkpoint.restore(path))
    assert jax_eng._tuner.state_dict() == eng._tuner.state_dict()
    fresh = StreamSummaryEngine(64, 512, ingress="standard", device="cpu")
    fresh.load_state_dict(checkpoint.restore(path))
    assert fresh._tuner.state_dict() == eng._tuner.state_dict()
    assert fresh._tuner.best() == eng._tuner.best()
    rest = fresh.process(src[cut:], dst[cut:])
    assert head + rest == jax_scan.StreamSummaryEngine(
        64, 512, k_bucket=eng.kb, ingress="standard").process(src, dst)
    # the JAX engine's tuned checkpoint into the port
    jax_path = str(tmp_path / "jax.npz")
    jax_eng.process(src[cut:], dst[cut:])
    jax_checkpoint.save(jax_path, jax_eng.state_dict())
    back = StreamSummaryEngine(64, 512, ingress="standard", device="cpu")
    back.load_state_dict(checkpoint.restore(jax_path))
    assert back._tuner.state_dict() == jax_eng._tuner.state_dict()
    assert back.windows_done == jax_eng.windows_done
    # with GS_AUTOTUNE=0 the key is carried nowhere
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    off = StreamSummaryEngine(64, 512, ingress="standard", device="cpu")
    off.load_state_dict(checkpoint.restore(path))
    assert off._tuner is None and "autotune" not in off.state_dict()


def _digest(results):
    return [(r.window_start, r.num_edges, r.triangles,
             r.vertex_ids.tobytes(), r.degrees.tobytes(),
             r.cc_labels.tobytes(), r.bipartite_odd.tobytes())
            for r in results]


def test_driver_scan_tuner_digests_and_checkpoint(monkeypatch):
    """The driver's scan tier under its tuner: the same WindowResults as
    with it off and as the JAX driver's, over chunked calls; its state
    rides the checkpoint as "autotune" into either package."""
    src, dst = _stream(300 * 64, 900, seed=11)
    src, dst = src.astype(np.int64) * 3 + 1, dst.astype(np.int64) * 3 + 1
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    jax_drv = JaxDriver(window_ms=0, edge_bucket=64, vertex_bucket=256,
                        snapshot_tier="scan", egress="full")
    want = _digest(jax_drv.run_arrays(src, dst))
    monkeypatch.setenv("GS_AUTOTUNE", "1")
    monkeypatch.setenv("GS_AUTOTUNE_EXPLORE", "2")
    monkeypatch.setenv("GS_AUTOTUNE_ROUND", "1")
    drv = StreamingAnalyticsDriver(window_ms=0, edge_bucket=64,
                                   vertex_bucket=256, device="cpu")
    got = []
    for lo, hi in ((0, 100), (100, 230), (230, 300)):
        got += drv.run_arrays(src[lo * 64:hi * 64], dst[lo * 64:hi * 64])
    assert _digest(got) == want
    assert drv._scan_tuner is not None and drv._scan_tuner._round > 1
    state = drv.state_dict()
    assert state["autotune"] == drv._scan_tuner.state_dict()
    assert "autotune_resident" not in state
    jax2 = JaxDriver(window_ms=0, edge_bucket=64, vertex_bucket=256,
                     snapshot_tier="scan", egress="full")
    jax2.load_state_dict(state)
    assert jax2._scan_tuner.state_dict() == drv._scan_tuner.state_dict()
    port2 = StreamingAnalyticsDriver(window_ms=0, edge_bucket=64,
                                     vertex_bucket=256, device="cpu")
    port2.load_state_dict(jax2.state_dict())
    assert port2._scan_tuner.state_dict() == drv._scan_tuner.state_dict()
