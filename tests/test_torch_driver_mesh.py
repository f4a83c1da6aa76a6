"""The port's mesh driver (StreamingAnalyticsDriver(mesh=) of
gelly_streaming_tpu_torch/core/driver.py over
parallel/sharded.make_sharded_snapshot_scan) held against the JAX
package's driver with mesh=make_mesh(4) and with no mesh, on the 8-device
virtual CPU mesh of tests/conftest.py: n=1 in this process (a one-rank
gloo group), n=3 and n=4 in two gloo groups of that many ranks spawned
for the whole file (tests/torch_driver_mesh_worker.py through
tests/torch_mesh_worker.Group), started together at the first test.

Checks, every window bit-equal (no tolerance: the analytics are
integers): the fixtures of tests/operations/test_mesh_faults.py,
tests/test_driver.py (event time with buckets growing en route, growth
inside a call both ways, growth after the carry exists) and
tests/test_deltas.py's deltas; the "engine" key against the JAX mesh
checkpoint's; checkpoints across the modes and the packages both ways,
one inside a call; only rank 0 writing the auto-checkpoints and the
journal; the port's twins of the 14 mesh-fault drills, each held to the
port's ladder (sharded -> scan, never below); the refusals; every rank's
results equal."""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gelly_streaming_tpu.core.driver import (
    StreamingAnalyticsDriver as JaxDriver)
from gelly_streaming_tpu.ops import scan_analytics as jax_scan
from gelly_streaming_tpu.ops import triangles as jax_tri
from gelly_streaming_tpu.parallel import mesh as jax_mesh
from gelly_streaming_tpu.utils import checkpoint as jax_ck
from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
from gelly_streaming_tpu_torch.core import driver as driver_mod
from gelly_streaming_tpu_torch.parallel import mesh, sharded
from gelly_streaming_tpu_torch.utils import faults
from tests import torch_driver_mesh_worker as W
from tests import torch_mesh_worker as base

SIZES = (1, 3, 4)
SCENARIOS = ["parity", "ckpt", "faults", "xpkg"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_JAX = {}


def jax_once(key, make):
    """A JAX oracle, run once a module (GS_AUTOTUNE=0: its defaults read
    evidence files; full egress pinned)."""
    if key not in _JAX:
        saved = os.environ.get("GS_AUTOTUNE")
        os.environ["GS_AUTOTUNE"] = "0"
        try:
            _JAX[key] = make()
        finally:
            if saved is None:
                os.environ.pop("GS_AUTOTUNE")
            else:
                os.environ["GS_AUTOTUNE"] = saved
    return _JAX[key]


def jdriver(mesh4: bool, **kw):
    if mesh4:
        return JaxDriver(mesh=jax_mesh.make_mesh(4), egress="full", **kw)
    return JaxDriver(snapshot_tier="scan", egress="full", **kw)


# ----------------------------------------------------------------------
# the JAX oracles
# ----------------------------------------------------------------------

def jax_faults(mesh4: bool) -> list:
    src, dst = W.fault_stream()
    d = jdriver(mesh4, window_ms=0, edge_bucket=W.EB, vertex_bucket=W.VB,
                analytics=W.FAULT_ANALYTICS)
    out = W.key(d.run_arrays(src[:4 * W.EB], dst[:4 * W.EB]))
    out += W.key(d.run_arrays(src[4 * W.EB:], dst[4 * W.EB:]))
    return out, d.state_dict()


def jax_event(mesh4: bool):
    s, t, ts = W.event_stream()
    d = jdriver(mesh4, window_ms=1000, vertex_bucket=64, edge_bucket=64)
    return W.key(d.run_arrays(s, t, ts)), d.state_dict()


def jax_growth(mesh4: bool, mode: str, form: str) -> list:
    s, t, ts = W.growth_stream()
    d = jdriver(mesh4, window_ms=1000, edge_bucket=128, vertex_bucket=16)
    extra = (ts,) if mode == "event" else ()
    if form == "batched":
        return W.key(d.run_arrays(s, t, *extra))
    out = []
    for i in range(0, len(s), 128):
        out += d.run_arrays(s[i:i + 128], t[i:i + 128],
                            *(x[i:i + 128] for x in extra))
    return W.key(out)


def jax_late_growth(mesh4: bool) -> list:
    (s1, d1), (s2, d2) = W.late_growth()
    d = jdriver(mesh4, window_ms=0, vertex_bucket=8, edge_bucket=16)
    return W.key(d.run_arrays(s1, d1)) + W.key(d.run_arrays(s2, d2))


def jax_deltas(mesh4: bool) -> list:
    s, t = W.fuzz_stream()
    d = jdriver(mesh4, window_ms=0, analytics=("degrees", "cc",
                                               "bipartite"),
                vertex_bucket=512, edge_bucket=512, emit_deltas=True)
    half = len(s) // 2
    return W.key(d.run_arrays(s[:half], t[:half])) \
        + W.key(d.run_arrays(s[half:], t[half:]))


def jax_ckpt_full() -> list:
    src, dst = W.ckpt_stream()
    return W.key(jdriver(False, window_ms=0, edge_bucket=W.CK_EB,
                         vertex_bucket=W.CK_VB).run_arrays(src, dst))


def jax_ckpt_heads() -> dict:
    """The JAX package's checkpoints after 4 windows: on make_mesh(4) and
    on one device."""
    src, dst = W.ckpt_stream()
    out = {}
    for name, mesh4 in zip(W.JAX_CKPTS, (True, False)):
        d = jdriver(mesh4, window_ms=0, edge_bucket=W.CK_EB,
                    vertex_bucket=W.CK_VB)
        d.run_arrays(src[:4 * W.CK_EB], dst[:4 * W.CK_EB])
        out[name] = d.state_dict()
    return out


def write_jax_ckpts(directory: str) -> None:
    heads = jax_once("ckpt_heads", jax_ckpt_heads)
    for name, state in heads.items():
        path = os.path.join(str(directory), name)
        jax_ck.save(path, state)
        open(path + ".ready", "w").close()


# ----------------------------------------------------------------------
# the groups
# ----------------------------------------------------------------------

_MADE_GROUP = []


def one_rank_mesh():
    if not dist.is_initialized():
        _MADE_GROUP.append(True)
    return mesh.make_mesh(device="cpu")


class _Groups:
    """The n>1 groups, started at once, the JAX checkpoints written for
    them as they start; each joined at its first read. n=1 runs the
    same scenarios in this process."""

    def __init__(self, tmp_factory):
        dirs = {n: tmp_factory.mktemp("drv_gloo%d" % n) for n in (3, 4)}
        self._groups = {n: base.Group(n, dirs[n], SCENARIOS,
                                      script=W.__file__)
                        for n in dirs}
        self._one_dir = tmp_factory.mktemp("drv_one")
        for d in list(dirs.values()) + [self._one_dir]:
            write_jax_ckpts(d)
        self._ranks = {}
        self._one = {}

    def ranks(self, n: int) -> list:
        if n not in self._ranks:
            self._ranks[n] = self._groups[n].join()
        return self._ranks[n]

    def get(self, n: int, name: str):
        if n == 1:
            if name not in self._one:
                W.SHARED = str(self._one_dir)
                self._one[name] = W.SCENARIOS[name](one_rank_mesh())
            return self._one[name]
        return self.ranks(n)[0][name]

    def close(self):
        for n in self._groups:
            if n not in self._ranks:
                try:
                    self.ranks(n)
                except AssertionError:
                    pass


@pytest.fixture(scope="module", autouse=True)
def groups(tmp_path_factory):
    g = _Groups(tmp_path_factory)
    yield g
    g.close()
    if _MADE_GROUP and dist.is_initialized():
        dist.destroy_process_group()
        _MADE_GROUP.clear()


# ----------------------------------------------------------------------
# every window of every fixture, against the JAX driver with and
# without make_mesh(4)
# ----------------------------------------------------------------------

def jax_stateful(name: str, mesh4: bool):
    """(keys, state) of the faults or the event fixture's JAX run."""
    return jax_once((name, "run", mesh4), lambda: (
        jax_faults if name == "faults" else jax_event)(mesh4))


FIXTURES = {
    "faults": lambda m: jax_stateful("faults", m)[0],
    "event": lambda m: jax_stateful("event", m)[0],
    ("growth", "count", "batched"): lambda m: jax_growth(m, "count",
                                                         "batched"),
    ("growth", "count", "single"): lambda m: jax_growth(m, "count",
                                                        "single"),
    ("growth", "event", "batched"): lambda m: jax_growth(m, "event",
                                                         "batched"),
    ("growth", "event", "single"): lambda m: jax_growth(m, "event",
                                                        "single"),
    "late_growth": jax_late_growth,
    "deltas": jax_deltas,
}


@pytest.mark.parametrize("fixture", list(FIXTURES), ids=str)
@pytest.mark.parametrize("n", SIZES)
def test_every_window_matches_jax(groups, n, fixture):
    got = groups.get(n, "parity")[fixture]
    for mesh4 in (False, True):
        # the JAX mesh driver's one-window calls equal its one call
        # (tests/test_driver.py:406); its per-window path compiles at
        # every bucket, so the mesh oracle of the "single" forms is the
        # one call's
        ref = (fixture[:2] + ("batched",)
               if mesh4 and fixture[-1] == "single" else fixture)
        want = jax_once((ref, mesh4), lambda: FIXTURES[ref](mesh4))
        assert len(got) == len(want)
        for w, (g, x) in enumerate(zip(got, want)):
            assert g == x, (fixture, mesh4, w)


@pytest.mark.parametrize("n", SIZES)
def test_fixtures_reach_growth_and_deltas(groups, n):
    got = groups.get(n, "parity")
    assert got["event_buckets"] == (512, 1024)
    assert got["late_growth_vb"] == 32
    deltas = got["deltas"]
    assert len(deltas) == 8 and all(r[7][0] is not None for r in deltas)
    # the growth fixture's calls of one window give the one-call windows
    for mode in ("count", "event"):
        assert got[("growth", mode, "single")] \
            == got[("growth", mode, "batched")]


@pytest.mark.parametrize("fixture", ["faults", "event"])
@pytest.mark.parametrize("n", SIZES)
def test_engine_key_equals_the_jax_mesh_checkpoint(groups, n, fixture):
    """The "engine" key built from the mirrors is bit-equal to the JAX
    mesh checkpoint's (sentinel slots included), and the mirrors to the
    JAX mirrors."""
    got = groups.get(n, "parity")[fixture + "_state"]
    want = jax_stateful(fixture, True)[1]
    assert got["sharded"] is True and got["mesh_shape"] == [n]
    assert set(got["engine"]) == set(want["engine"])
    assert got["engine"]["mesh_shape"] == [n]
    assert got["engine"]["vb"] == want["engine"]["vb"]
    for k in ("degree_state", "labels", "bip_labels"):
        if k in want["engine"]:
            np.testing.assert_array_equal(got["engine"][k],
                                          np.asarray(want["engine"][k]),
                                          err_msg=k)
    for k in ("degrees", "cc", "bip", "vertex_ids"):
        np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                      err_msg=k)
    for k in ("windows_done", "edges_done", "edge_bucket",
              "vertex_bucket", "wal_offset", "closed_partial"):
        assert got[k] == want[k], k


def test_jax_per_window_path_counts_padding_in_a_sentinel(groups):
    """ROADMAP §3: the JAX mesh driver's per-window path (one event window
    a call) pads each window to a multiple of the mesh and counts the
    padding in degree_state[vb+1]; the port, with no per-window path,
    leaves that slot 0, as the JAX batched path does. Every other slot
    is equal, no output reads it, and the JAX checkpoint resumes on the
    port's mesh to the same windows."""
    s, t, ts = W.event_stream()
    starts = ts - ts % 1000
    cut = int(np.searchsorted(starts, 2000))      # the first two windows

    def per_window():
        d = jdriver(True, window_ms=1000, vertex_bucket=64, edge_bucket=64)
        for lo, hi in ((0, int(np.searchsorted(starts, 1000))),
                       (int(np.searchsorted(starts, 1000)), cut)):
            d.run_arrays(s[lo:hi], t[lo:hi], ts[lo:hi])
        return d.state_dict()

    state = jax_once("per_window_state", per_window)
    vb = state["engine"]["vb"]
    mine = driver_mod.engine_state_from_mirrors(
        vb, state["degrees"], state["cc"], state["bip"], [4])
    deg = np.asarray(state["engine"]["degree_state"])
    assert deg[vb + 1] > 0 and mine["degree_state"][vb + 1] == 0
    np.testing.assert_array_equal(deg[:vb + 1], mine["degree_state"][:vb + 1])
    for k in ("labels", "bip_labels"):
        np.testing.assert_array_equal(state["engine"][k], mine[k])
    d = StreamingAnalyticsDriver(window_ms=1000, vertex_bucket=64,
                                 edge_bucket=64, mesh=one_rank_mesh())
    d.load_state_dict(state)
    assert W.key(d.run_arrays(s[cut:], t[cut:], ts[cut:])) \
        == jax_stateful("event", False)[0][2:]


# ----------------------------------------------------------------------
# checkpoints across the modes and the packages
# ----------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_checkpoints_across_modes(groups, n):
    full = jax_once("ckpt_full", jax_ckpt_full)
    got = groups.get(n, "ckpt")
    assert got["head"] == full[:4]
    assert got["tail_live"] == full[4:]
    for label in ("mesh", "scan", "host", "onto_mesh"):
        assert got[("tail", label)] == full[4:], label
    assert got["onto_mesh_vb"] == W.CK_VB


@pytest.mark.parametrize("n", SIZES)
def test_checkpoint_inside_a_call_resumes_both_ways(groups, n):
    full = jax_once("ckpt_full", jax_ckpt_full)
    got = groups.get(n, "ckpt")
    for label in ("mesh", "scan"):
        done, tail = got[("inside", label)]
        assert done == 4 and tail == full[4:], label


@pytest.mark.parametrize("n", SIZES)
def test_mesh_checkpoint_loads_in_the_jax_driver(groups, n, monkeypatch):
    """The port's mesh checkpoint resumed by the JAX driver on one device
    and on make_mesh(4)."""
    full = jax_once("ckpt_full", jax_ckpt_full)
    state = groups.get(n, "ckpt")["mesh_state"]
    src, dst = W.ckpt_stream()
    monkeypatch.setenv("GS_AUTOTUNE", "0")
    for mesh4 in (False, True):
        j = jdriver(mesh4, window_ms=0, edge_bucket=W.CK_EB,
                    vertex_bucket=W.CK_VB)
        j.load_state_dict(state)
        tail = W.key(j.run_arrays(src[j.edges_done:], dst[j.edges_done:]))
        assert tail == full[4:], mesh4


@pytest.mark.parametrize("n", SIZES)
def test_jax_checkpoints_resume_on_the_mesh(groups, n):
    full = jax_once("ckpt_full", jax_ckpt_full)
    got = groups.get(n, "xpkg")
    for name in W.JAX_CKPTS:
        assert got[name] == full[4:], name


@pytest.mark.parametrize("n", SIZES)
def test_only_rank_zero_writes(groups, n):
    full = jax_once("ckpt_full", jax_ckpt_full)
    ranks = [groups.get(1, "ckpt")] if n == 1 else [
        r["ckpt"] for r in groups.ranks(n)]
    assert [r["saves"] for r in ranks] == [1] + [0] * (n - 1)
    for rank, r in enumerate(ranks):
        j = r["journal"]
        assert j["enabled"] and j["journal_writer"] == (rank == 0)
        assert j["resumed_at"] == 5
        assert j["replayed"] == full[5:7] and j["tail"] == full[7:]


# ----------------------------------------------------------------------
# the mesh-fault drills, held to the port's ladder
# ----------------------------------------------------------------------

def fault_want() -> list:
    return jax_stateful("faults", False)[0]


def drill(groups, n, name):
    return groups.get(n, "faults")[name]


@pytest.mark.parametrize("n", SIZES)
def test_dead_shard_demotes_to_scan_with_parity(groups, n):
    got = drill(groups, n, "dead_shard")
    assert got["got"] == fault_want()
    assert not got["live"] and got["log"] == 1
    (ev,) = got["events"]
    assert (ev["from"], ev["to"]) == ("sharded", "scan")
    assert ev["mesh_shape"] == [n] and ev["shard_id"] == 3


@pytest.mark.parametrize("n", SIZES)
def test_mesh_demote_pin_raises_typed(groups, n):
    got = drill(groups, n, "pinned")
    assert got["raised"] == "StageFailed"
    assert got["live"] and got["events"] == []


@pytest.mark.parametrize("n", SIZES)
def test_transient_dispatch_retried_and_stall_waited_out(groups, n):
    got = drill(groups, n, "transient")
    assert got["got"] == fault_want()
    assert got["live"] and got["events"] == [] and got["fired"] == 1
    # no deadline thread on the mesh: the stall is waited out, not cut
    stall = drill(groups, n, "stall")
    assert stall["got"] == fault_want()
    assert stall["live"] and stall["events"] == []
    assert stall["seconds"] >= 1.5


@pytest.mark.parametrize("n", SIZES)
def test_corrupt_wire_retried_then_demotes(groups, n):
    """GS_MESH_WIRE_CHECK=1, on every rank: a transient corrupt slice is
    refused and retried clean; a persistent one exhausts the attempts
    and demotes; the windows are equal either way."""
    got = drill(groups, n, "wire_transient")
    assert got["got"] == fault_want()
    assert got["live"] and got["events"] == []
    got = drill(groups, n, "wire_persistent")
    assert got["got"] == fault_want()
    assert not got["live"]
    (ev,) = got["events"]
    assert (ev["from"], ev["to"]) == ("sharded", "scan")
    assert ("corrupt shard wire" in ev["reason"]
            or "_check_wire" in ev["reason"])


@pytest.mark.parametrize("n", SIZES)
def test_repromotion_after_probation(groups, n):
    got = drill(groups, n, "repromotion")
    assert got["got"] == fault_want()
    kinds = [(e["from"], e["to"]) for e in got["events"]]
    assert kinds == [("sharded", "scan"), ("scan", "sharded")]
    assert all(e["mesh_shape"] == [n] for e in got["events"])
    assert got["live"]


@pytest.mark.parametrize("n", SIZES)
def test_sharded_summary_drain_and_host_twin_handoff(groups, n):
    got = drill(groups, n, "summary_drain")
    whole = got["whole"]
    assert got["raised"] == "StageFailed"
    drained = got["drained"]
    assert drained and len(drained) == got["windows_done"] < len(whole)
    assert drained == whole[:len(drained)]
    assert drained + got["tail"] == whole
    assert got["twin"] == ("HostSummaryEngine" if got["eb"] == 128
                           else "ShardedSummaryEngine")
    if got["eb"] == 128:     # the JAX engine's windows
        assert whole == jax_scan.StreamSummaryEngine(
            edge_bucket=128, vertex_bucket=100).process(got["src"],
                                                        got["dst"])


@pytest.mark.parametrize("n", SIZES)
def test_sharded_triangle_kernel_drains_counts(groups, n):
    got = drill(groups, n, "triangle_drain")
    eb, src, dst = got["eb"], got["src"], got["dst"]
    exact = [int(jax_tri.triangle_count_sparse(
        src[w * eb:(w + 1) * eb], dst[w * eb:(w + 1) * eb], 64))
        for w in range(8)]
    assert got["want"] == exact and got["clean"] is None
    assert got["raised"] == "StageFailed"
    drained = got["drained"]
    assert drained is not None and 0 < len(drained) < 8
    assert drained == exact[:len(drained)]


@pytest.mark.parametrize("n", SIZES)
def test_dead_gather_demotes_off_the_mirrors(groups, n):
    want = fault_want()
    got = drill(groups, n, "dead_gather")
    assert got["head"] == want[:4] and got["rest"] == want[4:]
    assert got["head"] + got["tail"] == want
    assert not got["live"] and got["engine_vb"] == W.VB
    ev = got["events"][0]
    assert (ev["from"], ev["to"], ev["shard_id"]) == ("sharded", "scan", 1)


@pytest.mark.parametrize("n", SIZES)
def test_failed_repromotion_probe_restarts_probation(groups, n):
    got = drill(groups, n, "failed_probe")
    assert got["got"] == fault_want()
    kinds = [(e["from"], e["to"]) for e in got["events"]]
    assert kinds == [("sharded", "scan"), ("scan", "scan")]
    assert got["tier"] == "scan" and got["probes"] == 1


@pytest.mark.parametrize("n", SIZES)
def test_a_failure_on_scan_raises_typed_never_host(groups, n):
    got = drill(groups, n, "scan_floor")
    assert got["got"] == fault_want()[:4]
    assert got["first"] and not got["second"]
    assert got["kern"] == "TriangleWindowKernel" and got["single_kernel"]
    assert got["raised"] == "StageFailed" and got["tier"] == "scan"
    assert got["log"] == [("sharded", "scan")]


@pytest.mark.parametrize("n", SIZES)
def test_one_window_calls_event_time_demote_too(groups, n):
    rng = np.random.default_rng(8)
    nn = 6 * W.EB
    src = rng.integers(0, W.V, nn).astype(np.int64)
    dst = rng.integers(0, W.V, nn).astype(np.int64)
    ts = (np.arange(nn, dtype=np.int64) // W.EB) * 1000

    def one_by_one():
        d = jdriver(False, window_ms=1000, edge_bucket=W.EB,
                    vertex_bucket=W.VB, analytics=W.FAULT_ANALYTICS)
        out = []
        for w in range(6):
            lo = w * W.EB
            out += d.run_arrays(src[lo:lo + W.EB], dst[lo:lo + W.EB],
                                ts[lo:lo + W.EB])
        return W.key(out)

    got = drill(groups, n, "event_path")
    assert got["got"] == jax_once("event_path", one_by_one)
    assert not got["live"]
    assert got["events"][0]["from"] == "sharded"
    assert got["events"][0]["shard_id"] == 2


@pytest.mark.parametrize("n", SIZES)
def test_collective_and_kernel_errors_raise_unwrapped(groups, n):
    got = drill(groups, n, "device_errors")
    assert got["collective"] == ("CollectiveError", "RuntimeError")
    assert got["kernel"] == "KernelError"
    assert got["collective_events"] == [] and got["kernel_events"] == []
    assert got["live"]


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("n", [3, 4])
def test_every_rank_returns_the_same_answer(groups, n):
    ranks = groups.ranks(n)
    for name in SCENARIOS:
        for r in range(1, n):
            mine, first = dict(ranks[r][name]), dict(ranks[0][name])
            if name == "ckpt":
                for x in (mine, first):
                    x.pop("saves")
                    x["journal"] = dict(x["journal"], journal_writer=None)
            if name == "faults":
                for x in (mine, first):
                    x["stall"] = dict(x["stall"], seconds=None)
            assert _equal(mine, first), (name, r)


# ----------------------------------------------------------------------
# in this process: the refusals, the state conversions, the fault hooks
# ----------------------------------------------------------------------

def test_refusals_before_any_use_of_the_mesh(monkeypatch):
    """The JAX driver's refusals with mesh=object(), in its order."""
    with pytest.raises(ValueError, match="single-chip"):
        StreamingAnalyticsDriver(window_ms=0, mesh=object(), device="cpu",
                                 snapshot_tier="resident")
    with pytest.raises(ValueError, match="single-chip"):
        StreamingAnalyticsDriver(window_ms=1000, vertex_bucket=64,
                                 edge_bucket=128, slide=32, mesh=object())
    monkeypatch.setenv("GS_SLIDE", "32")
    with pytest.raises(ValueError, match="single-chip"):
        StreamingAnalyticsDriver(window_ms=0, edge_bucket=128,
                                 mesh=object())
    for kw in (dict(snapshot_tier="gpu"), dict(analytics=("pagerank",))):
        with pytest.raises(ValueError):
            StreamingAnalyticsDriver(window_ms=0, mesh=object(), **kw)


def test_mesh_driver_device_and_membership():
    m = one_rank_mesh()
    d = StreamingAnalyticsDriver(window_ms=0, mesh=m, egress="delta")
    assert d.device == m.device and d.snapshot_tier == "sharded"
    assert d.egress == "full" and d._mesh_shape() == [1]
    with pytest.raises(ValueError, match="disagrees"):
        StreamingAnalyticsDriver(window_ms=0, mesh=m, device="meta")
    outside = mesh.Mesh(m.group, np.array([5]), ("shard",), m.device,
                        "gloo")
    with pytest.raises(ValueError, match="not in the mesh"):
        StreamingAnalyticsDriver(window_ms=0, mesh=outside)
    if not torch.cuda.is_available():
        # a mesh on the card needs one: no quiet fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingAnalyticsDriver(window_ms=0, mesh=mesh.make_mesh())


def test_engine_state_from_mirrors_both_ways():
    """engine_state_from_mirrors and mirrors_from_engine_state invert
    each other, lay the cover out again at a wider bucket as the JAX
    driver does, and build what the JAX driver builds from the same
    mirrors."""
    rng = np.random.default_rng(4)
    deg = rng.integers(0, 9, 40).astype(np.int64)
    cc = np.minimum(np.arange(40), rng.integers(0, 40, 40)).astype(np.int32)
    bip = np.arange(2 * 64, dtype=np.int32)
    bip[:40] = np.minimum(bip[:40], rng.integers(0, 64, 40))
    for vb in (64, 256):
        st = driver_mod.engine_state_from_mirrors(vb, deg, cc, bip, [4])
        j = JaxDriver(window_ms=0, vertex_bucket=vb)
        j._degrees, j._cc, j._bip = deg.copy(), cc.copy(), bip.copy()
        want = j._engine_state_from_mirrors()
        want["mesh_shape"] = [4]
        assert set(st) == set(want) and st["vb"] == vb
        for k in ("degree_state", "labels", "bip_labels"):
            np.testing.assert_array_equal(st[k], want[k], err_msg=k)
        got = driver_mod.mirrors_from_engine_state(st, 40)
        np.testing.assert_array_equal(got[0], deg)
        np.testing.assert_array_equal(got[1], cc)
        np.testing.assert_array_equal(
            got[2], StreamingAnalyticsDriver._grow_cover(bip, vb))
        assert got[0].dtype == np.int64 and got[1].dtype == np.int32
    empty = driver_mod.engine_state_from_mirrors(
        8, np.zeros(0), np.zeros(0), np.zeros(0, np.int32))
    assert "bip_labels" not in empty
    assert driver_mod.mirrors_from_engine_state(empty, 0)[2] is None


def test_corrupt_shard_action_and_shard_metadata(monkeypatch):
    """The port's corrupt_shard fault poisons one shard's slice, which
    the wire check names; the fault's exception names its shard."""
    monkeypatch.setenv("GS_MESH_WIRE_CHECK", "1")
    good = np.full((2, 16), 7, np.int32)
    with faults.inject(faults.FaultSpec(site="shard_wire",
                                        action="corrupt_shard", shard=2)):
        with pytest.raises(RuntimeError, match="shard 2 of 4"):
            sharded.guard_wire((good, good), 4, 10)
    assert (good == 7).all()
    with faults.inject(faults.FaultSpec(site="shard_dispatch",
                                        shard=5)) as plan:
        with pytest.raises(faults.InjectedFault) as ei:
            faults.fire("shard_dispatch", 8)
    assert ei.value.shard == 5 and "shard 5" in str(ei.value)
    assert plan.fired == [("shard_dispatch", 1, "raise")]
    err = faults.InjectedFault("x", "shard_dispatch", shard=3)
    outer = RuntimeError("wrapped")
    outer.__cause__ = err
    assert driver_mod._shard_of(outer) == 3
    assert driver_mod._shard_of(RuntimeError("no shard")) is None


def test_collective_errors_are_device_errors():
    from gelly_streaming_tpu_torch.utils import resilience

    err = mesh.CollectiveError("all_reduce over the mesh failed")
    assert resilience.is_device_error(err)
    assert resilience.is_device_error(dist.DistError("gloo"))
    with pytest.raises(mesh.CollectiveError):
        resilience.call_guarded("dispatch", 0, lambda: (_ for _ in ()).throw(
            err), retries=2, timeout=0)
