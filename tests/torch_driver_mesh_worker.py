"""The rank side of the mesh driver's tests (tests/test_torch_driver_mesh.py):
StreamingAnalyticsDriver(mesh=) of gelly_streaming_tpu_torch on a gloo
group of `world` ranks on the CPU, one process a rank, started through
tests/torch_mesh_worker.Group with this file as the rank program. Each
scenario returns numpy results the tests hold against the JAX package.
Imports nothing of JAX.

    python tests/torch_driver_mesh_worker.py RANK WORLD STORE SCENARIOS OUT

The fixtures (seeded numpy) live here so that both sides build the same
inputs. Files the ranks share (checkpoints, journals, the JAX package's
checkpoints the test writes) go in SHARED, the group's directory.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests import torch_mesh_worker as base  # noqa: E402

SHARED = None              # the directory every rank of a group shares
EB, VB, V = 256, 512, 300  # the fault drills' fixture (mesh_faults)
CK_EB, CK_VB = 512, 1024   # the checkpoint fixture's buckets
FAULT_ANALYTICS = ("degrees", "cc", "triangles")
KNOBS = ("GS_STAGE_TIMEOUT_S", "GS_STAGE_RETRIES", "GS_STAGE_BACKOFF_S",
         "GS_TIER_RETRY_WINDOWS", "GS_TIER_DEMOTE", "GS_MESH_DEMOTE",
         "GS_MESH_WIRE_CHECK", "GS_AUTOTUNE")
JAX_CKPTS = ("jax_mesh.npz", "jax_single.npz")


# ----------------------------------------------------------------------
# fixtures and keys, shared with the tests
# ----------------------------------------------------------------------

def key(results) -> list:
    """Every WindowResult field, as lists (the deltas included)."""
    def arr(a):
        return None if a is None else np.asarray(a).tolist()

    return [(r.window_start, r.num_edges, arr(r.vertex_ids), arr(r.degrees),
             arr(r.cc_labels), arr(r.bipartite_odd), r.triangles,
             tuple(None if x is None else (arr(x[0]), arr(x[1]))
                   for x in (r.delta_degrees, r.delta_cc,
                             r.delta_bipartite)))
            for r in results]


def fault_stream(num_w: int = 8, seed: int = 5):
    """tests/operations/test_mesh_faults.py's stream."""
    rng = np.random.default_rng(seed)
    n = num_w * EB
    return (rng.integers(0, V, n).astype(np.int64),
            rng.integers(0, V, n).astype(np.int64))


def event_stream(seed: int = 0, n: int = 3000, v: int = 500):
    """tests/test_driver.py:13's timestamped stream (window_ms=1000,
    buckets 64 growing en route)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, n)
    dst = rng.integers(0, v, n)
    ts = np.sort(rng.integers(0, 5000, n))
    return src, dst, ts


def growth_stream():
    """tests/test_driver.py:413-421: a vertex domain that grows inside a
    call, eb=128 windows, count-based or one window a second."""
    rng = np.random.default_rng(17)
    n = 1024
    src = np.concatenate([rng.integers(0, 40, n // 2),
                          rng.integers(0, 900, n // 2)])
    dst = np.concatenate([rng.integers(0, 40, n // 2),
                          rng.integers(0, 900, n // 2)])
    return src, dst, (np.arange(n) // 128) * 1000


def late_growth():
    """tests/test_driver.py:299-306: a window over 8 vertices, then one
    that grows the bucket after the mesh carry exists."""
    s1 = np.tile(np.arange(4), 4)
    return (s1, s1 + 4), (np.arange(16), np.arange(16) + 16)


def fuzz_stream(num_edges: int = 4096, num_vertices: int = 500,
                seed: int = 23):
    """tests/test_deltas.py:17's skewed stream."""
    rng = np.random.default_rng(seed)
    src = rng.zipf(1.7, num_edges) % num_vertices
    dst = (src + 1 + rng.zipf(1.7, num_edges) % (num_vertices - 1)) \
        % num_vertices
    return src.astype(np.int64), dst.astype(np.int64)


def ckpt_stream(n: int = 8 * CK_EB, v: int = 700, seed: int = 9):
    """tests/test_checkpoint_roundtrip.py:28's stream."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, size=n).astype(np.int64),
            rng.integers(0, v, size=n).astype(np.int64))


# ----------------------------------------------------------------------
# helpers of the rank side
# ----------------------------------------------------------------------

def driver(mesh=None, **kw):
    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver

    if mesh is None:
        kw["device"] = "cpu"
    return StreamingAnalyticsDriver(mesh=mesh, **kw)


def fault_driver(mesh=None, **kw):
    return driver(mesh, window_ms=0, edge_bucket=EB, vertex_bucket=VB,
                  analytics=FAULT_ANALYTICS, **kw)


def ckpt_driver(mesh=None, **kw):
    return driver(mesh, window_ms=0, edge_bucket=CK_EB,
                  vertex_bucket=CK_VB, **kw)


@contextlib.contextmanager
def knobs(**kw):
    """The drills' knobs, from inert ones; the demotion registry and the
    prep pool cleared after."""
    from gelly_streaming_tpu_torch.ops import ingress_pipeline as ip
    from gelly_streaming_tpu_torch.utils import resilience

    saved = {k: os.environ.pop(k, None) for k in KNOBS}
    os.environ.update({"GS_STAGE_BACKOFF_S": "0.01", "GS_AUTOTUNE": "0"})
    os.environ.update({k: str(v) for k, v in kw.items()})
    resilience.reset_demotions()
    try:
        yield
    finally:
        for k in KNOBS:
            os.environ.pop(k, None)
            if saved[k] is not None:
                os.environ[k] = saved[k]
        resilience.reset_demotions()
        ip.reset_pool()


ARMED = {"GS_STAGE_TIMEOUT_S": "5", "GS_STAGE_RETRIES": "2"}


def events() -> list:
    from gelly_streaming_tpu_torch.utils import resilience

    return [{k: e[k] for k in ("from", "to", "mesh_shape", "shard_id",
                               "reason")}
            for e in resilience.demotion_events()]


def wait_for(path: str, seconds: float = 120.0) -> None:
    end = time.monotonic() + seconds
    while not os.path.exists(path):
        if time.monotonic() > end:
            raise TimeoutError("no file %s" % path)
        time.sleep(0.05)


# ----------------------------------------------------------------------
# the scenarios (rank side)
# ----------------------------------------------------------------------

def scenario_parity(mesh) -> dict:
    """Every fixture through a mesh driver: the fault drills' stream in
    two calls, the event-time stream with its buckets growing, the
    mid-call growth both ways (one call; one window a call), growth after
    the carry exists, deltas in two calls."""
    out = {}
    with knobs():
        src, dst = fault_stream()
        d = fault_driver(mesh)
        out["faults"] = key(d.run_arrays(src[:4 * EB], dst[:4 * EB])) \
            + key(d.run_arrays(src[4 * EB:], dst[4 * EB:]))
        out["faults_state"] = d.state_dict()

        s, t, ts = event_stream()
        d = driver(mesh, window_ms=1000, vertex_bucket=64, edge_bucket=64)
        out["event"] = key(d.run_arrays(s, t, ts))
        out["event_buckets"] = (d.vb, d.eb)
        out["event_state"] = d.state_dict()

        s, t, ts = growth_stream()
        for mode in ("count", "event"):
            a = driver(mesh, window_ms=1000, edge_bucket=128,
                       vertex_bucket=16)
            b = driver(mesh, window_ms=1000, edge_bucket=128,
                       vertex_bucket=16)
            extra = (ts,) if mode == "event" else ()
            out[("growth", mode, "batched")] = key(a.run_arrays(
                s, t, *extra))
            single = []
            for i in range(0, len(s), 128):
                single += b.run_arrays(s[i:i + 128], t[i:i + 128],
                                       *(x[i:i + 128] for x in extra))
            out[("growth", mode, "single")] = key(single)

        (s1, d1), (s2, d2) = late_growth()
        d = driver(mesh, window_ms=0, vertex_bucket=8, edge_bucket=16)
        out["late_growth"] = key(d.run_arrays(s1, d1)) \
            + key(d.run_arrays(s2, d2))
        out["late_growth_vb"] = d.vb

        s, t = fuzz_stream()
        d = driver(mesh, window_ms=0, analytics=("degrees", "cc",
                                                 "bipartite"),
                   vertex_bucket=512, edge_bucket=512, emit_deltas=True)
        half = len(s) // 2
        out["deltas"] = key(d.run_arrays(s[:half], t[:half])) \
            + key(d.run_arrays(s[half:], t[half:]))
    return out


def scenario_ckpt(mesh) -> dict:
    """Checkpoints both ways: a mesh checkpoint after 4 windows resumed on
    a fresh mesh driver and on one card (scan, host); one card's
    checkpoint resumed onto the mesh; a checkpoint taken inside a call
    (two-window chunks) resumed both ways; only rank 0 writes the
    auto-checkpoints and the journal, every rank resumes and replays
    from them."""
    from gelly_streaming_tpu_torch.utils import checkpoint

    out = {}
    src, dst = ckpt_stream()
    half = 4 * CK_EB
    with knobs():
        a = ckpt_driver(mesh)
        out["head"] = key(a.run_arrays(src[:half], dst[:half]))
        state = a.state_dict()
        out["mesh_state"] = state
        out["tail_live"] = key(a.run_arrays(src[half:], dst[half:]))
        for label, make in (("mesh", lambda: ckpt_driver(mesh)),
                            ("scan", lambda: ckpt_driver()),
                            ("host", lambda: ckpt_driver(
                                snapshot_tier="host"))):
            b = make()
            b.load_state_dict(state)
            out[("tail", label)] = key(b.run_arrays(src[b.edges_done:],
                                                    dst[b.edges_done:]))
        c = ckpt_driver()
        c.run_arrays(src[:half], dst[:half])
        single = c.state_dict()
        d = ckpt_driver(mesh)
        d.load_state_dict(single)
        out[("tail", "onto_mesh")] = key(d.run_arrays(src[half:],
                                                      dst[half:]))
        out["onto_mesh_vb"] = d.vb

        # a checkpoint inside a call: two-window chunks, one at window 4
        path = os.path.join(SHARED, "inside.npz")
        saves = []
        save = checkpoint.save
        checkpoint.save = lambda p, st: (saves.append(p), save(p, st))[1]
        try:
            e = ckpt_driver(mesh)
            e._SCAN_CHUNK = 2
            e.enable_auto_checkpoint(path, every_n_windows=4)
            e.run_arrays(src[:6 * CK_EB], dst[:6 * CK_EB])
        finally:
            checkpoint.save = save
        out["saves"] = len(saves)
        mesh_barrier(mesh)
        for label, make in (("mesh", lambda: ckpt_driver(mesh)),
                            ("scan", lambda: ckpt_driver())):
            f = make()
            assert f.try_resume(path)
            out[("inside", label)] = (f.windows_done, key(f.run_arrays(
                src[f.edges_done:], dst[f.edges_done:])))
        out["journal"] = journal_drill(mesh, src, dst)
    return out


def mesh_barrier(mesh) -> None:
    """Wait for every rank (a SUM of one slot): rank 0's file is written
    before any rank reads it."""
    import torch

    mesh.all_reduce(torch.zeros(1, dtype=torch.int32, device=mesh.device))


def journal_drill(mesh, src, dst) -> dict:
    """enable_wal + auto-checkpoints on one shared path and directory: rank
    0 alone writes; after a 'crash' past the checkpoint at window 5 every
    rank resumes and replays the journal to the same windows."""
    ckpt = os.path.join(SHARED, "wal.npz")
    wal_dir = os.path.join(SHARED, "wal")
    d = ckpt_driver(mesh)
    wrote = d.enable_wal(wal_dir)
    d.enable_auto_checkpoint(ckpt, every_n_windows=4)
    for lo, hi in ((0, 3), (3, 5), (5, 7)):
        d.run_arrays(src[lo * CK_EB:hi * CK_EB], dst[lo * CK_EB:hi * CK_EB])
    mine = d._wal is not None
    d.seal_wal()
    mesh_barrier(mesh)
    r = ckpt_driver(mesh)
    r.enable_wal(wal_dir)
    replayed = key(r.resume_and_replay(ckpt))
    return {"enabled": wrote, "journal_writer": mine,
            "resumed_at": r.windows_done - len(replayed),
            "replayed": replayed,
            "tail": key(r.run_arrays(src[7 * CK_EB:], dst[7 * CK_EB:]))}


def scenario_xpkg(mesh) -> dict:
    """The JAX package's checkpoints (a mesh one and a single-chip one,
    after 4 windows of the checkpoint fixture, written by the test into
    SHARED) resumed on this mesh."""
    from gelly_streaming_tpu_torch.utils import checkpoint

    src, dst = ckpt_stream()
    out = {}
    with knobs():
        for name in JAX_CKPTS:
            path = os.path.join(SHARED, name)
            wait_for(path + ".ready")
            d = ckpt_driver(mesh)
            d.load_state_dict(checkpoint.restore(path))
            out[name] = key(d.run_arrays(src[d.edges_done:],
                                         dst[d.edges_done:]))
    return out


def scenario_faults(mesh) -> dict:
    """The port's twins of tests/operations/test_mesh_faults.py, each held
    to the port's ladder (sharded -> scan, on the card)."""
    from gelly_streaming_tpu_torch import TriangleWindowKernel
    from gelly_streaming_tpu_torch.utils import faults, resilience

    src, dst = fault_stream()
    out = {}
    spec = faults.FaultSpec

    def two_calls(d):
        return key(d.run_arrays(src[:4 * EB], dst[:4 * EB])) \
            + key(d.run_arrays(src[4 * EB:], dst[4 * EB:]))

    # a dead shard demotes mid-stream, with the shape and the shard
    with knobs(**ARMED):
        d = fault_driver(mesh)
        with faults.inject(spec(site="shard_dispatch", on_call=2,
                                times=1 << 20, shard=3)):
            got = two_calls(d)
        out["dead_shard"] = {"got": got, "live": d._mesh_live(),
                             "events": events(), "log": len(
                                 d.demotion_log())}
    # GS_MESH_DEMOTE=0 pins the mesh rung
    with knobs(GS_MESH_DEMOTE="0", **ARMED):
        d = fault_driver(mesh)
        try:
            with faults.inject(spec(site="shard_dispatch", on_call=1,
                                    times=1 << 20)):
                d.run_arrays(src[:4 * EB], dst[:4 * EB])
            raised = None
        except resilience.StageError as e:
            raised = type(e).__name__
        out["pinned"] = {"raised": raised, "live": d._mesh_live(),
                         "events": events()}
    # a transient dispatch fault is retried; a stall has no deadline
    # thread on the mesh: it is waited out
    with knobs(**ARMED):
        d = fault_driver(mesh)
        with faults.inject(spec(site="shard_dispatch", on_call=1,
                                times=1)) as plan:
            got = two_calls(d)
        out["transient"] = {"got": got, "live": d._mesh_live(),
                            "events": events(), "fired": len(plan.fired)}
    with knobs(GS_STAGE_TIMEOUT_S="1", GS_STAGE_RETRIES="2"):
        d = fault_driver(mesh)
        t0 = time.perf_counter()
        with faults.inject(spec(site="shard_dispatch", on_call=1,
                                action="hang", seconds=1.5)):
            got = two_calls(d)
        out["stall"] = {"got": got, "live": d._mesh_live(),
                        "events": events(),
                        "seconds": time.perf_counter() - t0}
    # the wire check: transient corruption retried, persistent demotes
    for label, times in (("wire_transient", 1), ("wire_persistent",
                                                 1 << 20)):
        with knobs(GS_MESH_WIRE_CHECK="1", **ARMED):
            d = fault_driver(mesh)
            with faults.inject(spec(site="shard_wire", on_call=2,
                                    times=times, action="corrupt_shard",
                                    shard=mesh.size - 1)):
                got = key(d.run_arrays(src, dst))
            out[label] = {"got": got, "live": d._mesh_live(),
                          "events": events()}
    # re-promotion after probation (three firings: the armed guard's
    # three attempts)
    with knobs(GS_TIER_RETRY_WINDOWS="2", **ARMED):
        d = fault_driver(mesh)
        with faults.inject(spec(site="shard_dispatch", on_call=2, times=3,
                                shard=0)):
            got = key(d.run_arrays(src[:4 * EB], dst[:4 * EB]))
        got += key(d.run_arrays(src[4 * EB:6 * EB], dst[4 * EB:6 * EB]))
        got += key(d.run_arrays(src[6 * EB:], dst[6 * EB:]))
        out["repromotion"] = {"got": got, "live": d._mesh_live(),
                              "events": events()}
    out["summary_drain"] = summary_drain(mesh)
    out["triangle_drain"] = triangle_drain(mesh)
    # a dead gather (the flush's, before its dispatches die too): the
    # hand-off and a checkpoint off the mirrors
    with knobs(**ARMED):
        d = fault_driver(mesh)
        with faults.inject(spec(site="shard_dispatch", on_call=3,
                                times=1 << 20, shard=1),
                           spec(site="shard_gather", on_call=2,
                                times=1 << 20, shard=1)):
            head = key(d.run_arrays(src[:4 * EB], dst[:4 * EB]))
            live = d._mesh_live()
            state = d.state_dict()
        rest = key(d.run_arrays(src[4 * EB:], dst[4 * EB:]))
        r = fault_driver()
        r.load_state_dict(state)
        tail = key(r.run_arrays(src[r.edges_done:], dst[r.edges_done:]))
        out["dead_gather"] = {"head": head, "rest": rest, "tail": tail,
                              "live": live, "events": events(),
                              "engine_vb": state["engine"]["vb"]}
    # a probe that finds the mesh still dead restarts probation
    with knobs(GS_TIER_RETRY_WINDOWS="2", **ARMED):
        from gelly_streaming_tpu_torch.core import driver as driver_mod

        cls = driver_mod.StreamingAnalyticsDriver
        orig = cls._sync_engine_from_mirrors
        calls = {"n": 0}

        def dying_sync(self):
            calls["n"] += 1
            if calls["n"] <= 2:
                raise RuntimeError("mesh still dead")
            return orig(self)

        cls._sync_engine_from_mirrors = dying_sync
        try:
            d = fault_driver(mesh)
            with faults.inject(spec(site="shard_dispatch", on_call=2,
                                    times=3)):
                got = key(d.run_arrays(src[:4 * EB], dst[:4 * EB]))
            for lo in range(4, 8, 2):
                got += key(d.run_arrays(src[lo * EB:(lo + 2) * EB],
                                        dst[lo * EB:(lo + 2) * EB]))
        finally:
            cls._sync_engine_from_mirrors = orig
        out["failed_probe"] = {"got": got, "tier": d._demoted_tier,
                               "events": events(), "probes": calls["n"]}
    # a failure on scan raises typed: the port never demotes below scan
    with knobs(**ARMED):
        d = fault_driver(mesh)
        got = key(d.run_arrays(src[:2 * EB], dst[:2 * EB]))
        err = resilience.StageFailed("x", "dispatch", 0)
        err.__cause__ = RuntimeError("dead device")
        first = d._maybe_demote("sharded", err)
        second = d._maybe_demote("scan", err)
        kern = type(d._tri_kern()).__name__
        got += key(d.run_arrays(src[2 * EB:4 * EB], dst[2 * EB:4 * EB]))
        try:
            with faults.inject(spec(site="dispatch", times=1 << 20)):
                d.run_arrays(src[4 * EB:], dst[4 * EB:])
            raised = None
        except resilience.StageError as e:
            raised = type(e).__name__
        out["scan_floor"] = {"got": got, "first": first, "second": second,
                             "kern": kern, "raised": raised,
                             "tier": d._demoted_tier,
                             "single_kernel": isinstance(
                                 d._tri_kern(), TriangleWindowKernel),
                             "log": [(e["from"], e["to"])
                                     for e in d.demotion_log()]}
    # the one-window-a-call event-time path demotes too
    with knobs(**ARMED):
        rng = np.random.default_rng(8)
        n = 6 * EB
        es = rng.integers(0, V, n).astype(np.int64)
        ed = rng.integers(0, V, n).astype(np.int64)
        ts = (np.arange(n, dtype=np.int64) // EB) * 1000
        d = driver(mesh, window_ms=1000, edge_bucket=EB, vertex_bucket=VB,
                   analytics=FAULT_ANALYTICS)
        got = []
        with faults.inject(spec(site="shard_dispatch", on_call=4,
                                times=1 << 20, shard=2)):
            for w in range(6):
                lo = w * EB
                got += d.run_arrays(es[lo:lo + EB], ed[lo:lo + EB],
                                    ts[lo:lo + EB])
        out["event_path"] = {"got": key(got), "live": d._mesh_live(),
                             "events": events()}
    out["device_errors"] = device_errors(mesh)
    return out


def summary_drain(mesh) -> dict:
    """ShardedSummaryEngine: an error escaping process() leaves the
    finalized summaries on drained_partial, the cursor just past them,
    and a host twin continues to the uninterrupted run's summaries. The
    engine's edge bucket is 128 rounded up to a multiple of the mesh
    (129 at n=3, where a fresh engine on the mesh takes the state: the
    numpy twin's buckets are powers of two); the stream is 8 of its
    windows."""
    from gelly_streaming_tpu_torch.parallel.host_twin import \
        HostSummaryEngine
    from gelly_streaming_tpu_torch.parallel.sharded import \
        ShardedSummaryEngine
    from gelly_streaming_tpu_torch.utils import faults, resilience

    eb, v = 128, 100
    with knobs(GS_STAGE_TIMEOUT_S="5", GS_STAGE_RETRIES="0"):
        eng = ShardedSummaryEngine(mesh, edge_bucket=eb, vertex_bucket=v)
        rng = np.random.default_rng(9)
        src = rng.integers(0, v, 8 * eng.eb).astype(np.int32)
        dst = rng.integers(0, v, 8 * eng.eb).astype(np.int32)
        whole = eng.process(src, dst)
        eng.reset()
        eng.MAX_WINDOWS = 2
        raised = None
        try:
            with faults.inject(faults.FaultSpec(site="shard_dispatch",
                                                on_call=2, times=1 << 20)):
                eng.process(src, dst)
        except resilience.StageError as e:
            raised = type(e).__name__
        drained = eng.drained_partial
        if eng.eb == eb:
            twin = HostSummaryEngine.from_sharded(eng)
        else:
            twin = ShardedSummaryEngine(mesh, edge_bucket=eb,
                                        vertex_bucket=v)
            twin.load_state_dict(eng.state_dict())
        off = twin.resume_offset()
        tail = twin.process(src[off:], dst[off:])
    return {"raised": raised, "drained": drained, "whole": whole,
            "windows_done": eng.windows_done, "tail": tail,
            "eb": eng.eb, "twin": type(twin).__name__,
            "src": src, "dst": dst}


def triangle_drain(mesh) -> dict:
    """ShardedTriangleWindowKernel: an error escaping count_stream leaves
    the finalized counts on drained_counts (8 windows of the kernel's
    edge bucket, 128 rounded up to a multiple of the mesh)."""
    from gelly_streaming_tpu_torch.parallel.sharded import \
        ShardedTriangleWindowKernel
    from gelly_streaming_tpu_torch.utils import faults, resilience

    with knobs(GS_STAGE_TIMEOUT_S="5", GS_STAGE_RETRIES="0"):
        kern = ShardedTriangleWindowKernel(mesh, edge_bucket=128,
                                           vertex_bucket=64)
        kern.MAX_STREAM_WINDOWS = 2
        rng = np.random.default_rng(3)
        src = rng.integers(0, 60, 8 * kern.eb).astype(np.int32)
        dst = rng.integers(0, 60, 8 * kern.eb).astype(np.int32)
        want = kern.count_stream(src, dst)
        clean = kern.drained_counts
        raised = None
        try:
            with faults.inject(faults.FaultSpec(site="shard_dispatch",
                                                on_call=2, times=1 << 20)):
                kern.count_stream(src, dst)
        except resilience.StageError as e:
            raised = type(e).__name__
    return {"want": want, "clean": clean, "raised": raised,
            "drained": kern.drained_counts, "eb": kern.eb,
            "src": src, "dst": dst}


def device_errors(mesh) -> dict:
    """A failed collective and a kernel error raise as they were raised,
    with the guard armed: never retried, wrapped or demoted on."""
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.ops import unionfind
    from gelly_streaming_tpu_torch.parallel import mesh as mesh_mod
    from gelly_streaming_tpu_torch.utils import faults

    src, dst = fault_stream(num_w=2)
    out = {}
    dist = mesh_mod.dist
    real = dist.all_reduce

    def broken(*a, **kw):
        raise RuntimeError("peer closed the connection")

    with knobs(**ARMED):
        d = fault_driver(mesh)
        dist.all_reduce = broken
        try:
            with faults.inject():
                d.run_arrays(src, dst)
            out["collective"] = None
        except Exception as e:
            out["collective"] = (type(e).__name__,
                                 type(e.__cause__).__name__)
        finally:
            dist.all_reduce = real
        out["collective_events"] = events()
        fix = unionfind.cc_fixpoint

        def kernel_error(*a, **kw):
            raise kernels.KernelError("window_summary: launch failed")

        unionfind.cc_fixpoint = kernel_error
        try:
            d.run_arrays(src, dst)
            out["kernel"] = None
        except Exception as e:
            out["kernel"] = type(e).__name__
        finally:
            unionfind.cc_fixpoint = fix
        out["kernel_events"] = events()
        out["live"] = d._mesh_live()
    return out


SCENARIOS = {"parity": scenario_parity, "ckpt": scenario_ckpt,
             "faults": scenario_faults, "xpkg": scenario_xpkg}


if __name__ == "__main__":
    import traceback

    try:
        SHARED = os.path.dirname(sys.argv[5])
        base.rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                       sys.argv[4], sys.argv[5], scenarios=SCENARIOS)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
