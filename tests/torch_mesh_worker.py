"""The rank side of the sharded engines' tests: a gloo group of `world`
ranks on the CPU, spawned by the tests themselves, each rank one process
running a batch of scenarios through gelly_streaming_tpu_torch/parallel
and handing its numpy results back to the test in a pickle. Imports
nothing of JAX: the tests hold these results against the JAX package.

    python tests/torch_mesh_worker.py RANK WORLD STORE SCENARIOS OUT

The fixtures (seeded numpy) live here so that both sides build the same
inputs.
"""

from __future__ import annotations

import datetime
import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EB, VB = 384, 128          # the window counter's fixtures (3 and 4 divide)
SUM_EB, SUM_VB = 256, 200  # the summary engines'
ENG_VB = 64                # the window engine's
TABLES = ("replicated", "owner")
PANE = dict(vb=40, pb=12, wp=4, e=509)   # the sliding reduce's


# ----------------------------------------------------------------------
# fixtures, shared with the tests
# ----------------------------------------------------------------------

def clique(m: int, base: int = 1):
    u, v = np.triu_indices(m, k=1)
    return (u + base).astype(np.int32), (v + base).astype(np.int32)


def window_fixtures() -> list:
    """[(src, dst, valid)] host windows of EB slots: random ones with
    duplicates, self-loops and ragged padding, a clique past any small K,
    a star, and an empty one."""
    out = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        e = int(rng.integers(20, EB))
        s = np.full(EB, VB, np.int32)
        d = s.copy()
        s[:e] = rng.integers(0, 100, e)
        d[:e] = rng.integers(0, 100, e)
        out.append((s, d, np.arange(EB) < e))
    cs, cd = clique(27, 3)             # 351 edges
    s = np.full(EB, VB, np.int32)
    d = s.copy()
    s[:len(cs)], d[:len(cd)] = cs, cd
    out.append((s, d, np.arange(EB) < len(cs)))
    hub = np.zeros(EB, np.int32) + 7
    leaves = np.arange(EB, dtype=np.int32) % 120 + 8
    out.append((np.where(np.arange(EB) % 2 == 0, hub, leaves),
                np.where(np.arange(EB) % 2 == 0, leaves, np.roll(leaves, 1)),
                np.ones(EB, bool)))
    out.append((np.full(EB, VB, np.int32), np.full(EB, VB, np.int32),
                np.zeros(EB, bool)))
    return out


def raw_configs(n: int) -> list:
    """(kb, cap) pairs of the raw-triple checks at n ranks: small ones that
    overflow both ways, and roomy ones."""
    return [(2 * n, 4), (16 * n, EB // n)]


def stream_fixture():
    """A stream of windows of 512 edges: random, a 40-clique that
    overflows K=8, random, and a ragged tail."""
    rng = np.random.default_rng(21)
    cs, cd = clique(40, 1)
    parts = [(rng.integers(0, 100, 512), rng.integers(0, 100, 512)),
             (cs[:512], cd[:512]),
             (rng.integers(0, 100, 512), rng.integers(0, 100, 512)),
             (rng.integers(0, 100, 137), rng.integers(0, 100, 137))]
    return (np.concatenate([p[0] for p in parts]).astype(np.int32),
            np.concatenate([p[1] for p in parts]).astype(np.int32))


def summary_fixture():
    """2048 edges over 200 vertices, a 30-clique in window 3 (K=8
    overflows), plus a ragged tail of 77."""
    rng = np.random.default_rng(23)
    n = 2048 + 77
    src = rng.integers(0, SUM_VB, n).astype(np.int32)
    dst = rng.integers(0, SUM_VB, n).astype(np.int32)
    cs, cd = clique(30, 1)
    src[3 * SUM_EB:3 * SUM_EB + SUM_EB] = cs[:SUM_EB]
    dst[3 * SUM_EB:3 * SUM_EB + SUM_EB] = cd[:SUM_EB]
    return src, dst


def engine_batches():
    """Window batches of the window engine: two random ones, then a
    bridge, at ids below ENG_VB."""
    rng = np.random.default_rng(3)
    a = (rng.integers(0, 50, 333), rng.integers(0, 50, 333))
    b = (np.array([0, 1, 2, 10, 20, 21, 22]),
         np.array([1, 2, 3, 11, 21, 22, 20]))
    c = (np.array([3, 0]), np.array([10, 2]))
    return a, b, c


def oriented_table(src, dst, n: int):
    """The oriented CSR of a window (the JAX test's construction): (nbr
    [vb+1, K], a, b)."""
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    keep = lo != hi
    und = np.unique(lo[keep] * n + hi[keep])
    lo, hi = und // n, und % n
    deg = np.bincount(np.concatenate([lo, hi]), minlength=n)
    rank = np.argsort(np.argsort(deg.astype(np.int64) * n + np.arange(n)))
    a = np.where(rank[lo] < rank[hi], lo, hi).astype(np.int32)
    b = np.where(rank[lo] < rank[hi], hi, lo).astype(np.int32)
    order = np.argsort(a.astype(np.int64) * n + b, kind="stable")
    a, b = a[order], b[order]
    counts = np.bincount(a, minlength=n)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    vb = 8
    while vb < n:
        vb *= 2
    k = 8
    while k < counts.max():
        k *= 2
    nbr = np.full((vb + 1, k), vb, np.int32)
    nbr[a, np.arange(len(a)) - starts[a]] = b
    return nbr, a, b


def pane_fixture(dtype):
    """(src, pane, val) of the sliding reduce: PANE["e"] edges."""
    rng = np.random.default_rng(13)
    e = PANE["e"]
    return (rng.integers(0, PANE["vb"], e).astype(np.int32),
            rng.integers(0, PANE["pb"], e).astype(np.int32),
            rng.integers(-50, 100, e).astype(dtype))


# ----------------------------------------------------------------------
# the scenarios (rank side)
# ----------------------------------------------------------------------

def scenario_raw(mesh) -> dict:
    """The raw (count, bucket_overflow, k_overflow) of every fixture
    window, both table modes, at each (kb, cap) of raw_configs."""
    from gelly_streaming_tpu_torch.parallel import sharded

    out = {}
    for table in TABLES:
        for kb, cap in raw_configs(mesh.size):
            fn = sharded.make_sharded_window_triangle_fn(
                mesh, EB, VB, kb, cap, table=table)
            out[(table, kb, cap)] = np.array(
                [fn(s, d, v).tolist() for s, d, v in window_fixtures()])
    return out


def scenario_count(mesh) -> dict:
    """count() of every fixture window at k_bucket=8 (the ladder),
    count_stream and count_windows, both table modes."""
    from gelly_streaming_tpu_torch.parallel import sharded

    out = {}
    src, dst = stream_fixture()
    for table in TABLES:
        k = sharded.ShardedTriangleWindowKernel(mesh, 512, VB, k_bucket=8,
                                                table=table)
        out[(table, "count")] = [k.count(s[v], d[v])
                                 for s, d, v in window_fixtures()]
        out[(table, "stream")] = k.count_stream(src, dst)
        out[(table, "windows")] = k.count_windows(
            [(s[v], d[v]) for s, d, v in window_fixtures()])
        out[(table, "buckets")] = (k.eb, k.vb, k.kb, k.kb_max, k.cap)
    return out


def scenario_engine(mesh) -> dict:
    """The window engine: degrees twice, CC fresh then carried,
    bipartite fresh then carried, a triangle table, its state; then the
    sliding reduce for sum/min/max over int32 and float32 and the
    associative fns gcd and minimum."""
    import torch

    from gelly_streaming_tpu_torch.parallel import sharded

    eng = sharded.ShardedWindowEngine(mesh, num_vertices_bucket=ENG_VB)
    a, b, c = engine_batches()
    out = {"deg1": eng.degrees(*a), "deg2": eng.degrees(*b),
           "cc1": eng.cc_labels(*a, carry=False),
           "cc2": eng.cc_labels(*b), "cc3": eng.cc_labels(*c),
           "bip1": eng.bipartite(*b, carry=False),
           "bip2": eng.bipartite(*c)}
    nbr, ta, tb = oriented_table(*a, 50)
    out["tri"] = eng.triangles(nbr, ta, tb, np.ones(len(ta), bool))
    out["state"] = eng.state_dict()
    pe = sharded.ShardedWindowEngine(mesh, num_vertices_bucket=PANE["vb"])
    for dtype in (np.int32, np.float32):
        src, pane, val = pane_fixture(dtype)
        for name in ("sum", "min", "max"):
            out[("pane", name, np.dtype(dtype).name)] = pe.sliding_reduce(
                src, pane, val, PANE["pb"], PANE["wp"], name=name)
    src, pane, val = pane_fixture(np.int32)
    pos = np.abs(val) + 1
    out[("pane", "gcd")] = pe.sliding_reduce(
        src, pane, pos, PANE["pb"], PANE["wp"], fn=torch.gcd)
    out[("pane", "fn_min")] = pe.sliding_reduce(
        src, pane, val, PANE["pb"], PANE["wp"], fn=torch.minimum)
    return out


def scenario_summary(mesh) -> dict:
    """The summary engine in two calls, its state between them and
    after, and a resume from the state between them."""
    from gelly_streaming_tpu_torch.parallel import sharded

    src, dst = summary_fixture()
    eng = sharded.ShardedSummaryEngine(mesh, SUM_EB, SUM_VB, k_bucket=8)
    cut = 4 * eng.eb
    first = eng.process(src[:cut], dst[:cut])
    mid = eng.state_dict()
    rest = eng.process(src[cut:], dst[cut:])
    again = sharded.ShardedSummaryEngine(mesh, SUM_EB, SUM_VB, k_bucket=8)
    again.load_state_dict(mid)
    off = again.resume_offset()
    return {"summaries": first + rest, "mid": mid,
            "final": eng.state_dict(), "state": eng.state(),
            "resumed": again.process(src[off:], dst[off:]),
            "eb": eng.eb}


def scenario_wire(mesh) -> dict:
    """A stream whose last shard's slice is corrupted on the wire:
    refused with GS_MESH_WIRE_CHECK=1 on every rank, naming the shard; a
    clean stream passes the check."""
    from gelly_streaming_tpu_torch.parallel import sharded
    from gelly_streaming_tpu_torch.utils import faults

    k = sharded.ShardedTriangleWindowKernel(mesh, 512, VB, k_bucket=8)
    src, dst = stream_fixture()
    width = k.eb // mesh.size

    def corrupt(payload):
        (s, d, *rest), n = payload
        s = s.copy()
        s[..., (n - 1) * width:n * width] = VB + 999
        return (s, d, *rest), n

    os.environ["GS_MESH_WIRE_CHECK"] = "1"
    try:
        clean = k.count_stream(src, dst)
        try:
            with faults.inject(faults.FaultSpec(site="shard_wire",
                                                action="call", fn=corrupt)):
                k.count_stream(src, dst)
            refused = None
        except RuntimeError as e:
            refused = str(e)
    finally:
        del os.environ["GS_MESH_WIRE_CHECK"]
    return {"clean": clean, "refused": refused}


def scenario_hybrid(mesh) -> dict:
    """The hybrid mesh's shapes and errors, and a count on its flat
    view."""
    from gelly_streaming_tpu_torch.parallel import multihost, sharded

    hy = multihost.make_hybrid_mesh(ici_shards=2, dcn_shards=mesh.size // 2,
                                    device="cpu")
    flat = multihost.flatten_for_edges(hy)
    k = sharded.ShardedTriangleWindowKernel(flat, 512, VB, k_bucket=8)
    src, dst = stream_fixture()
    try:
        multihost.make_hybrid_mesh(ici_shards=3, dcn_shards=2, device="cpu")
        error = None
    except ValueError as e:
        error = str(e)
    return {"shape": hy.shape, "flat": flat.shape,
            "layout": hy.layout.tolist(), "counts": k.count_stream(src, dst),
            "error": error}


def scenario_subset(mesh) -> dict:
    """make_mesh(world - 1): the first ranks count, the last is outside
    the mesh and refused an engine."""
    from gelly_streaming_tpu_torch.parallel import mesh as mesh_mod
    from gelly_streaming_tpu_torch.parallel import sharded

    sub = mesh_mod.make_mesh(mesh.size - 1, device="cpu")
    src, dst = stream_fixture()
    try:
        k = sharded.ShardedTriangleWindowKernel(sub, 512, VB, k_bucket=8)
    except ValueError as e:
        return {"member": sub.member, "refused": str(e)}
    return {"member": sub.member, "shape": sub.shape,
            "counts": k.count_stream(src, dst)}


SCENARIOS = {"raw": scenario_raw, "count": scenario_count,
             "engine": scenario_engine, "summary": scenario_summary,
             "wire": scenario_wire, "hybrid": scenario_hybrid,
             "subset": scenario_subset}


# ----------------------------------------------------------------------
# the group
# ----------------------------------------------------------------------

class Group:
    """`world` rank processes of one gloo group, started at once; `join`
    waits for them up to the deadline and returns each rank's results
    ({scenario: result}), killing every rank on a failure or a hang.
    `script` is the rank program (this file by default; a sibling
    worker with scenarios of its own calls `rank_main`)."""

    def __init__(self, world: int, tmp, scenarios, timeout_s: float = 150,
                 script: str = None):
        tmp = str(tmp)
        self.world = world
        self.deadline = time.monotonic() + timeout_s
        store = os.path.join(tmp, "store")
        plan = os.path.join(tmp, "scenarios.pkl")
        with open(plan, "wb") as f:
            pickle.dump(list(scenarios), f)
        self.outs = [os.path.join(tmp, "rank%d.pkl" % r)
                     for r in range(world)]
        self.logs = [os.path.join(tmp, "rank%d.log" % r)
                     for r in range(world)]
        env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
        env.pop("GS_MESH_WIRE_CHECK", None)
        self.procs = []
        for r in range(world):
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(script or __file__),
                     str(r),
                     str(world), store, plan, self.outs[r]],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=REPO))

    def join(self) -> list:
        try:
            for p in self.procs:
                p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(self.procs) if p.returncode != 0]
        if bad:
            logs = "\n".join("--- rank %d (exit %s)\n%s" % (
                r, self.procs[r].returncode, open(self.logs[r]).read()[-3000:])
                for r in bad)
            raise AssertionError("gloo group of %d ranks failed:\n%s"
                                 % (self.world, logs))
        results = []
        for path in self.outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def rank_main(rank: int, world: int, store: str, plan: str,
              out: str, scenarios: dict = None) -> None:
    """One rank: join the gloo group through the FileStore, run the
    plan's scenarios (of `scenarios`, SCENARIOS by default) on the whole
    world's mesh and pickle their results to `out`."""
    sys.path.insert(0, REPO)
    import torch
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.parallel import mesh as mesh_mod

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=60))
    try:
        with open(plan, "rb") as f:
            names = pickle.load(f)
        mesh = mesh_mod.make_mesh(device="cpu")
        table = SCENARIOS if scenarios is None else scenarios
        results = {name: table[name](mesh) for name in names}
        with open(out + ".tmp", "wb") as f:
            pickle.dump(results, f)
        os.replace(out + ".tmp", out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                  sys.argv[4], sys.argv[5])
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)
