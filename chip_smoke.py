#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gelly_streaming_tpu_torch) on one
NVIDIA GPU.

Builds the CUDA kernels from gelly_streaming_tpu_torch/csrc and the
native host runtime (gelly_streaming_tpu_torch/native, g++) and runs
thirty-seven phases, with the dispatch tuner's cache (GS_TUNE_CACHE) in a
fresh temporary directory. The first twenty-three run with GS_AUTOTUNE=0,
so their numbers stay comparable across runs (phase cohort_resident's
(d) sets the tuner itself), and phases hooks_cohort and serve run with
GS_AUTOTUNE=0 and GS_COHORT_RESIDENT=off. Eight hold a kernel against its plain PyTorch version on
the card: intersect (ascending and shuffled rows), counter (count and
overflow on every window, overflowing ones included, both wires: a
Zipf chunk, a repeated edge across a whole window, a star, a row past
kb, ids 0 and vb-1, the L2 tier; its device scratch and launches a
call), summary (the summary body of csrc/summary_body.cuh at
vb=65536, its L2 tier, on sparse, bipartite,
ragged, star (hub) and late-odd chunks), gnn, cohort (the same body
through the cohort kernel on five dispatches at eb=4096: 64 Zipf
tenants at vb=8192 and a ragged batch in the shared-memory tier, 8
tenants at vb=65536 in the L2 tier, one tenant at vb=8192, and 4
tenants at vb=65536 whose last row not odd turns odd mid-chunk), compact
(the compact-wire forms of the counter and the summary kernel against
plain and against the standard wire) and snapshot (the driver's snapshot
kernel in its one tier, the cooperative grid, each analytics subset,
full rows with and without masks and the delta wire, a window of one
edge, empty windows, self-loops, and the grid fixtures of
utils/tier_fixtures.py) and cell_reduce (the windowed reduce's cell-reduce kernel:
sum/min/max × out/in/all × int32/float32 on both wires, full rows and
the delta wire, at [64, 8192] vb=16384 and [64, 32768] vb=65536, edge
cases, the plan against its Python mirror, the cell fixtures of
utils/tier_fixtures.py on both of its read paths, one launch a call in
a profile taken first in a child process (`python3 chip_smoke.py
--cell-reduce-capture`), a refused call raising KernelError, cohort_step
of 64 rows). Fourteen
drive the port's paths, each
with the launch counts set to 0 just before it and read just after,
every window checked, and each profile holding one summary-body launch
per summary wrapper call: over the bench's north-star stream
(make_stream(10_485_760, 65_536, seed=7): 320 Zipf windows of 32768
edges) TriangleWindowKernel(32768, 65536).count_stream on the standard wire
(phase stream) and the compact one (phase stream_compact),
StreamSummaryEngine(32768, 65536).process on both wires (phases
summary_stream, summary_stream_compact) and GnnSummaryEngine(32768,
65536, feature_dim=64).process (phase gnn_stream), all through the
ingress pipeline and each also once under forced_sync; the
one-window count triangle_count over dense windows of up to 4096
vertices, and its sparse route past 4096 (phase dense);
TenantCohort(4096, 8192) serving 64 tenant streams, 8 of them at
vb=65536, about 8.3M edges (phase cohort_stream), and the same served
on the cohort's resident tier (GS_COHORT_RESIDENT=on: each group's
carries stacked on the card between rounds, each dispatch one replayed
CUDA graph of graph family cohort_resident), every window and state
equal to the scan cohort's, tenant edges/s and the idle share of the
resident cohort, the scan cohort and 64 sequential engines in turns,
super-batches of 32 windows a tenant, the tuner's tenants-per-dispatch
arm and the ingest ring at 16 tenants a dispatch, and the poison drill
on resident hits with the committed stack bit-equal across each refused
dispatch (phase cohort_resident); and
GnnTenantCohort(4096, 8192, feature_dim=64) over 64 tenants of 16
windows (phase gnn_cohort); StreamingAnalyticsDriver(window_ms=1,
edge_bucket=32768).run_arrays over the north-star stream, count-based,
fed in calls that grow its vertex bucket from 4096 to 65536, every
window equal to one-call runs on both egress forms and on the native
tier, its triangles to count_stream's, a checkpoint resumed (phase
driver); stream_file over a timestamped text file (phase
driver_file); WindowedEdgeReduce(16384, 8192, "sum", "out") over
bench.py's reduce-leg stream (make_stream(2_097_152, 16_384), BASELINE
config #2) on both wires and egress forms, min and max over "all",
slide=2048, the native tier, and the north-star stream at vb=65536
(phase reduce_stream); and the record API (phase api): the reference's
nine TestSlice goldens through host and Torch* UDFs, 1,048,576
timestamped edges through slice(512 ms, ALL).reduce_on_edges(
TorchEdgesReduce(name="sum")), WindowTriangleCount taking both routes
of triangle_count, and get_degrees() over the first 262,144 of them;
the summary-aggregation models (phase models) over the synthetic cit-HepPh stream (421,578 edges, ts =
arrival index): aggregate(TorchConnectedComponents(4096)) and
aggregate(TorchBipartitenessCheck(4096)), also over a bipartite stream
of the same size, against scipy and host double-cover oracles,
TorchIterativeConnectedComponents in batches of 32768, the weighted
matching and both sampling estimators, then the union-find kernel
(gs_cc_fixpoint) timed at the models' sizes against its plain fixpoint;
and StreamingAnalyticsDriver(window_ms=1, edge_bucket=32768,
vertex_bucket=65536, slide=8192) over 2,097,152 edges of the north-star
stream, every emission's triangles equal to the raw trailing slice's,
its cumulative fields to a tumbling driver at the pane size, a resume
mid pane ring (phase driver_slide). Four more drive the resident tier and
the dispatch tuner (ops/autotune.py, ops/resident_engine.py) over the
north-star stream: count_stream and StreamSummaryEngine.process with the
tuner on, three passes each, every count and summary equal to the static
path's, a tuned checkpoint resumed with its incumbent, and six passes at
the tuner's default knobs in turns with the static path (phase autotune);
ResidentSummaryEngine(32768, 65536) on the compact and the standard wire
(phase resident), GnnResidentEngine(32768, 65536, feature_dim=64)
(phase gnn_resident) and StreamingAnalyticsDriver(...,
snapshot_tier="resident") (phase driver_resident), each super-batch a
replayed CUDA graph (replays counted), every result, carry and slab
equal to the scan twin's, a resume at a super-batch boundary exact,
edges/s and the idle share (device busy from CUDA events around each
dispatch) beside the twin in turns. Two drive the host hooks
(gelly_streaming_tpu_torch/utils/): hooks_engine runs count_stream and
the summary engine on both wires, the GNN engine at F=64 and the
resident engine over the same stream disarmed, with each hook armed
alone and with all (every result and carry, the launches and the host
syncs equal to the disarmed pass; edges/s, the journal's bytes, its
fsync), kills a journal-armed summary and resident engine inside a call
and recovers them from checkpoint + journal bit-exactly, retries
injected prep and h2d faults (a hung h2d past its deadline among them)
to equal results, and passes a fatal fault and an error of the launch
wrapper through unretried and unwrapped; costmodel_health arms the cost
observatory and the metrics registry, reads /healthz on an ephemeral
local port while the engines stream, and holds each kernel's cost-model
bound equal to its bound on the kernels line. Five drive the driver's
and the cohort's hooks, the driver's demotion ladder, the serving front
end and tracing: hooks_driver runs the driver
over the same stream (the scan tier fed as in phase driver, then the
resident tier) disarmed, with each hook alone (telemetry, metrics,
latency, costmodel, provenance, the journal, the sanitizer,
tracing=True) and with all (every window, the launches and the host
syncs equal to the disarmed pass; edges/s), kills a journal-armed driver
inside a call and recovers it by resume_and_replay bit-exactly, holds
the cost observatory's snapshot row to the kernels line's bound and
reads /healthz mid-stream; demotion drives the ladder on a 2M-edge
prefix, which never leaves the card (injected host faults at dispatch:
resident to scan, native to host, none off scan; a failed h2d copy
raised; probation and re-promotion; a prep fault retried; a resident
prep failure demoted to scan; a KernelError raised unwrapped with
nothing demoted; GS_TIER_DEMOTE=0); hooks_cohort serves phase
cohort_stream's 64 tenants disarmed, with the journal, the sanitizer
and provenance alone and with every hook armed (checkpoints every 16
windows among them), each equal to the disarmed pass with its launches
and host syncs, then quarantines exactly a tenant with a dispatch fault
and one with a poisoned output row (every tenant exact, one re-admitted
after its probation), raises a KernelError of the cohort launch
unwrapped with nothing quarantined, recovers a kill after pump 3 from
checkpoints + journal bit-exactly, holds the cost observatory's cohort
row to phase cohort's bound, reorders 4 tenants' shuffled stamps within
GS_OOO_BOUND, and runs GnnTenantCohort all armed equal to phase
gnn_cohort; serve (the serving front end, core/serve.py) takes phase
cohort_stream's 64 streams over loopback from 4 client threads into a
StreamServer on the card with GS_PUMP=async, every row and the results
file equal to cohort_stream's windows, feeds admitted during dispatches,
tenant edges/s beside the direct rate, host seconds of the codec, feed,
pump and emit, the card's idle share from CUDA events; then the sync
pump over 8 tenants, the standalone server on the card killed mid-window
and recovered with --recover then drained by SIGTERM, a subscriber that
never reads shed, and a KernelError on the pump thread raised unwrapped
with nothing quarantined; api_tracing traces the record API's
reduce_on_edges over the first 262,144 of phase api's 1M edges beside
its untraced rate, arms the reduce stream's spans, and reports the device_trace
(torch.profiler) capture of a driver call taken first in the process.
Then sharded drives the sharded engines
(gelly_streaming_tpu_torch/parallel/) on a one-rank NCCL group made by
make_mesh() on the card: ShardedTriangleWindowKernel(mesh, 32768, 65536,
k_bucket=128).count_stream over the north-star stream in both table
modes, every count equal to phase stream's; ShardedSummaryEngine over
its first SHARDED_SUMMARY_WINDOWS windows, every summary equal to phase
summary_stream's and the state to the single-chip engine's there;
ShardedWindowEngine(mesh, 65536) against the host twin and numpy
(degrees, CC, bipartite, a triangle table, sliding sum/min/max over
int32 and float32 and gcd); a state taken half way through the host
twin and back; the single-chip and sharded count_stream in turns
(edges/s, idle share from CUDA events). Its launches of the intersect,
union-find and cell-reduce kernels go on the kernels line as
"sharded_launches". driver_mesh runs StreamingAnalyticsDriver(mesh=) on
that group (phase_driver_mesh). The last, evidence, drives the
measured-adoption routing (utils/evidence.py) with its evidence file in
a temporary directory: (a) with no file every resolver keeps its
default and an unpinned TriangleWindowKernel (eb 32768 and 8192),
StreamSummaryEngine, StreamingAnalyticsDriver, TenantCohort (4 of phase
cohort_stream's tenants), WindowedEdgeReduce and the sharded kernel run
on the card with their kernels launched, equal to the earlier phases
over the first EVIDENCE_WINDOWS windows; (b) utils/evidence_ab.py writes
every section's rows over that prefix at full width, printed on a line
of their own after the card's name and power limit; (c) each resolver
chooses what the card's gate (worst_clears_bar) on those rows says, every
routed path is equal to its pinned default (counts, summaries, windows,
cohort rows, states; the reduce's float sums within 1e-5 · Σ|v|) and
launches kernels unless a host or native tier was adopted for it, and
the kernels the routing left out are printed; (d) the same rows under
another device's name route nothing. An evidence file in the checkout
is ignored, with a warning: every phase drives the default paths.
Every main-path phase ends with no demotion in the drivers' logs or the
process's. Each path reports
its rate, its launches and
where its time goes. Beside the dense and GNN kernels it times one
PyTorch call for the same product as a yardstick (torch.mm, torch._int_mm;
torch.addmm; index_add_ beside the cell reduce), and it counts the tensor-core instructions in those two
libraries' SASS where the toolkit has cuobjdump (a diagnostic only).

    python3 chip_smoke.py          # from the repository root

Output: progress lines; then, before the last line, the card's name and
power limit (nvidia-smi) and one JSON line {"kernels": [...]}; last, one
JSON line {"ok": true, "device": {...}}. Any failed check or exception
exits non-zero without that last line, as does a machine with no CUDA
device. Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch

EB, VB, KB = 32768, 65536, 128     # the bench's window at the 10M scale
STREAM_EDGES = 10_485_760          # 320 windows: the north-star scale
SEED = 7
CHUNK = 64                         # MAX_STREAM_WINDOWS
CLIQUE = 200                       # a window that overflows kb=128
STAR_HUBS = 4                      # hubs of the star fixture's windows
LATE_ODD = 40                      # the late-odd fixture's first odd window
CO_LATE_ODD = 5                    # the cohort's late-odd row's first odd window
GNN_F = 64                         # the GNN stream's feature width
DENSE_V = 4096                     # the dense path's largest window
# the cohorts: 64 tenants (the default admission cap) at eb=4096, most at
# vb=8192, the rest at vb=65536; K is the analytic default at eb=4096
CO_EB, CO_VB, CO_BIG_VB, CO_KB = 4096, 8192, 65536, 128
CO_TENANTS, CO_BIG = 64, 8
CO_EDGES, CO_RAGGED = 131072, 1000  # tenant i: CO_EDGES - (i % 5)·CO_RAGGED
CO_FEED = 5000                     # edges per feed() call
GNN_CO_WINDOWS = 16                # windows per tenant of the GNN cohort


class SmokeFailure(Exception):
    pass


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_BENCH_STREAM = []


def bench_stream() -> tuple:
    """make_stream(STREAM_EDGES, VB, seed=SEED), the north-star stream,
    made once a run (seconds of numpy each time); each caller gets its
    own copies."""
    if not _BENCH_STREAM:
        from gelly_streaming_tpu_torch import make_stream

        _BENCH_STREAM.extend(make_stream(STREAM_EDGES, VB, seed=SEED))
    return tuple(a.copy() for a in _BENCH_STREAM)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of fn() over `reps` runs after one warm-up, timed with
    CUDA events on the current stream."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


PROFILE_ATTEMPTS = 3


def take_profile(run, whole, setup=lambda: None) -> tuple:
    """(wall ms, {name: [device ms, launches]}, the launch counts before)
    of run() under torch.profiler (utils/profiling.device_times), after
    setup(). On the H100 the profiler has at times returned a profile
    with no device row, or short of a kernel's launches. A profile that
    whole(by_name, before) refuses is taken again, setup() first, up to
    PROFILE_ATTEMPTS in all, only where the same profile's host-side
    CUDA API rows hold at least as many launch calls as the wrappers
    counted in the run: the profiler itself saw the launches made (its
    record of the API calls, not the wrappers' counters), and lost only
    their device records. Each refused attempt's reading is printed.
    Where the API rows fall short, or no attempt is whole, the last
    profile goes to the caller's checks, which fail on it."""
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.utils.profiling import device_times

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        setup()
        before = dict(kernels.LAUNCHES)
        wall_ms, by_name, calls = device_times(run, launch_calls=True)
        if whole(by_name, before):
            break
        made = sum(kernels.LAUNCHES[k] - before[k] for k in before)
        print("profile attempt %d refused: %d device rows (%d launches), "
              "%d launch calls in the API rows, %d wrapper launches%s"
              % (attempt, len(by_name), sum(n for _ms, n in by_name.values()),
                 calls, made, "" if calls >= made else
                 "; the API rows do not confirm them: not taken again"))
        if calls < made:
            break
    return wall_ms, by_name, before


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up: the
    sum of its device rows under torch.profiler over the runs, so the
    host's launch gaps between short kernels are not counted."""
    fn()
    _wall, by_name, _before = take_profile(
        lambda: [fn() for _ in range(reps)], lambda rows, _b: bool(rows))
    require(by_name, "no device rows in a profile of %d calls" % reps)
    return sum(ms for ms, _n in by_name.values()) / reps


def bound(nbytes: float, ops: float, kind: str = "scalar"):
    """(bound_ms, bound_by): the larger of bytes over the H100's memory
    rate and operations over its peak rate for `kind` ("scalar", the
    32-bit scalar rate; "fp16_tc", "int8_tc", the dense tensor-core
    rates): the cost observatory's one table and roofline
    (gelly_streaming_tpu_torch/utils/costmodel.py `PEAKS`, `bound`)."""
    from gelly_streaming_tpu_torch.utils import costmodel

    return costmodel.bound(nbytes, ops, kind)


def row_work(src, dst, valid, vb: int, kb: int) -> tuple:
    """(Σ over windows of distinct oriented edges, Σ of la + lb): the
    merge steps the row intersection of each window's distinct oriented
    edges needs over sorted rows capped at kb, from the plain
    pipeline."""
    from gelly_streaming_tpu_torch.ops import window_counter as wc

    edges = compares = 0
    for w in range(src.shape[0]):
        v = valid[w] & (src[w] != dst[w])
        s = torch.where(v, src[w], vb)
        d = torch.where(v, dst[w], vb)
        deg = torch.zeros(vb + 1, dtype=torch.int32, device=s.device)
        ones = v.to(torch.int32)
        deg.index_add_(0, s, ones).index_add_(0, d, ones)
        a, b = wc.orient_by_degree(s, d, deg)
        a, b, ev, _pos = wc.dedupe_and_positions(a, b, vb, vb)
        a, b = a[ev].long(), b[ev].long()
        out = torch.bincount(a, minlength=vb + 1).clamp(max=kb)
        edges += int(a.numel())
        compares += int((out[a] + out[b]).sum())
    return edges, compares


def clique(m: int, base: int):
    u, v = np.triu_indices(m, k=1)
    return (u + base).astype(np.int32), (v + base).astype(np.int32)


# ----------------------------------------------------------------------
def phase_intersect(dev, rng) -> dict:
    """Kernel vs plain on random deduplicated rows at the main path's
    per-window shape (vb=65536, K=128, a ragged Ep), in both of the
    kernel's forms: rows strictly ascending with the fill at the end
    (`ascending=True`, the merge form triangle_count_sparse takes), and
    the same rows shuffled (the compare form). The sorted form's numbers
    are the row's in the kernels line."""
    from gelly_streaming_tpu_torch.ops import intersect

    vb, k, ep = VB, KB, EB - 37
    # ids from a narrow range so rows share entries; each row sorted,
    # deduplicated to the sentinel, a share blanked, sorted again (the
    # fill to the end), and a shuffled copy
    vals = np.sort(rng.integers(0, 1024, (vb + 1, k)), axis=1)
    dup = np.zeros_like(vals, bool)
    dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
    keep = ~dup & (rng.random((vb + 1, k)) < 0.7)
    rows = np.sort(np.where(keep, vals, vb), axis=1)
    rows[vb] = vb
    shuffled = np.take_along_axis(rows, rng.random((vb + 1, k)).argsort(1),
                                  1)
    ea = rng.integers(0, vb + 1, ep)
    eb = rng.integers(0, vb + 1, ep)
    emask = rng.random(ep) < 0.9
    nbr, nbr_any = (torch.from_numpy(x.astype(np.int32)).to(dev)
                    for x in (rows, shuffled))
    ta = torch.from_numpy(ea.astype(np.int32)).to(dev)
    tb = torch.from_numpy(eb.astype(np.int32)).to(dev)
    tm = torch.from_numpy(emask).to(dev)

    got = int(intersect.intersect_local(nbr, ta, tb, tm, ascending=True))
    got_any = int(intersect.intersect_local(nbr_any, ta, tb, tm))
    want = int(intersect.intersect_local_plain(nbr, ta, tb, tm))
    want_any = int(intersect.intersect_local_plain(nbr_any, ta, tb, tm))
    torch.cuda.synchronize()
    require(got == want == want_any == got_any,
            "intersect: kernel %d (shuffled rows %d) != plain %d (%d)"
            % (got, got_any, want, want_any))
    require(want > 0, "intersect: fixture has no common entries")
    ms = cuda_ms(lambda: intersect.intersect_local(nbr, ta, tb, tm,
                                                   ascending=True), 50)
    any_ms = cuda_ms(lambda: intersect.intersect_local(nbr_any, ta, tb, tm),
                     50)
    plain_ms = cuda_ms(
        lambda: intersect.intersect_local_plain(nbr, ta, tb, tm), 5)
    # bytes: each touched row once, the edge arrays, the total; ops: the
    # merge steps these rows need, Σ over valid edges of (valid entries
    # of row a) + (valid entries of row b)
    touched = np.unique(np.concatenate([ea[emask], eb[emask]])).size
    nbytes = touched * k * 4 + ep * 9 + 4
    row_len = (rows < vb).sum(axis=1).astype(np.int64)
    steps = int((row_len[ea[emask]] + row_len[eb[emask]]).sum())
    b_ms, b_by = bound(nbytes, steps)
    print("phase intersect: ok  count=%d  kernel %.4f ms ascending rows, "
          "%.4f ms shuffled  plain %.4f ms  (Ep=%d K=%d vb=%d)"
          % (got, ms, any_ms, plain_ms, ep, k, vb))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": abs(got - want),
            "shuffled_ms": any_ms}


def compare_counter(name, src, dst, valid, counter, dev):
    """Kernel (`counter`, a WindowCounter on the card) vs plain (count,
    overflow) of every window of a stack, on the standard wire and, where
    the ids fit uint16 and padding is each window's suffix, on the
    compact wire too: both outputs equal on every window, overflowing
    windows included (the kernel keeps each row's kb smallest ids, as
    the plain version and the JAX package do). Returns (count, overflow,
    max_abs_err) as numpy."""
    from gelly_streaming_tpu_torch.ops import window_counter as wc

    vb, kb = counter.vb, counter.kb
    s, d, v = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
               for x in (src, dst, valid))
    c, o = counter(s, d, v)
    pc, po = wc.count_windows_plain(s, d, v, vb, kb)
    torch.cuda.synchronize()
    c, o, pc, po = (x.cpu().numpy() for x in (c, o, pc, po))
    require(np.array_equal(o, po),
            "%s: overflow kernel %s != plain %s" % (name, o, po))
    require(np.array_equal(c, pc),
            "%s: count kernel %s != plain %s" % (name, c, pc))
    suffix = np.array_equal(valid, np.arange(valid.shape[1])[None, :]
                            < valid.sum(axis=1)[:, None])
    if vb <= 65536 and suffix:
        c16, o16 = counter(*(torch.from_numpy(x).to(dev) for x in
                             to_compact(src, dst, valid)), wire="compact")
        c16, o16 = c16.cpu().numpy(), o16.cpu().numpy()
        require(np.array_equal(c16, pc) and np.array_equal(o16, po),
                "%s: compact wire count %s overflow %s != plain %s %s"
                % (name, c16, o16, pc, po))
    err = int(np.abs(c.astype(np.int64) - pc).max(initial=0))
    return c, o, err


def special_windows(eb: int, vb: int):
    """Special windows of eb slots at vb: one edge repeated across the
    whole window (one row of eb entries, one distinct: the block form
    of a row's sort); eb distinct edges from vertex 0, a star (a hub of
    degree eb); vertex 0 joined to a clique on 1..m (rows of up to m
    distinct entries, past kb=128 at eb=32768); a triangle on ids 0 and
    vb-1; one edge repeated both ways; a dense multigraph on 40
    vertices. Valid slots are each window's prefix."""
    s = np.full((6, eb), vb, np.int32)
    d = np.full((6, eb), vb, np.int32)
    v = np.zeros((6, eb), bool)
    s[0], d[0], v[0] = 5, 9, True
    s[1], d[1], v[1] = 0, np.arange(1, eb + 1) % vb, True
    m = int((math.isqrt(8 * eb + 1) - 1) // 2)        # m + m(m-1)/2 <= eb
    u, w = np.triu_indices(m, 1)
    s[2, :m], d[2, :m] = 0, np.arange(1, m + 1)
    s[2, m:m + len(u)], d[2, m:m + len(u)] = u + 1, w + 1
    v[2, :m + len(u)] = True
    s[3, :3], d[3, :3], v[3, :3] = (0, vb - 1, 7), (vb - 1, 7, 0), True
    s[4, ::2], d[4, ::2], s[4, 1::2], d[4, 1::2] = 3, 9, 9, 3
    v[4] = True
    r = np.random.default_rng(3)
    s[5], d[5], v[5] = r.integers(0, 40, eb), r.integers(0, 40, eb), True
    return s, d, v


def phase_counter(dev) -> dict:
    """Kernel vs plain, count and overflow on every window, both wires:
    a 64-window chunk at eb=32768, vb=65536, kb=128 whose last window
    holds a CLIQUE-clique (overflows kb); special_windows at that shape
    and at kb=8; the K14 clique window at kb=8; edge cases at a small
    shape; the L2 tier (vb=131072, and eb=65536). Then the 64-window
    counter's device scratch (the allocator's peak around its first
    call), its launches a call in a profile, and its time."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc

    src, dst = make_stream(CHUNK * EB, VB, seed=11)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    cs, cd = clique(CLIQUE, 1000)
    s[-1, :len(cs)], d[-1, :len(cd)] = cs, cd
    # the device memory of a 64-window counter: the allocator's peak
    # around its first call (its scratch and its two outputs)
    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (s, d, v))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    counter = wc.WindowCounter(VB, KB, dev)
    counter(st, dt, vt)
    torch.cuda.synchronize()
    scratch_bytes = torch.cuda.max_memory_allocated() - base
    c, o, err = compare_counter("counter chunk", s, d, v, counter, dev)
    require(o[-1] > 0 and (o[:-1] == 0).all(),
            "counter chunk: overflow where not built: %s" % o)
    require(counter.scratch.shared_tier and scratch_bytes < 128 << 20,
            "counter chunk: %d bytes of device scratch (shared tier %s)"
            % (scratch_bytes, counter.scratch.shared_tier))

    errs = [err]
    sp = special_windows(EB, VB)
    csp, osp, e1 = compare_counter("counter windows", *sp, counter, dev)
    require(list(csp[[0, 1, 4]]) == [0, 0, 0] and csp[3] == 1
            and osp[2] > 0, "counter windows: counts %s overflow %s"
            % (csp, osp))
    _c, _o, e2 = compare_counter("counter windows kb=8", *sp,
                                 wc.WindowCounter(VB, 8, dev), dev)
    errs += [e1, e2]

    # the K14 clique of tests/operations/test_pallas_window.py at kb=8
    ks, kd = clique(14, 0)
    rng5 = np.random.default_rng(5)
    extra_s = rng5.integers(0, 128, 200).astype(np.int32)
    extra_d = rng5.integers(0, 128, 200).astype(np.int32)
    _w, s14, d14, v14 = seg.window_stack(np.concatenate([ks, extra_s]),
                                         np.concatenate([kd, extra_d]),
                                         128, sentinel=128)
    _c, o14, err14 = compare_counter("k14", s14, d14, v14,
                                     wc.WindowCounter(128, 8, dev), dev)
    require(o14[0] > 0, "k14: the clique window did not overflow kb=8")

    # edge cases: empty, self-loops only, one edge repeated both ways,
    # ids out of range (padding), a dense small window
    e = 256
    es = np.full((5, e), 256, np.int32)
    ed = np.full((5, e), 256, np.int32)
    ev = np.zeros((5, e), bool)
    es[1], ed[1], ev[1] = 7, 7, True
    es[2, ::2], ed[2, ::2], es[2, 1::2], ed[2, 1::2] = 3, 9, 9, 3
    ev[2] = True
    es[3], ed[3], ev[3] = np.arange(e) % 300 - 20, np.arange(e) % 7, True
    r = np.random.default_rng(3)
    es[4], ed[4], ev[4] = r.integers(0, 20, e), r.integers(0, 20, e), True
    ce, _oe, erre = compare_counter("edge cases", es, ed, ev,
                                    wc.WindowCounter(256, 8, dev), dev)
    require(ce[0] == 0 and ce[1] == 0 and ce[2] == 0,
            "edge cases: empty/loop/duplicate windows counted %s" % ce[:3])
    errs += [err14, erre]

    # the L2 tier: ids past 16 bits, and windows of 65536 slots
    big = 2 * VB
    src2, dst2 = make_stream(8 * EB, big, seed=4)
    _w, s2, d2, v2 = seg.window_stack(src2, dst2, EB, sentinel=big)
    c2 = wc.WindowCounter(big, KB, dev)
    errs.append(compare_counter("L2 tier vb=131072", s2, d2, v2, c2, dev)[2])
    require(not c2.scratch.shared_tier, "vb=131072 did not take the L2 tier")
    sp2 = tuple(np.where(sp[2], x, big) for x in sp[:2]) + (sp[2],)
    errs.append(compare_counter("L2 tier windows kb=8", *sp2,
                                wc.WindowCounter(big, 8, dev), dev)[2])
    src3, dst3 = make_stream(2 * 2 * EB, VB, seed=5)
    _w, s3, d3, v3 = seg.window_stack(src3, dst3, 2 * EB, sentinel=VB)
    s3[1], d3[1] = 5, 9
    c3 = wc.WindowCounter(VB, KB, dev)
    errs.append(compare_counter("L2 tier eb=65536", s3, d3, v3, c3, dev)[2])
    require(not c3.scratch.shared_tier, "eb=65536 did not take the L2 tier")

    # launches a call, time, plain time and bound at the chunk's shape
    calls = 5
    prof = profile_run(lambda: [counter(st, dt, vt) for _ in range(calls)])
    per_call = {k: n / calls for k, n in prof["launches_by_name"].items()}
    kern = sum(n for k, n in prof["launches_by_name"].items()
               if "counter_kernel" in k)
    require(calls - 1 <= kern <= calls and not any(
        "emset" in k for k in per_call),
        "counter: device launches %s for %d calls" % (per_call, calls))
    ms = cuda_ms(lambda: counter(st, dt, vt), 20)
    plain_ms = cuda_ms(lambda: wc.count_windows_plain(st, dt, vt, VB, KB), 2)
    edges, steps = row_work(st, dt, vt, VB, KB)
    # the slab in, two ints out (utils/costmodel.counter_work)
    b_ms, b_by = bound(*cm_work("counter", CHUNK, EB, "standard",
                                compares=steps))
    print(json.dumps({"counter": {
        "scratch_bytes": scratch_bytes, "blocks": counter.scratch.blocks,
        "device_launches_per_call": per_call,
        "device": torch.cuda.get_device_name(0)}}))
    print("phase counter: ok  overflow window %d  kernel %.3f ms/chunk  "
          "plain %.3f ms/chunk  scratch %d B  launches a call %s  (%d "
          "windows, %d distinct edges, %d merge steps)"
          % (o[-1], ms, plain_ms, scratch_bytes, per_call, CHUNK, edges,
             steps))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": max(errs),
            "scratch_bytes": scratch_bytes}


def phase_stream(dev):
    """The main path: count_stream over 320 windows (pipelined, standard
    wire), every window's count checked, launches of both kernels
    counted; one run under forced_sync, equal and timed. Returns the
    launches and the counts."""
    from gelly_streaming_tpu_torch import (TriangleWindowKernel, forced_sync,
                                           kernels)
    from gelly_streaming_tpu_torch.ops import host_triangles
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc

    src, dst = bench_stream()
    kern = TriangleWindowKernel(EB, VB)        # device=None: the card
    require(kern.device.type == "cuda", "kernel not on the card")
    require(kern.kb == KB, "kb %d, want %d" % (kern.kb, KB))
    kern.count_stream(src, dst)   # warm-up: builds and fills every ring slot
    torch.cuda.synchronize()

    kern.stage_timers.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    counts = kern.count_stream(src, dst)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stages = kern.stage_timers.snapshot()
    num_w = STREAM_EDGES // EB
    require(len(counts) == num_w, "%d windows, want %d"
            % (len(counts), num_w))
    # the triangle path's kernel (its row intersection runs inside it)
    for name in ("window_counter",):
        require(launches[name] > 0,
                "kernel %s was not launched on the main path" % name)

    # every window against the plain version on the card; a window the
    # plain version reports as overflowing is checked against numpy
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    recounted = 0
    for at in range(0, num_w, CHUNK):
        st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x[at:at + CHUNK]))
                      .to(dev) for x in (s, d, v))
        pc, po = (x.cpu().numpy() for x in
                  wc.count_windows_plain(st, dt, vt, VB, KB))
        for i in range(len(pc)):
            w = at + i
            want = int(pc[i])
            if po[i]:
                recounted += 1
                want = host_triangles.window_count(
                    src[w * EB:(w + 1) * EB], dst[w * EB:(w + 1) * EB])
            require(counts[w] == want, "stream window %d: kernel %d != "
                    "plain %d" % (w, counts[w], want))
    for w in range(4):
        want = host_triangles.window_count(src[w * EB:(w + 1) * EB],
                                           dst[w * EB:(w + 1) * EB])
        require(counts[w] == want, "stream window %d: kernel %d != numpy "
                "%d" % (w, counts[w], want))

    # a window built to overflow kb=128 is recounted exactly up the
    # ladder: one chunk call plus one recount at kb=512
    cs, cd = clique(CLIQUE, 1000)
    before = kernels.LAUNCHES["window_counter"]
    got = kern.count_stream(np.concatenate([src[:EB], cs]),
                            np.concatenate([dst[:EB], cd]))
    want = [counts[0], math.comb(CLIQUE, 3)]
    require(got == want, "overflow stream %s != %s" % (got, want))
    require(kernels.LAUNCHES["window_counter"] - before == 2,
            "overflow window was not recounted through the ladder")

    # the pipeline's effect in this run: the same stream under forced_sync
    # (prep and h2d inline on this thread)
    with forced_sync():
        t0 = time.perf_counter()
        sync_counts = kern.count_stream(src, dst)
        sync_wall = time.perf_counter() - t0
    require(sync_counts == counts, "stream: forced_sync counts differ")

    # the spread: the same stream twice more, then once under the
    # profiler for where the time goes
    repeats = []
    for _ in range(2):
        t0 = time.perf_counter()
        kern.count_stream(src, dst)
        repeats.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    seg.window_stack(np.asarray(src, np.int32), np.asarray(dst, np.int32),
                     EB, sentinel=VB)
    host_stack_ms = 1e3 * (time.perf_counter() - t0)

    rate = STREAM_EDGES / wall
    print(json.dumps({"stream": {
        "edges": STREAM_EDGES, "windows": num_w, "eb": EB, "vb": VB,
        "kb": kern.kb, "wire": kern.ingress, "seconds": wall,
        "edges_per_s": rate, "repeat_seconds": repeats,
        "forced_sync_seconds": sync_wall,
        "forced_sync_edges_per_s": STREAM_EDGES / sync_wall,
        "stage_ms_per_chunk": stages, "host_stack_ms": host_stack_ms,
        "triangles": int(sum(counts)), "plain_overflow_windows": recounted,
        "launches": launches,
        "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"profile": profile_both(
        lambda: kern.count_stream(src, dst))}))
    print("phase stream: ok  %d windows  %.1f edges/s  (forced_sync %.1f)"
          % (num_w, rate, STREAM_EDGES / sync_wall))
    return launches, counts


def phase_stream_compact(dev, want: list) -> dict:
    """The triangle path on the compact wire:
    TriangleWindowKernel(32768, 65536, ingress="compact").count_stream
    over the same 320 windows, every window equal to phase stream's
    count (checked there against plain), launches of the compact counter
    counted; one forced_sync run, equal and timed."""
    from gelly_streaming_tpu_torch import (TriangleWindowKernel, forced_sync,
                                           kernels)

    src, dst = bench_stream()
    kern = TriangleWindowKernel(EB, VB, ingress="compact")   # the card
    require(kern.device.type == "cuda" and kern.ingress == "compact",
            "compact kernel not on the card")
    kern.count_stream(src, dst)   # warm-up: builds and fills every ring slot
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    counts = kern.count_stream(src, dst)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name in ("window_counter_compact",):
        require(launches[name] > 0,
                "kernel %s was not launched on the compact path" % name)
    bad = [w for w, (a, b) in enumerate(zip(counts, want)) if a != b]
    require(len(counts) == len(want) and not bad,
            "stream_compact: windows %s differ from the standard wire" % bad)
    with forced_sync():
        t0 = time.perf_counter()
        sync_counts = kern.count_stream(src, dst)
        sync_wall = time.perf_counter() - t0
    require(sync_counts == counts, "stream_compact: forced_sync differs")
    repeats = []
    for _ in range(2):
        t0 = time.perf_counter()
        kern.count_stream(src, dst)
        repeats.append(time.perf_counter() - t0)
    prof = profile_both(lambda: kern.count_stream(src, dst))
    rate = STREAM_EDGES / wall
    print(json.dumps({"stream_compact": {
        "edges": STREAM_EDGES, "windows": len(counts), "wire": "compact",
        "seconds": wall, "edges_per_s": rate, "repeat_seconds": repeats,
        "forced_sync_seconds": sync_wall,
        "forced_sync_edges_per_s": STREAM_EDGES / sync_wall,
        "h2d_bytes_per_chunk": CHUNK * EB * 4 + CHUNK * 4,
        "launches": launches, "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"stream_compact_profile": prof}))
    print("phase stream_compact: ok  %d windows  %.1f edges/s  (forced_sync "
          "%.1f)" % (len(counts), rate, STREAM_EDGES / sync_wall))
    return launches


def clustered_stack(rng, num_w: int, size: int, cross: int):
    """A sparse uniform [num_w, EB] stack: edges inside clusters of
    `size` vertices (VB/size clusters, about one edge per vertex per
    window), plus `cross` random edges per window that merge clusters
    slowly, so num_components stays in the thousands and moves."""
    base = size * rng.integers(0, VB // size, (num_w, EB))
    s = base + rng.integers(0, size, (num_w, EB))
    d = base + rng.integers(0, size, (num_w, EB))
    s[:, :cross] = rng.integers(0, VB, (num_w, cross))
    return (s.astype(np.int32), d.astype(np.int32),
            np.ones((num_w, EB), bool))


def summary_fixtures():
    """(name, prefix stack folded first, the chunk under test), all at
    [64, EB] over VB vertices; each exercises what the Zipf stream does
    not."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import segment as seg

    rng = np.random.default_rng(13)
    sparse = clustered_stack(rng, 2 * CHUNK, 16, 8)
    yield ("sparse", tuple(x[:CHUNK] for x in sparse),
           tuple(x[CHUNK:] for x in sparse))

    # bipartite: src even, dst odd; the chunk's last window closes a
    # triangle 0-2-4, so `odd` turns true there and only there
    bs = 2 * rng.integers(0, VB // 2, (2 * CHUNK, EB)).astype(np.int32)
    bd = 2 * rng.integers(0, VB // 2, (2 * CHUNK, EB)).astype(np.int32) + 1
    bs[-1, -3:], bd[-1, -3:] = (0, 2, 4), (2, 4, 0)
    bv = np.ones((2 * CHUNK, EB), bool)
    yield ("bipartite", (bs[:CHUNK], bd[:CHUNK], bv[:CHUNK]),
           (bs[CHUNK:], bd[CHUNK:], bv[CHUNK:]))

    # ragged: 34 Zipf windows, one of self-loops only, the CLIQUE-200
    # overflow window, one partial window (padded slots), padded to 64
    # windows (padded windows): padding joins the cover's sentinels
    src, dst = make_stream(2 * CHUNK * EB, VB, seed=11)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    cs, cd = clique(CLIQUE, 1000)
    s[CHUNK + 35, :len(cs)], d[CHUNK + 35, :len(cd)] = cs, cd
    s[CHUNK + 34] = d[CHUNK + 34] = np.arange(EB) * 2
    v[CHUNK + 36, EB // 3:] = False
    sc, dc, vc, n = seg.pad_window_chunk(s, d, v, CHUNK, CHUNK + 37, CHUNK,
                                         EB, VB)
    require(n == 37 and sc.shape[0] == CHUNK, "ragged fixture shape")
    yield ("ragged", (s[:CHUNK], d[:CHUNK], v[:CHUNK]), (sc, dc, vc))

    # star: every window gives one of four hubs all but 64 of its slots
    # (the warp-aggregated degree adds), the rest random
    sp = clustered_stack(rng, CHUNK, 16, 8)
    ss = rng.integers(0, VB, (CHUNK, EB)).astype(np.int32)
    sd = rng.integers(0, VB, (CHUNK, EB)).astype(np.int32)
    ss[:, :EB - 64] = (7 * (np.arange(CHUNK) % STAR_HUBS) + 3)[:, None]
    yield "star", sp, (ss, sd, np.ones((CHUNK, EB), bool))

    # late odd: bipartite (src even, dst odd); the prefix joins 10 and 20
    # through 31, and the chunk's window LATE_ODD closes an odd cycle
    # with its one edge (10, 20), between two vertices touched long
    # before: odd turns true there and only there
    ls = 2 * rng.integers(0, VB // 2, (2 * CHUNK, EB)).astype(np.int32)
    ld = 2 * rng.integers(0, VB // 2, (2 * CHUNK, EB)).astype(np.int32) + 1
    ls[0, :2], ld[0, :2] = (10, 20), (31, 31)
    ls[CHUNK + LATE_ODD, -1], ld[CHUNK + LATE_ODD, -1] = 10, 20
    lv = np.ones((2 * CHUNK, EB), bool)
    yield ("late odd", (ls[:CHUNK], ld[:CHUNK], lv[:CHUNK]),
           (ls[CHUNK:], ld[CHUNK:], lv[CHUNK:]))


def compare_summary(name, chunk, summ, carry, plain_carry, dev):
    """Kernel (`summ`, a WindowSummary on the card, folding into
    `carry`) vs plain (folding into `plain_carry`) on one chunk: the five
    outputs equal on every window (triangles in overflowing windows
    too), then the three carries bit-equal. Returns the plain outputs as
    numpy and the max abs error."""
    from gelly_streaming_tpu_torch.ops import window_summary as ws

    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in chunk)
    got = [x.cpu().numpy() for x in summ(carry, st, dt, vt)]
    want = [x.cpu().numpy() for x in ws.summarize_windows_plain(
        plain_carry, st, dt, vt, summ.vb, summ.kb)]
    names = ("max_degree", "num_components", "odd", "triangles",
             "k_overflow")
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        require(np.array_equal(g, w), "%s: %s kernel %s != plain %s"
                % (name, names[i], g, w))
        err = max(err, int(np.abs(g.astype(np.int64) - w).max(initial=0)))
    for label, a, b in zip(("deg", "labels", "cover"), carry, plain_carry):
        require(torch.equal(a, b), "%s: carry %s differs from plain"
                % (name, label))
    return want, err


def phase_summary(dev) -> dict:
    """The window-summary kernel (+ the counter for triangles) vs its
    plain version on 64-window chunks at eb=32768, vb=65536, kb=128,
    each from a carry that is not fresh; the union-find entry vs the
    plain fixpoint; then times at the Zipf chunk."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.ops import window_summary as ws

    summ = ws.WindowSummary(VB, KB, dev)
    err = 0
    for name, prefix, chunk in summary_fixtures():
        carry, plain_carry = ws.fresh_carry(VB, dev), ws.fresh_carry(VB, dev)
        pre, e1 = compare_summary(name + " prefix", prefix, summ, carry,
                                  plain_carry, dev)
        out, e2 = compare_summary(name, chunk, summ, carry, plain_carry,
                                  dev)
        err = max(err, e1, e2)
        mdeg, ncomp, odd, tri, ovf = out
        if name == "sparse":
            require(ncomp.min() > 1000 and len(set(ncomp.tolist())) > 8,
                    "sparse: num_components %s" % ncomp)
            forest = carry[1]
        if name == "bipartite":
            require(not pre[2].any() and not odd[:-1].any() and odd[-1],
                    "bipartite: odd %s %s" % (pre[2], odd))
        if name == "ragged":
            require(int(carry[2][2 * VB + 1]) == VB,
                    "ragged: the cover's sentinels were not joined")
            require(odd[34] and tri[34] == 0 and ovf[35] > 0
                    and (ovf[37:] == 0).all()
                    and (mdeg[37:] == mdeg[36]).all(),
                    "ragged: loops/overflow/padding %s %s %s"
                    % (odd, ovf, mdeg))
        if name == "star":
            require(mdeg.min() >= EB - 64 and mdeg[-1] >= (
                CHUNK // STAR_HUBS) * (EB - 64), "star: max_degree %s"
                % mdeg)
        if name == "late odd":
            require(not pre[2].any() and not odd[:LATE_ODD].any()
                    and odd[LATE_ODD:].all(), "late odd: odd %s %s"
                    % (pre[2], odd))
        print("phase summary %s: ok  num_components %d..%d  odd windows "
              "%d  overflow windows %d" % (name, ncomp.min(), ncomp.max(),
                                           int(odd.sum()),
                                           int((ovf > 0).sum())))

    # the union-find entry (cc_fixpoint on CUDA tensors) vs the plain
    # rounds: carried on the sparse fixture's forest, and fresh
    rng = np.random.default_rng(17)
    es = torch.from_numpy(rng.integers(0, VB + 1, EB).astype(np.int32))
    ed = torch.from_numpy(rng.integers(0, VB + 1, EB).astype(np.int32))
    es, ed = es.to(dev), ed.to(dev)
    fresh = torch.arange(VB + 1, dtype=torch.int32, device=dev)
    for lab0, carried in ((forest, True), (fresh, False)):
        got = uf.cc_fixpoint(lab0, es, ed, carried)
        want = uf.cc_fixpoint_plain(lab0, es, ed, carried)
        require(torch.equal(got, want),
                "cc_fixpoint carried=%s: kernel != plain" % carried)

    # times at the main path's chunk: 64 Zipf windows, the carry after
    # one chunk folded
    src, dst = make_stream(2 * CHUNK * EB, VB, seed=11)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x[CHUNK:])).to(dev)
                  for x in (s, d, v))
    carry = ws.fresh_carry(VB, dev)
    pt, pd, pv = (torch.from_numpy(np.ascontiguousarray(x[:CHUNK])).to(dev)
                  for x in (s, d, v))
    summ(carry, pt, pd, pv)
    sums = torch.empty(3, CHUNK, dtype=torch.int32, device=dev)
    kern_ms = cuda_ms(lambda: ws.summarize(
        tuple(c.clone() for c in carry), st, dt, vt, VB, sums), 20)
    clone_ms = cuda_ms(lambda: tuple(c.clone() for c in carry), 20)
    ms = cuda_ms(lambda: summ(tuple(c.clone() for c in carry), st, dt, vt),
                 20)
    counter_ms = cuda_ms(lambda: summ.counter(st, dt, vt), 20)
    plain_ms = cuda_ms(lambda: ws.summarize_windows_plain(
        tuple(c.clone() for c in carry), st, dt, vt, VB, KB), 1)
    slots = int(vt.sum())
    edges, compares = row_work(st, dt, vt, VB, KB)
    b_ms, b_by = bound(*cm_work("summary", CHUNK, EB, VB, "standard",
                                slots=slots, compares=compares))
    print("phase summary: ok  kernel %.3f ms/chunk (summary kernel alone "
          "%.3f, %s tier; counter alone %.3f; carry clone %.3f)  plain "
          "%.1f ms/chunk  (%d windows, %d valid slots, %d distinct edges, "
          "%d compares)"
          % (ms - clone_ms, kern_ms - clone_ms, summary_tier(VB, dev),
             counter_ms, clone_ms, plain_ms, CHUNK, slots, edges, compares))
    return {"ms": ms - clone_ms, "plain_ms": plain_ms - clone_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err,
            "kernel_only_ms": kern_ms - clone_ms, "counter_ms": counter_ms}


def summary_tier(vb: int, dev) -> str:
    """Which tier of csrc/summary_body.cuh folds a carry row at vb:
    "shared" where its 16(vb+1) bytes fit a block's opt-in shared memory,
    "L2" elsewhere (a label for the output; the kernel decides)."""
    optin = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    return "shared" if 16 * (vb + 1) <= optin else "L2"


def cm_work(kind: str, *args, **kw) -> tuple:
    """(bytes, operations, kind) of one call of the counter, summary or
    GNN kernel: the cost observatory's counts
    (gelly_streaming_tpu_torch/utils/costmodel.py `counter_work`,
    `summary_work`, `gnn_work`), with the data-dependent operations
    (valid slots, row compares) this run's data needs."""
    from gelly_streaming_tpu_torch.utils import costmodel

    return getattr(costmodel, kind + "_work")(*args, **kw)


def phase_summary_stream(dev):
    """The summary engine's main path: StreamSummaryEngine(32768,
    65536).process over the 320-window stream (pipelined, standard wire),
    every window checked against the plain version on the card (and the
    numpy oracle where the plain count overflows K), the first four
    against the numpy summary oracle, the final carry against the plain
    one, launches of all three kernels counted; one run under
    forced_sync, equal and timed. Returns the launches, the summaries
    and the final state_dict."""
    from gelly_streaming_tpu_torch import (StreamSummaryEngine, forced_sync,
                                           kernels)
    from gelly_streaming_tpu_torch.ops import host_summary, host_triangles
    from gelly_streaming_tpu_torch.ops import scan_analytics as sa
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_summary as ws

    src, dst = bench_stream()
    eng = StreamSummaryEngine(EB, VB)          # device=None: the card
    require(eng.device.type == "cuda", "engine not on the card")
    require(eng.kb == KB, "kb %d, want %d" % (eng.kb, KB))
    eng.warm_fallback()
    eng.process(src, dst)         # warm-up: builds and fills every ring slot
    eng.reset()
    torch.cuda.synchronize()

    eng.stage_timers.reset()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.process(src, dst)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stages = eng.stage_timers.snapshot()
    num_w = STREAM_EDGES // EB
    require(len(out) == num_w, "%d windows, want %d" % (len(out), num_w))
    for name in ("window_counter", "window_summary"):
        require(launches[name] > 0, "kernel %s was not launched on the "
                "summary path" % name)
    state = eng.state_dict()

    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    plain_carry = ws.fresh_carry(VB, dev)
    recounted = 0
    for at in range(0, num_w, CHUNK):
        st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x[at:at + CHUNK]))
                      .to(dev) for x in (s, d, v))
        mdeg, ncomp, odd, tri, ovf = (
            x.cpu().numpy() for x in ws.summarize_windows_plain(
                plain_carry, st, dt, vt, VB, KB))
        for i in range(len(mdeg)):
            w = at + i
            want_tri = int(tri[i])
            if ovf[i]:
                recounted += 1
                want_tri = host_triangles.window_count(
                    src[w * EB:(w + 1) * EB], dst[w * EB:(w + 1) * EB])
            want = {"max_degree": int(mdeg[i]),
                    "num_components": int(ncomp[i]),
                    "odd_cycle": bool(odd[i]), "triangles": want_tri}
            require(out[w] == want, "summary window %d: engine %s != plain "
                    "%s" % (w, out[w], want))
    for label, a, b in zip(("deg", "labels", "cover"), state["carry"],
                           plain_carry):
        require(np.array_equal(a, b.cpu().numpy()),
                "summary stream: final carry %s differs from plain" % label)
    oracle, _carry = host_summary.summarize_stream(src[:4 * EB],
                                                   dst[:4 * EB], EB, VB)
    require(out[:4] == oracle, "summary stream: first windows %s != numpy "
            "%s" % (out[:4], oracle))

    eng.reset()
    with forced_sync():
        t0 = time.perf_counter()
        sync_out = eng.process(src, dst)
        sync_wall = time.perf_counter() - t0
    require(sync_out == out and all(
        np.array_equal(a, b) for a, b in zip(eng.state_dict()["carry"],
                                             state["carry"])),
        "summary stream: forced_sync summaries or carry differ")
    repeats = []
    for _ in range(2):
        eng.reset()
        t0 = time.perf_counter()
        eng.process(src, dst)
        repeats.append(time.perf_counter() - t0)
    prof = profile_both(lambda: eng.process(src, dst), eng.reset)
    # the engine's host work beyond the triangle stream's, timed alone
    s32, d32 = np.asarray(src, np.int32), np.asarray(dst, np.int32)
    t0 = time.perf_counter()
    sa._validate_ids(s32, d32, VB)
    id_check_ms = 1e3 * (time.perf_counter() - t0)
    rate = STREAM_EDGES / wall
    print(json.dumps({"summary_stream": {
        "edges": STREAM_EDGES, "windows": num_w, "eb": EB, "vb": VB,
        "kb": eng.kb, "wire": eng.ingress, "seconds": wall,
        "edges_per_s": rate, "repeat_seconds": repeats,
        "forced_sync_seconds": sync_wall,
        "forced_sync_edges_per_s": STREAM_EDGES / sync_wall,
        "stage_ms_per_chunk": stages, "id_check_ms": id_check_ms,
        "plain_overflow_windows": recounted, "last_window": out[-1],
        "launches": launches,
        "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"summary_profile": prof}))
    print("phase summary_stream: ok  %d windows  %.1f edges/s  (forced_sync "
          "%.1f)" % (num_w, rate, STREAM_EDGES / sync_wall))
    return launches, out, state


def phase_summary_stream_compact(dev, want: list, want_state: dict) -> dict:
    """The summary engine on the compact wire:
    StreamSummaryEngine(32768, 65536, ingress="compact").process over the
    same 320 windows, every window and the final carry equal to phase
    summary_stream's (checked there against plain), launches of the
    compact summary kernel and the compact counter counted; one
    forced_sync run, equal and timed."""
    from gelly_streaming_tpu_torch import (StreamSummaryEngine, forced_sync,
                                           kernels)

    src, dst = bench_stream()
    eng = StreamSummaryEngine(EB, VB, ingress="compact")   # the card
    require(eng.device.type == "cuda" and eng.ingress == "compact",
            "compact engine not on the card")
    eng.warm_fallback()
    eng.process(src, dst)         # warm-up: builds and fills every ring slot
    eng.reset()
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.process(src, dst)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name in ("window_counter_compact", "window_summary_compact"):
        require(launches[name] > 0, "kernel %s was not launched on the "
                "compact summary path" % name)
    bad = [w for w, (a, b) in enumerate(zip(out, want)) if a != b]
    require(len(out) == len(want) and not bad,
            "summary_stream_compact: windows %s differ from the standard "
            "wire" % bad)
    state = eng.state_dict()
    for label, a, b in zip(("deg", "labels", "cover"), state["carry"],
                           want_state["carry"]):
        require(np.array_equal(a, b), "summary_stream_compact: final carry "
                "%s differs from the standard wire's" % label)
    eng.reset()
    with forced_sync():
        t0 = time.perf_counter()
        sync_out = eng.process(src, dst)
        sync_wall = time.perf_counter() - t0
    require(sync_out == out, "summary_stream_compact: forced_sync differs")
    repeats = []
    for _ in range(2):
        eng.reset()
        t0 = time.perf_counter()
        eng.process(src, dst)
        repeats.append(time.perf_counter() - t0)
    prof = profile_both(lambda: eng.process(src, dst), eng.reset)
    rate = STREAM_EDGES / wall
    print(json.dumps({"summary_stream_compact": {
        "edges": STREAM_EDGES, "windows": len(out), "wire": "compact",
        "seconds": wall, "edges_per_s": rate, "repeat_seconds": repeats,
        "forced_sync_seconds": sync_wall,
        "forced_sync_edges_per_s": STREAM_EDGES / sync_wall,
        "h2d_bytes_per_chunk": CHUNK * EB * 4 + CHUNK * 4,
        "launches": launches, "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"summary_stream_compact_profile": prof}))
    print("phase summary_stream_compact: ok  %d windows  %.1f edges/s  "
          "(forced_sync %.1f)" % (len(out), rate, STREAM_EDGES / sync_wall))
    return launches


def to_compact(s, d, v):
    """A standard-wire [W, eb] stack on the compact wire (uint16 ids, one
    valid count per window); its padding must be each window's suffix."""
    nvalid = v.sum(axis=1).astype(np.int32)
    require(np.array_equal(v, np.arange(v.shape[1])[None, :]
                           < nvalid[:, None]),
            "compact wire: padding is not a suffix")
    return (np.where(v, s, 0).astype(np.uint16),
            np.where(v, d, 0).astype(np.uint16), nvalid)


def compact_fixtures():
    """(name, vb, prefix, chunk): phase summary's fixtures; a Zipf chunk
    at vb=65536 whose last window is half padding and closes a triangle
    on ids 65533-65535 in its last valid slots (the top uint16 id is
    real, padding only what lies past a window's count); and a Zipf
    chunk at vb=8192, the summary body's shared-memory tier, its last
    window half padding."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import segment as seg

    for name, prefix, chunk in summary_fixtures():
        yield name, VB, prefix, chunk
    src, dst = make_stream(2 * CHUNK * EB, VB, seed=19)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    tri = slice(EB // 2 - 3, EB // 2)     # the last valid slots
    s[-1, tri], d[-1, tri] = (65533, 65534, 65535), (65534, 65535, 65533)
    v[-1, EB // 2:] = False
    yield ("top ids", VB, (s[:CHUNK], d[:CHUNK], v[:CHUNK]),
           (s[CHUNK:], d[CHUNK:], v[CHUNK:]))
    src, dst = make_stream(2 * CHUNK * EB, CO_VB, seed=29)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=CO_VB)
    v[-1, EB // 2:] = False
    yield ("vb=8192", CO_VB, (s[:CHUNK], d[:CHUNK], v[:CHUNK]),
           (s[CHUNK:], d[CHUNK:], v[CHUNK:]))


def phase_compact(dev) -> dict:
    """The compact forms of the counter and the summary kernel (the
    decode fused into both) against their plain versions (widen_stack,
    then plain) and against the standard-wire kernels on the same
    windows: phase summary's fixtures, a vb=65536 chunk with id 65535
    and a vb=8192 chunk (the summary body's shared-memory tier), each
    from a carry that is not fresh.
    Outputs equal (triangles where overflow is 0) and carries bit-equal
    across the wires and against plain. Then ms per 64-window chunk of
    each wire at the Zipf chunk, and each wire's h2d bytes and copy
    time per chunk."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import compact_ingress as ci
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc
    from gelly_streaming_tpu_torch.ops import window_summary as ws

    def dev_stack(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                     for x in arrays)

    # (the compact wire's, the standard wire's) summaries per vb
    pairs = {vb: tuple(ws.WindowSummary(vb, KB, dev) for _ in range(2))
             for vb in (VB, CO_VB)}
    err = 0
    for name, vb, prefix, chunk in compact_fixtures():
        summ, std = pairs[vb]
        carries = [ws.fresh_carry(vb, dev) for _ in range(3)]
        for part, stack in (("prefix", prefix), ("chunk", chunk)):
            st = dev_stack(stack)
            ct = dev_stack(to_compact(*stack))
            got = [x.cpu().numpy() for x in summ(carries[0], *ct,
                                                 wire="compact")]
            other = [x.cpu().numpy() for x in std(carries[1], *st)]
            plain = [x.cpu().numpy() for x in ws.summarize_windows_plain(
                carries[2], *ci.widen_stack(*ct, EB, vb), vb, KB)]
            for i, (g, o, p) in enumerate(zip(got, other, plain)):
                require(np.array_equal(g, p) and np.array_equal(g, o),
                        "compact %s %s: output %d compact %s, standard %s, "
                        "plain %s" % (name, part, i, g, o, p))
                err = max(err, int(np.abs(g.astype(np.int64) - p)
                                   .max(initial=0)))
            for label, a, b, c in zip(("deg", "labels", "cover"),
                                      *carries):
                require(torch.equal(a, b) and torch.equal(a, c),
                        "compact %s %s: carry %s differs across wires or "
                        "from plain" % (name, part, label))
            # the counter alone on the same windows, both wires and plain
            c, o = summ.counter(*ct, wire="compact")
            pc, po = wc.count_windows_plain(*ci.widen_stack(*ct, EB, vb),
                                            vb, KB)
            c, o, pc, po = (x.cpu().numpy() for x in (c, o, pc, po))
            require(np.array_equal(o, po) and np.array_equal(c, pc),
                    "compact %s %s: counter %s %s != plain %s %s"
                    % (name, part, c, o, pc, po))
        if name in ("ragged", "vb=8192"):
            require(int(carries[0][2][2 * vb + 1]) == vb,
                    "compact %s: the cover's sentinels were not joined"
                    % name)
        if name == "top ids":
            require((plain[4][-1] > 0 or plain[3][-1] >= 1)
                    and int(carries[0][0][65535]) > 0,
                    "compact top ids: id 65535 lost: triangles %d, degree "
                    "%d" % (plain[3][-1], int(carries[0][0][65535])))
        print("phase compact %s: ok  both wires and plain bit-equal, "
              "triangles %d..%d" % (name, plain[3].min(), plain[3].max()))

    # times at the Zipf chunk of phase summary, both wires
    summ = pairs[VB][0]
    src, dst = make_stream(2 * CHUNK * EB, VB, seed=11)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    carry = ws.fresh_carry(VB, dev)
    summ(carry, *dev_stack(to_compact(s[:CHUNK], d[:CHUNK], v[:CHUNK])),
         wire="compact")
    st = dev_stack((s[CHUNK:], d[CHUNK:], v[CHUNK:]))
    ct = dev_stack(to_compact(s[CHUNK:], d[CHUNK:], v[CHUNK:]))
    clone_ms = cuda_ms(lambda: tuple(c.clone() for c in carry), 20)
    sums = torch.empty(3, CHUNK, dtype=torch.int32, device=dev)
    times = {}
    for wire, stack in (("standard", st), ("compact", ct)):
        times[wire] = {
            "summary_ms": cuda_ms(lambda: summ(
                tuple(c.clone() for c in carry), *stack, wire=wire), 20)
            - clone_ms,
            "kernel_only_ms": cuda_ms(lambda: ws.summarize(
                tuple(c.clone() for c in carry), *stack, VB, sums, wire),
                20) - clone_ms,
            "counter_ms": cuda_ms(lambda: summ.counter(*stack, wire=wire),
                                  20)}
    counter_plain_ms = cuda_ms(lambda: wc.count_windows_plain(
        *ci.widen_stack(*ct, EB, VB), VB, KB), 1)
    summary_plain_ms = cuda_ms(lambda: ws.summarize_windows_plain(
        tuple(c.clone() for c in carry), *ci.widen_stack(*ct, EB, VB), VB,
        KB), 1) - clone_ms
    # the h2d of one chunk of each wire from pinned memory
    h2d = {}
    for wire, nbytes in (("standard", CHUNK * EB * 9),
                         ("compact", CHUNK * EB * 4 + CHUNK * 4)):
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        h2d[wire] = {"bytes": nbytes, "ms": cuda_ms(
            lambda: buf.copy_(host, non_blocking=True), 20)}
    slots = int(v[CHUNK:].sum())
    edges, compares = row_work(*st, VB, KB)
    counter_bound = bound(*cm_work("counter", CHUNK, EB, "compact",
                                   compares=compares))
    summary_bound = bound(*cm_work("summary", CHUNK, EB, VB, "compact",
                                   slots=slots, compares=compares))
    print(json.dumps({"compact": {
        "times_ms": times, "h2d": h2d, "counter_plain_ms": counter_plain_ms,
        "summary_plain_ms": summary_plain_ms,
        "counter_bound": counter_bound, "summary_bound": summary_bound,
        "device": torch.cuda.get_device_name(0)}}))
    print("phase compact: ok  summary %.3f ms/chunk compact, %.3f standard"
          " (kernel alone %.3f, %.3f);  counter %.3f compact, %.3f standard;"
          "  h2d %d B (%.3f ms) compact, %d B (%.3f ms) standard"
          % (times["compact"]["summary_ms"], times["standard"]["summary_ms"],
             times["compact"]["kernel_only_ms"],
             times["standard"]["kernel_only_ms"],
             times["compact"]["counter_ms"], times["standard"]["counter_ms"],
             h2d["compact"]["bytes"], h2d["compact"]["ms"],
             h2d["standard"]["bytes"], h2d["standard"]["ms"]))
    return {
        "counter": {"ms": times["compact"]["counter_ms"],
                    "plain_ms": counter_plain_ms,
                    "bound_ms": counter_bound[0],
                    "bound_by": counter_bound[1], "max_abs_err": err},
        "summary": {"ms": times["compact"]["summary_ms"],
                    "plain_ms": summary_plain_ms,
                    "bound_ms": summary_bound[0],
                    "bound_by": summary_bound[1], "max_abs_err": err}}


def gnn_weights(F: int, lo: int, hi: int, seed: int = 3):
    """Random snapped weights that keep the slab between saturation and
    death: each output feature is one input minus another (±1 unit each,
    so a row whose features all saturate maps to its bias alone), plus a
    bias of [lo, hi) units."""
    from gelly_streaming_tpu_torch.ops import gnn_window as gw

    rng = np.random.RandomState(seed)
    W = np.zeros((F, F))
    for j in range(F):
        a, b = rng.choice(F, 2, replace=False)
        W[a, j], W[b, j] = 1, -1
    return gw.snap_weights(W / 32, rng.randint(lo, hi, F) / 32, F)


def gnn_fixtures():
    """(name, eb, F, act, (W, b) units, the slab loaded first, the
    [64, eb] chunk under test), all over VB vertices."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import gnn_window as gw
    from gelly_streaming_tpu_torch.ops import segment as seg

    def zipf(eb, seed=11):
        src, dst = make_stream(CHUNK * eb, VB, seed=seed)
        return seg.window_stack(src, dst, eb, sentinel=VB)[1:]

    yield ("zipf F=64 relu", EB, GNN_F, "relu", gnn_weights(GNN_F, -12, -3),
           gw.default_features(VB, GNN_F, seed=0), zipf(EB))
    # abs keeps every row with a nonzero feature alive: start from a slab
    # whose rows are a quarter nonzero, so activity spreads
    slab = gw.default_features(VB, 16, seed=1)
    slab[:VB][np.random.default_rng(1).random(VB) > 0.25] = 0
    yield ("F=16 abs", EB, 16, "abs", gnn_weights(16, 0, 1), slab, zipf(EB))
    # weight_shift 1; the first window is empty, so it holds a slab whose
    # sum is above 2^31: the checksum wraps
    s, d, v = zipf(EB)
    v[0] = False
    slab = gw.default_features(VB, 128, seed=2)
    slab[:VB] += 300
    yield ("F=128 identity", EB, 128, "identity", gnn_weights(128, -6, 1),
           slab, (s, d, v))
    yield ("eb=65536", 2 * EB, 32, "relu", gnn_weights(32, -24, -7),
           gw.default_features(VB, 32, seed=3), zipf(2 * EB, seed=12))
    # ragged: an empty first window over a slab whose sentinel row is
    # nonzero (the held checksum counts it), a self-loop window, a
    # partial window, then padded windows
    src, dst = make_stream(40 * EB, VB, seed=13)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    v[0] = False
    s[5] = d[5] = np.arange(EB) % VB
    v[36, EB // 3:] = False
    slab = gw.default_features(VB, GNN_F, seed=4)
    slab[VB] = 5
    sc, dc, vc, n = seg.pad_window_chunk(s, d, v, 0, 37, CHUNK, EB, VB)
    require(n == 37 and sc.shape[0] == CHUNK, "gnn ragged fixture shape")
    yield ("ragged", EB, GNN_F, "relu", gnn_weights(GNN_F, -12, -3), slab,
           (sc, dc, vc))
    # widths the tensor-core tiles pad: F=72 (neither k nor n a multiple
    # of 16; weight_shift 1), F=256, the widest (weight cap 128),
    # and F=3 and F=99, not multiples of 4: the 4-byte loads and stores
    # in place of the 16-byte ones, a last 32-column pass of 3 columns
    # (at F=3 the weights of seed 3 kill every row by the eighth window)
    for F, seed, w_seed in ((72, 5, 3), (256, 6, 3), (3, 7, 8), (99, 8, 3)):
        yield ("F=%d relu" % F, EB, F, "relu",
               gnn_weights(F, -12, -3, w_seed),
               gw.default_features(VB, F, seed=seed), zipf(EB, seed=9 + F))


def phase_gnn(dev) -> dict:
    """The GNN round kernel vs its plain version on 64-window chunks at
    vb=65536 from a loaded slab: F=64 relu on Zipf windows, F=16 abs,
    F=128 identity (weight_shift 1, a wrapping checksum), eb=65536
    (agg_shift 1), a ragged chunk, F=72, F=256, F=3 and F=99; slab and
    all 4×W sums equal. Then, at F=64, times of the whole call and the
    plain version, each kernel's µs a window from torch.profiler, and
    torch.addmm(b, p, W) on one window's [vb+1, F] as the product's
    yardstick."""
    from gelly_streaming_tpu_torch.ops import gnn_round as gr

    err = 0
    timed = None
    for name, eb, F, act, (W, b), slab, chunk in gnn_fixtures():
        st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                      for x in chunk)
        Wt, bt = torch.from_numpy(W).to(dev), torch.from_numpy(b).to(dev)
        h0 = torch.from_numpy(slab).to(dev)
        h, ph = h0.clone(), h0.clone()
        sums = torch.empty(4, CHUNK, dtype=torch.int32, device=dev)
        psums = torch.empty_like(sums)
        rnd = gr.GnnRound(VB, F, h.device)
        rnd(h, Wt, bt, st, dt, vt, act, sums)
        gr.gnn_rounds_plain(ph, Wt, bt, st, dt, vt, act, psums)
        torch.cuda.synchronize()
        require(torch.equal(h, ph), "gnn %s: slab kernel != plain (max "
                "diff %g)" % (name, float((h - ph).abs().max())))
        got, want = sums.cpu().numpy(), psums.cpu().numpy()
        require(np.array_equal(got, want), "gnn %s: sums kernel %s != "
                "plain %s" % (name, got, want))
        err = max(err, int(np.abs(got.astype(np.int64) - want).max()))
        maxf, active, csum, nmsg = want
        require((maxf < 511).any() and len(set(active.tolist())) > 1,
                "gnn %s: the fixture saturates or dies out: max_feat %s "
                "active %s" % (name, maxf, active))
        if name == "F=128 identity":
            exact = int(slab.astype(np.int64).sum())
            require(exact >= 2 ** 31 and csum[0] == exact - 2 ** 32
                    and nmsg[0] == 0,
                    "gnn %s: held checksum %d, exact %d" % (name, csum[0],
                                                            exact))
        if name == "ragged":
            held = int(slab.astype(np.int64).sum())
            require(csum[0] == held and nmsg[0] == 0 and nmsg[5] == EB
                    and nmsg[36] == EB // 3 and (nmsg[37:] == 0).all()
                    and (csum[37:] == csum[36]).all(),
                    "gnn ragged: hold/loops/padding %s %s" % (csum, nmsg))
        print("phase gnn %s: ok  max_feat %d..%d  active %d..%d  "
              "checksum %d..%d" % (name, maxf.min(), maxf.max(),
                                   active.min(), active.max(), csum.min(),
                                   csum.max()))
        if name == "zipf F=64 relu":
            timed = (rnd, h, Wt, bt, st, dt, vt, act, sums)

    rnd, h, Wt, bt, st, dt, vt, act, sums = timed
    ms = cuda_ms(lambda: rnd(h, Wt, bt, st, dt, vt, act, sums), 10)
    plain_ms = cuda_ms(lambda: gr.gnn_rounds_plain(
        h, Wt, bt, st, dt, vt, act, sums), 2)
    F = GNN_F
    # each input read once, each output written once: the edge slab, the
    # feature slab in and out (16.8 MB: it and the aggregate stay in L2
    # across the chunk's windows), W and b, the [4, W] sums
    # (utils/costmodel.gnn_work)
    b_ms, b_by = bound(*cm_work("gnn", CHUNK, EB, VB, F))
    prof = profile_run(lambda: rnd(h, Wt, bt, st, dt, vt, act, sums))
    per_window = {k: {"launches": n, "us_per_launch":
                      1e3 * prof["device_ms_by_name"][k] / n}
                  for k, n in prof["launches_by_name"].items()}
    p = torch.rand(VB + 1, F, device=dev).mul_(511).floor_()
    yard = {"addmm_f32_us": 1e3 * cuda_ms(lambda: torch.addmm(bt, p, Wt),
                                          20)}
    ph, Wh, bh = p.half(), Wt.half(), bt.half()
    yard["addmm_f16_us"] = 1e3 * cuda_ms(lambda: torch.addmm(bh, ph, Wh), 20)
    # one window's update alone: the slab read and written, the aggregate
    # read in the rows the window's messages reach (this chunk's mean);
    # the product's 2(vb+1)F² operations take 0.5 µs at the fp16 rate
    reached = np.mean([int(torch.unique(dt[w][vt[w]]).numel())
                       for w in range(CHUNK)])
    yard["update_bound_us"] = 1e3 * bound(
        4 * F * (2 * (VB + 1) + reached), 2 * (VB + 1) * F * F,
        "fp16_tc")[0]
    print(json.dumps({"gnn_kernels_us_per_window": per_window,
                      "gnn_yardsticks": yard}))
    print("phase gnn: ok  kernel %.3f ms/chunk  plain %.3f ms/chunk  "
          "(%d windows, eb=%d, vb=%d, F=%d)" % (ms, plain_ms, CHUNK, EB, VB,
                                                F))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err,
            "us_per_window": per_window, **yard}


def phase_gnn_stream(dev) -> dict:
    """The GNN engine's main path: GnnSummaryEngine(32768, 65536,
    feature_dim=64).process over the 320-window stream from
    default_features(vb, 64, seed=0) with fixed random snapped weights;
    every window against the plain round on the card, the first four
    against the numpy twin GnnHostEngine, the final slab against the
    plain one, the kernel's launches counted; one run under forced_sync,
    equal and timed."""
    from gelly_streaming_tpu_torch import (GnnHostEngine, GnnSummaryEngine,
                                           forced_sync, kernels)
    from gelly_streaming_tpu_torch.ops import gnn_round as gr
    from gelly_streaming_tpu_torch.ops import gnn_window as gw

    src, dst = bench_stream()
    W, b = gnn_weights(GNN_F, -12, -3)
    slab = gw.default_features(VB, GNN_F, seed=0)
    eng = GnnSummaryEngine(EB, VB, feature_dim=GNN_F)   # device=None
    require(eng.device.type == "cuda", "GNN engine not on the card")
    eng.set_weights(W / 32, b / 32)
    require(np.array_equal(eng.weights()[0], W), "weights not kept")

    def start():
        eng.reset()
        eng.load_feature_units(slab)

    start()
    eng.process(src, dst)         # warm-up: builds and fills every ring slot
    start()
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.process(src, dst)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    num_w = STREAM_EDGES // EB
    require(len(out) == num_w, "%d windows, want %d" % (len(out), num_w))
    require(launches["gnn_round"] > 0,
            "kernel gnn_round was not launched on the GNN path")
    final = eng.state_dict()["carry"][0]

    h = torch.from_numpy(slab).to(dev)
    Wt, bt = torch.from_numpy(W).to(dev), torch.from_numpy(b).to(dev)
    for w in range(num_w):
        s, d = (torch.from_numpy(x[w * EB:(w + 1) * EB]).to(dev)
                for x in (src, dst))
        v = torch.ones(EB, dtype=torch.bool, device=dev)
        h, outs = gr.gnn_round_plain(h, Wt, bt, s, d, v, EB, "relu")
        want = dict(zip(("max_feat", "active_vertices", "feat_checksum",
                         "msg_edges"), (int(x) for x in outs)))
        require(out[w] == want, "gnn stream window %d: engine %s != plain "
                "%s" % (w, out[w], want))
    require(np.array_equal(final, h.cpu().numpy()),
            "gnn stream: final slab differs from plain")
    twin = GnnHostEngine(EB, VB, feature_dim=GNN_F)
    twin.set_weights(W / 32, b / 32)
    twin.load_feature_units(slab)
    oracle = twin.process(src[:4 * EB], dst[:4 * EB])
    require(out[:4] == oracle, "gnn stream: first windows %s != numpy %s"
            % (out[:4], oracle))
    maxf = [o["max_feat"] for o in out]
    active = [o["active_vertices"] for o in out]
    require(max(maxf) < 511 and len(set(active)) > 1 and active[-1] > 0,
            "gnn stream saturates or dies out: max_feat %s, active %s"
            % (maxf, active))

    start()
    with forced_sync():
        t0 = time.perf_counter()
        sync_out = eng.process(src, dst)
        sync_wall = time.perf_counter() - t0
    require(sync_out == out and np.array_equal(
        eng.state_dict()["carry"][0], final),
        "gnn stream: forced_sync summaries or slab differ")
    repeats = []
    for _ in range(2):
        start()
        t0 = time.perf_counter()
        eng.process(src, dst)
        repeats.append(time.perf_counter() - t0)
    prof = profile_both(lambda: eng.process(src, dst), start)
    rate = STREAM_EDGES / wall
    print(json.dumps({"gnn_stream": {
        "edges": STREAM_EDGES, "windows": num_w, "eb": EB, "vb": VB,
        "feature_dim": GNN_F, "seconds": wall, "edges_per_s": rate,
        "edge_features_per_s": rate * GNN_F, "repeat_seconds": repeats,
        "forced_sync_seconds": sync_wall,
        "forced_sync_edges_per_s": STREAM_EDGES / sync_wall,
        "max_feat": [min(maxf), max(maxf)],
        "active_vertices": [min(active), max(active)],
        "last_window": out[-1], "launches": launches,
        "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"gnn_profile": prof}))
    print("phase gnn_stream: ok  %d windows  %.1f edges/s  %.4g "
          "edge-features/s  (forced_sync %.1f edges/s)"
          % (num_w, rate, rate * GNN_F, STREAM_EDGES / sync_wall))
    return launches, out, final, {"edges_per_s": rate,
                                  "idle_share": prof["pipelined"][
                                      "idle_share"]}


def dense_windows():
    """(name, src, dst, V): the windows phase dense counts."""
    from gelly_streaming_tpu_torch import make_stream

    src, dst = make_stream(EB, DENSE_V, seed=21)
    yield "zipf window", src, dst, DENSE_V
    rng = np.random.default_rng(22)
    for name, v, p in (("random p=0.05", DENSE_V, 0.05),
                       ("V=1000", 1000, 0.05)):
        iu, ju = np.triu_indices(v, k=1)
        keep = rng.random(iu.size) < p
        yield name, iu[keep], ju[keep], v
    yield "empty", np.zeros(0, np.int64), np.zeros(0, np.int64), 256
    yield "self-loops", np.arange(200), np.arange(200), 256
    s, d = np.array([0, 1, 2, 1, 2, 0]), np.array([1, 2, 0, 0, 1, 2])
    yield "duplicates", np.tile(s, 50), np.tile(d, 50), 256
    # the smallest buckets: vp=128 (one tile, no k split) and vp=512
    # (bucket of 300; k split in four)
    for name, v, p in (("V=100", 100, 0.3), ("V=300", 300, 0.1)):
        iu, ju = np.triu_indices(v, k=1)
        keep = rng.random(iu.size) < p
        yield name, iu[keep], ju[keep], v


def phase_dense(dev):
    """The dense path: triangle_count over dense windows (Zipf, random
    p=0.05 at V=4096, V=1000, empty, self-loop-only, duplicates, V=100,
    V=300) with the launch counts set to 0 just before and read just
    after, each count equal to triangle_count_sparse on the card and to
    the numpy oracle; the switch to the sparse route past 4096 vertices;
    then the kernel's partials against the plain ones on every window's
    int8 adjacency, an asymmetric matrix refused, and times at V=1024
    and V=4096 (the kernel alone and through the wrapper's symmetry
    check) beside torch.mm on float32 and torch._int_mm on int8, the
    product alone."""
    from gelly_streaming_tpu_torch import (kernels, make_stream,
                                           triangle_count)
    from gelly_streaming_tpu_torch.ops import dense_triangles as dt
    from gelly_streaming_tpu_torch.ops import host_triangles
    from gelly_streaming_tpu_torch.ops import triangles as tri

    windows = list(dense_windows())
    kernels.reset_launches()
    t0 = time.perf_counter()
    counts = [triangle_count(s, d, v) for _n, s, d, v in windows]
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(launches["dense_triangles"] == len(windows)
            and launches["intersect"] == 0,
            "dense path launches %s" % launches)
    for (name, s, d, v), got in zip(windows, counts):
        sparse = tri.triangle_count_sparse(s, d, v)
        oracle = host_triangles.window_count(s, d)
        require(got == sparse == oracle, "dense %s: kernel %d, sparse %d, "
                "numpy %d" % (name, got, sparse, oracle))
    require(counts[1] > 10 ** 6 and counts[3:6] == [0, 0, 1]
            and min(counts[6:]) > 0, "dense fixtures: counts %s" % counts)

    # the dispatcher's switch: dense at 4096 vertices, sparse at 4097
    _n, s, d, _v = windows[0]
    for v, route, other in ((DENSE_V, "dense_triangles", "intersect"),
                            (DENSE_V + 1, "intersect", "dense_triangles")):
        before = dict(kernels.LAUNCHES)
        require(triangle_count(s, d, v) == counts[0],
                "triangle_count at V=%d" % v)
        require(kernels.LAUNCHES[route] > before[route]
                and kernels.LAUNCHES[other] == before[other],
                "triangle_count at V=%d did not take the %s route"
                % (v, route))

    # the sparse route's own run, the intersect kernel's main path: the
    # Zipf window at 4097 vertices and the first two windows of the
    # bench's stream at 65536, with the launch counts set to 0 just
    # before and read just after, each count equal to numpy
    bs, bd = make_stream(2 * EB, VB, seed=SEED)
    sparse = [(s, d, DENSE_V + 1), (bs[:EB], bd[:EB], VB),
              (bs[EB:], bd[EB:], VB)]
    kernels.reset_launches()
    sparse_counts = [triangle_count(a, b, v) for a, b, v in sparse]
    sparse_launches = dict(kernels.LAUNCHES)
    require(sparse_launches["intersect"] == len(sparse)
            and sparse_launches["dense_triangles"] == 0,
            "sparse route launches %s" % sparse_launches)
    for (a, b, v), got in zip(sparse, sparse_counts):
        want = host_triangles.window_count(a, b)
        require(got == want, "sparse route at V=%d: %d != numpy %d"
                % (v, got, want))

    err = 0
    for name, s, d, v in windows:
        a = dt.adjacency(*(torch.from_numpy(np.asarray(x, np.int64))
                           .to(dev) for x in (s, d)), v, torch.int8)
        got, want = dt.six_t_partials(a), dt.six_t_partials_plain(a)
        torch.cuda.synchronize()
        require(torch.equal(got, want), "dense %s: partials kernel != "
                "plain" % name)
        err = max(err, float((got - want).abs().max()))
    a = torch.zeros(256, 256, dtype=torch.int8, device=dev)
    a[0, 200] = 1
    try:
        dt.six_t_partials(a)
        refused = False
    except ValueError:
        refused = True
    require(refused, "dense: six_t_partials took an asymmetric matrix")

    times = {}
    for v in (1024, DENSE_V):
        iu, ju = np.triu_indices(v, k=1)
        keep = np.random.default_rng(v).random(iu.size) < 0.05
        a8 = dt.adjacency(*(torch.from_numpy(x[keep]).to(dev)
                            for x in (iu, ju)), v, torch.int8)
        a32 = a8.to(torch.float32)
        # A at 1 byte an entry read once, the float32 partials written;
        # the product on the g(g+1)/2 tiles i <= j that a symmetric A
        # needs, 2·128²·v operations each: v³(1 + 1/g)
        g = v // dt.TILE
        b_ms, b_by = bound(v * v + v * v // 128 * 4,
                           2 * dt.TILE ** 2 * v * g * (g + 1) // 2,
                           "int8_tc")
        # the kernel alone, as triangle_count_dense calls it, and through
        # the wrapper with its symmetry check (A against A.T, a sync)
        times[v] = {"ms": cuda_ms(lambda: dt._symmetric_partials(a8), 20),
                    "checked_ms": cuda_ms(lambda: dt.six_t_partials(a8),
                                          20),
                    "plain_ms": cuda_ms(
                        lambda: dt.six_t_partials_plain(a8), 10),
                    "mm_ms": cuda_ms(lambda: torch.mm(a32, a32), 10),
                    "int_mm_ms": cuda_ms(lambda: torch._int_mm(a8, a8), 20),
                    "bound_ms": b_ms, "bound_by": b_by}
    vp = DENSE_V
    print(json.dumps({"dense": {
        "windows": [(n, v, c) for (n, _s, _d, v), c in zip(windows, counts)],
        "seconds": wall, "launches": launches, "times": times,
        "device": torch.cuda.get_device_name(0)}}))
    for v, t in sorted(times.items()):
        print("phase dense: V=%d  kernel %.4f ms  checked %.4f ms  plain "
              "%.4f ms  torch.mm (float32) %.4f ms  torch._int_mm %.4f ms  "
              "bound %.4f ms (%s)"
              % (v, t["ms"], t["checked_ms"], t["plain_ms"], t["mm_ms"],
                 t["int_mm_ms"], t["bound_ms"], t["bound_by"]))
    print("phase dense: ok  %d windows; sparse route %s, launches %s"
          % (len(windows), sparse_counts, sparse_launches))
    return {**times[vp], "max_abs_err": err}, launches, sparse_launches


def cohort_zipf_slab(nb: int, wb: int, vb: int, seed: int):
    """An [nb, wb, CO_EB] slab of Zipf rows: row n is
    make_stream(wb·CO_EB, vb, seed + n), all slots valid."""
    from gelly_streaming_tpu_torch import make_stream

    s = np.empty((nb, wb * CO_EB), np.int32)
    d = np.empty_like(s)
    for n in range(nb):
        s[n], d[n] = make_stream(wb * CO_EB, vb, seed=seed + n)
    return (s.reshape(nb, wb, CO_EB), d.reshape(nb, wb, CO_EB),
            np.ones((nb, wb, CO_EB), bool))


def cohort_fixtures():
    """(name, vb, the slab folded first, the slab under test): the three
    dispatches of phase cohort."""
    yield ("zipf nb=64", CO_VB, cohort_zipf_slab(64, 8, CO_VB, 400),
           cohort_zipf_slab(64, 8, CO_VB, 500))
    # ragged: rows of 8, 1, 5, 2, 7, 3 and 6 windows, row 0's last one
    # partial, row 2's second self-loops only; row 7 a pad row
    s, d, v = cohort_zipf_slab(8, 8, CO_VB, 600)
    for n, w in enumerate((8, 1, 5, 2, 7, 3, 6, 0)):
        s[n, w:] = d[n, w:] = CO_VB
        v[n, w:] = False
    s[0, 7, CO_EB // 3:] = d[0, 7, CO_EB // 3:] = CO_VB
    v[0, 7, CO_EB // 3:] = False
    s[2, 1] = d[2, 1] = np.arange(CO_EB) % CO_VB
    ps, pd, pv = cohort_zipf_slab(8, 8, CO_VB, 700)
    ps[7] = pd[7] = CO_VB
    pv[7] = False
    yield "ragged", CO_VB, (ps, pd, pv), (s, d, v)
    yield ("zipf nb=8 vb=65536", CO_BIG_VB,
           cohort_zipf_slab(8, 8, CO_BIG_VB, 800),
           cohort_zipf_slab(8, 8, CO_BIG_VB, 900))
    yield ("zipf nb=1", CO_VB, cohort_zipf_slab(1, 8, CO_VB, 1000),
           cohort_zipf_slab(1, 8, CO_VB, 1100))
    # late odd at vb=65536 (the L2 tier, many blocks): rows 0-2 Zipf, odd
    # from the carry on; row 3 bipartite (src even, dst odd), the prefix
    # joining 10 and 20 through 31, until window CO_LATE_ODD, whose one
    # edge (10, 20) closes an odd cycle. The last row not odd turns odd
    # mid-chunk: from the next window every block drops the odd check
    # and its grid barrier, all of them at once or the grid hangs
    ps, pd, pv = cohort_zipf_slab(4, 8, CO_BIG_VB, 1200)
    s, d, v = cohort_zipf_slab(4, 8, CO_BIG_VB, 1300)
    rng = np.random.default_rng(1400)
    for x, y in ((ps, pd), (s, d)):
        x[3] = 2 * rng.integers(0, CO_BIG_VB // 2, x[3].shape)
        y[3] = 2 * rng.integers(0, CO_BIG_VB // 2, y[3].shape) + 1
    ps[3, 0, :2], pd[3, 0, :2] = (10, 20), (31, 31)
    s[3, CO_LATE_ODD, -1], d[3, CO_LATE_ODD, -1] = 10, 20
    yield "late odd nb=4 vb=65536", CO_BIG_VB, (ps, pd, pv), (s, d, v)


def compare_cohort(name, slab, summ, carries, plain_carries, dev):
    """Kernel (`summ`, a CohortSummary on the card, folding into
    `carries`) vs plain (folding into `plain_carries`) on one [nb, W, eb]
    slab: the five [nb, W] outputs equal on every window, then the
    stacked carries bit-equal. Returns the plain outputs as
    numpy, the max abs error and the plain version's ms (CUDA events)."""
    from gelly_streaming_tpu_torch.ops import cohort_summary as cs

    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in slab)
    got = [x.cpu().numpy() for x in summ(carries, st, dt, vt)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = cs.summarize_cohort_plain(plain_carries, st, dt, vt, summ.vb,
                                     summ.kb)
    end.record()
    end.synchronize()
    want = [x.cpu().numpy() for x in want]
    names = ("max_degree", "num_components", "odd", "triangles",
             "k_overflow")
    err = 0
    for i, (g, w) in enumerate(zip(got, want)):
        require(np.array_equal(g, w), "cohort %s: %s kernel %s != plain %s"
                % (name, names[i], g, w))
        err = max(err, int(np.abs(g.astype(np.int64) - w).max(initial=0)))
    for label, a, b in zip(("deg", "labels", "cover"), carries,
                           plain_carries):
        require(torch.equal(a, b), "cohort %s: carry %s differs from plain"
                % (name, label))
    return want, err, start.elapsed_time(end)


def phase_cohort(dev) -> dict:
    """The cohort summary kernel (+ the counter for triangles) vs its
    plain version at eb=4096, kb=128 on five dispatches, each from
    carries that are not fresh: 64 Zipf tenants × 8 windows at vb=8192,
    the ragged batch (both in the shared-memory tier), 8 Zipf tenants ×
    8 windows at vb=65536 (the L2 tier), one tenant × 8 windows at
    vb=8192, 4 tenants × 8 windows at vb=65536 with a late-odd row (the
    L2 tier). Carries bit-equal; per dispatch the whole call, the kernel
    alone, the triangle stage alone and the plain version timed, and
    the bound of the work the call needs (`summary_work`)."""
    from gelly_streaming_tpu_torch.ops import cohort_summary as cs

    err = 0
    rows = []
    for name, vb, prefix, slab in cohort_fixtures():
        nb, wb, eb = slab[0].shape
        summ = cs.CohortSummary(vb, CO_KB, dev)
        carries = cs.fresh_cohort_carry(nb, vb, dev)
        plain = cs.fresh_cohort_carry(nb, vb, dev)
        _pre, e1, _ms = compare_cohort(name + " prefix", prefix, summ,
                                       carries, plain, dev)
        out, e2, plain_ms = compare_cohort(name, slab, summ, carries, plain,
                                           dev)
        err = max(err, e1, e2)
        mdeg, ncomp, odd, tri, ovf = out
        if name == "ragged":
            require(int(carries[2][7, 2 * vb + 1]) == vb
                    and int(carries[0][7].sum()) == 0
                    and (mdeg[1, 1:] == mdeg[1, 0]).all()
                    and odd[2, 1] and tri[2, 1] == 0,
                    "cohort ragged: pad row/hold/self-loops %s %s %s"
                    % (mdeg, odd, tri))
        if name.startswith("late odd"):
            require(odd[:3].all() and not odd[3, :CO_LATE_ODD].any()
                    and odd[3, CO_LATE_ODD:].all(),
                    "cohort late odd: odd %s" % odd)

        st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                      for x in slab)
        base = tuple(c.clone() for c in carries)
        sums = torch.empty(nb, 3, wb, dtype=torch.int32, device=dev)
        clone_ms = cuda_ms(lambda: tuple(c.clone() for c in base), 10)
        kern_ms = cuda_ms(lambda: cs.summarize_cohort(
            tuple(c.clone() for c in base), st, dt, vt, vb, sums), 10)
        ms = cuda_ms(lambda: summ(tuple(c.clone() for c in base), st, dt,
                                  vt), 10)
        counter_ms = cuda_ms(lambda: summ.count(st, dt, vt), 10)
        flat = [x.view(nb * wb, eb) for x in (st, dt, vt)]
        slots = int(vt.sum())
        edges, compares = row_work(*flat, vb, CO_KB)
        b_ms, b_by = bound(*cm_work("summary", wb, eb, vb, "standard",
                                    slots=slots, compares=compares,
                                    rows=nb))
        tier = summary_tier(vb, dev)
        rows.append({"dispatch": name, "nb": nb, "wb": wb, "vb": vb,
                     "tier": tier, "ms": ms - clone_ms,
                     "kernel_only_ms": kern_ms - clone_ms,
                     "counter_ms": counter_ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "valid_slots": slots,
                     "distinct_edges": edges, "compares": compares,
                     "overflow_windows": int((ovf > 0).sum())})
        print("phase cohort %s: ok  num_components %d..%d  odd windows %d  "
              "overflow windows %d  call %.3f ms (kernel alone %.3f, %s "
              "tier; counter alone %.3f)  plain %.1f ms  bound %.4f ms (%s)"
              % (name, ncomp.min(), ncomp.max(), int(odd.sum()),
                 int((ovf > 0).sum()), ms - clone_ms, kern_ms - clone_ms,
                 tier, counter_ms, plain_ms, b_ms, b_by))
    print(json.dumps({"cohort_dispatches": rows,
                      "device": torch.cuda.get_device_name(0)}))
    main = rows[0]
    return {"ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "max_abs_err": err, "kernel_only_ms": main["kernel_only_ms"]}


def cohort_streams() -> dict:
    """{tenant: (src, dst, vb)}: tenant i streams make_stream(CO_EDGES −
    (i mod 5)·CO_RAGGED, vb_i, seed=100+i), vb_i = CO_BIG_VB for the
    last CO_BIG tenants and CO_VB for the others."""
    from gelly_streaming_tpu_torch import make_stream

    out = {}
    for i in range(CO_TENANTS):
        vb = CO_BIG_VB if i >= CO_TENANTS - CO_BIG else CO_VB
        s, d = make_stream(CO_EDGES - (i % 5) * CO_RAGGED, vb,
                           seed=100 + i)
        out["t%02d" % i] = (s.astype(np.int32), d.astype(np.int32), vb)
    return out


def serve_cohort(streams: dict, demote: str = None, co=None,
                 cursor: dict = None, stop_after: int = None):
    """Drive a TenantCohort(CO_EB, CO_VB) on the card as a server would:
    admit every tenant at its vertex bucket; then, until every stream is
    in, feed each tenant CO_FEED edges at a time until its queue pushes
    back (TenantBackpressure) and pump(); `demote` goes to its own engine
    after the second pump; every tenant is closed at the end. `co` is a
    cohort to serve instead of a new one (admitting the tenants it does
    not know), `cursor` the edges of each stream already accepted (moved
    on in place), and `stop_after` a number of pumps after which the
    serving stops, nothing closed (a kill). Returns (summaries per
    tenant, the cohort, host-clock seconds by stage)."""
    from gelly_streaming_tpu_torch import TenantBackpressure, TenantCohort

    if co is None:
        co = TenantCohort(CO_EB, CO_VB)        # device=None: the card
    for tid, (_s, _d, vb) in streams.items():
        if tid not in co.tenants:
            co.admit(tid, vertex_bucket=vb)
    secs = {"feed": 0.0, "prep": 0.0, "pump": 0.0, "close": 0.0}
    prep = co._prep_slab

    def timed_prep(*args):                    # the slab's host prep alone
        t0 = time.perf_counter()
        got = prep(*args)
        secs["prep"] += time.perf_counter() - t0
        return got

    co._prep_slab = timed_prep
    out = {tid: [] for tid in streams}
    if cursor is None:
        cursor = dict.fromkeys(streams, 0)
    pumps = 0
    start = time.perf_counter()
    while any(cursor[tid] < len(s) for tid, (s, _d, _v) in streams.items()):
        t0 = time.perf_counter()
        for tid, (s, d, _vb) in streams.items():
            while cursor[tid] < len(s):
                c = cursor[tid]
                try:
                    co.feed(tid, s[c:c + CO_FEED], d[c:c + CO_FEED])
                except TenantBackpressure:
                    break
                cursor[tid] = min(len(s), c + CO_FEED)
        t1 = time.perf_counter()
        for tid, res in co.pump().items():
            out[tid].extend(res)
        pumps += 1
        secs["feed"] += t1 - t0
        secs["pump"] += time.perf_counter() - t1
        if pumps == 2 and demote:
            co.demote(demote)
        if pumps == stop_after:
            secs["wall"] = time.perf_counter() - start
            secs["pumps"] = pumps
            return out, co, secs
    t0 = time.perf_counter()
    for tid in streams:
        out[tid].extend(co.close(tid))
    secs["close"] = time.perf_counter() - t0
    secs["wall"] = time.perf_counter() - start
    secs["pumps"] = pumps
    return out, co, secs


def phase_cohort_stream(dev) -> dict:
    """The cohort's main path: 64 tenants (56 at vb=8192, 8 at
    vb=65536, so each pump makes two group dispatches) served through
    TenantCohort(4096, 8192) by `serve_cohort`, tenant 3 demoted after
    the second pump. Every tenant's summaries equal the port's
    StreamSummaryEngine on the card over its stream, its degrees and
    labels equal that engine's; the first four windows of tenants 0 and
    56 equal the numpy summary oracle; the cohort kernel was launched;
    the one demotion recorded is t03's, by the operator (and is cleared
    for the phase's no_demotions check)."""
    from gelly_streaming_tpu_torch import StreamSummaryEngine, kernels
    from gelly_streaming_tpu_torch.ops import host_summary
    from gelly_streaming_tpu_torch.utils import resilience

    streams = cohort_streams()
    total = sum(len(s) for s, _d, _v in streams.values())
    serve_cohort({tid: (s[:4 * CO_EB], d[:4 * CO_EB], vb)      # warm-up
                  for tid, (s, d, vb) in list(streams.items())[-2:]})
    torch.cuda.synchronize()

    kernels.reset_launches()
    out, co, secs = serve_cohort(streams, demote="t03")
    launches = dict(kernels.LAUNCHES)
    require(launches["cohort_summary"] > 0,
            "kernel cohort_summary was not launched on the cohort path")
    require(co.tenant_tier("t03") == "single", "t03 was not demoted")
    require([(e["component"], e["from"], e["to"], e["reason"])
             for e in resilience.demotion_events()]
            == [("tenant:t03", "cohort", "single", "operator")],
            "cohort_stream demotions: %s" % resilience.demotion_events())
    resilience.reset_demotions()

    engines = {}
    windows = 0
    for tid, (s, d, vb) in streams.items():
        if vb not in engines:
            engines[vb] = StreamSummaryEngine(CO_EB, vb)
        eng = engines[vb]
        eng.reset()
        want = eng.process(s, d)
        windows += len(want)
        require(out[tid] == want, "cohort tenant %s: %d windows differ from "
                "the engine's" % (tid, sum(a != b for a, b in
                                           zip(out[tid], want))))
        mine = co.tenant_state_dict(tid)
        theirs = eng.state_dict()
        require(mine["windows_done"] == theirs["windows_done"]
                and all(np.array_equal(a, b) for a, b in
                        zip(mine["carry"][:2], theirs["carry"][:2])),
                "cohort tenant %s: cursor, degrees or labels differ" % tid)
    for tid in ("t00", "t%02d" % (CO_TENANTS - CO_BIG)):
        s, d, vb = streams[tid]
        oracle, _carry = host_summary.summarize_stream(
            s[:4 * CO_EB], d[:4 * CO_EB], CO_EB, vb)
        require(out[tid][:4] == oracle, "cohort tenant %s: first windows %s "
                "!= numpy %s" % (tid, out[tid][:4], oracle))

    repeats = [serve_cohort(streams)[2]["wall"] for _ in range(2)]
    prof = profile_run(lambda: serve_cohort(streams))
    rate = total / secs["wall"]
    print(json.dumps({"cohort_stream": {
        "tenants": len(streams), "edges": total, "windows": windows,
        "eb": CO_EB, "vb": [CO_VB, CO_BIG_VB], "kb": CO_KB,
        "seconds": secs["wall"], "edges_per_s": rate,
        "host_seconds": secs, "repeat_seconds": repeats,
        "launches": launches, "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"cohort_profile": prof}))
    print("phase cohort_stream: ok  %d tenants  %d windows  %.1f tenant "
          "edges/s  %d pumps" % (len(streams), windows, rate, secs["pumps"]))
    return launches, streams, out, rate


def phase_gnn_cohort(dev) -> dict:
    """The GNN cohort: GnnTenantCohort(4096, 8192, feature_dim=64) over
    64 tenants of 16 windows (two pumps of 8 windows each), each tenant
    from default_features(8192, 64, seed=i), with the fixed snapped
    weights of phase gnn_stream. Every tenant's summaries and final slab
    equal a GnnSummaryEngine's on the card over the same stream; the GNN
    kernel was launched."""
    from gelly_streaming_tpu_torch import GnnSummaryEngine, kernels

    W, b, streams, slabs = gnn_cohort_inputs()
    total = GNN_CO_WINDOWS * CO_EB * CO_TENANTS

    def serve():
        return serve_gnn_cohort(W, b, streams, slabs)

    kernels.reset_launches()
    out, co, wall = serve()
    launches = dict(kernels.LAUNCHES)
    require(launches["gnn_round"] > 0,
            "kernel gnn_round was not launched on the GNN cohort path")

    eng = GnnSummaryEngine(CO_EB, CO_VB, feature_dim=GNN_F)
    eng.set_weights(W / 32, b / 32)
    for tid, slab in zip(streams, slabs):
        eng.reset()
        eng.load_feature_units(slab)
        want = eng.process(*streams[tid])
        require(out[tid] == want, "gnn cohort tenant %s differs from the "
                "engine" % tid)
        require(np.array_equal(co.tenant_state_dict(tid)["carry"][0],
                               eng.state_dict()["carry"][0]),
                "gnn cohort tenant %s: final slab differs" % tid)
        require(co.close(tid) == [], "gnn cohort tenant %s: a remainder"
                % tid)
    maxf = [r["max_feat"] for rows in out.values() for r in rows]
    active = [r["active_vertices"] for rows in out.values() for r in rows]
    require(max(maxf) < 511 and len(set(active)) > 1,
            "gnn cohort saturates or dies out: max_feat %d..%d"
            % (min(maxf), max(maxf)))

    repeats = [serve()[2] for _ in range(2)]
    prof = profile_run(serve)           # admission included
    rate = total / wall
    print(json.dumps({"gnn_cohort": {
        "tenants": CO_TENANTS, "edges": total,
        "windows": GNN_CO_WINDOWS * CO_TENANTS, "eb": CO_EB, "vb": CO_VB,
        "feature_dim": GNN_F, "seconds": wall, "edges_per_s": rate,
        "edge_features_per_s": rate * GNN_F, "repeat_seconds": repeats,
        "max_feat": [min(maxf), max(maxf)],
        "active_vertices": [min(active), max(active)],
        "launches": launches, "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"gnn_cohort_profile": prof}))
    print("phase gnn_cohort: ok  %d tenants  %.1f edges/s  %.4g "
          "edge-features/s" % (CO_TENANTS, rate, rate * GNN_F))
    return launches, out


def gnn_cohort_inputs() -> tuple:
    """(W, b, streams, slabs) of the GNN cohort: the fixed snapped
    weights of phase gnn_stream, 64 tenant streams of GNN_CO_WINDOWS
    windows (make_stream(..., seed=300+i)) and their
    default_features(8192, 64, seed=i) slabs."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import gnn_window as gw

    W, b = gnn_weights(GNN_F, -12, -3)
    streams = {"g%02d" % i: make_stream(GNN_CO_WINDOWS * CO_EB, CO_VB,
                                        seed=300 + i)
               for i in range(CO_TENANTS)}
    slabs = [gw.default_features(CO_VB, GNN_F, seed=i)
             for i in range(CO_TENANTS)]
    return W, b, streams, slabs


def serve_gnn_cohort(W, b, streams: dict, slabs: list) -> tuple:
    """GnnTenantCohort(4096, 8192, feature_dim=64) on the card: admit
    the tenants with their slabs, then two rounds of feeds of 8 windows
    and a pump; returns (summaries, the cohort, the seconds of the feed
    and pump rounds)."""
    from gelly_streaming_tpu_torch import GnnTenantCohort

    co = GnnTenantCohort(CO_EB, CO_VB, feature_dim=GNN_F)  # the card
    co.set_weights(W / 32, b / 32)
    for tid, slab in zip(streams, slabs):
        co.admit(tid, feature_units=slab)
    torch.cuda.synchronize()
    out = {tid: [] for tid in streams}
    half = GNN_CO_WINDOWS // 2 * CO_EB
    t0 = time.perf_counter()
    for lo, hi in ((0, half), (half, None)):
        for tid, (s, d) in streams.items():
            co.feed(tid, s[lo:hi], d[lo:hi])
        for tid, res in co.pump().items():
            out[tid].extend(res)
    return out, co, time.perf_counter() - t0


CO_DEEP_QUEUE = 32                 # phase cohort_resident (c): queue windows
CO_TPD = 16                        # (d): tenants a dispatch, four batches a round
CO_PAIRS = 3                       # (b): turns of the three forms
CO_PROBATION = 64                  # (e): past a stream's windows


def cohort_states(co, tids) -> dict:
    return {tid: co.tenant_state_dict(tid) for tid in tids}


def same_states(label, got: dict, want: dict, sentinel: bool = True):
    """Every tenant's state equal, carries bit for bit; without
    `sentinel` the cover's slot 2vb+1 (it records whether padded windows
    were folded, which the slab shapes decide) is left out."""
    for tid, a in want.items():
        b = got[tid]
        require(a["windows_done"] == b["windows_done"]
                and a["closed_partial"] == b["closed_partial"],
                "%s: tenant %s cursor differs" % (label, tid))
        for i, (x, y) in enumerate(zip(a["carry"], b["carry"])):
            if i == 2 and not sentinel:
                x, y = x[:-1], y[:-1]
            require(np.array_equal(x, y), "%s: tenant %s carry leaf %d "
                    "differs" % (label, tid, i))


def same_windows(label, got: dict, want: dict) -> int:
    for tid, rows in want.items():
        require(got[tid] == rows, "%s: tenant %s: %d of %d windows differ"
                % (label, tid, sum(a != b for a, b in zip(got[tid], rows))
                   + abs(len(got[tid]) - len(rows)), len(rows)))
    return sum(len(r) for r in want.values())


def resident_serve(streams: dict, tier: str, **kw) -> tuple:
    """serve_cohort on a new TenantCohort(CO_EB, CO_VB) with
    GS_COHORT_RESIDENT=`tier`, CUDA events around each of its dispatches
    (dispatch_events): (summaries, the cohort, host seconds, a row of
    the run's rate, dispatches, device busy ms and idle share)."""
    from gelly_streaming_tpu_torch import TenantCohort

    total = sum(len(s) for s, _d, _v in streams.values())
    queue = kw.pop("queue_windows", None)
    with knob_env(GS_COHORT_RESIDENT=tier):
        co = TenantCohort(CO_EB, CO_VB, queue_windows=queue)
        torch.cuda.synchronize()
        with dispatch_events([co._stage]) as evs:
            out, co, secs = serve_cohort(streams, co=co, **kw)
        busy = evs.busy_ms()
    row = {"edges_per_s": total / secs["wall"], "seconds": secs["wall"],
           "host_seconds": {k: secs[k] for k in ("feed", "prep", "pump",
                                                 "close")},
           "dispatches": len(evs.spans), "device_busy_ms": busy,
           "idle_share": 1 - busy / (1e3 * secs["wall"]),
           "resident_dispatches": co.resident_dispatches,
           "restacks": co.resident_restacks,
           "captures": co._graphs.captures}
    return out, co, secs, row


def sequential_serve(streams: dict, engines: dict) -> dict:
    """The same streams through one StreamSummaryEngine a vertex bucket,
    reset between tenants, one process() call a stream: the rate, CUDA
    events around every dispatch, the idle share."""
    total = sum(len(s) for s, _d, _v in streams.values())
    torch.cuda.synchronize()
    with dispatch_events([e._ring for e in engines.values()]) as evs:
        t0 = time.perf_counter()
        out = {}
        for tid, (s, d, vb) in streams.items():
            eng = engines[vb]
            eng.reset()
            out[tid] = eng.process(s, d)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = evs.busy_ms()
    return out, {"edges_per_s": total / wall, "seconds": wall,
                 "dispatches": len(evs.spans), "device_busy_ms": busy,
                 "idle_share": 1 - busy / (1e3 * wall)}


def watch_refusals(co, checked: list) -> None:
    """Around each dispatch of `co` on a resident hit, keep a device copy
    of the committed stack; when the dispatch is refused (a PoisonOutput
    or an injected dispatch fault), require the committed stack, every
    row, bit-equal to that copy, and count the check in `checked`."""
    from gelly_streaming_tpu_torch.core.tenancy import PoisonOutput
    from gelly_streaming_tpu_torch.utils import faults

    real = co._dispatch_batch

    def watched(vb, kb, slab, out, staged):
        entry = co._res.get((vb, kb))
        copy = None if entry is None else (
            entry, tuple(a.clone() for a in entry["carry"]))
        try:
            return real(vb, kb, slab, out, staged)
        except (PoisonOutput, faults.InjectedFault):
            if copy is not None and co._res.get((vb, kb)) is copy[0]:
                require(all(torch.equal(a, b) for a, b in
                            zip(copy[0]["carry"], copy[1])),
                        "cohort_resident: a refused dispatch changed the "
                        "committed stack")
                checked.append(sum(r is not None for r in copy[0]["rows"]))
            raise

    co._dispatch_batch = watched


def phase_cohort_resident(dev, streams: dict, want: dict) -> dict:
    """The cohort's resident tier (GS_COHORT_RESIDENT=on), its tuner arm
    and the ingest ring on phase cohort_stream's 64 streams (56 at
    vb=8192, 8 at vb=65536, about 8.3M edges), GS_AUTOTUNE=0 but in (d):
    (a) serve_cohort with the tier on and t03 demoted after the second
    pump: every window equal to phase cohort_stream's, every
    tenant_state_dict bit-equal to a scan cohort's served the same way,
    resident dispatches, restacks, graph captures and `cohort_resident`
    replays counted; (b) CO_PAIRS turns of the resident cohort, the scan
    cohort and 64 sequential StreamSummaryEngines (one a vertex bucket,
    reset between tenants): tenant edges/s, the spread, host seconds,
    dispatches and the idle share from CUDA events, and one row in the
    JAX `tenancy_ab` shape; (c) (a) and the resident turns again at
    queue_windows=32 (a super-batch of up to 32 windows a tenant); (d)
    GS_AUTOTUNE=1 with the tuning cache in a fresh directory (the arm
    chosen, the rounds by arm, the ring's submissions) and
    GS_TENANT_TPD=16 (four batches a round on the ring), every window
    equal; (e) phase
    hooks_cohort's drill with the tier on, each refusal on a resident
    hit: t17's output row poisoned from pump 3 and a dispatch fault on
    t05 from pump 4, each until its tenant is quarantined
    (GS_QUARANTINE_WINDOWS=64, past a stream's windows: they stay on
    probation, so pump 4 meets the stack pump 3 committed): exactly
    those two quarantined, once each,
    the committed stack bit-equal across each refused dispatch, every
    tenant's windows exact; each tenant's state after pump 2, taken
    under the tier, resumed in a scan cohort to the same windows."""
    import tempfile

    from gelly_streaming_tpu_torch import StreamSummaryEngine, TenantCohort
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.utils import faults, resilience

    t_phase = time.perf_counter()
    total = sum(len(s) for s, _d, _v in streams.values())
    report = {}
    with knob_env(GS_AUTOTUNE="0"):
        # (a) exactness, a membership change (t03 demoted) among it
        kernels.reset_launches()
        out, co, _secs, row = resident_serve(streams, "on", demote="t03")
        launches = {"launches": dict(kernels.LAUNCHES),
                    "replays": dict(kernels.REPLAYS)}
        windows = same_windows("cohort_resident (a)", out, want)
        require(co.resident_dispatches > 0
                and launches["replays"]["cohort_resident"] > 0,
                "cohort_resident (a): %d resident dispatches, replays %s"
                % (co.resident_dispatches, launches["replays"]))
        resilience.reset_demotions()
        _o, scan, _s, _r = resident_serve(streams, "off", demote="t03")
        resilience.reset_demotions()
        scan_states = cohort_states(scan, streams)
        same_states("cohort_resident (a)", cohort_states(co, streams),
                    scan_states)
        report["a"] = dict(row, **launches, windows=windows)
        print("phase cohort_resident (a): ok  %d windows equal to "
              "cohort_stream's, states equal to the scan cohort's; %d "
              "resident dispatches, %d restacks, %d graph captures, "
              "replays %d, launches %s"
              % (windows, co.resident_dispatches, co.resident_restacks,
                 co._graphs.captures,
                 launches["replays"]["cohort_resident"],
                 {k: v for k, v in launches["launches"].items() if v}))
        del co, scan

        # (b) speed: the three forms in alternating turns
        engines = {vb: StreamSummaryEngine(CO_EB, vb)
                   for vb in sorted({v for _s, _d, v in streams.values()})}
        sequential_serve(streams, engines)                   # warm-up
        turns = {"resident": [], "scan": [], "sequential": []}
        for i in range(CO_PAIRS):
            for form in (("resident", "scan", "sequential") if i % 2 == 0
                         else ("sequential", "scan", "resident")):
                if form == "sequential":
                    got, r = sequential_serve(streams, engines)
                else:
                    got, _co, _s, r = resident_serve(
                        streams, "on" if form == "resident" else "off")
                same_windows("cohort_resident (b) %s" % form, got, want)
                turns[form].append(r)
        best = {form: max(rs, key=lambda r: r["edges_per_s"])
                for form, rs in turns.items()}
        for form, rs in turns.items():
            report["b_" + form] = dict(best[form], spread_edges_per_s=[
                r["edges_per_s"] for r in rs])
        ab = {"probe": "cohort_resident", "parity": True,
              "tenants": len(streams), "tenant_edges_per_s":
              best["resident"]["edges_per_s"],
              "sequential_edges_per_s": best["sequential"]["edges_per_s"],
              "speedup": best["resident"]["edges_per_s"]
              / best["sequential"]["edges_per_s"],
              "scan_edges_per_s": best["scan"]["edges_per_s"],
              "device": torch.cuda.get_device_name(0), "card": card()}
        print(json.dumps({"cohort_resident_turns": turns}))
        print(json.dumps({"tenancy_ab": ab}))
        print("phase cohort_resident (b): ok  M tenant edges/s (best, "
              "spread of %d): %s; idle %s" % (CO_PAIRS, "; ".join(
                  "%s %.2f [%s]" % (f, best[f]["edges_per_s"] / 1e6,
                                    ", ".join("%.2f" % (r["edges_per_s"]
                                                        / 1e6) for r in rs))
                  for f, rs in turns.items()), ", ".join(
                  "%s %.3f" % (f, best[f]["idle_share"]) for f in turns)))

        # (c) deep queues: a super-batch of up to 32 windows a tenant
        out, co, _s, row = resident_serve(streams, "on",
                                          queue_windows=CO_DEEP_QUEUE)
        same_windows("cohort_resident (c)", out, want)
        require(co.resident_dispatches > 0, "cohort_resident (c): no "
                "resident dispatch")
        same_states("cohort_resident (c)", cohort_states(co, streams),
                    scan_states, sentinel=False)
        deep = [row]
        for _ in range(CO_PAIRS):
            got, _co, _s, r = resident_serve(streams, "on",
                                             queue_windows=CO_DEEP_QUEUE)
            same_windows("cohort_resident (c) turns", got, want)
            deep.append(r)
        report["c"] = {"exact": row, "turns": deep[1:]}
        print("phase cohort_resident (c): ok  queue_windows=%d: every "
              "window equal, %d resident dispatches; M tenant edges/s %s"
              % (CO_DEEP_QUEUE, co.resident_dispatches, ", ".join(
                  "%.2f" % (r["edges_per_s"] / 1e6) for r in deep[1:])))
        del co

        # (d) the tuner's arm and the ring
        tuned = {}
        with tempfile.TemporaryDirectory() as cache:
            for label, knobs_ in (("tuner", {"GS_AUTOTUNE": "1",
                                             "GS_TUNE_CACHE": cache}),
                                  ("tpd", {"GS_TENANT_TPD": str(CO_TPD)})):
                with knob_env(GS_COHORT_RESIDENT="on", **knobs_):
                    c = TenantCohort(CO_EB, CO_VB)
                    ring = []
                    submit = c._ring.submit

                    def counted(fn, key, item, ring=ring, submit=submit):
                        ok = submit(fn, key, item)
                        ring.append(ok)
                        return ok

                    c._ring.submit = counted
                    arms = {}
                    resolve = c._resolve_tpd

                    def logged(vb, n_ready, arms=arms, resolve=resolve):
                        tpd, arm = resolve(vb, n_ready)
                        key = "vb=%d ready=%d tpd=%d spb=%s" % (
                            vb, n_ready, tpd, (arm or {}).get("spb"))
                        arms[key] = arms.get(key, 0) + 1
                        return tpd, arm

                    c._resolve_tpd = logged
                    got, c, secs = serve_cohort(streams, co=c)
                same_windows("cohort_resident (d) %s" % label, got, want)
                tuned[label] = {
                    "edges_per_s": total / secs["wall"],
                    "ring_submissions": sum(ring),
                    "ring_declined": len(ring) - sum(ring),
                    "resident_dispatches": c.resident_dispatches,
                    "restacks": c.resident_restacks,
                    "rounds_by_arm": arms,
                    "tuners": {vb: {k: t.summary()[k] for k in
                                    ("key", "chosen", "rounds",
                                     "promotions")}
                               for vb, t in c._tuners.items()}}
        require(tuned["tpd"]["ring_submissions"] > 0, "cohort_resident "
                "(d): GS_TENANT_TPD=%d put nothing on the ring" % CO_TPD)
        require(tuned["tuner"]["tuners"] and all(
            t["rounds"] >= 1 and "tpd" in t["chosen"]
            for t in tuned["tuner"]["tuners"].values()),
            "cohort_resident (d): tuner %s" % tuned["tuner"]["tuners"])
        report["d"] = tuned
        print("phase cohort_resident (d): ok  every window equal; tuner "
              "%s, ring %d; GS_TENANT_TPD=%d: ring %d, %d restacks"
              % ({vb: (t["chosen"], t["rounds"]) for vb, t in
                  tuned["tuner"]["tuners"].items()},
                 tuned["tuner"]["ring_submissions"], CO_TPD,
                 tuned["tpd"]["ring_submissions"],
                 tuned["tpd"]["restacks"]))

        # (e) the poison drill on resident hits, and a resume on scan
        resilience.reset_demotions()
        armed = {"t05": False, "t17": False}

        def poison_t05(payload):
            if armed["t05"] and payload and "t05" in payload:
                raise faults.InjectedFault("poisoned", "cohort_dispatch")
            return payload

        checked = []
        t0 = time.perf_counter()
        with knob_env(GS_COHORT_RESIDENT="on",
                      GS_QUARANTINE_WINDOWS=str(CO_PROBATION)), \
                faults.inject(faults.FaultSpec(
                    site="cohort_dispatch", action="call", fn=poison_t05,
                    times=10 ** 6)):
            co = TenantCohort(CO_EB, CO_VB)
            poison_rows(co, "t17", armed)
            watch_refusals(co, checked)
            quarantine = co._quarantine

            def disarm(t, reason):      # hostile until quarantined once
                armed[t.tid] = False
                quarantine(t, reason)

            co._quarantine = disarm
            cursor = dict.fromkeys(streams, 0)
            out, co, _s = serve_cohort(streams, co=co, cursor=cursor,
                                       stop_after=2)
            resume = cohort_states(co, streams)
            armed["t17"] = True
            got, co, _s = serve_cohort(streams, co=co, cursor=cursor,
                                       stop_after=1)
            armed["t05"] = True
            more, co, _s = serve_cohort(streams, co=co, cursor=cursor,
                                        stop_after=1)
            rest, co, _s = serve_cohort(streams, co=co, cursor=cursor)
            torch.cuda.synchronize()
        drill_s = time.perf_counter() - t0
        quarantined = sorted(e["tenant"] for e in
                             resilience.demotion_events()
                             if e["to"] == "quarantined")
        resilience.reset_demotions()
        require(quarantined == ["t05", "t17"] and not any(armed.values()),
                "cohort_resident (e): quarantined %s" % quarantined)
        require(len(checked) >= 2, "cohort_resident (e): %d refusals on a "
                "resident hit checked" % len(checked))
        same_windows("cohort_resident (e)", {
            tid: out[tid] + got[tid] + more[tid] + rest[tid]
            for tid in streams}, want)
        with knob_env(GS_COHORT_RESIDENT="off"):
            scan = TenantCohort(CO_EB, CO_VB)
            for tid, (_s, _d, vb) in streams.items():
                scan.admit(tid, vertex_bucket=vb)
                scan.load_tenant_state_dict(tid, resume[tid])
            cursor = {tid: scan.resume_offset(tid) for tid in streams}
            tail, scan, _s = serve_cohort(streams, co=scan, cursor=cursor)
        same_windows("cohort_resident (e) resume", tail, {
            tid: rows[resume[tid]["windows_done"]:]
            for tid, rows in want.items()})
        no_demotions("cohort_resident (e) resume")
        report["e"] = {"quarantined": quarantined, "seconds": drill_s,
                       "refusals_checked": checked}
        print("phase cohort_resident (e): ok  t17 (poisoned row, pump 3) "
              "and t05 (dispatch fault, pump 4) quarantined; the committed "
              "stack bit-equal across %d refused dispatches on a resident "
              "hit (rows %s); every window exact; the states after pump 2 "
              "resumed in a scan cohort exact; %.2f s"
              % (len(checked), checked, drill_s))
    report["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"cohort_resident": report}))
    print("phase cohort_resident: ok  %.1f s" % report["seconds"])
    return report


SNAP_SMALL_VB = 8192               # the driver's early buckets (the L2 tier)
SNAP_WINDOWS = 16                  # windows of the snapshot phase's fixtures
FILE_EDGES = 1_048_576             # phase driver_file's timestamped file
FILE_WINDOW = 8192                 # its mean window, in edges
FILE_CHUNK_BYTES = 128 << 10       # stream_file's piece: about a window
# the driver phase's count-based feed: calls of 1, 1, 2, ..., 64 windows
DRIVER_FEED = (1, 1, 2, 4, 8, 16, 32, 64, 64, 64, 64)
# a delta cap below the changed slots of the stream's windows: its chunks
# overflow and are run again on full rows
DRIVER_SMALL_CAP = 1024
SNAP_EDGE_EB = 2048                # the grid fixtures' windows
SNAP_EDGE_WINDOWS = 2
# the grid fixtures' vertex buckets: the driver's early and main buckets
# less a few slots, so that the blocks' runs are ragged
SNAP_EDGE_VBS = (SNAP_SMALL_VB - 3, VB - 5)


def snapshot_fixtures():
    """(name, vb, analytics, [W, eb] chunk, prefix chunk) of the snapshot
    phase: Zipf windows at vb=65536 and at vb=8192 (the driver's main and
    early buckets), each analytics subset; edge cases at vb=8192: a
    window of one edge, empty (all-padding) windows, self-loops (odd
    cycles of one edge), a ragged chunk."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import segment as seg

    out = []
    for vb, seed in ((VB, 21), (SNAP_SMALL_VB, 22)):
        src, dst = make_stream(2 * SNAP_WINDOWS * EB, vb, seed=seed)
        _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=vb)
        prefix = (s[:SNAP_WINDOWS], d[:SNAP_WINDOWS], v[:SNAP_WINDOWS])
        chunk = (s[SNAP_WINDOWS:], d[SNAP_WINDOWS:], v[SNAP_WINDOWS:])
        subsets = ([("degrees", "cc", "bipartite"), ("degrees",), ("cc",),
                    ("bipartite",), ("degrees", "cc"),
                    ("degrees", "bipartite"), ("cc", "bipartite")]
                   if vb == VB else
                   [("degrees", "cc", "bipartite"), ("cc",),
                    ("bipartite",)])
        for analytics in subsets:
            out.append(("zipf vb=%d %s" % (vb, "+".join(analytics)), vb,
                        analytics, chunk, prefix))
    rng = np.random.default_rng(23)
    vb = SNAP_SMALL_VB
    wins = [(np.array([5], np.int32), np.array([9], np.int32)), ((), ()),
            (np.arange(40, dtype=np.int32),) * 2,
            (rng.integers(0, vb, EB).astype(np.int32),
             rng.integers(0, vb, EB).astype(np.int32)), ((), ()),
            (rng.integers(0, 50, EB // 2).astype(np.int32),
             rng.integers(0, 50, EB // 2).astype(np.int32))]
    wins = [(np.asarray(a, np.int32), np.asarray(b, np.int32))
            for a, b in wins]
    chunk = seg.stack_window_list(wins, EB, vb)
    prefix = seg.stack_window_list(wins[3:4], EB, vb)
    out.append(("edge cases vb=%d" % vb, vb, ("degrees", "cc", "bipartite"),
                chunk, prefix))
    return out


def abs_err(a, b) -> int:
    """max |a - b| of two integer or bool arrays (0 when empty)."""
    a, b = np.asarray(a).astype(np.int64), np.asarray(b).astype(np.int64)
    return int(np.abs(a - b).max()) if a.size else 0


def compare_snapshot(name, snap, plain, chunk, carry, plain_carry, dev):
    """Kernel (WindowSnapshot `snap` on the card) vs plain (`plain`, the
    same on plain_carry) on one chunk: every output equal (a delta row up
    to its window's count and the cap), then the carries bit-equal.
    Returns the plain outs and the largest |kernel - plain| over every
    output and carry entry compared."""
    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in chunk)
    got = {k: v.cpu().numpy() for k, v in snap(carry, st, dt, vt).items()}
    want = {k: v.cpu().numpy() for k, v in
            plain(plain_carry, st, dt, vt).items()}
    require(sorted(got) == sorted(want), "%s: outs %s, plain %s"
            % (name, sorted(got), sorted(want)))
    err = 0
    for k in want:
        if k.endswith(("_idx", "_val")):
            cnt = want[k.rsplit("_", 1)[0] + "_cnt"]
            for w in range(len(cnt)):
                n = min(int(cnt[w]), snap.cap)
                err = max(err, abs_err(got[k][w][:n], want[k][w][:n]))
                require(np.array_equal(got[k][w][:n], want[k][w][:n]),
                        "%s: %s window %d differs from plain" % (name, k, w))
        else:
            err = max(err, abs_err(got[k], want[k]))
            require(np.array_equal(got[k], want[k]),
                    "%s: %s differs from plain" % (name, k))
    for label, a, b in zip(("deg", "labels", "cover"), carry, plain_carry):
        require((a is None) == (b is None), "%s: carry %s on one side only"
                % (name, label))
        if a is not None:
            err = max(err, abs_err(a.cpu().numpy(), b.cpu().numpy()))
            require(torch.equal(a, b),
                    "%s: carry %s differs from plain" % (name, label))
    return want, err


def snapshot_carry(vb, analytics, dev):
    """A fresh engine-layout carry of the analytics on."""
    from gelly_streaming_tpu_torch.ops import window_snapshot as ws

    return ws.engine_carry(
        vb, np.zeros(vb, np.int32) if "degrees" in analytics else None,
        np.arange(vb, dtype=np.int32) if "cc" in analytics else None,
        np.arange(2 * vb, dtype=np.int32) if "bipartite" in analytics
        else None, dev)


SNAP_SUBSETS = [("degrees", "cc", "bipartite"), ("degrees",), ("cc",),
                ("bipartite",), ("degrees", "cc"), ("degrees", "bipartite"),
                ("cc", "bipartite")]


def snapshot_grid_checks(dev, compare_forms) -> int:
    """The tier_fixtures windows at the card's sizes against the plain
    version: each kind at each vb of SNAP_EDGE_VBS, SNAP_EDGE_WINDOWS
    windows of SNAP_EDGE_EB edges (one window for one_window), the
    blocks' runs those of the kernel's grid (one block an SM at this
    eb), from driver mirrors that are not fresh (chained forests in
    every other fixture): all three analytics on full rows with and
    without masks and on the delta wire at the default cap and at 64
    (64 passed by a window), and the first fixture in every analytics
    subset on full rows. Returns the fixtures run."""
    from gelly_streaming_tpu_torch.ops import delta_egress
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_snapshot as ws
    from gelly_streaming_tpu_torch.utils import tier_fixtures as tf

    blocks = torch.cuda.get_device_properties(dev).multi_processor_count
    i = 0
    for vb in SNAP_EDGE_VBS:
        cap = delta_egress.egress_cap(SNAP_EDGE_EB, vb)
        every = [(False, "full", 0), (True, "full", 0), (False, "delta", cap),
                 (True, "delta", 64)]
        for kind in tf.SNAPSHOT_KINDS:
            windows = tf.snapshot_windows(kind, vb, SNAP_EDGE_EB, blocks,
                                          seed=vb + i,
                                          windows=SNAP_EDGE_WINDOWS)
            mirrors = tf.driver_mirrors(vb, seed=i, compressed=i % 2 == 0)
            chunk = seg.stack_window_list(windows, SNAP_EDGE_EB, vb)
            for analytics in SNAP_SUBSETS if i == 0 else SNAP_SUBSETS[:1]:
                on = [a in analytics for a in ws.ANALYTICS]

                def carries(vb=vb, on=on, mirrors=mirrors):
                    args = [m if o else None for m, o in zip(mirrors, on)]
                    return (ws.engine_carry(vb, *args, device=dev),
                            ws.engine_carry(vb, *args, device=dev), None)

                forms = every if analytics == SNAP_SUBSETS[0] else every[:1]
                compare_forms("grid %s vb=%d %s" % (kind, vb,
                                                    "+".join(analytics)),
                              vb, analytics, chunk, carries, forms)
            i += 1
    print("phase snapshot grid fixtures: ok (%s at vb %s, %d blocks' runs)"
          % (", ".join(tf.SNAPSHOT_KINDS), SNAP_EDGE_VBS, blocks))
    return i


def launch_api_calls(fn, reps: int) -> tuple:
    """({launch entry point: calls}, {device kernel name: launches}) of
    `reps` calls of fn() under one torch.profiler run: the host-side
    CUDA API rows of the launch entry points (utils/profiling
    LAUNCH_CALLS, variants counted under their entry point), which the
    profiler keeps where it drops device records late in a process, and
    the device rows it kept."""
    from torch.profiler import ProfilerActivity, profile

    from gelly_streaming_tpu_torch.utils.profiling import LAUNCH_CALLS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    api, device = {}, {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            device[ev.key[:70]] = device.get(ev.key[:70], 0) + ev.count
            continue
        entry = max((c for c in LAUNCH_CALLS if ev.key.startswith(c)),
                    key=len, default=None)
        if entry:
            api[entry] = api.get(entry, 0) + ev.count
    return api, device


SNAP_TIER_REPS = 3


def snapshot_tier_check(dev) -> dict:
    """The snapshot kernel's one tier: at each of the driver's buckets
    (vb 4096 .. 65536) SNAP_TIER_REPS calls of one window make one
    cooperative launch each and no other launch (the profile's launch
    API rows), and the device rows the profile kept name no snapshot
    kernel but snapshot_grid_kernel. Returns {vb: (launch API calls,
    the grid kernel's device rows kept)}."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_snapshot as ws

    out = {}
    for vb in (4096, SNAP_SMALL_VB, 16384, 32768, VB):
        src, dst = make_stream(EB, vb, seed=vb)
        _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=vb)
        one = [torch.from_numpy(np.ascontiguousarray(x[:1])).to(dev)
               for x in (s, d, v)]
        analytics = ("degrees", "cc", "bipartite")
        snap = ws.WindowSnapshot(vb, analytics, dev)
        carry = snapshot_carry(vb, analytics, dev)
        snap(carry, *one)
        api, rows = launch_api_calls(lambda: snap(carry, *one),
                                     SNAP_TIER_REPS)
        grid = sum(n for k, n in rows.items() if "snapshot_grid_kernel" in k)
        others = [k for k in rows
                  if "snapshot" in k and "snapshot_grid_kernel" not in k]
        require(api == {"cudaLaunchCooperativeKernel": SNAP_TIER_REPS}
                and grid <= SNAP_TIER_REPS and not others,
                "snapshot vb=%d: %d calls made launch calls %s, device rows "
                "%s" % (vb, SNAP_TIER_REPS, api, rows))
        out[vb] = (api, grid)
    return out


def phase_snapshot(dev) -> dict:
    """The snapshot kernel (csrc/window_snapshot.cu) vs its plain version
    on every fixture of snapshot_fixtures(), each from a carry that is
    not fresh (a prefix chunk folded first), on the full rows with masks
    and without, and on the delta wire at the default cap and at a cap
    of 64 that windows overflow; then the grid fixtures
    (snapshot_grid_checks) and the one tier at every driver bucket from
    the profile (snapshot_tier_check); then the W ladder of
    utils/snapshot_probe.py at vb=65536 and 8192, and times at the main
    path's chunk (64 Zipf windows at eb=32768, vb=65536, all three
    analytics, full rows: the driver's default), the delta wire, and one
    window beside the counter at one window."""
    from gelly_streaming_tpu_torch import kernels, make_stream
    from gelly_streaming_tpu_torch.ops import delta_egress
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc
    from gelly_streaming_tpu_torch.ops import window_snapshot as ws
    from gelly_streaming_tpu_torch.utils import snapshot_probe

    t_phase = time.perf_counter()
    err = 0

    def compare_forms(name, vb, analytics, chunk, make_carries, forms):
        nonlocal err
        for deltas, egress, c in forms:
            snap = ws.WindowSnapshot(vb, analytics, dev, deltas=deltas,
                                     egress=egress, cap=c)
            carry, plain_carry, prefix = make_carries()

            def plain_on_card(pc, s, d, v, vb=vb, deltas=deltas,
                              egress=egress, c=c):
                return ws.snapshot_windows_plain(pc, s, d, v, vb, deltas,
                                                 egress, c)

            label = "%s %s%s" % (name, egress, "+masks" if deltas else "")
            if prefix is not None:
                _want, e1 = compare_snapshot(label + " prefix", snap,
                                             plain_on_card, prefix, carry,
                                             plain_carry, dev)
                err = max(err, e1)
            want, e2 = compare_snapshot(label, snap, plain_on_card, chunk,
                                        carry, plain_carry, dev)
            err = max(err, e2)
            if egress == "delta" and c == 64:
                require(max(int(want[k].max()) for k in want
                            if k.endswith("_cnt")) > 64,
                        "%s: no window passed the cap" % label)

    for name, vb, analytics, chunk, prefix in snapshot_fixtures():
        cap = delta_egress.egress_cap(EB, vb)
        forms = [(False, "full", 0), (True, "full", 0), (False, "delta", cap)]
        if analytics == ("degrees", "cc", "bipartite"):
            forms += [(True, "delta", 64)]
        compare_forms(name, vb, analytics, chunk, lambda vb=vb, a=analytics,
                      p=prefix: (snapshot_carry(vb, a, dev),
                                 snapshot_carry(vb, a, dev), p), forms)
        print("phase snapshot %s: ok" % name)
    fixtures = snapshot_grid_checks(dev, compare_forms)
    grid_launches = snapshot_tier_check(dev)
    lib = kernels.library("window_snapshot")
    ladder = {}
    for vb in (VB, SNAP_SMALL_VB):
        rows = snapshot_probe.snapshot_ladder(lib, vb, snapshot_probe.LADDER,
                                              dev)
        ladder[vb] = {"ladder": rows,
                      "fit_full": snapshot_probe.fit(rows, "full_ms"),
                      "fit_delta": snapshot_probe.fit(rows, "delta_ms")}
        print("phase snapshot W ladder vb=%d: full %s, delta %s  (%s)"
              % (vb, ladder[vb]["fit_full"],
                 ladder[vb]["fit_delta"],
                 ", ".join("W=%d %.4f/%.4f" % (r["windows"], r["full_ms"],
                                               r["delta_ms"])
                           for r in rows)))

    # times at the main path's chunk, the carry after one chunk folded
    src, dst = make_stream(2 * CHUNK * EB, VB, seed=24)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    first = [torch.from_numpy(np.ascontiguousarray(x[:CHUNK])).to(dev)
             for x in (s, d, v)]
    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x[CHUNK:])).to(dev)
                  for x in (s, d, v))
    analytics = ("degrees", "cc", "bipartite")
    snap = ws.WindowSnapshot(VB, analytics, dev)
    carry = snapshot_carry(VB, analytics, dev)
    snap(carry, *first)

    def cloned():
        return tuple(c.clone() for c in carry)

    # the timed chunk itself, kernel vs plain, from the same carry
    _want, e = compare_snapshot(
        "main chunk", snap,
        lambda pc, s, d, v: ws.snapshot_windows_plain(pc, s, d, v, VB),
        tuple(x.cpu().numpy() for x in (st, dt, vt)), cloned(), cloned(),
        dev)
    err = max(err, e)
    clone_ms = cuda_ms(cloned, 20)
    ms = cuda_ms(lambda: snap(cloned(), st, dt, vt), 20) - clone_ms
    cap = delta_egress.egress_cap(EB, VB)
    dsnap = ws.WindowSnapshot(VB, analytics, dev, egress="delta", cap=cap)
    delta_ms = cuda_ms(lambda: dsnap(cloned(), st, dt, vt), 20) - clone_ms
    one = (st[:1], dt[:1], vt[:1])
    w1_ms = cuda_ms(lambda: snap(cloned(), *one), 20) - clone_ms
    counter = wc.WindowCounter(VB, KB, dev)
    counter_w1_ms = cuda_ms(lambda: counter(*one), 20)
    plain_ms = cuda_ms(lambda: ws.snapshot_windows_plain(
        cloned(), st, dt, vt, VB), 1) - clone_ms
    slots = int(vt.sum())
    # bytes: the slab read once, the carry read and written once, the rows
    # written once (int32 degree, int32 label, bool odd a slot a window);
    # operations: per valid slot 2 degree adds and 3 unions, per slot and
    # window 3 root walks
    nbytes = CHUNK * EB * 9 + 2 * 16 * (VB + 1) + CHUNK * VB * 9
    b_ms, b_by = bound(nbytes, 5 * slots + 3 * VB * CHUNK)
    seconds = time.perf_counter() - t_phase
    print("phase snapshot: ok  kernel %.3f ms/chunk (L2 tier; delta wire "
          "%.3f; one window %.4f, the counter at one window %.4f; carry "
          "clone %.3f)  plain %.1f ms/chunk  bound %.4f (%s)  (%d windows, "
          "%d valid slots)  max |kernel - plain| %d  %d grid fixtures, "
          "grid launches %s  %.1f s"
          % (ms, delta_ms, w1_ms, counter_w1_ms, clone_ms, plain_ms, b_ms,
             b_by, CHUNK, slots, err, fixtures, grid_launches, seconds))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "delta_ms": delta_ms,
            "w1_ms": w1_ms, "counter_w1_ms": counter_w1_ms,
            "grid_fixtures": fixtures, "grid_launches": grid_launches,
            "ladder": ladder,
            "seconds": seconds}


FIELDS = ("window_start", "num_edges", "triangles")
ARRAYS = ("vertex_ids", "degrees", "cc_labels", "bipartite_odd")


def same_results(name, want, got, offset=0) -> None:
    """Every WindowResult field of `got` equal to `want`'s."""
    require(len(want) == len(got), "%s: %d windows, want %d"
            % (name, len(got), len(want)))
    for i, (w, g) in enumerate(zip(want, got)):
        for f in FIELDS:
            require(getattr(w, f) == getattr(g, f), "%s window %d: %s %s, "
                    "want %s" % (name, i + offset, f, getattr(g, f),
                                 getattr(w, f)))
        for f in ARRAYS:
            a, b = getattr(w, f), getattr(g, f)
            require(a.dtype == b.dtype and np.array_equal(a, b),
                    "%s window %d: %s differs" % (name, i + offset, f))


DRIVER_STEPS = ("parallel_intern_arrays", "_scan_device",
                "_flush_triangle_windows", "_finalize_chunk",
                "_fetch_wire", "run_pipeline", "stack_window_rows",
                "stack_window_list", "_vertex_ids", "numpy")


def host_profile(run) -> dict:
    """Cumulative host seconds of the driver's steps (DRIVER_STEPS) in
    one run() under cProfile (which slows the run itself), and the run's
    total there."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(run)
    torch.cuda.synchronize()
    out = {}
    for (_file, _line, name), row in pstats.Stats(prof).stats.items():
        if name in DRIVER_STEPS:
            out[name] = out.get(name, 0.0) + row[3]
        if name == "run_arrays":
            out["run_arrays (total)"] = row[3]
    return out


def phase_driver(dev, counts: list) -> dict:
    """The driver's main path: StreamingAnalyticsDriver(window_ms=1,
    edge_bucket=32768) over the 320-window stream, count-based, fed in
    calls of DRIVER_FEED windows so the vertex bucket grows from the
    default 4096 to 65536 (launch counts set to 0 just before, read just
    after); every window equal to one-call runs on the scan tier (full
    rows, the delta wire, and the delta wire at DRIVER_SMALL_CAP, whose
    chunks overflow and are run again on full rows on the card) and on
    the "native" tier, and its triangles to
    TriangleWindowKernel.count_stream's (`counts`); the checkpoint taken
    inside a call at window 64 resumed by a fresh driver, the rest and
    the final state equal; then a profiled one-call pass. Returns the
    launches."""
    import tempfile

    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver, kernels

    src, dst = bench_stream()
    num_w = STREAM_EDGES // EB
    require(sum(DRIVER_FEED) == num_w, "feed %s" % (DRIVER_FEED,))

    def driver(**kw):
        return StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB, **kw)

    warm = driver()                  # device=None: the card
    require(warm.device.type == "cuda", "driver not on the card")
    warm.run_arrays(src[:2 * EB], dst[:2 * EB])
    torch.cuda.synchronize()

    drv = driver()
    vbs = []
    kernels.reset_launches()
    t0 = time.perf_counter()
    got, at = [], 0
    for n in DRIVER_FEED:
        got += drv.run_arrays(src[at * EB:(at + n) * EB],
                              dst[at * EB:(at + n) * EB])
        vbs.append(drv.vb)
        at += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name in ("window_snapshot", "window_counter"):
        require(launches[name] > 0, "kernel %s was not launched on the "
                "driver path" % name)
    require(vbs[0] < VB and vbs[-1] == VB and len(set(vbs)) >= 3,
            "vertex buckets %s" % vbs)
    require(len(got) == num_w, "%d windows, want %d" % (len(got), num_w))
    require([r.triangles for r in got] == counts,
            "driver triangles differ from count_stream's")
    require(got[-1].degrees.sum() == 2 * STREAM_EDGES
            and len(got[-1].vertex_ids) == VB, "driver: last window")
    no_demotions("phase driver", drv)

    runs, refolds = {}, {}
    chunks = -(-num_w // StreamingAnalyticsDriver._SCAN_CHUNK)
    for label, kw in (("scan", {}), ("scan_delta", {"egress": "delta"}),
                      ("scan_delta_overflow",
                       {"egress": "delta", "egress_cap": DRIVER_SMALL_CAP}),
                      ("native", {"snapshot_tier": "native"})):
        d2 = driver(**kw)
        d2.run_arrays(src[:2 * EB], dst[:2 * EB])       # warm-up
        d2.reset()
        before = kernels.LAUNCHES["window_snapshot"]
        t0 = time.perf_counter()
        out = d2.run_arrays(src, dst)
        torch.cuda.synchronize()
        runs[label] = time.perf_counter() - t0
        if label.startswith("scan"):
            refolds[label] = (kernels.LAUNCHES["window_snapshot"] - before
                              - chunks)
        same_results("driver " + label, out, got)
        del out
    require(refolds["scan_delta_overflow"] > 0,
            "driver: no chunk overflowed the delta cap %d" % DRIVER_SMALL_CAP)

    # a checkpoint every 64 windows over a call of the first 100: the
    # one at window 64 is taken inside the call, whose interner holds
    # the vertices of all 100 by then; a fresh driver resumes from it
    # and runs the rest
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "driver.npz")
        first = driver()
        first.enable_auto_checkpoint(path, every_n_windows=64)
        first.run_arrays(src[:100 * EB], dst[:100 * EB])
        second = driver()
        require(second.try_resume(path), "no checkpoint to resume")
        done = second.windows_done
        require(done == 64, "resumed at window %d, want 64" % done)
        require(len(second.interner) < len(first.interner),
                "the checkpoint at window 64 holds the call's later "
                "vertices")
        rest = second.run_arrays(src[done * EB:], dst[done * EB:])
    same_results("driver resumed", got[done:], rest, offset=done)
    require(all(np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b
                for a, b in zip(second.state_dict().values(),
                                drv.state_dict().values())),
            "driver resumed: final state differs")

    prof_drv = driver()
    prof_drv.run_arrays(src[:2 * EB], dst[:2 * EB])
    prof = profile_run(lambda: prof_drv.run_arrays(src[2 * EB:],
                                                   dst[2 * EB:]))
    host = host_profile(lambda: driver().run_arrays(src, dst))
    print(json.dumps({"driver": {
        "edges": STREAM_EDGES, "windows": num_w, "eb": EB,
        "vertex_buckets": vbs, "feed_windows": list(DRIVER_FEED),
        "seconds": wall, "edges_per_s": STREAM_EDGES / wall,
        "one_call_seconds": runs,
        "one_call_edges_per_s": {k: STREAM_EDGES / v
                                 for k, v in runs.items()},
        "delta_refolds": refolds, "small_cap": DRIVER_SMALL_CAP,
        "resumed_at": done, "launches": launches,
        "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"driver_profile": prof}))
    print(json.dumps({"driver_host_profile": host}))
    print("phase driver: ok  %d windows  %.1f edges/s fed in %d calls  "
          "(one call: scan %.1f, delta wire %.1f, delta wire at cap %d "
          "%.1f with %d of %d chunks refolded, native %.1f)"
          % (num_w, STREAM_EDGES / wall, len(DRIVER_FEED),
             STREAM_EDGES / runs["scan"], STREAM_EDGES / runs["scan_delta"],
             DRIVER_SMALL_CAP, STREAM_EDGES / runs["scan_delta_overflow"],
             refolds["scan_delta_overflow"], chunks,
             STREAM_EDGES / runs["native"]))
    return launches, got, {"edges_per_s": STREAM_EDGES / runs["scan"],
                           "idle_share": prof["idle_share"]}


def phase_driver_file(dev) -> None:
    """stream_file over a timestamped 'src dst ts' text file written to a
    temporary directory (FILE_EDGES Zipf edges, event-time windows of
    about FILE_WINDOW edges, pieces of FILE_CHUNK_BYTES), the vertex
    bucket growing from 4096 on the way;
    every window equal to run_file of the native tier."""
    import tempfile

    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
    from gelly_streaming_tpu_torch import make_stream

    src, dst = make_stream(FILE_EDGES, VB, seed=25)
    rng = np.random.default_rng(26)
    n_win = FILE_EDGES // FILE_WINDOW
    ts = np.sort(rng.integers(0, n_win * 1000, FILE_EDGES))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "edges.txt")
        t0 = time.perf_counter()
        np.savetxt(path, np.stack([src, dst, ts], 1), fmt="%d")
        write_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        drv = StreamingAnalyticsDriver(window_ms=1000)
        vbs = []
        t0 = time.perf_counter()
        got = []
        for res in drv.stream_file(path, chunk_bytes=FILE_CHUNK_BYTES):
            got.append(res)
            vbs.append(drv.vb)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        want = StreamingAnalyticsDriver(
            window_ms=1000, snapshot_tier="native").run_file(path)
    same_results("driver_file", want, got)
    require(min(vbs) <= SNAP_SMALL_VB and max(vbs) > SNAP_SMALL_VB,
            "driver_file: vertex buckets %s..%s" % (min(vbs), max(vbs)))
    print(json.dumps({"driver_file": {
        "edges": FILE_EDGES, "windows": len(got), "bytes": size,
        "chunk_bytes": FILE_CHUNK_BYTES, "seconds": wall,
        "edges_per_s": FILE_EDGES / wall, "write_seconds": write_s,
        "vertex_buckets": sorted(set(vbs)), "edge_bucket": drv.eb,
        "device": torch.cuda.get_device_name(0)}}))
    print("phase driver_file: ok  %d windows  %.1f edges/s  (%d bytes)"
          % (len(got), FILE_EDGES / wall, size))


# ----------------------------------------------------------------------
# the cell reduce, the columnar windowed reduce and the graph API
# ----------------------------------------------------------------------

RED_EB, RED_VB = 8192, 16384        # BASELINE config #2 (bench.py:531)
RED_EDGES = 2_097_152               # its stream: make_stream(RED_EDGES, RED_VB)
RED_BIG_EB = 32768                  # the north-star stream, sum over "all"
RED_SLIDE = 2048
CELL_PASSES_VB = 1 << 18            # rows past a cluster's shared memory
API_EDGES = 1_048_576               # make_stream(API_EDGES, VB, seed=7)
API_RUN_EDGES = API_EDGES // 2      # phase api's reduce and triangle jobs'
                                    # prefix (cut, PR 22: the script past
                                    # 455 s with phase driver_mesh)
API_TRACE_EDGES = API_EDGES // 4    # phase api_tracing's prefix of it
API_DEGREE_EDGES = API_EDGES // 4   # phase api's get_degrees prefix
API_EDGES_PER_MS = 16
API_WINDOW_MS = 512                 # the reduce_on_edges slice
API_TRI_MS = (128, 2048)            # dense route, sparse route
DENSE_MAX_V = 4096                  # triangle_count's dense limit


def red_values(src, dst) -> np.ndarray:
    """bench.py's reduce-leg weights (bench.py:532)."""
    return (1 + (src + 3 * dst) % 97).astype(np.int32)


def cell_wire(src, dst, val, eb: int, vb: int, direction: str, wire: str,
              dev, nvalid=None):
    """The first [wb, eb] windows of a stream as the device tier stages
    them, on the card: the standard wire (cell ids, values) or the
    compact one (s16, d16, nvalid, values). `nvalid` overrides the valid
    counts (then the arrays are [wb·eb] already padded)."""
    wb = len(src) // eb
    vbp = vb + 1
    if nvalid is None:
        nvalid = np.full(wb, eb, np.int32)
    if wire == "compact":
        arrays = (src.astype(np.uint16).reshape(wb, eb),
                  dst.astype(np.uint16).reshape(wb, eb),
                  nvalid.astype(np.int32), val.reshape(wb, eb))
    else:
        valid = (np.arange(eb)[None, :] < nvalid[:, None]).reshape(-1)
        win = np.arange(wb * eb) // eb
        vtx = {"out": [src], "in": [dst], "all": [src, dst]}[direction]
        ids = np.concatenate([np.where(valid, win * vbp + v, wb * vbp)
                              for v in vtx]).astype(np.int32)
        arrays = (ids, np.concatenate([val] * len(vtx)))
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def reduce_call(wire, t, wb, eb, vbp, name, direction, egress="full",
                cap=0, plain=False):
    """One cell reduce of a staged wire: the kernel, or with plain the
    plain version on the same device."""
    from gelly_streaming_tpu_torch.ops import cell_reduce as cr

    if plain:
        ids, vals = (cr.compact_cell_ids(*t, vbp, direction)
                     if wire == "compact" else t)
        res = cr.cell_reduce_plain(ids, vals, wb, eb, vbp, name)
        return cr.touched_wire(*res, cap) if egress == "delta" else res
    if wire == "compact":
        return cr.cell_reduce_compact(*t, vbp, name, direction, egress,
                                      cap)
    return cr.cell_reduce(*t, wb, eb, vbp, name, egress, cap)


def compare_cells(label, got, want, name, tol=None) -> float:
    """Kernel outputs against plain ones: counts, indices and integer
    or min/max cells exact; float sums within 1e-5 · Σ|v| a cell (`tol`,
    the plain sum of |v| laid out as the cells). Returns the largest
    |kernel - plain| of the cells."""
    err = 0.0
    cells_at = 0 if len(got) == 2 else 2
    for k, (g, w) in enumerate(zip(got, want)):
        require(g.shape == w.shape and g.dtype == w.dtype,
                "%s: output %d %s %s != plain %s %s"
                % (label, k, tuple(g.shape), g.dtype, tuple(w.shape),
                   w.dtype))
        if k == cells_at and g.dtype == torch.float32:
            fin = torch.isfinite(w)
            require(torch.equal(fin, torch.isfinite(g)),
                    "%s: fills differ" % label)
            d = (g[fin].double() - w[fin].double()).abs()
            e = float(d.max()) if d.numel() else 0.0
            err = max(err, e)
            if name == "sum":
                require(bool((d <= 1e-5 * tol[fin].double() + 1e-30)
                             .all()), "%s: float sum past 1e-5 Σ|v| "
                        "(max %g)" % (label, e))
            else:
                require(e == 0, "%s: cells differ by %g" % (label, e))
            continue
        if not torch.equal(g, w):
            e = float((g.double() - w.double()).abs().max())
            raise SmokeFailure("%s: output %d differs (max %g)"
                               % (label, k, e))
    return err


def cell_edge_stack(eb: int, vb: int, rng):
    """Eight windows of edge cases: empty, one edge, ids 0 and vb-1
    alternating, all on one hub vertex, three random, a ragged last
    (half full). Returns (src, dst, nvalid) [8·eb]."""
    wb = 8
    src = rng.integers(0, vb, wb * eb)
    dst = rng.integers(0, vb, wb * eb)
    nvalid = np.full(wb, eb, np.int32)
    nvalid[0] = 0
    nvalid[1] = 1
    src[eb], dst[eb] = 0, vb - 1
    top = np.where(np.arange(eb) % 2 == 0, 0, vb - 1)
    src[2 * eb:3 * eb], dst[2 * eb:3 * eb] = top, top[::-1]
    src[3 * eb:4 * eb] = 4242 % vb
    nvalid[7] = eb // 2
    return src, dst, nvalid


def cell_bytes(rep: int, wb: int, eb: int, vbp: int, wire: str) -> int:
    """Bytes a call must move: each input once (the standard wire's
    int32 ids and 4-byte values, rep of each a slot; the compact wire's
    two uint16 ids and one value a slot and a count a window), the full
    rows once (4-byte cell and count a vertex a window)."""
    inp = (rep * wb * eb * 8 if wire == "standard"
           else wb * eb * 8 + 4 * wb)
    return inp + wb * vbp * 8


def phase_cell_reduce(dev) -> dict:
    """The cell-reduce kernel (csrc/cell_reduce.cu) against its plain
    version on the card: sum/min/max × out/in/all × int32/float32 on
    both wires, full rows and the delta wire, at [64, 8192] vb=16384
    (plain loads, a cluster of two blocks a row) and [64, 32768]
    vb=65536 (the TMA ring, four blocks a row); the edge-case windows;
    a multi-pass row; the card's plans against `plan_mirror`; the cell
    fixtures (cell_fixture_checks); a refused call raising KernelError;
    cohort_step of 64 rows. Then times at the main path's chunk and the
    north-star chunk beside the plain version and the library calls
    (index_add_ for cells and counts), each with its bound and share:
    device time under the profiler, and each call's time by CUDA
    events; the hub chunk at both vb; one launch a call in a
    profile."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import cell_reduce as cr
    from gelly_streaming_tpu_torch.ops import windowed_reduce as wr

    rng = np.random.default_rng(31)
    err = 0.0
    plans = {}
    checked = 0
    for eb, vb, seed in ((RED_EB, RED_VB, 7), (EB, VB, 7)):
        wb, vbp = CHUNK, vb + 1
        src, dst = make_stream(wb * eb, vb, seed=seed)
        direction = "out" if vb == RED_VB else "all"
        plans[vb] = dict(cr.plan(wb, vbp, dev, eb, "standard", direction),
                         eb=eb, direction=direction)
        values = {"int32": rng.integers(-1000, 1000, wb * eb)
                  .astype(np.int32),
                  "float32": (rng.standard_normal(wb * eb) * 100)
                  .astype(np.float32)}
        for direction in ("out", "in", "all"):
            cap = min(eb * (2 if direction == "all" else 1), vbp)
            for dtype, val in values.items():
                std = cell_wire(src, dst, val, eb, vb, direction,
                                "standard", dev)
                tol = reduce_call("standard", (std[0], std[1].abs()), wb,
                                  eb, vbp, "sum", direction,
                                  plain=True)[0] if dtype == "float32" \
                    else None
                for wire in ("standard", "compact"):
                    t = std if wire == "standard" else cell_wire(
                        src, dst, val, eb, vb, direction, wire, dev)
                    for name in ("sum", "min", "max"):
                        want = reduce_call(wire, t, wb, eb, vbp, name,
                                           direction, plain=True)
                        got = reduce_call(wire, t, wb, eb, vbp, name,
                                          direction)
                        label = "cell_reduce %d/%d %s %s %s %s" % (
                            eb, vb, direction, dtype, wire, name)
                        err = max(err, compare_cells(label, got, want,
                                                     name, tol))
                        dwant = cr.touched_wire(*want, cap)
                        dgot = reduce_call(wire, t, wb, eb, vbp, name,
                                           direction, "delta", cap)
                        dtol = None
                        if tol is not None:
                            dtol = torch.gather(tol, 1,
                                                dwant[1].long())
                        err = max(err, compare_cells(label + " delta",
                                                     dgot, dwant, name,
                                                     dtol))
                        checked += 2
        print("phase cell_reduce %d/%d: ok  (%s: cluster %d, span %d, "
              "passes %d, stages %d, clusters %d)"
              % (eb, vb, direction, plans[vb]["cluster"], plans[vb]["span"],
                 plans[vb]["passes"], plans[vb]["stages"],
                 plans[vb]["clusters"]))

    # edge cases, both wires, full and delta
    for eb, vb in ((RED_EB, RED_VB), (EB, VB)):
        vbp = vb + 1
        src, dst, nvalid = cell_edge_stack(eb, vb, rng)
        val = rng.integers(-9, 9, len(src)).astype(np.int32)
        for name, direction in (("sum", "all"), ("min", "out"),
                                ("max", "in")):
            cap = min(eb * (2 if direction == "all" else 1), vbp)
            for wire in ("standard", "compact"):
                t = cell_wire(src, dst, val, eb, vb, direction, wire, dev,
                              nvalid)
                want = reduce_call(wire, t, 8, eb, vbp, name, direction,
                                   plain=True)
                got = reduce_call(wire, t, 8, eb, vbp, name, direction)
                label = "cell_reduce edge cases %d %s %s %s" % (
                    vb, wire, name, direction)
                compare_cells(label, got, want, name)
                compare_cells(label + " delta", reduce_call(
                    wire, t, 8, eb, vbp, name, direction, "delta", cap),
                    cr.touched_wire(*want, cap), name)
                require(not got[1][0].any(), label + ": empty window")
                require(int(got[1][1].sum()) ==
                        (2 if direction == "all" else 1),
                        label + ": one-edge window")
    # rows past 8 blocks' shared memory: several passes a cluster
    eb, vb, wb = 2 * RED_EB, CELL_PASSES_VB, 2
    vbp = vb + 1
    plans[vb] = dict(cr.plan(wb, vbp, dev, eb, "standard", "all"), eb=eb,
                     direction="all")
    require(plans[vb]["passes"] > 1 and plans[vb]["stages"] > 0,
            "multi-pass ring plan %s" % plans[vb])
    src, dst = rng.integers(0, vb, wb * eb), rng.integers(0, vb, wb * eb)
    for name, direction, val in (
            ("sum", "all", rng.integers(-50, 50, wb * eb).astype(np.int32)),
            ("min", "out", rng.standard_normal(wb * eb).astype(np.float32))):
        cap = min(eb * (2 if direction == "all" else 1), vbp)
        for wire in ("standard",):      # ids past 16 bits
            t = cell_wire(src, dst, val, eb, vb, direction, wire, dev)
            want = reduce_call(wire, t, wb, eb, vbp, name, direction,
                               plain=True)
            label = "cell_reduce passes %s %s" % (wire, name)
            compare_cells(label, reduce_call(wire, t, wb, eb, vbp, name,
                                             direction), want, name)
            compare_cells(label + " delta", reduce_call(
                wire, t, wb, eb, vbp, name, direction, "delta", cap),
                cr.touched_wire(*want, cap), name)
            checked += 2

    # the plan on the card is its Python mirror's, fed the card's SMs and
    # room; then the fixtures of utils/tier_fixtures.py at card sizes
    for vb, p in plans.items():
        m = cr.plan_mirror(CHUNK if vb != CELL_PASSES_VB else 2, vb + 1,
                           p["sms"], p["room"], p["eb"] * cr.slot_bytes(
                               "standard", p["direction"]))
        require(all(p[k] == m[k] for k in m if k != "smem"),
                "cell_reduce plan at vb=%d %s != its mirror %s" % (vb, p, m))
    fixtures = cell_fixture_checks(dev, plans[VB]["room"], rng)
    checked += fixtures["calls"]
    err = max(err, fixtures["max_abs_err"])

    # cohort_step: 64 tenants' windows in one launch, each equal to its
    # own window on the host tier
    eng = wr.WindowedEdgeReduce(RED_VB, RED_EB, "sum", "all", device=dev)
    rows = []
    for i in range(CHUNK):
        k = int(rng.integers(0, RED_EB + 1)) if i % 9 else 0
        s = rng.integers(0, RED_VB, k)
        d = rng.integers(0, RED_VB, k)
        rows.append((s, d, red_values(s, d)))
    from gelly_streaming_tpu_torch import kernels

    before = kernels.LAUNCHES["cell_reduce"]
    got = eng.cohort_step(rows)
    require(kernels.LAUNCHES["cell_reduce"] - before == 1,
            "cohort_step: not one launch")
    host = wr.WindowedEdgeReduce(RED_VB, RED_EB, "sum", "all", tier="host")
    for r, ((gc, gn), (s, d, v)) in enumerate(zip(got, rows)):
        if len(s) == 0:
            require(not gn.any(), "cohort row %d: empty row touched" % r)
            continue
        (hc, hn), = host.process_stream(s, d, v)
        require(np.array_equal(gn, hn) and np.array_equal(gc, hc),
                "cohort row %d differs from the host tier" % r)

    # a call the C entry refuses (a bad rep, a device that is not there)
    # raises KernelError before any launch; nothing falls back to plain
    lib = kernels.library("cell_reduce")
    ids = torch.zeros(8, dtype=torch.int32, device=dev)
    drill = torch.empty(2, 9, dtype=torch.int32, device=dev)
    out = cr._Out(cells=drill[0].data_ptr(), counts=drill[1].data_ptr())
    for label, rep, index in (("rep 3", 3, dev.index), ("device 999", 1, 999)):
        before = kernels.LAUNCHES["cell_reduce"]
        try:
            kernels.check("cell_reduce", lib.gs_cell_reduce(
                ids.data_ptr(), ids.data_ptr(), 1, 8, rep, 9, 0, 0,
                ctypes.byref(out), index, kernels.stream_of(ids)))
        except kernels.KernelError:
            require(kernels.LAUNCHES["cell_reduce"] == before,
                    "cell_reduce drill %s: counted a launch" % label)
        else:
            raise SmokeFailure("cell_reduce drill %s: no KernelError" % label)
    torch.cuda.synchronize()

    # times at the main path's chunk (out, sum, int32, standard, full)
    res = {}
    for key, eb, vb, direction in (("main", RED_EB, RED_VB, "out"),
                                   ("big", EB, VB, "all")):
        wb, vbp = CHUNK, vb + 1
        src, dst = make_stream(wb * eb, vb, seed=7)
        val = red_values(src, dst)
        t = cell_wire(src, dst, val, eb, vb, direction, "standard", dev)
        rep = 2 if direction == "all" else 1
        n_cells = wb * vbp
        ids = t[0]

        def library():
            cells = torch.zeros(n_cells + 1, dtype=torch.int32, device=dev)
            cells.index_add_(0, ids, t[1])
            counts = torch.zeros(n_cells + 1, dtype=torch.int32,
                                 device=dev)
            counts.index_add_(0, ids, torch.ones_like(ids))
            return cells, counts

        lc, ln = library()
        kc, kn = reduce_call("standard", t, wb, eb, vbp, "sum", direction)
        require(torch.equal(lc[:-1].reshape(wb, vbp), kc)
                and torch.equal(ln[:-1].reshape(wb, vbp), kn),
                "cell_reduce %s: kernel != library" % key)
        # device time (profiled) beside the call's time (CUDA events,
        # which a call of a few µs leaves bound by the host's launches)
        kernel = lambda: reduce_call("standard", t, wb, eb, vbp,  # noqa
                                     "sum", direction)
        ms = device_ms(kernel, 50)
        call_ms = cuda_ms(kernel, 50)
        lib_ms = device_ms(library, 50)
        lib_call_ms = cuda_ms(library, 50)
        plain_ms = device_ms(lambda: reduce_call(
            "standard", t, wb, eb, vbp, "sum", direction, plain=True), 3)
        delta_ms = device_ms(lambda: reduce_call(
            "standard", t, wb, eb, vbp, "sum", direction, "delta",
            min(rep * eb, vbp)), 50)
        ct = cell_wire(src, dst, val, eb, vb, direction, "compact", dev)
        compact_ms = device_ms(lambda: reduce_call(
            "compact", ct, wb, eb, vbp, "sum", direction), 50)
        b_ms, b_by = bound(cell_bytes(rep, wb, eb, vbp, "standard"),
                           2 * rep * wb * eb)
        res[key] = {"ms": ms, "library_ms": lib_ms, "plain_ms": plain_ms,
                    "call_ms": call_ms, "library_call_ms": lib_call_ms,
                    "delta_ms": delta_ms, "compact_ms": compact_ms,
                    "bound_ms": b_ms, "bound_by": b_by,
                    "eb": eb, "vb": vb, "direction": direction}
    # a chunk all on one hub vertex (its folds meet in one cell), at
    # both shapes
    hub_ms = {}
    for key, eb, vb in (("main", RED_EB, RED_VB), ("big", EB, VB)):
        hub = np.full(CHUNK * eb, 4242, np.int64)
        ht = cell_wire(hub, hub, np.ones(len(hub), np.int32), eb, vb,
                       "out", "standard", dev)
        hub_ms[key] = device_ms(lambda: reduce_call(
            "standard", ht, CHUNK, eb, vb + 1, "sum", "out"), 50)
    # one launch a call: 64 windows at vb=65536 (more clusters than the
    # card runs at once), 20 calls in a profile: 20 launch calls in its
    # CUDA API rows, and no device row but the kernel's (the profiler
    # may drop device records in an aged process, never add them). The
    # profile is the first of a fresh process (cell_reduce_capture):
    # taken here, ~100 s into this one, it has kept none of them
    calls, grid = cell_reduce_capture()
    require(calls == 20 and grid and all("cell_reduce" in k for k in grid)
            and sum(grid.values()) <= 20,
            "cell_reduce: %d launch calls, device rows %s in 20 calls"
            % (calls, grid))
    main, big = res["main"], res["big"]
    for r in (main, big):
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
    print(json.dumps({"cell_reduce": {
        "checked_calls": checked, "max_abs_err": err, "plans": plans,
        "times": res, "hub_chunk_ms": hub_ms, "fixtures": fixtures,
        "launch_calls": calls, "device_records": grid,
        "device": torch.cuda.get_device_name(0)}}))
    print("phase cell_reduce: ok  kernel %.4f ms/chunk on the device "
          "(call %.4f; delta %.4f, compact %.4f)  library %.4f (call "
          "%.4f)  plain %.3f  bound %.4f (%s, %.0f%%); vb=65536 all %.4f "
          "(library %.4f, bound %.4f, %.0f%%); hub chunk %.4f, %.4f at "
          "vb=65536; %d fixture calls; one launch a call  (%d calls "
          "checked, max float |kernel - plain| %g)"
          % (main["ms"], main["call_ms"], main["delta_ms"],
             main["compact_ms"], main["library_ms"],
             main["library_call_ms"], main["plain_ms"], main["bound_ms"],
             main["bound_by"], 100 * main["share_of_bound"], big["ms"],
             big["library_ms"], big["bound_ms"],
             100 * big["share_of_bound"], hub_ms["main"], hub_ms["big"],
             fixtures["calls"], checked, err))
    return dict(main, max_abs_err=err, big=big, hub_ms=hub_ms)


CAPTURE_FLAG = "--cell-reduce-capture"


_CAPTURE = []                      # the capture child, once started


def start_cell_reduce_capture() -> None:
    """Start the child of cell_reduce_capture (once the kernels are
    built), so that it runs beside the first phases; it is stopped at
    exit if it is still running."""
    import atexit

    if not _CAPTURE:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), CAPTURE_FLAG],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        atexit.register(lambda: proc.poll() is None and proc.kill())
        _CAPTURE.append(proc)


def cell_reduce_capture() -> tuple:
    """(launch calls, {device row: launches}) of 20 cell-reduce calls at
    [64, 32768], vb=65536, direction "all", in a child process
    (`python3 chip_smoke.py --cell-reduce-capture`,
    cell_reduce_capture_child) whose torch.profiler session is the first
    of its life; started here unless start_cell_reduce_capture did."""
    start_cell_reduce_capture()
    out, err = _CAPTURE[0].communicate(timeout=600)
    require(_CAPTURE[0].returncode == 0, "cell_reduce capture: exit %d\n%s"
            % (_CAPTURE[0].returncode, err[-3000:]))
    got = json.loads(out.strip().splitlines()[-1])
    return got["launch_calls"], got["device_rows"]


def cell_reduce_capture_child() -> int:
    """The child of cell_reduce_capture: builds the wire, runs the kernel
    once, then takes the profile of 20 calls and prints one JSON line."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.utils.profiling import device_times

    dev = torch.device("cuda", torch.cuda.current_device())
    big = cell_wire(*make_stream(CHUNK * EB, VB, seed=7),
                    np.ones(CHUNK * EB, np.int32), EB, VB, "all",
                    "standard", dev)

    def call():
        return reduce_call("standard", big, CHUNK, EB, VB + 1, "sum", "all")

    call()
    torch.cuda.synchronize()
    _wall, rows, calls = device_times(lambda: [call() for _ in range(20)],
                                      launch_calls=True)
    print(json.dumps({"launch_calls": calls, "device_rows": {
        k: n for k, (_ms, n) in rows.items()}}))
    return 0


def cell_fixture_checks(dev, room: int, rng) -> dict:
    """utils/tier_fixtures.py's cell-reduce fixtures at card sizes, each
    kernel call against the plain version on the same tensors: both
    wires (the compact one up to 65536 vertices), full rows and the
    delta wire, float32 sum over "all", int32 min over "out" and
    float32 max over "in"; the fixtures' block ranges are the card's
    plans (`max_span` from the card's room)."""
    from gelly_streaming_tpu_torch.ops import cell_reduce as cr
    from gelly_streaming_tpu_torch.utils import tier_fixtures as tf

    ring_span = ((room - cr.MIN_STAGES * cr.STAGE_BYTES - 64) // 8) & ~31
    plain_span = ((room - 64) // 8) & ~31
    big = cr.plan(CHUNK, VB + 1, dev, EB, "standard", "all")
    # (kind, windows, eb, vb): eb 8192 "all" and below read with plain
    # loads, 16384 "all" (256 KB a window) and above through the ring
    cases = [("boundaries", 8, RED_EB, RED_VB),
             ("one_block", 4, 2 * RED_EB, VB),
             ("ragged", 6, RED_EB + 5, RED_VB),
             ("ragged", 6, 2 * RED_EB + 5, RED_VB),
             ("nvalid", 10, 2 * RED_EB, RED_VB),
             ("uniform", 3 * big["sms"] // big["cluster"] + 1, 2 * RED_EB,
              VB),
             ("boundaries", 2, 2 * RED_EB, CELL_PASSES_VB),
             ("hub", 4, 2 * RED_EB, VB)]
    cases += [("boundaries", 4, 2 * RED_EB, vbp - 1)
              for vbp in tf.capacity_vbps(ring_span, 2)]
    cases += [("boundaries", 4, RED_EB // 2, vbp - 1)
              for vbp in tf.capacity_vbps(plain_span, 2)]
    calls, err = 0, 0.0
    for kind, wb, eb, vb in cases:
        p = cr.plan(wb, vb + 1, dev, eb, "standard", "all")
        src, dst, nvalid = tf.cell_stack(kind, wb, eb, vb, calls,
                                         p["cluster"], p["span"])
        for k, (name, direction, dtype) in enumerate(
                (("sum", "all", "float32"), ("min", "out", "int32"),
                 ("max", "in", "float32"))):
            val = tf.cell_values(dtype, wb, eb, k)
            wires = tf.cell_wires(src, dst, nvalid, val, vb, direction)
            cap = min(eb * (2 if direction == "all" else 1), vb + 1)
            std = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in wires["standard"])
            tol = None
            if dtype == "float32" and name == "sum":
                tol = cr.cell_reduce_plain(std[0], std[1].abs(), wb, eb,
                                           vb + 1, "sum")[0]
            for wire in ("standard", "compact")[:1 if vb > 65536 else 2]:
                t = std if wire == "standard" else tuple(
                    torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in wires["compact"])
                want = reduce_call(wire, t, wb, eb, vb + 1, name, direction,
                                   plain=True)
                label = "cell_reduce fixture %s %dx%d vb=%d %s %s %s" % (
                    kind, wb, eb, vb, wire, name, direction)
                err = max(err, compare_cells(label, reduce_call(
                    wire, t, wb, eb, vb + 1, name, direction), want, name,
                    tol))
                dwant = cr.touched_wire(*want, cap)
                err = max(err, compare_cells(label + " delta", reduce_call(
                    wire, t, wb, eb, vb + 1, name, direction, "delta", cap),
                    dwant, name, None if tol is None else
                    torch.gather(tol, 1, dwant[1].long())))
                calls += 2
    return {"calls": calls, "max_abs_err": err, "cases": len(cases)}


def np_port_with_counts(src, val, eb: int, vb: int) -> list:
    """bench.py's baseline (bench.py:553-567): per window the bincount of
    the values and of the contributions by source."""
    out = []
    for lo in range(0, len(src), eb):
        s = src[lo:lo + eb]
        out.append((np.bincount(s, val[lo:lo + eb], minlength=vb),
                    np.bincount(s, minlength=vb)))
    return out


def same_rows(label, got, want, exact_len=True) -> None:
    """Every window's (cells, counts) equal: counts everywhere, cells
    where counted (the fills differ by tier)."""
    require(len(got) == len(want), "%s: %d windows, want %d"
            % (label, len(got), len(want)))
    for w, ((gc, gn), (wc, wn)) in enumerate(zip(got, want)):
        k = len(wn)
        require(np.array_equal(gn[:k], wn) and not gn[k:].any(),
                "%s window %d: counts differ" % (label, w))
        m = wn > 0
        require(np.array_equal(np.asarray(gc[:k])[m],
                               np.asarray(wc)[m]),
                "%s window %d: cells differ" % (label, w))


def phase_reduce_stream(dev) -> dict:
    """The columnar windowed reduce's main path: WindowedEdgeReduce(16384,
    8192, "sum", "out") over bench.py's reduce-leg stream (BASELINE
    config #2 at its published size), launch counts set to 0 just
    before and read just after, every window equal to bench.py's
    np.bincount port on both wires and both egress forms and under
    forced_sync; "all" with min and max equal to the native tier (its
    first windows to numpy_reference); slide=2048 equal to
    sliding_numpy_reference; the native tier equal to the device tier;
    the north-star stream at vb=65536 (sum over "all") equal to the
    native tier. Each form's edges/s, repeats and a profiled idle
    share."""
    from gelly_streaming_tpu_torch import (WindowedEdgeReduce, forced_sync,
                                           kernels, make_stream)
    from gelly_streaming_tpu_torch.ops import windowed_reduce as wr

    src, dst = make_stream(RED_EDGES, RED_VB)
    val = red_values(src, dst)
    want = np_port_with_counts(src, val, RED_EB, RED_VB)
    num_w = RED_EDGES // RED_EB
    out = {}

    def timed(eng, s=src, d=dst, v=val, reps=2):
        eng.process_stream(s, d, v)           # warm-up: builds, fills the ring
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = eng.process_stream(s, d, v)
        wall = time.perf_counter() - t0
        launches = kernels.LAUNCHES["cell_reduce"]
        repeats = []
        for _ in range(reps):
            t0 = time.perf_counter()
            eng.process_stream(s, d, v)
            repeats.append(time.perf_counter() - t0)
        return got, wall, launches, repeats

    main = WindowedEdgeReduce(RED_VB, RED_EB, "sum", "out")  # the card
    require(main.device.type == "cuda", "reduce engine not on the card")
    for ingress, egress in (("standard", "full"), ("compact", "full"),
                            ("standard", "delta"), ("compact", "delta")):
        eng = (main if (ingress, egress) == ("standard", "full") else
               WindowedEdgeReduce(RED_VB, RED_EB, "sum", "out",
                                  ingress=ingress, egress=egress))
        got, wall, launches, repeats = timed(eng)
        label = "reduce_stream %s/%s" % (ingress, egress)
        same_rows(label, got, want)
        require(launches == -(-num_w // eng.MAX_STREAM_WINDOWS),
                "%s: %d cell_reduce launches" % (label, launches))
        prof = profile_run(lambda: eng.process_stream(src, dst, val))
        out["%s/%s" % (ingress, egress)] = {
            "seconds": wall, "edges_per_s": RED_EDGES / wall,
            "repeat_seconds": repeats, "launches": launches,
            "stage_ms_per_chunk": eng.stage_timers.snapshot(),
            "idle_share": prof["idle_share"],
            "device_busy_ms": prof["device_busy_ms"],
            "profiled_wall_ms": prof["wall_ms"]}
    main_launches = out["standard/full"]["launches"]
    with forced_sync():
        t0 = time.perf_counter()
        got = main.process_stream(src, dst, val)
        sync_wall = time.perf_counter() - t0
    same_rows("reduce_stream forced_sync", got, want)
    out["standard/full"]["forced_sync_seconds"] = sync_wall
    out["standard/full"]["forced_sync_edges_per_s"] = RED_EDGES / sync_wall

    # the native tier, equal to the device tier
    nat = WindowedEdgeReduce(RED_VB, RED_EB, "sum", "out", tier="native")
    t0 = time.perf_counter()
    ngot = nat.process_stream(src, dst, val)
    out["native"] = {"seconds": time.perf_counter() - t0}
    out["native"]["edges_per_s"] = RED_EDGES / out["native"]["seconds"]
    same_rows("reduce_stream native", ngot, want)
    np_t0 = time.perf_counter()
    np_port_with_counts(src, val, RED_EB, RED_VB)
    out["numpy_port_edges_per_s"] = RED_EDGES / (time.perf_counter()
                                                  - np_t0)

    # "all" with min and max
    for name in ("min", "max"):
        eng = WindowedEdgeReduce(RED_VB, RED_EB, name, "all")
        got, wall, launches, repeats = timed(eng, reps=1)
        ref = WindowedEdgeReduce(RED_VB, RED_EB, name, "all",
                                 tier="native").process_stream(src, dst,
                                                               val)
        same_rows("reduce_stream all/%s vs native" % name, got,
                  [(c, n) for c, n in ref])
        same_rows("reduce_stream all/%s vs numpy" % name, got[:4],
                  wr.numpy_reference(src[:4 * RED_EB], dst[:4 * RED_EB],
                                     val[:4 * RED_EB], RED_EB, "all",
                                     name))
        out["all/" + name] = {"seconds": wall,
                              "edges_per_s": RED_EDGES / wall,
                              "repeat_seconds": repeats,
                              "launches": launches}

    # sliding windows by pane composition
    eng = WindowedEdgeReduce(RED_VB, RED_EB, "sum", "out", slide=RED_SLIDE)
    got, wall, launches, repeats = timed(eng, reps=1)
    ref = wr.sliding_numpy_reference(src, dst, val, RED_EB, RED_SLIDE,
                                     "out", "sum")
    same_rows("reduce_stream slide=%d" % RED_SLIDE, got, ref)
    out["slide"] = {"slide": RED_SLIDE, "emissions": len(got),
                    "seconds": wall, "edges_per_s": RED_EDGES / wall,
                    "repeat_seconds": repeats, "launches": launches}

    # the large-vb tier: the north-star stream, sum over "all"
    bsrc, bdst = bench_stream()
    bval = red_values(bsrc, bdst)
    eng = WindowedEdgeReduce(VB, RED_BIG_EB, "sum", "all")
    got, wall, launches, repeats = timed(eng, bsrc, bdst, bval, reps=1)
    ref = WindowedEdgeReduce(VB, RED_BIG_EB, "sum", "all",
                             tier="native").process_stream(bsrc, bdst, bval)
    same_rows("reduce_stream vb=65536 all/sum", got,
              [(c, n) for c, n in ref])
    prof = profile_run(lambda: eng.process_stream(bsrc, bdst, bval))
    out["big_all_sum"] = {"edges": STREAM_EDGES, "eb": RED_BIG_EB,
                          "vb": VB, "seconds": wall,
                          "edges_per_s": STREAM_EDGES / wall,
                          "repeat_seconds": repeats, "launches": launches,
                          "idle_share": prof["idle_share"]}
    print(json.dumps({"reduce_stream": dict(
        out, edges=RED_EDGES, windows=num_w, eb=RED_EB, vb=RED_VB,
        device=torch.cuda.get_device_name(0))}))
    m = out["standard/full"]
    print("phase reduce_stream: ok  %d windows  %.1f edges/s  (forced_sync "
          "%.1f, compact %.1f, delta %.1f, native %.1f, numpy port %.1f; "
          "vb=65536 all %.1f)  idle %s"
          % (num_w, m["edges_per_s"], m["forced_sync_edges_per_s"],
             out["compact/full"]["edges_per_s"],
             out["standard/delta"]["edges_per_s"],
             out["native"]["edges_per_s"], out["numpy_port_edges_per_s"],
             out["big_all_sum"]["edges_per_s"], m["idle_share"]))
    return {"cell_reduce": main_launches}


def api_goldens(dev) -> None:
    """The nine goldens of the reference's TestSlice.java:81-229 through
    the host UDFs and the Torch* UDFs on the card."""
    import gelly_streaming_tpu_torch as P
    from gelly_streaming_tpu_torch.core.types import csv_line

    fold_want = {"OUT": ["1,25", "2,23", "3,69", "4,45", "5,51"],
                 "IN": ["1,51", "2,12", "3,36", "4,34", "5,80"],
                 "ALL": ["1,76", "2,35", "3,105", "4,79", "5,131"]}
    apply_want = {
        "OUT": ["1,small", "2,small", "3,big", "4,small", "5,big"],
        "IN": ["1,big", "2,small", "3,small", "4,small", "5,big"],
        "ALL": ["1,big", "2,small", "3,big", "4,big", "5,big"]}
    edges = [(1, 2, 12), (1, 3, 13), (2, 3, 23), (3, 4, 34), (3, 5, 35),
             (4, 5, 45), (5, 1, 51)]

    def run(direction, op):
        env = P.StreamEnvironment(clock=P.ManualClock(0))   # the card
        g = P.SimpleEdgeStream(env.from_collection(
            [P.Edge(*e) for e in edges]), env).slice(
            P.Time.seconds(1), P.EdgeDirection[direction])
        sink = op(g).collect()
        env.execute()
        require(env.device.type == "cuda", "api: env not on the card")
        return sorted(csv_line(v) for v in env.results_of(sink))

    def classify(vid, nbrs, collect):
        collect((vid, "big" if sum(v for _n, v in nbrs) > 50
                 else "small"))

    i32 = lambda: torch.tensor(0, dtype=torch.int32)  # noqa: E731
    for direction in ("OUT", "IN", "ALL"):
        cases = {
            "fold host": (lambda g: g.fold_neighbors((0, 0), P.EdgesFold(
                lambda acc, vid, nid, val: (vid, acc[1] + val))),
                fold_want),
            "fold torch": (lambda g: g.fold_neighbors(P.TorchEdgesFold(
                (i32(), i32()), lambda acc, vid, nid, val:
                (vid, acc[1] + val))), fold_want),
            "reduce host": (lambda g: g.reduce_on_edges(P.EdgesReduce(
                lambda a, b: a + b)), fold_want),
            "reduce torch named": (lambda g: g.reduce_on_edges(
                P.TorchEdgesReduce(name="sum")), fold_want),
            "reduce torch fn": (lambda g: g.reduce_on_edges(
                P.TorchEdgesReduce(fn=torch.add)), fold_want),
            "reduce torch associative": (lambda g: g.reduce_on_edges(
                P.TorchEdgesReduce(fn=torch.add, associative=True)),
                fold_want),
            "apply host": (lambda g: g.apply_on_neighbors(
                P.EdgesApply(classify)), apply_want),
            "apply torch": (lambda g: g.apply_on_neighbors(
                P.TorchEdgesApply(
                    lambda vid, nbrs, vals, mask:
                    torch.where(mask, vals, 0).sum(-1),
                    emit=lambda vid, row: (vid, "big" if row[0] > 50
                                           else "small"))), apply_want)}
        for label, (op, table) in cases.items():
            got = run(direction, op)
            require(got == sorted(table[direction]), "api golden %s %s: "
                    "%s" % (label, direction, got))


def api_graph(P, src, dst, ts):
    """A SimpleEdgeStream over (src, dst) at event times ts (ms), edge
    values bench.py's reduce-leg weights, on a fresh environment on the
    card."""
    env = P.StreamEnvironment(clock=P.ManualClock(0))
    edges = env.from_collection(
        [P.Edge(s, d, t) for s, d, t in zip(src.tolist(), dst.tolist(),
                                            ts.tolist())])
    graph = P.SimpleEdgeStream(
        edges, env,
        timestamp_extractor=P.AscendingTimestampExtractor(lambda e: e.value))
    return env, graph.map_edges(
        lambda e: 1 + (e.source + 3 * e.target) % 97)


def phase_api(dev) -> dict:
    """The record API on the card: the nine TestSlice goldens through
    host and Torch* UDFs; the first API_RUN_EDGES of API_EDGES timestamped
    edges (API_EDGES_PER_MS edges a ms) through slice(512 ms,
    ALL).reduce_on_edges(
    TorchEdgesReduce(name="sum")), every window equal to numpy, launch
    counts set to 0 just before and read just after; WindowTriangleCount
    over the same graph at API_TRI_MS, both routes of triangle_count
    taken, every window equal to ops/host_triangles; get_degrees() over
    the first API_DEGREE_EDGES edges (a host-only path, cut to a prefix
    to keep the script's time) equal to a numpy running degree."""
    import gelly_streaming_tpu_torch as P
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.models.triangles import \
        WindowTriangleCount
    from gelly_streaming_tpu_torch.ops import host_triangles

    t0 = time.perf_counter()
    api_goldens(dev)
    golden_s = time.perf_counter() - t0
    src, dst = (a[:API_RUN_EDGES]
                for a in P.make_stream(API_EDGES, VB, seed=SEED))
    ts = np.arange(API_RUN_EDGES) // API_EDGES_PER_MS
    res = {"goldens_seconds": golden_s}

    # reduce_on_edges over 512 ms tumbling windows, direction ALL
    env, graph = api_graph(P, src, dst, ts)
    out = graph.slice(P.Time.milliseconds_of(API_WINDOW_MS),
                      P.EdgeDirection.ALL).reduce_on_edges(
        P.TorchEdgesReduce(name="sum")).collect()
    kernels.reset_launches()
    t0 = time.perf_counter()
    env.execute()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    n_win = check_api_reduce("api", env._results[out.node.id], src, dst,
                             ts)
    require(launches["cell_reduce"] == n_win,
            "api: %d cell_reduce launches for %d windows"
            % (launches["cell_reduce"], n_win))
    res["reduce"] = {"edges": API_RUN_EDGES, "windows": n_win,
                     "seconds": wall, "edges_per_s": API_RUN_EDGES / wall,
                     "launches": launches["cell_reduce"]}
    # where its time goes: a 1/8 prefix of the same job, profiled
    k = API_EDGES // 8
    penv, pgraph = api_graph(P, src[:k], dst[:k], ts[:k])
    pgraph.slice(P.Time.milliseconds_of(API_WINDOW_MS),
                 P.EdgeDirection.ALL).reduce_on_edges(
        P.TorchEdgesReduce(name="sum")).collect()
    prof = profile_run(penv.execute, retry=False)
    res["reduce"]["profiled_edges"] = k
    res["reduce"]["idle_share"] = prof["idle_share"]
    res["reduce"]["host_share"] = prof["idle_share"]
    res["reduce"]["device_busy_ms"] = prof["device_busy_ms"]
    res["reduce"]["profiled_wall_ms"] = prof["wall_ms"]

    # WindowTriangleCount at two window sizes: the dense and sparse routes
    routes = {"dense": 0, "sparse": 0}
    tri_launches = {}
    for size in API_TRI_MS:
        env, graph = api_graph(P, src, dst, ts)
        out = WindowTriangleCount(P.Time.milliseconds_of(size)).run(
            graph).collect()
        kernels.reset_launches()
        t0 = time.perf_counter()
        env.execute()
        wall = time.perf_counter() - t0
        tri_launches[size] = {k: v for k, v in kernels.LAUNCHES.items()
                              if v}
        counts = env.results_of(out)
        win = ts // size
        n_w = int(win[-1]) + 1
        require(len(counts) == n_w, "triangles %d ms: %d windows"
                % (size, len(counts)))
        here = {"dense": 0, "sparse": 0}
        for w, (count, wmax) in enumerate(counts):
            m = win == w
            nv = len(np.unique(np.concatenate([src[m], dst[m]])))
            here["dense" if nv <= DENSE_MAX_V else "sparse"] += 1
            require(wmax == w * size + size - 1 and count ==
                    host_triangles.window_count(src[m], dst[m]),
                    "triangles %d ms window %d: %d" % (size, w, count))
        require(tri_launches[size].get("dense_triangles", 0) ==
                here["dense"] and tri_launches[size].get("intersect", 0) ==
                here["sparse"], "triangles %d ms: launches %s for routes %s"
                % (size, tri_launches[size], here))
        for r in routes:
            routes[r] += here[r]
        res["triangles_%dms" % size] = {
            "windows": n_w, "routes": here, "seconds": wall,
            "edges_per_s": API_RUN_EDGES / wall,
            "launches": tri_launches[size]}
    require(routes["dense"] > 0 and routes["sparse"] > 0,
            "triangles: routes %s" % routes)

    # get_degrees (BASELINE config #1): a running degree a contribution
    m = API_DEGREE_EDGES
    env, graph = api_graph(P, src[:m], dst[:m], ts[:m])
    out = graph.get_degrees().collect()
    t0 = time.perf_counter()
    env.execute()
    wall = time.perf_counter() - t0
    got = env.results_of(out)
    ids = np.stack([src[:m], dst[:m]], 1).reshape(-1)
    order = np.argsort(ids, kind="stable")
    run = np.empty(len(ids), np.int64)
    first = np.r_[0, np.flatnonzero(np.diff(ids[order])) + 1]
    starts = np.repeat(first, np.diff(np.r_[first, len(ids)]))
    run[order] = np.arange(len(ids)) - starts + 1
    require(len(got) == len(ids)
            and [v.id for v in got] == ids.tolist()
            and [v.value for v in got] == run.tolist(),
            "api get_degrees differs from the numpy running degree")
    res["degrees"] = {"edges": m, "records": len(got), "seconds": wall,
                      "edges_per_s": m / wall}
    print(json.dumps({"api": dict(res, routes=routes,
                                  device=torch.cuda.get_device_name(0))}))
    print("phase api: ok  goldens 9 × 2 forms; reduce_on_edges %d windows "
          "%.1f edges/s (host share %s); triangles %s routes %s; degrees "
          "%.1f edges/s"
          % (n_win, res["reduce"]["edges_per_s"],
             res["reduce"]["host_share"],
             {s: round(res["triangles_%dms" % s]["edges_per_s"], 1)
              for s in API_TRI_MS}, routes,
             res["degrees"]["edges_per_s"]))
    return {"cell_reduce": launches["cell_reduce"],
            "edges_per_s": res["reduce"]["edges_per_s"]}


def check_api_reduce(label: str, records, src, dst, ts) -> int:
    """Every window of the record API's slice(API_WINDOW_MS, ALL)
    .reduce_on_edges(sum) job (`records`, the sink's (value, ts) pairs)
    equal to numpy's sums of the edges' weights; returns the windows."""
    weight = 1 + (src + 3 * dst) % 97
    n_win = -(-len(src) // (API_WINDOW_MS * API_EDGES_PER_MS))
    win = ts // API_WINDOW_MS
    got = {}
    for (vid, value), wmax in records:
        got.setdefault(wmax, []).append((vid, value))
    require(len(got) == n_win, "%s: %d windows" % (label, len(got)))
    for w in range(n_win):
        m = win == w
        ids = np.concatenate([src[m], dst[m]])
        sums = np.bincount(ids, np.concatenate([weight[m], weight[m]]),
                           minlength=VB)
        have = np.flatnonzero(np.bincount(ids, minlength=VB))
        rows = sorted(got[w * API_WINDOW_MS + API_WINDOW_MS - 1])
        require([r[0] for r in rows] == have.tolist()
                and [r[1] for r in rows] == sums[have].astype(np.int64)
                .tolist(), "%s reduce window %d differs" % (label, w))
    return n_win


# ----------------------------------------------------------------------
# the summary-aggregation models and the driver's sliding windows
# ----------------------------------------------------------------------
MODEL_WINDOW_MS = 4096              # the models' merge window (ts = index)
MODEL_BATCH = 32768                 # the iterative CC's batch
MODEL_SAMPLE_EDGES = 65536          # the estimators' prefix (131072 to
                                    # PR 21; cut, PR 22)
MODEL_SAMPLES = 64
MODEL_STATE_EDGES = 16384           # the samplers' determinism prefix
SLIDE_EDGES = 2_097_152             # phase driver_slide: the stream's prefix
SLIDE = 8192                        # its pane: 256 emissions


def canonical_components(src, dst, n: int) -> np.ndarray:
    """Each vertex's smallest same-component vertex, by scipy's
    connected_components over the undirected graph."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    adj = coo_matrix((np.ones(len(src), np.int8), (src, dst)), (n, n))
    k, lab = connected_components(adj, directed=False)
    mins = np.full(k, n, np.int64)
    np.minimum.at(mins, lab, np.arange(n))
    return mins[lab]


def double_cover_bipartite(src, dst, n: int) -> bool:
    """The host double-cover check: bipartite iff no vertex's two cover
    copies share a component."""
    lab = canonical_components(np.concatenate([src, src + n]),
                               np.concatenate([dst + n, dst]), 2 * n)
    return not bool((lab[:n] == lab[n:]).any())


def disjoint_set_components(ds, n: int) -> np.ndarray:
    """canonical_components' form of a DisjointSet over ids 0..n-1."""
    out = np.full(n, -1, np.int64)
    for members in ds.components().values():
        out[members] = min(members)
    return out


def bipartite_citation_stream():
    """A bipartite stream of the citation stream's size and shape, made
    from its seed: each cited paper moved to the citing paper's other
    parity side (w -> w ^ 1 where w's parity matches), so the graph is
    bipartite by parity."""
    from gelly_streaming_tpu_torch.utils.realgraph import citation_stream

    src, dst, ts = citation_stream()
    same = (src & 1) == (dst & 1)
    dst = np.where(same, dst ^ 1, dst).astype(np.int32)
    return src, dst, ts


def model_run(P, model, src, dst, ts):
    """graph.aggregate(model) over (src, dst) at event times ts on a
    fresh environment on the card; returns (final state, emissions,
    seconds)."""
    env = P.StreamEnvironment(clock=P.ManualClock(0))
    edges = env.from_collection(
        [P.Edge(s, d, t) for s, d, t in zip(src.tolist(), dst.tolist(),
                                            ts.tolist())])
    graph = P.SimpleEdgeStream(
        edges, env,
        timestamp_extractor=P.AscendingTimestampExtractor(lambda e: e.value))
    out = graph.aggregate(model).collect()
    t0 = time.perf_counter()
    env.execute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    states = env.results_of(out)
    return states[-1], len(states), wall


def uf_work(n: int, ne: int, carried: bool) -> tuple:
    """(bytes, operations) of a union-find call over n slots and ne
    edges: the labels read and written once (4 B a slot each way), 8 B
    an edge; a union an edge (two root reads and a min) and a pass a
    slot, two with `carried` (its links)."""
    return 8 * n + 8 * ne, 3 * ne + (2 if carried else 1) * n


def uf_launch_rows(fn, reps: int, names: tuple) -> tuple:
    """(device ms a call, {kernel name: device launches}, launch calls)
    of `reps` calls of fn() under torch.profiler, one warm call first:
    the device ms a call sums each kernel's mean over the launches the
    profile kept; the launch calls are the profile's host-side record
    of launch API calls (utils/profiling.device_times). A profile that
    keeps fewer than reps - 1 launches of a kernel of `names` is taken
    again where the API rows confirm the launches (take_profile)."""
    fn()

    def whole(rows, _before):
        return all(sum(n for k, (_ms, n) in rows.items() if name in k)
                   >= reps - 1 for name in names)

    from gelly_streaming_tpu_torch.utils.profiling import device_times

    def run():
        for _ in range(reps):
            fn()

    _wall, rows, _before = take_profile(run, whole)
    # the launch API calls of one more profiled run, counted by the
    # profiler itself
    _w, _rows, calls = device_times(run, launch_calls=True)
    require(rows, "no device rows in a profile of %d union-find calls"
            % reps)
    per_call = sum(ms / n for ms, n in rows.values())
    return per_call, {k: n for k, (_ms, n) in rows.items()}, calls


# the device kernels each tier of the union-find's plan launches a call
UF_TIER_KERNELS = {"grid": ("cc_grid_kernel",),
                   "four launches": ("init_kernel", "edge_kernel",
                                     "compress_kernel")}


def time_union_find(label, lab0, s, d, carried: bool, reps: int,
                    one_launch: bool) -> dict:
    """cc_fixpoint against its plain version on one call's tensors:
    equal labels, its plan, CUDA-event and profiled device ms of each,
    the bound. The profile must show the plan tier's kernels, one launch
    of each a call (the profiler may miss one of a run); with
    `one_launch` (the calls the models make) that tier must be one
    launch."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    got = uf.cc_fixpoint(lab0, s, d, carried)
    want = uf.cc_fixpoint_plain(lab0, s, d, carried)
    err = int((got.long() - want.long()).abs().max())
    require(err == 0, "cc_fixpoint %s: kernel != plain" % label)
    n, ne = lab0.numel(), s.numel()
    plan = uf.plan(n, ne, lab0.device)
    b_ms, b_by = bound(*uf_work(n, ne, carried))
    names = UF_TIER_KERNELS[plan["tier"]]
    if carried and plan["tier"] == "four launches":
        names += ("link_kernel",)
    dev_ms, rows, calls = uf_launch_rows(
        lambda: uf.cc_fixpoint(lab0, s, d, carried), reps, names)
    # the device rows hold only the plan's kernels, each at most once a
    # call, and the launch API was called len(names) times a call
    require((not one_launch or len(names) == 1)
            and len(rows) == len(names)
            and all(any(k in row for row in rows) for k in names)
            and all(0 < n_ <= reps for n_ in rows.values())
            and calls == reps * len(names),
            "cc_fixpoint %s: plan %s, %d calls made device launches %s "
            "and %d launch calls" % (label, plan, reps, rows, calls))
    res = {"slots": n, "edges": ne, "carried": carried, "plan": plan,
           "ms": cuda_ms(lambda: uf.cc_fixpoint(lab0, s, d, carried), reps),
           "device_ms": dev_ms, "device_launches": rows,
           "launch_calls": calls,
           "plain_ms": cuda_ms(lambda: uf.cc_fixpoint_plain(
               lab0, s, d, carried), 3),
           "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err}
    print("  cc_fixpoint %s: %d slots, %d edges (%s, %d blocks): %.4f ms "
          "(device %.4f; %d calls: %d launch calls, device rows %s), plain "
          "%.3f ms, bound %.5f ms (%s)"
          % (label, n, ne, plan["tier"], plan["blocks"], res["ms"],
             res["device_ms"], reps, calls, sorted(rows.values()),
             res["plain_ms"], b_ms, b_by))
    return res


UF_GRID_EDGES = 1 << 17            # csrc/window_summary.cu kGridEdges
# (kind, slots, edges, the plan's tier) of union_find_edge_cases
UF_EDGE_CASES = (("one_slot", 1, 0, "grid"),
                 ("no_edges", 65537, 0, "grid"),
                 ("cross_ranks", 32769, 3 * 32768, "grid"),
                 ("out_of_range", 65537, UF_GRID_EDGES, "grid"),
                 ("long_chains", 65537, UF_GRID_EDGES + 1, "four launches"),
                 ("long_chains", 131073, UF_GRID_EDGES, "grid"),
                 ("out_of_range", 131073, UF_GRID_EDGES + 1,
                  "four launches"))


def union_find_edge_cases(dev) -> dict:
    """The union-find kernel against its plain version on the
    tier_fixtures cases of UF_EDGE_CASES (edges out of range compared
    with the plain fixpoint over the edges the kernel folds; the blocks'
    runs those of the plan's grid): n = 1, a carried forest of chains
    with no edge, and both sides of the plan's one threshold, at
    UF_GRID_EDGES edges (one cooperative launch) and one more (four
    launches). Each call's plan is the case's, its profile's launch API
    rows that tier's launches (one cooperative launch; or one
    cudaLaunchKernel a kernel of the four launches), and the device rows
    the profile kept only that tier's kernels, once each. Returns {case:
    plan}."""
    from gelly_streaming_tpu_torch.ops import unionfind as uf
    from gelly_streaming_tpu_torch.utils import tier_fixtures as tf

    out = {}
    for i, (kind, n, ne, tier) in enumerate(UF_EDGE_CASES):
        C = uf.plan(n, ne, dev)["blocks"]
        lab0, src, dst, carried = tf.union_find_case(kind, n, ne, C, seed=i)
        fs, fd = tf.in_range_edges(src, dst, len(lab0))
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (lab0, src, dst, fs, fd)]
        label = "%s n=%d ne=%d" % (kind, len(lab0), len(src))
        plan = uf.plan(len(lab0), len(src), dev)
        require(plan["tier"] == tier, "cc_fixpoint %s: plan %s, not %s"
                % (label, plan, tier))
        got = uf.cc_fixpoint(t[0], t[1], t[2], carried)
        want = uf.cc_fixpoint_plain(t[0], t[3], t[4], carried)
        require(torch.equal(got, want), "cc_fixpoint %s: kernel != plain"
                % label)
        names = UF_TIER_KERNELS[tier]
        if carried and tier == "four launches":
            names += ("link_kernel",)
        api, rows = launch_api_calls(
            lambda: uf.cc_fixpoint(t[0], t[1], t[2], carried), 1)
        want_api = ({"cudaLaunchCooperativeKernel": 1} if tier == "grid"
                    else {"cudaLaunchKernel": len(names)})
        require(api == want_api
                and all(any(k in r for k in names) and n_ == 1
                        for r, n_ in rows.items()),
                "cc_fixpoint %s: plan %s, one call made launch calls %s, "
                "device rows %s" % (label, plan, api, rows))
        out[label] = plan
    print("  cc_fixpoint tier fixtures: ok  %s" % out)
    return out


def union_find_cases(src, dst, carry, dev) -> dict:
    """The union-find kernel timed at the models' sizes: one merge
    window of each model (the middle one), padded as ops/unionfind's
    host wrappers pad it; the whole citation graph in one fresh call and
    its double cover at 2·V; and a carried batch of MODEL_BATCH edges,
    `carry` = (the iterative CC's labels before its last full batch, the
    batch's slots, the vertex count after it), laid out as its
    process_batch lays them out."""
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import unionfind as uf

    def fresh(s, d, n):
        eb, vb = seg.bucket_size(len(s)), seg.bucket_size(n)
        st, dt = uf._padded_edges(s, d, eb, vb, dev)
        return torch.arange(vb + 1, dtype=torch.int32, device=dev), st, dt

    cases = {}
    w = len(src) // MODEL_WINDOW_MS // 2
    m = slice(w * MODEL_WINDOW_MS, (w + 1) * MODEL_WINDOW_MS)
    uniq, (ws, wd) = seg.intern(src[m], dst[m])
    cases["cc_window"] = time_union_find(
        "cc window", *fresh(ws, wd, len(uniq)), False, 50, True)
    cs, cd = uf.double_cover_edges(ws, wd, len(uniq))
    cases["bipartite_window"] = time_union_find(
        "bipartite window", *fresh(cs, cd, 2 * len(uniq)), False, 50, True)
    n = int(max(src.max(), dst.max())) + 1
    cases["cc_graph"] = time_union_find("cc graph", *fresh(src, dst, n),
                                        False, 10, False)
    cs, cd = uf.double_cover_edges(src, dst, n)
    cases["bipartite_graph"] = time_union_find(
        "bipartite graph", *fresh(cs, cd, 2 * n), False, 10, False)
    labels, slot_s, slot_d, nv = carry
    vb = seg.bucket_size(nv)
    st, dt = uf._padded_edges(slot_s, slot_d, seg.bucket_size(len(slot_s)),
                              vb, dev)
    lab0 = torch.from_numpy(np.concatenate([
        labels, np.arange(len(labels), vb + 1, dtype=np.int32)])).to(dev)
    cases["carried_batch"] = time_union_find("carried batch", lab0, st, dt,
                                             True, 20, True)
    return cases


def phase_models(dev) -> dict:
    """The summary-aggregation models on the card over the synthetic
    cit-HepPh stream (421,578 edges, 34,546 vertices, ts = arrival
    index), with the launch counts set to 0 just before and read just
    after each model path: aggregate(TorchConnectedComponents(4096)),
    its final components equal to the host ConnectedComponents' on the
    same stream and to scipy's, profiled for the card's idle share;
    aggregate(TorchBipartitenessCheck(4096)), its verdict equal to a
    host double-cover check; both again on a bipartite stream of the
    same size (verdict true); TorchIterativeConnectedComponents in
    batches of MODEL_BATCH, its final labels equal to a host
    DisjointSet's components; the weighted matching over the stream
    with seeded weights (a matching, and every ADD worth more than twice
    the edges it removed); both sampling estimators on a prefix,
    their samplers deterministic on a repeat. Then the union-find kernel
    timed at the models' sizes. Returns the kernel row's numbers."""
    import gelly_streaming_tpu_torch as P
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.models import (
        ConnectedComponents, TorchBipartitenessCheck,
        TorchConnectedComponents, TorchIterativeConnectedComponents)
    from gelly_streaming_tpu_torch.models.matching import \
        centralized_weighted_matching
    from gelly_streaming_tpu_torch.models.sampling_triangles import (
        EdgeSampleRouter, VectorTriangleSampler, broadcast_triangle_count,
        incidence_sampling_triangle_count)
    from gelly_streaming_tpu_torch.utils.disjoint_set import DisjointSet
    from gelly_streaming_tpu_torch.utils.events import MatchingEventType
    from gelly_streaming_tpu_torch.utils.realgraph import citation_stream

    src, dst, ts = citation_stream()
    n = int(max(src.max(), dst.max())) + 1
    require(len(src) == 421_578 and n == 34_546,
            "citation stream: %d edges over %d vertices" % (len(src), n))
    want_cc = canonical_components(src, dst, n)
    res = {"edges": len(src), "vertices": n, "window_ms": MODEL_WINDOW_MS}
    launches = {}

    # connected components on the card, profiled: edges/s and idle share
    kernels.reset_launches()
    box = {}

    def cc_run():
        box["state"], box["emissions"], box["seconds"] = model_run(
            P, TorchConnectedComponents(MODEL_WINDOW_MS), src, dst, ts)

    wall_ms, by_name, _before = take_profile(
        cc_run, lambda rows, _b: bool(rows), kernels.reset_launches)
    launches["cc"] = kernels.LAUNCHES["cc_fixpoint"]
    require(launches["cc"] == box["emissions"] > 100,
            "cc: %d cc_fixpoint launches for %d windows"
            % (launches["cc"], box["emissions"]))
    require(np.array_equal(disjoint_set_components(box["state"], n),
                           want_cc), "cc: components differ from scipy's")
    busy = sum(ms for ms, _n in by_name.values())
    require(busy > 0, "cc: the profile has no device rows")
    res["cc"] = {"windows": box["emissions"], "seconds": box["seconds"],
                 "edges_per_s": len(src) / box["seconds"],
                 "profiled_wall_ms": wall_ms, "device_busy_ms": busy,
                 "idle_share": 1 - busy / wall_ms,
                 "device_ms_by_name": {k: v[0] for k, v in by_name.items()}}
    host_state, _k, host_s = model_run(
        P, ConnectedComponents(MODEL_WINDOW_MS), src, dst, ts)
    require(np.array_equal(disjoint_set_components(host_state, n), want_cc),
            "cc: the host ConnectedComponents differs from scipy's")
    res["cc"]["host_seconds"] = host_s

    # bipartiteness on the card: the citation stream (odd cycles) and a
    # bipartite stream of its size
    bsrc, bdst, bts = bipartite_citation_stream()
    for label, (s, d, t) in (("bipartiteness", (src, dst, ts)),
                             ("bipartiteness_bipartite", (bsrc, bdst, bts))):
        kernels.reset_launches()
        cand, k, wall = model_run(
            P, TorchBipartitenessCheck(MODEL_WINDOW_MS), s, d, t)
        launches[label] = kernels.LAUNCHES["cc_fixpoint"]
        want = double_cover_bipartite(s, d, n)
        require(launches[label] == k and cand.success == want,
                "%s: verdict %s, want %s, %d launches for %d windows"
                % (label, cand.success, want, launches[label], k))
        if want:
            seen = sorted(v for comp in cand.map.values() for v in comp)
            require(seen == sorted(set(s.tolist()) | set(d.tolist())),
                    "%s: the candidates miss vertices" % label)
        res[label] = {"windows": k, "seconds": wall, "verdict": want,
                      "edges_per_s": len(s) / wall}
    require(not res["bipartiteness"]["verdict"]
            and res["bipartiteness_bipartite"]["verdict"],
            "bipartiteness: verdicts %s" % res)
    kernels.reset_launches()
    state, k, wall = model_run(P, TorchConnectedComponents(MODEL_WINDOW_MS),
                               bsrc, bdst, bts)
    launches["cc_bipartite"] = kernels.LAUNCHES["cc_fixpoint"]
    require(launches["cc_bipartite"] == k and np.array_equal(
        disjoint_set_components(state, n),
        canonical_components(bsrc, bdst, n)),
            "cc on the bipartite stream differs from scipy's")
    res["cc_bipartite"] = {"windows": k, "seconds": wall,
                           "edges_per_s": len(bsrc) / wall}

    # iterative CC in batches, labels carried on the card
    kernels.reset_launches()
    model = TorchIterativeConnectedComponents()
    batches = range(0, len(src), MODEL_BATCH)
    last_full = (len(src) // MODEL_BATCH - 1) * MODEL_BATCH
    t0 = time.perf_counter()
    for at in batches:
        if at == last_full:
            before = model.state_dict()["labels"].copy()
        model.process_batch(src[at:at + MODEL_BATCH],
                            dst[at:at + MODEL_BATCH])
    wall = time.perf_counter() - t0
    launches["iterative_cc"] = kernels.LAUNCHES["cc_fixpoint"]
    require(launches["iterative_cc"] == len(batches),
            "iterative cc: %d launches for %d batches"
            % (launches["iterative_cc"], len(batches)))
    host = DisjointSet()
    for a, b in zip(src.tolist(), dst.tolist()):
        host.union(a, b)
    st = model.state_dict()
    ids = np.asarray(st["ids"], np.int64)
    got = np.full(n, -1, np.int64)
    got[ids] = ids[st["labels"]]
    roots = np.full(n, n, np.int64)
    np.minimum.at(roots, got, np.arange(n))
    require(np.array_equal(roots[got], disjoint_set_components(host, n)),
            "iterative cc: labels differ from the host DisjointSet's")
    res["iterative_cc"] = {"batches": len(batches), "seconds": wall,
                           "edges_per_s": len(src) / wall}

    # weighted matching with seeded weights, on the host by design
    weight = np.random.default_rng(SEED).integers(1, 1000, len(src))
    env = P.StreamEnvironment(clock=P.ManualClock(0))
    out = centralized_weighted_matching(env.from_collection(
        [P.Edge(a, b, w) for a, b, w in zip(src.tolist(), dst.tolist(),
                                            weight.tolist())])).collect()
    t0 = time.perf_counter()
    env.execute()
    wall = time.perf_counter() - t0
    matched, by_vertex, removed, adds = {}, {}, [], 0
    for ev in env.results_of(out):
        e = ev.edge
        if ev.type == MatchingEventType.REMOVE:
            require(matched.pop(e, None) is not None,
                    "matching: REMOVE of an unmatched edge")
            for v in (e.source, e.target):
                by_vertex.pop(v)
            removed.append(e.value)
            continue
        require(e.source not in by_vertex and e.target not in by_vertex
                and e.value > 2 * sum(removed),
                "matching: ADD %s breaks the 2x rule or the matching" % (e,))
        matched[e] = True
        by_vertex[e.source] = by_vertex[e.target] = e
        removed, adds = [], adds + 1
    res["matching"] = {"seconds": wall, "edges_per_s": len(src) / wall,
                       "adds": adds, "matched": len(matched),
                       "weight": int(sum(e.value for e in matched))}

    # the sampling estimators on a prefix; at this many vertices their
    # samples rarely close a wedge, so determinism is held on the
    # samplers' state after the same edges, twice
    k = MODEL_SAMPLE_EDGES
    prefix = [P.Edge(a, b, P.NULL) for a, b in zip(src[:k].tolist(),
                                                    dst[:k].tolist())]
    for label, fn in (("broadcast", broadcast_triangle_count),
                      ("incidence", incidence_sampling_triangle_count)):
        env = P.StreamEnvironment(clock=P.ManualClock(0))
        out = fn(env.from_collection(prefix), MODEL_SAMPLES, n).collect()
        t0 = time.perf_counter()
        env.execute()
        wall = time.perf_counter() - t0
        got = env.results_of(out)
        res[label] = {"edges": k, "samples": MODEL_SAMPLES, "seconds": wall,
                      "edges_per_s": k / wall, "emissions": len(got),
                      "estimate": got[-1][1] if got else 0}

    def sampler_states():
        vec = VectorTriangleSampler(MODEL_SAMPLES, n)
        router = EdgeSampleRouter(MODEL_SAMPLES, 1)
        for e in prefix[:MODEL_STATE_EDGES]:
            vec(e, lambda _rec: None)
            router(e, lambda _rec: None)
        return (vec.src, vec.trg, vec.third, vec.beta, router.sample_src,
                router.sample_trg)

    first, again = sampler_states(), sampler_states()
    require(all(np.array_equal(a, b) for a, b in zip(first, again))
            and (first[2] >= 0).all() and (first[4] >= 0).all(),
            "sampling estimators: not deterministic on a repeat")

    # the last full batch as its call got it: the labels before it, its
    # edges as slots (stable: the final id table gives them)
    slot = np.zeros(n, np.int32)
    slot[ids] = np.arange(len(ids), dtype=np.int32)
    m = slice(last_full, last_full + MODEL_BATCH)
    nv = len(np.unique(np.concatenate([ids[:len(before)], src[m], dst[m]])))
    res["launches"] = launches
    res["union_find"] = union_find_cases(
        src, dst, (before, slot[src[m]], slot[dst[m]], nv), dev)
    res["union_find_tiers"] = union_find_edge_cases(dev)
    print(json.dumps({"models": dict(res,
                                     device=torch.cuda.get_device_name(0))}))
    print("phase models: ok  cc %.1f edges/s (idle %.4f, host fold %.1f s), "
          "bipartiteness %.1f / %.1f edges/s (verdicts false / true), "
          "iterative cc %.1f, matching %.1f, estimators %.1f / %.1f edges/s; "
          "cc_fixpoint launches %s"
          % (res["cc"]["edges_per_s"], res["cc"]["idle_share"],
             res["cc"]["host_seconds"],
             res["bipartiteness"]["edges_per_s"],
             res["bipartiteness_bipartite"]["edges_per_s"],
             res["iterative_cc"]["edges_per_s"],
             res["matching"]["edges_per_s"],
             res["broadcast"]["edges_per_s"],
             res["incidence"]["edges_per_s"], launches))
    # the kernels line: a merge window's call, bound by its launches, so
    # its ms is the profiled device time (as the cell reduce's)
    window = res["union_find"]["cc_window"]
    return {"ms": window["device_ms"], "plain_ms": window["plain_ms"],
            "bound_ms": window["bound_ms"], "bound_by": window["bound_by"],
            "max_abs_err": max(c["max_abs_err"]
                               for c in res["union_find"].values()),
            "launches": launches["cc"]}


def phase_driver_slide(dev) -> dict:
    """The driver's sliding windows: StreamingAnalyticsDriver(window_ms=1,
    edge_bucket=32768, vertex_bucket=65536, slide=8192) over the first
    SLIDE_EDGES edges of the north-star stream in one call (launch
    counts set to 0 just before, read just after): 256 emissions, each
    emission's triangles equal to count_windows over the raw trailing
    slice of 32768 edges rebuilt on the host, the cumulative fields
    equal to a tumbling driver at edge_bucket=8192, and a checkpoint
    taken inside a call mid pane ring resumed to equal results."""
    import tempfile

    from gelly_streaming_tpu_torch import (StreamingAnalyticsDriver,
                                           TriangleWindowKernel, kernels)

    src, dst = bench_stream()
    src, dst = src[:SLIDE_EDGES], dst[:SLIDE_EDGES]
    num_e = SLIDE_EDGES // SLIDE

    def driver(**kw):
        return StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                        vertex_bucket=VB, **kw)

    warm = driver(slide=SLIDE)
    warm.run_arrays(src[:2 * EB], dst[:2 * EB])
    torch.cuda.synchronize()
    drv = driver(slide=SLIDE)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = drv.run_arrays(src, dst)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    for name in ("window_snapshot", "window_counter"):
        require(launches[name] > 0, "kernel %s was not launched on the "
                "sliding driver's path" % name)
    require(len(got) == num_e, "%d emissions, want %d" % (len(got), num_e))
    no_demotions("phase driver_slide", drv)

    trailing = [(src[max(0, (i + 1) * SLIDE - EB):(i + 1) * SLIDE]
                 .astype(np.int32),
                 dst[max(0, (i + 1) * SLIDE - EB):(i + 1) * SLIDE]
                 .astype(np.int32)) for i in range(num_e)]
    want = TriangleWindowKernel(EB, VB).count_windows(trailing)
    require([r.triangles for r in got] == list(want),
            "driver slide: triangles differ from the raw trailing slices'")
    require(all(r.num_edges == SLIDE and r.window_start == i * SLIDE
                for i, r in enumerate(got)), "driver slide: emission cuts")

    panes = StreamingAnalyticsDriver(
        window_ms=1, edge_bucket=SLIDE, vertex_bucket=VB,
        analytics=("degrees", "cc", "bipartite")).run_arrays(src, dst)
    require(len(panes) == num_e, "pane tumbling: %d windows" % len(panes))
    for i, (a, b) in enumerate(zip(got, panes)):
        for f in ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            require(x.dtype == y.dtype and np.array_equal(x, y),
                    "driver slide emission %d: %s differs from pane "
                    "tumbling" % (i, f))

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "slide.npz")
        first = driver(slide=SLIDE)
        first.enable_auto_checkpoint(path, every_n_windows=64)
        first.run_arrays(src[:100 * SLIDE], dst[:100 * SLIDE])
        second = driver(slide=SLIDE)
        require(second.try_resume(path), "no checkpoint to resume")
        done = second.windows_done
        require(done == 64 and len(second.state_dict()["pane_ring_src"])
                == EB // SLIDE - 1, "resumed at window %d" % done)
        rest = second.run_arrays(src[done * SLIDE:], dst[done * SLIDE:])
    same_results("driver slide resumed", got[done:], rest, offset=done)
    res = {"edges": SLIDE_EDGES, "emissions": num_e, "eb": EB, "vb": VB,
           "slide": SLIDE, "seconds": wall,
           "edges_per_s": SLIDE_EDGES / wall, "launches": launches,
           "resumed_at": done, "device": torch.cuda.get_device_name(0)}
    print(json.dumps({"driver_slide": res}))
    print("phase driver_slide: ok  %d emissions  %.1f edges/s  launches "
          "window_counter %d, window_snapshot %d"
          % (num_e, SLIDE_EDGES / wall, launches["window_counter"],
             launches["window_snapshot"]))
    return launches


# ----------------------------------------------------------------------
# the resident tier and the dispatch autotuner
# ----------------------------------------------------------------------
AUTOTUNE_PASSES = 3                # tuned passes of each autotuned path
RESIDENT_RESUME = 256              # the resident resumes: a super-batch in


class knob_env:
    """Set GS_* environment knobs for a block, restoring them after."""

    def __init__(self, **knobs):
        self.knobs = {k: str(v) for k, v in knobs.items()}
        self.saved = {}

    def __enter__(self):
        for k, v in self.knobs.items():
            self.saved[k] = os.environ.get(k)
            os.environ[k] = v
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def timed(run) -> float:
    """Host seconds of run(), ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def same_carry(label, got, want) -> None:
    for name, a, b in zip(("deg", "labels", "cover"), got, want):
        require(np.array_equal(a, b), "%s: final carry %s differs"
                % (label, name))


def phase_autotune(dev, counts: list, summaries: list, state: dict) -> dict:
    """The online dispatch tuner (ops/autotune.py) on, exploring every
    second round (GS_AUTOTUNE_EXPLORE=2), over the 320-window stream:
    TriangleWindowKernel(32768, 65536).count_stream and
    StreamSummaryEngine(32768, 65536).process, wire untied (the tuner
    moves wb, K and the wire; the engine wb and the wire), three passes
    each, every pass's counts equal to phase stream's and summaries and
    final carry to phase summary_stream's; each pass's edges/s beside
    the static path's (GS_AUTOTUNE=0) in the same phase; each tuner's
    summary printed. A summary checkpoint taken mid-stream carries
    "autotune"; a fresh engine loads it, holds the same incumbent and
    finishes the stream equal. No promotion is required: they depend on
    timing."""
    from gelly_streaming_tpu_torch import (StreamSummaryEngine,
                                           TriangleWindowKernel, kernels)

    src, dst = bench_stream()
    num_w = STREAM_EDGES // EB
    report = {}
    with knob_env(GS_AUTOTUNE=0):
        static_tri = TriangleWindowKernel(EB, VB)
        static_tri.count_stream(src, dst)
        static_eng = StreamSummaryEngine(EB, VB)
        static_eng.warm_fallback()
        static_eng.process(src, dst)

    def static_rates():
        with knob_env(GS_AUTOTUNE=0):
            t_tri = timed(lambda: static_tri.count_stream(src, dst))
            static_eng.reset()
            t_sum = timed(lambda: static_eng.process(src, dst))
        return STREAM_EDGES / t_tri, STREAM_EDGES / t_sum

    with knob_env(GS_AUTOTUNE=1, GS_AUTOTUNE_EXPLORE=2):
        kern = TriangleWindowKernel(EB, VB)
        require(kern.device.type == "cuda", "tuned kernel not on the card")
        eng = StreamSummaryEngine(EB, VB)
        eng.warm_fallback()
        passes = []
        kernels.reset_launches()
        for p in range(AUTOTUNE_PASSES):
            tri_static, sum_static = static_rates()
            got = []
            t_tri = timed(lambda: got.append(kern.count_stream(src, dst)))
            require(got[0] == counts, "autotune: pass %d counts differ from "
                    "the static path's" % p)
            eng.reset()
            t_sum = timed(lambda: got.append(eng.process(src, dst)))
            require(got[1] == summaries, "autotune: pass %d summaries differ "
                    "from the static path's" % p)
            same_carry("autotune pass %d" % p, eng.state_dict()["carry"],
                       state["carry"])
            passes.append({
                "triangle_edges_per_s": STREAM_EDGES / t_tri,
                "triangle_static_edges_per_s": tri_static,
                "summary_edges_per_s": STREAM_EDGES / t_sum,
                "summary_static_edges_per_s": sum_static,
                "triangle_arm": kern.tuner.best(),
                "summary_arm": eng._tuner.best()})
        launches = dict(kernels.LAUNCHES)
        for name in ("window_counter", "window_summary"):
            require(launches[name] > 0, "autotune: kernel %s was not "
                    "launched" % name)
        # a checkpoint mid-stream carries the tuner; a fresh engine
        # resumes it with the same incumbent
        half = num_w // 2
        eng.reset()
        first = eng.process(src[:half * EB], dst[:half * EB])
        ckpt = eng.state_dict()
        require("autotune" in ckpt, "autotune: no tuner state in the "
                "checkpoint")
        fresh = StreamSummaryEngine(EB, VB)
        fresh.load_state_dict(ckpt)
        require(fresh._tuner is not None
                and fresh._tuner.best() == eng._tuner.best(),
                "autotune: the resumed engine's incumbent differs")
        rest = fresh.process(src[half * EB:], dst[half * EB:])
        require(first + rest == summaries, "autotune: resumed summaries "
                "differ")
        same_carry("autotune resumed", fresh.state_dict()["carry"],
                   state["carry"])
        report = {"passes": passes, "launches": launches,
                  "triangle_tuner": kern.tuner.summary(),
                  "summary_tuner": eng._tuner.summary(),
                  "resumed_incumbent": fresh._tuner.best()}
    report["default"] = default_vs_static(src, dst, counts, summaries,
                                          static_tri, static_eng)
    report["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"autotune": report}))
    last, dflt = passes[-1], report["default"]
    print("phase autotune: ok  triangle %.1f edges/s (static %.1f), summary "
          "%.1f (static %.1f); arms %s, %s; default knobs over %d passes: "
          "triangle %.3fx static, summary %.3fx static"
          % (last["triangle_edges_per_s"], last["triangle_static_edges_per_s"],
             last["summary_edges_per_s"], last["summary_static_edges_per_s"],
             last["triangle_arm"], last["summary_arm"], DEFAULT_PASSES,
             dflt["triangle_ratio"], dflt["summary_ratio"]))
    return report


DEFAULT_PASSES = 6                 # passes of the default configuration


def default_vs_static(src, dst, counts, summaries, static_tri,
                      static_eng) -> dict:
    """The tuner at its default knobs (GS_AUTOTUNE on, GS_AUTOTUNE_ROUND
    and GS_AUTOTUNE_EXPLORE unset) against the static path (GS_AUTOTUNE=0)
    on the 320-window stream: a fresh TriangleWindowKernel and
    StreamSummaryEngine, one untimed pass each (as the static engines
    had: their staging and scratch made), then DEFAULT_PASSES passes
    each, every pass's counts and summaries equal to the static path's,
    timed in turns with the static engines (static, default, default,
    static); the ratio is of the summed walls."""
    from gelly_streaming_tpu_torch import StreamSummaryEngine
    from gelly_streaming_tpu_torch import TriangleWindowKernel

    for k in ("GS_AUTOTUNE_ROUND", "GS_AUTOTUNE_EXPLORE"):
        require(k not in os.environ, "%s is set: not the default" % k)
    with knob_env(GS_AUTOTUNE=1):
        kern = TriangleWindowKernel(EB, VB)
        eng = StreamSummaryEngine(EB, VB)
        eng.warm_fallback()
        require(kern.count_stream(src, dst) == counts
                and eng.process(src, dst) == summaries,
                "autotune default warm pass: results differ")
    walls = {k: [] for k in ("triangle", "triangle_static", "summary",
                             "summary_static")}
    for turn in range(DEFAULT_PASSES // 2):
        for tuned in (False, True, True, False):
            got = []
            with knob_env(GS_AUTOTUNE=int(tuned)):
                k, e = (kern, eng) if tuned else (static_tri, static_eng)
                tag = "" if tuned else "_static"
                walls["triangle" + tag].append(timed(
                    lambda: got.append(k.count_stream(src, dst))))
                e.reset()
                walls["summary" + tag].append(timed(
                    lambda: got.append(e.process(src, dst))))
            require(got[0] == counts and got[1] == summaries,
                    "autotune default turn %d: results differ" % turn)
    out = {"walls_s": walls,
           "triangle_tuner": kern.tuner.summary(),
           "summary_tuner": eng._tuner.summary()}
    for path in ("triangle", "summary"):
        out[path + "_edges_per_s"] = (
            STREAM_EDGES * len(walls[path]) / sum(walls[path]))
        out[path + "_static_edges_per_s"] = (
            STREAM_EDGES * len(walls[path + "_static"])
            / sum(walls[path + "_static"]))
        out[path + "_ratio"] = (out[path + "_edges_per_s"]
                                / out[path + "_static_edges_per_s"])
    return out


class dispatch_events:
    """CUDA events around every dispatch through the staging rings
    `stagers` (ops/staging.ChunkStager) inside the block: a start
    recorded on the compute stream right after a chunk's take() (so its
    wait for the chunk's copy lies before it), an end right after its
    done() (behind the chunk's launches, or its graph's replay). Their
    spans summed are the device time of the dispatches, read without
    torch.profiler, so a replayed graph counts as its eager launches do;
    copies are not in it, and host gaps between the launches of one
    dispatch are."""

    def __init__(self, stagers):
        self.stagers = list(stagers)
        self.spans = []

    def __enter__(self):
        open_ = {}

        def patch(st):
            take, done = st.take, st.done

            def take_(staged):
                out = take(staged)
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                open_[id(staged.slot)] = ev
                return out

            def done_(staged):
                start = open_.pop(id(staged.slot), None)
                if start is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.spans.append((start, end))
                done(staged)

            st.take, st.done = take_, done_

        for st in self.stagers:
            patch(st)
        return self

    def __exit__(self, *exc):
        for st in self.stagers:
            del st.take, st.done        # the class's methods again
        return False

    def busy_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.spans)


def event_busy(run, setup, stagers) -> dict:
    """Wall ms of one run() (after setup(), outside the timing), its
    dispatches' device busy ms from CUDA events (dispatch_events) and
    the device's idle share 1 - busy / wall; graph replays in the run
    beside them. Fails on a run with no dispatch or no busy time."""
    from gelly_streaming_tpu_torch import kernels

    setup()
    before = dict(kernels.REPLAYS)
    with dispatch_events(stagers) as evs:
        wall_ms = 1e3 * timed(run)
    busy = evs.busy_ms()
    require(evs.spans and busy > 0, "no dispatch timed in the run: %d "
            "spans, %.3f ms" % (len(evs.spans), busy))
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / wall_ms, "dispatches": len(evs.spans),
            "replays": {k: kernels.REPLAYS[k] - before[k]
                        for k in kernels.REPLAYS},
            "method": "cuda_events"}


def phase_resident(dev, summaries: list, state: dict) -> dict:
    """ResidentSummaryEngine(32768, 65536) over the 320-window stream
    (GS_AUTOTUNE=0: super-batches of 256 and 64 windows) on the compact
    wire (its default at vb=65536) and the standard wire: every window's
    summaries and the final carry equal to phase summary_stream's, the
    super-batches replayed as CUDA graphs (replays and launches counted),
    a forced_sync run equal, a resume from the state_dict taken at the
    first super-batch's boundary exact, and one pass with the tuner on
    equal; edges/s pipelined and forced_sync, and device busy ms and
    idle share (event_busy), beside StreamSummaryEngine on the same wire
    in turns (scan, resident, resident, scan)."""
    from gelly_streaming_tpu_torch import (StreamSummaryEngine, forced_sync,
                                           kernels)
    from gelly_streaming_tpu_torch.ops.resident_engine import (
        ResidentSummaryEngine)

    src, dst = bench_stream()
    report = {}
    for pin in (None, "standard"):
        with knob_env(GS_AUTOTUNE=0):
            eng = ResidentSummaryEngine(EB, VB, ingress=pin)
            wire = eng.ingress
            require(eng.device.type == "cuda" and eng.MAX_WINDOWS == 256
                    and wire == (pin or "compact"),
                    "resident engine: %s %d %s" % (eng.device,
                                                   eng.MAX_WINDOWS, wire))
            scan = StreamSummaryEngine(EB, VB, ingress=wire)
            for e in (eng, scan):
                e.warm_fallback()
                e.process(src, dst)     # warm-up: graphs captured here
                e.reset()
            captured = eng._graphs.captures
            kernels.reset_launches()
            out = eng.process(src, dst)
            launches = dict(kernels.LAUNCHES)
            replays = kernels.REPLAYS["resident_summary"]
            require(replays == 2 and eng._graphs.captures == captured,
                    "resident %s: %d replays, %d captures in the pass"
                    % (wire, replays, eng._graphs.captures - captured))
            require(out == summaries, "resident %s: summaries differ from "
                    "summary_stream's" % wire)
            same_carry("resident " + wire, eng.state_dict()["carry"],
                       state["carry"])
            walls = {"scan": [], "resident": []}
            for label in ("scan", "resident", "resident", "scan"):
                e = eng if label == "resident" else scan
                e.reset()
                walls[label].append(timed(lambda: e.process(src, dst)))
            eng.reset()
            with forced_sync():
                sync_out = []
                sync_wall = timed(lambda: sync_out.extend(
                    eng.process(src, dst)))
            require(sync_out == summaries, "resident %s: forced_sync "
                    "differs" % wire)
            scan.reset()
            with forced_sync():
                scan_sync = timed(lambda: scan.process(src, dst))
            # a resume from the checkpoint at the first super-batch's end
            cut = RESIDENT_RESUME * EB
            eng.reset()
            head = eng.process(src[:cut], dst[:cut])
            fresh = ResidentSummaryEngine(EB, VB, ingress=pin)
            fresh.load_state_dict(eng.state_dict())
            require(fresh.windows_done == RESIDENT_RESUME,
                    "resident resume at %d" % fresh.windows_done)
            tail = fresh.process(src[cut:], dst[cut:])
            require(head + tail == summaries, "resident %s: resumed "
                    "summaries differ" % wire)
            same_carry("resident %s resumed" % wire,
                       fresh.state_dict()["carry"], state["carry"])
            prof = {label: event_busy(lambda e=e: e.process(src, dst),
                                      e.reset, [e._ring])
                    for label, e in (("scan", scan), ("resident", eng))}
        with knob_env(GS_AUTOTUNE=1):
            eng.reset()
            tuned = eng.process(src, dst)
            require(tuned == summaries, "resident %s: the tuned pass "
                    "differs" % wire)
            tuner = eng._tuner.summary()
        best = {k: STREAM_EDGES / min(v) for k, v in walls.items()}
        report[wire] = {
            "edges_per_s": best["resident"],
            "scan_edges_per_s": best["scan"],
            "walls_s": walls,
            "forced_sync_edges_per_s": STREAM_EDGES / sync_wall,
            "scan_forced_sync_edges_per_s": STREAM_EDGES / scan_sync,
            "replays_a_pass": replays, "graphs_captured": captured,
            "launches": launches, "profile": prof, "tuner": tuner}
        print("phase resident (%s): ok  %.1f edges/s (scan %.1f), "
              "forced_sync %.1f (scan %.1f), %d replays a pass, idle %s "
              "(scan %s)"
              % (wire, best["resident"], best["scan"],
                 STREAM_EDGES / sync_wall, STREAM_EDGES / scan_sync,
                 replays, prof["resident"]["idle_share"],
                 prof["scan"]["idle_share"]))
    report["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"resident": report}))
    return report


def phase_gnn_resident(dev, want: list, want_slab: np.ndarray) -> dict:
    """GnnResidentEngine(32768, 65536, feature_dim=64) over the 320-window
    stream from phase gnn_stream's slab and weights: summaries and final
    slab equal to phase gnn_stream's, the super-batches replayed as CUDA
    graphs; edges/s and the idle share beside GnnSummaryEngine in turns."""
    from gelly_streaming_tpu_torch import (GnnResidentEngine, GnnSummaryEngine,
                                           forced_sync, kernels)
    from gelly_streaming_tpu_torch.ops import gnn_window as gw

    src, dst = bench_stream()
    W, b = gnn_weights(GNN_F, -12, -3)
    slab = gw.default_features(VB, GNN_F, seed=0)
    eng = GnnResidentEngine(EB, VB, feature_dim=GNN_F)   # device=None
    scan = GnnSummaryEngine(EB, VB, feature_dim=GNN_F)
    require(eng.device.type == "cuda" and eng.MAX_WINDOWS == 256,
            "GNN resident engine: %s %d" % (eng.device, eng.MAX_WINDOWS))
    for e in (eng, scan):
        e.set_weights(W / 32, b / 32)

    def start(e):
        e.reset()
        e.load_feature_units(slab)

    for e in (eng, scan):
        start(e)
        e.process(src, dst)           # warm-up: graphs captured here
    start(eng)
    captured = eng._graphs.captures
    kernels.reset_launches()
    out = eng.process(src, dst)
    launches = dict(kernels.LAUNCHES)
    replays = kernels.REPLAYS["gnn_resident"]
    require(replays == 2 and launches["gnn_round"] == 2,
            "gnn resident: %d replays, launches %s" % (replays, launches))
    require(out == want, "gnn resident: summaries differ from gnn_stream's")
    require(np.array_equal(eng.state_dict()["carry"][0], want_slab),
            "gnn resident: final slab differs from gnn_stream's")
    require(eng._graphs.captures == captured, "gnn resident: recaptured")
    walls = {"scan": [], "resident": []}
    for label in ("scan", "resident", "resident", "scan"):
        e = eng if label == "resident" else scan
        start(e)
        walls[label].append(timed(lambda: e.process(src, dst)))
    start(eng)
    with forced_sync():
        sync_out = []
        sync_wall = timed(lambda: sync_out.extend(eng.process(src, dst)))
    require(sync_out == want, "gnn resident: forced_sync differs")
    prof = {label: event_busy(lambda e=e: e.process(src, dst),
                              lambda e=e: start(e), [e._ring])
            for label, e in (("scan", scan), ("resident", eng))}
    best = {k: STREAM_EDGES / min(v) for k, v in walls.items()}
    report = {"edges_per_s": best["resident"],
              "scan_edges_per_s": best["scan"], "walls_s": walls,
              "edge_features_per_s": best["resident"] * GNN_F,
              "forced_sync_edges_per_s": STREAM_EDGES / sync_wall,
              "replays_a_pass": replays, "graphs_captured": captured,
              "launches": launches, "profile": prof,
              "device": torch.cuda.get_device_name(0)}
    print(json.dumps({"gnn_resident": report}))
    print("phase gnn_resident: ok  %.1f edges/s (scan %.1f), %d replays a "
          "pass, idle %s (scan %s)"
          % (best["resident"], best["scan"], replays,
             prof["resident"]["idle_share"], prof["scan"]["idle_share"]))
    return report


def phase_driver_resident(dev, want: list) -> dict:
    """StreamingAnalyticsDriver(window_ms=1, edge_bucket=32768,
    vertex_bucket=65536, snapshot_tier="resident") over the 320-window
    stream in one call (GS_AUTOTUNE=0: super-batches of 256 and 64):
    every WindowResult equal to phase driver's scan tier (`want`), the
    super-batches replayed as CUDA graphs; the delta wire and a pass with
    the tuner on equal too; a resume from the checkpoint at window 256,
    taken inside the call, equal to the uninterrupted run; edges/s,
    replays and the idle share beside the scan tier's one call in turns."""
    import tempfile

    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver, kernels

    src, dst = bench_stream()

    def driver(**kw):
        return StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                        vertex_bucket=VB, **kw)

    with knob_env(GS_AUTOTUNE=0):
        res = driver(snapshot_tier="resident")
        require(res.device.type == "cuda"
                and res.snapshot_tier == "resident", "resident driver")
        scan = driver()
        for d in (res, scan):
            d.run_arrays(src, dst)      # warm-up: graphs captured here
            d.reset()
        kernels.reset_launches()
        got = res.run_arrays(src, dst)
        torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        replays = kernels.REPLAYS["driver_resident"]
        require(replays == 2 and launches["window_snapshot"] == 2,
                "driver resident: %d replays, launches %s"
                % (replays, launches))
        same_results("driver resident", want, got)
        no_demotions("phase driver_resident", res)
        del got
        walls = {"scan": [], "resident": []}
        for label in ("scan", "resident", "resident", "scan"):
            d = res if label == "resident" else scan
            d.reset()
            walls[label].append(timed(lambda: d.run_arrays(src, dst)))
        delta = driver(snapshot_tier="resident", egress="delta")
        same_results("driver resident delta", want, delta.run_arrays(
            src, dst))
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "driver.npz")
            first = driver(snapshot_tier="resident")
            first.enable_auto_checkpoint(path,
                                         every_n_windows=RESIDENT_RESUME)
            first.run_arrays(src, dst)
            second = driver(snapshot_tier="resident")
            require(second.try_resume(path), "no checkpoint to resume")
            done = second.windows_done
            require(done == RESIDENT_RESUME, "driver resident resumed at "
                    "window %d, want %d" % (done, RESIDENT_RESUME))
            rest = second.run_arrays(src[done * EB:], dst[done * EB:])
        same_results("driver resident resumed", want[done:], rest,
                     offset=done)
        prof = {label: event_busy(
                    lambda d=d: d.run_arrays(src, dst), d.reset,
                    [d._res_stager if d is res else d._ring,
                     d._tri_kern()._ring])
                for label, d in (("scan", scan), ("resident", res))}
    with knob_env(GS_AUTOTUNE=1):
        res.reset()
        same_results("driver resident tuned", want, res.run_arrays(src, dst))
        tuner = res._resident_tuner.summary()
    best = {k: STREAM_EDGES / min(v) for k, v in walls.items()}
    report = {"edges_per_s": best["resident"],
              "scan_edges_per_s": best["scan"], "walls_s": walls,
              "replays_a_call": replays, "launches": launches,
              "resumed_at": done, "profile": prof, "tuner": tuner,
              "device": torch.cuda.get_device_name(0)}
    print(json.dumps({"driver_resident": report}))
    print("phase driver_resident: ok  %.1f edges/s (scan %.1f), %d replays "
          "a call, idle %s (scan %s)"
          % (best["resident"], best["scan"], replays,
             prof["resident"]["idle_share"], prof["scan"]["idle_share"]))
    return report


def profile_both(run, setup=lambda: None) -> dict:
    """profile_run of run(), pipelined and under forced_sync, each after
    setup() outside the profiled region."""
    from gelly_streaming_tpu_torch import forced_sync

    def synced():
        with forced_sync():
            run()

    return {"pipelined": profile_run(run, setup=setup),
            "forced_sync": profile_run(synced, setup=setup)}


def tensor_core_ops(lib) -> dict:
    """Counts of tensor-core instructions (HMMA, IMMA, HGMMA, IGMMA) in
    the SASS of a built library, from cuobjdump where the toolkit has
    it: a diagnostic, not a gate."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        return {"cuobjdump": "not found"}
    proc = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120)
    if proc.returncode:
        return {"cuobjdump": "exit %d" % proc.returncode}
    ops = re.findall(r"\b(HMMA|IMMA|HGMMA|IGMMA)\.", proc.stdout)
    return {op: ops.count(op) for op in ("HMMA", "IMMA", "HGMMA", "IGMMA")}


# the summary body's device kernels (csrc/summary_body.cuh), one per tier
SUMMARY_BODY = ("summary_block_kernel", "summary_grid_kernel")
SUMMARY_CALLS = ("window_summary", "window_summary_compact",
                 "cohort_summary")


def profile_run(run, setup=lambda: None, retry: bool = True) -> dict:
    """One run() under torch.profiler: device time by name (the
    device-side rows only, so nothing is counted twice) and launches of
    the eight largest, their sum, and the device's idle share of the
    profiled wall time; the summary body's device rows by name, whose
    launches must match the summary wrappers' calls in the run (one
    launch per chunk or cohort dispatch). The profiler can miss one
    launch of these ctypes-loaded libraries in a profiled run (seen on
    the H100: the first of a run, at times), so one fewer passes, and
    the launches missed are printed; a run with summary calls whose
    profile has no device rows at all fails; before failing, such a
    profile is taken again where its API rows confirm the launches
    (take_profile; setup() before each, `retry` False for a run() that
    cannot repeat)."""
    from gelly_streaming_tpu_torch import kernels

    def summary_rows(by_name, before):
        calls = sum(kernels.LAUNCHES[k] - before[k] for k in SUMMARY_CALLS)
        body = {k: v for k, v in by_name.items()
                if any(b in k for b in SUMMARY_BODY)}
        return calls, body, sum(n for _ms, n in body.values())

    def whole(by_name, before):
        calls, _body, seen = summary_rows(by_name, before)
        return not retry or (
            (by_name or not calls) and calls - 1 <= seen <= calls)

    wall_ms, by_name, before = take_profile(run, whole, setup)
    calls, body, seen = summary_rows(by_name, before)
    require(by_name or not calls,
            "%d summary calls, but the profile has no device rows" % calls)
    require(calls - 1 <= seen <= calls,
            "summary body launches %s, wrapper calls %d" % (body, calls))
    busy = sum(ms for ms, _n in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    out = {"wall_ms": wall_ms,
           "device_busy_ms": busy if busy else "not measured",
           "idle_share": 1 - busy / wall_ms if busy else "not measured",
           "device_ms_by_name": {k: ms for k, (ms, _n) in top},
           "launches_by_name": {k: n for k, (_ms, n) in top},
           "summary_calls": calls,
           "summary_body_missed": calls - seen,
           "summary_body": {k: {"ms": ms, "launches": n}
                            for k, (ms, n) in body.items()}}
    return out


# ----------------------------------------------------------------------
# the host hooks (utils/telemetry, metrics, latency, provenance,
# sanitize, wal, costmodel): armed against disarmed, recovery, faults
# ----------------------------------------------------------------------
HOOKS = ("telemetry", "metrics", "latency", "provenance", "sanitize",
         "wal", "costmodel")
STREAM_HOOKS = ("telemetry", "metrics", "costmodel")  # count_stream's
HOOK_TIMEOUT_S = 0.5               # the stage deadline of the fault drill
HOOK_HANG_S = 1.5                  # its hung h2d


class SyncCount:
    """Counts the host's waits on the card while active, on every
    thread: torch.cuda.synchronize, Event.synchronize, Stream.synchronize
    and .cpu(), .item(), .tolist() of a CUDA tensor."""

    def __enter__(self):
        self.calls = []
        self._saved = []

        def wrap(owner, name, cuda_only=False):
            real = getattr(owner, name)

            def counted(*a, **k):
                if not cuda_only or a[0].is_cuda:
                    self.calls.append(name)
                return real(*a, **k)

            setattr(owner, name, counted)
            self._saved.append((owner, name, real))

        wrap(torch.cuda, "synchronize")
        wrap(torch.cuda.Event, "synchronize")
        wrap(torch.cuda.Stream, "synchronize")
        for name in ("cpu", "item", "tolist"):
            wrap(torch.Tensor, name, cuda_only=True)
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            setattr(owner, name, real)
        return False

    @property
    def n(self) -> int:
        return len(self.calls)


def reset_hooks() -> None:
    from gelly_streaming_tpu_torch.utils import (costmodel, latency,
                                                 metrics, provenance,
                                                 sanitize, telemetry)

    for m in (telemetry, metrics, latency, provenance, sanitize,
              costmodel):
        m.reset()


def hook_knobs(hooks, tmp: str) -> dict:
    """The GS_* knobs that arm `hooks` (the journal is armed by
    enable_wal), every other hook knob off."""
    env = {"GS_TELEMETRY": 0, "GS_METRICS": 0, "GS_LATENCY": 0,
           "GS_PROVENANCE": 0, "GS_SANITIZE": "off", "GS_COSTMODEL": 0,
           "GS_AUTOTUNE": 0}
    dirs = {"telemetry": ("GS_TRACE_DIR", "trace"),
            "provenance": ("GS_PROVENANCE_DIR", "prov"),
            "sanitize": ("GS_DLQ_DIR", "dlq")}
    for h in hooks:
        if h in ("telemetry", "metrics", "latency", "provenance",
                 "costmodel"):
            env["GS_" + h.upper()] = 1
        if h == "sanitize":
            env["GS_SANITIZE"] = "on"
        if h in dirs:
            env[dirs[h][0]] = os.path.join(tmp, dirs[h][1])
    return env


def dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path)) if os.path.isdir(path) else 0


def hook_engines(dev) -> dict:
    """name -> (engine, its journal-armed twin or None, run(engine) ->
    (results, carry as host arrays)): the slice's engines over the
    bench stream, each warmed (kernels built, rings filled, the
    resident graphs captured)."""
    from gelly_streaming_tpu_torch import (GnnSummaryEngine,
                                           StreamSummaryEngine,
                                           TriangleWindowKernel)
    from gelly_streaming_tpu_torch.ops import gnn_window as gw
    from gelly_streaming_tpu_torch.ops.resident_engine import (
        ResidentSummaryEngine)

    src, dst = bench_stream()
    W, b = gnn_weights(GNN_F, -12, -3)
    slab = gw.default_features(VB, GNN_F, seed=0)

    def tri_run(k):
        return k.count_stream(src, dst), ()

    def eng_run(e):
        e.reset()
        if isinstance(e, GnnSummaryEngine):
            e.load_feature_units(slab)
        out = e.process(src, dst)
        return out, tuple(np.asarray(c) for c in e.state_dict()["carry"])

    def gnn():
        e = GnnSummaryEngine(EB, VB, feature_dim=GNN_F)
        e.set_weights(W / 32, b / 32)
        return e

    made = {
        "count_stream": (TriangleWindowKernel(EB, VB), None, tri_run),
        "count_stream_compact": (TriangleWindowKernel(EB, VB,
                                                      ingress="compact"),
                                 None, tri_run),
        "summary": (StreamSummaryEngine(EB, VB),
                    StreamSummaryEngine(EB, VB), eng_run),
        "summary_compact": (StreamSummaryEngine(EB, VB, ingress="compact"),
                            StreamSummaryEngine(EB, VB, ingress="compact"),
                            eng_run),
        "gnn": (gnn(), gnn(), eng_run),
        "resident": (ResidentSummaryEngine(EB, VB),
                     ResidentSummaryEngine(EB, VB), eng_run)}
    with knob_env(**hook_knobs((), "")):
        for eng, twin, run in made.values():
            for e in (eng, twin):
                if e is not None:
                    require(e.device.type == "cuda", "engine not on card")
                    run(e)
    torch.cuda.synchronize()
    return made


def hooks_pass(eng, twin, run, hooks, tmp: str) -> dict:
    """One pass with `hooks` armed (the journal on the twin, into a
    fresh directory): results, carry, launches, host syncs, wall."""
    from gelly_streaming_tpu_torch import kernels

    reset_hooks()
    with knob_env(**hook_knobs(hooks, tmp)):
        e = eng
        if "wal" in hooks:
            e = twin
            wal_dir = os.path.join(tmp, "wal%d" % len(os.listdir(tmp)))
            require(e.enable_wal(wal_dir), "enable_wal refused")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with SyncCount() as syncs:
            out, carry = run(e)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res = {"out": out, "carry": carry, "wall": wall,
               "launches": dict(kernels.LAUNCHES), "syncs": syncs.n}
        if "wal" in hooks:
            e._wal.close()
            res["journal_bytes"] = dir_bytes(wal_dir)
        if "metrics" in hooks:
            from gelly_streaming_tpu_torch.utils import metrics

            h = metrics.histogram("gs_wal_fsync_seconds")
            res["fsync_s"] = None if h is None else h["sum"]
            res["fsyncs"] = None if h is None else h["count"]
    return res


def phase_hooks_engine(dev, counts, summaries, state, gnn_out) -> dict:
    """The host hooks on the slice's engines over the bench stream:
    count_stream and the summary engine on both wires, the GNN engine at
    F=64 and the resident summary engine, each disarmed, with each hook
    armed alone, and with every hook armed, each configuration twice in
    mirrored turns: every window's results and the final carry bit-equal
    to the disarmed pass (and to phases stream, summary_stream,
    gnn_stream), the same kernel launches and the same host syncs;
    edges/s of the better pass of each, the journal's bytes and its
    fsync seconds. Then the drills on the summary engine (and the
    resident engine): a kill by a fatal fault inside a call, recovered
    from checkpoint + journal bit-exactly; retried prep and h2d faults
    (a hung h2d retried on another thread into its staging slot) with
    equal results; a fatal fault passed through; and an error raised
    by the launch wrapper before any launch, passed through unretried
    with no StageFailed and no plain fallback."""
    import tempfile

    from gelly_streaming_tpu_torch import forced_sync, kernels
    from gelly_streaming_tpu_torch.ops import window_summary as ws
    from gelly_streaming_tpu_torch.utils import faults, resilience

    t_phase = time.perf_counter()
    made = hook_engines(dev)
    want = {"count_stream": counts, "count_stream_compact": counts,
            "summary": summaries,
            "summary_compact": summaries, "gnn": gnn_out,
            "resident": summaries}
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (eng, twin, run) in made.items():
            hooks = STREAM_HOOKS if name.startswith("count_stream") \
                else HOOKS
            # every configuration twice, in mirrored turns (disarmed,
            # each hook, all, all, ..., disarmed): the best wall of two
            passes = [("disarmed", ())] + [(h, (h,)) for h in hooks] \
                + [("all", hooks)]
            runs = {}
            for i, (label, armed) in enumerate(passes + passes[::-1]):
                sub = os.path.join(tmp, "%s_%s_%d" % (name, label, i))
                os.makedirs(sub)
                runs.setdefault(label, []).append(
                    hooks_pass(eng, twin, run, armed, sub))
            rows = {label: min(rs, key=lambda r: r["wall"])
                    for label, rs in runs.items()}
            base = rows["disarmed"]
            require(base["out"] == want[name], "hooks %s: the disarmed "
                    "pass differs from the main path's" % name)
            if name in ("summary", "summary_compact", "resident"):
                same_carry("hooks " + name, base["carry"], state["carry"])
            for label, r in ((lab, r) for lab, rs in runs.items()
                             for r in rs):
                require(r["out"] == base["out"], "hooks %s %s: results "
                        "differ from the disarmed pass" % (name, label))
                require(all(np.array_equal(a, b) for a, b in
                            zip(r["carry"], base["carry"])),
                        "hooks %s %s: carry differs" % (name, label))
                require(r["launches"] == base["launches"],
                        "hooks %s %s: launches %s, disarmed %s"
                        % (name, label, r["launches"], base["launches"]))
                require(r["syncs"] == base["syncs"], "hooks %s %s: %d host "
                        "syncs, disarmed %d" % (name, label, r["syncs"],
                                                base["syncs"]))
            report[name] = {
                label: {"edges_per_s": STREAM_EDGES / r["wall"],
                        "walls_s": [x["wall"] for x in runs[label]],
                        "launches": sum(r["launches"].values()),
                        "syncs": r["syncs"],
                        **{k: r[k] for k in ("journal_bytes", "fsync_s",
                                             "fsyncs") if k in r}}
                for label, r in rows.items()}
            print("phase hooks_engine %s: ok  armed == disarmed on %d "
                  "windows, launches %d, host syncs %d in every pass; "
                  "edges/s %s"
                  % (name, len(base["out"]), sum(base["launches"].values()),
                     base["syncs"], ", ".join(
                         "%s %.0f" % (k, v["edges_per_s"])
                         for k, v in report[name].items())))
        print(json.dumps({"hooks_engine": report,
                          "device": torch.cuda.get_device_name(0)}))

        # a kill inside a call, recovered from checkpoint + journal
        from gelly_streaming_tpu_torch import StreamSummaryEngine
        from gelly_streaming_tpu_torch.ops.resident_engine import (
            ResidentSummaryEngine)

        src, dst = bench_stream()
        cut = 128 * EB
        recovery = {}
        for name, make in (
                ("summary", lambda: StreamSummaryEngine(EB, VB)),
                ("resident", lambda: ResidentSummaryEngine(
                    EB, VB, superbatch=CHUNK))):
            sub = os.path.join(tmp, "kill_" + name)
            ckpt = os.path.join(sub, "ckpt")
            with knob_env(**hook_knobs((), "")):
                eng = make()
                require(eng.enable_wal(os.path.join(sub, "wal")), "wal")
                eng.enable_auto_checkpoint(ckpt, every_n_windows=CHUNK)
                require(eng.process(src[:cut], dst[:cut])
                        == summaries[:128], "kill %s: head" % name)
                with faults.inject(faults.FaultSpec(
                        site="prep", on_call=3, fatal=True)) as plan:
                    try:
                        eng.process(src[cut:], dst[cut:])
                        raise SmokeFailure("kill %s: no kill" % name)
                    except faults.InjectedFault as e:
                        require(e.fatal, "kill %s: not the fatal fault"
                                % name)
                eng._wal.close()
                t0 = time.perf_counter()
                rec = make()
                rec.enable_wal(os.path.join(sub, "wal"))
                got = rec.resume_and_replay(ckpt)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
            require(got == summaries[128:], "kill %s: recovered windows "
                    "differ" % name)
            same_carry("kill " + name, rec.state_dict()["carry"],
                       state["carry"])
            recovery[name] = {"seconds": secs, "replayed_windows": len(got),
                              "fired": plan.fired,
                              "journal_bytes": dir_bytes(
                                  os.path.join(sub, "wal"))}
            print("phase hooks_engine recovery %s: ok  killed inside the "
                  "second call (%s), %d windows recovered from checkpoint "
                  "+ journal in %.3f s, bit-equal"
                  % (name, plan.fired, len(got), secs))

        # retried host faults: prep raises, h2d raises, h2d hangs past the
        # deadline (its retry stages the chunk from another thread)
        eng, _twin, run = made["summary"]
        res_eng, _rt, _r = made["resident"]
        drills = {}
        with knob_env(**hook_knobs((), ""), GS_STAGE_RETRIES=3,
                      GS_STAGE_TIMEOUT_S=HOOK_TIMEOUT_S,
                      GS_STAGE_BACKOFF_S=0.01):
            # pooled on the summary engine's 5 chunks; in order
            # (forced_sync, the retries still on threads of their own)
            # on the resident engine's 2 super-batches, so each fault
            # meets a call
            for name, e, sync, calls in (
                    ("summary", eng, False, (2, 3, 5)),
                    ("resident", res_eng, True, (2, 2, 3))):
                with (forced_sync() if sync else knob_env()), \
                        faults.inject(
                            faults.FaultSpec(site="prep", on_call=calls[0]),
                            faults.FaultSpec(site="h2d", on_call=calls[1]),
                            faults.FaultSpec(site="h2d", on_call=calls[2],
                                             action="hang",
                                             seconds=HOOK_HANG_S)) as plan:
                    out, carry = run(e)
                require(out == summaries, "retried faults %s: results "
                        "differ" % name)
                same_carry("retried faults " + name, carry, state["carry"])
                require(len(plan.fired) == 3, "retried faults %s: fired %s"
                        % (name, plan.fired))
                drills[name] = plan.fired
            # a fatal fault passes through unretried; the engine goes on
            with faults.inject(faults.FaultSpec(site="h2d", on_call=2,
                                                fatal=True)) as plan:
                try:
                    run(eng)
                    raise SmokeFailure("fatal fault: nothing raised")
                except faults.InjectedFault as e:
                    require(type(e) is faults.InjectedFault and e.fatal,
                            "fatal fault: %r" % e)
            require([f for f in plan.fired if f[0] == "h2d"]
                    == [("h2d", 2, "raise")], "fatal fault retried: %s"
                    % plan.fired)
            require(run(eng)[0] == summaries, "after the fatal fault")
            # an error of the launch wrapper, before any launch
            real_library, real_plain = kernels.library, \
                ws.summarize_windows_plain
            calls = {"library": 0, "plain": 0}

            def broken(name):
                if name == "window_summary":
                    calls["library"] += 1
                    raise kernels.KernelError(
                        "injected: the window_summary wrapper failed "
                        "before its launch")
                return real_library(name)

            def plain(*a, **k):
                calls["plain"] += 1
                return real_plain(*a, **k)

            kernels.library, ws.summarize_windows_plain = broken, plain
            kernels.reset_launches()
            try:
                run(eng)
                raise SmokeFailure("launch error: nothing raised")
            except kernels.KernelError as e:
                require(not isinstance(e, resilience.StageError)
                        and e.__cause__ is None,
                        "launch error wrapped: %r" % e)
            finally:
                kernels.library, ws.summarize_windows_plain = \
                    real_library, real_plain
            require(calls == {"library": 1, "plain": 0}
                    and kernels.LAUNCHES["window_summary"] == 0,
                    "launch error: %s, launches %s" % (calls,
                                                       kernels.LAUNCHES))
            require(run(eng)[0] == summaries, "after the launch error")
    print("phase hooks_engine drills: ok  retried faults %s bit-equal; a "
          "fatal h2d fault passed through unretried; a launch-wrapper "
          "error raised once, unwrapped, no plain fallback, no launch; "
          "%.1f s" % (drills, time.perf_counter() - t_phase))
    return {"passes": report, "recovery": recovery, "drills": drills,
            "engines": made}


def phase_costmodel_health(dev, made: dict, bounds: dict) -> dict:
    """The cost observatory and /healthz over the slice's engines: with
    GS_COSTMODEL and GS_METRICS armed and the health server on an
    ephemeral local port, each engine of phase hooks_engine makes one
    pass over the bench stream while a thread reads /healthz; then one
    cost-model row per kernel on the path (and per resident replay),
    whose bound must equal the kernels line's bound at the same shape
    (`bounds`, PERF.md §6's column)."""
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.utils import costmodel

    reset_hooks()
    with knob_env(**hook_knobs(("costmodel", "metrics"), "")):
        seen, final, total = poll_healthz(lambda: sum(
            len(run(eng)[0]) for eng, _twin, run in made.values()))
        rows = costmodel.report()
    mid = [s for s in seen if 0 < s[2] < total]
    require(mid and all(c == 200 and st == "ok" for c, st, _w in seen),
            "healthz: %d reads, %d mid-stream, %s" % (len(seen), len(mid),
                                                      seen[-3:]))
    require(final["windows_finalized"] == total, "healthz: %d windows, "
            "want %d" % (final["windows_finalized"], total))
    picked = {}
    for r in rows:
        full = ("[%d," % CHUNK) in r["sig"] or r["program"] in \
            kernels.GRAPH_FAMILIES
        if full and r["dispatches"]:
            picked.setdefault(r["program"], r)
    for prog, want in bounds.items():
        r = picked.get(prog)
        require(r is not None, "costmodel: no row of %s (%s)"
                % (prog, sorted(picked)))
        require(r["card"] == costmodel.H100 and abs(
            r["bound_ms"] - want["bound_ms"]) <= 1e-12 * want["bound_ms"]
            and r["bound_by"] == want["bound_by"],
            "costmodel %s: bound %s %s, kernels line %s %s"
            % (prog, r["bound_ms"], r["bound_by"], want["bound_ms"],
               want["bound_by"]))
    out = []
    for prog, r in sorted(picked.items()):
        out.append({k: r.get(k) for k in (
            "program", "sig", "dispatches", "measured_mean_s",
            "bytes_accessed", "flops", "kind", "bound_ms", "bound_by",
            "roofline_frac", "card")})
        print("costmodel %s %s: %d launches, mean %.4f ms, bound %.4f ms "
              "(%s), bound/mean %.4f"
              % (prog, r["sig"], r["dispatches"],
                 1e3 * r["measured_mean_s"], r["bound_ms"], r["bound_by"],
                 r["roofline_frac"]))
    print(json.dumps({"costmodel_health": {
        "rows": out, "healthz_reads": len(seen), "healthz_mid_stream":
        len(mid), "windows": total,
        "device": torch.cuda.get_device_name(0)}}))
    print("phase costmodel_health: ok  %d rows, bounds equal to the "
          "kernels line's for %s; /healthz read %d times (%d mid-stream), "
          "all ok" % (len(out), sorted(bounds), len(seen), len(mid)))
    return {"rows": out}


# ----------------------------------------------------------------------
# the driver's hooks, its demotion ladder and tracing
# ----------------------------------------------------------------------
DRIVER_HOOKS = ("telemetry", "metrics", "latency", "costmodel",
                "provenance", "wal", "sanitize", "tracing")
# hooks_driver's passes run twice on the scan tier: those whose share
# of the disarmed rate stands out of the hosts' noise
MIRRORED = ("disarmed", "all", "wal", "provenance", "sanitize")
DEMOTE_EDGES = 2_097_152            # phase demotion's prefix: 64 windows
DRIVER_KILL = 64                    # the kill drill's checkpoint window
DRIVER_KILL_CALL = 100              # and its first call, killed inside


def no_demotions(label: str, *drivers) -> None:
    """(b): a main path demotes nothing, in the drivers' logs or the
    process's."""
    from gelly_streaming_tpu_torch.utils import resilience

    logs = [d.demotion_log() for d in drivers]
    require(not any(logs) and not resilience.demotion_events(),
            "%s demoted: %s %s" % (label, logs,
                                   resilience.demotion_events()))


def poll_healthz(run) -> tuple:
    """Serve /healthz on an ephemeral local port while run() streams,
    reading it from a thread: (reads as (code, status, windows), the
    final body, run()'s value)."""
    import threading
    import urllib.error
    import urllib.request

    from gelly_streaming_tpu_torch.utils import healthz

    seen = []
    stop = threading.Event()
    srv = healthz.start(port=0)
    url = "http://127.0.0.1:%d/healthz" % srv.port

    def poll():
        while not stop.is_set():
            try:
                with urllib.request.urlopen(url, timeout=5) as r:
                    code, body = r.status, json.loads(r.read())
            except urllib.error.HTTPError as e:   # 503: degraded
                code, body = e.code, json.loads(e.read())
            seen.append((code, body["status"], body["windows_finalized"]))
            stop.wait(0.005)

    poller = threading.Thread(target=poll, daemon=True)
    poller.start()
    try:
        value = run()
    finally:
        stop.set()
        poller.join()
        final = json.loads(urllib.request.urlopen(url).read())
        healthz.stop()
    return seen, final, value


def driver_hooks_pass(make, feed, hooks, tmp: str, want: list) -> dict:
    """One driver pass with `hooks` armed (the journal by enable_wal,
    tracing by the constructor): every window equal to `want`; the
    launches, host syncs and wall; the journal's bytes and the cost
    observatory's rows where armed."""
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.utils import costmodel, metrics

    reset_hooks()
    with knob_env(**hook_knobs(hooks, tmp)):
        drv = make(tracing="tracing" in hooks)
        if "wal" in hooks:
            wal_dir = os.path.join(tmp, "wal")
            require(drv.enable_wal(wal_dir), "enable_wal refused")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with SyncCount() as syncs:
            out = feed(drv)
        torch.cuda.synchronize()
        res = {"wall": time.perf_counter() - t0,
               "launches": dict(kernels.LAUNCHES), "syncs": syncs.n}
        same_results("hooks_driver %s" % (hooks,), want, out)
        if "latency" in hooks:
            require(all(r.latency is not None for r in out),
                    "hooks_driver: a window without its latency record")
        del out
        no_demotions("hooks_driver %s" % (hooks,), drv)
        if "tracing" in hooks:
            res["steps"] = {r["op"]: r["calls"] for r in drv.trace_report()}
        if "wal" in hooks:
            drv._wal.close()
            res["journal_bytes"] = dir_bytes(wal_dir)
        if "metrics" in hooks:
            h = metrics.histogram("gs_wal_fsync_seconds")
            res["fsync_s"] = None if h is None else h["sum"]
        if "costmodel" in hooks:
            res["cost_rows"] = costmodel.report()
    return res


def phase_hooks_driver(dev, want: list, snapshot: dict) -> dict:
    """The host hooks on the driver's main path: the scan tier fed as in
    phase driver (DRIVER_FEED calls, the vertex bucket growing from 4096
    to 65536), then the resident tier in one call, each disarmed, with
    each hook alone (DRIVER_HOOKS) and with all; on the scan tier the
    passes in MIRRORED run again in a mirrored turn. Every window of
    every pass equal to phase driver's (`want`), the same launches and
    host syncs as the disarmed pass, no demotion; edges/s of the better
    pass (the one pass where a hook ran once). Then a kill inside a
    call (a checkpoint at window 64, a fatal `finalize` fault in the
    call's second chunk) recovered by resume_and_replay bit-exactly; the
    cost observatory's row S beside the kernels line's bound
    (`snapshot`); /healthz read while the driver streams."""
    import tempfile

    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
    from gelly_streaming_tpu_torch.utils import faults
    from gelly_streaming_tpu_torch.utils.tracing import StepTimer

    t_phase = time.perf_counter()
    src, dst = bench_stream()

    def scan_feed(drv):
        got, at = [], 0
        for n in DRIVER_FEED:
            got += drv.run_arrays(src[at * EB:(at + n) * EB],
                                  dst[at * EB:(at + n) * EB])
            at += n
        return got

    # the resident tier keeps one driver (its CUDA graphs captured once),
    # reset and its timer set a pass; the scan tier's vertex bucket
    # grows from a fresh driver's each pass
    res_drv = StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                       vertex_bucket=VB,
                                       snapshot_tier="resident")

    def resident(tracing=False):
        res_drv.reset()
        res_drv.timer = StepTimer() if tracing else None
        res_drv._wal = res_drv._wal_dir = None
        return res_drv

    tiers = {
        "scan": (lambda tracing=False: StreamingAnalyticsDriver(
            window_ms=1, edge_bucket=EB, tracing=tracing), scan_feed, True),
        "resident": (resident, lambda drv: drv.run_arrays(src, dst),
                     False)}
    passes = [("disarmed", ())] + [(h, (h,)) for h in DRIVER_HOOKS] \
        + [("all", DRIVER_HOOKS)]
    mirror = [p for p in passes[::-1] if p[0] in MIRRORED]
    report, rows_s = {}, []
    with tempfile.TemporaryDirectory() as tmp, \
            knob_env(**hook_knobs((), "")):
        res_drv.run_arrays(src, dst)      # its graphs captured here
        for tier, (make, feed, mirrored) in tiers.items():
            runs = {}
            for i, (label, hooks) in enumerate(
                    passes + mirror if mirrored else passes):
                sub = os.path.join(tmp, "%s_%s_%d" % (tier, label, i))
                os.makedirs(sub)
                r = driver_hooks_pass(make, feed, hooks, sub, want)
                rows_s += [c for c in r.pop("cost_rows", ())
                           if c["program"] == "window_snapshot"
                           and "[%d,%d]" % (CHUNK, EB) in c["sig"]
                           and str(VB + 1) in c["sig"]]
                runs.setdefault(label, []).append(r)
            base = runs["disarmed"][0]
            for label, rs in runs.items():
                for r in rs:
                    require(r["launches"] == base["launches"],
                            "hooks_driver %s %s: launches %s, disarmed %s"
                            % (tier, label, r["launches"],
                               base["launches"]))
                    require(r["syncs"] == base["syncs"], "hooks_driver %s "
                            "%s: %d host syncs, disarmed %d"
                            % (tier, label, r["syncs"], base["syncs"]))
            for name in ("window_snapshot", "window_counter"):
                require(base["launches"][name] > 0, "hooks_driver %s: no "
                        "%s launch" % (tier, name))
            best = {label: min(rs, key=lambda r: r["wall"])
                    for label, rs in runs.items()}
            base_wall = best["disarmed"]["wall"]
            report[tier] = {
                label: {"edges_per_s": STREAM_EDGES / r["wall"],
                        "share": base_wall / r["wall"],
                        "walls_s": [x["wall"] for x in runs[label]],
                        **{k: r[k] for k in ("journal_bytes", "fsync_s",
                                             "steps") if k in r}}
                for label, r in best.items()}
            print("phase hooks_driver %s: ok  armed == disarmed on %d "
                  "windows, launches %s, host syncs %d in every pass; M "
                  "edges/s %s" % (tier, len(want), {
                      k: v for k, v in base["launches"].items() if v},
                      base["syncs"], ", ".join(
                          "%s %.2f" % (k, v["edges_per_s"] / 1e6)
                          for k, v in report[tier].items())))

        # a kill inside a call, recovered from checkpoint + journal
        sub = os.path.join(tmp, "kill")
        ckpt, wal_dir = os.path.join(sub, "ckpt"), os.path.join(sub, "wal")
        make = tiers["scan"][0]
        cut = DRIVER_KILL_CALL * EB
        drv = make()
        require(drv.enable_wal(wal_dir), "kill: enable_wal")
        drv.enable_auto_checkpoint(ckpt, every_n_windows=DRIVER_KILL)
        with faults.inject(faults.FaultSpec(site="finalize", on_call=2,
                                            fatal=True)) as plan:
            try:
                drv.run_arrays(src[:cut], dst[:cut])
                raise SmokeFailure("kill: no kill")
            except faults.InjectedFault as e:
                require(e.fatal, "kill: not the fatal fault")
        drv._wal.close()
        journal = dir_bytes(wal_dir)
        t0 = time.perf_counter()
        rec = make()
        rec.enable_wal(wal_dir)
        lost = rec.resume_and_replay(ckpt)
        torch.cuda.synchronize()
        recovery_s = time.perf_counter() - t0
        same_results("kill: recovered", want[DRIVER_KILL:DRIVER_KILL_CALL],
                     lost, offset=DRIVER_KILL)
        rest = rec.run_arrays(src[cut:], dst[cut:])
        same_results("kill: the rest", want[DRIVER_KILL_CALL:], rest,
                     offset=DRIVER_KILL_CALL)
        no_demotions("kill", drv, rec)
        del lost, rest
        kill = {"fired": plan.fired, "recovered_windows":
                DRIVER_KILL_CALL - DRIVER_KILL, "recovery_s": recovery_s,
                "journal_mb_per_m_edges": journal / (cut / 1e6) / 1e6}
        print("phase hooks_driver kill: ok  killed at %s, windows %d-%d "
              "recovered from checkpoint + journal in %.3f s, the rest "
              "equal; journal %.2f MB a million edges, its fsyncs %s s a "
              "pass (all armed: scan, resident)"
              % (plan.fired, DRIVER_KILL, DRIVER_KILL_CALL - 1, recovery_s,
                 kill["journal_mb_per_m_edges"],
                 [report[t]["all"]["fsync_s"] for t in tiers]))

        # /healthz while the driver streams (metrics armed)
        reset_hooks()
        with knob_env(**hook_knobs(("metrics",), "")):
            seen, final, got = poll_healthz(lambda: scan_feed(make()))
        mid = [s for s in seen if 0 < s[2] < len(want)]
        require(mid and all(c == 200 and st == "ok" for c, st, _w in seen),
                "hooks_driver healthz: %d reads, %d mid-stream, %s"
                % (len(seen), len(mid), seen[-3:]))
        require(final["windows_finalized"] == len(want),
                "hooks_driver healthz: %d windows"
                % final["windows_finalized"])
        del got
    require(rows_s, "hooks_driver: no cost row of the snapshot kernel")
    for r in rows_s:
        require(abs(r["bound_ms"] - snapshot["bound_ms"])
                <= 1e-12 * snapshot["bound_ms"]
                and r["bound_by"] == snapshot["bound_by"],
                "costmodel window_snapshot: bound %s %s, kernels line %s %s"
                % (r["bound_ms"], r["bound_by"], snapshot["bound_ms"],
                   snapshot["bound_by"]))
    row_s = {"sig": rows_s[0]["sig"], "bound_ms": rows_s[0]["bound_ms"],
             "bound_by": rows_s[0]["bound_by"],
             "mean_ms": [1e3 * r["measured_mean_s"] for r in rows_s],
             "launches": [r["dispatches"] for r in rows_s]}
    out = {"passes": report, "kill": kill, "row_s": row_s,
           "healthz_reads": len(seen), "healthz_mid_stream": len(mid),
           "device": torch.cuda.get_device_name(0)}
    print(json.dumps({"hooks_driver": out}))
    print("phase hooks_driver: ok  costmodel window_snapshot %s: bound "
          "%.4f ms (%s) equal to the kernels line's, mean %s ms a call; "
          "/healthz read %d times (%d mid-stream), all ok; %.1f s"
          % (row_s["sig"], row_s["bound_ms"], row_s["bound_by"],
             ["%.4f" % m for m in row_s["mean_ms"]], len(seen), len(mid),
             time.perf_counter() - t_phase))
    return out


def phase_demotion(dev, want: list) -> dict:
    """The demotion ladder on the card, over the first DEMOTE_EDGES edges
    of the north-star stream (64 windows; `want`, phase driver's): it
    never leaves the card. A host fault at `dispatch` demotes a resident
    driver to scan, bit-equal, triangles included; persistent ones on a
    scan driver raise StageFailed with nothing demoted; a failed h2d copy
    raises with nothing demoted; a driver pinned to native walks to host,
    bit-equal; GS_TIER_RETRY_WINDOWS=4 re-promotes to resident at the
    next call; a transient prep fault is retried with no demotion; a
    resident call whose prep fails demotes to scan; a kernels.KernelError
    of the snapshot wrapper's library raises unwrapped with nothing
    demoted, on the scan and the resident tier; GS_TIER_DEMOTE=0 raises
    StageFailed."""
    from gelly_streaming_tpu_torch import (StreamingAnalyticsDriver,
                                           forced_sync, kernels)
    from gelly_streaming_tpu_torch.utils import faults, resilience

    t_phase = time.perf_counter()
    src, dst = bench_stream()
    src, dst = src[:DEMOTE_EDGES], dst[:DEMOTE_EDGES]
    want = want[:DEMOTE_EDGES // EB]

    def driver(**kw):
        return StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                        vertex_bucket=VB, **kw)

    def walk(drv):
        return [(e["from"], e["to"]) for e in drv.demotion_log()]

    def raises(label, drv, stage, specs):
        """drv's call under `specs` raises StageFailed of `stage`, with
        nothing demoted and no window finalized."""
        resilience.reset_demotions()
        with faults.inject(*specs):
            try:
                drv.run_arrays(src, dst)
                raise SmokeFailure("demotion %s: no StageFailed" % label)
            except resilience.StageFailed as e:
                require(e.stage == stage, "demotion %s: StageFailed of %s"
                        % (label, e.stage))
        no_demotions("demotion " + label, drv)
        require(drv.windows_done == 0, "demotion %s: the cursor moved"
                % label)

    cases = {}
    with knob_env(GS_AUTOTUNE=0, GS_STAGE_BACKOFF_S=0.01):
        for tier, to in (("resident", "scan"), ("native", "host")):
            resilience.reset_demotions()
            drv = driver(snapshot_tier=tier)
            with faults.inject(faults.FaultSpec(site="dispatch",
                                                on_call=1)) as plan:
                t0 = time.perf_counter()
                same_results("demotion %s" % tier, want,
                             drv.run_arrays(src, dst))
                cases[tier] = {"seconds": time.perf_counter() - t0,
                               "walk": walk(drv), "fired": plan.fired}
            require(walk(drv) == [(tier, to)]
                    and len(resilience.demotion_events()) == 1,
                    "demotion %s: %s" % (tier, walk(drv)))

        raises("scan", driver(), "dispatch", [faults.FaultSpec(
            site="dispatch", on_call=1, times=2)])
        cases["scan"] = "StageFailed, nothing demoted"
        with knob_env(GS_STAGE_RETRIES=1):
            raises("h2d", driver(snapshot_tier="resident"), "h2d",
                   [faults.FaultSpec(site="h2d", on_call=1, times=2)])
        cases["h2d"] = "StageFailed, nothing demoted"
        resilience.reset_demotions()

        with knob_env(GS_TIER_RETRY_WINDOWS=4):
            drv = driver(snapshot_tier="resident")
            with faults.inject(faults.FaultSpec(site="dispatch",
                                                on_call=1)):
                got = drv.run_arrays(src[:32 * EB], dst[:32 * EB])
            got += drv.run_arrays(src[32 * EB:], dst[32 * EB:])
            same_results("demotion probation", want, got)
            require(walk(drv) == [("resident", "scan"),
                                  ("scan", "resident")]
                    and drv._demoted_tier is None,
                    "demotion probation: %s" % walk(drv))
            cases["probation"] = walk(drv)

        with knob_env(GS_STAGE_RETRIES=1):
            def counted(tier, specs):
                d = driver(snapshot_tier=tier)
                with forced_sync(), faults.inject(*specs) as p:
                    out = d.run_arrays(src, dst)
                return d, p, out

            for tier, times, want_walk in (("scan", 1, []),
                                           ("resident", 2,
                                            [("resident", "scan")])):
                _d, clean, _o = counted(tier, [])
                last = clean.calls["prep"] - 1   # the snapshot's last prep
                d, p, out = counted(tier, [faults.FaultSpec(
                    site="prep", on_call=last, times=times)])
                same_results("demotion prep %s" % tier, want, out)
                require(walk(d) == want_walk, "demotion prep %s: %s"
                        % (tier, walk(d)))
                cases["prep_" + tier] = {"walk": walk(d),
                                         "fired": p.fired}

        real = kernels.library
        for tier in ("scan", "resident"):
            calls = []

            def broken(name):
                if name == "window_snapshot":
                    calls.append(name)
                    raise kernels.KernelError(
                        "injected: the window_snapshot library failed")
                return real(name)

            resilience.reset_demotions()
            drv = driver(snapshot_tier=tier)
            kernels.library = broken
            try:
                drv.run_arrays(src, dst)
                raise SmokeFailure("demotion %s: the KernelError did not "
                                   "raise" % tier)
            except kernels.KernelError as e:
                require(not isinstance(e, resilience.StageError)
                        and e.__cause__ is None and len(calls) == 1,
                        "demotion %s: KernelError wrapped or retried: %r "
                        "%s" % (tier, e, calls))
            finally:
                kernels.library = real
            no_demotions("demotion KernelError %s" % tier, drv)
            require(drv.windows_done == 0, "demotion: KernelError moved "
                    "the cursor")
        cases["kernel_error"] = "raised unwrapped, nothing demoted"

        with knob_env(GS_TIER_DEMOTE=0):
            raises("GS_TIER_DEMOTE=0", driver(snapshot_tier="resident"),
                   "dispatch", [faults.FaultSpec(site="dispatch",
                                                 on_call=1)])
        cases["pinned"] = "StageFailed"
    resilience.reset_demotions()
    print(json.dumps({"demotion": dict(
        cases, device=torch.cuda.get_device_name(0))}))
    print("phase demotion: ok  a dispatch fault walked %s bit-equal "
          "(triangles too) in %.2f s, and %s in %.2f s; persistent faults "
          "on scan and a failed h2d copy raised StageFailed, nothing "
          "demoted; probation %s; a transient prep fault retried, none "
          "demoted; resident prep failure %s; a KernelError raised "
          "unwrapped on scan and resident, nothing demoted; "
          "GS_TIER_DEMOTE=0 raised StageFailed; %.1f s"
          % (cases["resident"]["walk"], cases["resident"]["seconds"],
             cases["native"]["walk"], cases["native"]["seconds"],
             cases["probation"], cases["prep_resident"]["walk"],
             time.perf_counter() - t_phase))
    return cases


COHORT_HOOKS = ("telemetry", "metrics", "latency", "costmodel", "provenance",
                "wal", "sanitize", "checkpoint")
COHORT_CKPT_EVERY = 16             # hooks_cohort's auto-checkpoint cadence
COHORT_KILL_PUMP = 3               # its kill: after this many pumps
OOO_TENANTS, OOO_WINDOWS = 4, 4    # its reorder-buffer drill
OOO_BOUND = 100_000                # ns; stamps 1000 ns apart, ±40,000 jitter


def cohort_hooks_pass(streams: dict, hooks, tmp: str, want: dict) -> dict:
    """One pass of serve_cohort with `hooks` armed (the journal by
    enable_wal, checkpoints by enable_auto_checkpoint every
    COHORT_CKPT_EVERY windows): every tenant's windows equal to `want`;
    the launches, host syncs, wall; the journal's bytes and its fsync
    seconds where armed; the cost observatory's cohort rows."""
    from gelly_streaming_tpu_torch import TenantCohort, kernels
    from gelly_streaming_tpu_torch.utils import costmodel, metrics

    reset_hooks()
    with knob_env(**hook_knobs(hooks, tmp)):
        co = TenantCohort(CO_EB, CO_VB)
        if "wal" in hooks:
            require(co.enable_wal(os.path.join(tmp, "wal")),
                    "enable_wal refused")
        if "checkpoint" in hooks:
            co.enable_auto_checkpoint(os.path.join(tmp, "ckpt"),
                                      every_n_windows=COHORT_CKPT_EVERY)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with SyncCount() as syncs:
            out, co, _secs = serve_cohort(streams, co=co)
        torch.cuda.synchronize()
        res = {"wall": time.perf_counter() - t0,
               "launches": dict(kernels.LAUNCHES), "syncs": syncs.n}
        for tid, rows in want.items():
            require(out[tid] == rows, "hooks_cohort %s: tenant %s differs "
                    "from the disarmed run" % (hooks, tid))
        no_demotions("hooks_cohort %s" % (hooks,))
        if "wal" in hooks:
            co._wal.close()
            res["journal_bytes"] = dir_bytes(os.path.join(tmp, "wal"))
        if "metrics" in hooks:
            h = metrics.histogram("gs_wal_fsync_seconds")
            res["fsync_s"] = None if h is None else h["sum"]
        if "costmodel" in hooks:
            res["cost_rows"] = [r for r in costmodel.report()
                                if r["program"] == "cohort_summary"]
        if "checkpoint" in hooks:
            res["checkpoints"] = len(os.listdir(os.path.join(tmp, "ckpt")))
    return res


def poison_rows(co, hostile: str, armed: dict = None) -> None:
    """Wrap co's dispatch so its folded outputs come back with max_degree
    -1 in `hostile`'s slab row (the port test
    test_poison_output_quarantines_by_row's poison), while
    `armed[hostile]` is true if `armed` is given. The outputs are changed
    after the fold (`_fold_slab`), so on the resident tier the poison
    stays outside the replayed CUDA graph."""
    real_batch = co._dispatch_batch
    real_fold = co._fold_slab

    def evil(vb, kb, slab, out, staged):
        rows = [r for t, r, _w, _n in slab[5] if t.tid == hostile
                and (armed is None or armed[hostile])]

        def poisoned(*args):
            res = real_fold(*args)
            if rows:
                res = res.clone()
                res[0, rows[0]] = -1
            return res

        co._fold_slab = poisoned
        try:
            return real_batch(vb, kb, slab, out, staged)
        finally:
            del co._fold_slab

    co._dispatch_batch = evil


def phase_hooks_cohort(dev, streams: dict, want: dict, gnn_want: dict,
                       cohort_bound: dict) -> dict:
    """The cohort's hooks on its main path (serve_cohort over
    cohort_streams(): 64 tenants, 8 at vb=65536, about 8.3M tenant
    edges): the pass disarmed, with the journal, the sanitizer and
    provenance alone, and with every hook armed (COHORT_HOOKS,
    checkpoints every 16 windows among them), disarmed and all twice in
    mirrored turns: every tenant's windows, the launches and the host
    syncs equal to the disarmed pass's; tenant edges/s. Then the drills:
    a `cohort_dispatch` fault on t05 and a poisoned output row on t17
    (GS_QUARANTINE_WINDOWS=2) quarantine exactly those two, every
    tenant's windows exact, t05 re-admitted after its probes; a
    KernelError of the cohort launch raised unwrapped, nothing
    quarantined or demoted; a kill after pump 3 recovered from
    checkpoints + journal into a fresh cohort to the uninterrupted
    windows; the cost observatory's row at 64 × 8 windows, vb=8192,
    equal to phase cohort's bound; 4 tenants with stamps shuffled within
    GS_OOO_BOUND equal to the sorted streams; GnnTenantCohort with every
    hook armed equal to phase gnn_cohort, one provenance record a tenant
    window. The caller pins GS_AUTOTUNE=0 and GS_COHORT_RESIDENT=off (the
    scan form, every ready tenant of a group in one slab), so the numbers
    compare with the runs before the resident tier and the tuner's
    arm."""
    import tempfile

    from gelly_streaming_tpu_torch import (StreamSummaryEngine,
                                           TenantBackpressure, TenantCohort,
                                           kernels)
    from gelly_streaming_tpu_torch.utils import (costmodel, faults,
                                                 metrics, provenance,
                                                 resilience)

    t_phase = time.perf_counter()
    total = sum(len(s) for s, _d, _v in streams.values())
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        passes = [("disarmed", ()), ("all", COHORT_HOOKS)]
        runs = {}
        order = passes + [("journal", ("wal",)),
                          ("sanitizer", ("sanitize",)),
                          ("provenance", ("provenance",))] + passes[::-1]
        for i, (label, hooks) in enumerate(order):
            sub = os.path.join(tmp, "%s_%d" % (label, i))
            os.makedirs(sub)
            runs.setdefault(label, []).append(
                cohort_hooks_pass(streams, hooks, sub, want))
        base = min(runs["disarmed"], key=lambda r: r["wall"])
        for label, rs in runs.items():
            for r in rs:
                require(r["launches"] == base["launches"], "hooks_cohort "
                        "%s: launches %s, disarmed %s"
                        % (label, r["launches"], base["launches"]))
                require(r["syncs"] == base["syncs"], "hooks_cohort %s: %d "
                        "host syncs, disarmed %d" % (label, r["syncs"],
                                                     base["syncs"]))
        rate0 = total / base["wall"]
        for label, rs in runs.items():
            best = min(rs, key=lambda r: r["wall"])
            report[label] = {
                "tenant_edges_per_s": total / best["wall"],
                "share": total / best["wall"] / rate0,
                "walls_s": [r["wall"] for r in rs],
                "launches": sum(best["launches"].values()),
                "syncs": best["syncs"],
                **{k: best[k] for k in ("journal_bytes", "fsync_s",
                                        "checkpoints") if k in best}}
        # the row of phase cohort's main dispatch: the vb=CO_VB group's
        # tenants (56: nb=64) × 8 windows
        nb = 1 << (CO_TENANTS - CO_BIG - 1).bit_length()
        sig = costmodel.tensor_sig((
            torch.empty(nb, CO_VB + 1, dtype=torch.int32),
            torch.empty(nb, 8, CO_EB, dtype=torch.int32)))
        rows = [r for r in runs["all"][0]["cost_rows"] if r["sig"] == sig]
        require(len(rows) == 1, "hooks_cohort: no cost row at %d x 8, "
                "vb=%d" % (nb, CO_VB))
        cost = {"bound_ms": rows[0]["bound_ms"],
                "bound_by": rows[0]["bound_by"],
                "mean_ms": 1e3 * rows[0]["measured_mean_s"],
                "calls": rows[0]["dispatches"]}
        require(abs(cost["bound_ms"] - cohort_bound["bound_ms"]) < 1e-9,
                "hooks_cohort: cost row bound %.6f ms, phase cohort's %.6f"
                % (cost["bound_ms"], cohort_bound["bound_ms"]))
        print("phase hooks_cohort passes: ok  armed == disarmed, launches "
              "%d, host syncs %d in every pass; M tenant edges/s (share of "
              "disarmed) %s; cost row bound %.4f ms (%s), mean event time "
              "%.4f ms a call over %d calls"
              % (report["disarmed"]["launches"], base["syncs"], ", ".join(
                  "%s %.2f (%.3f)" % (k, v["tenant_edges_per_s"] / 1e6,
                                      v["share"])
                  for k, v in report.items()), cost["bound_ms"],
                 cost["bound_by"], cost["mean_ms"], cost["calls"]))

        # the poison drill: a dispatch fault on t05 in the first pump, a
        # poisoned output row on t17 in every dispatch that carries it
        reset_hooks()
        resilience.reset_demotions()
        bisects = []

        def poison_t05(payload):
            if payload and "t05" in payload:
                raise faults.InjectedFault("poisoned", "cohort_dispatch")
            return payload

        with knob_env(**hook_knobs((), tmp), GS_QUARANTINE_WINDOWS=2):
            co = TenantCohort(CO_EB, CO_VB)
            poison_rows(co, "t17")
            split = co._bisect_split

            def counted(batch, wins, err, errors):
                got = split(batch, wins, err, errors)
                bisects.append(got is not None)
                return got

            co._bisect_split = counted
            t0 = time.perf_counter()
            cursor = dict.fromkeys(streams, 0)
            with faults.inject(faults.FaultSpec(
                    site="cohort_dispatch", action="call", fn=poison_t05,
                    times=10 ** 6)):
                out, co, _s = serve_cohort(streams, co=co, cursor=cursor,
                                           stop_after=1)
            tiers = {t: co.tenant_tier(t) for t in ("t05", "t17")}
            rest, co, _s = serve_cohort(streams, co=co, cursor=cursor)
            torch.cuda.synchronize()
            poison_s = time.perf_counter() - t0
        quarantined = sorted({e["tenant"] for e in
                              resilience.demotion_events()
                              if e["to"] == "quarantined"})
        require(quarantined == ["t05", "t17"] and tiers == {
            "t05": "quarantined", "t17": "quarantined"},
            "hooks_cohort poison: quarantined %s, tiers %s"
            % (quarantined, tiers))
        require(co.tenant_tier("t05") == "cohort", "hooks_cohort poison: "
                "t05 not re-admitted")
        for tid, rows_ in want.items():
            require(out[tid] + rest[tid] == rows_, "hooks_cohort poison: "
                    "tenant %s differs" % tid)
        resilience.reset_demotions()
        report["poison"] = {"quarantined": quarantined, "seconds": poison_s,
                            "bisects": sum(bisects),
                            "final_tiers": {t: co.tenant_tier(t)
                                            for t in ("t05", "t17")}}
        print("phase hooks_cohort poison: ok  t05 (dispatch fault) and t17 "
              "(poisoned row) quarantined, every tenant exact, t05 "
              "re-admitted after its probes; %d bisects; %.2f s"
              % (sum(bisects), poison_s))

        # a KernelError of the cohort launch: raised unwrapped, nothing
        # quarantined or demoted
        real = kernels.library
        calls = []

        def broken(name):
            if name == "cohort_summary":
                calls.append(name)
                raise kernels.KernelError("injected: the cohort_summary "
                                          "library failed")
            return real(name)

        with knob_env(**hook_knobs((), tmp)):
            co = TenantCohort(CO_EB, CO_VB)
            kernels.library = broken
            try:
                serve_cohort(streams, co=co)
                raise SmokeFailure("hooks_cohort: the KernelError did not "
                                   "raise")
            except kernels.KernelError as e:
                require(not isinstance(e, resilience.StageError)
                        and e.__cause__ is None and len(calls) == 1,
                        "hooks_cohort: KernelError wrapped or retried: %r %s"
                        % (e, calls))
            finally:
                kernels.library = real
        require(co.quarantined() == [] and all(
            co.tenant_tier(t) == "cohort" for t in streams),
            "hooks_cohort: a device error quarantined or demoted")
        no_demotions("hooks_cohort KernelError")
        report["kernel_error"] = "raised unwrapped, nothing quarantined"

        # a kill after pump 3, recovered from checkpoints + journal
        sub = os.path.join(tmp, "kill")
        wal_dir, ck = os.path.join(sub, "wal"), os.path.join(sub, "ckpt")
        reset_hooks()
        with knob_env(**hook_knobs(("metrics",), sub)):
            co = TenantCohort(CO_EB, CO_VB)
            require(co.enable_wal(wal_dir), "enable_wal refused")
            co.enable_auto_checkpoint(ck, every_n_windows=COHORT_CKPT_EVERY)
            cursor = dict.fromkeys(streams, 0)
            head, co, _s = serve_cohort(streams, co=co, cursor=cursor,
                                        stop_after=COHORT_KILL_PUMP)
            co._wal.close()                       # the kill
            t0 = time.perf_counter()
            rec = TenantCohort(CO_EB, CO_VB)
            for tid, (_s, _d, vb) in streams.items():
                rec.admit(tid, vertex_bucket=vb)
            rec.enable_auto_checkpoint(ck, every_n_windows=COHORT_CKPT_EVERY)
            require(rec.enable_wal(wal_dir), "enable_wal refused")
            info = rec.recover()
            recovery_s = time.perf_counter() - t0
            resumed = {tid: rec.windows_done(tid) for tid in streams}
            tail, rec, _s = serve_cohort(streams, co=rec, cursor=cursor)
            rec._wal.close()
            h = metrics.histogram("gs_wal_fsync_seconds")
        for tid, rows_ in want.items():
            require(head[tid][:resumed[tid]] + tail[tid] == rows_,
                    "hooks_cohort kill: tenant %s differs" % tid)
        require(all(info["resumed"].values()), "hooks_cohort kill: a "
                "tenant had no checkpoint")
        report["kill"] = {
            "recovery_s": recovery_s,
            "replayed_edges": sum(info["replayed_edges"].values()),
            "journal_mb_per_m_edges": dir_bytes(wal_dir) / total,
            "fsync_s": None if h is None else h["sum"],
            "fsyncs": None if h is None else h["count"]}
        print("phase hooks_cohort kill: ok  killed after pump %d, %d "
              "tenants resumed, %d journaled edges replayed in %.3f s, every "
              "window exact; journal %.2f MB a million edges, fsync %.3f s"
              % (COHORT_KILL_PUMP, len(resumed),
                 report["kill"]["replayed_edges"], recovery_s,
                 report["kill"]["journal_mb_per_m_edges"],
                 report["kill"]["fsync_s"] or 0.0))

        # the reorder buffer: stamps shuffled within the bound
        rng = np.random.default_rng(SEED)
        n = OOO_WINDOWS * CO_EB
        got, ref = {}, {}
        with knob_env(**hook_knobs((), tmp), GS_OOO_BOUND=OOO_BOUND):
            co = TenantCohort(CO_EB, CO_VB)
            for i in range(OOO_TENANTS):
                tid = "t%02d" % i
                s, d, _vb = streams[tid]
                s, d = s[:n], d[:n]
                ts = (np.arange(n, dtype=np.int64) * 1000
                      + rng.integers(-40, 40, n) * 1000)
                order = np.argsort(ts, kind="stable")
                ref[tid] = StreamSummaryEngine(CO_EB, CO_VB).process(
                    s[order], d[order])
                co.admit(tid)
                got[tid] = []
                at = 0
                while at < n:
                    try:
                        co.feed(tid, s[at:at + CO_FEED], d[at:at + CO_FEED],
                                ts=ts[at:at + CO_FEED])
                        at += CO_FEED
                    except TenantBackpressure:
                        got[tid] += co.pump().get(tid, [])
                got[tid] += co.pump().get(tid, []) + co.close(tid)
        require(got == ref, "hooks_cohort: the reorder buffer's windows "
                "differ from the sorted streams'")
        print("phase hooks_cohort reorder: ok  %d tenants, stamps shuffled "
              "within GS_OOO_BOUND=%d ns, equal to the sorted streams"
              % (OOO_TENANTS, OOO_BOUND))

        # the GNN cohort, every hook armed
        reset_hooks()
        with knob_env(**hook_knobs(("telemetry", "metrics", "latency",
                                    "costmodel", "provenance"), tmp)):
            kernels.reset_launches()
            gout, _co, gwall = serve_gnn_cohort(*gnn_cohort_inputs())
            torch.cuda.synchronize()
            provenance.reset()
            recs = provenance.scan(os.path.join(tmp, "prov"))["records"]
        require(gout == gnn_want, "hooks_cohort: the armed GNN cohort "
                "differs from phase gnn_cohort")
        require(len(recs) == CO_TENANTS * GNN_CO_WINDOWS
                and kernels.LAUNCHES["gnn_round"] > 0,
                "hooks_cohort gnn: %d provenance records" % len(recs))
        report["gnn_all"] = {"seconds": gwall,
                             "provenance_records": len(recs)}
    reset_hooks()
    resilience.reset_demotions()
    report["cost"] = cost
    report["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"hooks_cohort": report,
                      "device": torch.cuda.get_device_name(0)}))
    print("phase hooks_cohort: ok  %.1f s" % report["seconds"])
    return report


SERVE_CLIENTS = 4                  # phase serve (a): client threads
SERVE_SYNC = (6, 2, 16)            # (b): small, big tenants; windows each
SERVE_CLI = (4, 16)                # (c), (d): tenants; windows each
SERVE_CLI_KILL = 8                 # (c): windows fed before the kill
SERVE_DEVICE_ARGS = ()             # the subprocess server's --device
SERVE_BUDGET_S = 300               # (c)'s deadline for its subprocesses


class TimedClient:
    """A ServeClient whose requests time their own JSON encode and
    decode (`codec`, seconds) and ride the typed backpressure: `feed_all`
    feeds a tenant's stream from its cursor until the queue refuses."""

    def __init__(self, port: int):
        from gelly_streaming_tpu_torch import ServeClient

        self.cli = ServeClient(port, timeout=120)
        # a feed is about one loopback segment: no Nagle hold on its tail
        self.cli.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.codec = 0.0         # JSON encode and decode, seconds
        self.wire = 0.0          # request round trips less the codec
        self.slept = 0.0         # sleeping retry hints
        self.refused = 0

    def request(self, **req) -> dict:
        cli = self.cli
        t0 = time.perf_counter()
        line = (json.dumps(req) + "\n").encode()
        t1 = time.perf_counter()
        cli.sock.sendall(line)
        while b"\n" not in cli._buf:
            cli._recv("serve: the server closed a connection")
        t2 = time.perf_counter()
        resp = cli._line()
        self.codec += (t1 - t0) + (time.perf_counter() - t2)
        self.wire += t2 - t1
        return resp

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)
        self.slept += seconds

    def feed(self, tid, s, d) -> dict:
        t0 = time.perf_counter()
        src, dst = s.tolist(), d.tolist()
        self.codec += time.perf_counter() - t0
        return self.request(op="feed", tenant=tid, src=src, dst=dst)

    def feed_until_refused(self, tid, s, d, cursor: dict):
        """Feed CO_FEED edges at a time from cursor[tid]; None once the
        stream is in, else the refusal's retry hint."""
        while cursor[tid] < len(s):
            c = cursor[tid]
            r = self.feed(tid, s[c:c + CO_FEED], d[c:c + CO_FEED])
            if not r["ok"]:
                require(r["error"] == "TenantBackpressure", "serve: %s" % r)
                self.refused += 1
                return r["retry_after_s"]
            require(r["accepted"] == len(s[c:c + CO_FEED]),
                    "serve: a partial accept %s" % r)
            cursor[tid] = c + CO_FEED
        return None


def serve_streams(port: int, streams: dict, client: "TimedClient" = None,
                  pump: bool = False) -> "TimedClient":
    """Admit `streams` ({tenant: (src, dst, vb)}) through one client and
    feed them whole, sweeping the tenants: each is fed until its queue
    refuses, and a refused tenant waits out its retry hint before it is
    tried again (the async server pumps by itself); with `pump` (the
    sync server) a sweep with a refusal is followed by a pump request
    instead. Closes every tenant at the end."""
    cli = client or TimedClient(port)
    for tid, (_s, _d, vb) in streams.items():
        require(cli.request(op="admit", tenant=tid,
                            vertex_bucket=vb)["ok"], "serve: admit %s" % tid)
    cursor = dict.fromkeys(streams, 0)
    wake = dict.fromkeys(streams, 0.0)     # a refused tenant's next try
    while True:
        pending = [t for t, (s, _d, _v) in streams.items()
                   if cursor[t] < len(s)]
        if not pending:
            break
        now = time.perf_counter()
        ready = [t for t in pending if wake[t] <= now]
        if not ready:
            cli.sleep(min(wake[t] for t in pending) - now)
            continue
        refused = False
        for t in ready:
            s, d, _vb = streams[t]
            hint = cli.feed_until_refused(t, s, d, cursor)
            if hint is not None:
                refused = True
                if not pump:
                    wake[t] = time.perf_counter() + hint
        if pump and refused:
            require(cli.request(op="pump")["ok"], "serve: pump refused")
    for tid in streams:
        require(cli.request(op="close", tenant=tid)["ok"],
                "serve: close %s" % tid)
    return cli


def served_rows(label: str, rows: dict, want: dict, windows=None) -> int:
    """Every tenant's delivered rows: ordinals 0.. and summaries equal to
    `want` (its first `windows` where given). Returns the rows."""
    n = 0
    for tid, w in want.items():
        w = w if windows is None else w[:windows]
        got = rows.get(tid, [])
        require([r["window"] for r in got] == list(range(len(w)))
                and [r["summary"] for r in got] == w,
                "%s: tenant %s: %d rows, %d differ from phase "
                "cohort_stream's" % (label, tid, len(got), sum(
                    a["summary"] != b for a, b in zip(got, w))))
        n += len(got)
    return n


def results_file_rows(path: str) -> dict:
    """The last record per (tenant, window) of a results file."""
    last = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            last[(r["tenant"], r["window"])] = r["summary"]
    return last


def spawn_cli(tmp: str, *extra) -> tuple:
    """Start `python -m gelly_streaming_tpu_torch.core.serve` on the card
    (the default device) with a journal, checkpoints, a results file and
    a port file: (process, port file, start time)."""
    port_file = os.path.join(tmp, "port.txt")
    if os.path.exists(port_file):
        os.unlink(port_file)
    cmd = [sys.executable, "-m", "gelly_streaming_tpu_torch.core.serve",
           "--edge-bucket", str(CO_EB), "--vertex-bucket", str(CO_VB),
           "--wal", os.path.join(tmp, "wal"),
           "--ckpt", os.path.join(tmp, "ckpt"), "--ckpt-every", "4",
           "--results", os.path.join(tmp, "results.jsonl"),
           "--port-file", port_file, *SERVE_DEVICE_ARGS, *extra]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return proc, port_file, t0


def serving_port(cli: tuple, end: float) -> tuple:
    """(port, seconds from the start to the port file) of a spawn_cli
    server; kills it on a failure."""
    proc, port_file, t0 = cli
    try:
        while True:
            require(time.perf_counter() < end, "serve: no port file")
            text = open(port_file).read() if os.path.exists(port_file) \
                else ""
            if text.strip():
                return int(text), time.perf_counter() - t0
            if proc.poll() is not None:
                _out, err = proc.communicate()
                raise SmokeFailure("serve: the server exited %d: %s"
                                   % (proc.returncode, err[-2000:]))
            time.sleep(0.02)
    except BaseException:
        reap(proc)
        raise


def reap(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def phase_serve(dev, streams: dict, want: dict, direct_rate: float) -> dict:
    """The serving front end (core/serve.py) on the card over loopback.
    (a) GS_PUMP=async: a StreamServer over TenantCohort(4096, 8192) takes
    phase cohort_stream's 64 streams (8 at vb=65536, about 8.3M edges)
    from SERVE_CLIENTS client threads in CO_FEED-edge feeds riding the
    typed backpressure: every row and the results file equal to phase
    cohort_stream's windows, feeds admitted during dispatches, the cohort
    and counter kernels launched, nothing demoted; tenant edges/s beside
    cohort_stream's, host seconds of codec, feed, pump and emit, device
    busy from CUDA events around each dispatch. (b) GS_PUMP=sync over a
    cut of 8 tenants (2 at vb=65536) of 16 windows: rows equal to (a)'s.
    (c) The standalone server on the card with journal, checkpoints and
    results, 4 tenants of 16 windows: killed after 8.5 windows a tenant
    were fed, restarted with --recover, fed the rest, closed and drained
    by SIGTERM: exit 0, a sealed drain, the last record per (tenant,
    window) equal to (a)'s. (d) A subscriber at GS_SUB_QUEUE=1 that never
    reads is shed while the pump serves on; a KernelError of the cohort
    launch on the async pump thread makes the server fatal and is raised
    unwrapped by serve_until_drained, nothing quarantined or demoted.
    The caller pins GS_AUTOTUNE=0 and GS_COHORT_RESIDENT=off (the scan
    form, every ready tenant of a group in one slab), so the numbers
    compare with the runs before the resident tier and the tuner's arm;
    (c)'s server inherits them."""
    import signal
    import tempfile
    import threading
    from types import SimpleNamespace

    from gelly_streaming_tpu_torch import (ServeClient, StreamServer,
                                           TenantCohort, kernels)
    from gelly_streaming_tpu_torch.core import serve as serve_mod

    t_phase = time.perf_counter()
    total = sum(len(s) for s, _d, _v in streams.values())
    report = {}
    with tempfile.TemporaryDirectory() as tmp:
        # (c)'s standalone server starts (interpreter, torch, the card)
        # while (a) and (b) run
        sub = os.path.join(tmp, "cli")
        os.makedirs(sub)
        first = spawn_cli(sub)
        end = time.perf_counter() + SERVE_BUDGET_S
        try:
            # (a) the async pump, whole streams, several clients
            secs = {"feed": 0.0, "pump": 0.0, "emit": 0.0, "request": 0.0,
                    "codec": 0.0}
            lock = threading.Lock()

            def timed_call(fn, key):
                def run(*a, **k):
                    t0 = time.perf_counter()
                    try:
                        return fn(*a, **k)
                    finally:
                        with lock:
                            secs[key] += time.perf_counter() - t0
                return run

            results = os.path.join(tmp, "results.jsonl")
            with knob_env(GS_PUMP="async"):
                co = TenantCohort(CO_EB, CO_VB)        # device=None: the card
                srv = StreamServer(co, port=0, results_path=results)
            co.feed = timed_call(co.feed, "feed")
            co.pump = timed_call(co.pump, "pump")
            srv._emit = timed_call(srv._emit, "emit")
            srv._handle_request = timed_call(srv._handle_request, "request")
            # the server's JSON codec: its module's json, timed
            serve_mod.json = SimpleNamespace(
                loads=timed_call(json.loads, "codec"),
                dumps=timed_call(json.dumps, "codec"))
            tids = list(streams)
            parts = [{tid: streams[tid] for tid in tids[i::SERVE_CLIENTS]}
                     for i in range(SERVE_CLIENTS)]
            clients, errors = [], []

            def client(part):
                try:
                    clients.append(serve_streams(srv.port, part))
                except BaseException as e:      # raised after the join
                    errors.append(e)

            torch.cuda.synchronize()
            kernels.reset_launches()
            srv.start()
            with dispatch_events([co._stage]) as evs:
                t0 = time.perf_counter()
                threads = [threading.Thread(target=client, args=(p,))
                           for p in parts]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join()
                require(not errors, "serve (a): a client failed: %r"
                        % (errors[:1],))
                for c in clients:
                    c.cli.close()
                drained = srv.drain(deadline_s=60)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            busy_ms = evs.busy_ms()
            srv.close()
            serve_mod.json = json
            launches = dict(kernels.LAUNCHES)
            n = served_rows("serve (a)", srv.results, want)
            require(drained["sealed"] and drained["windows_total"] == n,
                    "serve (a): drain %s" % drained)
            require(results_file_rows(results) == {
                (tid, i): s for tid, w in want.items()
                for i, s in enumerate(w)}
                and sum(1 for _ in open(results)) == n,
                "serve (a): the results file differs from the rows")
            require(srv._stats["overlap_feeds"] > 0,
                    "serve (a): no feed was admitted during a dispatch")
            require(launches["cohort_summary"] > 0
                    and launches["window_counter"] > 0,
                    "serve (a): launches %s" % launches)
            no_demotions("phase serve (a)")
            codec_client = sum(c.codec for c in clients)
            wire = sum(c.wire for c in clients)
            slept = sum(c.slept for c in clients)
            report["async"] = {
                "tenants": len(streams), "edges": total, "windows": n,
                "clients": SERVE_CLIENTS, "seconds": wall,
                "tenant_edges_per_s": total / wall,
                "direct_tenant_edges_per_s": direct_rate,
                "share_of_direct": total / wall / direct_rate,
                "host_seconds": {
                    "client_codec": codec_client, "client_wire": wire,
                    "client_slept": slept,
                    "server_codec": secs["codec"],
                    "server_requests": secs["request"],
                    "feed": secs["feed"], "pump": secs["pump"],
                    "emit": secs["emit"]},
                "refusals": sum(c.refused for c in clients),
                "overlap_feeds": srv._stats["overlap_feeds"],
                "requests": srv._stats["requests"],
                "device_busy_ms": busy_ms, "dispatches": len(evs.spans),
                "idle_share": 1 - busy_ms / (1e3 * wall),
                "launches": launches}
            print("phase serve (a): ok  %d tenants, %d windows over loopback, "
                  "GS_PUMP=async, %d clients: %.4g tenant edges/s (direct "
                  "%.4g, %.3f of it); host s: client codec %.2f, wire %.2f, "
                  "slept %.2f (%d refusals), server codec %.2f, requests %.2f "
                  "(feed %.2f), pump %.2f, emit %.2f; device busy %.1f ms of "
                  "%.2f s, idle %.4f; %d overlapping feeds"
                  % (len(streams), n, SERVE_CLIENTS, total / wall, direct_rate,
                     total / wall / direct_rate, codec_client, wire, slept,
                     report["async"]["refusals"], secs["codec"],
                     secs["request"], secs["feed"], secs["pump"], secs["emit"],
                     busy_ms, wall,
                     report["async"]["idle_share"],
                     srv._stats["overlap_feeds"]))

            # (b) the sync pump over a cut
            small, big, windows = SERVE_SYNC
            cut = [t for t in tids if streams[t][2] == CO_VB][:small] \
                + [t for t in tids if streams[t][2] == CO_BIG_VB][:big]
            part = {t: tuple(a[:windows * CO_EB] for a in streams[t][:2])
                    + (streams[t][2],) for t in cut}
            with knob_env(GS_PUMP="sync"):
                srv = StreamServer(TenantCohort(CO_EB, CO_VB), port=0).start()
            try:
                t0 = time.perf_counter()
                cli = serve_streams(srv.port, part, pump=True)
                sync_s = time.perf_counter() - t0
                cli.cli.close()
                require(srv.pump_mode == "sync" and srv._pump_thread is None,
                        "serve (b): not the sync pump")
            finally:
                srv.close()
            served_rows("serve (b)", srv.results,
                        {t: want[t] for t in cut}, windows)
            no_demotions("phase serve (b)")
            report["sync"] = {"tenants": len(cut), "windows": windows,
                              "seconds": sync_s,
                              "tenant_edges_per_s":
                                  len(cut) * windows * CO_EB / sync_s}
            print("phase serve (b): ok  GS_PUMP=sync, %d tenants x %d windows "
                  "equal to (a)'s, %.2f s" % (len(cut), windows, sync_s))

            # (c) the standalone server on the card: kill, recover, drain
            ntenants, windows = SERVE_CLI
            part = {t: tuple(a[:windows * CO_EB] for a in streams[t][:2])
                    + (streams[t][2],) for t in tids[:ntenants]}
            head = SERVE_CLI_KILL * CO_EB + CO_EB // 2
            proc = first[0]
            port, start_s = serving_port(first, end)
            try:
                cli = TimedClient(port)
                for t, (s, d, vb) in part.items():
                    require(cli.request(op="admit", tenant=t,
                                        vertex_bucket=vb)["ok"], "serve (c)")
                    cursor = {t: 0}
                    while cursor[t] < head:
                        hint = cli.feed_until_refused(t, s[:head], d[:head],
                                                      cursor)
                        if hint is not None:
                            cli.sleep(hint)
                path = os.path.join(sub, "results.jsonl")
                while not (os.path.exists(path) and len(results_file_rows(
                        path)) >= ntenants * SERVE_CLI_KILL):
                    require(time.perf_counter() < end and proc.poll() is None,
                            "serve (c): the windows fed were not delivered")
                    time.sleep(0.02)
                cli.cli.close()
                proc.kill()                            # SIGKILL mid-window
                proc.communicate(timeout=60)
            finally:
                reap(proc)
            killed_rows = len(results_file_rows(path))
            second = spawn_cli(sub, "--recover")
            proc = second[0]
            port, recover_s = serving_port(second, end)
            try:
                cli = TimedClient(port)
                for t, (s, d, _vb) in part.items():
                    cursor = {t: head}
                    while cursor[t] < len(s):
                        hint = cli.feed_until_refused(t, s, d, cursor)
                        if hint is not None:
                            cli.sleep(hint)
                    require(cli.request(op="close", tenant=t)["ok"],
                            "serve (c): close %s" % t)
                cli.cli.close()
                proc.send_signal(signal.SIGTERM)
                out, err = proc.communicate(
                    timeout=max(1.0, end - time.perf_counter()))
            finally:
                reap(proc)
            require(proc.returncode == 0, "serve (c): exit %d: %s"
                    % (proc.returncode, err[-2000:]))
            lines = out.splitlines()
            drained = [json.loads(x[len("drained: "):]) for x in lines
                       if x.startswith("drained: ")]
            recovered = [json.loads(x[len("recovered: "):]) for x in lines
                         if x.startswith("recovered: ")]
            require(len(drained) == 1 and drained[0]["sealed"] is True
                    and len(recovered) == 1, "serve (c): %s" % lines)
            require(results_file_rows(path) == {
                (t, i): s for t in part
                for i, s in enumerate(want[t][:windows])},
                "serve (c): the last records differ from (a)'s rows")
            report["cli"] = {"tenants": ntenants, "windows": windows,
                             "killed_after_rows": killed_rows,
                             "start_s": start_s, "recover_start_s": recover_s,
                             "replayed_edges": recovered[0]["replayed_edges"],
                             "drain": drained[0]}
            print("phase serve (c): ok  the standalone server on the card, %d "
                  "tenants x %d windows: killed with %d rows delivered, "
                  "restarted with --recover to serving in %.2f s (the first "
                  "start, beside (a) and (b), %.2f s), %d journaled edges "
                  "replayed, drained sealed, every window's last record equal "
                  "to (a)'s"
                  % (ntenants, windows, killed_rows, recover_s, start_s,
                     sum(recovered[0]["replayed_edges"].values())))

            # (d) the drills: a subscriber that never reads; a KernelError on
            # the pump thread
            with knob_env(GS_PUMP="async", GS_SUB_QUEUE=1):
                srv = StreamServer(TenantCohort(CO_EB, CO_VB), port=0).start()
                try:
                    deaf = ServeClient(srv.port, timeout=120)
                    require(deaf.subscribe("*")["ok"], "serve (d): subscribe")
                    cli = serve_streams(srv.port, part)
                    shed = (not srv._subs, srv._stats["shed"])
                    cli.cli.close()
                    deaf.close()
                    srv.drain(deadline_s=60)
                finally:
                    srv.close()
            require(shed[0] and shed[1] >= 1, "serve (d): the subscriber that "
                    "never reads was not shed: %s" % (shed,))
            served_rows("serve (d) subscriber", srv.results,
                        {t: want[t] for t in part}, windows)
            no_demotions("phase serve (d)")

            real, calls = kernels.library, []

            def broken(name):
                if name == "cohort_summary":
                    calls.append(name)
                    raise kernels.KernelError("injected: the cohort_summary "
                                              "library failed")
                return real(name)

            term = signal.getsignal(signal.SIGTERM)
            with knob_env(GS_PUMP="async"):
                srv = StreamServer(TenantCohort(CO_EB, CO_VB), port=0).start()
            kernels.library = broken
            try:
                t, (s, d, vb) = next(iter(part.items()))
                cli = ServeClient(srv.port, timeout=120)
                cli.admit(t, vertex_bucket=vb)
                require(cli.feed(t, s[:2 * CO_EB], d[:2 * CO_EB])["ok"],
                        "serve (d): feed")
                stop = time.perf_counter() + 60
                while not srv.fatal and time.perf_counter() < stop:
                    time.sleep(0.01)
                require(srv.fatal, "serve (d): the KernelError left the "
                        "server serving")
                try:
                    srv.serve_until_drained()
                    raise SmokeFailure("serve (d): the KernelError did not "
                                       "raise")
                except kernels.KernelError as e:
                    require(e is srv.pump_error and e.__cause__ is None
                            and srv.fatal and calls == ["cohort_summary"],
                            "serve (d): KernelError wrapped or retried: %r %s"
                            % (e, calls))
                cli.close()
                co = srv.cohort
                require(co.quarantined() == []
                        and co.tenant_tier(t) == "cohort"
                        and co.queued_edges(t) == 2 * CO_EB,
                        "serve (d): a device error quarantined or demoted")
            finally:
                kernels.library = real
                signal.signal(signal.SIGTERM, term)
                srv.close()
            no_demotions("phase serve (d) KernelError")
            report["drills"] = {"subscriber_shed": shed[1],
                                "kernel_error": "raised unwrapped, server "
                                                "fatal, nothing quarantined"}
            print("phase serve (d): ok  the subscriber that never read was "
                  "shed and every row served; a KernelError on the pump "
                  "thread raised unwrapped, the server fatal, nothing "
                  "quarantined")
        finally:
            reap(first[0])
    report["seconds"] = time.perf_counter() - t_phase
    print(json.dumps({"serve": report,
                      "device": torch.cuda.get_device_name(0)}))
    print("phase serve: ok  %.1f s" % report["seconds"])
    return report


def device_trace_capture(dev) -> dict:
    """One device_trace capture of a driver call over DEMOTE_EDGES edges
    with the flight recorder armed, taken before any other profiler
    session of the process: on the H100, torch.profiler records none of
    the card's kernels in a process after a long profiler session (phase
    api's profiled record API; `gelly_streaming_tpu_torch/utils/
    trace_probe.py --smoke`). It must hold the snapshot and counter
    kernels' events and stamp the durable `device_trace_captured`
    event; phase api_tracing holds its windows to phase driver's
    (`digests`, provenance.result_digest a window)."""
    import tempfile

    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver
    from gelly_streaming_tpu_torch.utils import (provenance, telemetry,
                                                 tracing)

    src, dst = bench_stream()
    drv = StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                   vertex_bucket=VB)
    reset_hooks()
    with tempfile.TemporaryDirectory() as tmp, \
            knob_env(**hook_knobs(("telemetry",), tmp)):
        drv.run_arrays(src[:2 * EB], dst[:2 * EB])      # warm-up
        drv.reset()
        with tracing.device_trace(os.path.join(tmp, "device_trace")) as cap:
            got = drv.run_arrays(src[:DEMOTE_EDGES], dst[:DEMOTE_EDGES])
            torch.cuda.synchronize()
        events = [r for r in telemetry.records()
                  if r.get("name") == "device_trace_captured"]
        require(cap.path and os.path.isfile(cap.path) and events,
                "device_trace: no capture written")
        named = {k: sum(n for name, n in cap.kernels.items() if k in name)
                 for k in ("snapshot_grid_kernel", "counter_kernel")}
        require(cap.kernel_events > 0 and all(named.values()),
                "device_trace: the capture holds %d kernel events, the "
                "driver's kernels %s" % (cap.kernel_events, named))
        out = {"kernel_events": cap.kernel_events, "driver_kernels": named,
               "bytes": os.path.getsize(cap.path),
               "digests": [provenance.result_digest(r) for r in got]}
    reset_hooks()
    no_demotions("device_trace", drv)
    print("device_trace: %d kernel events (%s), %d bytes"
          % (out["kernel_events"], named, out["bytes"]))
    return out


def phase_api_tracing(dev, api: dict, want_driver: list,
                      capture: dict) -> dict:
    """Tracing on the graph API and the reduce stream: the record API's
    slice(512 ms, ALL).reduce_on_edges over the first API_TRACE_EDGES of
    phase api's timestamped edges with env.enable_tracing(), every window
    equal to numpy, its steps and its rate beside phase api's untraced
    rate (`api`); WindowedEdgeReduce over the reduce-leg stream with the
    flight recorder armed, equal to bench.py's port, its spans counted;
    the device_trace capture of a driver call (`capture`, taken first in
    the process by device_trace_capture), its windows equal to phase
    driver's (`want_driver`)."""
    import tempfile

    import gelly_streaming_tpu_torch as P
    from gelly_streaming_tpu_torch import WindowedEdgeReduce, make_stream
    from gelly_streaming_tpu_torch.utils import provenance, telemetry

    out = {}
    src, dst = (a[:API_TRACE_EDGES]
                for a in P.make_stream(API_EDGES, VB, seed=SEED))
    ts = np.arange(API_TRACE_EDGES) // API_EDGES_PER_MS
    env, graph = api_graph(P, src, dst, ts)
    sink = graph.slice(P.Time.milliseconds_of(API_WINDOW_MS),
                       P.EdgeDirection.ALL).reduce_on_edges(
        P.TorchEdgesReduce(name="sum")).collect()
    env.enable_tracing()
    t0 = time.perf_counter()
    env.execute()
    wall = time.perf_counter() - t0
    check_api_reduce("api_tracing", env._results[sink.node.id], src, dst,
                     ts)
    steps = env.trace_report()
    require(steps and sum(r["calls"] for r in steps) >= len(steps),
            "api_tracing: no steps")
    out["record_api"] = {
        "edges": API_TRACE_EDGES, "edges_per_s": API_TRACE_EDGES / wall,
        "untraced_edges_per_s": api["edges_per_s"],
        "steps": [{k: r[k] for k in ("op", "total_s", "calls", "records")}
                  for r in steps]}

    reset_hooks()
    with tempfile.TemporaryDirectory() as tmp, \
            knob_env(**hook_knobs(("telemetry",), tmp)):
        rsrc, rdst = make_stream(RED_EDGES, RED_VB)
        val = red_values(rsrc, rdst)
        eng = WindowedEdgeReduce(RED_VB, RED_EB, "sum", "out")
        same_rows("api_tracing reduce", eng.process_stream(rsrc, rdst, val),
                  np_port_with_counts(rsrc, val, RED_EB, RED_VB))
        spans = {}
        for r in telemetry.records():
            if r.get("t") == "span":
                spans[r["name"]] = spans.get(r["name"], 0) + 1
        require(spans.get("reduce.stream") == 1
                and spans.get("ingress.dispatch"),
                "api_tracing reduce spans: %s" % spans)
        out["reduce_spans"] = spans
    reset_hooks()

    want = [provenance.result_digest(r)
            for r in want_driver[:len(capture["digests"])]]
    require(capture["digests"] == want, "api_tracing: the captured driver "
            "call's windows differ from phase driver's")
    out["device_trace"] = {k: v for k, v in capture.items()
                           if k != "digests"}
    out["device"] = torch.cuda.get_device_name(0)
    print(json.dumps({"api_tracing": out}))
    print("phase api_tracing: ok  record API traced %.1f edges/s "
          "(untraced %.1f, phase api), %d steps; reduce stream spans %s; "
          "device_trace of a driver call (the process's first profiler "
          "session): %d kernel events (%s), %d bytes"
          % (out["record_api"]["edges_per_s"], api["edges_per_s"],
             len(steps), spans, capture["kernel_events"],
             capture["driver_kernels"], capture["bytes"]))
    return out


# ----------------------------------------------------------------------
SHARDED_SUMMARY_WINDOWS = 160      # (b), (d): depth of the summary stream
                                   # (cut from 320: the script past 400 s)
SHARDED_ENGINE_WINDOWS = 4         # (c): windows through degrees/CC/bipartite
SHARDED_PANES = 16                 # (c): panes of the sliding reduce
SHARDED_PANE_EDGES = 16384         # edges a pane
SHARDED_WP = 4                     # panes a window
SHARDED_TABLES = ("replicated", "owner")


def oriented_csr(src, dst, n: int):
    """The oriented CSR of a window ((degree, id) order, deduplicated,
    rows ascending): (nbr [vb+1, K], a, b) for
    ShardedWindowEngine.triangles."""
    src, dst = np.asarray(src, np.int64), np.asarray(dst, np.int64)
    keep = src != dst
    lo, hi = np.minimum(src, dst)[keep], np.maximum(src, dst)[keep]
    und = np.unique(lo * n + hi)
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
    k = 8
    while k < counts.max():
        k *= 2
    nbr = np.full((n + 1, k), n, np.int32)
    nbr[a, np.arange(len(a)) - starts[a]] = b
    return nbr, a, b


def numpy_panes(src, pane, val, vb: int, pb: int, wp: int, name: str):
    """(win_vals, win_counts, win_abs) of the sliding reduce in numpy:
    each (pane, vertex) cell reduced, then each window's wp panes
    combined; empty cells hold the monoid identity (the engines'
    `_pane_identity`), win_abs the Σ|v| of each window cell."""
    vbp = vb + 1
    ids = pane.astype(np.int64) * vbp + src
    counts = np.bincount(ids, minlength=pb * vbp).reshape(pb, vbp)
    absum = np.zeros(pb * vbp)
    np.add.at(absum, ids, np.abs(val.astype(np.float64)))
    if name == "sum":
        cells = np.zeros(pb * vbp, val.dtype)
        np.add.at(cells, ids, val)
        ident = 0
    else:
        big = (np.finfo(val.dtype).max if val.dtype.kind == "f"
               else np.iinfo(val.dtype).max)
        ident = big if name == "min" else -big
        cells = np.full(pb * vbp, ident, val.dtype)
        (np.minimum if name == "min" else np.maximum).at(cells, ids, val)
    cells = cells.reshape(pb, vbp)
    n_w = pb + wp - 1
    wv = np.full((n_w, vbp), ident, val.dtype)
    wc = np.zeros((n_w, vbp), np.int64)
    wa = np.zeros((n_w, vbp))
    for w in range(n_w):
        lo, hi = max(w - wp + 1, 0), min(w, pb - 1)
        part = cells[lo:hi + 1]
        wv[w] = (part.sum(0, dtype=val.dtype) if name == "sum" else
                 part.min(0) if name == "min" else part.max(0))
        wc[w] = counts[lo:hi + 1].sum(0)
        wa[w] = absum.reshape(pb, vbp)[lo:hi + 1].sum(0)
    return wv, wc, wa


def sharded_window_engine(m, src, dst, counts: list) -> dict:
    """(c): ShardedWindowEngine(mesh, 65536) over the stream's first
    windows (degrees, CC, bipartite against the host twin and numpy),
    the triangle table of window 0 (its count against phase stream's),
    and sliding_reduce for sum/min/max over int32 and float32 and gcd
    in the associative tier (against numpy; float sums to 1e-5·Σ|v| a
    cell). Returns its launches and checks."""
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.parallel import host_twin, sharded

    eng = sharded.ShardedWindowEngine(m, VB)
    twin = host_twin.HostWindowEngine(VB)
    kernels.reset_launches()
    t0 = time.perf_counter()
    for w in range(SHARDED_ENGINE_WINDOWS):
        s, d = src[w * EB:(w + 1) * EB], dst[w * EB:(w + 1) * EB]
        got = eng.degrees(s, d)
        require(np.array_equal(got, twin.degrees(s, d)),
                "sharded engine: degrees of window %d differ" % w)
        require(np.array_equal(got, (
            np.bincount(src[:(w + 1) * EB], minlength=VB)
            + np.bincount(dst[:(w + 1) * EB], minlength=VB))),
            "sharded engine: degrees of window %d != numpy" % w)
        require(np.array_equal(eng.cc_labels(s, d), twin.cc_labels(s, d)),
                "sharded engine: CC labels of window %d differ" % w)
        for a, b in zip(eng.bipartite(s, d), twin.bipartite(s, d)):
            require(np.array_equal(a, b), "sharded engine: bipartite of "
                    "window %d differs" % w)
    nbr, a, b = oriented_csr(src[:EB], dst[:EB], VB)
    tri = eng.triangles(nbr, a, b, np.ones(len(a), bool))
    require(tri == counts[0], "sharded engine: triangles %d != phase "
            "stream's %d" % (tri, counts[0]))
    n = SHARDED_PANES * SHARDED_PANE_EDGES
    ps = np.asarray(src[:n], np.int32)
    pane = (np.arange(n) // SHARDED_PANE_EDGES).astype(np.int32)
    ival = red_values(ps, dst[:n])
    fval = (ival * np.float32(0.37) - np.float32(11.5)).astype(np.float32)
    err = 0.0
    cells = 0
    for val in (ival, fval):
        for name in ("sum", "min", "max"):
            wv, wc = eng.sliding_reduce(ps, pane, val, SHARDED_PANES,
                                        SHARDED_WP, name=name)
            want, wantc, wa = numpy_panes(ps, pane, val, VB, SHARDED_PANES,
                                          SHARDED_WP, name)
            label = "sliding %s %s" % (name, val.dtype)
            require(np.array_equal(wc, wantc), label + ": counts differ")
            occ = wantc > 0
            cells += int(occ.sum())
            if name == "sum" and val.dtype == np.float32:
                diff = np.abs(wv.astype(np.float64) - want)
                err = max(err, float(diff[occ].max()))
                require(np.all(diff[occ] <= 1e-5 * wa[occ]),
                        label + ": past 1e-5 · Σ|v|")
            else:
                require(np.array_equal(wv, want), label + ": values differ")
    gv, gc = eng.sliding_reduce(ps, pane, ival, SHARDED_PANES, SHARDED_WP,
                                fn=torch.gcd)
    mv, mc = eng.sliding_reduce(ps, pane, ival, SHARDED_PANES, SHARDED_WP,
                                name="min")
    require(np.array_equal(gc, mc), "sliding gcd: counts differ")
    # gcd of values 1..97 over a cell: checked against numpy's on the
    # cells of window SHARDED_WP - 1 (its wp panes in full)
    w = SHARDED_WP - 1
    ids = ps[:(w + 1) * SHARDED_PANE_EDGES].astype(np.int64)
    want = np.zeros(VB + 1, np.int64)
    np.gcd.at(want, ids, ival[:(w + 1) * SHARDED_PANE_EDGES].astype(np.int64))
    occ = gc[w] > 0
    require(np.array_equal(gv[w][occ], want[occ]), "sliding gcd: values of "
            "window %d differ" % w)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"launches": dict(kernels.LAUNCHES), "seconds": seconds,
            "pane_cells_checked": cells, "float_sum_max_abs_err": err,
            "triangles_window0": tri}


def sharded_turns(m, src, dst, counts: list) -> dict:
    """(e): count_stream of the single-chip kernel and of the sharded
    kernel (the replicated table; (a) times the owner mode once) in
    turns, single, sharded, sharded, single: wall, edges/s and the idle
    share from CUDA events around each dispatch (event_busy)."""
    from gelly_streaming_tpu_torch import TriangleWindowKernel
    from gelly_streaming_tpu_torch.parallel import sharded

    kerns = {"single": TriangleWindowKernel(EB, VB),
             "sharded": sharded.ShardedTriangleWindowKernel(
                 m, EB, VB, k_bucket=KB)}
    for k in kerns.values():
        k.count_stream(src[:2 * EB], dst[:2 * EB])   # warm-up
    turns = {k: [] for k in kerns}
    for name in ("single", "sharded", "sharded", "single"):
        got = []
        row = event_busy(lambda: got.append(kerns[name].count_stream(src,
                                                                     dst)),
                         lambda: None, [kerns[name]._ring])
        require(got[0] == counts, "timing turn %s: counts differ" % name)
        row["edges_per_s"] = STREAM_EDGES / (row["wall_ms"] / 1e3)
        turns[name].append(row)
    return turns


def sharded_group():
    """The one-rank NCCL group of phases sharded and driver_mesh:
    make_mesh() on the card (device=None), whose caller destroys it."""
    import torch.distributed as dist

    from gelly_streaming_tpu_torch.parallel import mesh as mesh_mod

    require(not dist.is_initialized(), "a process group exists already")
    m = mesh_mod.make_mesh()                  # device=None: the card
    require(m.backend == "nccl" and m.device.type == "cuda"
            and m.size == 1 and m.rank == 0,
            "mesh %s is not one NCCL rank on the card" % m)
    return m


def phase_sharded(m, counts: list, summaries: list, state: dict) -> dict:
    """The sharded engines (gelly_streaming_tpu_torch/parallel/) on the
    one-rank NCCL group of sharded_group(), over the bench stream at
    eb=32768, vb=65536, kb=128: (a)
    ShardedTriangleWindowKernel.count_stream over the 320 windows in both
    table modes, every count equal to phase stream's, the launches of
    rows 1, U and R and the windows that went down the ladder, and a
    200-clique window recounted down it; (b)
    ShardedSummaryEngine.process over SHARDED_SUMMARY_WINDOWS windows,
    every summary and the final state bit-equal to phase
    summary_stream's; (c) ShardedWindowEngine (sharded_window_engine);
    (d) a state taken half way, through the host twin and back, the
    resumed stream equal to (b)'s; (e) sharded_turns. Each path's
    launches are counted from 0."""
    from gelly_streaming_tpu_torch import StreamSummaryEngine, kernels
    from gelly_streaming_tpu_torch.parallel import host_twin
    from gelly_streaming_tpu_torch.parallel import sharded

    t_phase = time.perf_counter()
    src, dst = bench_stream()
    num_w = STREAM_EDGES // EB
    res = {"mesh": repr(m), "stream": {}}
    launches = {}
    # (a) the triangle stream, both table modes
    for table in SHARDED_TABLES:
        kern = sharded.ShardedTriangleWindowKernel(m, EB, VB,
                                                   k_bucket=KB,
                                                   table=table)
        require((kern.eb, kern.vb, kern.kb, kern.cap)
                == (EB, VB, KB, EB),
                "buckets %s" % ((kern.eb, kern.vb, kern.kb, kern.cap),))
        kern.count_stream(src[:2 * EB], dst[:2 * EB])   # warm-up
        torch.cuda.synchronize()
        ladder = []
        count = kern.count
        kern.count = lambda s, d, **kw: (ladder.append(kw), count(s, d,
                                                               **kw))[1]
        kernels.reset_launches()
        t0 = time.perf_counter()
        got = kern.count_stream(src, dst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches["stream_" + table] = dict(kernels.LAUNCHES)
        require(len(got) == num_w and got == counts,
                "sharded %s stream: counts differ from phase stream's "
                "at windows %s" % (table, [w for w in range(
                    min(len(got), num_w)) if got[w] != counts[w]][:8]))
        require(kernels.LAUNCHES["intersect"] >= num_w,
                "sharded %s stream: %d intersect launches"
                % (table, kernels.LAUNCHES["intersect"]))
        res["stream"][table] = {
            "seconds": wall, "edges_per_s": STREAM_EDGES / wall,
            "ladder_windows": len(ladder),
            "launches": launches["stream_" + table]}
        # a window built to overflow kb=128 goes down the ladder
        cs, cd = clique(CLIQUE, 1000)
        del ladder[:]
        got = kern.count_stream(np.concatenate([src[:EB], cs]),
                                np.concatenate([dst[:EB], cd]))
        require(got == [counts[0], math.comb(CLIQUE, 3)]
                and len(ladder) == 1,
                "sharded %s: the overflow stream gave %s with %d "
                "ladder windows" % (table, got, len(ladder)))
    # (b) the summary engine
    depth = SHARDED_SUMMARY_WINDOWS * EB
    eng = sharded.ShardedSummaryEngine(m, EB, VB, k_bucket=KB)
    eng.process(src[:2 * EB], dst[:2 * EB])          # warm-up
    eng.reset()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out = eng.process(src[:depth], dst[:depth])
    wall = time.perf_counter() - t0
    launches["summary"] = dict(kernels.LAUNCHES)
    require(out == summaries[:SHARDED_SUMMARY_WINDOWS],
            "sharded summary: summaries differ from phase "
            "summary_stream's at windows %s" % [
                w for w in range(len(out)) if out[w] != summaries[w]][:8])
    final = eng.state_dict()
    want = state
    if SHARDED_SUMMARY_WINDOWS < num_w:    # a cut depth: the prefix's
        ref = StreamSummaryEngine(EB, VB)
        ref.process(src[:depth], dst[:depth])
        want = ref.state_dict()
    for key in ("edge_bucket", "vertex_bucket", "windows_done",
                "closed_partial", "wal_offset"):
        require(final[key] == want[key], "sharded summary: state %s "
                "%s != %s" % (key, final[key], want[key]))
    for label, a, b in zip(("deg", "labels", "cover"), final["carry"],
                           want["carry"]):
        require(np.array_equal(a, b), "sharded summary: final carry "
                "%s differs from the single-chip engine's" % label)
    require(kernels.LAUNCHES["cc_fixpoint"] > 0
            and kernels.LAUNCHES["intersect"] > 0,
            "sharded summary: launches %s" % kernels.LAUNCHES)
    res["summary"] = {"windows": len(out), "seconds": wall,
                      "edges_per_s": depth / wall,
                      "cc_rounds_per_window": kernels.LAUNCHES[
                          "cc_fixpoint"] / max(len(out), 1),
                      "launches": launches["summary"]}
    # (c) the window engine
    c = sharded_window_engine(m, src, dst, counts)
    launches["engine"] = c.pop("launches")
    require(launches["engine"]["cell_reduce"] > 0
            and launches["engine"]["cc_fixpoint"] > 0
            and launches["engine"]["intersect"] > 0,
            "sharded engine: launches %s" % launches["engine"])
    res["engine"] = c
    # (d) a state taken half way, through the twin and back
    half = (SHARDED_SUMMARY_WINDOWS // 2) * EB
    first = sharded.ShardedSummaryEngine(m, EB, VB, k_bucket=KB)
    head = first.process(src[:half], dst[:half])
    twin = host_twin.HostSummaryEngine.from_state(first.state_dict())
    back = sharded.ShardedSummaryEngine(m, EB, VB, k_bucket=KB)
    back.load_state_dict(twin.state_dict())
    off = back.resume_offset()
    require(off == half, "resume offset %d, want %d" % (off, half))
    tail = back.process(src[off:depth], dst[off:depth])
    require(head + tail == out, "sharded resume: the resumed stream "
            "differs from the stream that never stopped")
    for label, a, b in zip(("deg", "labels", "cover"),
                           back.state_dict()["carry"], final["carry"]):
        require(np.array_equal(a, b), "sharded resume: final carry %s "
                "differs" % label)
    # (e) the timing turns, with the static single-chip path
    with knob_env(GS_AUTOTUNE=0):
        res["turns"] = sharded_turns(m, src, dst, counts)
    res["launches"] = launches
    totals = {k: sum(l[k] for l in launches.values())
              for k in ("intersect", "cc_fixpoint", "cell_reduce")}
    require(all(totals.values()), "phase sharded: launches %s" % totals)
    res["row_launches"] = totals
    res["seconds"] = time.perf_counter() - t_phase
    res["device"] = card()
    print(card())
    print(json.dumps({"sharded": res}))
    best = {k: max(r["edges_per_s"] for r in v)
            for k, v in res["turns"].items()}
    print("phase sharded: ok  %d windows in both table modes, %d ladder "
          "windows (and the clique's); summaries of %d windows bit-equal; "
          "launches %s; best edges/s single %.1f, sharded %.1f  (%.1f s)"
          % (num_w, res["stream"]["replicated"]["ladder_windows"],
             len(out), totals, best["single"], best["sharded"],
             res["seconds"]))
    return res


MESH_PREFIX = 64                   # driver_mesh (b)-(d): windows of a prefix
MESH_CKPT_CALL = 100               # (c): the call the checkpoint is taken in
MESH_RESUME_TO = 128               # (c): the resumed drivers run to here
MESH_FAULT_FEED = 8                # (d): windows a call
MESH_PROBATION = 16                # (d): GS_TIER_RETRY_WINDOWS
DELTA_FIELDS = ("delta_degrees", "delta_cc", "delta_bipartite")
STATE_KEYS = ("windows_done", "edges_done", "wal_offset", "edge_bucket",
              "vertex_bucket", "closed_partial", "vertex_ids", "degrees",
              "cc", "bip")


def same_deltas(name, want, got) -> None:
    """Every delta field of `got` equal to `want`'s."""
    require(len(want) == len(got), "%s: %d windows, want %d"
            % (name, len(got), len(want)))
    for i, (w, g) in enumerate(zip(want, got)):
        for f in DELTA_FIELDS:
            a, b = getattr(w, f), getattr(g, f)
            require(a is not None and b is not None
                    and all(np.array_equal(x, y) for x, y in zip(a, b)),
                    "%s window %d: %s differs" % (name, i, f))


def same_state(name, want: dict, got: dict) -> None:
    """The carried state and cursors of two driver checkpoints equal
    (either mode: the mesh's "engine" key is built from these)."""
    for k in STATE_KEYS:
        a, b = want[k], got[k]
        require(np.array_equal(a, b) if isinstance(a, np.ndarray)
                else a == b, "%s: state %s differs" % (name, k))


class scan_spans:
    """CUDA events around every call of a mesh driver's sharded scan (its
    dispatches take host stacks, no staging ring), into a
    dispatch_events' spans."""

    def __init__(self, drv, evs):
        self.drv, self.evs, self.saved = drv, evs, None

    def __enter__(self):
        fns = self.drv._sharded_scans
        self.saved = dict(fns)

        def wrap(fn):
            def run(*a):
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*a)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                self.evs.spans.append((start, end))
                return out
            return run

        for k, fn in self.saved.items():
            fns[k] = wrap(fn)
        return self

    def __exit__(self, *exc):
        self.drv._sharded_scans.clear()
        self.drv._sharded_scans.update(self.saved)
        return False


def mesh_turns(m, src, dst, want: list) -> dict:
    """(e): the whole stream in one call on a single-chip scan driver and
    on the mesh driver, in turns single, mesh, mesh, single, each built at
    vb=65536 and warmed: wall, edges/s and the idle share from CUDA events
    around each dispatch (the snapshot and triangle dispatches)."""
    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver

    drivers = {"single": StreamingAnalyticsDriver(
                   window_ms=1, edge_bucket=EB, vertex_bucket=VB),
               "mesh": StreamingAnalyticsDriver(
                   window_ms=1, edge_bucket=EB, vertex_bucket=VB, mesh=m)}
    for d in drivers.values():
        d.run_arrays(src[:2 * EB], dst[:2 * EB])        # warm-up
        d.reset()
    turns = {k: [] for k in drivers}
    for name in ("single", "mesh", "mesh", "single"):
        d = drivers[name]
        d.reset()
        got = []
        stagers = [d._tri_kern()._ring] + (
            [d._ring] if name == "single" else [])
        with dispatch_events(stagers) as evs:
            with scan_spans(d, evs):
                wall = timed(lambda: got.append(d.run_arrays(src, dst)))
        busy = evs.busy_ms()
        same_results("driver_mesh turn " + name, want, got[0])
        turns[name].append({
            "wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "idle_share": 1 - busy / (1e3 * wall),
            "dispatches": len(evs.spans),
            "edges_per_s": STREAM_EDGES / wall, "method": "cuda_events"})
        del got
    no_demotions("driver_mesh turns", *drivers.values())
    return turns


def phase_driver_mesh(m, want: list, counts: list) -> dict:
    """The driver's mesh branch: StreamingAnalyticsDriver(window_ms=1,
    edge_bucket=32768, mesh=m) on the one-rank NCCL group of
    sharded_group(). (a) The 320-window stream fed in DRIVER_FEED calls,
    so the vertex bucket grows 4096 -> 65536 on the mesh (launch counts
    set to 0 just before, read just after): every window equal to phase
    driver's scan run (`want`), its triangles to count_stream's
    (`counts`), rows U (cc_fixpoint) and 1 (intersect) launched and row S
    (window_snapshot) not, no demotion. (b) emit_deltas=True over a
    MESH_PREFIX-window prefix: the deltas equal the single-chip driver's.
    (c) A mesh checkpoint taken inside a call at window 64 resumed by a
    fresh mesh driver and by a single-chip scan driver, and a single-chip
    one resumed onto the mesh: the rest equal, and the final states equal
    to an uninterrupted single-chip run's. (d) A shard_dispatch fault
    demoting sharded -> scan mid-stream (record mesh_shape [1]), the scan
    tier on the card, re-promotion after MESH_PROBATION windows, the
    results equal throughout; a kernel error and a failed collective
    raise unwrapped with no demotion. (e) mesh_turns. Returns the
    launches of (a)."""
    import tempfile

    from gelly_streaming_tpu_torch import StreamingAnalyticsDriver, kernels
    from gelly_streaming_tpu_torch.ops import unionfind
    from gelly_streaming_tpu_torch.parallel import mesh as mesh_mod
    from gelly_streaming_tpu_torch.utils import faults, resilience

    t_phase = time.perf_counter()
    src, dst = bench_stream()
    num_w = STREAM_EDGES // EB

    def on_mesh(**kw):
        return StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB, mesh=m,
                                        **kw)

    def single(**kw):
        return StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB, **kw)

    res = {"mesh": repr(m)}
    warm = on_mesh()
    require(warm.device == m.device and warm.device.type == "cuda"
            and warm.snapshot_tier == "sharded",
            "mesh driver on %s, tier %s" % (warm.device, warm.snapshot_tier))
    warm.run_arrays(src[:2 * EB], dst[:2 * EB])
    torch.cuda.synchronize()
    del warm
    # (a) the main path
    drv = on_mesh()
    vbs, got, at = [], [], 0
    kernels.reset_launches()
    t0 = time.perf_counter()
    for n in DRIVER_FEED:
        got += drv.run_arrays(src[at * EB:(at + n) * EB],
                              dst[at * EB:(at + n) * EB])
        vbs.append(drv.vb)
        at += n
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    require(launches["cc_fixpoint"] > 0 and launches["intersect"] > 0,
            "driver_mesh: rows U and 1 not launched: %s" % launches)
    require(launches["window_snapshot"] == 0,
            "driver_mesh: row S launched %d times on the mesh"
            % launches["window_snapshot"])
    require(vbs[0] < VB and vbs[-1] == VB and len(set(vbs)) >= 3,
            "driver_mesh: vertex buckets %s" % vbs)
    same_results("driver_mesh", want, got)
    require([r.triangles for r in got] == counts,
            "driver_mesh: triangles differ from count_stream's")
    no_demotions("phase driver_mesh (a)", drv)
    res["main"] = {"windows": len(got), "seconds": wall,
                   "edges_per_s": STREAM_EDGES / wall,
                   "vertex_buckets": vbs, "launches": launches,
                   "cc_rounds_per_window": launches["cc_fixpoint"] / num_w}
    del got
    # (b) the deltas over a prefix
    n64 = MESH_PREFIX * EB
    wantd = single(emit_deltas=True).run_arrays(src[:n64], dst[:n64])
    gotd = on_mesh(emit_deltas=True).run_arrays(src[:n64], dst[:n64])
    same_results("driver_mesh deltas", wantd, gotd)
    same_deltas("driver_mesh deltas", wantd, gotd)
    res["deltas_windows"] = len(gotd)
    del wantd, gotd
    # (c) checkpoints across the modes, one taken inside a call
    lo, hi = MESH_PREFIX, MESH_RESUME_TO
    ref = single()
    ref.run_arrays(src[:hi * EB], dst[:hi * EB])
    ref_state = ref.state_dict()
    resumed = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, make in (("mesh", on_mesh), ("single", single)):
            first = make()
            path = os.path.join(tmp, label + ".npz")
            first.enable_auto_checkpoint(path, every_n_windows=MESH_PREFIX)
            first.run_arrays(src[:MESH_CKPT_CALL * EB],
                             dst[:MESH_CKPT_CALL * EB])
            for into, make2 in ((("mesh", on_mesh), ("single", single))
                                if label == "mesh" else
                                (("mesh", on_mesh),)):
                r = make2()
                require(r.try_resume(path), "no %s checkpoint" % label)
                require(r.windows_done == lo, "%s -> %s: resumed at %d"
                        % (label, into, r.windows_done))
                rest = r.run_arrays(src[lo * EB:hi * EB], dst[lo * EB:hi * EB])
                name = "driver_mesh %s checkpoint -> %s" % (label, into)
                same_results(name, want[lo:hi], rest, offset=lo)
                st = r.state_dict()
                same_state(name, ref_state, st)
                require(st["sharded"] == (into == "mesh"),
                        "%s: sharded %s" % (name, st["sharded"]))
                resumed["%s->%s" % (label, into)] = r.windows_done
    res["resumed"] = resumed
    # (d) an injected fault: demotion, probation, re-promotion; device
    # errors raise
    resilience.reset_demotions()
    kernels.reset_launches()
    with knob_env(GS_STAGE_RETRIES=2, GS_STAGE_BACKOFF_S=0.01,
                  GS_TIER_RETRY_WINDOWS=MESH_PROBATION):
        d = on_mesh()
        out, at, live = [], 0, []
        with faults.inject(faults.FaultSpec(site="shard_dispatch",
                                            on_call=2, times=1 << 20,
                                            shard=0)):
            for _ in range(2):
                out += d.run_arrays(src[at * EB:(at + MESH_FAULT_FEED) * EB],
                                    dst[at * EB:(at + MESH_FAULT_FEED) * EB])
                at += MESH_FAULT_FEED
                live.append(d._mesh_live())
        while at < MESH_PREFIX:
            out += d.run_arrays(src[at * EB:(at + MESH_FAULT_FEED) * EB],
                                dst[at * EB:(at + MESH_FAULT_FEED) * EB])
            at += MESH_FAULT_FEED
            live.append(d._mesh_live())
        same_results("driver_mesh demoted", want[:MESH_PREFIX], out)
        log = d.demotion_log()
        require([(e["from"], e["to"]) for e in log]
                == [("sharded", "scan"), ("scan", "sharded")],
                "driver_mesh: demotion log %s" % log)
        require(log[0]["mesh_shape"] == [1] and log[0]["shard_id"] == 0,
                "driver_mesh: demotion record %s" % log[0])
        require(not live[0] and live[-1] and d._mesh_live(),
                "driver_mesh: live per call %s" % live)
        require(kernels.LAUNCHES["window_snapshot"] > 0,
                "driver_mesh: the demoted scan tier did not run on the card")
        res["demotion"] = {"log": log, "live_per_call": live,
                           "launches": dict(kernels.LAUNCHES)}
        resilience.reset_demotions()
        errors = {}
        fix = unionfind.cc_fixpoint

        def kernel_error(*a, **kw):
            raise kernels.KernelError("window_summary: injected launch error")

        real = mesh_mod.dist.all_reduce

        def dead_peer(*a, **kw):
            raise RuntimeError("injected: the peer closed the connection")

        for label, patch, undo in (
                ("kernel", lambda: setattr(unionfind, "cc_fixpoint",
                                           kernel_error),
                 lambda: setattr(unionfind, "cc_fixpoint", fix)),
                ("collective", lambda: setattr(mesh_mod.dist, "all_reduce",
                                               dead_peer),
                 lambda: setattr(mesh_mod.dist, "all_reduce", real))):
            e2 = on_mesh()
            patch()
            try:
                e2.run_arrays(src[:2 * EB], dst[:2 * EB])
                errors[label] = None
            except Exception as e:            # recorded, then required
                errors[label] = type(e).__name__
            finally:
                undo()
            no_demotions("driver_mesh %s error" % label, e2)
        require(errors == {"kernel": "KernelError",
                           "collective": "CollectiveError"},
                "driver_mesh: device errors raised %s" % errors)
        res["device_errors"] = errors
    # (e) the turns
    with knob_env(GS_AUTOTUNE=0):
        res["turns"] = mesh_turns(m, src, dst, want)
    res["seconds"] = time.perf_counter() - t_phase
    res["device"] = card()
    print(card())
    print(json.dumps({"driver_mesh": res}))
    best = {k: max(r["edges_per_s"] for r in v)
            for k, v in res["turns"].items()}
    print("phase driver_mesh: ok  %d windows fed in %d calls at %.1f "
          "edges/s, bit-equal to phase driver; deltas, checkpoints both "
          "ways and a demotion equal; launches U %d, 1 %d, S %d; best "
          "edges/s single %.1f, mesh %.1f  (%.1f s)"
          % (num_w, len(DRIVER_FEED), STREAM_EDGES / wall,
             launches["cc_fixpoint"], launches["intersect"],
             launches["window_snapshot"], best["single"], best["mesh"],
             res["seconds"]))
    return launches


# ----------------------------------------------------------------------
EVIDENCE_WINDOWS = 64                 # phase evidence: the prefix's windows
EVIDENCE_TENANTS = 4                  # (a), (c): cohort tenants served
FOREIGN_CARD = "NVIDIA A100-SXM4-80GB"  # (d): the rows under another name
EVIDENCE_PINS = ("GS_RESIDENT", "GS_COHORT_RESIDENT", "GS_EGRESS",
                 "GS_EGRESS_CAP")


def evidence_choices(dev) -> dict:
    """Every resolver of the measured-adoption routing on `dev`."""
    from gelly_streaming_tpu_torch.core import driver as drv_mod
    from gelly_streaming_tpu_torch.ops import delta_egress, resident_engine
    from gelly_streaming_tpu_torch.ops import triangles as tri
    from gelly_streaming_tpu_torch.ops import windowed_reduce as wr
    from gelly_streaming_tpu_torch.parallel import sharded

    ebs = (8192, EB)
    return {"stream": {eb: tri._resolve_stream_impl(eb, dev) for eb in ebs},
            "ingress": tri.resolve_ingress(None, VB, dev),
            "kb": {eb: tri._tuned_kb(eb, dev) for eb in ebs},
            "chunk": {eb: tri._tuned_chunk(eb, dev) for eb in ebs},
            "resident": resident_engine.resolve_resident(dev),
            "cohort": resident_engine.resolve_resident_cohort(dev),
            "snapshot": drv_mod.resolve_snapshot_tier(dev),
            "egress": delta_egress.resolve_egress(dev),
            "reduce": wr._resolve_reduce_impl("sum", device=dev),
            "table": sharded.resolve_table_mode(dev)}


def evidence_defaults() -> dict:
    """The choices with no evidence: the port's defaults."""
    from gelly_streaming_tpu_torch.ops import triangles as tri

    ebs = (8192, EB)
    return {"stream": dict.fromkeys(ebs, "device"), "ingress": "standard",
            "kb": {eb: tri.default_kb(eb) for eb in ebs},
            "chunk": dict.fromkeys(ebs, CHUNK), "resident": False,
            "cohort": False, "snapshot": "scan", "egress": "full",
            "reduce": "device", "table": "replicated"}


def evidence_expected(sec: dict, label: str) -> dict:
    """What each resolver must choose on the card `label` given the rows
    `sec`, computed here from the rows and the card's gate
    (worst_clears_bar: the alternative's slowest turn against the
    baseline's fastest): per edge bucket the stream tier; the wire, K,
    chunk, resident tiers, egress, the reduce tier of "sum" and the
    table mode."""
    from gelly_streaming_tpu_torch import native
    from gelly_streaming_tpu_torch.ops import triangles as tri
    from gelly_streaming_tpu_torch.utils.evidence import worst_clears_bar

    def tier(rows, native_loads):
        if not rows:
            return "device"
        if worst_clears_bar(rows, "native", ("device", "host"),
                            parity_key="native_parity") and native_loads:
            return "native"
        return "host" if worst_clears_bar(rows, "host", "device") \
            else "device"

    def fastest(eb, sweep, key, default):
        rows = [x for row in sec["window"] if row["edge_bucket"] == eb
                for x in row[sweep]]
        return (min(rows, key=lambda x: x["per_window_ms"])[key] if rows
                else default)

    ebs = (8192, EB)
    res = [r for r in sec["resident_ab"] if r["probe"] == "driver_resident"]
    resident = worst_clears_bar(res, "resident", ("scan", "native"))
    tab = sec["sharded_table"]
    return {
        "stream": {eb: tier([r for r in sec["host_stream"]
                             if r["edge_bucket"] == eb],
                            native.triangles_available()) for eb in ebs},
        "ingress": ("compact" if worst_clears_bar(
            sec["ingress_ab"], "compact", "std") else "standard"),
        "kb": {eb: fastest(eb, "k_sweep", "k_bucket", tri.default_kb(eb))
               for eb in ebs},
        "chunk": {eb: fastest(eb, "chunk_sweep", "windows_per_dispatch",
                              CHUNK) for eb in ebs},
        "resident": resident,
        "cohort": worst_clears_bar(
            [r for r in sec["tenancy_ab"] if r["probe"] == "cohort_resident"],
            "tenant", "sequential"),
        "snapshot": "resident" if resident else "scan",
        "egress": ("delta" if worst_clears_bar(sec["egress_ab"], "delta",
                                               "full") else "full"),
        "reduce": tier([r for r in sec["host_reduce"] if r["name"] == "sum"],
                       native.windowed_reduce_available()),
        "table": ("owner" if tab["backend"] == label
                  and tab["counts_match"] is True
                  and worst_clears_bar(tab["rows"], "owner", "replicated",
                                       parity_key="counts_match")
                  else "replicated")}


def evidence_paths(m, label: str, want: dict, ref: dict = None) -> dict:
    """The paths an unpinned caller drives, on the card over the phase's
    prefix: TriangleWindowKernel(32768, 65536) and (8192, 65536),
    StreamSummaryEngine(32768, 65536), StreamingAnalyticsDriver(
    window_ms=1, edge_bucket=32768), TenantCohort(4096, 8192) over
    EVIDENCE_TENANTS of phase cohort_stream's tenants, WindowedEdgeReduce(
    16384, 8192, "sum") on integer and float values, and the sharded
    kernel (k_bucket=128, no table) on the mesh; each with the launch
    counts set to 0 just before it and read just after, its results held
    to `want` (counts, summaries, windows and cohort rows of the earlier
    phases, the pinned defaults' reduce rows and 8192-edge counts) and,
    given `ref` (what (a) returned), its states to ref's. Returns the
    launches by path, the states and the reduce rows."""
    from gelly_streaming_tpu_torch import (StreamingAnalyticsDriver,
                                           StreamSummaryEngine, TenantCohort,
                                           TriangleWindowKernel,
                                           WindowedEdgeReduce, kernels)
    from gelly_streaming_tpu_torch.parallel.sharded import (
        ShardedTriangleWindowKernel)

    s, d = want["stream"]
    out = {"launches": {}}

    def path(name, run):
        torch.cuda.synchronize()
        kernels.reset_launches()
        got = run()
        torch.cuda.synchronize()
        out["launches"][name] = {k: v for k, v in kernels.LAUNCHES.items()
                                 if v}
        return got

    k = TriangleWindowKernel(EB, VB)
    require(k.device.type == "cuda", "evidence: kernel not on the card")
    require(path("stream", lambda: k.count_stream(s, d)) == want["counts"],
            "evidence: %s count_stream differs" % label)
    s8, d8 = want["stream8"]
    k8 = TriangleWindowKernel(8192, VB)
    require(path("stream8192", lambda: k8.count_stream(s8, d8))
            == want["counts8"], "evidence: %s counts at eb=8192 differ"
            % label)
    eng = StreamSummaryEngine(EB, VB)
    require(path("summary", lambda: eng.process(s, d)) == want["summaries"],
            "evidence: %s summaries differ" % label)
    st = eng.state_dict()
    out["summary_state"] = (st["windows_done"],
                            [np.asarray(x) for x in st["carry"]])
    drv = StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB)
    same_results("evidence %s driver" % label, want["windows"],
                 path("driver", lambda: drv.run_arrays(s, d)))
    no_demotions("evidence %s" % label, drv)
    ds = drv.state_dict()
    out["driver_state"] = {key: v for key, v in ds.items()
                           if isinstance(v, np.ndarray)
                           or key in ("windows_done", "edges_done")}
    co = TenantCohort(CO_EB, CO_VB)
    rows, _co, _secs = path("cohort", lambda: serve_cohort(
        want["tenants"], co=co))
    same_windows("evidence %s cohort" % label, rows, want["cohort"])
    out["cohort_state"] = cohort_states(co, list(want["tenants"]))
    rs, rd, rv = want["reduce_stream"]
    red = WindowedEdgeReduce(RED_VB, RED_EB, "sum")
    out["reduce"] = path("reduce", lambda: red.process_stream(rs, rd, rv))
    out["reduce_float"] = red.process_stream(rs, rd, rv.astype(np.float32)
                                             / 4)
    sk = ShardedTriangleWindowKernel(m, EB, VB, k_bucket=KB)
    require(path("sharded", lambda: sk.count_stream(s, d))
            == want["counts"], "evidence: %s sharded counts differ" % label)
    if ref is not None:
        w0, carry0 = ref["summary_state"]
        w1, carry1 = out["summary_state"]
        require(w0 == w1 and all(np.array_equal(a, b) for a, b in
                                 zip(carry0, carry1)),
                "evidence: %s summary state differs" % label)
        for key, v in ref["driver_state"].items():
            got = out["driver_state"][key]
            require(np.array_equal(got, v) if isinstance(v, np.ndarray)
                     else got == v, "evidence: %s driver %s differs"
                     % (label, key))
        # the cover's sentinel slot records the slab shapes, which the
        # cohort's tier decides
        same_states("evidence %s cohort" % label, out["cohort_state"],
                    ref["cohort_state"], sentinel=False)
    return out


def same_reduce_rows(label: str, got, want, vals=None, src=None) -> None:
    """(cells, counts) rows equal: counts exactly; cells where counted,
    exactly, or, given the values, within 1e-5 · Σ|v| of the cell (row
    R's bound for float sums), the cell's Σ|v| from `src`."""
    require(len(got) == len(want), "%s: %d rows, want %d"
            % (label, len(got), len(want)))
    for w, ((c1, n1), (c2, n2)) in enumerate(zip(got, want)):
        require(np.array_equal(np.asarray(n1, np.int64),
                               np.asarray(n2, np.int64)),
                "%s window %d: counts differ" % (label, w))
        on = np.asarray(n2) > 0
        a = np.asarray(c1, np.float64)[on]
        b = np.asarray(c2, np.float64)[on]
        if vals is None:
            require(np.array_equal(a, b), "%s window %d: cells differ"
                    % (label, w))
        else:
            lo, hi = w * RED_EB, (w + 1) * RED_EB
            tol = np.bincount(src[lo:hi], weights=np.abs(
                vals[lo:hi].astype(np.float64)),
                minlength=len(on))[:len(on)][on]
            require(bool(np.all(np.abs(a - b) <= 1e-5 * tol + 1e-30)),
                    "%s window %d: a float sum past 1e-5 Σ|v|" % (label, w))


def phase_evidence(m, counts: list, summaries: list, driver_got: list,
                   co_streams: dict, co_out: dict) -> dict:
    """The measured-adoption routing (gelly_streaming_tpu_torch/utils/
    evidence.py and its resolvers) on the card, with the evidence path
    pointed at a temporary directory and the routing knobs unset:
    (a) no evidence file: every resolver returns its default and the
    unpinned paths of evidence_paths run on the card, each with its
    kernels launched, equal to the earlier phases over the first
    EVIDENCE_WINDOWS windows; (b) utils/evidence_ab.py writes every
    section's rows there over that prefix at full width, printed with
    the card's name and power limit; (c) each resolver's choice equals
    the one computed here from the rows with the card's gate
    (worst_clears_bar), every routed path is equal to its pinned default
    on the same prefix (counts, summaries, windows, cohort rows, states;
    the reduce's integer rows exactly, its float sums within
    1e-5 · Σ|v|) and launches kernels unless a host or native tier was
    adopted for it; (d) the same rows filed under another device's name
    route nothing."""
    import tempfile

    from gelly_streaming_tpu_torch import (TriangleWindowKernel,
                                           WindowedEdgeReduce, make_stream)
    from gelly_streaming_tpu_torch.ops import triangles as tri
    from gelly_streaming_tpu_torch.utils import evidence, evidence_ab

    dev = m.device
    label = torch.cuda.get_device_name(dev)
    W = EVIDENCE_WINDOWS
    src, dst = bench_stream()
    s8, d8 = make_stream(W * 8192, VB, seed=SEED)
    s8, d8 = s8.astype(np.int32), d8.astype(np.int32)
    counts8 = TriangleWindowKernel(8192, VB, k_bucket=tri.default_kb(8192),
                                   ingress="standard",
                                   stream_tier="device").count_stream(s8, d8)
    rs, rd = make_stream(W * RED_EB, RED_VB)
    rv = red_values(rs, rd)
    plain = WindowedEdgeReduce(RED_VB, RED_EB, "sum", tier="device",
                               ingress="standard", egress="full")
    tenants = dict(list(co_streams.items())[:EVIDENCE_TENANTS])
    want = {"stream": (src[:W * EB], dst[:W * EB]),
            "counts": counts[:W], "summaries": summaries[:W],
            "windows": driver_got[:W], "stream8": (s8, d8),
            "counts8": counts8, "tenants": tenants,
            "cohort": {t: co_out[t] for t in tenants},
            "reduce_stream": (rs, rd, rv)}
    want_rows = plain.process_stream(rs, rd, rv)
    want_float = plain.process_stream(rs, rd, rv.astype(np.float32) / 4)
    tmp = tempfile.mkdtemp(prefix="gs_evidence_")
    path = os.path.join(tmp, "PERF_torch.json")
    saved_path = evidence.PERF_PATH
    saved_pins = {k: os.environ.pop(k) for k in EVIDENCE_PINS
                  if k in os.environ}
    evidence.PERF_PATH = path
    evidence.forget()
    t_phase = time.perf_counter()
    try:
        # (a) no evidence file
        got = evidence_choices(dev)
        require(got == evidence_defaults(), "evidence (a): a resolver "
                "left its default with no file: %s" % got)
        t0 = time.perf_counter()
        base = evidence_paths(m, "(a)", want)
        for name, kern in (("stream", "window_counter"),
                           ("stream8192", "window_counter"),
                           ("summary", "window_summary"),
                           ("driver", "window_snapshot"),
                           ("cohort", "cohort_summary"),
                           ("reduce", "cell_reduce"),
                           ("sharded", "intersect")):
            require(base["launches"][name].get(kern, 0) > 0,
                    "evidence (a): %s launched no %s" % (name, kern))
        same_reduce_rows("evidence (a) reduce", base["reduce"], want_rows)
        same_reduce_rows("evidence (a) reduce float", base["reduce_float"],
                         want_float, rv.astype(np.float32) / 4, rs)
        print("evidence (a): defaults with no file, paths %.2f s, "
              "launches %s" % (time.perf_counter() - t0,
                               json.dumps(base["launches"])))

        # (b) the rows, measured here
        t0 = time.perf_counter()
        w = evidence_ab.run(path, device=dev, windows=W, mesh=m, log=print)
        t_rows = time.perf_counter() - t0
        require(w.label == label, "evidence (b): label %s" % w.label)
        print(card())
        print(json.dumps({"evidence_rows": {"device": label,
                                            "windows": W,
                                            "seconds": w.seconds,
                                            "sections": w.sections}},
                         separators=(",", ":")))

        # (c) route on them
        evidence.forget()
        expect = evidence_expected(w.sections, label)
        got = evidence_choices(dev)
        require(got == expect, "evidence (c): the resolvers chose %s, the "
                "rows say %s" % (got, expect))
        adopted = sorted(k for k in got if got[k] != evidence_defaults()[k])
        t0 = time.perf_counter()
        routed = evidence_paths(m, "(c)", want, ref=base)
        # a routed path launches kernels unless a host or native tier was
        # adopted for it; the kernels (a) launched that (c) did not
        off_card = {"stream": got["stream"][EB],
                    "stream8192": got["stream"][8192],
                    "reduce": got["reduce"]}
        for name, launched in routed["launches"].items():
            require(bool(launched) or off_card.get(name) in ("host",
                                                             "native"),
                    "evidence (c): path %s launched no kernel" % name)
        removed = {name: sorted(k for k, n in ran.items()
                                if n and not routed["launches"][name].get(k))
                   for name, ran in base["launches"].items()}
        print("evidence (c): kernels launched in (a) and not in (c): %s"
              % json.dumps({k: v for k, v in removed.items() if v}))
        same_reduce_rows("evidence (c) reduce", routed["reduce"], want_rows)
        same_reduce_rows("evidence (c) reduce float",
                         routed["reduce_float"], want_float,
                         rv.astype(np.float32) / 4, rs)
        print("evidence (c): choices %s, adopted %s, paths %.2f s, "
              "launches %s" % (json.dumps(got, sort_keys=True), adopted,
                               time.perf_counter() - t0,
                               json.dumps(routed["launches"])))

        # (d) another device's name
        evidence_ab.write(path, FOREIGN_CARD, w.sections)
        with open(path) as f:
            filed = json.load(f)["devices"]
        filed.pop(label)
        with open(path, "w") as f:
            json.dump({"devices": filed}, f)
        evidence.forget()
        require(evidence_choices(dev) == evidence_defaults(),
                "evidence (d): rows of %s routed %s" % (FOREIGN_CARD, label))
        seconds = time.perf_counter() - t_phase
        print("evidence: (a)-(d) ok in %.1f s (rows %.1f s)"
              % (seconds, t_rows))
    finally:
        evidence.PERF_PATH = saved_path
        evidence.forget()
        os.environ.update(saved_pins)
        shutil.rmtree(tmp, ignore_errors=True)
    return {"adopted": adopted, "seconds": seconds,
            "launches_a": base["launches"], "launches_c": routed["launches"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:] == [CAPTURE_FLAG]:
        return cell_reduce_capture_child()
    import tempfile

    from gelly_streaming_tpu_torch.utils import evidence

    # the tuners' cache in a fresh directory: one run never seeds another
    with tempfile.TemporaryDirectory() as cache:
        os.environ["GS_TUNE_CACHE"] = cache
        # every phase drives the default paths: an evidence file in the
        # checkout would reroute each unpinned engine (phase evidence
        # writes and reads rows of its own)
        if os.path.exists(evidence.PERF_PATH):
            print("chip_smoke: WARNING: %s is ignored: the phases measure "
                  "the default paths" % evidence.PERF_PATH)
        evidence.PERF_PATH = os.path.join(cache, "PERF_torch.json")
        evidence.forget()
        return run_phases()


class Laps:
    """lap(name) records the host seconds since the previous lap (the
    first: since the laps began) under `name`, in `seconds`."""

    def __init__(self):
        self.seconds = {}
        self._mark = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = round(now - self._mark, 2)
        self._mark = now


def run_phases() -> int:
    from gelly_streaming_tpu_torch import kernels

    dev = torch.device("cuda", torch.cuda.current_device())
    print(card())
    t_run = t0 = time.perf_counter()
    lap = Laps()
    logs = kernels.build()
    print("build: %.1f s  (%s)" % (time.perf_counter() - t0,
                                   ", ".join(sorted(kernels.SIGNATURES))))
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas %s: %s" % (name, line.strip()))
    # phase cell_reduce's profile, in a process of its own, meanwhile
    start_cell_reduce_capture()
    from gelly_streaming_tpu_torch import native

    t0 = time.perf_counter()
    require(native.available(), "native library: %s" % native.build_error())
    print("native build: %.1f s  (%s)" % (time.perf_counter() - t0,
                                         native.library_path().name))
    for name in ("gnn_round", "dense_triangles"):
        print("sass %s: %s" % (name, json.dumps(tensor_core_ops(
            kernels.library_path(name)))))
    lap("build")

    # the phases of PRs 1-11 run the static configuration, so their
    # numbers stay comparable; the new ones set the tuner themselves
    os.environ["GS_AUTOTUNE"] = "0"
    print("phases intersect .. driver_slide: GS_AUTOTUNE=0 (the static "
          "configuration); autotune, resident, gnn_resident and "
          "driver_resident set it themselves")
    capture = device_trace_capture(dev)
    lap("device_trace")
    rng = np.random.default_rng(SEED)
    inter = phase_intersect(dev, rng)
    lap("intersect")
    counter = phase_counter(dev)
    lap("counter")
    summary = phase_summary(dev)
    lap("summary")
    gnn = phase_gnn(dev)
    lap("gnn")
    cohort = phase_cohort(dev)
    lap("cohort")
    compact = phase_compact(dev)
    lap("compact")
    snapshot = phase_snapshot(dev)
    lap("snapshot")
    cells = phase_cell_reduce(dev)
    lap("cell_reduce")
    launches, counts = phase_stream(dev)
    lap("stream")
    no_demotions("phase stream")
    compact_launches = phase_stream_compact(dev, counts)
    lap("stream_compact")
    no_demotions("phase stream_compact")
    summary_launches, summaries, state = phase_summary_stream(dev)
    lap("summary_stream")
    no_demotions("phase summary_stream")
    summary_compact_launches = phase_summary_stream_compact(dev, summaries,
                                                            state)
    lap("summary_stream_compact")
    no_demotions("phase summary_stream_compact")
    gnn_launches, gnn_out, gnn_slab, gnn_scan = phase_gnn_stream(dev)
    lap("gnn_stream")
    no_demotions("phase gnn_stream")
    dense, dense_launches, sparse_launches = phase_dense(dev)
    lap("dense")
    no_demotions("phase dense")
    cohort_launches, co_streams, co_out, co_rate = phase_cohort_stream(dev)
    lap("cohort_stream")
    no_demotions("phase cohort_stream")
    phase_cohort_resident(dev, co_streams, co_out)
    lap("cohort_resident")
    no_demotions("phase cohort_resident")
    _gnn_launches, gnn_co_out = phase_gnn_cohort(dev)
    lap("gnn_cohort")
    no_demotions("phase gnn_cohort")
    driver_launches, driver_got, driver_scan = phase_driver(dev, counts)
    lap("driver")
    no_demotions("phase driver")
    phase_driver_file(dev)
    lap("driver_file")
    no_demotions("phase driver_file")
    reduce_launches = phase_reduce_stream(dev)
    lap("reduce_stream")
    no_demotions("phase reduce_stream")
    api_launches = phase_api(dev)
    lap("api")
    no_demotions("phase api")
    require(api_launches["cell_reduce"] > 0, "api: no cell_reduce launch")
    union_find = phase_models(dev)
    lap("models")
    no_demotions("phase models")
    phase_driver_slide(dev)
    lap("driver_slide")
    no_demotions("phase driver_slide")
    phase_autotune(dev, counts, summaries, state)
    lap("autotune")
    no_demotions("phase autotune")
    phase_resident(dev, summaries, state)
    lap("resident")
    no_demotions("phase resident")
    phase_gnn_resident(dev, gnn_out, gnn_slab)
    lap("gnn_resident")
    no_demotions("phase gnn_resident")
    phase_driver_resident(dev, driver_got)
    lap("driver_resident")
    no_demotions("phase driver_resident")
    hooks = phase_hooks_engine(dev, counts, summaries, state, gnn_out)
    lap("hooks_engine")
    no_demotions("phase hooks_engine")
    phase_costmodel_health(dev, hooks["engines"], {
        "window_counter": counter,
        "window_counter_compact": compact["counter"],
        "window_summary": summary,
        "window_summary_compact": compact["summary"],
        "gnn_round": gnn})
    lap("costmodel_health")
    no_demotions("phase costmodel_health")
    del hooks
    phase_hooks_driver(dev, driver_got, snapshot)
    lap("hooks_driver")
    phase_demotion(dev, driver_got)
    lap("demotion")
    # the scan form and static batches, as in the runs before the
    # resident tier and the tuner's arm, so their numbers compare
    with knob_env(GS_AUTOTUNE=0, GS_COHORT_RESIDENT="off"):
        phase_hooks_cohort(dev, co_streams, co_out, gnn_co_out, cohort)
        lap("hooks_cohort")
        no_demotions("phase hooks_cohort")
        phase_serve(dev, co_streams, co_out, co_rate)
        lap("serve")
        no_demotions("phase serve")
    phase_api_tracing(dev, api_launches, driver_got, capture)
    lap("api_tracing")
    no_demotions("phase api_tracing")
    import torch.distributed as dist

    m = sharded_group()
    try:
        shard = phase_sharded(m, counts, summaries, state)
        lap("sharded")
        no_demotions("phase sharded")
        mesh_launches = phase_driver_mesh(m, driver_got, counts)
        lap("driver_mesh")
        no_demotions("phase driver_mesh")
        phase_evidence(m, counts, summaries, driver_got, co_streams, co_out)
        lap("evidence")
        no_demotions("phase evidence")
    finally:
        dist.destroy_process_group()

    rows = []
    pw = "gelly_streaming_tpu/ops/pallas_window.py:"
    for name, source, replaces, res, n in (
            ("intersect", "intersect",
             "gelly_streaming_tpu/ops/pallas_intersect.py:118", inter,
             sparse_launches["intersect"]),
            ("window_counter", "window_counter", pw + "748", counter,
             launches["window_counter"]),
            ("window_counter_compact", "window_counter", pw + "748",
             compact["counter"], compact_launches["window_counter_compact"]),
            ("window_summary", "window_summary", pw + "504", summary,
             summary_launches["window_summary"]),
            ("window_summary_compact", "window_summary", pw + "548",
             compact["summary"],
             summary_compact_launches["window_summary_compact"]),
            ("cohort_summary", "cohort_summary", pw + "640", cohort,
             cohort_launches["cohort_summary"]),
            ("gnn_round", "gnn_round", pw + "1099", gnn,
             gnn_launches["gnn_round"]),
            ("dense_triangles", "dense_triangles",
             "gelly_streaming_tpu/ops/pallas_triangles.py:58", dense,
             dense_launches["dense_triangles"]),
            # no Pallas counterpart: the JAX driver's XLA lax.scan
            ("window_snapshot", "window_snapshot",
             "gelly_streaming_tpu/core/driver.py:91", snapshot,
             driver_launches["window_snapshot"]),
            # no Pallas counterpart: the JAX package's XLA segment programs
            ("cell_reduce", "cell_reduce",
             "gelly_streaming_tpu/ops/windowed_reduce.py:317", cells,
             reduce_launches["cell_reduce"]),
            # no Pallas counterpart: the JAX package's XLA while_loop
            ("cc_fixpoint", "window_summary",
             "gelly_streaming_tpu/ops/unionfind.py:47", union_find,
             union_find["launches"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/%s.cu" % source,
            "replaces": replaces, "launches": n,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms")})
        if name in shard["row_launches"]:   # phase sharded's, rows 1, U, R
            rows[-1]["sharded_launches"] = shard["row_launches"][name]
        if name in ("intersect", "cc_fixpoint"):   # phase driver_mesh's (a)
            rows[-1]["mesh_driver_launches"] = mesh_launches[name]
        if name == "cell_reduce":   # the north-star chunk beside the main
            big = res["big"]
            rows[-1].update(
                share_of_bound=res["share_of_bound"], big_ms=big["ms"],
                big_bound_ms=big["bound_ms"],
                big_share_of_bound=big["share_of_bound"],
                big_library_ms=big["library_ms"],
                big_plain_ms=big["plain_ms"], hub_chunk_ms=res["hub_ms"])
    print(json.dumps({"phase_seconds": lap.seconds}))
    print("chip_smoke: every phase ok in %.1f s"
          % (time.perf_counter() - t_run))
    print(card())
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print("chip_smoke: FAIL: %s" % e, file=sys.stderr)
        sys.exit(1)
