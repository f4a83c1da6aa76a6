#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gelly_streaming_tpu_torch) on one
NVIDIA GPU.

Builds the CUDA kernels from gelly_streaming_tpu_torch/csrc and the
native host runtime (gelly_streaming_tpu_torch/native, g++) and runs
twenty phases. Eight hold a kernel against its plain PyTorch version on
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
kernel in both tiers, each analytics subset, full rows with and without
masks and the delta wire, a window of one edge, empty windows,
self-loops) and cell_reduce (the windowed reduce's cell-reduce kernel:
sum/min/max × out/in/all × int32/float32 on both wires, full rows and
the delta wire, at [64, 8192] vb=16384 and [64, 32768] vb=65536, edge
cases, cohort_step of 64 rows). Twelve drive the port's paths, each
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
vb=65536, about 8.3M edges (phase cohort_stream); and
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
of triangle_count, and get_degrees(). Each path reports its rate, its
launches and
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

import json
import math
import os
import re
import shutil
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
# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W
# limit): HBM bytes/s, and the float32 rate outside the tensor cores,
# taken as the rate of 32-bit scalar operations (compares, adds); the
# dense tensor-core rates at fp16 (exact for the GNN lattice's products)
# and at int8 (exact for 0/1 adjacency products).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12
PEAK_FP16_TC_S = 989e12
PEAK_INT8_TC_S = 1979e12
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


def device_ms(fn, reps: int) -> float:
    """Mean device time of fn() over `reps` runs after one warm-up: the
    sum of its device rows under torch.profiler over the runs, so the
    host's launch gaps between short kernels are not counted."""
    from gelly_streaming_tpu_torch.utils.profiling import device_times

    fn()
    _wall, by_name = device_times(lambda: [fn() for _ in range(reps)])
    require(by_name, "no device rows in a profile of %d calls" % reps)
    return sum(ms for ms, _n in by_name.values()) / reps


def bound(nbytes: float, ops: float, ops_rate: float = PEAK_OPS_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over `ops_rate` (default the scalar rate)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / ops_rate
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


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
    nbytes = CHUNK * EB * 9 + CHUNK * 8     # the slab in, two ints out
    b_ms, b_by = bound(nbytes, CHUNK * EB + steps)
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
                                           kernels, make_stream)
    from gelly_streaming_tpu_torch.ops import host_triangles
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc

    src, dst = make_stream(STREAM_EDGES, VB, seed=SEED)
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
                                           kernels, make_stream)

    src, dst = make_stream(STREAM_EDGES, VB, seed=SEED)
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
    b_ms, b_by = bound(*summary_work(CHUNK * EB * 9, CHUNK * EB, slots, 1,
                                     CHUNK, VB, compares))
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


def summary_work(slab_bytes: int, total_slots: int, slots: int,
                 rows: int, windows: int, vb: int, compares: int) -> tuple:
    """(bytes, operations) a summary call needs, its triangle stage
    included, over `rows` carry rows of `windows` windows each: the slab
    read once, each carry row (16(vb+1) bytes) read and written once, 20
    bytes out per window; per valid slot 2 degree adds and 3 unions; per
    carry slot one pass of 3 root walks in the whole call (the
    summaries are read incrementally, so no pass per window); the
    triangle stage's one operation per slot and its row compares."""
    nbytes = slab_bytes + rows * (2 * 16 * (vb + 1) + 20 * windows)
    ops = 5 * slots + 3 * rows * (vb + 1) + total_slots + compares
    return nbytes, ops


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
                                           kernels, make_stream)
    from gelly_streaming_tpu_torch.ops import host_summary, host_triangles
    from gelly_streaming_tpu_torch.ops import scan_analytics as sa
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_summary as ws

    src, dst = make_stream(STREAM_EDGES, VB, seed=SEED)
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
                                           kernels, make_stream)

    src, dst = make_stream(STREAM_EDGES, VB, seed=SEED)
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
    slab = CHUNK * EB * 4 + CHUNK * 4     # JAX slab_bytes: eb·4 + 4 a window
    counter_bound = bound(slab + CHUNK * 8, CHUNK * EB + compares)
    summary_bound = bound(*summary_work(slab, CHUNK * EB, slots, 1, CHUNK,
                                        VB, compares))
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
    nbytes = CHUNK * 9 * EB + 2 * 4 * (VB + 1) * F + 4 * F * (F + 1) \
        + 16 * CHUNK
    ops = CHUNK * 2 * (VB + 1) * F * F
    b_ms, b_by = bound(nbytes, ops, PEAK_FP16_TC_S)
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
        PEAK_FP16_TC_S)[0]
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
                                           forced_sync, kernels, make_stream)
    from gelly_streaming_tpu_torch.ops import gnn_round as gr
    from gelly_streaming_tpu_torch.ops import gnn_window as gw

    src, dst = make_stream(STREAM_EDGES, VB, seed=SEED)
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
    return launches


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
                           PEAK_INT8_TC_S)
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
        b_ms, b_by = bound(*summary_work(nb * wb * eb * 9, nb * wb * eb,
                                         slots, nb, wb, vb, compares))
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


def serve_cohort(streams: dict, demote: str = None):
    """Drive a TenantCohort(CO_EB, CO_VB) on the card as a server would:
    admit every tenant at its vertex bucket; then, until every stream is
    in, feed each tenant CO_FEED edges at a time until its queue pushes
    back (TenantBackpressure) and pump(); `demote` goes to its own engine
    after the second pump; every tenant is closed at the end. Returns
    (summaries per tenant, the cohort, host-clock seconds by stage)."""
    from gelly_streaming_tpu_torch import TenantBackpressure, TenantCohort

    co = TenantCohort(CO_EB, CO_VB)            # device=None: the card
    for tid, (_s, _d, vb) in streams.items():
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
    56 equal the numpy summary oracle; the cohort kernel was launched."""
    from gelly_streaming_tpu_torch import StreamSummaryEngine, kernels
    from gelly_streaming_tpu_torch.ops import host_summary

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
    return launches


def phase_gnn_cohort(dev) -> dict:
    """The GNN cohort: GnnTenantCohort(4096, 8192, feature_dim=64) over
    64 tenants of 16 windows (two pumps of 8 windows each), each tenant
    from default_features(8192, 64, seed=i), with the fixed snapped
    weights of phase gnn_stream. Every tenant's summaries and final slab
    equal a GnnSummaryEngine's on the card over the same stream; the GNN
    kernel was launched."""
    from gelly_streaming_tpu_torch import (GnnSummaryEngine, GnnTenantCohort,
                                           kernels, make_stream)
    from gelly_streaming_tpu_torch.ops import gnn_window as gw

    W, b = gnn_weights(GNN_F, -12, -3)
    streams = {"g%02d" % i: make_stream(GNN_CO_WINDOWS * CO_EB, CO_VB,
                                        seed=300 + i)
               for i in range(CO_TENANTS)}
    slabs = [gw.default_features(CO_VB, GNN_F, seed=i)
             for i in range(CO_TENANTS)]
    total = GNN_CO_WINDOWS * CO_EB * CO_TENANTS

    def serve():
        """Admit the tenants with their slabs, then two rounds of feeds
        of 8 windows and a pump; returns (summaries, the cohort, the
        seconds of the feed and pump rounds)."""
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
    return launches


SNAP_SMALL_VB = 8192               # the snapshot's shared-memory tier
SNAP_WINDOWS = 16                  # windows of the snapshot phase's fixtures
FILE_EDGES = 1_048_576             # phase driver_file's timestamped file
FILE_WINDOW = 8192                 # its mean window, in edges
FILE_CHUNK_BYTES = 128 << 10       # stream_file's piece: about a window
# the driver phase's count-based feed: calls of 1, 1, 2, ..., 64 windows
DRIVER_FEED = (1, 1, 2, 4, 8, 16, 32, 64, 64, 64, 64)
# a delta cap below the changed slots of the stream's windows: its chunks
# overflow and are run again on full rows
DRIVER_SMALL_CAP = 1024


def snapshot_fixtures():
    """(name, vb, analytics, [W, eb] chunk, prefix chunk) of the snapshot
    phase: Zipf windows at vb=65536 (the L2 tier) and at vb=8192 (the
    shared-memory tier), each analytics subset; edge cases at vb=8192: a
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


def phase_snapshot(dev) -> dict:
    """The snapshot kernel (csrc/window_snapshot.cu) vs its plain version
    on every fixture of snapshot_fixtures(), each from a carry that is
    not fresh (a prefix chunk folded first), in both tiers, on the full
    rows with masks and without, and on the delta wire at the default
    cap and at a cap of 64 that windows overflow; then times at the main
    path's chunk (64 Zipf windows at eb=32768, vb=65536, all three
    analytics, full rows: the driver's default), the delta wire, and one
    window beside the counter at one window."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import delta_egress
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc
    from gelly_streaming_tpu_torch.ops import window_snapshot as ws

    tiers = set()
    err = 0
    for name, vb, analytics, chunk, prefix in snapshot_fixtures():
        cap = delta_egress.egress_cap(EB, vb)
        forms = [(False, "full", 0), (True, "full", 0), (False, "delta", cap)]
        if analytics == ("degrees", "cc", "bipartite"):
            forms += [(True, "delta", 64)]
        for deltas, egress, c in forms:
            snap = ws.WindowSnapshot(vb, analytics, dev, deltas=deltas,
                                     egress=egress, cap=c)
            carry = snapshot_carry(vb, analytics, dev)
            plain_carry = snapshot_carry(vb, analytics, dev)

            def plain_on_card(pc, s, d, v, vb=vb, deltas=deltas,
                              egress=egress, c=c):
                return ws.snapshot_windows_plain(pc, s, d, v, vb, deltas,
                                                 egress, c)

            label = "%s %s%s" % (name, egress, "+masks" if deltas else "")
            _want, e1 = compare_snapshot(label + " prefix", snap,
                                         plain_on_card, prefix, carry,
                                         plain_carry, dev)
            want, e2 = compare_snapshot(label, snap, plain_on_card, chunk,
                                        carry, plain_carry, dev)
            err = max(err, e1, e2)
            if egress == "delta" and c == 64:
                require(max(int(want[k].max()) for k in want
                            if k.endswith("_cnt")) > 64,
                        "%s: no window passed the cap" % label)
        tiers.add(summary_tier(vb, dev))
        print("phase snapshot %s: ok" % name)
    require(tiers == {"shared", "L2"}, "snapshot tiers %s" % tiers)

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
    print("phase snapshot: ok  kernel %.3f ms/chunk (%s tier; delta wire "
          "%.3f; one window %.4f, the counter at one window %.4f; carry "
          "clone %.3f)  plain %.1f ms/chunk  bound %.4f (%s)  (%d windows, "
          "%d valid slots)  max |kernel - plain| %d"
          % (ms, summary_tier(VB, dev), delta_ms, w1_ms, counter_w1_ms,
             clone_ms, plain_ms, b_ms, b_by, CHUNK, slots, err))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "delta_ms": delta_ms,
            "w1_ms": w1_ms, "counter_w1_ms": counter_w1_ms}


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

    from gelly_streaming_tpu_torch import (StreamingAnalyticsDriver,
                                           kernels, make_stream)

    src, dst = make_stream(STREAM_EDGES, VB, seed=SEED)
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
    return launches


def phase_driver_file(dev) -> None:
    """stream_file over a timestamped 'src dst ts' text file written to a
    temporary directory (FILE_EDGES Zipf edges, event-time windows of
    about FILE_WINDOW edges, pieces of FILE_CHUNK_BYTES), the vertex
    bucket growing past the snapshot's shared-memory tier on the way;
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
    both wires, full rows and the delta wire, at [64, 8192] vb=16384 (one
    block a window's row in shared memory) and [64, 32768] vb=65536 (a
    cluster of blocks a row); the edge-case windows; cohort_step of 64
    rows. Then times at the main path's chunk beside the plain version
    and the library calls (index_add_ for cells and counts): device
    time under the profiler, and each call's time by CUDA events."""
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
        plans[vb] = cr.plan(wb, vbp, dev)
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
        print("phase cell_reduce %d/%d: ok  (cluster %d, span %d, "
              "passes %d)" % (eb, vb, plans[vb]["cluster"],
                              plans[vb]["span"], plans[vb]["passes"]))

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
    eb, vb, wb = RED_EB, CELL_PASSES_VB, 2
    vbp = vb + 1
    plans[vb] = cr.plan(wb, vbp, dev)
    require(plans[vb]["passes"] > 1, "multi-pass plan %s" % plans[vb])
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
    # a window all on one hub vertex (the atomics serialise), one chunk
    hub = np.full(CHUNK * RED_EB, 4242, np.int64)
    ht = cell_wire(hub, hub, np.ones(len(hub), np.int32), RED_EB, RED_VB,
                   "out", "standard", dev)
    hub_ms = device_ms(lambda: reduce_call("standard", ht, CHUNK, RED_EB,
                                           RED_VB + 1, "sum", "out"), 50)
    main = res["main"]
    print(json.dumps({"cell_reduce": {
        "checked_calls": checked, "max_abs_err": err, "plans": plans,
        "times": res, "hub_chunk_ms": hub_ms,
        "device": torch.cuda.get_device_name(0)}}))
    print("phase cell_reduce: ok  kernel %.4f ms/chunk on the device "
          "(call %.4f; delta %.4f, compact %.4f)  library %.4f (call "
          "%.4f)  plain %.3f  bound %.4f (%s); vb=65536 all %.4f (library "
          "%.4f); hub chunk %.4f  (%d calls checked, max float |kernel - "
          "plain| %g)"
          % (main["ms"], main["call_ms"], main["delta_ms"],
             main["compact_ms"], main["library_ms"],
             main["library_call_ms"], main["plain_ms"], main["bound_ms"],
             main["bound_by"], res["big"]["ms"], res["big"]["library_ms"],
             hub_ms, checked, err))
    return dict(main, max_abs_err=err, big=res["big"], hub_ms=hub_ms)


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
    bsrc, bdst = make_stream(STREAM_EDGES, VB, seed=SEED)
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
    host and Torch* UDFs; API_EDGES timestamped edges (API_EDGES_PER_MS
    edges a ms) through slice(512 ms, ALL).reduce_on_edges(
    TorchEdgesReduce(name="sum")), every window equal to numpy, launch
    counts set to 0 just before and read just after; WindowTriangleCount
    over the same graph at API_TRI_MS, both routes of triangle_count
    taken, every window equal to ops/host_triangles; get_degrees() equal
    to a numpy running degree."""
    import gelly_streaming_tpu_torch as P
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.models.triangles import \
        WindowTriangleCount
    from gelly_streaming_tpu_torch.ops import host_triangles

    t0 = time.perf_counter()
    api_goldens(dev)
    golden_s = time.perf_counter() - t0
    src, dst = P.make_stream(API_EDGES, VB, seed=SEED)
    ts = np.arange(API_EDGES) // API_EDGES_PER_MS
    weight = 1 + (src + 3 * dst) % 97
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
    records = env._results[out.node.id]
    n_win = -(-API_EDGES // (API_WINDOW_MS * API_EDGES_PER_MS))
    require(launches["cell_reduce"] == n_win,
            "api: %d cell_reduce launches for %d windows"
            % (launches["cell_reduce"], n_win))
    win = ts // API_WINDOW_MS
    got = {}
    for (vid, value), wmax in records:
        got.setdefault(wmax, []).append((vid, value))
    require(len(got) == n_win, "api: %d windows" % len(got))
    for w in range(n_win):
        m = win == w
        ids = np.concatenate([src[m], dst[m]])
        sums = np.bincount(ids, np.concatenate([weight[m], weight[m]]),
                           minlength=VB)
        have = np.flatnonzero(np.bincount(ids, minlength=VB))
        rows = sorted(got[w * API_WINDOW_MS + API_WINDOW_MS - 1])
        require([r[0] for r in rows] == have.tolist()
                and [r[1] for r in rows] == sums[have].astype(np.int64)
                .tolist(), "api reduce window %d differs" % w)
    res["reduce"] = {"edges": API_EDGES, "windows": n_win,
                     "seconds": wall, "edges_per_s": API_EDGES / wall,
                     "launches": launches["cell_reduce"]}
    # where its time goes: a 1/8 prefix of the same job, profiled
    k = API_EDGES // 8
    penv, pgraph = api_graph(P, src[:k], dst[:k], ts[:k])
    pgraph.slice(P.Time.milliseconds_of(API_WINDOW_MS),
                 P.EdgeDirection.ALL).reduce_on_edges(
        P.TorchEdgesReduce(name="sum")).collect()
    prof = profile_run(penv.execute)
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
            "edges_per_s": API_EDGES / wall,
            "launches": tri_launches[size]}
    require(routes["dense"] > 0 and routes["sparse"] > 0,
            "triangles: routes %s" % routes)

    # get_degrees (BASELINE config #1): a running degree a contribution
    env, graph = api_graph(P, src, dst, ts)
    out = graph.get_degrees().collect()
    t0 = time.perf_counter()
    env.execute()
    wall = time.perf_counter() - t0
    got = env.results_of(out)
    ids = np.stack([src, dst], 1).reshape(-1)
    order = np.argsort(ids, kind="stable")
    run = np.empty(len(ids), np.int64)
    first = np.r_[0, np.flatnonzero(np.diff(ids[order])) + 1]
    starts = np.repeat(first, np.diff(np.r_[first, len(ids)]))
    run[order] = np.arange(len(ids)) - starts + 1
    require(len(got) == len(ids)
            and [v.id for v in got] == ids.tolist()
            and [v.value for v in got] == run.tolist(),
            "api get_degrees differs from the numpy running degree")
    res["degrees"] = {"records": len(got), "seconds": wall,
                      "edges_per_s": API_EDGES / wall}
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
    return {"cell_reduce": launches["cell_reduce"]}


def profile_both(run, setup=lambda: None) -> dict:
    """profile_run of run(), pipelined and under forced_sync, each after
    setup() outside the profiled region."""
    from gelly_streaming_tpu_torch import forced_sync

    def synced():
        with forced_sync():
            run()

    setup()
    pipelined = profile_run(run)
    setup()
    return {"pipelined": pipelined, "forced_sync": profile_run(synced)}


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


def profile_run(run) -> dict:
    """One run() under torch.profiler: device time by name (the
    device-side rows only, so nothing is counted twice) and launches of
    the eight largest, their sum, and the device's idle share of the
    profiled wall time; the summary body's device rows by name, whose
    launches must match the summary wrappers' calls in the run (one
    launch per chunk or cohort dispatch). The profiler can miss one
    launch of these ctypes-loaded libraries in a profiled run (seen on
    the H100: the first of a run, at times), so one fewer passes, and
    the launches missed are printed; a run with summary calls whose
    profile has no device rows at all fails."""
    from gelly_streaming_tpu_torch import kernels
    from gelly_streaming_tpu_torch.utils.profiling import device_times

    before = dict(kernels.LAUNCHES)
    wall_ms, by_name = device_times(run)
    calls = sum(kernels.LAUNCHES[k] - before[k] for k in SUMMARY_CALLS)
    body = {k: v for k, v in by_name.items()
            if any(b in k for b in SUMMARY_BODY)}
    seen = sum(n for _ms, n in body.values())
    require(by_name or not calls,
            "%d summary calls, but the profile has no device rows" % calls)
    require(calls - 1 <= seen <= calls,
            "summary body launches %s, wrapper calls %d" % (body, calls))
    busy = sum(ms for ms, _n in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy else "not measured",
            "idle_share": 1 - busy / wall_ms if busy else "not measured",
            "device_ms_by_name": {k: ms for k, (ms, _n) in top},
            "launches_by_name": {k: n for k, (_ms, n) in top},
            "summary_calls": calls,
            "summary_body_missed": calls - seen,
            "summary_body": {k: {"ms": ms, "launches": n}
                             for k, (ms, n) in body.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from gelly_streaming_tpu_torch import kernels

    dev = torch.device("cuda", torch.cuda.current_device())
    print(card())
    t0 = time.perf_counter()
    logs = kernels.build()
    print("build: %.1f s  (%s)" % (time.perf_counter() - t0,
                                   ", ".join(sorted(kernels.SIGNATURES))))
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas %s: %s" % (name, line.strip()))
    from gelly_streaming_tpu_torch import native

    t0 = time.perf_counter()
    require(native.available(), "native library: %s" % native.build_error())
    print("native build: %.1f s  (%s)" % (time.perf_counter() - t0,
                                         native.library_path().name))
    for name in ("gnn_round", "dense_triangles"):
        print("sass %s: %s" % (name, json.dumps(tensor_core_ops(
            kernels.library_path(name)))))

    rng = np.random.default_rng(SEED)
    inter = phase_intersect(dev, rng)
    counter = phase_counter(dev)
    summary = phase_summary(dev)
    gnn = phase_gnn(dev)
    cohort = phase_cohort(dev)
    compact = phase_compact(dev)
    snapshot = phase_snapshot(dev)
    cells = phase_cell_reduce(dev)
    launches, counts = phase_stream(dev)
    compact_launches = phase_stream_compact(dev, counts)
    summary_launches, summaries, state = phase_summary_stream(dev)
    summary_compact_launches = phase_summary_stream_compact(dev, summaries,
                                                            state)
    gnn_launches = phase_gnn_stream(dev)
    dense, dense_launches, sparse_launches = phase_dense(dev)
    cohort_launches = phase_cohort_stream(dev)
    phase_gnn_cohort(dev)
    driver_launches = phase_driver(dev, counts)
    phase_driver_file(dev)
    reduce_launches = phase_reduce_stream(dev)
    api_launches = phase_api(dev)
    require(api_launches["cell_reduce"] > 0, "api: no cell_reduce launch")

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
             reduce_launches["cell_reduce"])):
        rows.append({
            "name": name, "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/%s.cu" % source,
            "replaces": replaces, "launches": n,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms")})
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
