#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gelly_streaming_tpu_torch) on one
NVIDIA GPU.

Builds the CUDA kernels from gelly_streaming_tpu_torch/csrc, holds each
against its plain PyTorch version on the card, then drives the port's
main path: TriangleWindowKernel(32768, 65536).count_stream over the
bench's north-star stream (make_stream(10_485_760, 65_536, seed=7): 320
Zipf windows of 32768 edges), checks every window's count, and reports
edges/s and each kernel's launches and times.

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
# Published peaks of one H100 SXM (NVIDIA's data sheet, at the 700 W
# limit): HBM bytes/s, and the float32 rate outside the tensor cores,
# taken as the rate of 32-bit scalar operations (compares, adds).
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = 67e12


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


def bound(nbytes: float, ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the scalar rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_OPS_S
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


def row_work(src, dst, valid, vb: int, kb: int) -> tuple:
    """(Σ over windows of distinct oriented edges, Σ of la·lb): the
    compares the row intersection of each window's distinct oriented
    edges needs, rows capped at kb, from the plain pipeline."""
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
        compares += int((out[a] * out[b]).sum())
    return edges, compares


def clique(m: int, base: int):
    u, v = np.triu_indices(m, k=1)
    return (u + base).astype(np.int32), (v + base).astype(np.int32)


# ----------------------------------------------------------------------
def phase_intersect(dev, rng) -> dict:
    """Kernel vs plain on random deduplicated unsorted rows at the main
    path's per-window shape: vb=65536, K=128, a ragged Ep."""
    from gelly_streaming_tpu_torch.ops import intersect

    vb, k, ep = VB, KB, EB - 37
    # ids from a narrow range so rows share entries; each row sorted,
    # deduplicated to the sentinel, a share blanked, then shuffled
    vals = np.sort(rng.integers(0, 1024, (vb + 1, k)), axis=1)
    dup = np.zeros_like(vals, bool)
    dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
    keep = ~dup & (rng.random((vb + 1, k)) < 0.7)
    rows = np.where(keep, vals, vb)
    rows = np.take_along_axis(rows, rng.random((vb + 1, k)).argsort(1), 1)
    rows[vb] = vb
    ea = rng.integers(0, vb + 1, ep)
    eb = rng.integers(0, vb + 1, ep)
    emask = rng.random(ep) < 0.9
    nbr = torch.from_numpy(rows.astype(np.int32)).to(dev)
    ta = torch.from_numpy(ea.astype(np.int32)).to(dev)
    tb = torch.from_numpy(eb.astype(np.int32)).to(dev)
    tm = torch.from_numpy(emask).to(dev)

    got = int(intersect.intersect_local(nbr, ta, tb, tm))
    want = int(intersect.intersect_local_plain(nbr, ta, tb, tm))
    torch.cuda.synchronize()
    require(got == want, "intersect: kernel %d != plain %d" % (got, want))
    require(want > 0, "intersect: fixture has no common entries")
    ms = cuda_ms(lambda: intersect.intersect_local(nbr, ta, tb, tm), 50)
    plain_ms = cuda_ms(
        lambda: intersect.intersect_local_plain(nbr, ta, tb, tm), 5)
    # bytes: each touched row once, the edge arrays, the total; ops: the
    # compares these rows need, Σ over valid edges of (valid entries of
    # row a) × (valid entries of row b): a sentinel entry never matches
    touched = np.unique(np.concatenate([ea[emask], eb[emask]])).size
    nbytes = touched * k * 4 + ep * 9 + 4
    row_len = (rows < vb).sum(axis=1).astype(np.int64)
    compares = int((row_len[ea[emask]] * row_len[eb[emask]]).sum())
    b_ms, b_by = bound(nbytes, compares)
    print("phase intersect: ok  count=%d  kernel %.4f ms  plain %.4f ms  "
          "(Ep=%d K=%d vb=%d)" % (got, ms, plain_ms, ep, k, vb))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": abs(got - want)}


def compare_counter(name, src, dst, valid, counter, dev):
    """Kernel (`counter`, a WindowCounter on the card) vs plain (count,
    overflow) of every window of a stack: overflow equal everywhere,
    count equal where overflow is 0 (with overflow > 0 the truncated rows
    differ by design and callers recount). Returns (count, overflow,
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
    clean = po == 0
    require(np.array_equal(c[clean], pc[clean]),
            "%s: count kernel %s != plain %s" % (name, c[clean], pc[clean]))
    err = int(np.abs(c[clean].astype(np.int64) - pc[clean]).max(initial=0))
    return c, o, err


def phase_counter(dev) -> dict:
    """Kernel vs plain on a 64-window chunk at eb=32768, vb=65536,
    kb=128 whose last window holds a CLIQUE-clique (overflows kb), the K14
    clique window at kb=8, and edge cases at a small shape."""
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc

    src, dst = make_stream(CHUNK * EB, VB, seed=11)
    _w, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    cs, cd = clique(CLIQUE, 1000)
    s[-1, :len(cs)], d[-1, :len(cd)] = cs, cd
    counter = wc.WindowCounter(VB, KB, dev)
    c, o, err = compare_counter("counter chunk", s, d, v, counter, dev)
    require(o[-1] > 0 and (o[:-1] == 0).all(),
            "counter chunk: overflow where not built: %s" % o)

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

    # times at the main path's chunk shape
    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (s, d, v))
    count = torch.empty(CHUNK, dtype=torch.int32, device=dev)
    overflow = torch.empty_like(count)
    ms = cuda_ms(lambda: counter(st, dt, vt), 20)
    tables_ms = cuda_ms(lambda: wc.build_tables(
        st, dt, vt, counter.scratch, overflow), 20)
    stage_ms = cuda_ms(lambda: wc.intersect_tables(counter.scratch, count),
                       20)
    plain_ms = cuda_ms(lambda: wc.count_windows_plain(st, dt, vt, VB, KB), 2)
    edges, compares = row_work(st, dt, vt, VB, KB)
    nbytes = CHUNK * EB * 9 + CHUNK * 8     # the slab in, two ints out
    b_ms, b_by = bound(nbytes, CHUNK * EB + compares)
    print("phase counter: ok  overflow window %d  kernel %.3f ms/chunk "
          "(tables %.3f + intersect %.3f)  plain %.3f ms/chunk  "
          "(%d windows, %d distinct edges, %d compares)"
          % (o[-1], ms, tables_ms, stage_ms, plain_ms, CHUNK, edges,
             compares))
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": max(err, err14, erre),
            "tables_ms": tables_ms, "intersect_stage_ms": stage_ms}


def phase_stream(dev) -> dict:
    """The main path: count_stream over 320 windows, every window's
    count checked, launches of both kernels counted."""
    from gelly_streaming_tpu_torch import TriangleWindowKernel, kernels
    from gelly_streaming_tpu_torch import make_stream
    from gelly_streaming_tpu_torch.ops import host_triangles
    from gelly_streaming_tpu_torch.ops import segment as seg
    from gelly_streaming_tpu_torch.ops import window_counter as wc

    src, dst = make_stream(STREAM_EDGES, VB, seed=SEED)
    kern = TriangleWindowKernel(EB, VB)        # device=None: the card
    require(kern.device.type == "cuda", "kernel not on the card")
    require(kern.kb == KB, "kb %d, want %d" % (kern.kb, KB))
    kern.count_stream(src[:CHUNK * EB], dst[:CHUNK * EB])   # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    counts = kern.count_stream(src, dst)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    num_w = STREAM_EDGES // EB
    require(len(counts) == num_w, "%d windows, want %d"
            % (len(counts), num_w))
    for name, n in launches.items():
        require(n > 0, "kernel %s was not launched on the main path" % name)

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
        "kb": kern.kb, "seconds": wall, "edges_per_s": rate,
        "repeat_seconds": repeats, "host_stack_ms": host_stack_ms,
        "triangles": int(sum(counts)), "plain_overflow_windows": recounted,
        "launches": launches,
        "device": torch.cuda.get_device_name(0)}}))
    print(json.dumps({"profile": profile_stream(kern, src, dst)}))
    print("phase stream: ok  %d windows  %.1f edges/s" % (num_w, rate))
    return launches


def profile_stream(kern, src, dst) -> dict:
    """One count_stream under torch.profiler: device time by name (the
    device-side rows only, so nothing is counted twice), their sum, and
    the device's idle share of the profiled wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern.count_stream(src, dst)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            key = ev.key[:70]
            by_name[key] = by_name.get(key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_ms": wall_ms,
            "device_busy_ms": busy if busy else "not measured",
            "idle_share": 1 - busy / wall_ms if busy else "not measured",
            "device_ms_by_name": top}


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

    rng = np.random.default_rng(SEED)
    inter = phase_intersect(dev, rng)
    counter = phase_counter(dev)
    launches = phase_stream(dev)

    rows = []
    for name, replaces, res in (
            ("intersect", "gelly_streaming_tpu/ops/pallas_intersect.py:116",
             inter),
            ("window_counter",
             "gelly_streaming_tpu/ops/pallas_window.py:748", counter)):
        rows.append({
            "name": name, "route": "cuda",
            "source": "gelly_streaming_tpu_torch/csrc/%s.cu" % name,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None})
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
