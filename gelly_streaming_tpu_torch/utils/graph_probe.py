"""The resident tier's super-batches as CUDA graphs, alone: does each
kernel family capture, does a replay equal the eager launches, and what
does a replay save a super-batch.

    python3 -m gelly_streaming_tpu_torch.utils.graph_probe [--windows 256]

For each family, at the bench stream's shapes (eb=32768, vb=65536, the
first `windows` windows of make_stream(10_485_760, 65_536, seed=7)):

  summary          the summary kernel + counter, standard and compact
                   wire (the L2 tier at vb=65536, a cooperative grid),
                   and at vb=8192 (the shared-memory tier, one block);
  gnn              the GNN round at F=64 (2 launches a window and two
                   memsets, all in one graph);
  snapshot         the driver's snapshot kernel, full rows, at vb=65536
                   (cooperative grid) and vb=8192 (one block).

Each is captured through ops/resident_engine.SuperBatchGraphs, replayed
from a copy of a start carry, and held bit-equal (outputs and carry) to
the same launches made eagerly from the same carry. Then each is timed
(host clock around `reps` back-to-back super-batches ending in a
synchronize, and CUDA events): eager against replay. One JSON line on
stdout. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import kernels
from ..ops import compact_ingress
from ..ops import gnn_window as gw
from ..ops import segment as seg
from ..ops import window_snapshot as snap_ops
from ..ops.gnn_round import GnnRound
from ..ops.resident_engine import SuperBatchGraphs
from ..ops.window_summary import WindowSummary, fresh_carry
from .streams import make_stream

EB, VB, SMALL_VB, F = 32768, 65536, 8192, 64


def _summary_fn(summary, wire: str):
    """The summary call over (deg, labels, cover, *stack), its outputs
    as one [5, W] int32 tensor."""
    def fold(dg, lb, cv, *stack):
        return torch.stack([x.to(torch.int32) for x in
                            summary((dg, lb, cv), *stack, wire)])
    return fold


def _timed(fn, reps: int) -> tuple:
    """(host ms, device ms) a call of fn over `reps` calls."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    host = 1e3 * (time.perf_counter() - t0) / reps
    return host, start.elapsed_time(end) / reps


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a is None and b is None or torch.equal(a, b)


def probe(name: str, carry0, inputs, fn, reps: int) -> dict:
    """Capture fn(*carry, *inputs) over a copy of carry0, replay it,
    hold it to an eager run from carry0, then time both."""
    live = [t for t in carry0 if t is not None]
    eager_carry = [t.clone() for t in live]
    eager_out = fn(*eager_carry, *inputs)
    eager_out = {k: v.clone() for k, v in eager_out.items()} \
        if isinstance(eager_out, dict) else eager_out.clone()
    graph_carry = [t.clone() for t in live]
    graphs = SuperBatchGraphs("resident_summary")
    before = dict(kernels.LAUNCHES)
    out = graphs.run(("probe",), tuple(graph_carry) + tuple(inputs), fn)
    torch.cuda.synchronize()
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in before
                if kernels.LAUNCHES[k] != before[k]}
    same = _equal(out, eager_out) and _equal(graph_carry, eager_carry)
    if not same:
        raise AssertionError("%s: the replay differs from the eager run"
                             % name)
    key = tuple(graph_carry) + tuple(inputs)
    eager_host, eager_dev = _timed(lambda: fn(*graph_carry, *inputs), reps)
    replay_host, replay_dev = _timed(
        lambda: graphs.run(("probe",), key, fn), reps)
    return {"name": name, "equal": True,
            "launches_a_replay": launches,
            "eager_host_ms": round(eager_host, 4),
            "eager_device_ms": round(eager_dev, 4),
            "replay_host_ms": round(replay_host, 4),
            "replay_device_ms": round(replay_dev, 4),
            "saved_us": round(1e3 * (eager_host - replay_host), 1)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=256)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("graph_probe needs a CUDA device")
    dev = torch.device("cuda", 0)
    kernels.build()
    w = args.windows
    src, dst = make_stream(w * EB, VB, seed=7)
    _n, s, d, valid = seg.window_stack(src, dst, EB, sentinel=VB)
    rows = []

    def staged(vb):
        s_, d_ = (np.where(valid, x % vb, vb).astype(np.int32)
                  for x in (s, d))
        return tuple(torch.from_numpy(x).to(dev) for x in (s_, d_, valid))

    for vb in (VB, SMALL_VB):
        summary = WindowSummary(vb, 128, dev)
        summary.counter.reserve(w, EB)
        std = staged(vb)
        summary(fresh_carry(vb, dev), *std)          # warm, outside capture
        rows.append(probe(
            "summary_standard_vb%d" % vb, fresh_carry(vb, dev), std,
            _summary_fn(summary, "standard"), args.reps))
        if vb == VB:
            cs, cd, nv = compact_ingress.window_stack(src, dst, EB)[1:]
            comp = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                         for x in (cs, cd, nv))
            summary(fresh_carry(vb, dev), *comp, "compact")
            rows.append(probe(
                "summary_compact_vb%d" % vb, fresh_carry(vb, dev), comp,
                _summary_fn(summary, "compact"), args.reps))
        snap = snap_ops.WindowSnapshot(vb, snap_ops.ANALYTICS, dev)
        carry = snap_ops.engine_carry(
            vb, np.zeros(0, np.int64), np.zeros(0, np.int32),
            np.arange(2 * vb, dtype=np.int32), dev)
        snap(tuple(t.clone() for t in carry), *std)  # warm
        rows.append(probe(
            "snapshot_vb%d" % vb, carry, std,
            lambda dg, lb, cv, *t, snap=snap: snap((dg, lb, cv), *t),
            args.reps))
    rnd = GnnRound(VB, F, dev)
    h = torch.from_numpy(gw.default_features(VB, F, seed=0)).to(dev)
    wt, bt = (torch.from_numpy(x).to(dev) for x in gw.snap_weights(
        *gw.default_weights(F), F))
    std = staged(VB)

    def gnn(hh, *t):
        sums = torch.empty(4, w, dtype=torch.int32, device=dev)
        rnd(hh, wt, bt, *t, "relu", sums)
        return sums

    gnn(h.clone(), *std)                              # warm
    rows.append(probe("gnn_f%d" % F, (h,), std, gnn, args.reps))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "windows": w, "eb": EB, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
