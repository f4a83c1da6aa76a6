"""Where a sharded window's time goes on one rank of the card.

    python3 -m gelly_streaming_tpu_torch.utils.shard_probe [--windows N]

On a one-rank NCCL mesh (parallel/mesh.make_mesh()), the N windows of
make_stream(N·32768, 65_536, seed=7) (eb=32768, vb=65536, k_bucket=128,
the bench stream's buckets) through ShardedTriangleWindowKernel.count_stream
in both table modes and through ShardedSummaryEngine.process: each run
once to warm up, once timed on the host clock (synchronized), once under
torch.profiler. One JSON line a path: wall ms a window; kernel launches
(cudaLaunchKernel calls), collectives (c10d rows) and their host ms a
window; device ms a window and its five largest device rows. The
profiler's session is the first of the process.

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from .. import kernels
from ..parallel import mesh as mesh_mod
from ..parallel import sharded
from .streams import make_stream

EB, VB, KB = 32768, 65536, 128


def _profile(run, windows: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    run()                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    launches = comms = 0
    comm_ms = device_ms = 0.0
    rows = {}
    for ev in prof.key_averages():
        if str(ev.device_type).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0)
            device_ms += us / 1e3
            rows[ev.key[:60]] = rows.get(ev.key[:60], 0.0) + us / 1e3
            continue
        if ev.key.startswith("cudaLaunchKernel"):
            launches += ev.count
        if ev.key.startswith("c10d::"):
            comms += ev.count
            comm_ms += ev.cpu_time_total / 1e3
    top = sorted(rows.items(), key=lambda kv: -kv[1])[:5]
    return {"windows": windows, "wall_ms_per_window": 1e3 * wall / windows,
            "launches_per_window": launches / windows,
            "collectives_per_window": comms / windows,
            "collective_host_ms_per_window": comm_ms / windows,
            "device_ms_per_window": device_ms / windows,
            "top_device_ms_per_window": {k: v / windows for k, v in top}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=64)
    args = ap.parse_args(argv)
    kernels.build()
    mesh = mesh_mod.make_mesh()
    n = args.windows * EB
    src, dst = make_stream(n, VB, seed=7)
    card = torch.cuda.get_device_name(0)
    try:
        for table in ("replicated", "owner"):
            kern = sharded.ShardedTriangleWindowKernel(
                mesh, EB, VB, k_bucket=KB, table=table)
            row = _profile(lambda: kern.count_stream(src, dst), args.windows)
            print(json.dumps({"path": "count_stream", "table": table,
                              "device": card, **row}))
        eng = sharded.ShardedSummaryEngine(mesh, EB, VB, k_bucket=KB)

        def summary():
            eng.reset()
            eng.process(src, dst)

        print(json.dumps({"path": "summary", "table": "replicated",
                          "device": card,
                          **_profile(summary, args.windows)}))
    finally:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
