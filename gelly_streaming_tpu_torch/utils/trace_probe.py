"""Does a device_trace capture keep the card's kernel records, and after
what does it lose them.

    python3 -m gelly_streaming_tpu_torch.utils.trace_probe [--edges N]
    python3 -m gelly_streaming_tpu_torch.utils.trace_probe --smoke

A scan-tier driver call over the first `edges` edges of the bench
stream (make_stream(10_485_760, 65_536, seed=7), eb=32768, vb=65536) is
captured by utils/tracing.device_trace at each step of one process's
history, in this order:

  fresh               the first profiler session of the process;
  again               a second capture at once;
  after_device_times  after one utils/profiling.device_times session
                      of the same call;
  after_6_sessions    after five more;
  telemetry           with the flight recorder armed (GS_TELEMETRY=1);
  costmodel           with the cost observatory armed (GS_COSTMODEL=1);
  after_graphs        after a resident-tier driver call, whose
                      super-batches are captured and replayed as CUDA
                      graphs;
  synced              the same, the card synchronized before the start.

One JSON line a step on stdout: the kernel events of the capture by
kernel name (or, for a device_times session, its device rows by name)
and the wrapper launches of the call.

--smoke runs chip_smoke.py (from the repository root) instead, with the
same capture before its first phase and after each phase it closes with
`no_demotions("phase ...")`, each line with the seconds since the last:
after which phase the captures lose the card's records. The captures
leave the smoke's launch counts as they were.

Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from .. import kernels
from ..core.driver import StreamingAnalyticsDriver
from . import costmodel, telemetry, tracing
from .profiling import device_times
from .streams import make_stream

EB, VB = 32768, 65536


def _capture(log_dir: str, run, sync: bool = False) -> dict:
    if sync:
        torch.cuda.synchronize()
    kernels.reset_launches()
    with tracing.device_trace(log_dir) as cap:
        run()
        torch.cuda.synchronize()
    return {"kernel_events": cap.kernel_events, "kernels": cap.kernels,
            "launches": {k: v for k, v in kernels.LAUNCHES.items() if v}}


def smoke_history(edges: int) -> int:
    """chip_smoke.py's run, a capture before its first phase and after
    each phase it closes (module docstring); its exit code."""
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    state = {"t": time.perf_counter()}

    def capture(step: str) -> None:
        if "drv" not in state:
            src, dst = make_stream(10_485_760, VB, seed=7)
            state["stream"] = (src[:edges], dst[:edges])
            state["drv"] = StreamingAnalyticsDriver(
                window_ms=1, edge_bucket=EB, vertex_bucket=VB)
        drv, (src, dst) = state["drv"], state["stream"]
        counts = (dict(kernels.LAUNCHES), dict(kernels.REPLAYS))

        def run():
            drv.reset()
            drv.run_arrays(src, dst)

        got = _capture(os.path.join(state["tmp"], step.replace(" ", "_")),
                       run)
        kernels.LAUNCHES.update(counts[0])
        kernels.REPLAYS.update(counts[1])
        now = time.perf_counter()
        print(json.dumps({"step": step, "since_s": now - state["t"],
                          **got}), flush=True)
        state["t"] = time.perf_counter()

    first, closed = chip_smoke.phase_intersect, chip_smoke.no_demotions

    def phase_intersect(*a, **k):
        capture("before the first phase")
        return first(*a, **k)

    def no_demotions(label, *drivers):
        closed(label, *drivers)
        if label.startswith("phase "):
            capture("after " + label)

    chip_smoke.phase_intersect = phase_intersect
    chip_smoke.no_demotions = no_demotions
    with tempfile.TemporaryDirectory() as tmp:
        state["tmp"] = tmp
        return chip_smoke.main()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--edges", type=int, default=2_097_152)
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_probe: no CUDA device")
    if args.smoke:
        return smoke_history(args.edges)
    kernels.build()
    src, dst = make_stream(10_485_760, VB, seed=7)
    src, dst = src[:args.edges], dst[:args.edges]
    drv = StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                   vertex_bucket=VB)
    drv.run_arrays(src[:2 * EB], dst[:2 * EB])          # warm-up

    def run():
        drv.reset()
        drv.run_arrays(src, dst)

    def show(step: str, got: dict) -> None:
        print(json.dumps({"step": step, **got}), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        def cap(step: str, sync: bool = False) -> None:
            show(step, _capture(os.path.join(tmp, step), run, sync))

        def session(step: str) -> None:
            _wall, rows = device_times(run)
            show(step, {"device_rows": {k: n for k, (_ms, n)
                                        in rows.items()}})

        cap("fresh")
        cap("again")
        session("device_times_1")
        cap("after_device_times")
        for i in range(2, 7):
            session("device_times_%d" % i)
        cap("after_6_sessions")
        os.environ["GS_TELEMETRY"] = "1"
        os.environ["GS_TRACE_DIR"] = os.path.join(tmp, "telemetry")
        telemetry.reset()
        cap("telemetry")
        os.environ["GS_TELEMETRY"] = "0"
        telemetry.reset()
        os.environ["GS_COSTMODEL"] = "1"
        costmodel.reset()
        cap("costmodel")
        os.environ["GS_COSTMODEL"] = "0"
        costmodel.reset()
        res = StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                       vertex_bucket=VB,
                                       snapshot_tier="resident")
        res.run_arrays(src, dst)
        kernels.reset_launches()
        res.reset()
        res.run_arrays(src, dst)
        show("resident_call", {"replays": dict(kernels.REPLAYS)})
        cap("after_graphs")
        cap("synced", sync=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
