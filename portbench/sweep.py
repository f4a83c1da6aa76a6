"""Find the highest rate an open-loop mix sustains: one sweep of fixed
offered rates through one set-up, on the card.

    python3 portbench/sweep.py --workload <open-loop cell> --seconds <s> \
        --rates <edges/s> ... [--seed <n>]

For each rate in turn, a window of `seconds` at that rate (the cell's
mix with its edges_per_s replaced), from the state the previous rate
left. A rate is sustained where the calls' lateness against their due
times does not grow over the window: the last quarter's mean lateness
within one call's median time of the first quarter's. Prints one JSON
line a rate. The rate found goes into the mix's file as a number; the
benchmark's runs never search.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(HERE.parent)
else:
    sys.path.insert(0, str(HERE.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    import torch

    from portbench import loops, peaks, spec

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(HERE.parent)
    cell = spec.workload(bench, args.workload)
    cfg = spec.load_config(bench, cell["config"])
    traffic = spec.load_traffic(cell["traffic"])
    ref = spec.load_module(spec.module_path("reference", cfg["reference"]))
    sysmod = spec.load_module(spec.module_path("systems", cfg["system"]))
    system = sysmod.System(cfg, args.seed, traffic, ref)
    print(json.dumps({"setup_s": time.perf_counter() - T_START,
                      "power_limit": peaks.power_limit()}), flush=True)
    for rate in args.rates:
        mix = dict(traffic, loop="open", edges_per_s=rate)
        loops.check_traffic(mix)
        win = loops.run(mix, system, args.seconds, args.seed)
        q = max(1, len(win.lateness_s) // 4)
        first = sum(win.lateness_s[:q]) / q
        last = sum(win.lateness_s[-q:]) / q
        call = statistics.median(win.call_s)
        lat = sorted(win.latency_s)
        print(json.dumps({
            "edges_per_s": rate, "calls": len(win.calls),
            "delivered_edges_per_s": win.edges / win.seconds,
            "late_first_s": first, "late_last_s": last,
            "call_p50_s": call, "sustained": last - first <= call,
            "window_p50_ms": loops.nearest_rank(lat, 0.5) * 1e3,
            "window_p95_ms": loops.nearest_rank(lat, 0.95) * 1e3}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
