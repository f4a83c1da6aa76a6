"""The readings that set the limits of `correct`: the program's numbers
compared over many seeds, and the control's, in one process.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> ... --control-seeds <n> ... [--out FILE]

Each seed is a whole run of the cell (harness.execute: set-up, a window
of `seconds`, the check) with the program, or with the control in the
program's place: the plain reference at the precision below the one the
configuration states (the systems' `program="control"`). Prints one JSON
line a run and, last, each number's largest reading over the program's
runs (the lower reading) and its smallest over the control's (the upper
reading). Needs the cards the cell asks for.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
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
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from portbench import harness, peaks, spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_benchmark(HERE.parent)
    rows = []
    for program, seeds in (("engine", args.seeds),
                           ("control", args.control_seeds)):
        for seed in seeds:
            t = time.perf_counter()
            res, _ = harness.execute(bench, args.workload, seed,
                                     args.seconds, False, t,
                                     program=program)
            row = {"program": program, "seed": seed,
                   "correct": res["correct"], "windows": res["attempted"],
                   "checks": {k: v["value"] for k, v in res["checks"].items()},
                   "seconds": time.perf_counter() - t}
            rows.append(row)
            print(json.dumps(row), flush=True)
            gc.collect()
            torch.cuda.empty_cache()
    names = sorted({k for r in rows for k in r["checks"]})
    summary = {}
    for n in names:
        low = [r["checks"][n] for r in rows if r["program"] == "engine"]
        up = [r["checks"][n] for r in rows if r["program"] == "control"]
        summary[n] = {"lower": max(low) if low else None,
                      "upper": min(up) if up else None}
    line = json.dumps({"workload": args.workload, "readings": summary,
                       "power_limit": peaks.power_limit()})
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
