"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the checkout's root, on a machine with the CUDA cards the cell asks
for. With --trace 0 the result line carries the cell's end-to-end
metrics, with --trace 1 its per-layer metrics, read from a device
capture of the window's first calls. Standard output's last line is the
result (JSON: correct, attempted, failed, metrics, device, breakdown
with --trace 1, and last the numbers compared with their limits);
standard error's last lines are the same numbers compared.

Exits 2 with no result where the cards are missing, 3 where a module of
JAX or of the JAX package was loaded, and 1 on any other failure.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the bytecode of every module the run imports (PyTorch's and the
# port's) is cached in the checkout too, so that only its first run
# compiles it, also where the installation keeps none and the
# environment says not to write it beside the sources
sys.pycache_prefix = str(HERE / "_cache" / "pycache")
sys.dont_write_bytecode = False
# the program's build and kernel caches stay in the checkout, at fixed
# paths (the port builds its CUDA libraries into its own _build/)
os.environ["TRITON_CACHE_DIR"] = str(HERE / "_cache" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(HERE / "_cache" / "torch_extensions")
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
else:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness, spec

    laps = [("imports", time.perf_counter() - T_START)]
    bench = spec.load_benchmark(ROOT)
    cell = spec.workload(bench, args.workload)
    t = time.perf_counter()
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    laps.append(("look for cards", time.perf_counter() - t))
    if found < cell["chips"]:
        print("portbench: cell %s needs %d CUDA card(s), found %d; no "
              "result" % (args.workload, cell["chips"], found),
              file=sys.stderr)
        return 2
    result, lines = harness.execute(bench, args.workload, args.seed,
                                    args.seconds, bool(args.trace), T_START,
                                    laps=laps)
    bad = harness.forbidden_modules()
    if bad:
        print("portbench: modules of JAX or the JAX package were loaded: %s;"
              " no result" % ", ".join(bad), file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
