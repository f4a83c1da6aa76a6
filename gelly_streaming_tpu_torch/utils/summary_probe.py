"""Where the summary body's time goes on the card: the kernel of
csrc/summary_body.cuh timed alone in each tier at several window
counts, so that what a call costs once and what a window costs
separate.

    python3 -m gelly_streaming_tpu_torch.utils.summary_probe [--source DIR]

Shared-memory tier: the cohort kernel (`summarize_cohort`) on Zipf rows
at eb=4096, vb=8192, nb = 1 and 64, W = 1, 2, 4, 8. L2 tier: the window
summary kernel (`summarize`) on Zipf windows at eb=32768, vb=65536,
W = 1, 8, 64, and the cohort kernel at nb=8, vb=65536, W = 1, 8. Tier
choice: the cohort kernel at vb=8192, nb = 1, 8, 64, W = 1, 8, in the
shared-memory tier and, built with GS_SUMMARY_L2_ONLY, in the L2 tier,
side by side (the port's own csrc only). Each
starts from carries with eight windows folded, cloned 20 times before
the timed run; the 20 launches, straight through the C entry point,
are timed back to back with CUDA events: the kernel's own time, none
of the wrapper's host time. With `--source DIR`, the kernels built
from DIR's window_summary.cu and cohort_summary.cu instead (another
commit's csrc, unpacked; same C entry points), with the port's nvcc
flags. One JSON line on stdout, with the card's name and power limit.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..ops import cohort_summary as cs
from ..ops import window_summary as ws
from .streams import make_stream

REPS = 20


def _slab(nb: int, windows: int, eb: int, vb: int, seed: int, dev):
    """[nb, windows, eb] Zipf rows, all slots valid, on `dev`."""
    s = np.empty((nb, windows * eb), np.int32)
    d = np.empty_like(s)
    for n in range(nb):
        s[n], d[n] = make_stream(windows * eb, vb, seed=seed + n)
    shape = (nb, windows, eb)
    return (torch.from_numpy(s.reshape(shape)).to(dev),
            torch.from_numpy(d.reshape(shape)).to(dev),
            torch.ones(shape, dtype=torch.bool, device=dev))


def _check(code: int) -> None:
    if code:
        raise RuntimeError("summary kernel: CUDA error %d" % code)


def _launches_ms(carries, launch) -> float:
    """ms per launch of `launch(carry)` over REPS copies of `carries`,
    cloned before the timed run and launched back to back: the kernel's
    own time on the card, none of the wrapper's host time."""
    launch(tuple(c.clone() for c in carries))
    copies = [tuple(c.clone() for c in carries) for _ in range(REPS)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for carry in copies:
        launch(carry)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def load(source: Path = None, defines: tuple = ()) -> dict:
    """{"window_summary": lib, "cohort_summary": lib}: the port's, or
    built with the nvcc flags `defines` added, from the .cu files of the
    csrc directory `source` (default the port's; its own headers beside
    them) into the build directory."""
    names = ("window_summary", "cohort_summary")
    if source is None and not defines:
        return {name: kernels.library(name) for name in names}
    source = source or kernels.CSRC
    tag = hashlib.sha256(" ".join(defines).encode() + b"".join(
        f.read_bytes() for f in sorted(source.glob("*.cu*")))).hexdigest()
    out_dir = kernels.BUILD_DIR / ("probe-" + tag[:16])
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in names:
        lib = out_dir / (name + ".so")
        if not lib.exists():
            subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS,
                            *defines, "-o", str(lib),
                            str(source / (name + ".cu"))],
                           check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(lib))
        for fn, argtypes in kernels.SIGNATURES[name].items():
            getattr(libs[name], fn).argtypes = argtypes
            getattr(libs[name], fn).restype = ctypes.c_int
    return libs


def cohort_ms(lib, nb: int, windows: int, eb: int, vb: int, dev) -> float:
    """The cohort kernel alone, ms per launch, on Zipf rows from carries
    with eight windows folded."""
    carries = cs.fresh_cohort_carry(nb, vb, dev)
    cs.summarize_cohort(carries, *_slab(nb, 8, eb, vb, 100, dev), vb,
                        torch.empty(nb, 3, 8, dtype=torch.int32,
                                    device=dev))
    src, dst, valid = _slab(nb, windows, eb, vb, 200, dev)
    sums = torch.empty(nb, 3, windows, dtype=torch.int32, device=dev)
    stream = kernels.stream_of(src)

    def launch(carry):
        _check(lib.gs_cohort_summary(
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(), nb, windows,
            eb, vb, *(c.data_ptr() for c in carry), sums.data_ptr(),
            dev.index, stream))

    return _launches_ms(carries, launch)


def window_ms(lib, windows: int, eb: int, vb: int, dev) -> float:
    """The window summary kernel alone (standard wire), ms per launch,
    on Zipf windows from a carry with eight windows folded."""
    carry = ws.fresh_carry(vb, dev)
    pre = [x[0] for x in _slab(1, 8, eb, vb, 100, dev)]
    ws.summarize(carry, *pre, vb, torch.empty(3, 8, dtype=torch.int32,
                                              device=dev))
    src, dst, valid = (x[0] for x in _slab(1, windows, eb, vb, 200, dev))
    sums = torch.empty(3, windows, dtype=torch.int32, device=dev)
    stream = kernels.stream_of(src)

    def launch(c):
        _check(lib.gs_window_summary(
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(), windows, eb,
            vb, *(x.data_ptr() for x in c), sums.data_ptr(), dev.index,
            stream))

    return _launches_ms(carry, launch)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=None,
                        help="a csrc directory to build the kernels from")
    args = parser.parse_args()
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = load(args.source)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    out = {"card": card, "source": str(args.source or kernels.CSRC),
           "shared_tier": [], "l2_tier": [], "tier_choice": []}
    coh, win = libs["cohort_summary"], libs["window_summary"]
    for nb in (1, 64):
        for windows in (1, 2, 4, 8):
            out["shared_tier"].append({
                "kernel": "cohort", "nb": nb, "windows": windows,
                "eb": 4096, "vb": 8192,
                "ms": cohort_ms(coh, nb, windows, 4096, 8192, dev)})
    for windows in (1, 8, 64):
        out["l2_tier"].append({
            "kernel": "window", "nb": 1, "windows": windows, "eb": 32768,
            "vb": 65536, "ms": window_ms(win, windows, 32768, 65536, dev)})
    for windows in (1, 8):
        out["l2_tier"].append({
            "kernel": "cohort", "nb": 8, "windows": windows, "eb": 4096,
            "vb": 65536, "ms": cohort_ms(coh, 8, windows, 4096, 65536, dev)})
    if args.source is None:
        l2 = load(None, ("-DGS_SUMMARY_L2_ONLY",))["cohort_summary"]
        for nb in (1, 8, 64):
            for windows in (1, 8):
                out["tier_choice"].append({
                    "kernel": "cohort", "nb": nb, "windows": windows,
                    "eb": 4096, "vb": 8192,
                    "shared_ms": cohort_ms(coh, nb, windows, 4096, 8192,
                                           dev),
                    "l2_ms": cohort_ms(l2, nb, windows, 4096, 8192, dev)})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
