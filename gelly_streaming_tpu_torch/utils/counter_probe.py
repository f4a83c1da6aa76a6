"""Where the window counter's time goes on the card: the kernel of
csrc/window_counter.cu timed alone, by window count, by stage and by
tier, and the intersect kernel of csrc/intersect.cu on sorted and
shuffled rows.

    python3 -m gelly_streaming_tpu_torch.utils.counter_probe [--source DIR]

Counter: Zipf windows (make_stream, all slots valid) at the main shape
(eb=32768, vb=65536, kb=128) and the cohort's (eb=4096, vb=8192,
kb=128), W = 1, 8, 64 (and 512 at the cohort's shape: its 64 × 8
dispatch). Each call is REPS launches straight through the C entry
point, back to back, timed with CUDA events: the kernel's own time, none
of the wrapper's host time. Stages (the port's csrc only): builds with
GS_COUNTER_STAGES = 1..5 stop after that stage, so each stage's time is
the difference to the build before (64 windows at the main shape, 512
and 8 at the cohort's). Tiers: a build with GS_COUNTER_L2_ONLY runs the
L2 tier where the shared-memory tier would run. Clusters: a build with
GS_COUNTER_ONE_BLOCK runs one block a window where the plan gives a
cluster of 2-8 (the crossover by W). Intersect: the one-window
`intersect_local` at Ep=32731, K=128, vb=65536 (phase intersect's rows
of chip_smoke.py), on the same rows shuffled (the compare form) and
sorted (`ascending=True`, the merge form).

With `--source DIR`, the kernels built from DIR's window_counter.cu and
intersect.cu instead (another commit's csrc, unpacked; its own headers
beside them), with the port's nvcc flags, so that two designs are timed
on one card in one call. A csrc whose counter exports gs_window_tables
(the earlier hash-set design) is driven through that entry and its
intersect stage, with the scratch it needs. One JSON line on stdout,
with the card's name and power limit. Needs a CUDA device and nvcc.
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
from ..ops import intersect
from .streams import make_stream

REPS = 20
MAIN = (32768, 65536, 128)          # eb, vb, kb
COHORT = (4096, 8192, 128)
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# the C entry points of the earlier hash-set design (padded table, one
# warp an edge), for --source
OLD = {"gs_window_tables": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I,
                            _P, _P, _P, _P, _I, _P],
       "gs_intersect": [_P, _LL, _I, _I, _I, _P, _P, _LL, _P, _P, _I, _P,
                        _LL, _P, _I, _I, _P]}


def build(names, source: Path = None, defines: tuple = ()) -> dict:
    """{name: ctypes library} of csrc/<name>.cu for each name (the
    counter and the intersect), from `source` (default the port's csrc)
    with the nvcc flags `defines` added, into the build directory; each
    library's `hash_set_design` says whether it is the earlier hash-set
    design."""
    source = source or kernels.CSRC
    tag = hashlib.sha256(" ".join(defines).encode() + b"".join(
        f.read_bytes() for f in sorted(source.glob("*.cu*")))).hexdigest()
    out_dir = kernels.BUILD_DIR / ("counter-probe-" + tag[:16])
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = out_dir / (name + ".so")
        if not lib.exists():
            procs[name] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o",
                 str(lib), str(source / (name + ".cu"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log))
    libs = {name: ctypes.CDLL(str(out_dir / (name + ".so")))
            for name in names}
    # the hash-set design exports gs_window_tables, and its gs_intersect
    # takes strides, row lengths and windows
    old = hasattr(libs["window_counter"], "gs_window_tables")
    for name, lib in libs.items():
        sigs = ({fn: OLD[fn] for fn in OLD if hasattr(lib, fn)} if old
                else kernels.SIGNATURES[name])
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.hash_set_design = old
    return libs


def _check(code: int) -> None:
    if code:
        raise RuntimeError("counter probe: CUDA error %d" % code)


def timed(launch) -> float:
    """ms per launch of `launch()`, REPS launches back to back after one
    warm-up, timed with CUDA events."""
    launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS


def zipf_stack(windows: int, eb: int, vb: int, dev, seed: int = 200):
    """[windows, eb] Zipf windows, all slots valid, on `dev`."""
    src, dst = make_stream(windows * eb, vb, seed=seed)
    shape = (windows, eb)
    return (torch.from_numpy(src.astype(np.int32).reshape(shape)).to(dev),
            torch.from_numpy(dst.astype(np.int32).reshape(shape)).to(dev),
            torch.ones(shape, dtype=torch.bool, device=dev))


def counter_launch(libs, stack, vb: int, kb: int, dev):
    """A no-argument launch of the counter built in `libs` on `stack`:
    the port's design (one entry, its plan's scratch) or the hash-set
    design (tables, then the intersect stage over them)."""
    src, dst, valid = stack
    w, eb = src.shape
    stream = kernels.stream_of(src)
    count = torch.empty(w, dtype=torch.int32, device=dev)
    overflow = torch.empty_like(count)
    lib = libs["window_counter"]
    if not lib.hash_set_design:
        out = (ctypes.c_longlong * 4)()
        _check(lib.gs_counter_plan(w, eb, vb, dev.index, out))
        buf = torch.empty(max(int(out[2]), 1), dtype=torch.uint8, device=dev)

        def launch():
            _check(lib.gs_window_counter(
                src.data_ptr(), dst.data_ptr(), valid.data_ptr(), w, eb, vb,
                kb, buf.data_ptr(), buf.numel(), count.data_ptr(),
                overflow.data_ptr(), dev.index, stream))
        return launch, {"shared_tier": bool(out[0]), "blocks": int(out[1]),
                        "scratch_bytes": int(out[2]), "cluster": int(out[3])}

    slots = 1 << max(1, (2 * eb - 1).bit_length())
    scratch = [torch.empty(shape, dtype=dtype, device=dev) for shape, dtype in
               (((w, vb + 1), torch.int32), ((w, vb + 1), torch.int32),
                ((w, vb + 1, kb), torch.int32), ((w, slots), torch.int64),
                ((w, eb), torch.int32), ((w, eb), torch.int32),
                ((w,), torch.int32))]
    deg, outdeg, table, hsh, ea, eb_, nedges = scratch
    inter = libs["intersect"]

    def launch():
        _check(lib.gs_window_tables(
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(), w, eb, vb, kb,
            deg.data_ptr(), outdeg.data_ptr(), table.data_ptr(),
            hsh.data_ptr(), slots, ea.data_ptr(), eb_.data_ptr(),
            nedges.data_ptr(), overflow.data_ptr(), dev.index, stream))
        _check(inter.gs_intersect(
            table.data_ptr(), (vb + 1) * kb, vb + 1, kb, vb, ea.data_ptr(),
            eb_.data_ptr(), eb, None, nedges.data_ptr(), eb,
            outdeg.data_ptr(), vb + 1, count.data_ptr(), w, dev.index,
            stream))
    return launch, {"scratch_bytes": sum(t.numel() * t.element_size()
                                         for t in scratch)}


def intersect_rows(dev, seed: int = 7):
    """Phase intersect's rows (chip_smoke.py): [vb+1, K] deduplicated rows
    from a narrow id range, a share blanked; shuffled and sorted copies,
    and Ep edges with a mask."""
    rng = np.random.default_rng(seed)
    vb, k, ep = MAIN[1], MAIN[2], MAIN[0] - 37
    vals = np.sort(rng.integers(0, 1024, (vb + 1, k)), axis=1)
    dup = np.zeros_like(vals, bool)
    dup[:, 1:] = vals[:, 1:] == vals[:, :-1]
    keep = ~dup & (rng.random((vb + 1, k)) < 0.7)
    rows = np.sort(np.where(keep, vals, vb), axis=1)
    rows[vb] = vb
    shuffled = np.take_along_axis(rows, rng.random(rows.shape).argsort(1), 1)
    edges = [rng.integers(0, vb + 1, ep).astype(np.int32) for _ in range(2)]
    mask = rng.random(ep) < 0.9
    t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
         for x in (shuffled.astype(np.int32), rows.astype(np.int32),
                   *edges, mask)]
    return t[0], t[1], t[2:]


def intersect_launch(lib, nbr, edges, ascending: bool, dev):
    ea, eb, emask = edges
    out = torch.empty(1, dtype=torch.int32, device=dev)
    stream = kernels.stream_of(out)
    rows, k = nbr.shape
    if lib.hash_set_design:
        def launch():
            _check(lib.gs_intersect(
                nbr.data_ptr(), 0, rows, k, rows - 1, ea.data_ptr(),
                eb.data_ptr(), 0, emask.data_ptr(), None, ea.shape[0], None,
                0, out.data_ptr(), 1, dev.index, stream))
    else:
        def launch():
            _check(lib.gs_intersect(
                nbr.data_ptr(), rows, k, rows - 1, ea.data_ptr(),
                eb.data_ptr(), emask.data_ptr(), ea.shape[0],
                int(ascending), out.data_ptr(), dev.index, stream))
    return launch, out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=None,
                        help="a csrc directory to build the kernels from")
    args = parser.parse_args()
    dev = torch.device("cuda", torch.cuda.current_device())
    names = ("window_counter", "intersect")
    libs = build(names, args.source)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    out = {"card": card, "source": str(args.source or kernels.CSRC),
           "counter": [], "stages": [], "tiers": [], "clusters": [],
           "intersect": {}}
    shapes = ((MAIN, (1, 8, 64)), (COHORT, (1, 8, 64, 512)))
    stacks = {}
    for (eb, vb, kb), counts in shapes:
        for w in counts:
            stacks[eb, w] = zipf_stack(w, eb, vb, dev)
            launch, info = counter_launch(libs, stacks[eb, w], vb, kb, dev)
            out["counter"].append({"eb": eb, "vb": vb, "kb": kb,
                                   "windows": w, "ms": timed(launch), **info})
            del launch
    if args.source is None:
        cuts = {n: build(names, None, ("-DGS_COUNTER_STAGES=%d" % n,))
                for n in range(1, 6)}
        l2 = build(names, None, ("-DGS_COUNTER_L2_ONLY",))
        one = build(names, None, ("-DGS_COUNTER_ONE_BLOCK",))
        for (eb, vb, kb), w in ((MAIN, 64), (COHORT, 512), (COHORT, 8)):
            ms = [timed(counter_launch(cuts[n], stacks[eb, w], vb, kb,
                                       dev)[0]) for n in range(1, 6)]
            ms.append(timed(counter_launch(libs, stacks[eb, w], vb, kb,
                                           dev)[0]))
            out["stages"].append({
                "eb": eb, "vb": vb, "windows": w, "through_stage_ms": ms,
                "stage_ms": [ms[0]] + [b - a for a, b in zip(ms, ms[1:])]})
        for (eb, vb, kb), counts in shapes:
            for w in counts:
                out["tiers"].append({
                    "eb": eb, "vb": vb, "windows": w,
                    "shared_ms": timed(counter_launch(
                        libs, stacks[eb, w], vb, kb, dev)[0]),
                    "l2_ms": timed(counter_launch(
                        l2, stacks[eb, w], vb, kb, dev)[0])})
                launch, info = counter_launch(libs, stacks[eb, w], vb, kb,
                                              dev)
                out["clusters"].append({
                    "eb": eb, "vb": vb, "windows": w,
                    "cluster": info["cluster"], "ms": timed(launch),
                    "one_block_ms": timed(counter_launch(
                        one, stacks[eb, w], vb, kb, dev)[0])})
    shuffled, ordered, edges = intersect_rows(dev)
    for name, nbr, asc in (("shuffled", shuffled, False),
                           ("sorted", ordered, True)):
        launch, res = intersect_launch(libs["intersect"], nbr, edges, asc,
                                       dev)
        ms = timed(launch)
        out["intersect"][name] = {
            "ms": ms, "count": int(res[0]),
            "plain": int(intersect.intersect_local_plain(nbr, *edges))}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
