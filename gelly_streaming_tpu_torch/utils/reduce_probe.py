"""Where the cell-reduce kernel's time goes on the card, timed straight
through its C entry points, beside another commit's kernel and beside
builds without one of its design's elements.

    python3 -m gelly_streaming_tpu_torch.utils.reduce_probe \
        [--source DIR] [--elements] [--reps N]

Run from the repository's root (the bounds come from chip_smoke.py's
`cell_bytes` and `bound`). The cases (csrc/cell_reduce.cu
`gs_cell_reduce`, `gs_cell_reduce_compact`; int32 sums unless named):
- main: windows of eb = 8192 at vb = 16384, direction "out" (the
  reduce stream's chunk), W = 1, 8 and 64 windows a call; at W = 64
  also the compact wire, the delta wire, float32 min (the CAS loop);
- big: eb = 32768 at vb = 65536, direction "all" (the north-star
  stream), the same;
- the Zipf stream (`make_stream`, as above), a uniform-id chunk and an
  all-on-one-vertex hub chunk at both shapes (W = 64);
- the record API's one-window call (ops/neighborhood.py
  `_monoid_cells`: one window of eb = 8192 slots over the window's
  interned sources).
Each row has each kernel's plan (`gs_cell_reduce_plan`: C, span,
passes and, where the source has them, stages and clusters launched),
the bound of its bytes, and per kernel the device ms (each kernel's
mean a launch from utils/profiling.device_times) and the CUDA-event ms
of REPS launches back to back after a warm-up. The kernels run in turns
in one process, case by case: the other source's, this one's, this
one's, the other's (each reported as the mean of its two turns, both
kept). `--source DIR` builds DIR's cell_reduce.cu (another commit's
csrc, unpacked: the same C entry points) with the port's nvcc flags;
`--elements` also builds this source with the ring at every window
size and at none (-DGS_CELL_RING_MIN_BYTES=0, =2^40) and times them in
the same turns. One
JSON line on stdout, with the card's name and power limit. Needs a CUDA
device and nvcc.
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
from ..ops import cell_reduce as cr
from .profiling import device_times
from .streams import make_stream

REPS = 50
MAIN = (8192, 16384, "out")
BIG = (32768, 65536, "all")
ELEMENTS = {"ring_always": ("-DGS_CELL_RING_MIN_BYTES=0",),
            "ring_never": ("-DGS_CELL_RING_MIN_BYTES=1099511627776",)}


def load(builds: dict) -> dict:
    """{name: cell_reduce library} of builds {name: (source, defines)}:
    the port's for (None, ()), else `source`'s cell_reduce.cu (default
    the port's csrc) with `defines` added to the port's nvcc flags, one
    nvcc each, all started together."""
    paths, procs = {}, {}
    for name, (source, defines) in builds.items():
        if source is None and not defines:
            continue
        source = source or kernels.CSRC
        tag = hashlib.sha256(" ".join(defines).encode() + b"".join(
            f.read_bytes() for f in sorted(source.glob("*.cu*"))))
        paths[name] = kernels.BUILD_DIR / (
            "probe-cell-%s.so" % tag.hexdigest()[:16])
        if not paths[name].exists():
            kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs[name] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o",
                 str(paths[name]), str(source / "cell_reduce.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc %s %s:\n%s" % (name, builds[name], log))
    libs = {}
    for name in builds:
        if name not in paths:
            libs[name] = kernels.library("cell_reduce")
            continue
        lib = libs[name] = ctypes.CDLL(str(paths[name]))
        for fn, argtypes in kernels.SIGNATURES["cell_reduce"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        source = builds[name][0] or kernels.CSRC
        lib.window_shape = "int slot_bytes, int vbp" in (
            source / "cell_reduce.cu").read_text()
        if not lib.window_shape:
            lib.gs_cell_reduce_plan.argtypes = [ctypes.c_int] * 3 + [
                ctypes.c_void_p]
        lib.gs_error_string.argtypes = [ctypes.c_int]
        lib.gs_error_string.restype = ctypes.c_char_p
    return libs


def lib_plan(lib, case, dev) -> dict:
    """A library's plan for a case: PLAN_KEYS where it writes them (a
    source older than the ring plan takes no window shape and writes the
    first three)."""
    out = (ctypes.c_int * len(cr.PLAN_KEYS))(*([-1] * len(cr.PLAN_KEYS)))
    if getattr(lib, "window_shape", True):
        code = lib.gs_cell_reduce_plan(
            case.wb, case.eb, cr.slot_bytes(case.wire, case.direction),
            case.vbp, dev.index, out)
    else:
        code = lib.gs_cell_reduce_plan(case.wb, case.vbp, dev.index, out)
    if code:
        return {"error": lib.gs_error_string(code).decode()}
    return {k: v for k, v in zip(cr.PLAN_KEYS, out) if v != -1}


def ids_of(kind: str, n: int, vb: int, seed: int):
    """(src, dst) of n edges: the Zipf stream, uniform ids or one hub."""
    if kind == "zipf":
        return make_stream(n, vb, seed=seed)
    if kind == "uniform":
        rng = np.random.default_rng(seed)
        return rng.integers(0, vb, n), rng.integers(0, vb, n)
    hub = np.full(n, 4242 % vb, np.int64)
    return hub, hub


class Case:
    """One call's inputs on the card and its outputs, launched through a
    library's C entry points."""

    def __init__(self, name, wb, eb, vb, direction, dev, kind="zipf",
                 wire="standard", egress="full", op="sum",
                 dtype=torch.int32, vbp=None):
        self.name, self.wb, self.eb, self.vb = name, wb, eb, vb
        self.vbp = vbp or vb + 1
        self.direction, self.wire, self.egress, self.op = (
            direction, wire, egress, op)
        self.dtype = dtype
        src, dst = ids_of(kind, wb * eb, vb, 7)
        rng = np.random.default_rng(3)
        val = (rng.integers(-1000, 1000, wb * eb).astype(np.int32)
               if dtype == torch.int32 else
               rng.standard_normal(wb * eb).astype(np.float32))
        rep = 2 if direction == "all" else 1
        self.rep = rep
        if wire == "compact":
            self.t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (src.astype(np.uint16).reshape(wb, eb),
                                     dst.astype(np.uint16).reshape(wb, eb),
                                     np.full(wb, eb, np.int32),
                                     val.reshape(wb, eb)))
        else:
            win = np.arange(wb * eb) // eb
            vtx = {"out": [src], "in": [dst], "all": [src, dst]}[direction]
            ids = np.concatenate([win * self.vbp + v for v in vtx])
            self.t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in (ids.astype(np.int32),
                                     np.concatenate([val] * rep)))
        self.cap = min(rep * eb, self.vbp)
        self.res, self.out = cr._outputs(wb, self.vbp, dtype, egress,
                                         self.cap, dev)
        self.dev = dev
        self.fields = {"case": name, "windows": wb, "eb": eb, "vb": vb,
                       "vbp": self.vbp, "direction": direction,
                       "ids": kind, "wire": wire, "egress": egress,
                       "op": op, "dtype": str(dtype).split(".")[-1]}

    def launch(self, lib) -> int:
        is_float = int(self.dtype == torch.float32)
        stream = kernels.stream_of(self.t[0])
        if self.wire == "compact":
            return lib.gs_cell_reduce_compact(
                *(x.data_ptr() for x in self.t), self.wb, self.eb,
                cr.DIRECTIONS[self.direction], self.vbp, cr.OPS[self.op],
                is_float, ctypes.byref(self.out), self.dev.index, stream)
        return lib.gs_cell_reduce(
            self.t[0].data_ptr(), self.t[1].data_ptr(), self.wb, self.eb,
            self.rep, self.vbp, cr.OPS[self.op], is_float,
            ctypes.byref(self.out), self.dev.index, stream)

    def outputs(self):
        return tuple(x.clone() for x in self.res)


def time_launches(case: Case, lib, reps: int) -> dict:
    """{device_ms, event_ms} of `reps` launches back to back after one
    warm-up; a refused launch reported by its error."""
    code = case.launch(lib)
    if code:
        return {"error": lib.gs_error_string(code).decode()}
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        case.launch(lib)
    end.record()
    end.synchronize()
    _wall, rows = device_times(lambda: [case.launch(lib)
                                        for _ in range(reps)])
    return {"device_ms": sum(ms / n for ms, n in rows.values()),
            "device_launches": sum(n for _ms, n in rows.values()),
            "event_ms": start.elapsed_time(end) / reps}


def cases(dev) -> list:
    out = []
    for shape, (eb, vb, direction) in (("main", MAIN), ("big", BIG)):
        for wb in (1, 8, 64):
            out.append(Case("%s W=%d" % (shape, wb), wb, eb, vb, direction,
                            dev))
        out.append(Case(shape + " compact", 64, eb, vb, direction, dev,
                        wire="compact"))
        out.append(Case(shape + " delta", 64, eb, vb, direction, dev,
                        egress="delta"))
        out.append(Case(shape + " float min", 64, eb, vb, direction, dev,
                        op="min", dtype=torch.float32))
        for kind in ("uniform", "hub"):
            out.append(Case("%s %s" % (shape, kind), 64, eb, vb, direction,
                            dev, kind=kind))
    # between the two: windows of 16384 slots, "out" and "all"
    for direction in ("out", "all"):
        out.append(Case("mid %s" % direction, 64, 16384, 16384, direction,
                        dev))
    # the record API's one-window call: eb = 8192 edges' sources over
    # the window's interned sources
    src, _dst = make_stream(8192, 65536, seed=7)
    n_seg = len(np.unique(src))
    out.append(Case("record API window", 1, 8192, n_seg - 1, "out", dev,
                    vbp=n_seg))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=None,
                        help="a csrc directory to build the other kernel "
                             "from")
    parser.add_argument("--elements", action="store_true",
                        help="also time builds without each element")
    parser.add_argument("--reps", type=int, default=REPS)
    args = parser.parse_args()
    import chip_smoke

    dev = torch.device("cuda", torch.cuda.current_device())
    builds = {"this": (None, ())}
    if args.source is not None:
        builds["other"] = (args.source, ())
    if args.elements:
        builds.update((name, (None, d)) for name, d in ELEMENTS.items())
    libs = load(builds)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    rows = []
    for case in cases(dev):
        row = dict(case.fields)
        row["plans"] = {name: lib_plan(lib, case, dev)
                        for name, lib in libs.items()}
        row["bound_ms"], row["bound_by"] = chip_smoke.bound(
            chip_smoke.cell_bytes(case.rep, case.wb, case.eb, case.vbp,
                                  case.wire), 2 * case.rep * case.wb
            * case.eb)
        # turns: the others, this, this, the others; outputs equal to
        # this kernel's (float sums aside)
        order = [n for n in libs if n != "this"]
        turns = order + ["this", "this"] + order[::-1]
        timed = {}
        want = None
        for name in turns:
            timed.setdefault(name, []).append(
                time_launches(case, libs[name], args.reps))
            got = case.outputs()
            if name == "this":
                want = got
            elif want is not None and not (case.dtype == torch.float32
                                           and case.op == "sum"):
                timed[name][-1]["equal"] = all(
                    torch.equal(a, b) for a, b in zip(got, want))
        for name, runs in timed.items():
            # a profile that lost the launches' device rows reads 0
            ok = [r for r in runs if "error" not in r
                  and r["device_launches"]]
            row[name] = {"runs": runs}
            if ok:
                for key in ("device_ms", "event_ms"):
                    row[name][key] = sum(r[key] for r in ok) / len(ok)
                row[name]["share_of_bound"] = (row["bound_ms"]
                                               / row[name]["device_ms"])
        rows.append(row)
        print(json.dumps({"progress": row["case"], "this": row["this"].get(
            "device_ms"), "other": row.get("other", {}).get("device_ms")}),
            flush=True)
    print(json.dumps({"card": card, "source": str(args.source),
                      "reps": args.reps, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
