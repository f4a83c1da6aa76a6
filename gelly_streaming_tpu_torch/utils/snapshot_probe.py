"""Where the snapshot kernel's and the union-find kernel's time goes on
the card: each timed alone, straight through its C entry point, so that
what a call costs once and what a window costs separate.

    python3 -m gelly_streaming_tpu_torch.utils.snapshot_probe \
        [--source DIR] [--cc-tiers]

Snapshot (csrc/window_snapshot.cu, `gs_window_snapshot`): all three
analytics on Zipf windows at eb=32768 from a carry with eight windows
folded, at the driver's vertex buckets vb = 4096 .. 65536, W = 1, 2, 4,
8, 16, 32, 64 windows a call, on full rows and on the delta wire at its
default cap; a least-squares line ms = fixed + per_window · W for each
(vb, form); and µs a window of 64-window calls at eb = 256, 4096 and
32768 at each vb (full rows).

Union-find (csrc/window_summary.cu, `gs_cc_fixpoint`) at the models'
sizes over the synthetic cit-HepPh stream: one merge window of 4096
edges (4097 slots) and its double cover (8193), the whole graph (65537
slots, 524288 edge slots) and its double cover (131073, 1048576), a
carried batch of 32768 edges at 32769 slots; uniform random edges over
65537 slots at ne = 2^15 .. 2^18 (where the plan's tiers cross); and
2^21 + 1 slots with 2^23 edges. Each with its plan (`gs_cc_plan`).

With `--cc-tiers`, the union-find's cases also in two builds that pin
its tier at every size (-DGS_PIN_CC_TIER=0, the cooperative grid, and
=1, the four launches): the measurement of the plan's threshold
(window_summary.cu kGridEdges).

Each timing is REPS launches back to back after one warm-up, each on
its own clone of the carry made before the timed run, timed with CUDA
events: the kernel's time on the card with the gaps between its own
launches, none of a wrapper's host time (a launch shorter than its
host call is timed at the host's rate). The union-find's calls are
also profiled (utils/profiling.device_times): device ms a call (each
kernel's mean over the launches the profile kept, summed over the
kernels, so a profile that drops a launch does not read low), the
device launches by kernel name. With `--source DIR`, the
kernels are built from DIR's window_snapshot.cu and window_summary.cu
(another commit's csrc, unpacked; the same C entry points) with the
port's nvcc flags. One JSON line on stdout, with the card's name and
power limit. Needs a CUDA device and nvcc.
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
from ..ops import delta_egress
from ..ops import segment as seg
from ..ops import window_snapshot as ws
from .profiling import device_times
from .streams import make_stream

REPS = 20
EB = 32768
LADDER = (1, 2, 4, 8, 16, 32, 64)
BUCKETS = (4096, 8192, 16384, 32768, 65536)
EB_SWEEP = (256, 4096, EB)
NAMES = ("window_snapshot", "window_summary")


def load(source: Path = None, defines: tuple = ()) -> dict:
    """{name: lib} of NAMES: the port's, or built with the nvcc flags
    `defines` added, from the .cu files of the csrc directory `source`
    (default the port's; its own headers beside them)."""
    if source is None and not defines:
        return {name: kernels.library(name) for name in NAMES}
    source = source or kernels.CSRC
    tag = hashlib.sha256(" ".join(defines).encode() + b"".join(
        f.read_bytes() for f in sorted(source.glob("*.cu*")))).hexdigest()
    out_dir = kernels.BUILD_DIR / ("probe-" + tag[:16])
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in NAMES:
        lib = out_dir / (name + ".so")
        if not lib.exists():
            procs[name] = subprocess.Popen(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, *defines, "-o",
                 str(lib), str(source / (name + ".cu"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError("nvcc %s %s:\n%s" % (name, defines, log))
    libs = {}
    for name in NAMES:
        libs[name] = ctypes.CDLL(str(out_dir / (name + ".so")))
        for fn, argtypes in kernels.SIGNATURES[name].items():
            if hasattr(libs[name], fn):     # an older csrc may lack one
                getattr(libs[name], fn).argtypes = argtypes
                getattr(libs[name], fn).restype = ctypes.c_int
        libs[name].gs_error_string.argtypes = [ctypes.c_int]
        libs[name].gs_error_string.restype = ctypes.c_char_p
    return libs


def _launches_ms(carries, launch) -> float:
    """ms per launch of `launch(carry)` over REPS clones of `carries`
    made before the timed run, launched back to back."""
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


def _stack(windows: int, vb: int, seed: int, dev, eb: int = EB):
    src, dst = make_stream(windows * eb, vb, seed=seed)
    _w, s, d, v = seg.window_stack(src, dst, eb, sentinel=vb)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (s, d, v))


class Snapshot:
    """One library's snapshot entry at vb, all three analytics, with its
    scratch and outputs for up to max(LADDER) windows."""

    def __init__(self, lib, vb: int, dev):
        self.lib, self.vb, self.dev = lib, vb, dev
        self.cap = delta_egress.egress_cap(EB, vb)
        w = max(LADDER)
        self.scratch = (torch.empty(3, vb, dtype=torch.int32, device=dev),
                        torch.empty(3, vb, dtype=torch.uint8, device=dev),
                        torch.empty(3, ws.MAX_BLOCKS, dtype=torch.int32,
                                    device=dev))
        self.rows = [torch.empty(w, vb, dtype=t, device=dev)
                     for t in (torch.int32, torch.int32, torch.bool)]
        self.cnt = torch.empty(3, w, dtype=torch.int32, device=dev)
        self.idx = torch.empty(3, w, self.cap, dtype=torch.int32, device=dev)
        self.vals = [torch.empty(w, self.cap, dtype=t, device=dev)
                     for t in (torch.int32, torch.int32, torch.bool)]

    def args(self, delta: bool):
        prev, chg, blocks = self.scratch
        a = ws._Args(prev=prev.data_ptr(), chg=chg.data_ptr(),
                     block_counts=blocks.data_ptr(),
                     max_blocks=ws.MAX_BLOCKS, cap=self.cap)
        if delta:
            a.cnt, a.idx = self.cnt.data_ptr(), self.idx.data_ptr()
            a.val_deg, a.val_labels, a.val_odd = (
                v.data_ptr() for v in self.vals)
        else:
            a.out_deg, a.out_labels, a.out_odd = (
                r.data_ptr() for r in self.rows)
        return a

    def launch(self, carry, src, dst, valid, delta: bool) -> int:
        a = self.args(delta)
        return self.lib.gs_window_snapshot(
            src.data_ptr(), dst.data_ptr(), valid.data_ptr(), src.shape[0],
            src.shape[1], self.vb, 7 | (16 if delta else 0),
            *(c.data_ptr() for c in carry), ctypes.addressof(a),
            self.dev.index, kernels.stream_of(src))


def snapshot_ladder(lib, vb: int, ladder, dev) -> list:
    """[{windows, full_ms, delta_ms}] at vb over `ladder`, from a carry
    with eight windows folded; a refused launch reported by its error."""
    snap = Snapshot(lib, vb, dev)
    carry = ws.engine_carry(vb, np.zeros(vb, np.int32),
                            np.arange(vb, dtype=np.int32),
                            np.arange(2 * vb, dtype=np.int32), dev)
    code = snap.launch(carry, *_stack(8, vb, 100, dev), False)
    if code:
        return [{"error": lib.gs_error_string(code).decode()}]
    chunk = _stack(max(ladder), vb, 200, dev)
    out = []
    for w in ladder:
        part = tuple(x[:w] for x in chunk)
        row = {"windows": w}
        for form, delta in (("full_ms", False), ("delta_ms", True)):
            row[form] = _launches_ms(
                carry, lambda c: snap.launch(c, *part, delta))
        out.append(row)
    torch.cuda.synchronize()
    return out


def window_us(lib, vb: int, eb: int, dev, windows: int = 64) -> float:
    """µs a window of a call of `windows` windows of eb slots at vb, full
    rows, from a carry with eight windows folded; a refused launch
    reported by its error."""
    snap = Snapshot(lib, vb, dev)
    carry = ws.engine_carry(vb, np.zeros(vb, np.int32),
                            np.arange(vb, dtype=np.int32),
                            np.arange(2 * vb, dtype=np.int32), dev)
    code = snap.launch(carry, *_stack(8, vb, 100, dev, eb), False)
    if code:
        return lib.gs_error_string(code).decode()
    chunk = _stack(windows, vb, 200, dev, eb)
    return 1e3 * _launches_ms(
        carry, lambda c: snap.launch(c, *chunk, False)) / windows


def fit(rows: list, key: str) -> dict:
    """The least-squares line ms = fixed + per_window · W."""
    w = np.array([r["windows"] for r in rows], float)
    ms = np.array([r[key] for r in rows], float)
    per, fixed = np.polyfit(w, ms, 1)
    return {"fixed_ms": float(fixed), "per_window_ms": float(per)}


def union_find_inputs(dev) -> list:
    """(label, labels0, src, dst, carried) at the models' sizes, from the
    synthetic cit-HepPh stream, padded as ops/unionfind pads them."""
    from ..ops import unionfind as uf
    from .realgraph import citation_stream

    src, dst, _ts = citation_stream()
    src, dst = src.astype(np.int32), dst.astype(np.int32)

    def fresh(s, d, n):
        eb, vb = seg.bucket_size(len(s)), seg.bucket_size(n)
        st, dt = uf._padded_edges(s, d, eb, vb, dev)
        return torch.arange(vb + 1, dtype=torch.int32, device=dev), st, dt

    cases = []
    m = slice(len(src) // 2, len(src) // 2 + 4096)
    uniq, (ws_, wd_) = seg.intern(src[m], dst[m])
    cases.append(("cc window",) + fresh(ws_, wd_, len(uniq)) + (False,))
    cs, cd = uf.double_cover_edges(ws_, wd_, len(uniq))
    cases.append(("bipartite window",) + fresh(cs, cd, 2 * len(uniq))
                 + (False,))
    n = int(max(src.max(), dst.max())) + 1
    cases.append(("cc graph",) + fresh(src, dst, n) + (False,))
    cs, cd = uf.double_cover_edges(src, dst, n)
    cases.append(("bipartite graph",) + fresh(cs, cd, 2 * n) + (False,))
    # a carried batch: the forest of the edges inside [0, 32768) up to
    # the stream's middle, then the next 32768 of them
    keep = (src < 32768) & (dst < 32768)
    ks, kd = src[keep], dst[keep]
    half = len(ks) // 2
    lab = uf.cc_fixpoint_plain(
        torch.arange(32769, dtype=torch.int32),
        torch.from_numpy(ks[:half]), torch.from_numpy(kd[:half]), False)
    bs, bd = ks[half:half + 32768], kd[half:half + 32768]
    cases.append(("carried batch", lab.to(dev),
                  torch.from_numpy(bs).to(dev), torch.from_numpy(bd).to(dev),
                  True))
    return cases


def union_find_ms(lib, cases, dev) -> list:
    out = []
    for label, lab0, s, d, carried in cases:
        res = torch.empty_like(lab0)
        stream = kernels.stream_of(lab0)

        def launch(_c):
            return lib.gs_cc_fixpoint(
                lab0.data_ptr(), lab0.shape[0], s.data_ptr(), d.data_ptr(),
                s.shape[0], int(carried), res.data_ptr(), dev.index, stream)

        row = {"case": label, "slots": int(lab0.shape[0]),
               "edges": int(s.shape[0]), "carried": carried}
        code = launch(None)
        if code:
            row["error"] = lib.gs_error_string(code).decode()
        else:
            row["ms"] = _launches_ms((lab0,), launch)
            _wall, rows = device_times(
                lambda: [launch(None) for _ in range(REPS)])
            row["device_ms"] = sum(ms / n for ms, n in rows.values())
            row["device_launches"] = {k: n for k, (_ms, n) in rows.items()}
        out.append(row)
    return out


def random_case(label: str, n: int, ne: int, dev) -> tuple:
    """(label, labels0, src, dst, carried): ne uniform random edges over
    n fresh slots."""
    rng = np.random.default_rng(ne)
    s, d = (torch.from_numpy(rng.integers(0, n, ne).astype(np.int32)).to(dev)
            for _ in range(2))
    return (label, torch.arange(n, dtype=torch.int32, device=dev), s, d,
            False)


def extra_cases(dev) -> list:
    """The union-find's random cases: where its tiers cross, and large."""
    return ([random_case("random %d" % ne, 65537, ne, dev)
             for ne in (1 << 15, 1 << 16, 1 << 17, 1 << 18)]
            + [random_case("large", (1 << 21) + 1, 1 << 23, dev)])


def uf_plan(lib, case, dev) -> dict:
    """The union-find's plan for a case, where the source has it."""
    if not hasattr(lib, "gs_cc_plan"):
        return None
    out = (ctypes.c_int * 2)()
    kernels.check("window_summary", lib.gs_cc_plan(
        case[1].shape[0], case[2].shape[0], dev.index, out))
    return {"tier": out[0], "blocks": out[1]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--source", type=Path, default=None,
                        help="a csrc directory to build the kernels from")
    parser.add_argument("--cc-tiers", action="store_true",
                        help="also time the union-find pinned to each tier")
    args = parser.parse_args()
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = load(args.source)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    out = {"card": card, "source": str(args.source or kernels.CSRC),
           "snapshot": [], "union_find": []}
    snap = libs["window_snapshot"]
    for vb in BUCKETS:
        ladder = LADDER if vb in (8192, 65536) else (1, 8, 64)
        rows = snapshot_ladder(snap, vb, ladder, dev)
        entry = {"vb": vb, "eb": EB, "ladder": rows,
                 "us_a_window": {eb: window_us(snap, vb, eb, dev)
                                 for eb in EB_SWEEP}}
        if "error" not in rows[0]:
            entry["fit_full"] = fit(rows, "full_ms")
            entry["fit_delta"] = fit(rows, "delta_ms")
        out["snapshot"].append(entry)
    cases = union_find_inputs(dev) + extra_cases(dev)
    out["union_find"] = union_find_ms(libs["window_summary"], cases, dev)
    for row, case in zip(out["union_find"], cases):
        row["plan"] = uf_plan(libs["window_summary"], case, dev)
    if args.cc_tiers:
        for tier in (0, 1):
            lib = load(args.source, ("-DGS_PIN_CC_TIER=%d" % tier,))
            out["union_find_tier_%d" % tier] = union_find_ms(
                lib["window_summary"], cases, dev)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
