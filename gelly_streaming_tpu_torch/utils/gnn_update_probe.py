"""Where the GNN round's time goes on the card: a probe of one
`gnn_round.cu` source, built as it is and with one block of its code
taken out.

    python3 -m gelly_streaming_tpu_torch.utils.gnn_update_probe \\
        [--source csrc/gnn_round.cu] [--skip MARKER] [--feature-dim 64]

It compiles the source twice with the port's nvcc flags (kernels.py):
as it is, and with the block that opens on the first line holding
MARKER removed up to its matching brace (the product loop, say, so the
update runs its loads, epilogue and stores with a zero accumulator).
Each build is loaded through `gs_gnn_rounds` and run on a 64-window
Zipf chunk at eb=32768, vb=65536 (make_stream(64·eb, vb, seed=11), the
slab default_features(vb, F, seed=0), sparse snapped weights that keep
the slab between saturation and death), and on a chunk of 64 empty
windows (the hold rule: the update only reads the slab's summaries).
Printed, per build: ptxas's registers, shared memory and spills; the
whole call's ms per chunk (CUDA events); each kernel's µs per launch
from torch.profiler. The unmodified build is checked bit-equal to
`gnn_rounds_plain` first. One JSON line on stdout. Needs a CUDA device
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .. import kernels
from ..ops import gnn_round as gr
from ..ops import gnn_window as gw
from ..ops import segment as seg
from .profiling import device_times
from .streams import make_stream

EB, VB, CHUNK = 32768, 65536, 64


def strip_block(text: str, marker: str) -> str:
    """`text` without the brace block that opens on the first line
    holding `marker` (that line through the line of its matching
    closing brace)."""
    lines = text.splitlines(keepends=True)
    start = next((i for i, ln in enumerate(lines) if marker in ln), None)
    if start is None:
        raise ValueError("marker %r not in the source" % marker)
    depth, opened = 0, False
    for end in range(start, len(lines)):
        for ch in lines[end]:
            if ch == "{":
                depth, opened = depth + 1, True
            elif ch == "}":
                depth -= 1
        if opened and depth == 0:
            return "".join(lines[:start] + lines[end + 1:])
    raise ValueError("unbalanced braces after marker %r" % marker)


def build(source: Path, text: str, tag: str) -> tuple:
    """Compile `text` (the source, maybe edited) into a library under
    the build directory; returns (path, ptxas lines)."""
    out_dir = kernels.BUILD_DIR / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / ("gnn_round_%s.cu" % tag)
    cu.write_text(text)
    lib = out_dir / ("gnn_round_%s.so" % tag)
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", str(source.parent),
           "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError("nvcc failed:\n" + proc.stdout + proc.stderr)
    ptxas = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
             if "registers" in ln or "spill" in ln]
    return lib, ptxas


def weights(F: int, seed: int = 3):
    """Each output feature one input minus another, plus a bias in
    [-12, -3) units (as chip_smoke.py's GNN fixtures)."""
    rng = np.random.RandomState(seed)
    W = np.zeros((F, F))
    for j in range(F):
        a, b = rng.choice(F, 2, replace=False)
        W[a, j], W[b, j] = 1, -1
    return gw.snap_weights(W / 32, rng.randint(-12, -3, F) / 32, F)


def kernel_us(run) -> dict:
    """µs per launch of each device kernel over one run()."""
    _wall, by_name = device_times(run)
    return {k: {"launches": n, "us_per_launch": 1e3 * ms / n}
            for k, (ms, n) in by_name.items()}


def probe(lib_path: Path, F: int, check: bool, marks: bool) -> dict:
    """Times (and, with `check`, checks) one build; `marks`: its
    gs_gnn_rounds takes the uint8 row-mark scratch after m (sources
    before the marks took one pointer fewer)."""
    lib = ctypes.CDLL(str(lib_path))
    fn = lib.gs_gnn_rounds
    argtypes = list(kernels.SIGNATURES["gnn_round"]["gs_gnn_rounds"])
    if not marks:
        del argtypes[13]
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    dev = torch.device("cuda", torch.cuda.current_device())
    src, dst = make_stream(CHUNK * EB, VB, seed=11)
    _n, s, d, v = seg.window_stack(src, dst, EB, sentinel=VB)
    st, dt, vt = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in (s, d, v))
    empty = torch.zeros_like(vt)
    W, b = (torch.from_numpy(x).to(dev) for x in weights(F))
    h0 = torch.from_numpy(gw.default_features(VB, F, seed=0)).to(dev)
    h = h0.clone()
    scratch = [torch.zeros_like(h)]
    if marks:
        scratch.append(torch.zeros(VB + 1, dtype=torch.uint8, device=dev))
    sums = torch.empty(4, CHUNK, dtype=torch.int32, device=dev)

    def call(valid):
        code = fn(h.data_ptr(), W.data_ptr(), b.data_ptr(), st.data_ptr(),
                  dt.data_ptr(), valid.data_ptr(), CHUNK, EB, VB, F,
                  gr.ACTIVATIONS["relu"], gr.agg_shift(EB),
                  *(t.data_ptr() for t in scratch),
                  sums.data_ptr(), dev.index,
                  torch.cuda.current_stream(dev).cuda_stream)
        if code:
            raise RuntimeError("gs_gnn_rounds: CUDA error %d" % code)

    res = {}
    if check:
        call(vt)
        ph, psums = h0.clone(), torch.empty_like(sums)
        gr.gnn_rounds_plain(ph, W, b, st, dt, vt, "relu", psums)
        res["equal_to_plain"] = bool(torch.equal(h, ph)
                                     and torch.equal(sums, psums))
    for name, valid in (("zipf", vt), ("held", empty)):
        h.copy_(h0)
        call(valid)                                   # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        reps = 5
        start.record()
        for _ in range(reps):
            call(valid)
        end.record()
        end.synchronize()
        h.copy_(h0)
        res[name] = {"ms_per_chunk": start.elapsed_time(end) / reps,
                     "kernels": kernel_us(lambda: call(valid))}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=str(kernels.CSRC / "gnn_round.cu"))
    ap.add_argument("--skip", default="for (int k0 = 0; k0 < F;",
                    help="the block to take out opens on the first line "
                         "holding this text")
    ap.add_argument("--feature-dim", type=int, default=64)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gnn_update_probe: no CUDA device", file=sys.stderr)
        return 2
    source = Path(args.source).resolve()
    text = source.read_text()
    head = text[text.index("gs_gnn_rounds("):]
    marks = "touched" in head[:head.index(")")]
    report = {"source": args.source, "skip": args.skip,
              "feature_dim": args.feature_dim, "eb": EB, "vb": VB,
              "windows": CHUNK, "device": torch.cuda.get_device_name(0)}
    for tag, body, check in (("full", text, True),
                             ("no_product", strip_block(text, args.skip),
                              False)):
        lib, ptxas = build(source, body, tag)
        report[tag] = {"ptxas": ptxas, **probe(lib, args.feature_dim,
                                               check, marks)}
    print(json.dumps(report))
    if not report["full"]["equal_to_plain"]:
        print("gnn_update_probe: the build differs from plain",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
