"""Edges/s of the static stream paths of one checkout of the port, for an
A/B of two checkouts in one call on one card.

    python3 gelly_streaming_tpu_torch/utils/stream_ab.py [--root DIR]
        [--passes 8]

Imports `gelly_streaming_tpu_torch` from DIR (default: the checkout this
file is in), so it also measures a checkout that predates it. With
GS_AUTOTUNE=0 (the static configuration) it times
`TriangleWindowKernel(32768, 65536).count_stream` and
`StreamSummaryEngine(32768, 65536).process` over the bench stream
`make_stream(10_485_760, 65_536, seed=7)`, after one warm pass each, in
`passes` alternating passes (host clock around each pass, ending in a
synchronize), and prints one JSON line: the walls, edges/s of the summed
walls, and a digest of the counts and summaries, so two checkouts can be
held equal. Run it as parent, change, change, parent in one call and
compare within that call only. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

EDGES = 10_485_760
EB, VB = 32768, 65536


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--passes", type=int, default=8)
    args = ap.parse_args()
    os.environ["GS_AUTOTUNE"] = "0"
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import gelly_streaming_tpu_torch as gs

    src, dst = gs.make_stream(EDGES, VB, seed=7)
    kern = gs.TriangleWindowKernel(EB, VB)
    eng = gs.StreamSummaryEngine(EB, VB)
    eng.warm_fallback()
    digest = hashlib.sha256()

    def tri():
        out = kern.count_stream(src, dst)
        digest.update(repr(out).encode())

    def summ():
        eng.reset()
        out = eng.process(src, dst)
        digest.update(repr(out).encode())

    walls = {"triangle": [], "summary": []}
    for name, run in (("triangle", tri), ("summary", summ)):
        run()
    for _ in range(args.passes):
        for name, run in (("triangle", tri), ("summary", summ)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    print(json.dumps({
        "root": args.root, "package": os.path.dirname(gs.__file__),
        "walls_s": walls,
        "edges_per_s": {k: EDGES * len(v) / sum(v) for k, v in walls.items()},
        "digest": digest.hexdigest(),
        "device": torch.cuda.get_device_name(0)}))


if __name__ == "__main__":
    main()
