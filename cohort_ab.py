"""Tenant edges/s of the disarmed `TenantCohort` path of one checkout of
the port, and where its host time goes, for an A/B of two checkouts in
one call on one card.

    python3 cohort_ab.py [--root DIR] [--passes 10] [--profile]
        [--frozen-knobs]

Imports `chip_smoke` and `gelly_streaming_tpu_torch` from DIR (default:
the checkout this file is in), so it also measures a checkout that
predates it. With every GS_* knob unset but GS_AUTOTUNE=0 it serves
chip_smoke's cohort (`serve_cohort(cohort_streams())`: 64 tenants, 8 of
them at vb=65536, about 8.3M tenant edges through
`TenantCohort(4096, 8192)`) once to warm up, then in `passes` passes
(host clock around each, ending in a synchronize), and prints one JSON
line: the walls, the pumps of a pass, tenant edges/s of the
best and of the summed walls, and a digest of the summaries, so two
checkouts can be held equal. `--profile` adds one more pass under
cProfile: the calls of and seconds inside `feed` and `pump`, the calls and
seconds of the knob registry's environment reads, and the functions
with the most own seconds, and the own seconds summed by source file.
cProfile slows every Python call, so read its seconds as shares, and
the walls of the plain passes as times. `--frozen-knobs` reads the
environment once at start-up and answers every later knob read from
that copy: the difference from a run without it is what the live knob
reads cost. Run it as parent, change, change, parent in one call and
compare within that call only. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import cProfile
import hashlib
import json
import os
import pstats
import sys
import time


def _profile(chip_smoke, streams, torch) -> dict:
    """One disarmed pass under cProfile, summarised."""
    prof = cProfile.Profile()
    torch.cuda.synchronize()
    prof.enable()
    chip_smoke.serve_cohort(streams)
    torch.cuda.synchronize()
    prof.disable()
    st = pstats.Stats(prof).stats     # (file, line, fn) -> (cc, nc, tt, ct, _)
    total = sum(tt for _cc, _nc, tt, _ct, _c in st.values())

    def where(key):
        path, line, fn = key
        return "%s:%d(%s)" % (os.path.basename(path), line, fn)

    def pick(path_end, fn):
        return [v for k, v in st.items()
                if k[0].endswith(path_end) and k[2] == fn]

    def cum(path_end, fn):
        return sum(ct for _cc, _nc, _tt, ct, _c in pick(path_end, fn))

    knob_reads = pick(os.path.join("utils", "knobs.py"), "_raw")
    top = sorted(st.items(), key=lambda kv: -kv[1][2])[:25]
    by_file: dict = {}
    for (path, _line, _fn), (_cc, _nc, tt, _ct, _c) in st.items():
        name = os.path.basename(path)
        by_file[name] = by_file.get(name, 0.0) + tt
    return {
        "profiled_s": total,
        "feeds": sum(nc for _cc, nc, _tt, _ct, _c in pick(
            os.path.join("core", "tenancy.py"), "feed")),
        "feed_s": cum(os.path.join("core", "tenancy.py"), "feed"),
        "pump_s": cum(os.path.join("core", "tenancy.py"), "pump"),
        "knob_reads": sum(nc for _cc, nc, _tt, _ct, _c in knob_reads),
        "knob_read_s": sum(ct for _cc, _nc, _tt, ct, _c in knob_reads),
        "top_own_s": [[where(k), v[1], v[2]] for k, v in top],
        "own_s_by_file": dict(sorted(by_file.items(),
                                     key=lambda kv: -kv[1])[:20]),
    }


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--passes", type=int, default=10)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--frozen-knobs", action="store_true")
    args = ap.parse_args()
    for k in [k for k in os.environ if k.startswith("GS_")]:
        del os.environ[k]
    os.environ["GS_AUTOTUNE"] = "0"
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import chip_smoke
    import gelly_streaming_tpu_torch as gs

    if args.frozen_knobs:
        from gelly_streaming_tpu_torch.utils import knobs

        env = {k: v for k, v in os.environ.items() if v != ""}
        knobs._raw = env.get

    streams = chip_smoke.cohort_streams()
    total = sum(len(s) for s, _d, _v in streams.values())
    digest = hashlib.sha256()
    chip_smoke.serve_cohort(streams)
    walls = []
    for _ in range(args.passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _co, secs = chip_smoke.serve_cohort(streams)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        digest.update(repr(sorted(out.items())).encode())
    row = {
        "root": args.root, "package": os.path.dirname(gs.__file__),
        "frozen_knobs": args.frozen_knobs,
        "walls_s": walls, "pumps": secs["pumps"],
        "feed_s": secs["feed"], "pump_s": secs["pump"],
        "best_tenant_edges_per_s": total / min(walls),
        "tenant_edges_per_s": total * len(walls) / sum(walls),
        "digest": digest.hexdigest(),
        "device": torch.cuda.get_device_name(0)}
    if args.profile:
        row["profile"] = _profile(chip_smoke, streams, torch)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
