"""The A/B rows the measured-adoption routing reads (utils/evidence.py),
measured on the device this runs on and written under its name.

    python3 -m gelly_streaming_tpu_torch.utils.evidence_ab --out PATH
        [--windows 64]

The port's counterpart of the A/B sections of the JAX package's
tools/profile_kernels.py, with their sections' keys. At full width (the
bench stream's buckets: eb=32768 and vb=65536, make_stream(..., seed=7);
the cohort at its own, eb=4096 and vb=8192) over `--windows` windows
(the depth), with GS_AUTOTUNE=0 so each lever is measured alone:

- `host_stream`: TriangleWindowKernel's device tier, the numpy counter
  and the C++ counter, at eb 8192 and 32768;
- `ingress_ab`: count_stream on the standard and the compact wire;
- `window`: count_stream at K 32, 64 and 128 (`k_sweep`, with the
  overflow recounts each K paid), then at the fastest K with 16, 32
  and 64 windows a call (`chunk_sweep`), at eb 8192 and 32768;
- `egress_ab`: the driver's scan tier and the windowed reduce on full
  rows and on the delta wire;
- `resident_ab`: the driver on the resident, scan and native tiers and
  fed a window a call (`perwindow`), and ResidentSummaryEngine beside
  StreamSummaryEngine;
- `tenancy_ab`: a TenantCohort on its resident tier beside one
  StreamSummaryEngine a tenant, in turn (`cohort_resident`);
- `host_reduce`: WindowedEdgeReduce "sum" on its device, host and
  native tiers, at eb 8192 and 32768;
- `sharded_table`: ShardedTriangleWindowKernel in both table modes on
  a mesh (one NCCL rank of its own where none is given).

Every row holds its arms' results equal first (exact, the reduce's float
sums aside: its values are integers) and raises AssertionError where
they differ, before anything is timed. Then the arms run in turns, three
turns after one warm pass, and the row keeps each arm's median seconds
and its spread (`<arm>_s`, `<arm>_s_min`, `<arm>_s_max`) and the rates
of the medians. The file at `--out` keeps every other device's rows; it
is written only where `--out` names it. Needs a CUDA device, nvcc and
g++ (the native library); `run(device="cpu")` measures the CPU's rows.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import statistics
import sys
import time

import numpy as np
import torch

EB, VB = 32768, 65536              # the bench stream's buckets
BUCKETS = (8192, 32768)            # host_stream, window, host_reduce
K_SWEEP = (32, 64, 128)
CHUNK_SWEEP = (16, 32, 64)
CO_EB, CO_VB, CO_TENANTS = 4096, 8192, 8
SEED = 7
TURNS = 3
SECTIONS = ("host_stream", "ingress_ab", "window", "egress_ab",
            "resident_ab", "tenancy_ab", "host_reduce", "sharded_table")


@contextlib.contextmanager
def knob_env(**pins):
    """The GS_* knobs set for the scope, restored after."""
    old = {k: os.environ.get(k) for k in pins}
    os.environ.update({k: str(v) for k, v in pins.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def turns(arms: dict, dev) -> dict:
    """{arm: (median, min, max) seconds} of each fn in `arms`, run in
    turns TURNS times after the warm pass the caller made."""
    times = {name: [] for name in arms}
    for _ in range(TURNS):
        for name, fn in arms.items():
            _sync(dev)
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            times[name].append(time.perf_counter() - t0)
    return {name: (statistics.median(ts), min(ts), max(ts))
            for name, ts in times.items()}


def dispersion(row: dict, stats: dict, n: int) -> None:
    """Each arm's median, min and max seconds and the rate of its
    median (`<arm>_edges_per_s`)."""
    for name, (med, lo, hi) in stats.items():
        row["%s_s" % name] = round(med, 6)
        row["%s_s_min" % name] = round(lo, 6)
        row["%s_s_max" % name] = round(hi, 6)
        row["%s_edges_per_s" % name] = round(n / med)


def speedups(row: dict, stats: dict, base: str, alt: str) -> None:
    """`speedup` (base median over alt median), and its pessimistic and
    optimistic pairings over the spread."""
    b, a = stats[base], stats[alt]
    row["speedup"] = round(b[0] / a[0], 4)
    row["speedup_worst"] = round(b[1] / a[2], 4)
    row["speedup_best"] = round(b[2] / a[1], 4)


def same(label: str, want, got) -> None:
    if want != got:
        raise AssertionError("evidence_ab: %s: the arms disagree" % label)


def digest_windows(results) -> str:
    """sha256 of a driver's WindowResults: every scalar and array."""
    h = hashlib.sha256()
    for r in results:
        h.update(repr((r.window_start, r.num_edges, r.triangles)).encode())
        for f in ("vertex_ids", "degrees", "cc_labels", "bipartite_odd"):
            a = getattr(r, f)
            h.update(b"-" if a is None else np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def digest_rows(rows) -> str:
    """sha256 of a reduce's (cells, counts) rows, cells where counted."""
    h = hashlib.sha256()
    for cells, counts in rows:
        h.update(np.asarray(counts, np.int64).tobytes())
        h.update(np.asarray(cells[counts > 0], np.int64).tobytes())
    return h.hexdigest()


class Writer:
    """The rows of one device: `measure(section)` fills `sections`."""

    def __init__(self, device=None, windows: int = 64, mesh=None, log=None):
        from ..core.platform import resolve_device
        from . import evidence

        self.dev = resolve_device(device)
        self.label = evidence.device_label(self.dev)
        self.windows = int(windows)
        self.mesh = mesh
        self.log = log or (lambda msg: None)
        self.sections = {}
        self.seconds = {}
        self._streams = {}

    def stream(self, eb: int) -> tuple:
        key = (eb, VB)
        if key not in self._streams:
            from .streams import make_stream

            s, d = make_stream(self.windows * eb, VB, seed=SEED)
            self._streams[key] = (s.astype(np.int32), d.astype(np.int32))
        return self._streams[key]

    def measure(self, section: str) -> None:
        t0 = time.perf_counter()
        with knob_env(GS_AUTOTUNE=0):
            self.sections[section] = getattr(self, section)()
        self.seconds[section] = round(time.perf_counter() - t0, 3)
        self.log("evidence_ab %s: %.1f s" % (section, self.seconds[section]))

    # ---- triangles ---------------------------------------------------
    def _kernel(self, eb, **kw):
        from ..ops import triangles as tri

        kw.setdefault("k_bucket", tri.default_kb(eb))
        kw.setdefault("ingress", "standard")
        kern = tri.TriangleWindowKernel(eb, VB, device=self.dev,
                                        stream_tier="device", **kw)
        # the sweeps' anchor is the class default, never a tuned chunk
        kern.MAX_STREAM_WINDOWS = tri.TriangleWindowKernel.MAX_STREAM_WINDOWS
        return kern

    def host_stream(self) -> list:
        from .. import native
        from ..ops import host_triangles
        from ..ops import triangles as tri

        rows = []
        for eb in BUCKETS:
            s, d = self.stream(eb)
            kern = self._kernel(eb)
            arms = {"device": lambda: kern._count_stream_device(s, d),
                    "host": lambda: host_triangles.count_stream(s, d, eb)}
            if native.triangles_available():
                arms["native"] = lambda: tri._native_count_stream_parallel(
                    s, d, eb)
            got = {name: fn() for name, fn in arms.items()}
            same("host_stream eb=%d" % eb, got["device"], got["host"])
            row = {"edge_bucket": eb, "vertex_bucket": VB,
                   "windows": self.windows, "parity": True}
            if "native" in got:
                same("host_stream native eb=%d" % eb, got["device"],
                     got["native"])
                row["native_parity"] = True
            stats = turns(arms, self.dev)
            dispersion(row, stats, len(s))
            row["host_vs_device"] = round(stats["device"][0]
                                          / stats["host"][0], 4)
            rows.append(row)
        return rows

    def ingress_ab(self) -> list:
        s, d = self.stream(EB)
        k_std = self._kernel(EB, ingress="standard")
        k_cmp = self._kernel(EB, ingress="compact")
        arms = {"std": lambda: k_std._count_stream_device(s, d),
                "compact": lambda: k_cmp._count_stream_device(s, d)}
        got = {name: fn() for name, fn in arms.items()}
        same("ingress_ab", got["std"], got["compact"])
        row = {"probe": "stream_ab", "backend": self.label,
               "num_edges": len(s), "eb": EB, "vb": VB, "k": k_std.kb,
               "windows_per_dispatch": k_std.MAX_STREAM_WINDOWS,
               "parity": True}
        stats = turns(arms, self.dev)
        dispersion(row, stats, len(s))
        speedups(row, stats, "std", "compact")
        return [row]

    def window(self) -> list:
        rows = []
        for eb in BUCKETS:
            s, d = self.stream(eb)
            kernels = {kb: self._kernel(eb, k_bucket=kb) for kb in K_SWEEP}
            recounts = {}
            want = None
            for kb, kern in kernels.items():
                counted = [0]
                plain_count = kern.count

                def count(*a, _f=plain_count, _n=counted, **kw):
                    _n[0] += 1
                    return _f(*a, **kw)

                kern.count = count
                got = kern._count_stream_device(s, d)   # warm + recounts
                kern.count = plain_count
                recounts[kb] = counted[0]
                want = got if want is None else want
                same("window eb=%d K=%d" % (eb, kb), want, got)
            stats = turns({kb: (lambda k=k: k._count_stream_device(s, d))
                           for kb, k in kernels.items()}, self.dev)
            dkb = self._kernel(eb).kb           # the analytic default's
            row = {"edge_bucket": eb, "vertex_bucket": VB,
                   "windows": self.windows, "k_sweep": []}
            for kb, kern in kernels.items():
                row["k_sweep"].append({
                    "k_bucket": kern.kb, "default": kern.kb == dkb,
                    "per_window_ms": round(stats[kb][0] / self.windows
                                           * 1e3, 4),
                    "per_window_ms_min": round(stats[kb][1] / self.windows
                                               * 1e3, 4),
                    "per_window_ms_max": round(stats[kb][2] / self.windows
                                               * 1e3, 4),
                    "edges_per_s": round(len(s) / stats[kb][0]),
                    "overflow_recounts_per_run": recounts[kb]})
            best = min(row["k_sweep"], key=lambda r: r["per_window_ms"])
            kern = kernels[best["k_bucket"]]
            row["chunk_sweep_k"] = kern.kb
            chunks = {}
            for cs in CHUNK_SWEEP:
                chunk = self._kernel(eb, k_bucket=kern.kb)
                chunk.MAX_STREAM_WINDOWS = cs
                same("window eb=%d chunk=%d" % (eb, cs), want,
                     chunk._count_stream_device(s, d))
                chunks[cs] = chunk
            stats = turns({cs: (lambda k=k: k._count_stream_device(s, d))
                           for cs, k in chunks.items()}, self.dev)
            row["chunk_sweep"] = [{
                "windows_per_dispatch": cs,
                "default": cs == kern.MAX_STREAM_WINDOWS,
                "per_window_ms": round(stats[cs][0] / self.windows * 1e3, 4),
                "per_window_ms_min": round(stats[cs][1] / self.windows
                                           * 1e3, 4),
                "per_window_ms_max": round(stats[cs][2] / self.windows
                                           * 1e3, 4),
                "edges_per_s": round(len(s) / stats[cs][0])}
                for cs in CHUNK_SWEEP]
            rows.append(row)
        return rows

    # ---- the driver and the reduce ------------------------------------
    def _driver(self, **kw):
        from ..core.driver import StreamingAnalyticsDriver

        kw.setdefault("egress", "full")
        return StreamingAnalyticsDriver(window_ms=1, edge_bucket=EB,
                                        vertex_bucket=VB, device=self.dev,
                                        **kw)

    @staticmethod
    def _drive(drv, s, d, per_window: bool = False):
        drv.reset()
        if not per_window:
            return drv.run_arrays(s, d)
        out = []
        for at in range(0, len(s), drv.eb):
            out.extend(drv.run_arrays(s[at:at + drv.eb], d[at:at + drv.eb]))
        return out

    def _reduce(self, eb, **kw):
        from ..ops.windowed_reduce import WindowedEdgeReduce

        kw.setdefault("tier", "device")
        kw.setdefault("ingress", "standard")
        kw.setdefault("egress", "full")
        return WindowedEdgeReduce(VB, eb, "sum", "out", device=self.dev,
                                  **kw)

    @staticmethod
    def _values(s, d) -> np.ndarray:
        return (1 + (s.astype(np.int64) + 3 * d) % 97).astype(np.int32)

    def egress_ab(self) -> list:
        from ..ops import delta_egress

        s, d = self.stream(EB)
        drivers = {e: self._driver(snapshot_tier="scan", egress=e)
                   for e in ("full", "delta")}
        got = {e: digest_windows(self._drive(drv, s, d))
               for e, drv in drivers.items()}
        same("egress_ab driver", got["full"], got["delta"])
        stats = turns({e: (lambda drv=drv: self._drive(drv, s, d))
                       for e, drv in drivers.items()}, self.dev)
        row = {"probe": "driver_ab", "backend": self.label,
               "num_edges": len(s), "eb": EB, "vb": VB,
               "cap": delta_egress.egress_cap(EB, VB), "parity": True}
        dispersion(row, stats, len(s))
        speedups(row, stats, "full", "delta")
        rows = [row]
        val = self._values(s, d)
        reduces = {e: self._reduce(EB, egress=e) for e in ("full", "delta")}
        got = {e: digest_rows(r.process_stream(s, d, val))
               for e, r in reduces.items()}
        same("egress_ab reduce", got["full"], got["delta"])
        stats = turns({e: (lambda r=r: r.process_stream(s, d, val))
                       for e, r in reduces.items()}, self.dev)
        row = {"probe": "reduce_ab", "backend": self.label,
               "num_edges": len(s), "eb": EB, "vb": VB,
               "cap": reduces["delta"]._delta_cap(), "parity": True}
        dispersion(row, stats, len(s))
        speedups(row, stats, "full", "delta")
        rows.append(row)
        return rows

    def resident_ab(self) -> list:
        from .. import native
        from ..ops import resident_engine
        from ..ops.resident_engine import ResidentSummaryEngine
        from ..ops.scan_analytics import StreamSummaryEngine

        s, d = self.stream(EB)
        arms = {"resident": (self._driver(snapshot_tier="resident"), False),
                "scan": (self._driver(snapshot_tier="scan"), False),
                "perwindow": (self._driver(snapshot_tier="scan"), True)}
        if native.snapshot_available():
            arms["native"] = (self._driver(snapshot_tier="native"), False)
        got = {name: digest_windows(self._drive(drv, s, d, pw))
               for name, (drv, pw) in arms.items()}
        for name in got:
            same("resident_ab driver %s" % name, got["scan"], got[name])
        stats = turns({name: (lambda drv=drv, pw=pw:
                              self._drive(drv, s, d, pw))
                       for name, (drv, pw) in arms.items()}, self.dev)
        row = {"probe": "driver_resident", "backend": self.label,
               "num_edges": len(s), "eb": EB, "vb": VB,
               "superbatch": resident_engine.resident_spb(EB),
               "ring_slots": resident_engine.ring_slots(), "parity": True}
        dispersion(row, stats, len(s))
        speedups(row, stats, "perwindow", "resident")
        row["speedup_vs_scan"] = round(stats["scan"][0]
                                       / stats["resident"][0], 4)
        rows = [row]
        engines = {"resident": ResidentSummaryEngine(EB, VB, device=self.dev),
                   "scan": StreamSummaryEngine(EB, VB, device=self.dev)}

        def run(eng):
            eng.reset()
            return eng.process(s, d)

        got = {name: run(eng) for name, eng in engines.items()}
        same("resident_ab engine", got["scan"], got["resident"])
        stats = turns({name: (lambda e=eng: run(e))
                       for name, eng in engines.items()}, self.dev)
        row = {"probe": "engine_resident", "backend": self.label,
               "num_edges": len(s), "eb": EB, "vb": VB,
               "superbatch": resident_engine.resident_spb(EB),
               "parity": True}
        dispersion(row, stats, len(s))
        speedups(row, stats, "scan", "resident")
        rows.append(row)
        return rows

    def tenancy_ab(self) -> list:
        from ..core.tenancy import TenantBackpressure, TenantCohort
        from ..ops.scan_analytics import StreamSummaryEngine
        from .streams import make_stream

        per = max(2, self.windows // CO_TENANTS)
        streams = {}
        for i in range(CO_TENANTS):
            s, d = make_stream(per * CO_EB - CO_EB // 8 * (i % 3), CO_VB,
                               seed=100 + i)
            streams["t%02d" % i] = (s.astype(np.int32), d.astype(np.int32))
        total = sum(len(s) for s, _d in streams.values())

        def cohort():
            with knob_env(GS_COHORT_RESIDENT="on"):
                co = TenantCohort(CO_EB, CO_VB, device=self.dev)
                out = {tid: [] for tid in streams}
                cur = dict.fromkeys(streams, 0)
                for tid in streams:
                    co.admit(tid)
                while any(cur[t] < len(s) for t, (s, _d) in streams.items()):
                    for tid, (s, d) in streams.items():
                        while cur[tid] < len(s):
                            c = cur[tid]
                            try:
                                co.feed(tid, s[c:c + 5000], d[c:c + 5000])
                            except TenantBackpressure:
                                break
                            cur[tid] = min(len(s), c + 5000)
                    for tid, res in co.pump().items():
                        out[tid].extend(res)
                for tid in streams:
                    out[tid].extend(co.close(tid))
                return out

        eng = StreamSummaryEngine(CO_EB, CO_VB, device=self.dev)

        def sequential():
            out = {}
            for tid, (s, d) in streams.items():
                eng.reset()
                out[tid] = eng.process(s, d)
            return out

        got, want = cohort(), sequential()
        same("tenancy_ab cohort_resident", want, got)
        stats = turns({"tenant": cohort, "sequential": sequential}, self.dev)
        row = {"probe": "cohort_resident", "backend": self.label,
               "tenants": CO_TENANTS, "eb": CO_EB, "vb": CO_VB,
               "num_edges": total,
               "windows": sum(-(-len(s) // CO_EB)
                              for s, _d in streams.values()),
               "parity": True}
        dispersion(row, stats, total)
        speedups(row, stats, "sequential", "tenant")
        return [row]

    def host_reduce(self) -> list:
        from .. import native

        rows = []
        for eb in BUCKETS:
            s, d = self.stream(eb)
            val = self._values(s, d)
            tiers = {"device": self._reduce(eb),
                     "host": self._reduce(eb, tier="host")}
            if native.windowed_reduce_available():
                tiers["native"] = self._reduce(eb, tier="native")
            got = {t: digest_rows(r.process_stream(s, d, val))
                   for t, r in tiers.items()}
            for t in got:
                same("host_reduce eb=%d %s" % (eb, t), got["device"], got[t])
            stats = turns({t: (lambda r=r: r.process_stream(s, d, val))
                           for t, r in tiers.items()}, self.dev)
            row = {"name": "sum", "edge_bucket": eb, "vertex_bucket": VB,
                   "windows": self.windows, "parity": True}
            if "native" in got:
                row["native_parity"] = True
            dispersion(row, stats, len(s))
            row["host_vs_device"] = round(stats["device"][0]
                                          / stats["host"][0], 4)
            rows.append(row)
        return rows

    def sharded_table(self) -> dict:
        import torch.distributed as dist

        from ..parallel import mesh as mesh_mod
        from ..parallel.sharded import ShardedTriangleWindowKernel

        # a one-rank group of its own where no group exists, ended after
        own = self.mesh is None and not dist.is_initialized()
        m = self.mesh if self.mesh is not None else mesh_mod.make_mesh(
            device=self.dev)
        try:
            s, d = self.stream(EB)
            kernels = {mode: ShardedTriangleWindowKernel(
                m, EB, VB, k_bucket=128, table=mode)
                for mode in ("replicated", "owner")}
            got = {mode: k.count_stream(s, d) for mode, k in kernels.items()}
            same("sharded_table", got["replicated"], got["owner"])
            stats = turns({mode: (lambda k=k: k.count_stream(s, d))
                           for mode, k in kernels.items()}, self.dev)
            row = {"edge_bucket": EB, "vertex_bucket": VB,
                   "windows": self.windows, "counts_match": True}
            dispersion(row, stats, len(s))
        finally:
            if own:
                dist.destroy_process_group()
        return {"devices": mesh_mod.shard_count(m), "backend": self.label,
                "rows": [row],
                "owner_edges_per_s": row["owner_edges_per_s"],
                "replicated_edges_per_s": row["replicated_edges_per_s"],
                "counts_match": True}


def write(path: str, label: str, sections: dict) -> dict:
    """`sections` filed under `label` in the evidence file at `path`,
    every other device's rows kept (a corrupt file starts anew); written
    through a temporary file, the resolvers' memos forgotten after.
    Returns the whole file."""
    try:
        with open(path) as f:
            perf = json.load(f)
        if not isinstance(perf.get("devices"), dict):
            raise ValueError("no devices")
    except (OSError, ValueError, AttributeError):
        perf = {"devices": {}}
    perf["devices"][label] = sections
    tmp = "%s.tmp%d" % (path, os.getpid())
    with open(tmp, "w") as f:
        json.dump(perf, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    from . import evidence

    evidence.forget()       # route on the file as it is now
    return perf


def run(out: str, device=None, windows: int = 64, sections=SECTIONS,
        mesh=None, log=print) -> Writer:
    """Measure `sections` on `device` and write them to `out`."""
    w = Writer(device, windows, mesh=mesh, log=log)
    for name in sections:
        w.measure(name)
    write(out, w.label, w.sections)
    return w


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="the evidence file to write (other devices' rows "
                         "are kept)")
    ap.add_argument("--windows", type=int, default=64,
                    help="windows of each stream (the depth)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("evidence_ab: no CUDA device is available", file=sys.stderr)
        return 2
    w = run(args.out, windows=args.windows)
    print(json.dumps({"device": w.label, "seconds": w.seconds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
