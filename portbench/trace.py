"""The device capture of a `--trace 1` run and its reduction.

`Capture` runs torch.profiler (host and CUDA activities) over the
window's first calls, each inside a `portbench.call` annotation, writes
the Chrome trace into the run's temporary directory, reads it back and
deletes it. `Trace` holds what the readers need:

  device_ops   (name, start_us, dur_us, category) of every kernel, memcpy
               and memset on the card;
  span_us      from the first traced call's start to the last one's end;
  busy_us      the union of the device ops' intervals inside the span;
  breakdown()  the ten device ops that took most time, by name, and the
               ten longest idle gaps of the card inside the span, each
               named by the innermost host operation or annotation that
               covers the gap's middle.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
CALL = "portbench.call"


def clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:\-]", "_", str(name))[:64]


def union(intervals):
    """Merged, sorted [start, end) intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    def __init__(self, events: list):
        self.device_ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0)),
                            e["cat"]) for e in events
                           if e.get("cat") in DEVICE_CATS]
        self.host_ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0)))
                         for e in events if e.get("cat") in HOST_CATS]
        calls = [(ts, ts + dur) for name, ts, dur in self.host_ops
                 if name == CALL]
        if calls:
            self.t0, self.t1 = min(a for a, _ in calls), max(
                b for _, b in calls)
        else:
            self.t0 = self.t1 = 0.0
        self.busy_intervals = [
            [max(a, self.t0), min(b, self.t1)]
            for a, b in union((ts, ts + dur)
                              for _, ts, dur, _ in self.device_ops)
            if b > self.t0 and a < self.t1]
        self.busy_us = sum(b - a for a, b in self.busy_intervals)

    @property
    def span_us(self) -> float:
        return self.t1 - self.t0

    def device_time_us(self, parts=(), cats=("kernel",)) -> float:
        """Summed duration of the device ops of `cats` whose name holds
        one of `parts` (every op of those categories where parts is
        empty)."""
        return sum(dur for name, _, dur, cat in self.device_ops
                   if cat in cats and (not parts or any(
                       p in name for p in parts)))

    def _host_at(self, t: float) -> str:
        best = None
        for name, ts, dur in self.host_ops:
            if ts <= t <= ts + dur and (best is None or dur < best[1]):
                best = (name, dur)
        return best[0] if best else "between_calls"

    def breakdown(self) -> dict:
        by_name = defaultdict(float)
        for name, ts, dur, _ in self.device_ops:
            if ts < self.t1 and ts + dur > self.t0:
                by_name[clean(name)] += dur * 1e-6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, at = [], self.t0
        for a, b in self.busy_intervals + [[self.t1, self.t1]]:
            if a > at:
                gaps.append((a - at, (a + at) / 2))
            at = max(at, b)
        gaps.sort(reverse=True)
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[clean(self._host_at(mid)), g * 1e-6]
                              for g, mid in gaps[:10]]}


class Capture:
    def __init__(self):
        self.prof = None
        self.trace = None
        self.stop_s = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    def annotate(self, name: str):
        from torch.profiler import record_function

        return record_function(name)

    def stop(self) -> None:
        import time

        import torch

        t = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()
        fd, path = tempfile.mkstemp(prefix="portbench_trace_",
                                    suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.trace = Trace(events)
        self.prof = None
        self.stop_s = time.perf_counter() - t
