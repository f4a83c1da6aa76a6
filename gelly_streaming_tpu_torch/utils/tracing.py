"""Tracing: per-step wall time and record counts, and the device trace.

Port of the JAX package's `utils/tracing.py`:

- `StepTimer`: per-operator and per-step wall time and record counts,
  collected by the graph API's runtime when `env.enable_tracing()` is on
  and by the driver under `tracing=True`. It is a thin adapter over the
  flight recorder (utils/telemetry.py): `step()` measures through a
  telemetry span (an armed recorder sees every step as a `step.<name>`
  span), while `report()` and `event_log()` accumulate as the JAX class
  does, so both packages report the same steps, calls and records for
  the same job. A step whose seconds are a share of a longer interval
  (the driver's per-window steps, which the port runs as one chunk) is
  marked `"apportioned": True` in its report row.
- `device_trace`: a context manager around `torch.profiler` that writes
  a Chrome trace of the job's host calls and, on the card, its kernels.
  The trace only observes: it is never armed by default and never
  changes a result. The log directory is created; a nested capture (one
  profiler at a time, across threads) or a start the profiler refuses
  becomes a no-op with a `device_trace_failed` telemetry event; a
  finished capture is kept whatever device records the profiler dropped
  and stamps a durable `device_trace_captured` event with the log
  directory, the trace file, its kernel events, the cost observatory's
  program inventory (utils/costmodel.py) and the clock anchor: as the
  capture starts, the calling thread enters a `gs.clock_anchor`
  annotation and reads the flight recorder's clock inside it
  (`clock_anchor`), so one offset (the annotation's start in the trace
  less that reading) maps any recorder span, the pool's worker stages
  that the profiler does not hold among them, onto the trace's
  timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
from collections import defaultdict
from typing import Dict, List, Optional

from . import telemetry


class StepTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.records: Dict[str, int] = defaultdict(int)
        self.events: List[dict] = []  # discrete happenings (demotions)
        self.apportioned: set = set()  # steps with seconds not measured

    def event(self, name: str, info: dict = None) -> None:
        """Record a discrete runtime event (a tier demotion, a
        re-promotion) in the trace: `event_log()` lists them beside
        `report()`, so a degraded run's trace says so."""
        self.events.append({"event": name, **(info or {})})

    def event_log(self) -> List[dict]:
        return list(self.events)

    def add(self, name: str, seconds: float, num_records: int = 0,
            apportioned: bool = False) -> None:
        """Record one already-measured step (the runtime's
        exclusive-time accounting). `apportioned`: `seconds` is a share
        of a longer interval, not this step's own measurement; its row
        in report() says so."""
        if apportioned:
            self.apportioned.add(name)
        self.totals[name] += seconds
        self.counts[name] += 1
        self.records[name] += num_records

    @contextlib.contextmanager
    def step(self, name: str, num_records: int = 0):
        """Time one step through a telemetry span, which it yields (a
        caller may attach attributes before it records)."""
        sp = telemetry.span("step." + name, records=num_records)
        try:
            with sp:
                yield sp
        finally:
            self.add(name, sp.elapsed, num_records)

    def report(self) -> List[dict]:
        out = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            total = self.totals[name]
            recs = self.records[name]
            row = {
                "op": name,
                "total_s": round(total, 6),
                "calls": self.counts[name],
                "records": recs,
                "records_per_s": round(recs / total) if total and recs else 0,
            }
            if name in self.apportioned:
                row["apportioned"] = True
            out.append(row)
        return out

    def __str__(self) -> str:
        lines = ["op                            total_s    calls  records  rec/s"]
        for row in self.report():
            lines.append(
                f"{row['op']:<28} {row['total_s']:>9.4f} {row['calls']:>7}"
                f" {row['records']:>8} {row['records_per_s']:>7}"
            )
        return "\n".join(lines)


# one profiler at a time: a nested device_trace is a no-op. The depth
# is written under the lock only.
_TRACE_LOCK = threading.Lock()
_TRACE_DEPTH = 0


@dataclasses.dataclass
class TraceCapture:
    """What a device_trace captured, filled in at its exit: the Chrome
    trace file (None when this capture was a no-op), how many kernel
    events it holds and their count by kernel name."""

    log_dir: str
    path: Optional[str] = None
    kernel_events: int = 0
    kernels: Dict[str, int] = dataclasses.field(default_factory=dict)


def _start_profiler():
    """A started torch.profiler session (host calls, and the card's
    kernels where CUDA is available) and the recorder's clock read
    inside its `gs.clock_anchor` annotation."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    with record_function("gs.clock_anchor"):
        anchor = telemetry.clock()
    return prof, anchor


def _stop_profiler(prof, log_dir: str) -> tuple:
    """Stop `prof` and write its Chrome trace into `log_dir`: (path,
    {kernel name: events in the file})."""
    prof.stop()
    n = sum(1 for f in os.listdir(log_dir) if f.startswith("gs_trace_"))
    path = os.path.join(log_dir, "gs_trace_%d_%d.json" % (os.getpid(), n))
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    names: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("cat") in ("kernel", "Kernel"):
            names[str(e.get("name"))] += 1
    return path, dict(names)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """A torch.profiler capture of the enclosed work into `log_dir`
    (module docstring); yields a TraceCapture."""
    global _TRACE_DEPTH
    os.makedirs(log_dir, exist_ok=True)
    cap = TraceCapture(str(log_dir))
    prof = anchor = None
    with _TRACE_LOCK:
        if _TRACE_DEPTH == 0:
            try:
                prof, anchor = _start_profiler()
            except Exception as e:  # an observer must not stop the job
                telemetry.event(
                    "device_trace_failed", log_dir=str(log_dir),
                    error="%s: %s" % (type(e).__name__, e))
        _TRACE_DEPTH += 1
    try:
        yield cap
    finally:
        with _TRACE_LOCK:
            _TRACE_DEPTH -= 1
            if prof is not None:
                try:
                    cap.path, cap.kernels = _stop_profiler(
                        prof, str(log_dir))
                    cap.kernel_events = sum(cap.kernels.values())
                except Exception as e:  # the same: the job goes on
                    telemetry.event(
                        "device_trace_failed", log_dir=str(log_dir),
                        error="stop: %s: %s" % (type(e).__name__, e))
                else:
                    from . import costmodel

                    telemetry.event(
                        "device_trace_captured", durable=True,
                        log_dir=str(log_dir), path=cap.path,
                        kernel_events=cap.kernel_events,
                        programs=len(costmodel.programs()),
                        clock_anchor=anchor)
