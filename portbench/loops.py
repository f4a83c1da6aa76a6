"""The one load generator: a traffic mix's parameters (a JSON file under
portbench/traffic/) drive a system's calls through the measured window.

Keys of a mix:
  loop              "closed": each call starts when the last returns;
                    "open": calls fall due on a fixed schedule that does
                    not slow when the system does
  windows_per_call  windows of the configuration's edge bucket a call
  edges_per_s       (open) the offered rate: call k (k = 1, 2, ...)
                    falls due when its last edge is due, at
                    k * windows_per_call * edge_bucket / edges_per_s
                    seconds after the window opens
  trace_seconds     with --trace 1, the device capture covers calls on
                    the mix's schedule until this much time has passed,
                    before the window opens

The window opens at the first timed call. A closed window closes at the
first call boundary after `seconds`; an open one offers the calls due
within `seconds` and closes when the last returns. Every time is the
host's clock (time.perf_counter). One call, drawn from the seed, has
the system's state before and after it kept for the check
(`system.keep`): the first call of the window to start at or after a
moment drawn uniformly from [0, seconds), or, where the window closes
first, one call more after it. The copies are the harness's, not the
program's work: the window's clock stops while they are made (and an
open loop's schedule moves on by as much).

What a loop measures (`Window`), over the window's calls (not those of
the capture): edges and windows fed, each call's seconds, the window's
seconds; in an open loop each window's latency,
from the moment its last edge was due to the return of the call that
delivered it (a wait behind a late call counts), and how late each call
started against its due time; and the Python collector's passes inside
the window (the program's allocations set them off, so they are the
program's to pay: counted and timed, never suppressed).
"""

from __future__ import annotations

import dataclasses
import gc
import math
import random
import time
from typing import List, Optional

LOOPS = ("closed", "open")
SAMPLE_SALT = 0x5EED


@dataclasses.dataclass
class Window:
    calls: List[int] = dataclasses.field(default_factory=list)
    timed_calls: List[int] = dataclasses.field(default_factory=list)
    edges: int = 0
    windows: int = 0
    seconds: float = 0.0
    call_s: List[float] = dataclasses.field(default_factory=list)
    latency_s: List[float] = dataclasses.field(default_factory=list)
    lateness_s: List[float] = dataclasses.field(default_factory=list)
    traced_calls: List[int] = dataclasses.field(default_factory=list)
    kept_s: float = 0.0
    gc_passes: List[int] = dataclasses.field(
        default_factory=lambda: [0, 0, 0])
    gc_s: float = 0.0

    def end_to_end(self) -> dict:
        """Every end-to-end number this window gives, by metric name."""
        out = {"edges_per_s": self.edges / self.seconds}
        if self.latency_s:
            lat = sorted(self.latency_s)
            out["window_p95_ms"] = nearest_rank(lat, 0.95) * 1e3
        return out


def nearest_rank(sorted_values, q: float) -> float:
    """The q-quantile of sorted values by the nearest rank."""
    return sorted_values[max(0, math.ceil(q * len(sorted_values)) - 1)]


def check_traffic(traffic: dict) -> None:
    if traffic.get("loop") not in LOOPS:
        raise ValueError("traffic loop must be one of %s, got %r"
                         % (LOOPS, traffic.get("loop")))
    w = traffic.get("windows_per_call")
    if not isinstance(w, int) or w < 1:
        raise ValueError("traffic windows_per_call must be a whole number "
                         "above 0, got %r" % (w,))
    if traffic["loop"] == "open":
        r = traffic.get("edges_per_s")
        if not isinstance(r, (int, float)) or r <= 0:
            raise ValueError("an open loop needs edges_per_s above 0")


def run(traffic: dict, system, seconds: float, seed: int,
        capture=None) -> Window:
    """Drive `system` through one window of `seconds`. With `capture`,
    the capture first covers calls on the mix's schedule until the mix's
    trace_seconds have passed; once it has stopped, the stage timers are
    reset and the window opens, its schedule anew. The mix is
    `check_traffic`'s."""
    at = random.Random(int(seed) ^ SAMPLE_SALT).random() * seconds
    win = Window()
    n = [0]
    picked = [False]

    def phase(limit: float, traced: bool) -> float:
        open_loop = traffic["loop"] == "open"
        rate = float(traffic.get("edges_per_s", 0.0))
        gap = traffic["windows_per_call"] * system.eb / rate \
            if open_loop else 0.0
        j = 0
        t0 = time.perf_counter()
        while True:
            j += 1
            if open_loop and j * gap > limit:
                break
            n[0] += 1
            k = n[0]
            # the sample: the first call to start at or after `at`; its
            # copies are kept off the window's clock
            sample = not traced and not picked[0] and max(
                time.perf_counter(), t0 + j * gap) - t0 >= at
            if sample:
                picked[0] = True
                t0 += _kept(win, system.keep, k, False)
            due = t0 + j * gap
            if open_loop:
                wait = due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
            start = time.perf_counter()
            if traced:
                with capture.annotate("portbench.call"):
                    edges = system.call(k)
            else:
                edges = system.call(k)
            end = time.perf_counter()
            win.calls.append(k)
            if traced:
                win.traced_calls.append(k)
                if end - t0 >= limit:
                    break
                continue
            win.edges += edges
            win.windows += -(-edges // system.eb)
            win.call_s.append(end - start)
            win.timed_calls.append(k)
            if open_loop:
                win.lateness_s.append(start - due)
                first = (j - 1) * traffic["windows_per_call"]
                for w in range(-(-edges // system.eb)):
                    win.latency_s.append(
                        end - (t0 + (first + w + 1) * system.eb / rate))
            if sample:
                t0 += _kept(win, system.keep, k, True)
            if not open_loop and end - t0 >= limit:
                break
        return time.perf_counter() - t0

    if capture is not None:
        capture.start()
        phase(float(traffic.get("trace_seconds", 0.3)), True)
        capture.stop()
        system.reset_stages()
    tally = _GcTally(win)
    gc.callbacks.append(tally)
    try:
        win.seconds = phase(seconds, False)
    finally:
        gc.callbacks.remove(tally)
    if not picked[0]:
        n[0] += 1
        _kept(win, system.keep, n[0], False)
        system.call(n[0])
        win.calls.append(n[0])
        _kept(win, system.keep, n[0], True)
    return win


def _kept(win: Window, keep, k: int, after: bool) -> float:
    """Run the system's keep of call k's state; returns its seconds."""
    t = time.perf_counter()
    keep(k, after)
    t = time.perf_counter() - t
    win.kept_s += t
    return t


class _GcTally:
    """A gc callback: the collector's passes by generation and their
    seconds."""

    def __init__(self, win: Window):
        self.win, self.t = win, 0.0

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self.t = time.perf_counter()
        else:
            self.win.gc_passes[info["generation"]] += 1
            self.win.gc_s += time.perf_counter() - self.t


def lateness_line(win: Window) -> Optional[str]:
    """How late the open loop's calls started, for standard error."""
    if not win.lateness_s:
        return None
    late = sorted(win.lateness_s)
    quarter = max(1, len(win.lateness_s) // 4)
    return ("generator lateness: calls %d, p50 %.6f s, p95 %.6f s, max "
            "%.6f s; mean of the first quarter %.6f s, of the last %.6f s"
            % (len(late), nearest_rank(late, 0.5), nearest_rank(late, 0.95),
               late[-1], sum(win.lateness_s[:quarter]) / quarter,
               sum(win.lateness_s[-quarter:]) / quarter))


def gc_line(win: Window) -> str:
    """The collector's passes and the harness's kept copies inside the
    window, for standard error."""
    return ("window: collector passes by generation %s, %.6f s; the "
            "check's state copies %.6f s, off the clock"
            % (win.gc_passes, win.gc_s, win.kept_s))
