"""One run of one cell: set-up, the measured window, the metrics, the
check of `correct`, the result line.

`execute` is the whole run but the look for a card, which `run.py`
makes first; tests call it with `device="cpu"` at toy sizes, and
`control.py` with `program="control"`.
"""

from __future__ import annotations

import sys
import time
import types
from pathlib import Path

from portbench import loops, peaks, spec
from portbench import trace as trace_mod

# top-level module names that no run may hold once its window has
# closed: JAX, its libraries, the JAX package and the JAX-era bench.py
FORBIDDEN = ("jax", "jaxlib", "flax", "gelly_streaming_tpu", "bench")


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN names among the top-level names (the part before
    the first dot, compared whole) of the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def _metrics_of(bench: dict, cell: str, trace: bool) -> list:
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in spec.cells_of(m, bench)]


def execute(bench: dict, cell_name: str, seed: int, seconds: float,
            trace: bool, t_start: float, device=None,
            program: str = "engine", root: Path = spec.ROOT,
            laps=()):
    """Run the cell once; returns (result dict, lines for standard
    error). `t_start` is the host clock at the process's start, `laps`
    the (name, seconds) of set-up before this call."""
    import torch

    cell = spec.workload(bench, cell_name)
    cfg = spec.load_config(bench, cell["config"], root)
    traffic = spec.load_traffic(cell["traffic"], root)
    loops.check_traffic(traffic)
    reference = spec.load_module(
        spec.module_path("reference", cfg["reference"], root))
    sysmod = spec.load_module(spec.module_path("systems", cfg["system"],
                                               root))
    wanted = _metrics_of(bench, cell_name, trace)
    readers = {m["name"]: spec.load_module(spec.metric_path(m["name"], root))
               for m in wanted} if trace else {}
    on_card = device is None or torch.device(device).type == "cuda"
    seed = int(seed) % 2 ** 63

    system = sysmod.System(cfg, seed, traffic, reference, device=device,
                           program=program)
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    capture = trace_mod.Capture() if trace else None
    win = loops.run(traffic, system, seconds, seed, capture)
    stages = system.stage_ms()
    if on_card:
        kind = torch.cuda.get_device_name()
        # the program's own peak: from the engine's build on, less what
        # the harness held on the card then (its weights)
        peak = torch.cuda.max_memory_allocated() - system.memory_base
        dev = {"platform": "gpu", "kind": kind, "count": int(cell["chips"]),
               "memory_peak_bytes": int(peak),
               "power_limit": peaks.power_limit()}
        card_peaks = peaks.peaks_of(kind)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0, "power_limit": "none"}
        card_peaks = {}

    values = {}
    if trace:
        ctx = types.SimpleNamespace(
            window=win, system=system, stages=stages,
            trace=capture.trace, peaks=card_peaks,
            round_kernels=getattr(sysmod, "ROUND_KERNELS", ()))
        for m in wanted:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                values[m["name"]] = {"value": float(v), "unit": m["unit"]}
        tr = capture.trace
        dev["busy_s"] = tr.busy_us * 1e-6
        dev["window_s"] = tr.span_us * 1e-6
    else:
        have = win.end_to_end()
        have["setup_s"] = setup_s
        for m in wanted:
            if m["name"] not in have:
                raise spec.SpecError("cell %s reports %s, which its loop "
                                     "does not measure"
                                     % (cell_name, m["name"]))
            values[m["name"]] = {"value": float(have[m["name"]]),
                                 "unit": m["unit"]}

    system.release()
    t_check = time.perf_counter()
    checks, missing = system.check(win.calls)
    t_check = time.perf_counter() - t_check
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": int(win.windows),
        "failed": int(missing),
        "metrics": values,
        "device": dev,
    }
    if trace:
        result["breakdown"] = capture.trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in checks}
    lines = ["cell %s seed %d: setup %.3f s, window %.3f s, %d calls, %d "
             "windows, %d edges; card %s at %s (peaks: %s)"
             % (cell_name, seed, setup_s, win.seconds, len(win.calls),
                win.windows, win.edges, dev["kind"], dev["power_limit"],
                ", ".join("%s %.4g" % kv for kv in sorted(card_peaks.items()))
                or "none")]
    lines.append("set-up steps: " + ", ".join(
        "%s %.3f s" % step for step in list(laps) + list(
            getattr(system, "setup_steps", []))))
    lines.append(loops.gc_line(win))
    lines.append("check %.3f s" % t_check + (
        "; capture of %d calls, its stop %.3f s" % (
            len(win.traced_calls), capture.stop_s) if trace else ""))
    late = loops.lateness_line(win)
    if late:
        lines.append(late)
    lines += ["check %s: %d (limit %d)" % c for c in checks]
    return result, lines
