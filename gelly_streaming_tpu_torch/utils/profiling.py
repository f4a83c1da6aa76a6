"""Device time by kernel of one run, from torch.profiler."""

from __future__ import annotations

import time

import torch


# the host-side CUDA API rows of a kernel launch or a graph replay
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cuLaunchKernel", "cudaGraphLaunch", "cuGraphLaunch")


def device_times(run, launch_calls: bool = False) -> tuple:
    """Runs run() once under torch.profiler and returns (wall ms, {name:
    [device ms, launches]}), the names cut to 70 characters. Only the
    device-side rows are read, so nothing is counted twice. With
    `launch_calls`, a third value: the calls of the launch entry points
    (LAUNCH_CALLS, their variants included) in the host-side CUDA API
    rows, the profiler's own record that launches were made, whatever
    became of their device records. Needs a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    by_name = {}
    calls = 0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            if ev.key.startswith(LAUNCH_CALLS):
                calls += ev.count
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            ms_n = by_name.setdefault(ev.key[:70], [0.0, 0])
            ms_n[0] += us / 1e3
            ms_n[1] += ev.count
    if launch_calls:
        return wall_ms, by_name, calls
    return wall_ms, by_name
