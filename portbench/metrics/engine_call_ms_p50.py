"""engine_call_ms_p50: the median over the window's calls of the host's
clock around `process()`: admission, prep, dispatch and finalize of one
call, the engine front's own share of a window's latency."""

import statistics


def read(ctx):
    if not ctx.window.call_s:
        return None
    return statistics.median(ctx.window.call_s) * 1e3
