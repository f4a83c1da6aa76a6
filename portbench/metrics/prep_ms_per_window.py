"""prep_ms_per_window: milliseconds of the ingress pipeline's prep a
window (ops/ingress_pipeline.py, the window cuts and stacking of
ops/segment.py on the pool's workers), summed over the workers: CPU
time, not time on the critical path. From the engine's StageTimers over
the whole window."""


def read(ctx):
    prep = ctx.stages.get("prep")
    if prep is None or not ctx.window.windows:
        return None
    return prep / ctx.window.windows
