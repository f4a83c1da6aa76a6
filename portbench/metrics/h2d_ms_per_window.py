"""h2d_ms_per_window: milliseconds of the staging's host-to-device copy
a window (ops/staging.py ChunkStager, on the pool's workers). From the
engine's StageTimers over the whole window."""


def read(ctx):
    h2d = ctx.stages.get("h2d")
    if h2d is None or not ctx.window.windows:
        return None
    return h2d / ctx.window.windows
