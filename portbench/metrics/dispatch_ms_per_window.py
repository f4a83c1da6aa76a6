"""dispatch_ms_per_window: the program's `ingress.dispatch` spans
(ops/ingress_pipeline.py run_pipeline: a chunk's kernels launched on the
dispatching thread, not waited for) summed over the traced calls, in ms
a window of theirs. From the device trace's annotations; nothing where
it holds none."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_window_ms(ctx, "ingress.dispatch")
