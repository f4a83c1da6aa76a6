"""ingress_wait_ms_per_window: the program's `ingress.wait` spans
(ops/ingress_pipeline.py run_pipeline: the dispatching thread getting a
chunk's staged payload, blocked on the pool's prep and h2d or running
them inline) summed over the traced calls, in ms a window of theirs:
the prep and h2d on the critical path. From the device trace's
annotations; nothing where it holds none."""

from portbench import program_spans


def read(ctx):
    return program_spans.per_window_ms(ctx, "ingress.wait")
