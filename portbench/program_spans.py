"""The program's own spans in a `--trace 1` run's device capture.

While a torch.profiler capture records, the port's summary engines enter
their dispatching thread's spans (utils/telemetry.py `span(profile=
True)`) as `user_annotation` events of the trace: `engine.call`,
`engine.admit`, `engine.chunks`, `ingress.wait`, `ingress.dispatch`,
`ingress.finalize`. The readers of `program_span` metrics take them from `Trace.host_ops`.
"""


def durations_ms(trace, name: str) -> list:
    """The durations in ms of the host events named `name`, each clipped
    to the traced calls' span [t0, t1]; those wholly outside it are left
    out."""
    out = []
    for n, ts, dur in trace.host_ops:
        if n == name and ts < trace.t1 and ts + dur > trace.t0:
            out.append((min(ts + dur, trace.t1) - max(ts, trace.t0)) * 1e-3)
    return out


def traced_windows(ctx) -> int:
    """The windows of the traced calls, as the program delivered them."""
    return sum(len(ctx.system.outputs[k]) for k in ctx.window.traced_calls)


def per_window_ms(ctx, name: str):
    """The summed durations of the spans named `name` over the traced
    calls' windows, in ms a window; None where the trace holds none."""
    if ctx.trace is None:
        return None
    spans = durations_ms(ctx.trace, name)
    windows = traced_windows(ctx)
    if not spans or not windows:
        return None
    return sum(spans) / windows
