"""device_idle_share: the share of the traced calls' span (from the
first traced call's start to the last one's end, on the host's clock of
the trace) in which no kernel, memcpy or memset ran on the card, in %.
From the device trace."""


def read(ctx):
    tr = ctx.trace
    if tr is None or tr.span_us <= 0 or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_us / tr.span_us)
