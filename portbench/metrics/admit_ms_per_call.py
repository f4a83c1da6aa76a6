"""admit_ms_per_call: the median over the traced calls of the program's
`engine.admit` span (ops/scan_analytics.py SummaryEngineBase._admit: the
admit fault site, the sanitizer, the int32 arrays, the id check, the
journal and the latency stamp), in ms, clipped to the traced calls'
span. From the device trace's annotations; nothing where it holds
none."""

import statistics

from portbench import program_spans


def read(ctx):
    if ctx.trace is None:
        return None
    spans = program_spans.durations_ms(ctx.trace, "engine.admit")
    return statistics.median(spans) if spans else None
