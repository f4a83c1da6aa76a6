"""The readers of the program's spans (portbench/program_spans.py and
the `program_span` metrics): their arithmetic on a synthetic trace, the
clipping to the traced calls' span, their silence where the span is
absent, and a toy CPU `--trace 1` run that reports them."""

import time
import types

import numpy as np
import pytest

from portbench import harness, spec
from portbench.trace import Trace

from conftest import ROOT

READERS = ("admit_ms_per_call", "ingress_wait_ms_per_window",
           "dispatch_ms_per_window")


def _reader(name):
    return spec.load_module(spec.metric_path(name, ROOT))


def _ann(name, ts, dur):
    return {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _ctx(events, windows=(4, 2)):
    calls = list(range(1, len(windows) + 1))
    return types.SimpleNamespace(
        trace=Trace(events),
        window=types.SimpleNamespace(traced_calls=calls),
        system=types.SimpleNamespace(outputs={
            k: np.zeros((w, 4), np.int64) for k, w in zip(calls, windows)}))


# two traced calls, [1000, 2000) and [3000, 4000) us: t0 1000, t1 4000
CALLS = [_ann("portbench.call", 1000, 1000), _ann("portbench.call", 3000,
                                                  1000)]


def test_readers_sum_and_median_inside_the_span():
    ctx = _ctx(CALLS + [
        _ann("engine.admit", 1000, 300), _ann("engine.admit", 3000, 100),
        _ann("engine.admit", 3500, 200),
        _ann("ingress.wait", 1300, 500), _ann("ingress.wait", 3100, 100),
        _ann("ingress.dispatch", 1800, 100),
        _ann("ingress.dispatch", 3200, 300),
        # a device event of the name is no span of the program
        {"cat": "kernel", "name": "ingress.wait", "ts": 1000, "dur": 9000}])
    assert _reader("admit_ms_per_call").read(ctx) == pytest.approx(0.2)
    # 6 windows in the two traced calls
    assert _reader("ingress_wait_ms_per_window").read(ctx) == \
        pytest.approx(0.6 / 6)
    assert _reader("dispatch_ms_per_window").read(ctx) == \
        pytest.approx(0.4 / 6)


def test_readers_clip_to_the_traced_calls():
    ctx = _ctx(CALLS + [
        _ann("engine.admit", 500, 1000),      # 500 us inside
        _ann("engine.admit", 4500, 300),      # wholly after t1
        _ann("ingress.wait", 3900, 600),      # 100 us inside
        _ann("ingress.wait", 100, 200),       # wholly before t0
        _ann("ingress.dispatch", 900, 3200)])  # the whole span, 3000 us
    assert _reader("admit_ms_per_call").read(ctx) == pytest.approx(0.5)
    assert _reader("ingress_wait_ms_per_window").read(ctx) == \
        pytest.approx(0.1 / 6)
    assert _reader("dispatch_ms_per_window").read(ctx) == \
        pytest.approx(3.0 / 6)


@pytest.mark.parametrize("name", READERS)
def test_readers_silent_without_their_span(name):
    other = [_ann("engine.call", 1000, 900), _ann("ingress.finalize",
                                                  3000, 500)]
    assert _reader(name).read(_ctx(CALLS + other)) is None
    # only outside the traced calls
    outside = [_ann(s, 5000, 100) for s in ("engine.admit", "ingress.wait",
                                            "ingress.dispatch")]
    assert _reader(name).read(_ctx(CALLS + outside)) is None
    assert _reader(name).read(types.SimpleNamespace(trace=None)) is None


@pytest.mark.parametrize("cell,suffix", [("toy.bulk", ".bulk"),
                                         ("toy.live", ".live")])
def test_toy_traced_run_reports_the_span_metrics(toy, cell, suffix):
    root, bench = toy
    res, _ = harness.execute(bench, cell, 2 ** 31 + 29, 0.3, True,
                             time.perf_counter(), device="cpu", root=root)
    assert res["correct"] is True
    for name in READERS:
        got = res["metrics"][name + suffix]
        assert got["unit"] == "ms" and got["value"] > 0
