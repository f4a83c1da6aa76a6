"""The result line's schema, and the run's refusals."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from portbench import harness

from conftest import ROOT

E2E = {"toy.bulk": {"edges_per_s", "setup_s"},
       "toy.live": {"window_p95_ms", "setup_s"}}
LAYER = {"toy.bulk": {"prep_ms_per_window.bulk", "h2d_ms_per_window.bulk"},
         "toy.live": {"prep_ms_per_window.live", "engine_call_ms_p50.live"}}


@pytest.mark.parametrize("cell", sorted(E2E))
@pytest.mark.parametrize("trace", [False, True])
def test_result_schema(toy, cell, trace):
    root, bench = toy
    res, lines = harness.execute(bench, cell, 2 ** 31 + 17, 0.3, trace,
                                 time.perf_counter(), device="cpu",
                                 root=root)
    keys = list(res)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        # the CPU has no peaks and no device ops: those readers are silent
        assert set(res["metrics"]) <= LAYER[cell] | {"device_idle_share.bulk",
                                                     "device_idle_share.live"}
        assert LAYER[cell] <= set(res["metrics"])
        assert {"busy_s", "window_s"} <= set(dev)
        bd = res["breakdown"]
        assert set(bd) == {"device_ops", "idle_gaps"}
        assert all(len(x) <= 10 for x in bd.values())
    else:
        assert set(res["metrics"]) == E2E[cell]
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    assert lines[-len(res["checks"]):] == [
        "check %s: %d (limit %d)" % (n, c["value"], c["limit"])
        for n, c in res["checks"].items()]
    json.dumps(res, allow_nan=False)


def run_cli(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ogbn-arxiv-f256.bulk", "--seed", str(2 ** 31 + 1), "--seconds",
         "1", "--trace", "0", *extra], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = run_cli(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = run_cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
