"""On the card: one short run of each cell through the command, correct
and with a result line. Skips without a card (decided in the fixture).

    python3 -m pytest portbench/tests -m card
"""

import json
import subprocess
import sys

import pytest

from portbench import spec

from conftest import ROOT

CELLS = [w["name"] for w in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 101), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    bench = spec.load_benchmark(ROOT)
    group = bench["per_layer"] if trace else bench["end_to_end"]
    want = {m["name"] for m in group if cell in spec.cells_of(m, bench)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
