"""Fixtures of the benchmark's tests: a toy checkout that runs the
harness on the CPU, and the look for a card of the tests marked
`card` (made in the fixture, never at import)."""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY = {"num_vertices": 300, "num_edges": 5000, "edge_bucket": 256,
       "vertex_bucket": 300, "feature_dim": 16}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one (decided in "
        "the `card` fixture)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card only")
    return torch.device("cuda")


def make_toy_root(path: Path, seconds_trace: float = 0.05):
    """A checkout of the harness's shared files (symlinked) with a toy
    configuration of the arxiv file, a closed and an open mix, and a
    BENCHMARK.json of two cells over them. Returns (root, bench)."""
    pb = path / "portbench"
    (pb / "configs").mkdir(parents=True)
    (pb / "traffic").mkdir()
    for d in ("systems", "reference", "metrics"):
        os.symlink(ROOT / "portbench" / d, pb / d)
    cfg = json.loads((ROOT / "portbench/configs/ogbn-arxiv-f256.json")
                     .read_text())
    cfg.update(TOY, name="toy")
    (pb / "configs/toy.json").write_text(json.dumps(cfg))
    (pb / "traffic/bulk.json").write_text(json.dumps(
        {"loop": "closed", "windows_per_call": 4,
         "trace_seconds": seconds_trace}))
    (pb / "traffic/live.json").write_text(json.dumps(
        {"loop": "open", "windows_per_call": 2, "edges_per_s": 100000,
         "trace_seconds": seconds_trace}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [dict(bench["configs"][0], name="toy",
                             file="portbench/configs/toy.json")]
    bulk = dict(bench["workloads"][0], name="toy.bulk", config="toy",
                traffic="bulk")
    live = dict(bulk, name="toy.live", traffic="live")
    bench["workloads"] = [bulk, live]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["toy.live" if (m["name"].endswith(".live")
                                             or m["name"] == "window_p95_ms")
                              else "toy.bulk"]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path, bench


@pytest.fixture
def toy(tmp_path):
    return make_toy_root(tmp_path)
