"""BENCHMARK.json and the files it names, each found by its name; a
malformed description is refused; a new configuration and cell are
taken up by adding files and entries alone."""

import copy
import json
import time

import pytest

from portbench import harness, spec

from conftest import ROOT


def test_benchmark_json_is_well_formed():
    bench = spec.load_benchmark(ROOT)
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    names = [w["name"] for w in bench["workloads"]]
    assert names[:2] == ["ogbn-arxiv-f256.bulk", "ogbn-products-f256.bulk"]
    for m in bench["per_layer"]:
        for cell in spec.cells_of(m, bench):
            e2e = {x["name"]: x for x in bench["end_to_end"]}[m["moves"]]
            assert cell in spec.cells_of(e2e, bench)
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_file_is_found_by_name():
    bench = spec.load_benchmark(ROOT)
    for c in bench["configs"]:
        cfg = spec.load_config(bench, c["name"], ROOT)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        spec.load_module(spec.module_path("systems", cfg["system"], ROOT))
    for w in bench["workloads"]:
        assert spec.load_traffic(w["traffic"], ROOT)["loop"] in (
            "closed", "open")
    for m in bench["per_layer"]:
        mod = spec.load_module(spec.metric_path(m["name"], ROOT))
        assert callable(mod.read)


def test_split_metrics_share_a_reader():
    assert spec.metric_path("prep_ms_per_window.live", ROOT).name == \
        "prep_ms_per_window.py"


def mutate(bench, fn):
    b = copy.deepcopy(bench)
    fn(b)
    return b


BREAKS = {
    "extra top key": lambda b: b.update(note="x"),
    "run_seconds over 51": lambda b: b.update(run_seconds=52),
    "name with a space": lambda b: b["workloads"][0].update(name="a b"),
    "unknown config": lambda b: b["workloads"][0].update(config="nope"),
    "missing traffic file": lambda b: b["workloads"][0].update(
        traffic="nope"),
    "chips 2": lambda b: b["workloads"][0].update(chips=2),
    "bound over 0.25": lambda b: b["end_to_end"][0].update(bound=0.3),
    "no setup_s": lambda b: b.update(end_to_end=[
        m for m in b["end_to_end"] if m["name"] != "setup_s"]),
    "unit with a space": lambda b: b["per_layer"][0].update(unit="m s"),
    "metric with why": lambda b: b["per_layer"][0].update(why="x"),
    "moves unknown": lambda b: b["per_layer"][0].update(moves="nope"),
    "metric with no reader": lambda b: b["per_layer"][0].update(
        name="no_such_metric"),
    "cell not reporting what it moves": lambda b: b["per_layer"][0].update(
        workloads=[w["name"] for w in b["workloads"]
                   if w["name"].endswith(".live")]),
    "config file missing": lambda b: b["configs"][0].update(
        file="portbench/configs/none.json"),
}


@pytest.mark.parametrize("what", sorted(BREAKS))
def test_malformed_description_is_refused(what):
    bench = spec.load_benchmark(ROOT)
    with pytest.raises(spec.SpecError):
        spec.validate(mutate(bench, BREAKS[what]), ROOT)


def test_malformed_files_are_refused(toy):
    root, bench = toy
    (root / "portbench/traffic/bad.json").write_text("[1, 2")
    with pytest.raises(spec.SpecError):
        spec.load_traffic("bad", root)
    cfg = json.loads((root / "portbench/configs/toy.json").read_text())
    del cfg["system"]
    (root / "portbench/configs/toy.json").write_text(json.dumps(cfg))
    with pytest.raises(spec.SpecError):
        spec.load_config(bench, "toy", root)


def test_new_config_and_cell_by_files_alone(toy):
    root, bench = toy
    cfg = json.loads((root / "portbench/configs/toy.json").read_text())
    cfg.update(name="toy2", num_vertices=700, vertex_bucket=700)
    (root / "portbench/configs/toy2.json").write_text(json.dumps(cfg))
    bench["configs"].append(dict(bench["configs"][0], name="toy2",
                                 file="portbench/configs/toy2.json"))
    bench["workloads"].append(dict(bench["workloads"][0], name="toy2.bulk",
                                   config="toy2"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "toy.bulk" in m.get("workloads", []):
            m["workloads"].append("toy2.bulk")
    spec.validate(bench, root)
    res, _ = harness.execute(bench, "toy2.bulk", 2 ** 31 + 3, 0.2, False,
                             time.perf_counter(), device="cpu", root=root)
    assert res["correct"] and set(res["metrics"]) == {"edges_per_s",
                                                      "setup_s"}
