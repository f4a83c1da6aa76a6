"""The benchmark's description: `BENCHMARK.json` at the checkout's root,
and the files it names under `portbench/`, each found by its name.

- a configuration `<config>` is `configs/<config>.json`;
- a traffic mix `<traffic>` is `traffic/<traffic>.json`, a file of
  parameters that `loops.py` reads;
- a per-layer metric `<name>` is read by `metrics/<name>.py`, or, where
  that file does not exist, by `metrics/<stem>.py` with `<stem>` the
  name up to its first dot (so `prep_ms_per_window.bulk` and
  `prep_ms_per_window.live` share one reader);
- a configuration's `system` names the adapter `systems/<system>.py`
  that builds and drives the program, and its `reference` the plain
  reference `reference/<reference>.py`.

A later cell, mix or metric is added by adding files and entries; no
file here changes for it. `load_benchmark` refuses a description that
breaks the format of BENCHMARK.json in a way a run would otherwise
only find late: a malformed name, a missing key, a cell whose files are not
there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


class SpecError(ValueError):
    """The benchmark's description, or a file it names, is malformed."""


def _line(text, what: str, limit: int = 200) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= limit \
            or "\n" in text or "\t" in text:
        raise SpecError("%s must be one line of 1 to %d characters, got %r"
                        % (what, limit, text))


def _name(text, what: str) -> None:
    if not isinstance(text, str) or not NAME.match(text):
        raise SpecError("%s %r is not a name (a letter, digit or _ first, "
                        "then at most 63 of letters, digits, _ . -)"
                        % (what, text))


def _keys(entry: dict, allowed: set, what: str, optional=()) -> None:
    if not isinstance(entry, dict):
        raise SpecError("%s must be an object, got %r" % (what, entry))
    missing = allowed - set(entry)
    extra = set(entry) - allowed - set(optional)
    if missing or extra:
        raise SpecError("%s %r: missing keys %s, unknown keys %s"
                        % (what, entry.get("name"), sorted(missing),
                           sorted(extra)))


def _metric(m: dict, keys: set, sources: set, cells: set, what: str) -> None:
    _keys(m, keys, what, optional=("workloads",))
    _name(m["name"], what)
    if not isinstance(m["unit"], str) or not UNIT.match(m["unit"]):
        raise SpecError("%s %s: unit %r" % (what, m["name"], m["unit"]))
    if m["better"] not in ("lower", "higher"):
        raise SpecError("%s %s: better must be lower or higher"
                        % (what, m["name"]))
    if m["source"] not in sources:
        raise SpecError("%s %s: source %r not one of %s"
                        % (what, m["name"], m["source"], sorted(sources)))
    for cell in m.get("workloads", []):
        if cell not in cells:
            raise SpecError("%s %s lists unknown workload %r"
                            % (what, m["name"], cell))


def validate(bench: dict, root: Path = ROOT) -> None:
    """Raise SpecError where `bench` breaks BENCHMARK.json's format."""
    if set(bench) != TOP_KEYS:
        raise SpecError("BENCHMARK.json keys must be %s, got %s"
                        % (sorted(TOP_KEYS), sorted(bench)))
    rs = bench["run_seconds"]
    if not isinstance(rs, int) or isinstance(rs, bool) or not 1 <= rs <= 51:
        raise SpecError("run_seconds must be a whole number in [1, 51]")
    for word in bench["command"]:
        _line(word, "a word of the command")
    if not 1 <= len(bench["paths"]) <= 16:
        raise SpecError("paths must name 1 to 16 directories")
    for p in bench["paths"]:
        if not re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) or p.startswith("/") \
                or ".." in p.split("/"):
            raise SpecError("path %r is not a relative path in the checkout"
                            % p)
    names = set()
    configs = {}
    for c in bench["configs"]:
        _keys(c, CONFIG_KEYS, "config")
        _name(c["name"], "config")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        if len(c["reduced"]) > 16:
            raise SpecError("config %s reduces more than 16 keys" % c["name"])
        for k in c["reduced"]:
            _name(k, "reduced key")
        if not (root / c["file"]).is_file():
            raise SpecError("config %s: file %s is missing"
                            % (c["name"], c["file"]))
        configs[c["name"]] = c
    cells = set()
    pairs = set()
    for w in bench["workloads"]:
        _keys(w, CELL_KEYS, "workload")
        for key in ("name", "config", "traffic"):
            _name(w[key], "workload " + key)
        _line(w["why"], "workload why")
        if w["config"] not in configs:
            raise SpecError("workload %s names unknown config %r"
                            % (w["name"], w["config"]))
        if w["chips"] not in (1, 4):
            raise SpecError("workload %s: chips must be 1 or 4" % w["name"])
        if (w["config"], w["traffic"]) in pairs or w["name"] in cells:
            raise SpecError("workload %s repeats a name or a pair"
                            % w["name"])
        traffic_path(w["traffic"], root)       # exists
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    used = {w["config"] for w in bench["workloads"]}
    if set(configs) - used:
        raise SpecError("configs used by no cell: %s"
                        % sorted(set(configs) - used))
    for m in bench["end_to_end"]:
        _metric(m, E2E_KEYS, SOURCES_E2E, cells, "end_to_end metric")
        b = m["bound"]
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            raise SpecError("metric %s: bound %r not in [0.01, 0.25]"
                            % (m["name"], b))
        names.add(m["name"])
    if "setup_s" not in names:
        raise SpecError("end_to_end must hold setup_s")
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        _metric(m, LAYER_KEYS, SOURCES, cells, "per_layer metric")
        _line(m["layer"], "layer")
        if m["moves"] not in e2e:
            raise SpecError("metric %s moves unknown %r"
                            % (m["name"], m["moves"]))
        for cell in m.get("workloads", []):
            if cell not in cells_of(e2e[m["moves"]], bench):
                raise SpecError("metric %s lists %s, which does not report "
                                "%s" % (m["name"], cell, m["moves"]))
        if m["name"] in names:
            raise SpecError("metric name %s repeats" % m["name"])
        names.add(m["name"])
        metric_path(m["name"], root)           # a reader exists


def cells_of(metric: dict, bench: dict) -> list:
    """The cells that report `metric`: its `workloads`, or all."""
    every = [w["name"] for w in bench["workloads"]]
    return list(metric.get("workloads", every))


def load_benchmark(root: Path = ROOT) -> dict:
    path = Path(root) / "BENCHMARK.json"
    with open(path) as f:
        bench = json.load(f)
    validate(bench, Path(root))
    return bench


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SpecError("no workload %r in BENCHMARK.json (there are %s)"
                    % (name, [w["name"] for w in bench["workloads"]]))


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise SpecError("no config %r" % name)


def load_json(path: Path, what: str) -> dict:
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise SpecError("%s %s cannot be read: %s" % (what, path, e)) from e
    if not isinstance(data, dict):
        raise SpecError("%s %s must hold a JSON object" % (what, path))
    return data


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The configuration's file as it is run; it must name a system
    adapter and a reference that exist."""
    entry = config_entry(bench, name)
    cfg = load_json(Path(root) / entry["file"], "config")
    for key in ("system", "reference"):
        if key not in cfg:
            raise SpecError("config %s lacks %r" % (name, key))
        _name(cfg[key], "config " + key)
    module_path("systems", cfg["system"], root)
    module_path("reference", cfg["reference"], root)
    return cfg


def traffic_path(name: str, root: Path = ROOT) -> Path:
    _name(name, "traffic")
    path = Path(root) / "portbench" / "traffic" / (name + ".json")
    if not path.is_file():
        raise SpecError("traffic %r has no file %s" % (name, path))
    return path


def load_traffic(name: str, root: Path = ROOT) -> dict:
    return load_json(traffic_path(name, root), "traffic")


def module_path(kind: str, name: str, root: Path = ROOT) -> Path:
    path = Path(root) / "portbench" / kind / (name + ".py")
    if not path.is_file():
        raise SpecError("%s %r has no file %s" % (kind, name, path))
    return path


def metric_path(name: str, root: Path = ROOT) -> Path:
    _name(name, "metric")
    base = Path(root) / "portbench" / "metrics"
    for stem in (name, name.split(".")[0]):
        path = base / (stem + ".py")
        if path.is_file():
            return path
    raise SpecError("metric %r has no reader %s.py or %s.py in %s"
                    % (name, name, name.split(".")[0], base))


def load_module(path: Path) -> ModuleType:
    """Import the file at `path` as a module of its own."""
    modname = "portbench_" + re.sub(r"\W", "_", str(
        path.relative_to(path.parents[1])))[:-3]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
