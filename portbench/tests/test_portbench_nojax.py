"""Nothing of JAX, its libraries, the JAX package or the root's bench.py
in a run: by whole top-level names, in the sources and in sys.modules."""

import ast
import subprocess
import sys

from portbench import harness

from conftest import ROOT


def test_top_level_names_compared_whole():
    mods = ["gelly_streaming_tpu_torch", "gelly_streaming_tpu_torch.ops",
            "jaxtyping", "benchmarks", "torch", "portbench.harness"]
    assert harness.forbidden_modules(mods) == []
    assert harness.forbidden_modules(mods + ["jax.numpy"]) == ["jax"]
    assert harness.forbidden_modules(
        ["gelly_streaming_tpu.core", "jaxlib", "flax.linen", "bench"]) == \
        ["bench", "flax", "gelly_streaming_tpu", "jaxlib"]


def test_sources_import_none_of_it():
    for path in (ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and not node.level:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in harness.FORBIDDEN, (path, n)


def test_reference_imports_nothing_of_the_program():
    src = (ROOT / "portbench/reference/gcn_round.py").read_text()
    tree = ast.parse(src)
    mods = {a.name.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.Import) for a in n.names}
    mods |= {n.module.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    assert mods <= {"__future__", "contextlib", "torch"}


def test_a_toy_run_loads_none_of_it(tmp_path):
    code = (
        "import sys, time\n"
        "sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from conftest import make_toy_root\n"
        "from portbench import harness\n"
        "from pathlib import Path\n"
        "root, bench = make_toy_root(Path(%r))\n"
        "res, _ = harness.execute(bench, 'toy.bulk', 5, 0.2, False,\n"
        "                         time.perf_counter(), device='cpu',\n"
        "                         root=root)\n"
        "assert res['correct']\n"
        "print(harness.forbidden_modules())\n"
        % (str(ROOT), str(ROOT / "portbench/tests"), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
