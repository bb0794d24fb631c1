"""The import rule: nothing under benchmark/ imports JAX, flax or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the yardstick imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from benchmark import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "poem_v2_tpu"}
PROGRAM = "poem_v2_tpu_torch"


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(glob.glob(os.path.join(harness.BENCH_DIR, "**", "*.py"), recursive=True))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, harness.ROOT))
def test_no_jax_anywhere(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_the_port_is_not_the_jax_package():
    # compared whole, the port's name is allowed, though it begins with the JAX package's
    assert PROGRAM.split(".")[0] not in FORBIDDEN and PROGRAM.startswith("poem_v2_tpu")


@pytest.mark.parametrize("sub", ["reference", "counts", "generator.py", "weights.py", "readers.py"])
def test_yardstick_imports_nothing_of_the_program(sub):
    root = os.path.join(harness.BENCH_DIR, sub)
    paths = glob.glob(os.path.join(root, "*.py")) if os.path.isdir(root) else [root]
    for p in paths:
        assert PROGRAM not in imported_top_levels(p), p


def test_a_run_loads_no_jax():
    """The harness, every driver and every metric reader, imported in a fresh
    process, leave no JAX module in sys.modules."""
    code = ("import sys; sys.path.insert(0, %r); from benchmark import harness; "
            "import json; b = json.load(open(%r)); "
            "[harness.load_module('drivers', harness.load_cell(w['name'], b).workload['driver']) "
            "for w in b['workloads']]; "
            "[harness.load_module('metrics', m['name']) for m in b['per_layer']]; "
            "import poem_v2_tpu_torch.serving.predictor, poem_v2_tpu_torch.training.trainer; "
            "print(harness.forbidden_modules())") % (harness.ROOT, os.path.join(harness.ROOT, "BENCHMARK.json"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
