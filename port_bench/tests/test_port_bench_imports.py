"""Nothing the benchmark runs loads JAX or the JAX package, and the plain reference
loads nothing of the system under test. Top-level module names are compared whole: the
system's name, ``r3m_tpu_torch``, begins with the JAX package's."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

from port_bench import harness

BENCH = harness.HERE


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(folder: str):
    for base, _, files in os.walk(folder):
        yield from (os.path.join(base, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources(BENCH):
        if os.sep + "tests" + os.sep in path:
            continue
        found = set(_imports(path)) & set(harness.FORBIDDEN)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_system():
    for path in _sources(os.path.join(BENCH, "reference")):
        names = set(_imports(path))
        assert "r3m_tpu_torch" not in names and not names & set(harness.FORBIDDEN), path


def test_a_run_loads_no_forbidden_module():
    """A whole run of a small cell on the CPU, in a fresh process, then the same check of
    ``sys.modules`` the benchmark makes before it prints a result."""
    code = (
        "import sys, time; sys.path.insert(0, %r)\n"
        "from port_bench.tests.tiny import tiny_spec\n"
        "from port_bench import harness\n"
        "r, c = harness.run_cell(tiny_spec('train_vit_b32'), 3, 0.2, True, 'cpu', "
        "time.perf_counter())\n"
        "print(harness.forbidden_modules(), r['attempted'] > 0)\n"
    ) % harness.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_no_card_no_result(tmp_path):
    """Without a card the benchmark exits with another code than 0 and prints nothing;
    so it does in a directory that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (harness.ROOT, str(tmp_path)):
        out = subprocess.run([sys.executable, "port_bench/run.py", "--workload",
                              "train_resnet50", "--seed", "1", "--seconds", "1", "--trace", "0"],
                             capture_output=True, text=True, timeout=300, cwd=cwd)
        assert out.returncode != 0 and out.stdout.strip() == "", (cwd, out.stdout[-500:])
