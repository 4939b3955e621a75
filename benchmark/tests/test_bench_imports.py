"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (so lpformer_tpu_torch is not lpformer_tpu),
and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys

import pytest

from lpbench.spec import BENCH_DIR, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "lpformer_tpu", "bench"}
PROGRAM = "lpformer_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        if "tests" in d.split(os.sep) or ".cache" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_no_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, BENCH_DIR))
def test_reference_is_independent(path):
    assert PROGRAM not in set(_imports(path))


def test_whole_names_compare(monkeypatch):
    import types

    import run as bench_run
    __import__(PROGRAM)
    assert "lpformer_tpu" not in sys.modules
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "lpformer_tpu.models",
                        types.ModuleType("y"))
    assert bench_run.forbidden_modules() == ["jax", "lpformer_tpu"]


def test_no_card_means_no_result():
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "citation2-like.eval",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = ['benchmark/tests', 'benchmark', '.'];"
            "from tiny import run_tiny; run_tiny('citation2-like.eval');"
            "import run; print(run.forbidden_modules())")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
