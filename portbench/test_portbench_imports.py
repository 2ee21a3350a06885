"""Nothing the benchmark runs loads jax or the JAX package; the reference
loads nothing of the program either. Top-level module names are compared
whole: bayestyper_tpu_torch is not bayestyper_tpu."""

import ast
import json
import os
import subprocess
import sys
import types

import pytest

from portbench import run

HERE = os.path.dirname(os.path.abspath(__file__))
JAX = {"jax", "jaxlib", "flax", "bayestyper_tpu"}


def _loaded_after(code):
    """Top-level names of the modules a fresh interpreter holds after
    running code from the repository's root."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=os.path.dirname(HERE), capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=os.path.dirname(HERE)))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole (tiny, CPU) run of a cell, as run.py makes it."""
    loaded = _loaded_after(
        "import sys; sys.path.insert(0, 'portbench')\n"
        "from conftest import tiny_run\n"
        "result, checks = tiny_run()\n"
        "assert result['correct'], checks\n")
    assert "bayestyper_tpu_torch" in loaded
    assert not loaded & JAX


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import portbench.reference, portbench.kmers")
    assert "torch" in loaded and "numpy" in loaded
    assert not loaded & (JAX | {"bayestyper_tpu_torch"})


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_and_reference_stays_plain():
    for root, _, files in os.walk(HERE):
        for f in files:
            if not f.endswith(".py"):
                continue
            names = set(_imports(os.path.join(root, f)))
            assert not names & JAX, f
            if f in ("reference.py", "kmers.py"):
                assert "bayestyper_tpu_torch" not in names, f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bayestyper_tpu_torch.fake",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping_like", types.ModuleType("x"))
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "bayestyper_tpu.engine",
                        types.ModuleType("x"))
    assert "bayestyper_tpu" in run.forbidden_modules()


def test_no_result_without_a_card():
    """run.py refuses without CUDA: exit 3 and nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "r3-bulk-seq", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == ""
