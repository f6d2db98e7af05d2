"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference imports nothing of the
program; ``run.py`` exits non-zero without a card."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "ppr_tpu"}


def imported_top_levels(path):
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    assert imported_top_levels(BENCH / "reference.py") <= {
        "__future__", "math", "numpy", "torch"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "ppr_tpu_torch_fake", object())
    assert "ppr_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ppr_tpu.fake_sub", object())
    assert run.forbidden_modules() == ["ppr_tpu"]


def test_a_cpu_run_loads_no_forbidden_module(tmp_path):
    """A whole run of a tiny cell on the CPU, in a fresh interpreter: every
    module ``run.py`` and the program import, then the check."""
    code = f"""
import sys, json, torch
sys.path.insert(0, {str(ROOT)!r}); sys.path.insert(0, {str(BENCH / 'tests')!r})
import bench_tiny, pathlib
from benchmark import run
from benchmark.manifest import Manifest
tmp = pathlib.Path({str(tmp_path)!r})
man = bench_tiny.make_tiny_manifest(tmp)
out = run.run_cell(man, "tiny.batch", 5, 0.5, False, torch.device("cpu"))
print(json.dumps(run.forbidden_modules()))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_nonzero_without_a_card():
    res = subprocess.run([sys.executable, str(BENCH / "run.py"),
                          "--workload", "flickr.batch", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert res.stdout.strip() == ""
