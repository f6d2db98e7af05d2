"""The port imports neither JAX nor the JAX package: importing it and every
module of the slice in a fresh interpreter leaves no ``jax`` and no
``ppr_tpu`` module loaded."""

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

MODULES = [
    "ppr_tpu_torch",
    "ppr_tpu_torch.device",
    "ppr_tpu_torch.graph.csr",
    "ppr_tpu_torch.graph.io",
    "ppr_tpu_torch.graph.neostore",
    "ppr_tpu_torch.native",
    "ppr_tpu_torch.ops.spmv",
    "ppr_tpu_torch.ops.hub_split",
    "ppr_tpu_torch.ops.push",
    "ppr_tpu_torch.ops.topk",
    "ppr_tpu_torch.ops.cuda_build",
    "ppr_tpu_torch.ops.dense_power",
    "ppr_tpu_torch.ops.probe",
    "ppr_tpu_torch.ops.compact",
    "ppr_tpu_torch.ops.row_gather",
    "ppr_tpu_torch.ops.walk",
    "ppr_tpu_torch.models.base",
    "ppr_tpu_torch.models.power_method",
    "ppr_tpu_torch.models.fora",
    "ppr_tpu_torch.models.neo4j_method",
    "ppr_tpu_torch.models.forward_push",
    "ppr_tpu_torch.models.backward_search",
    "ppr_tpu_torch.models.base_allpair",
    "ppr_tpu_torch.models.monte_carlo",
    "ppr_tpu_torch.models.config",
    "ppr_tpu_torch.utils.metrics",
    "ppr_tpu_torch.utils.store",
    "ppr_tpu_torch.utils.report",
    "ppr_tpu_torch.utils.timer",
    "ppr_tpu_torch.utils.cuda_timing",
    "ppr_tpu_torch.utils.cpu_fora",
    "ppr_tpu_torch.utils.calibrate",
    "ppr_tpu_torch.utils.drivers",
    "ppr_tpu_torch.service",
    "ppr_tpu_torch.serving",
    "ppr_tpu_torch.harness",
    "ppr_tpu_torch.cli",
    "ppr_tpu_torch.parallel",
    "ppr_tpu_torch.parallel.mesh",
    "ppr_tpu_torch.parallel.sharded",
    "ppr_tpu_torch.parallel.sharded_fora",
    "ppr_tpu_torch.parallel.node_sharded",
    "ppr_tpu_torch.parallel.node_sharded_fora",
    "ppr_tpu_torch.parallel.dryrun",
    "ppr_tpu_torch.parallel.mesh_algos",
    "ppr_tpu_torch.parallel.sharded_allpair",
    "ppr_tpu_torch.parallel.node_sharded_allpair",
    "ppr_tpu_torch.parallel.scaling",
    "ppr_tpu_torch.parallel.comm_model",
    "ppr_tpu_torch.parallel.distributed",
    "chip_smoke",
    "dense_power_ablation",
    "row_gather_ablation",
    "bench_torch",
    "serving_latency_torch",
    "hub_knee_torch",
    "scale_1m_torch",
    "scale_1m_knee_torch",
    "ring_occupancy_torch",
    "gen_scaling_model_torch",
    "dist_protocol_ab",
    "protocol_grid_torch",
    "protocol_grid_reference",
    "mc_deposit_torch",
    "profile_sweep_torch",
]

_PROBE = """
import importlib, json, sys
for name in sys.argv[1:]:
    importlib.import_module(name)
print(json.dumps(sorted(sys.modules)))
"""


@pytest.fixture(scope="module")
def loaded():
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, *MODULES], cwd=root,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


_JAX_IMPORT = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|ppr_tpu)\b", re.M)


def _is_jax(name):
    return name.split(".")[0] in ("jax", "jaxlib", "ppr_tpu")


def test_no_jax_loaded(loaded):
    assert not sorted(m for m in loaded if _is_jax(m))


@pytest.mark.parametrize("module", MODULES)
def test_module_imported_without_jax(loaded, module):
    assert module in loaded
    path = Path(__file__).resolve().parents[1].joinpath(*module.split("."))
    source = path.with_suffix(".py")
    if not source.exists():
        source = path / "__init__.py"
    assert not _JAX_IMPORT.search(source.read_text())


def test_store_writer_imports_without_jax():
    """``chip_smoke.py`` writes its Neo4j store with
    ``tests/test_torch_neostore.write_store``: importing that test module
    loads no JAX (its JAX imports sit inside the tests)."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, "tests.test_torch_neostore"],
        cwd=root, capture_output=True, text=True, timeout=120, check=True,
    )
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "tests.test_torch_neostore" in loaded
    assert not sorted(m for m in loaded if _is_jax(m))
