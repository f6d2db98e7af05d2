"""The benchmark's own tests (``python -m pytest benchmark/tests``): the
manifest, the reference and the check, the import rule, the traffic and
the trace reader, on the CPU at tiny sizes. They import no JAX."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def tiny_manifest(tmp_path):
    from bench_tiny import make_tiny_manifest

    return make_tiny_manifest(tmp_path)
