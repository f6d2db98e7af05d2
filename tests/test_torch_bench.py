"""The port's bench (``bench_torch.py``): its CPU baseline is
``bench.CpuFora`` to the bit, and it runs on the card only."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bench
import bench_torch
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.utils.cpu_fora import CpuFora

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("n,deg,k", [(2048, 8, 10), (300, 3, 5)])
def test_cpu_fora_equals_bench_cpu_fora(n, deg, k):
    """Same graph, same numpy generator: the same estimates, bit for bit."""
    jds = synthetic_powerlaw(n, deg, seed=3, dense_threshold=0)
    jg = jds.graph
    tds = Dataset(graph=graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu"), names=jds.names, name=jds.name)
    ref, port = bench.CpuFora(jds, 0.15, k), CpuFora(tds, 0.15, k)
    rng_ref, rng_port = np.random.default_rng(1), np.random.default_rng(1)
    for s in np.random.default_rng(0).integers(0, n, 4):
        np.testing.assert_array_equal(port.topk(int(s), 0.5, rng_port),
                                      ref.topk(int(s), 0.5, rng_ref))


def test_bench_torch_args_match_bench():
    args = bench_torch.parse_args([])
    assert (args.n, args.deg, args.batch, args.eps, args.k, args.alpha,
            args.cpu_queries, args.acc_queries, args.hub_split) == \
        (65536, 16, 2048, 0.5, 10, 0.15, 16, 32, 4096)
    quick = bench_torch.parse_args(["--quick"])
    assert (quick.n, quick.batch, quick.cpu_queries) == (4096, 8, 1)


def test_bench_torch_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_torch.main(["--quick"]) == 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.run(bench_torch.parse_args(["--quick"]))


def test_bench_torch_exits_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    proc = subprocess.run([sys.executable, "bench_torch.py", "--quick"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


def test_serving_latency_torch_on_the_cpu(tmp_path):
    """The latency script, in process on the CPU at a small size: one load
    point, every future waited for, percentiles in order."""
    import serving_latency_torch

    out = tmp_path / "lat.json"
    assert serving_latency_torch.main([
        "--device", "cpu", "--db", "synth:300x3@3", "--max-batch", "16",
        "--rates", "0.25", "--duration-s", "0.5", "--queries", "64",
        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == "cpu" and rec["capacity_qps"] > 0
    [row] = rec["rows"]
    assert row["requests"] > 0 and row["p50_ms"] <= row["p99_ms"]
