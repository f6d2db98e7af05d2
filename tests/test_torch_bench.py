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
        (65536, 16, 2048, 0.5, 10, 0.15, 16, 32, None)
    # bench.py's rule (bench.py:212-213): 4096 hubs at B >= 1024, else auto
    assert bench_torch.hub_count(args.batch, args.hub_split) == 4096
    assert bench_torch.hub_count(1024) == 4096
    assert bench_torch.hub_count(512) == "auto"
    assert bench_torch.hub_count(512, 2048) == 2048
    quick = bench_torch.parse_args(["--quick"])
    assert (quick.n, quick.batch, quick.cpu_queries) == (4096, 8, 1)
    assert bench_torch.hub_count(quick.batch, quick.hub_split) == "auto"


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


LATENCY_CPU = ["--device", "cpu", "--db", "synth:300x3@3", "--max-batch",
               "16", "--rates", "0.25", "--duration-s", "0.3", "--queries",
               "64"]


def test_serving_latency_calibrate_reaches_the_service(tmp_path,
                                                      monkeypatch):
    """``--calibrate`` builds ``PPRService(calibrate=True)``; the artifact
    holds the constants it measured and the path at every prewarmed rung,
    and without the flag the code's constants."""
    import serving_latency_torch
    from ppr_tpu_torch.models.fora import _default_cost_constants
    from ppr_tpu_torch.service import PPRService

    seen = []
    init = PPRService.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("calibrate"))
        init(self, *a, **kw)

    monkeypatch.setattr(PPRService, "__init__", spy)
    recs = {}
    for flag in (False, True):
        out = tmp_path / f"{flag}.json"
        assert serving_latency_torch.main(
            LATENCY_CPU + ["--out", str(out)]
            + (["--calibrate"] if flag else [])) == 0
        recs[flag] = json.loads(out.read_text())["cost_model"]
    assert seen == [False, True]
    code = _default_cost_constants(torch.device("cpu"))
    assert recs[False]["calibrate"] is False
    assert recs[False]["constants"]["walk_ns"] == code[0]
    assert recs[True]["calibrate"] is True
    assert recs[True]["constants"]["walk_ns"] != code[0]
    for rec in recs.values():
        assert [r["width"] for r in rec["rungs"]] == [8, 16]
        for r in rec["rungs"]:
            assert r["path"] in ("annealed", "push+walks")
            assert r["prewarm_ms"] > 0 and r["walk_ns"] > 0


@pytest.mark.parametrize("flag", [False, True])
def test_serving_latency_daemon_cmd_carries_calibrate(flag):
    """Daemon mode passes ``--calibrate`` to the daemon, as the JAX
    script does (``scripts/serving_latency.py:114-115``)."""
    import serving_latency_torch

    args = serving_latency_torch.parse_args(
        ["--daemon", "--device", "cpu", "--db", "synth:300x3@3"]
        + (["--calibrate"] if flag else []))
    cmd = serving_latency_torch.daemon_cmd(args)
    assert cmd[1:3] == ["-m", "ppr_tpu_torch.serving"]
    assert ("--calibrate" in cmd) == flag
    assert cmd[cmd.index("--device") + 1] == "cpu"


def test_serving_latency_needs_a_card(monkeypatch, tmp_path):
    import serving_latency_torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.json"
    assert serving_latency_torch.main(["--out", str(out)]) == 1
    assert serving_latency_torch.main(["--daemon", "--out", str(out)]) == 1
    assert not out.exists()
