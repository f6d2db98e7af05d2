"""The port's sweep profile (``profile_sweep_torch.py``) against the JAX
package's ``scripts/profile_sweep.py`` on the CPU at ``--quick --hubs 512``:
every variant's sweep count equal to JAX's, the coverage curve equal to the
bit, the artifact written only where ``--out`` points, and exit 1 without a
card. Then the one reader of a kernel trace (``utils/timer.kernel_split``)
on a hand-written trace whose busy time and shares are known."""

import contextlib
import importlib.util
import io
import json
import sys
from pathlib import Path

import pytest
import torch

import profile_sweep_torch
from ppr_tpu_torch.utils.timer import kernel_split

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results"
QUICK = ["--quick", "--hubs", "512"]
VARIANTS = ("plain", "hub512_f32", "hub512_bf16", "annealed_plain",
            "annealed_hub512_bf16")


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_profile_sweep", ROOT / "scripts" / "profile_sweep.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def results_before():
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
            for p in RESULTS.iterdir()}


@pytest.fixture(scope="module")
def jax_lines():
    """The JAX script's printed lines at ``--quick --hubs 512``: its head
    line and its summary."""
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setattr(sys, "argv", ["profile_sweep.py", *QUICK])
        jax_script().main()
    lines = [json.loads(x) for x in out.getvalue().splitlines()
             if x.startswith("{")]
    return lines[0], lines[-1]["summary"]


@pytest.fixture(scope="module")
def port(tmp_path_factory, results_before):
    out = tmp_path_factory.mktemp("ps") / "ps.json"
    assert profile_sweep_torch.main(
        [*QUICK, "--device", "cpu", "--out", str(out)]) == 0
    return json.loads(out.read_text())


@pytest.mark.parametrize("name", VARIANTS)
def test_iters_equal_jax(jax_lines, port, name):
    _, want = jax_lines
    assert port["summary"][name]["iters"] == want[name]["iters"]


def test_quick_sweeps(port):
    """The JAX CPU run's counts at ``--quick``: 86 residual sweeps, 49
    annealed ones."""
    assert {k: v["iters"] for k, v in port["summary"].items()} == {
        "plain": 86, "hub512_f32": 86, "hub512_bf16": 86,
        "annealed_plain": 49, "annealed_hub512_bf16": 49}


def test_coverage_equal_jax(jax_lines, port):
    head, _ = jax_lines
    assert port["coverage"] == head["coverage"]
    assert (port["n"], port["m"]) == (head["n"], head["m"])


def test_rows_on_the_cpu(port):
    assert port["device"] == {"type": "cpu", "card": "cpu"}
    assert port["batch"] == 32 and port["operator"] == "sparse"
    assert set(port["summary"]) == set(VARIANTS)
    for name, row in port["summary"].items():
        assert row["device_ms"] is None and row["total_ms"] > 0
        assert row["first_call_s"] > 0
        if name.startswith("annealed_"):
            assert row["qps"] > 0
        else:
            assert row["sweep_ms"] == pytest.approx(
                row["total_ms"] / row["iters"])
            assert row["sweep_device_ms"] is None
    assert "traces" not in port


def test_artifact_only_where_out_points(port, results_before, tmp_path,
                                        monkeypatch):
    """``--quick`` without ``--out`` writes nothing; no run touches
    ``results/``."""
    monkeypatch.chdir(tmp_path)
    assert profile_sweep_torch.main(
        [*QUICK, "--device", "cpu", "--skip-residual", "--skip-f32"]) == 0
    assert list(tmp_path.iterdir()) == []
    after = {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
             for p in RESULTS.iterdir()}
    assert after == results_before


def test_defaults():
    args = profile_sweep_torch.parse_args([])
    assert (args.n, args.deg, args.batch, args.hubs, args.device) == \
        (65536, 16, 256, "512,2048,4096", "cuda")
    assert args.out == "results/profile_sweep_h100.json"
    quick = profile_sweep_torch.parse_args(["--quick"])
    assert (quick.n, quick.deg, quick.batch, quick.out) == (4096, 8, 32, None)


def test_exits_without_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.json"
    assert profile_sweep_torch.main(["--quick", "--out", str(out)]) == 1
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profile_sweep_torch.run(profile_sweep_torch.parse_args(["--quick"]))


def test_trace_and_keep(tmp_path, monkeypatch):
    """``--trace`` traces each annealed variant (a CPU trace holds no
    kernel); ``keep`` holds each annealed variant's reserve, the same as a
    direct call of the loop."""
    from ppr_tpu_torch.models import fora
    from ppr_tpu_torch.ops.push import forward_push_init

    monkeypatch.chdir(tmp_path)
    args = profile_sweep_torch.parse_args(
        [*QUICK, "--device", "cpu", "--skip-residual", "--skip-f32",
         "--trace"])
    keep = {}
    rec = profile_sweep_torch.run(args, keep=keep)
    assert set(rec["traces"]) == {"annealed_plain", "annealed_hub512_bf16"}
    for tr in rec["traces"].values():
        assert tr["kernels"] == 0 and Path(tr["trace"]).exists()
        assert set(tr["named"]) == {"K3", "hub mm"}
    g = profile_sweep_torch.build(args, torch.device("cpu")).graph
    p0, r0, onehot = forward_push_init(g, keep["sources"])
    assert torch.equal(onehot, keep["onehot"])
    p, _, it = fora.annealed_topk_propagate(
        g, torch.zeros_like(p0), r0, onehot, profile_sweep_torch.EPS, 0.1,
        1.0 / g.n, 10, 0.15)
    assert int(it) == rec["summary"]["annealed_plain"]["iters"]
    assert torch.equal(keep["annealed_plain"], p)


# --- the one reader of a kernel trace ------------------------------------

def _trace(path):
    """Kernels A [0, 10), B [5, 15) (overlapping A), A [20, 30) and C [40,
    45) us; A and B linked to ``aten::mm``, C to ``aten::add``, a CPU op
    and a runtime call that are no kernels."""
    def kernel(name, ts, dur, ext):
        return {"ph": "X", "cat": "kernel", "name": name, "ts": ts,
                "dur": dur, "args": {"External id": ext}}

    events = [
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 2,
         "args": {"External id": 1}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 3, "dur": 2,
         "args": {"External id": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 0, "dur": 100, "args": {"External id": 1}},
        kernel("A_gemm", 0, 10, 1), kernel("B_ppr_gather_kernel", 5, 10, 1),
        kernel("A_gemm", 20, 10, 1), kernel("C", 40, 5, 2),
    ]
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_kernel_split_on_a_hand_written_trace(tmp_path):
    split = kernel_split(str(_trace(tmp_path / "t.json")),
                         named={"K3": ("ppr_gather_kernel",),
                                "mm": ("gemm", "nvjet")})
    # busy: [0, 15) + [20, 30) + [40, 45) = 30 us in a span of 45 us
    assert split["kernels"] == 4
    assert split["busy_ms"] == pytest.approx(0.030)
    assert split["span_ms"] == pytest.approx(0.045)
    assert split["idle_share"] == pytest.approx(1 - 30 / 45)
    assert [(k["name"], k["launches"]) for k in split["by_kernel"]] == \
        [("A_gemm", 2), ("B_ppr_gather_kernel", 1), ("C", 1)]
    assert [k["ms"] for k in split["by_kernel"]] == \
        pytest.approx([0.020, 0.010, 0.005])
    # shares of the busy time: overlap counts in each kernel's own time
    assert [k["share"] for k in split["by_kernel"]] == \
        pytest.approx([20 / 30, 10 / 30, 5 / 30])
    assert [(o["name"], o["launches"]) for o in split["by_op"]] == \
        [("aten::mm", 3), ("aten::add", 1)]
    assert split["by_op"][0]["ms"] == pytest.approx(0.030)
    assert split["named"]["K3"] == pytest.approx(
        {"ms": 0.010, "launches": 1, "share": 10 / 30})
    assert split["named"]["mm"]["launches"] == 2


def test_kernel_split_top_and_empty(tmp_path):
    split = kernel_split(str(_trace(tmp_path / "t.json")), top=1)
    assert [k["name"] for k in split["by_kernel"]] == ["A_gemm"]
    assert "named" not in split
    empty = tmp_path / "e.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    split = kernel_split(str(empty))
    assert (split["kernels"], split["busy_ms"], split["span_ms"],
            split["idle_share"], split["by_kernel"]) == (0, 0.0, 0.0, None,
                                                         [])
