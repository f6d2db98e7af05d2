"""The port's frontier-occupancy driver (``ring_occupancy_torch.py``), its
scaling model (``gen_scaling_model_torch.py``) and ``comm_model.main
--frontier-json`` against the JAX package's ``scripts/ring_occupancy.py``
and ``ppr_tpu/parallel/comm_model.py::main``.

Part A: the same sweeps, and each sweep's occupancy and coverage within
1e-5 of JAX's ``dense_coverage`` on the same graph and sources. Part B: the
dense and frontier rings' sweep counts equal to JAX's
``empirical_inflation`` on its 8 virtual CPU devices (the port on ``["cpu"]
* 8``), the same 2x4 mesh (at 4 of 64 blocks within 1%: near-tied block
masses add in another order). The frontier entry that ``--frontier-json``
picks from the same artifact under the same rates is JAX's, with equal
``comm_bytes``."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import gen_scaling_model_torch
import ring_occupancy_torch
from ppr_tpu.cli import load_dataset as jax_load
from ppr_tpu.parallel import comm_model as jcm
from ppr_tpu_torch.cli import load_dataset
from ppr_tpu_torch.parallel import comm_model as tcm
from ppr_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parents[1]
SPEC = "synth:2048x8@5"
#: the rates both comm models are given (the JAX package's v5e defaults)
V5E = dict(spmv_ns_per_edge=12.0, link_bytes_per_s=9.0e10)


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_ring_occupancy", ROOT / "scripts" / "ring_occupancy.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the ring is many small ops a shard, which threads
    only slow down beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def graphs():
    jds, tds = jax_load(SPEC), load_dataset(SPEC, device="cpu")
    deg = tds.graph.out_deg[: tds.graph.n].numpy()
    cand = np.nonzero(deg > 0)[0]
    sources = np.random.default_rng(0).choice(
        cand, size=16, replace=False).astype(np.int32)
    return jds, tds, sources


def test_constants_are_jax_s():
    jax_mod = jax_script()
    assert ring_occupancy_torch.NBLK == jax_mod.NBLK
    assert ring_occupancy_torch.FRACS == jax_mod.FRACS


@pytest.mark.parametrize("param", [0.5, 0.2])
def test_dense_coverage_matches_jax(graphs, param):
    jds, tds, sources = graphs
    jrows, jagg = jax_script().dense_coverage(jds, sources, param)
    trows, tagg = ring_occupancy_torch.dense_coverage(tds, sources, param)
    assert tagg["sweeps"] == jagg["sweeps"] == len(trows) == len(jrows)
    for jr, tr in zip(jrows, trows):
        assert set(tr) == set(jr)
        for key in jr:
            assert abs(tr[key] - jr[key]) <= 1e-5 * max(1.0, abs(jr[key])), \
                (jr["sweep"], key)
    assert set(tagg) == set(jagg)
    for key in jagg:
        assert abs(tagg[key] - jagg[key]) <= 1e-5, key


def test_inflation_matches_jax(graphs):
    jds, tds, sources = graphs
    caps, orders = (4, 8, 16, 64), ("degree", "id")
    want = jax_script().empirical_inflation(jds, sources, 0.5,
                                            orders=orders, caps=caps)
    mesh = make_mesh(8, data=2, graph=4, devices=["cpu"] * 8)
    got = ring_occupancy_torch.empirical_inflation(
        tds, sources, 0.5, mesh, orders=orders, caps=caps)
    assert got["mesh"] == {"data": 2, "graph": 4}
    assert got["dense_sweeps"] == want["dense_sweeps"]
    assert abs(got["dense_oracle_err"] - want["dense_oracle_err"]) <= 1e-5
    assert len(got["frontier"]) == len(want["frontier"]) == 8
    for g, w in zip(got["frontier"], want["frontier"]):
        for key in ("block_order", "capacity_blocks", "capacity_frac"):
            assert g[key] == w[key], key
        if g["capacity_blocks"] >= 8:
            assert g["sweeps"] == w["sweeps"]
        else:
            # 4 of 64 blocks: near-tied block masses, summed in another
            # order, can send another block on a late sweep (degree order
            # here: 246 sweeps against JAX's 244)
            assert abs(g["sweeps"] - w["sweeps"]) <= 0.01 * w["sweeps"]
        assert abs(g["oracle_err"] - w["oracle_err"]) <= 1e-5
        if g["capacity_blocks"] == 64:
            # full capacity is the dense ring, bit for bit
            assert g["values_equal_dense"] and g["ids_match_dense"]


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    out = tmp_path_factory.mktemp("occ") / "occ.json"
    assert ring_occupancy_torch.main([
        "--device", "cpu", "--graphs", SPEC, "--batch", "16", "--caps",
        "4,8,16,32", "--orders", "degree", "--out", str(out)]) == 0
    return out


def test_artifact_keys(artifact):
    rec = json.loads(artifact.read_text())
    assert set(rec) >= {"param", "k", "batch", "nblk_global", "graphs"}
    assert rec["device"] == {"type": "cpu", "card": "cpu"}
    entry = rec["graphs"][SPEC]
    assert set(entry) == {"n", "m", "aggregate", "per_sweep", "empirical"}
    assert [f["capacity_blocks"] for f in entry["empirical"]["frontier"]] \
        == [4, 8, 16, 32]


def k3_rate(monkeypatch, ns_edge):
    """K3's ns an edge, fixed: ``main`` measures it, and the parity needs
    the rate JAX's model is given."""
    monkeypatch.setattr(tcm, "measure_spmv_ns_per_edge",
                        lambda g, batch, reps=10: ns_edge)


@pytest.mark.parametrize("batch", [16, 512, 2048])
def test_frontier_json_picks_jax_s_entry(artifact, capsys, monkeypatch,
                                         batch):
    k3_rate(monkeypatch, V5E["spmv_ns_per_edge"])
    argv = ["--n", "2048", "--deg", "8", "--batch", str(batch),
            "--frontier-json", str(artifact), "--frontier-graph", SPEC]
    assert jcm.main(argv) == 0
    want = json.loads(capsys.readouterr().out)
    assert tcm.main(argv + [
        "--device", "cpu", "--seed", "3",
        "--link-bytes-per-s", str(V5E["link_bytes_per_s"])]) == 0
    got = json.loads(capsys.readouterr().out)
    w = want["node_sharded_2host_frontier_bf16"]
    g = got["prediction"]["node_sharded_2host_frontier_bf16"]
    assert g["comm_bytes"] == w["comm_bytes"]
    for key in ("capacity_frac", "sweep_inflation", "s_graph", "batch"):
        assert g[key] == w[key], key
    assert abs(g["t_sweep_s"] - w["t_sweep_s"]) <= 1e-12
    assert got["frontier_candidates_measured"] == \
        want["frontier_candidates_measured"]


def test_frontier_json_without_a_link(artifact, capsys, monkeypatch):
    """No link rate: the candidates are listed and nothing is predicted."""
    k3_rate(monkeypatch, 1.0)
    assert tcm.main(["--device", "cpu", "--n", "2048", "--deg", "8",
                     "--batch", "16",
                     "--frontier-json", str(artifact),
                     "--frontier-graph", SPEC]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["prediction"] is None and got["link_bytes_per_s"] is None
    assert len(got["frontier_candidates_measured"]) == 4


def test_gen_scaling_model_on_the_cpu(artifact, tmp_path, monkeypatch):
    k3_rate(monkeypatch, 12.0)
    out = tmp_path / "model.json"
    assert gen_scaling_model_torch.main([
        "--device", "cpu", "--n", "2048", "--seed", "5", "--occupancy",
        f"{artifact},{artifact}", "--link-bytes-per-s", "9e10",
        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["link_source"] == "argument" and rec["batch"] == 16
    assert rec["batch_16"]["batch"] == 16
    front = rec["node_sharded_2host_frontier_bf16"]
    cands = rec["frontier_candidates_measured"]
    assert front["capacity_frac"] in [c["capacity_frac"] for c in cands]
    assert rec["measured_breakdown"]["platform"] == "cpu"
    # JAX's scaling model on the same graph, rates and measured point
    from ppr_tpu.graph.io import synthetic_powerlaw

    jg = synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0).graph
    want = jcm.two_host_prediction(
        jg, batch=16, spmv_ns_per_edge=12.0, ici_bytes_per_s=9e10,
        frontier={k: front[k] for k in ("capacity_frac",
                                         "sweep_inflation")})
    for key in ("node_sharded_2host", "node_sharded_2host_bf16_ring",
                "node_sharded_2host_frontier_bf16", "graph_parallel_2host"):
        assert rec[key]["comm_bytes"] == want[key]["comm_bytes"]
        assert abs(rec[key]["efficiency"] - want[key]["efficiency"]) <= 1e-12


@pytest.mark.parametrize("mod", [ring_occupancy_torch,
                                 gen_scaling_model_torch])
def test_exits_without_a_card(mod, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.json"
    assert mod.main(["--out", str(out)]) == 1
    assert not out.exists()
    assert mod.parse_args([]).out.endswith("_h100.json")


def test_skip_inflation_leaves_part_b_out(artifact, tmp_path):
    """``--skip-inflation``: Part A as the full run's, no ``empirical``."""
    out = tmp_path / "a.json"
    assert ring_occupancy_torch.main([
        "--device", "cpu", "--graphs", SPEC, "--batch", "16",
        "--skip-inflation", "--out", str(out)]) == 0
    entry = json.loads(out.read_text())["graphs"][SPEC]
    full = json.loads(artifact.read_text())["graphs"][SPEC]
    assert set(entry) == {"n", "m", "aggregate", "per_sweep"}
    assert entry["aggregate"] == full["aggregate"]
    assert entry["per_sweep"] == full["per_sweep"]
    assert not ring_occupancy_torch.parse_args([]).skip_inflation
