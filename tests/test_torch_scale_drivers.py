"""The port's hub-knee and 1M-node drivers (``hub_knee_torch.py``,
``scale_1m_torch.py``, ``scale_1m_knee_torch.py``) in process on the CPU
at a tiny size: their artifacts' keys, the automatic count equal to the
JAX package's under the same prices (an exact integer), the JAX 1M
artifact's keys kept, and no pre-port artifact under ``results/`` touched.
Without a card and without ``--device cpu`` each exits 1."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hub_knee_torch
import scale_1m_knee_torch
import scale_1m_torch
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.ops.hub_split import auto_num_hubs as jax_auto
from ppr_tpu_torch.ops import hub_split as ths

ROOT = Path(__file__).resolve().parents[1]
RESULTS = ROOT / "results"
#: the JAX package's TPU artifacts these drivers port, which they never write
PRE_PORT = ("hub_knee_r4.json", "hub_knee_b2048.json", "scale_1m_nodes.json",
            "scale_1m_knee.json", "ring_occupancy.json", "scaling_model.json")


@pytest.fixture(scope="module")
def results_before():
    return {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
            for p in RESULTS.iterdir()}


def assert_results_untouched(before):
    after = {p.name: (p.stat().st_mtime_ns, p.stat().st_size)
             for p in RESULTS.iterdir()}
    assert after == before
    for name in PRE_PORT:
        assert name in after


def jax_rule(n, deg, seed):
    g = synthetic_powerlaw(n, deg, seed=seed, dense_threshold=0).graph
    return jax_auto(g, jnp.bfloat16, tail_ns_per_edge=ths.TAIL_NS_PER_EDGE,
                    hbm_gbps=ths.HUB_COLUMN_GBPS)


def test_defaults_write_h100_artifacts():
    for mod in (hub_knee_torch, scale_1m_torch, scale_1m_knee_torch):
        out = mod.parse_args([]).out
        assert out.startswith("results/") and out.endswith("_h100.json")
        assert Path(out).name not in PRE_PORT
    assert hub_knee_torch.parse_args([]).batches == "256,512,1024,2048,4096"
    # the ladders reach below the rule's counts on both graphs (512 and
    # 128), so a knee is not read at a ladder's edge
    assert hub_knee_torch.parse_args([]).hubs == \
        "256,384,512,1024,2048,4096,8192,16384"
    assert scale_1m_knee_torch.parse_args([]).batches == \
        "256,512,1024,1536,2048"
    assert scale_1m_knee_torch.parse_args([]).hubs == \
        "256,512,768,1024,1920,4096,8192"
    args = scale_1m_torch.parse_args([])
    assert (args.n, args.deg, args.seed) == (1 << 20, 8, 11)


@pytest.mark.parametrize("mod", [hub_knee_torch, scale_1m_torch,
                                 scale_1m_knee_torch])
def test_exits_without_a_card(mod, monkeypatch, tmp_path, results_before):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "x.json"
    assert mod.main(["--out", str(out)]) == 1
    assert not out.exists()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.run(mod.parse_args([]))
    assert_results_untouched(results_before)


def test_hub_knee_on_the_cpu(tmp_path, results_before):
    out = tmp_path / "hk.json"
    assert hub_knee_torch.main([
        "--device", "cpu", "--n", "2048", "--deg", "8", "--batches", "8,16",
        "--hubs", "128,256", "--reps", "1", "--host-split", "16,128",
        "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["device"] == {"type": "cpu", "card": "cpu"}
    rule = rec["rule"]["auto_hubs"]
    assert rule == jax_rule(2048, 8, 42)
    assert rec["rule"]["tail_ns_per_edge"] == ths.TAIL_NS_PER_EDGE
    assert {r["hubs"] for r in rec["rows"]} == {128, 256, rule}
    for r in rec["rows"]:
        assert set(r) >= {"batch", "hubs", "qps", "sweeps", "ms_per_sweep",
                          "peak_gb", "tail_edges", "hub_edge_cover", "rule"}
        assert r["peak_gb"] is None and r["qps"] > 0 and r["sweeps"] > 0
        assert 0 < r["hub_edge_cover"] < 1
    assert set(rec["knee"]) == {"8", "16"}
    for knee in rec["knee"].values():
        assert knee["rule_hubs"] == rule and knee["rule_qps_lost"] >= 0
    split = rec["host_split"]
    assert set(split["parts_ms"]) == {"one_hot_init", "loop", "epilogue",
                                      "to_host", "tie_expansion"}
    assert split["sweeps"] > 0
    assert split["parts_ms"]["loop"] == pytest.approx(
        split["device_path_ms"] - split["parts_ms"]["one_hot_init"])
    assert "constants" not in rec
    with pytest.raises(RuntimeError, match="on the card"):
        from ppr_tpu_torch.graph.io import synthetic_powerlaw as tpl
        hub_knee_torch.measure_prices(
            tpl(512, 4, seed=1, dense_threshold=0, device="cpu").graph, 8)
    assert_results_untouched(results_before)


def test_scale_1m_on_the_cpu(tmp_path, results_before):
    out = tmp_path / "s1m.json"
    assert scale_1m_torch.main([
        "--device", "cpu", "--n", "4096", "--batch", "16", "--wg-batch",
        "4", "--walkers", "4096", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    jax_keys = json.loads((RESULTS / "scale_1m_nodes.json").read_text())
    assert set(rec) >= set(jax_keys)
    assert rec["n"] == 4096 and rec["topk_batch"] == 16
    assert rec["auto_hubs"] == jax_rule(4096, 8, 11)
    assert 0 <= rec["recall_at_10"] <= 1 and rec["fora_topk_qps"] > 0
    assert len(rec["mass_rows"]) == 4 and rec["wg_finite"]
    # the spmv completion stops at eps/n of residue a row
    assert abs(rec["mass_conservation"] - 1.0) <= 0.5 / 4096 + 1e-6
    assert abs(rec["walks_mass"] - 1.0) <= 1e-6
    # the whole-graph rows of the accuracy sources against the oracle:
    # its top-10 kept, FORA's relative bound eps above 1/n
    assert len(rec["acc_sources"]) == 4 and rec["wg_checked_rows"] == 4
    assert rec["wg_precision_at_10"] == 1.0
    assert rec["wg_rel_err_above_delta"] <= 0.5
    assert_results_untouched(results_before)


def test_scale_1m_measure_returns_the_oracle_rows():
    """``measure``'s oracle rows are the power method's on the record's
    accuracy sources, which lead the top-k batch."""
    from ppr_tpu_torch.models.power_method import power_method_batch

    args = scale_1m_torch.parse_args([
        "--device", "cpu", "--n", "2048", "--batch", "16", "--acc-queries",
        "3", "--wg-batch", "4", "--walkers", "1024"])
    ds = scale_1m_torch.build(args, torch.device("cpu"))
    rec, oracle = scale_1m_torch.measure(args, ds)
    acc = np.asarray(rec["acc_sources"])
    assert len(acc) == 3 and oracle.shape == (3, ds.graph.n_pad)
    assert np.array_equal(
        acc, np.random.default_rng(0).integers(0, 2048, 16)[:3])
    want = power_method_batch(ds.graph, acc, 0.15, 100).numpy()[:3]
    assert np.array_equal(oracle, want)
    assert rec["wg_checked_rows"] == 3


def test_scale_1m_knee_on_the_cpu(tmp_path, results_before):
    out = tmp_path / "knee.json"
    assert scale_1m_knee_torch.main([
        "--device", "cpu", "--n", "4096", "--batches", "8,16", "--hubs",
        "128", "--reps", "1", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    rule = jax_rule(4096, 8, 11)
    assert rec["auto_hubs"] == rule
    assert [(r["batch"], r["hubs"]) for r in rec["rows"]] == \
        [(b, h) for b in (8, 16) for h in sorted({128, rule})]
    assert rec["batch_ceiling"] == {str(h): 16 for h in sorted({128, rule})}
    assert set(rec["knee"]) == {"8", "16"} and rec["best"]["qps"] > 0
    assert_results_untouched(results_before)


def test_oom_point_is_recorded():
    """An out-of-memory point keeps the bytes asked for."""
    err = torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.50 GiB. GPU 0 has a total "
        "capacity of 79.19 GiB")
    row = scale_1m_knee_torch.oom_row(2048, 8192, err, torch.device("cpu"))
    assert row["oom"] and row["qps"] == 0.0
    assert row["asked_bytes"] == 8.5 * 2**30
    assert np.isfinite(row["asked_bytes"])


# --- --db on the knee drivers ---------------------------------------------

def test_db_artifact_names():
    """A ``--db`` run writes its own file, never the default graph's."""
    assert hub_knee_torch.parse_args(["--db", "data/blogcatalog/"]).out \
        == "results/hub_knee_blogcatalog_h100.json"
    assert hub_knee_torch.parse_args(["--db", "synth:blogcatalog"]).out == \
        "results/hub_knee_blogcatalog_h100.json"
    assert scale_1m_knee_torch.parse_args(["--db", "synth:8192x4@3"]).out \
        == "results/scale_1m_knee_8192x4_3_h100.json"
    assert hub_knee_torch.parse_args(["--db", "x", "--out", "a.json"]).out \
        == "a.json"
    assert hub_knee_torch.parse_args([]).db is None


def test_db_bench_graph_is_the_default_graph():
    """``--db synth:65536x16@42`` loads the bench graph the default
    ``--n/--deg/--seed`` builds: n_pad 65,664, m 1,038,206, sparse, the
    same edges."""
    from ppr_tpu_torch.utils.drivers import graph_record

    cpu = torch.device("cpu")
    ds, db = hub_knee_torch.load(hub_knee_torch.parse_args(
        ["--db", "synth:65536x16@42", "--device", "cpu"]), cpu)
    ref, ref_db = hub_knee_torch.load(hub_knee_torch.parse_args(
        ["--device", "cpu"]), cpu)
    assert (db, ref_db) == ("synth:65536x16@42", "synth:65536x16@42")
    assert graph_record(ds.graph) == graph_record(ref.graph) == {
        "n": 65536, "m": 1_038_206, "n_pad": 65_664, "operator": "sparse"}
    assert torch.equal(ds.graph.edge_src_bydst, ref.graph.edge_src_bydst)
    assert torch.equal(ds.graph.edge_dst_bydst, ref.graph.edge_dst_bydst)


def test_db_records_a_dense_operator():
    """``load_dataset("synth:NxD@S")`` keeps the default dense threshold:
    a 2048-node graph carries the dense matrix, the same ``--n`` graph
    does not, and the artifact says which ran."""
    from ppr_tpu_torch.utils.drivers import graph_record

    cpu = torch.device("cpu")
    ds, _ = hub_knee_torch.load(hub_knee_torch.parse_args(
        ["--db", "synth:2048x8@42"]), cpu)
    ref, _ = hub_knee_torch.load(hub_knee_torch.parse_args(
        ["--n", "2048", "--deg", "8"]), cpu)
    assert graph_record(ds.graph)["operator"] == "dense"
    assert graph_record(ref.graph)["operator"] == "sparse"
    assert graph_record(ds.graph)["m"] == graph_record(ref.graph)["m"]


#: a point's fields that do not depend on the clock
DETERMINISTIC = ("batch", "hubs", "sweeps", "tail_edges", "hub_edge_cover",
                 "rule")


@pytest.mark.parametrize("mod,extra", [
    (hub_knee_torch, ["--host-split", "none"]),
    (scale_1m_knee_torch, [])])
def test_db_gives_the_same_rows(mod, extra, tmp_path, results_before):
    """``--db synth:8192x4@5`` and ``--n 8192 --deg 4 --seed 5``: the same
    sparse operator, the same points."""
    common = ["--device", "cpu", "--batches", "8", "--hubs", "128",
              "--reps", "1", *extra]
    recs = []
    for i, graph in enumerate((["--db", "synth:8192x4@5"],
                               ["--n", "8192", "--deg", "4", "--seed", "5"])):
        out = tmp_path / f"{i}.json"
        assert mod.main([*graph, *common, "--out", str(out)]) == 0
        recs.append(json.loads(out.read_text()))
    by_db, by_n = recs
    assert by_db["db"] == "synth:8192x4@5"
    assert by_db["graph"] == by_n["graph"]
    assert by_db["graph"]["operator"] == "sparse"
    assert [{k: r[k] for k in DETERMINISTIC} for r in by_db["rows"]] == \
        [{k: r[k] for k in DETERMINISTIC} for r in by_n["rows"]]
    assert_results_untouched(results_before)


# --- --quick and --phase on the 1M driver --------------------------------

def test_scale_1m_quick_writes_nothing(tmp_path, results_before):
    """``--quick`` is the JAX script's small run, and writes nothing."""
    args = scale_1m_torch.parse_args(["--quick"])
    assert (args.n, args.deg, args.batch, args.wg_batch, args.walkers) == \
        (1 << 14, 8, 16, 4, 1 << 16)
    out = tmp_path / "q.json"
    assert scale_1m_torch.main(["--quick", "--device", "cpu", "--phase",
                                "walks", "--out", str(out)]) == 0
    assert not out.exists()
    assert_results_untouched(results_before)


SMALL_1M = ["--device", "cpu", "--n", "2048", "--batch", "16",
            "--wg-batch", "4", "--walkers", "2048"]


def small_graph_m():
    args = scale_1m_torch.parse_args(SMALL_1M)
    return scale_1m_torch.build(args, torch.device("cpu")).graph.m


@pytest.mark.parametrize("same_graph", [True, False])
def test_scale_1m_phase_merges(tmp_path, same_graph, results_before):
    """``--phase walks`` adds its keys to an artifact of the same n and m,
    keeping the other phases'; of another graph, it writes its own."""
    m = small_graph_m()
    out = tmp_path / "s.json"
    prior = {"n": 2048, "m": m if same_graph else m + 1,
             "fora_topk_qps": 123.0, "recall_at_10": 1.0}
    out.write_text(json.dumps(prior))
    assert scale_1m_torch.main([*SMALL_1M, "--phase", "walks",
                                "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["m"] == m and abs(rec["walks_mass"] - 1.0) <= 1e-6
    assert ("fora_topk_qps" in rec) == same_graph
    if same_graph:
        assert rec["fora_topk_qps"] == 123.0
    assert "mass_rows" not in rec and "acc_sources" not in rec
    assert_results_untouched(results_before)


def test_scale_1m_phases_run_alone():
    """Each phase writes its own keys only; the whole-graph phase builds its
    own hub split and checks the oracle rows."""
    keys = {}
    for phase in ("topk", "wg", "walks"):
        args = scale_1m_torch.parse_args([*SMALL_1M, "--phase", phase])
        keys[phase] = set(scale_1m_torch.run(args))
    assert "fora_topk_qps" in keys["topk"] and "walks_mass" not in keys["topk"]
    assert {"fora_whole_graph_qps", "wg_precision_at_10"} <= keys["wg"]
    assert "fora_topk_qps" not in keys["wg"]
    assert "walks_per_sec" in keys["walks"]
    assert not keys["walks"] & {"fora_topk_qps", "fora_whole_graph_qps",
                                "acc_sources"}
