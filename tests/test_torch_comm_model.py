"""The port's communication model and scaling sweep (``ppr_tpu_torch/
parallel/comm_model.py``, ``scaling.py``) against the JAX package's.

Every case of ``tests/test_comm_model.py`` and
``tests/test_scaling_timer.py::test_scaling_sweep_runs``. The byte
formulas equal JAX's on a grid of shapes; the predictions equal JAX's
given the same rates (the port has no default rate: both are arguments);
the measured breakdown runs on a mesh of CPU devices and names its
platform."""

import dataclasses
import itertools

import numpy as np
import pytest

from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.parallel import comm_model as jcm
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import load_default
from ppr_tpu_torch.parallel import comm_model as tcm
from ppr_tpu_torch.parallel.mesh import make_mesh
from ppr_tpu_torch.parallel.scaling import (engine_scaling_sweep,
                                            scaling_sweep)

#: rates for the comparisons: any pair, given to both packages
RATES = dict(spmv_ns_per_edge=3.5, link_bytes_per_s=2.0e11)
JAX_RATES = dict(spmv_ns_per_edge=3.5, ici_bytes_per_s=2.0e11)


@pytest.fixture(scope="module")
def graphs():
    jg = synthetic_powerlaw(8192, 8, seed=1, dense_threshold=0).graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return jg, tg


GRID = list(itertools.product([128, 1024, 4096, 65664], [1, 8, 16, 2048],
                              [1, 2, 3, 4, 8], [2, 4]))


@pytest.mark.parametrize("n_pad,b,s,payload", GRID[::3])
def test_byte_formulas_equal_jax(n_pad, b, s, payload):
    assert tcm.psum_bytes_per_sweep(n_pad, b, s, payload) == \
        jcm.psum_bytes_per_sweep(n_pad, b, s, payload)
    assert tcm.ring_bytes_per_sweep(n_pad, b, s, payload) == \
        jcm.ring_bytes_per_sweep(n_pad, b, s, payload)
    for frac in (1.0, 0.25, 0.5):
        assert tcm.frontier_ring_bytes_per_sweep(n_pad, b, s, frac,
                                                 payload) == \
            jcm.frontier_ring_bytes_per_sweep(n_pad, b, s, frac, payload)


def test_bytes_formulas():
    # one shard: no traffic
    assert tcm.psum_bytes_per_sweep(1024, 8, 1) == 0
    assert tcm.ring_bytes_per_sweep(1024, 8, 1) == 0
    # ring all-reduce: 2(S-1)/S of the full state out of each device
    assert tcm.psum_bytes_per_sweep(1024, 8, 2) == 1024 * 8 * 4
    # linear in the batch width
    assert tcm.psum_bytes_per_sweep(1024, 16, 4) == \
        2 * tcm.psum_bytes_per_sweep(1024, 8, 4)
    # the node ring moves (S-1)*n/S*B: about half the psum's bytes
    p8 = tcm.psum_bytes_per_sweep(4096, 8, 8)
    r8 = tcm.ring_bytes_per_sweep(4096, 8, 8)
    assert r8 < p8 and abs(r8 / p8 - 0.5) < 0.1


@pytest.mark.parametrize("engine,payload,frac,inflation", [
    ("edge_sharded", 4, 1.0, 1.0), ("node_sharded", 4, 1.0, 1.0),
    ("node_sharded", 2, 1.0, 1.0), ("node_sharded", 2, 0.25, 1.6)])
@pytest.mark.parametrize("s_graph,s_data", [(1, 1), (2, 1), (4, 2), (8, 1)])
def test_predict_sweep_equals_jax(graphs, engine, payload, frac, inflation,
                                  s_graph, s_data):
    jg, tg = graphs
    kw = dict(engine=engine, s_graph=s_graph, s_data=s_data, batch=512,
              payload_bytes=payload, capacity_frac=frac,
              sweep_inflation=inflation)
    got = tcm.predict_sweep(tg, **kw, **RATES).as_dict()
    want = jcm.predict_sweep(jg, **kw, **JAX_RATES).as_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key] == pytest.approx(value, rel=1e-12), key


def test_predict_sweep_efficiency_monotone(graphs):
    _, tg = graphs
    effs = [tcm.predict_sweep(tg, s_graph=s, batch=512, **RATES).efficiency
            for s in (1, 2, 4, 8)]
    assert effs[0] == 1.0
    # fixed work and growing collectives: strong-scaling efficiency decays
    assert all(a >= b for a, b in zip(effs, effs[1:]))
    with pytest.raises(ValueError, match="unknown engine"):
        tcm.predict_sweep(tg, engine="ring", **RATES)
    with pytest.raises(TypeError):          # no default rate
        tcm.predict_sweep(tg, s_graph=2)


def test_two_host_prediction_fields(graphs):
    jg, tg = graphs
    frontier = {"capacity_frac": 0.25, "sweep_inflation": 1.6}
    out = tcm.two_host_prediction(tg, batch=512, frontier=frontier, **RATES)
    ref = jcm.two_host_prediction(jg, batch=512, frontier=frontier,
                                  **JAX_RATES)
    assert out["data_parallel_2host"]["efficiency"] == 1.0
    assert 0 < out["graph_parallel_2host"]["efficiency"] <= 1.0
    assert out["two_host_relative_efficiency"] > 0
    assert out["assumptions"] == RATES
    for key in ("graph_parallel_1host", "graph_parallel_2host",
                "node_sharded_2host", "node_sharded_2host_bf16_ring"):
        for field, value in ref[key].items():
            assert out[key][field] == pytest.approx(value, rel=1e-12)
    assert out["two_host_relative_efficiency"] == pytest.approx(
        ref["two_host_relative_efficiency"], rel=1e-12)
    assert out["node_sharded_2host_frontier_bf16"]["comm_bytes"] == \
        ref["node_sharded_2host_frontier_bf16"]["comm_bytes"]


def test_measure_breakdown_on_cpu_devices():
    jg = synthetic_powerlaw(4096, 6, seed=2, dense_threshold=0).graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    mesh = make_mesh(8, devices=["cpu"] * 8)
    out = tcm.measure_breakdown(mesh, tg, batch=16, num_sweeps=8, iters=3)
    assert out["t_sweep_full_s"] > 0 and out["t_sweep_local_only_s"] > 0
    assert 0.0 <= out["collective_fraction"] < 1.0
    assert out["platform"] == "cpu" and out["distinct_devices"] == 1
    assert out["model_psum_bytes"] == tcm.psum_bytes_per_sweep(
        tg.n_pad, 16 // 4, 2)


def test_main_on_cpu_has_no_link(capsys):
    """Without two cards ``main`` measures no link, predicts nothing and
    prints the bytes; no rate is taken from elsewhere."""
    import json

    assert tcm.main(["--device", "cpu", "--n", "2048", "--deg", "4",
                     "--batch", "32"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["link_bytes_per_s"] is None and out["prediction"] is None
    assert out["spmv_ns_per_edge"] > 0
    assert out["bytes_per_sweep"]["graph=8"]["edge_psum"] == \
        tcm.psum_bytes_per_sweep(out["graph"]["n_pad"], 32, 8)


def test_scaling_sweep_runs():
    g = load_default(device="cpu").graph
    res = scaling_sweep(g, device_counts=[1, 2], iters=2,
                        walkers_per_row=64, devices=["cpu"] * 2)
    assert len(res) == 2
    assert res[0]["devices"] == 1 and res[1]["devices"] == 2
    for r in res:
        assert r["queries_per_sec"] > 0 and np.isfinite(r["efficiency"])
        assert r["proxy"] and r["device_type"] == "cpu"


def test_engine_scaling_sweep_runs():
    ds = load_default(device="cpu")
    res = engine_scaling_sweep(ds, [1, 2], batch=8, iters=1,
                               devices=["cpu"] * 2)
    assert [r["devices"] for r in res] == [1, 2]
    assert res[0]["sweeps"] == res[1]["sweeps"] > 0
    with pytest.raises(ValueError, match="start at 1"):
        engine_scaling_sweep(ds, [2, 4], devices=["cpu"] * 4)
