"""The port's power-method oracle against the JAX package's and against a
float64 dense iteration (tests/conftest.py).

Tolerances: 1e-6 against JAX (the same f32 arithmetic, reduced in another
order); 2e-5 against float64 (100 f32 rounds vs 300 exact ones)."""

import dataclasses

import numpy as np
import pytest

from conftest import exact_ppr_dangling_to_source
from ppr_tpu.graph.io import load_default, synthetic_powerlaw
from ppr_tpu.models.power_method import power_method_batch as jax_pm
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models.config import AlgoConf, AlgoType
from ppr_tpu_torch.models.power_method import PowerMethod, power_method_batch
from ppr_tpu_torch.ops import dense_power

ALPHA = 0.15


def port(jg):
    return graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")


@pytest.fixture(scope="module")
def graphs():
    dense = load_default().graph
    sparse = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0).graph
    return {"dense": (dense, port(dense)), "sparse": (sparse, port(sparse))}


def _sources(g, b):
    deg = np.asarray(g.out_deg)[: g.n]
    s = np.random.default_rng(b).integers(0, g.n, b)
    s[0] = np.nonzero(deg == 0)[0][0]          # a dangling source
    return s


@pytest.mark.parametrize("b", [3, 12])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_power_method_batch_matches_jax(graphs, kind, b):
    jg, tg = graphs[kind]
    sources = _sources(jg, b)
    ref = np.asarray(jax_pm(jg, np.asarray(sources, np.int32), ALPHA, 100))
    out = power_method_batch(tg, sources, ALPHA, 100)
    assert out.shape == (b, jg.n_pad)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_power_method_matches_float64(graphs, kind):
    jg, tg = graphs[kind]
    src = np.asarray(jg.edge_src)[: jg.m]
    dst = np.asarray(jg.edge_dst)[: jg.m]
    sources = _sources(jg, 3)
    out = power_method_batch(tg, sources, ALPHA, 100).numpy()
    for row, s in zip(out, sources):
        exact = exact_ppr_dangling_to_source(src, dst, jg.n, int(s), ALPHA)
        np.testing.assert_allclose(row[: jg.n], exact, atol=2e-5)
        assert not row[jg.n:].any()


def test_power_method_class_on_cpu(graphs, monkeypatch):
    jg, tg = graphs["dense"]
    monkeypatch.setattr(dense_power, "launches", 0)
    ds = Dataset(graph=tg, names=[str(i) for i in range(tg.n)], name="got")
    pm = AlgoConf(ALPHA).new_algo_obj(AlgoType.POWER_METHOD, ds)
    assert isinstance(pm, PowerMethod)
    sources = np.array([1, 4, 9])
    out = pm.compute_whole_graph_batch(sources)
    assert dense_power.launches == 0            # the CPU runs the plain path
    np.testing.assert_allclose(
        out, np.asarray(jax_pm(jg, sources.astype(np.int32), ALPHA, 100)),
        atol=1e-6)
    pm.compute_topk_ppr(4, 5, None)
    ids = pm.get_topk_node_ids(5)
    assert len(ids) >= 5 and out[1][ids[0]] == out[1].max()


def test_unported_algorithms_raise(graphs):
    """Monte-Carlo, which raised here until it was ported, is built with
    the reference's delta = pfail = 1/n (Algo_Conf.java:29-34)."""
    _, tg = graphs["dense"]
    ds = Dataset(graph=tg, names=[str(i) for i in range(tg.n)], name="got")
    mc = AlgoConf(ALPHA, seed=4).new_algo_obj(AlgoType.MC, ds)
    assert type(mc).__name__ == "MonteCarlo" and mc.alpha == ALPHA
    assert mc.delta == mc.pfail == 1.0 / tg.n
