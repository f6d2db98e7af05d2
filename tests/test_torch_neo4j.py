"""The port's Neo4j method and K2's plain version against the JAX package.

K2's plain version is held against the JAX Pallas kernel run in interpret
mode on the CPU (as tests/test_pallas_dense.py runs it); the method against
the JAX method, which takes its XLA path on the CPU. The CUDA kernels are
held against the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).

Tolerance 1e-6: f32 rounds of a full-precision product summed in another
order; x stays near unit mass, so rounding builds up with the rounds, but
the normalized scores of 300 rounds agree to well within it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import load_default, synthetic_powerlaw
from ppr_tpu.models import neo4j_method as jneo
from ppr_tpu.ops.pallas_dense import dense_pagerank_iterations as jax_k2
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import neo4j_method as tneo
from ppr_tpu_torch.models.config import AlgoConf, AlgoType
from ppr_tpu_torch.ops import dense_power, probe

ALPHA = 0.15
DAMPING = 1.0 - ALPHA


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.fixture(scope="module")
def datasets():
    return {kind: (jds, port_dataset(jds)) for kind, jds in (
        ("dense", load_default()),
        ("sparse", synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0)),
    )}


def onehot(n_pad, sources):
    return np.eye(n_pad, dtype=np.float32)[sources]


def sources_for(g, b):
    s = np.random.default_rng(b).integers(0, g.n, b)
    dangling = np.nonzero(np.asarray(g.out_deg)[: g.n] == 0)[0]
    s[0] = dangling[0]
    return s


@pytest.mark.parametrize("iters", [0, 40, 300])
@pytest.mark.parametrize("b", [1, 2, 9])
def test_k2_ref_matches_pallas_interpret(datasets, b, iters):
    jds, tds = datasets["dense"]
    oh = onehot(jds.graph.n_pad, sources_for(jds.graph, b))
    ref = np.asarray(jax_k2(jds.graph, jnp.asarray(oh), DAMPING, iters,
                            interpret=True))
    out = dense_power.dense_pagerank_iterations_ref(
        tds.graph, torch.from_numpy(oh), DAMPING, iters)
    assert out.shape == (b, jds.graph.n_pad) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    if iters == 0:
        np.testing.assert_array_equal(out.numpy(), (1.0 - DAMPING) * oh)


@pytest.mark.parametrize("iters", [5, 40, 300])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_personalized_pagerank_batch_matches_jax(datasets, kind, iters):
    jds, tds = datasets[kind]
    sources = sources_for(jds.graph, 9)
    ref = np.asarray(jneo.personalized_pagerank_batch(
        jds.graph, jnp.asarray(sources, jnp.int32), DAMPING, iters))
    out = tneo.personalized_pagerank_batch(tds.graph, sources, DAMPING,
                                           iters)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    # normalized rows; the dangling source keeps its teleport mass only
    np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)
    assert out[0, sources[0]] == 1.0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_whole_graph_batch_matches_jax(datasets, kind):
    jds, tds = datasets[kind]
    sources = sources_for(jds.graph, 13)
    ref = jneo.Neo4jMethod(jds, ALPHA).compute_whole_graph_batch(sources, 100)
    out = tneo.Neo4jMethod(tds, ALPHA).compute_whole_graph_batch(
        sources, 100.0)   # the harness passes params as floats
    assert isinstance(out, np.ndarray) and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_single_query_topk_matches_jax(datasets, kind):
    jds, tds = datasets[kind]
    source = int(sources_for(jds.graph, 3)[2])
    jalgo, talgo = jneo.Neo4jMethod(jds, ALPHA), tneo.Neo4jMethod(tds, ALPHA)
    jalgo.compute_topk_ppr(source, 10, 40)
    talgo.compute_topk_ppr(source, 10, 40)
    np.testing.assert_allclose(talgo.get_whole_graph_dense(),
                               jalgo.get_whole_graph_dense(), atol=1e-6)
    assert set(talgo.get_topk_node_ids(10).tolist()) == \
        set(jalgo.get_topk_node_ids(10).tolist())
    talgo.compute_whole_graph_ppr(source, 40)
    assert set(talgo.get_whole_graph_ppr()) == \
        set(np.nonzero(talgo.get_whole_graph_dense() > 0)[0].tolist())


def test_cpu_never_launches(datasets, monkeypatch):
    _, tds = datasets["dense"]
    monkeypatch.setattr(dense_power, "pagerank_launches", 0)
    monkeypatch.setattr(probe, "launches", 0)
    assert not dense_power.supports(tds.graph)   # the graph lies on the CPU
    oh = torch.from_numpy(onehot(tds.graph.n_pad, [0, 3, 9]))
    out = dense_power.dense_pagerank_iterations(tds.graph, oh, DAMPING, 50)
    ref = dense_power.dense_pagerank_iterations_ref(tds.graph, oh, DAMPING,
                                                    50)
    assert torch.equal(out, ref)
    tneo.Neo4jMethod(tds, ALPHA).compute_whole_graph_batch(np.arange(9), 40)
    x = torch.ones(probe.SHAPE)
    assert torch.equal(probe.double(x), 2 * x)
    assert dense_power.pagerank_launches == 0 and probe.launches == 0


def test_other_devices_raise(datasets):
    _, tds = datasets["dense"]
    oh = torch.zeros((2, tds.graph.n_pad), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        dense_power.dense_pagerank_iterations(tds.graph, oh, DAMPING, 10)
    with pytest.raises(ValueError, match="unsupported device"):
        probe.double(oh)


def test_new_algo_obj(datasets):
    _, tds = datasets["dense"]
    conf = AlgoConf(ALPHA, seed=3)
    algo = conf.new_algo_obj(AlgoType.NEO4J_METHOD, tds)
    assert isinstance(algo, tneo.Neo4jMethod) and algo.alpha == ALPHA
    assert algo.prep_dirname == "Neo4j_Method_ppr_results"
    for ported, name in ((AlgoType.FWDPUSH, "ForwardPush"),
                         (AlgoType.BASE_WHOLE_GRAPH, "BaseAllPair")):
        other = conf.new_algo_obj(ported, tds)
        assert type(other).__name__ == name and other.alpha == ALPHA
    # Monte-Carlo and FORA whole-graph, which raised until they were
    # ported: every AlgoType builds
    for ported, name in ((AlgoType.MC, "MonteCarlo"),
                         (AlgoType.FORA_WHOLE_GRAPH, "ForaWholeGraph")):
        other = conf.new_algo_obj(ported, tds)
        assert type(other).__name__ == name and other.alpha == ALPHA
        assert other.delta == other.pfail == 1.0 / tds.n
    assert {type(conf.new_algo_obj(a, tds, 5)).__name__
            for a in AlgoType} >= {"ForaTopk", "PowerMethod"}
