"""The port's Monte-Carlo (``ppr_tpu_torch/models/monte_carlo.py``) against
the JAX package's.

Exact: the walk count ``mc_num_walks``, the source chunk and the
preprocessing batch height, so that both packages' stores hold batches at
the same starts. By distribution: each row's mass is 1 within f32 (1e-6),
and the accuracy against the port's power method within the bounds of
``tests/test_algorithms.py::test_monte_carlo_accuracy`` (mean max-err <
0.05, precision@10 > 0.85, NDCG > 0.95). A store read back equals the rows
the sweep computed (1e-7, the store's f32 values)."""

import dataclasses

import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import synthetic_powerlaw as jax_powerlaw
from ppr_tpu.models import monte_carlo as jmc
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset, load_default
from ppr_tpu_torch.models import AlgoConf, AlgoType
from ppr_tpu_torch.models import monte_carlo as tmc
from ppr_tpu_torch.ops.topk import topk_ids_with_ties
from ppr_tpu_torch.utils.metrics import max_abs_err, ndcg_at_k, precision_at_k

ALPHA, K = 0.15, 10


@pytest.fixture(scope="module")
def got():
    return load_default(device="cpu")


@pytest.fixture(scope="module")
def pair():
    jds = jax_powerlaw(600, 4, seed=5, dense_threshold=0)
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return jds, Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.mark.parametrize("eps", [5.0, 1.0, 0.5, 0.05, 0.01])
@pytest.mark.parametrize("n", [107, 5120, 262144])
def test_mc_num_walks_matches_jax(eps, n):
    assert tmc.mc_num_walks(eps, 1.0 / n, 1.0 / n) == \
        jmc.mc_num_walks(eps, 1.0 / n, 1.0 / n)


@pytest.mark.parametrize("max_walk_batch", [4_000_000, 50_000, 1])
@pytest.mark.parametrize("param", [1.0, 0.5, 0.1, 0.05])
def test_source_chunk_and_prep_batch_match_jax(pair, param, max_walk_batch):
    jds, tds = pair
    j = jmc.MonteCarlo(jds, ALPHA, max_walk_batch=max_walk_batch)
    t = AlgoConf(ALPHA).new_algo_obj(AlgoType.MC, tds)
    t.max_walk_batch = max_walk_batch
    assert (t.delta, t.pfail) == (j.delta, j.pfail)
    assert t._source_chunk(param) == j._source_chunk(param)
    for bs in (1, 7, 128, 4096):
        assert t._prep_batch(param, bs) == j._prep_batch(param, bs)


def test_mc_whole_graph_batch_conserves_mass(got):
    g = got.graph
    gen = torch.Generator().manual_seed(0)
    sources = torch.as_tensor([0, 4, 50, 106], dtype=torch.int32)
    out = tmc.mc_whole_graph_batch(g, sources, gen, ALPHA, 3000)
    assert out.shape == (4, g.n_pad) and (out >= 0).all()
    np.testing.assert_allclose(out.sum(dim=1).numpy(), 1.0, rtol=1e-6)


def test_monte_carlo_accuracy(got):
    sources = np.arange(0, got.n, 5)
    oracle = AlgoConf(ALPHA).set_conf_power_method(got) \
        .compute_whole_graph_batch(sources)
    mc = AlgoConf(ALPHA, seed=1).set_conf_mc(got)
    scores = mc.compute_whole_graph_batch(sources, 0.5)
    err = np.mean([max_abs_err(scores[i], oracle[i])
                   for i in range(len(sources))])
    assert err < 0.05
    precs, ndcgs = [], []
    for i in range(len(sources)):
        gnd = topk_ids_with_ties(oracle[i], K)
        ids = topk_ids_with_ties(scores[i], K)
        precs.append(precision_at_k(ids, gnd))
        ndcgs.append(ndcg_at_k(ids, gnd, oracle[i]))
    assert np.mean(precs) > 0.85 and np.mean(ndcgs) > 0.95


def test_chunks_cover_the_batch(got):
    """A batch larger than one chunk runs chunk by chunk, row for row."""
    mc = AlgoConf(ALPHA).set_conf_mc(got)
    mc.max_walk_batch = 3 * tmc.mc_num_walks(1.0, mc.delta, mc.pfail)
    assert mc._source_chunk(1.0) == 3
    scores = mc.compute_whole_graph_batch(np.arange(8), 1.0)
    assert scores.shape == (8, got.graph.n_pad)
    np.testing.assert_allclose(scores.sum(axis=1), 1.0, rtol=1e-6)
    assert (scores[np.arange(8), np.arange(8)] > ALPHA / 2).all()


def test_store_round_trip(got, tmp_path, monkeypatch):
    """Preprocessing writes shards at the JAX package's batch starts, and
    the rows read back are the rows the sweep computed."""
    monkeypatch.chdir(tmp_path)
    mc = AlgoConf(ALPHA, seed=2).set_conf_mc(got)
    mc.max_walk_batch = 40 * tmc.mc_num_walks(1.0, mc.delta, mc.pfail)
    computed = {}
    real = mc.compute_whole_graph_device

    def keep(sources, param):
        out = real(sources, param)
        for s, row in zip(sources, out.numpy()):
            computed[int(s)] = row
        return out

    monkeypatch.setattr(mc, "compute_whole_graph_device", keep)
    assert mc._prep_pending(1.0)
    mc.preprocessing(-1.0, 1.0, progress=False)
    store = mc._store
    starts = list(range(0, got.n, mc._prep_batch(1.0)))
    assert mc._prep_batch(1.0) == 40
    assert all(store.has_batch(s) for s in starts)
    assert sorted(computed) == list(range(got.n))
    for s in (0, 39, 40, 106):
        mc.read_preprocessed_ppr(s)
        np.testing.assert_allclose(mc.get_whole_graph_dense(), computed[s],
                                   atol=1e-7)
    assert mc.get_prep_size() > 0
    mc.delete_prep_dir()
