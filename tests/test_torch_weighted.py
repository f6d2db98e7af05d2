"""Weighted graphs in the port against the JAX package and a numpy
operator: the six cases of ``tests/test_weighted.py`` on its ``wgraph``,
then the weighted generator, the chunked push, the graph carried across
from JAX, the algorithms that run on a weighted graph, and the hub split's
refusals.

Tolerances: the graph's arrays and alias tables equal JAX's bit for bit
(the same host code on the same inputs); pushes within 1e-6 of JAX's (f32
sums over the same edges, the dense matmul in another order) and 1e-4 of
the float64 numpy operator, as ``tests/test_weighted.py`` holds JAX; the
power method within 2e-5 of the numpy oracle. The walks draw from a
``torch.Generator`` (Philox), JAX's from threefry, so they are held by
distribution: one alias step's neighbour frequencies within 0.01 of the
weights at 200,000 draws, Monte-Carlo within 0.02 of the power method.
FORA top-k runs with ``push="none"`` (no walks) and must stop on JAX's
sweep with the same tie-expanded top-10 sets; FORA whole-graph with
``spmv`` completion, Forward Push and BASE agree within 1e-6."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph import csr as jcsr
from ppr_tpu.graph import io as jio
from ppr_tpu.models import base_allpair as jbase
from ppr_tpu.models import fora as jfora
from ppr_tpu.models import forward_push as jfwp
from ppr_tpu.models.power_method import power_method_batch as jpower
from ppr_tpu.ops.push import forward_push_init as jax_init
from ppr_tpu.ops import spmv as jspmv
from ppr_tpu.ops import walk as jwalk
from ppr_tpu_torch.graph import csr as tcsr
from ppr_tpu_torch.graph import io as tio
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import base_allpair as tbase
from ppr_tpu_torch.models import fora as tfora
from ppr_tpu_torch.models import forward_push as tfwp
from ppr_tpu_torch.models.monte_carlo import MonteCarlo
from ppr_tpu_torch.models.power_method import power_method_batch
from ppr_tpu_torch.ops import hub_split as thub
from ppr_tpu_torch.ops import spmv as tspmv
from ppr_tpu_torch.ops import walk as twalk
from ppr_tpu_torch.ops.topk import (topk_ids_with_ties,
                                    topk_ids_with_ties_from_pairs)
from ppr_tpu_torch.service import PPRService

ALPHA, EPS, K = 0.15, 0.5, 10
FIELDS = ("indptr", "indices", "edge_src", "edge_dst", "edge_mask",
          "edge_src_bydst", "edge_dst_bydst", "out_deg", "in_deg",
          "node_mask", "dense_out", "edge_coef", "edge_coef_bydst",
          "alias_prob", "alias_other")


def gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


def jax_fields(g):
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def assert_same_graph(tg, jg):
    assert (tg.n, tg.m, tg.n_pad, tg.m_pad) == (jg.n, jg.m, jg.n_pad,
                                                jg.m_pad)
    assert tg.weighted == jg.weighted
    for name in FIELDS:
        a, b = getattr(jg, name), getattr(tg, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        assert b.numpy().dtype == a.dtype, name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)


@pytest.fixture(scope="module")
def wgraph():
    """``tests/test_weighted.py``'s graph: directed, 60 nodes, one forced
    dangling, weights in [0.1, 4.1); both packages build it."""
    rng = np.random.default_rng(21)
    n, m = 60, 500
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)
    keep = src != n - 1
    src, dst = src[keep], dst[keep]
    w = rng.random(src.size) * 4 + 0.1
    jg = jcsr.build_graph(src, dst, n=n, weights=w)
    tg = tcsr.build_graph(src, dst, n, weights=w, device="cpu")
    return jg, tg, src, dst, w, n


def weighted_operator(src, dst, w, n):
    P = np.zeros((n, n))
    wsum = np.zeros(n)
    np.add.at(wsum, src, w)
    for s, d, ww in zip(src, dst, w):
        P[s, d] += ww / wsum[s]
    return P


def sparse_copy(tg):
    """The same graph without its dense operator, so the default backend
    is the sorted segmented sum."""
    return dataclasses.replace(tg, dense_out=None)


# --- the six cases of tests/test_weighted.py --------------------------------
def test_weighted_fields_and_alias_tables_match_jax(wgraph):
    jg, tg, src, dst, w, n = wgraph
    assert tg.weighted and tg.alias_prob.shape == (tg.m_pad,)
    assert_same_graph(tg, jg)
    coef = tg.edge_coef[: tg.m].numpy().astype(np.float64)
    sums = np.zeros(tg.n_pad)
    np.add.at(sums, tg.edge_src[: tg.m].numpy(), coef)
    deg = tg.out_deg.numpy()
    np.testing.assert_allclose(sums[:n][deg[:n] > 0], 1.0, atol=1e-5)
    # padding edges carry coefficient 0
    assert not tg.edge_coef[tg.m:].any() and not tg.edge_coef_bydst[tg.m:].any()


def operand(g, rows, seed):
    a = np.zeros((rows, g.n_pad), np.float32)
    a[:, : g.n] = np.random.default_rng(seed).random((rows, g.n))
    return a


@pytest.mark.parametrize("backend", ["dense", "coo", "coo_sorted"])
def test_weighted_push_out(wgraph, backend):
    jg, tg, src, dst, w, n = wgraph
    P = weighted_operator(src, dst, w, n)
    a = operand(jg, 3, 1)
    ref = np.asarray(jspmv.push_out(jg, jnp.asarray(a), backend=backend))
    out = tspmv.push_out(tg, torch.from_numpy(a), backend=backend).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(out[:, :n], a[:, :n] @ P, atol=1e-4)
    # one row, as a 1-D operand
    one = tspmv.push_out(tg, torch.from_numpy(a[0]), backend=backend)
    np.testing.assert_allclose(one.numpy(), out[0], atol=1e-6)


@pytest.mark.parametrize("backend", ["dense", "coo", "coo_sorted"])
def test_weighted_pull_out(wgraph, backend):
    jg, tg, src, dst, w, n = wgraph
    P = weighted_operator(src, dst, w, n)
    a = operand(jg, 2, 2)
    ref = np.asarray(jspmv.pull_out_norm(jg, jnp.asarray(a),
                                         backend=backend))
    out = tspmv.pull_out_norm(tg, torch.from_numpy(a),
                              backend=backend).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(out[:, :n], a[:, :n] @ P.T, atol=1e-4)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "sparse"])
def test_weighted_power_method_matches_oracle(wgraph, dense):
    jg, tg, src, dst, w, n = wgraph
    P = weighted_operator(src, dst, w, n)
    dangling = tg.out_deg[:n].numpy() == 0
    s = 3
    p, r = np.zeros(n), np.zeros(n)
    r[s] = 1.0
    for _ in range(100):
        p += ALPHA * r
        rem = (1 - ALPHA) * r
        dm = rem[dangling].sum()
        r = rem @ P
        r[s] += dm
    g = tg if dense else sparse_copy(tg)
    out = power_method_batch(g, np.asarray([s], np.int32), ALPHA, 100)
    out = out.numpy()[0]
    np.testing.assert_allclose(out[:n], p, atol=2e-5)
    ref = np.asarray(jpower(jg, jnp.asarray([s], jnp.int32), ALPHA, 100))[0]
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_alias_tables_sample_correct_distribution(wgraph):
    """One alias step from the highest-degree node: neighbour frequencies
    of 200,000 draws against the edge weights."""
    jg, tg, src, dst, w, n = wgraph
    v = int(np.argmax(tg.out_deg[:n].numpy()))
    W = 200_000
    g = gen(5)
    u = torch.rand(W, generator=g)
    u2 = torch.rand(W, generator=g)
    cur = torch.full((W,), v, dtype=torch.int32)
    nxt = twalk._uniform_neighbor(tg, cur, u, cur, u2).numpy()
    counts = np.bincount(nxt, minlength=tg.n_pad)[:n] / W
    np.testing.assert_allclose(counts, weighted_operator(src, dst, w, n)[v],
                               atol=0.01)
    # the same uniforms give JAX's neighbours, walker for walker
    c = jnp.asarray(cur.numpy())
    ref = np.asarray(jwalk._uniform_neighbor(
        jg, c, jnp.asarray(u.numpy()), c, jnp.asarray(u2.numpy())))
    np.testing.assert_array_equal(nxt, ref)
    with pytest.raises(ValueError, match="second uniform"):
        twalk._uniform_neighbor(tg, cur, u, cur)


def test_weighted_mc_converges_to_weighted_ppr(wgraph):
    jg, tg, *_ = wgraph
    ds = Dataset(graph=tg, names=[str(i) for i in range(tg.n)], name="wtest")
    est = MonteCarlo(ds, ALPHA, seed=4).compute_whole_graph_batch(
        np.asarray([3]), 0.3)[0]
    oracle = power_method_batch(tg, np.asarray([3], np.int32), ALPHA,
                                100).numpy()[0]
    assert np.abs(est - oracle).max() < 0.02
    assert abs(est.sum() - 1.0) < 1e-5


# --- beyond tests/test_weighted.py -------------------------------------------
def test_synthetic_weighted_matches_jax():
    jds = jio.synthetic_weighted(512, 8, seed=3)
    tds = tio.synthetic_weighted(512, 8, seed=3, device="cpu")
    assert tds.name == jds.name and tds.names == jds.names
    assert_same_graph(tds.graph, jds.graph)


def test_graph_from_numpy_carries_a_weighted_graph(wgraph):
    jg, tg, *_ = wgraph
    carried = tcsr.graph_from_numpy(jax_fields(jg), device="cpu")
    assert_same_graph(carried, jg)
    for name in ("bydst_ptr", "bysrc_ptr", "dang_ids"):
        assert torch.equal(getattr(carried, name), getattr(tg, name)), name
    fields = jax_fields(jg)
    fields["alias_prob"] = None
    with pytest.raises(ValueError, match="weighted graph needs all"):
        tcsr.graph_from_numpy(fields, device="cpu")


def test_weighted_load_edge_list_matches_jax(tmp_path):
    path = tmp_path / "w.txt"
    path.write_text("# src dst w\n10 20 0.5\n20 30 2\n30 10 1.25\n"
                    "10 30 3\n\n20 10\n")
    jds = jio.load_edge_list(str(path), weighted=True)
    tds = tio.load_edge_list(str(path), weighted=True, device="cpu")
    assert tds.names == jds.names == ["10", "20", "30"]
    assert_same_graph(tds.graph, jds.graph)
    # the line without a weight weighs 1.0
    coef = tds.graph.dense_out[1, :3].numpy()
    np.testing.assert_allclose(coef, [1 / 3, 0, 2 / 3], rtol=1e-6)


@pytest.mark.parametrize("num_chunks", [1, 3])
def test_weighted_push_out_chunked_t_matches_jax(wgraph, num_chunks):
    jg, tg, *_ = wgraph
    a_t = operand(jg, 8, 3).T.copy()
    ref = np.asarray(jspmv.push_out_chunked_t(jg, jnp.asarray(a_t),
                                              num_chunks=num_chunks))
    out = tspmv.push_out_chunked_t(tg, torch.from_numpy(a_t),
                                   num_chunks=num_chunks)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    full = tspmv.push_out_t(sparse_copy(tg), torch.from_numpy(a_t))
    np.testing.assert_allclose(out.numpy(), full.numpy(), atol=1e-6)


def test_weighted_push_out_chunked_uses_the_coefficients(wgraph):
    jg, tg, src, dst, w, n = wgraph
    a = operand(jg, 4, 6)
    out = tspmv.push_out_chunked(tg, torch.from_numpy(a), num_chunks=3)
    np.testing.assert_allclose(out.numpy()[:, :n],
                               a[:, :n] @ weighted_operator(src, dst, w, n),
                               atol=1e-4)


@pytest.fixture(scope="module")
def fora_datasets():
    jds = jio.synthetic_weighted(2048, 8, seed=5, dense_threshold=0)
    tds = Dataset(graph=tcsr.graph_from_numpy(jax_fields(jds.graph),
                                              device="cpu"),
                  names=jds.names, name=jds.name)
    return jds, tds


def test_weighted_fora_topk_matches_jax(fora_datasets):
    jds, tds = fora_datasets
    sources = np.random.default_rng(16).integers(0, jds.graph.n, 16)
    jalgo = jfora.ForaTopk(jds, ALPHA, K, seed=7, push="none")
    talgo = tfora.ForaTopk(tds, ALPHA, K, seed=7, push="none")
    jv, ji = jalgo.compute_topk_ids_batch(sources, K, EPS)
    tv, ti = talgo.compute_topk_ids_batch(sources, K, EPS)
    # JAX's engine keeps no sweep count: its annealed loop gives it
    padded, _ = jfora._pad_sources(sources)
    p, r, oh = jax_init(jds.graph, jnp.asarray(padded, jnp.int32))
    jp, _, jiters = jfora.annealed_topk_propagate(
        jds.graph, jnp.zeros_like(p), r, oh, jnp.float32(EPS * 0.5),
        1.0 / K, 1.0 / jds.graph.n, K, ALPHA)
    assert talgo.last_iters == int(jiters) > 0
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    for row in range(len(sources)):
        assert set(topk_ids_with_ties_from_pairs(tv[row], ti[row], K)) == \
            set(topk_ids_with_ties_from_pairs(jv[row], ji[row], K))
    p = talgo.compute_topk_batch(sources[:4], K, EPS)
    jp = jalgo.compute_topk_batch(sources[:4], K, EPS)
    np.testing.assert_allclose(p, jp, atol=1e-6)


def test_weighted_fora_whole_graph_spmv_matches_jax(fora_datasets):
    jds, tds = fora_datasets
    sources = np.random.default_rng(3).integers(0, jds.graph.n, 10)
    out = []
    for mod, ds in ((jfora, jds), (tfora, tds)):
        algo = mod.ForaWholeGraph(ds, ALPHA, completion="spmv",
                                  max_push_rounds=4)
        algo.avg_rand_walk_time_ns = algo.spmv_ns_per_edge = 1e30
        out.append(algo.compute_whole_graph_batch(sources, EPS))
    np.testing.assert_allclose(out[1], out[0], atol=1e-6)
    tol = EPS / jds.graph.n
    for row in range(len(sources)):
        assert set(topk_ids_with_ties(out[1][row], K, tol=tol)) == \
            set(topk_ids_with_ties(out[0][row], K, tol=tol))


@pytest.fixture(scope="module")
def small_weighted():
    out = {}
    for kind, jds in (
        ("dense", jio.synthetic_weighted(107, 3, seed=7)),
        ("sparse", jio.synthetic_weighted(300, 4, seed=2,
                                          dense_threshold=0)),
    ):
        tds = Dataset(graph=tcsr.graph_from_numpy(jax_fields(jds.graph),
                                                  device="cpu"),
                      names=jds.names, name=jds.name)
        out[kind] = (jds, tds)
    return out


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_weighted_forward_push_rows_match_jax(small_weighted, kind):
    jds, tds = small_weighted[kind]
    sources = np.random.default_rng(11).integers(0, jds.graph.n, 11)
    jalgo = jfwp.ForwardPush(jds, ALPHA)
    talgo = tfwp.ForwardPush(tds, ALPHA)
    ref = jalgo.compute_whole_graph_batch(sources, 1e-6)
    out = talgo.compute_whole_graph_batch(sources, 1e-6)
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(talgo.residue_sum(), jalgo.residue_sum(),
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_weighted_base_rows_match_jax(small_weighted, tmp_path, monkeypatch,
                                      kind):
    jds, tds = small_weighted[kind]
    rows = {}
    for pkg, mod, ds in (("jax", jbase, jds), ("port", tbase, tds)):
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        algo = mod.BaseAllPair(ds, ALPHA, target_batch=64)
        algo.preprocessing(1e-3, -1, progress=False)
        rows[pkg] = [algo._store.read_row_ordered(s) for s in range(ds.n)]
    assert sum(len(ids) for ids, _ in rows["port"]) > jds.n
    for (tids, tvals), (jids, jvals) in zip(rows["port"], rows["jax"]):
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tvals, jvals, atol=1e-6)


def test_weighted_random_walks_stop_distribution(wgraph):
    """Stop nodes of walks from one source against the weighted power
    method (5e-3 at 200k walkers, the bound of ``tests/test_walk.py``)."""
    _, tg, *_ = wgraph
    W = 200_000
    starts = torch.full((W,), 3, dtype=torch.int32)
    stops = twalk.random_walks(tg, starts, gen(2), ALPHA).numpy()
    freq = np.bincount(stops, minlength=tg.n_pad) / W
    oracle = power_method_batch(tg, np.asarray([3], np.int32), ALPHA,
                                100).numpy()[0]
    assert np.abs(freq - oracle).max() < 5e-3


def test_hub_split_refuses_a_weighted_graph(wgraph):
    _, tg, *_ = wgraph
    with pytest.raises(NotImplementedError, match="uniform graphs"):
        thub.build_hub_split(tg, 16)


def test_service_refuses_hub_split_on_a_weighted_graph(wgraph):
    _, tg, *_ = wgraph
    ds = Dataset(graph=tg, names=[str(i) for i in range(tg.n)], name="w")
    with pytest.raises(ValueError, match="weighted graphs"):
        PPRService.from_dataset(ds, hub_split=16)
    hits = PPRService.from_dataset(ds, k=5).top_k([3], k=5)[0]
    assert hits and all(h.score > 0 for h in hits)
