"""The port's node-sharded engines (``ppr_tpu_torch/parallel/
node_sharded.py``, ``node_sharded_fora.py``, ``dryrun.py``) against the
JAX package's on the same mesh shapes: JAX on its 8 virtual CPU devices
(``tests/conftest.py``), the port on ``["cpu"] * S``.

Tolerances are the JAX package's own: the f32 ring's scores within atol
5e-6, rtol 1e-4 of JAX's, tie-expanded top-k id sets equal at tol 1e-6,
and the same sweep count (``tests/test_node_sharded_fora.py``); the bf16
ring within ``tests/test_ring_bf16.py``'s bars of the f32 ring; frontier
compaction at full capacity equal to the dense ring bit for bit, at low
capacity within rtol 5e-2, atol 5e-3 (``tests/test_frontier_ring.py``);
FORA whole-graph's ``spmv`` completion within eps/n of the exact rows,
its ``walks`` completion with rows of mass 1 within 1e-3. Each shard's
reserve is ``[n_pad / graph, B / data]``: O(n/S)."""

import dataclasses

import numpy as np
import pytest

from ppr_tpu.graph.csr import build_graph as jax_build_graph
from ppr_tpu.graph.io import Dataset as JaxDataset
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.ops.topk import topk_ids_with_ties
from ppr_tpu.parallel import node_sharded as jns
from ppr_tpu.parallel.node_sharded_fora import NodeShardedForaTopk as JaxNode
from ppr_tpu.parallel.node_sharded_fora import (
    NodeShardedForaWholeGraph as JaxWholeGraph)
from ppr_tpu.parallel.sharded import make_mesh as jax_make_mesh
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.parallel import dryrun
from ppr_tpu_torch.parallel import node_sharded as tns
from ppr_tpu_torch.parallel.mesh import make_mesh
from ppr_tpu_torch.parallel.node_sharded_fora import (
    NodeShardedForaTopk, NodeShardedForaWholeGraph)
from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk
from tests.conftest import exact_ppr_dangling_to_source

ALPHA, EPS, K = 0.15, 0.5, 10
SHAPES = [(4, 2), (2, 4), (2, 2), (4, 1)]


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


def jax_mesh(d, g):
    return jax_make_mesh(d * g, data=d, graph=g)


def port_mesh(d, g):
    return make_mesh(d * g, data=d, graph=g, devices=["cpu"] * (d * g))


@pytest.fixture(scope="module")
def datasets(tiny):
    rng = np.random.default_rng(2)
    src, dst = rng.integers(0, 1024, 6144), rng.integers(0, 1024, 6144)
    wg = jax_build_graph(src, dst, n=1024, weights=rng.uniform(0.1, 4.0, 6144),
                         dense_threshold=0)
    out = {
        "synth": synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0),
        "tiny": JaxDataset(graph=tiny, names=[str(i) for i in range(6)],
                           name="tiny"),
        "weighted": JaxDataset(graph=wg, names=[str(i) for i in range(1024)],
                               name="wshard"),
        "wg512": synthetic_powerlaw(512, 6, seed=9, dense_threshold=0),
        "wg256": synthetic_powerlaw(256, 5, seed=11, dense_threshold=0),
    }
    return {k: (jds, port_dataset(jds)) for k, jds in out.items()}


SOURCES = {
    "synth": np.random.default_rng(1).integers(0, 2048, 6).astype(np.int32),
    # node 4 is dangling, node 5 a self loop
    "tiny": np.array([4, 0, 5, 2, 3], np.int32),
    "weighted": np.random.default_rng(2).integers(0, 1024, 4)
    .astype(np.int32),
}


@pytest.fixture(scope="module")
def jax_runs(datasets):
    """The JAX node engine's ``(dense [B, n_pad], iters)`` per graph and
    mesh shape, each engine built once."""
    cache = {}

    def run(kind, d, g):
        if (kind, d, g) not in cache:
            jds, _ = datasets[kind]
            eng = JaxNode(jds, ALPHA, K, mesh=jax_mesh(d, g))
            sp, b = eng._pad_batch(SOURCES[kind])
            kcap = min(max(4 * K, K + 32), jds.graph.n_pad)
            _, _, p, iters = eng._run(sp, K, kcap, EPS * 0.5)
            cache[kind, d, g] = (np.asarray(p)[:b], int(iters))
        return cache[kind, d, g]

    return run


@pytest.fixture(scope="module")
def port_dense(datasets):
    """The port's f32 dense-ring result on ``synth`` at 2x4, the baseline
    of the bf16 and frontier cases."""
    _, tds = datasets["synth"]
    eng = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4))
    return eng.compute_topk_batch(SOURCES["synth"], K, EPS), eng.last_iters


def assert_same_topk(got, want, k=K):
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-4)
    for i in range(len(got)):
        assert set(topk_ids_with_ties(got[i], k, tol=1e-6).tolist()) == \
            set(topk_ids_with_ties(want[i], k, tol=1e-6).tolist()), i


@pytest.mark.parametrize("kind", ["synth", "tiny", "weighted"])
@pytest.mark.parametrize("d,g", SHAPES)
def test_node_engine_matches_jax(datasets, jax_runs, kind, d, g):
    _, tds = datasets[kind]
    want, iters = jax_runs(kind, d, g)
    eng = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(d, g))
    got = eng.compute_topk_batch(SOURCES[kind], K, EPS)
    assert got.shape == want.shape
    assert_same_topk(got, want)
    assert eng.last_iters == iters > 0


def test_node_engine_matches_edge_engine(datasets, port_dense):
    _, tds = datasets["synth"]
    edge = ShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4))
    np.testing.assert_allclose(
        edge.compute_topk_batch(SOURCES["synth"], K, EPS), port_dense[0],
        atol=5e-6, rtol=1e-4)
    assert edge.last_iters == port_dense[1]


@pytest.mark.parametrize("d,g", [(2, 4), (4, 2)])
def test_node_serving_path_matches_dense(datasets, port_dense, d, g):
    """The distributed top-k returns the dense result's tie-expanded ids
    and values."""
    _, tds = datasets["synth"]
    dense = port_dense[0]
    vals, ids = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(d, g)) \
        .compute_topk_ids_batch(SOURCES["synth"], K, EPS)
    assert vals.shape == (6, 42) and ids.shape == (6, 42)
    for i in range(len(ids)):
        want = set(topk_ids_with_ties(dense[i], K, tol=1e-6).tolist())
        assert set(ids[i][:K].tolist()) <= want
        np.testing.assert_allclose(vals[i], dense[i][ids[i]], atol=5e-6,
                                   rtol=1e-4)


@pytest.mark.parametrize("ring_dtype,frontier", [
    ("f32", None), ("bf16", None), ("f32", 16), ("bf16", 8)])
def test_node_engine_is_deterministic(datasets, ring_dtype, frontier):
    _, tds = datasets["synth"]
    eng = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4),
                              ring_dtype=ring_dtype,
                              frontier_blocks=frontier, num_blocks=32)
    a = eng.compute_topk_batch(SOURCES["synth"], K, EPS)
    np.testing.assert_array_equal(
        eng.compute_topk_batch(SOURCES["synth"], K, EPS), a)


def test_bf16_ring_ids_match_f32(datasets, port_dense):
    """``tests/test_ring_bf16.py``'s bars: the support prefix's id sets
    equal, values within rtol 5e-3, atol 5e-4."""
    _, tds = datasets["synth"]
    eng = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4),
                              ring_dtype="bf16")
    v16, i16 = eng.compute_topk_ids_batch(SOURCES["synth"], K, EPS)
    v32, i32 = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4)) \
        .compute_topk_ids_batch(SOURCES["synth"], K, EPS)
    for row in range(len(i16)):
        sup = min(K, int((v32[row] > 0).sum()), int((v16[row] > 0).sum()))
        assert sup >= 1
        assert set(i16[row][:sup].tolist()) == set(i32[row][:sup].tolist())
        np.testing.assert_allclose(np.sort(v16[row][:sup]),
                                   np.sort(v32[row][:sup]),
                                   rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("ring_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("nb,order", [(16, "degree"), (64, "degree"),
                                      (32, "id")])
def test_frontier_full_capacity_is_the_dense_ring(datasets, ring_dtype, nb,
                                                  order):
    _, tds = datasets["synth"]
    mesh = port_mesh(2, 4)
    dense = NodeShardedForaTopk(tds, ALPHA, K, mesh=mesh,
                                ring_dtype=ring_dtype)
    full = NodeShardedForaTopk(tds, ALPHA, K, mesh=mesh,
                               ring_dtype=ring_dtype, frontier_blocks=nb,
                               num_blocks=nb, block_order=order)
    np.testing.assert_array_equal(
        full.compute_topk_batch(SOURCES["synth"], K, EPS),
        dense.compute_topk_batch(SOURCES["synth"], K, EPS))
    assert full.last_iters == dense.last_iters


@pytest.mark.parametrize("c,nb,ring_dtype", [(4, 32, "f32"), (8, 32, "bf16"),
                                             (2, 64, "f32")])
def test_frontier_low_capacity_same_answer(datasets, port_dense, c, nb,
                                           ring_dtype):
    """Deferral changes the push order only: the same top-k, the values
    within ``tests/test_frontier_ring.py``'s bar, more sweeps."""
    _, tds = datasets["synth"]
    eng = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4),
                              frontier_blocks=c, num_blocks=nb,
                              ring_dtype=ring_dtype)
    v_s, i_s = eng.compute_topk_ids_batch(SOURCES["synth"], K, EPS)
    dense = port_dense[0]
    for row in range(len(i_s)):
        want = np.sort(dense[row])[::-1][:K]
        sup = min(K, int((want > 0).sum()), int((v_s[row] > 0).sum()))
        assert sup >= 1
        assert set(i_s[row][:sup].tolist()) <= set(
            topk_ids_with_ties(dense[row], K, tol=1e-6).tolist())
        np.testing.assert_allclose(np.sort(v_s[row][:sup])[::-1],
                                   want[:sup], rtol=5e-2, atol=5e-3)
    assert eng.last_iters >= port_dense[1]


def test_frontier_matches_jax_at_low_capacity(datasets):
    """The frontier ring against JAX's at the same capacity: the same
    blocks go each sweep, so the same sweep count and scores."""
    jds, tds = datasets["synth"]
    jeng = JaxNode(jds, ALPHA, K, mesh=jax_mesh(2, 4), frontier_blocks=4,
                   num_blocks=32)
    sp, b = jeng._pad_batch(SOURCES["synth"])
    _, _, jp, jiters = jeng._run(sp, K, 42, EPS * 0.5)
    eng = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4),
                              frontier_blocks=4, num_blocks=32)
    assert_same_topk(eng.compute_topk_batch(SOURCES["synth"], K, EPS),
                     np.asarray(jp)[:b])
    assert eng.last_iters == int(jiters)


def test_node_state_is_o_n_over_s(datasets):
    _, tds = datasets["synth"]
    eng = NodeShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 4))
    sources, _ = eng._pad_batch(np.arange(8, dtype=np.int32))
    _, _, p_local, _ = eng._run(sources, K, 4 * K, EPS * 0.5)
    n_pad = tds.graph.n_pad
    expect = eng.final_state_shard_shape(len(sources))
    assert expect == (n_pad // 4, len(sources) // 2)
    # the JAX engine's shard is the transpose (batch-major)
    jeng = JaxNode(datasets["synth"][0], ALPHA, K, mesh=jax_mesh(2, 4))
    assert jeng.final_state_shard_shape(8) == expect[::-1]
    assert len(p_local) == 2 and all(len(row) == 4 for row in p_local)
    assert all(tuple(x.shape) == expect for row in p_local for x in row)
    _, shards = eng._program(K, 4 * K)
    for row in shards:
        for sh in row:
            assert len(sh.blocks) == 4
            assert sh.inv_deg.shape == (n_pad // 4,)


def test_node_dangling_source_short_circuits(datasets):
    _, tds = datasets["tiny"]
    dense = NodeShardedForaTopk(tds, ALPHA, 2, mesh=port_mesh(2, 2)) \
        .compute_topk_batch(np.array([4, 0], np.int32), 2, EPS)
    assert dense[0, 4] == pytest.approx(1.0) and dense[0].sum() == \
        pytest.approx(1.0)
    assert dense[1].sum() == pytest.approx(1.0, abs=EPS * 0.5 * 0.5)


def test_node_engine_options_raise(datasets):
    _, tds = datasets["tiny"]
    with pytest.raises(ValueError, match="ring_dtype"):
        NodeShardedForaTopk(tds, mesh=port_mesh(1, 2), ring_dtype="fp8")
    eng = NodeShardedForaTopk(tds, mesh=port_mesh(1, 2), frontier_blocks=2,
                              block_order="hub")
    with pytest.raises(ValueError, match="block_order"):
        eng.compute_topk_batch([1], K, EPS)


# -- the ring, the all-gather propagation and the walks --------------------

@pytest.mark.parametrize("ring_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["synth", "weighted"])
def test_ring_propagate_matches_jax(datasets, kind, ring_dtype):
    jds, tds = datasets[kind]
    sources = np.array([3, 11, 42, 64])
    prepare, run = jns.make_node_sharded_propagate_ring(
        jax_mesh(2, 4), jds.graph, ALPHA, ring_dtype=ring_dtype)
    jp, _ = run(*prepare(sources), 30)
    tprep, trun = tns.make_node_sharded_propagate_ring(
        port_mesh(2, 4), tds.graph, ALPHA, ring_dtype=ring_dtype)
    tp, _ = trun(*tprep(sources), 30)
    got = tns.gather_nodes(tp).T.numpy()
    # the bf16 wire rounds in both packages; their sums differ in order
    atol = 1e-6 if ring_dtype == "f32" else 5e-3
    np.testing.assert_allclose(got, np.asarray(jp), atol=atol)


def test_bf16_ring_propagate_bounded_error(datasets):
    """``tests/test_ring_bf16.py``'s bar on the port's own rings: 60
    sweeps, the bf16 ring within 5e-3 of the f32 ring, mass within
    1e-2."""
    _, tds = datasets["synth"]
    out = {}
    for dt in ("f32", "bf16"):
        prepare, run = tns.make_node_sharded_propagate_ring(
            port_mesh(2, 4), tds.graph, ALPHA, ring_dtype=dt)
        p, _ = run(*prepare(np.array([3, 11, 42, 64])), 60)
        out[dt] = tns.gather_nodes(p).numpy()
    assert np.abs(out["bf16"] - out["f32"]).max() < 5e-3
    np.testing.assert_allclose(out["bf16"].sum(0), out["f32"].sum(0),
                               atol=1e-2)
    with pytest.raises(ValueError, match="ring_dtype"):
        tns.make_node_sharded_propagate_ring(port_mesh(1, 2), tds.graph,
                                             ALPHA, ring_dtype="fp8")


@pytest.mark.parametrize("kind", ["synth", "weighted"])
def test_all_gather_propagate_matches_jax(datasets, kind):
    jds, tds = datasets[kind]
    sources = np.array([3, 11, 42, 64])
    _, prepare, run = jns.make_node_sharded_propagate(jax_mesh(2, 4),
                                                      jds.graph, ALPHA)
    jp, jr = run(*prepare(sources), 20)
    step, tprep, trun = tns.make_node_sharded_propagate(port_mesh(2, 4),
                                                        tds.graph, ALPHA)
    state = tprep(sources)
    tp, tr = trun(*state, 20)
    np.testing.assert_allclose(tns.gather_nodes(tp).T.numpy(),
                               np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tns.gather_nodes(tr).T.numpy(),
                               np.asarray(jr), atol=1e-6)
    # the ring computes the same sweeps
    rprep, rrun = tns.make_node_sharded_propagate_ring(port_mesh(2, 4),
                                                       tds.graph, ALPHA)
    rp, _ = rrun(*rprep(sources), 20)
    np.testing.assert_allclose(tns.gather_nodes(rp).numpy(),
                               tns.gather_nodes(tp).numpy(), atol=1e-6)
    p1, _ = step(*state)
    assert tns.gather_nodes(p1).sum() == pytest.approx(4 * ALPHA)


@pytest.mark.parametrize("kind", ["wg256", "weighted"])
def test_walk_counts_conserve_weight(datasets, kind):
    """The rotating-adjacency walk ring: every walker deposits its weight
    once in its own column; two calls with one seed give the same
    counts; the stops of 2^14 walks from one source follow its PPR row."""
    _, tds = datasets[kind]
    walk = tns.make_node_sharded_walk_counts(port_mesh(2, 4), tds.graph,
                                             ALPHA)
    starts = np.repeat(np.array([[1], [7], [20], [33]], np.int32), 4096, 1)
    weights = np.full(starts.shape, 1.0 / 4096, np.float32)
    counts = tns.gather_nodes(walk(starts, weights, 5)).numpy()
    np.testing.assert_array_equal(
        counts, tns.gather_nodes(walk(starts, weights, 5)).numpy())
    np.testing.assert_allclose(counts.sum(axis=0), 1.0, atol=1e-5)
    assert counts[tds.graph.n:].sum() == 0.0
    if kind == "wg256":
        exact = _exact_rows(datasets[kind][0], [1, 7, 20, 33])
        assert np.abs(counts.T - exact).max() < 0.03


def _exact_rows(jds, sources):
    g = jds.graph
    src = np.asarray(g.edge_src)[: g.m]
    dst = np.asarray(g.edge_dst)[: g.m]
    rows = np.zeros((len(sources), g.n_pad))
    for i, s in enumerate(sources):
        rows[i, : g.n] = exact_ppr_dangling_to_source(src, dst, g.n, int(s),
                                                      ALPHA)[: g.n]
    return rows


@pytest.mark.parametrize("d,g", [(2, 4), (4, 2)])
def test_whole_graph_spmv_vs_oracle_and_jax(datasets, d, g):
    jds, tds = datasets["wg512"]
    sources = np.random.default_rng(4).integers(0, tds.n, 5).astype(np.int32)
    eng = NodeShardedForaWholeGraph(tds, ALPHA, mesh=port_mesh(d, g),
                                    completion="spmv")
    out = eng.compute_whole_graph_batch(sources, EPS)
    exact = _exact_rows(jds, sources)
    assert np.abs(out - exact).max() <= EPS / tds.n + 1e-5
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=EPS / tds.n)
    want = JaxWholeGraph(jds, ALPHA, mesh=jax_mesh(d, g),
                         completion="spmv").compute_whole_graph_batch(
        sources, EPS)
    np.testing.assert_allclose(out, want, atol=1e-6)


def test_whole_graph_walks_completion(datasets):
    jds, tds = datasets["wg256"]
    sources = np.array([1, 7, 20, 33], np.int32)
    eng = NodeShardedForaWholeGraph(tds, ALPHA, mesh=port_mesh(2, 4),
                                    completion="walks", seed=3)
    out = eng.compute_whole_graph_batch(sources, EPS)
    assert out.shape == (4, tds.graph.n_pad)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)
    assert np.abs(out - _exact_rows(jds, sources)).max() < 0.03
    # a small per-device pool makes the ring push further first
    small = NodeShardedForaWholeGraph(tds, ALPHA, mesh=port_mesh(2, 4),
                                      completion="walks", seed=3,
                                      max_walkers_per_device=1 << 14)
    out_small = small.compute_whole_graph_batch(sources, EPS)
    np.testing.assert_allclose(out_small.sum(axis=1), 1.0, atol=1e-3)
    assert small.last_iters > eng.last_iters


def test_whole_graph_weighted_walks(datasets):
    jds, tds = datasets["weighted"]
    sources = SOURCES["weighted"]
    eng = NodeShardedForaWholeGraph(tds, ALPHA, mesh=port_mesh(2, 2),
                                    completion="walks", seed=1)
    out = eng.compute_whole_graph_batch(sources, 1.0)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)
    spmv = NodeShardedForaWholeGraph(tds, ALPHA, mesh=port_mesh(2, 2)) \
        .compute_whole_graph_batch(sources, 1.0)
    assert np.abs(out - spmv).max() < 0.03


def test_whole_graph_dangling_source(datasets):
    _, tds = datasets["tiny"]
    eng = NodeShardedForaWholeGraph(tds, ALPHA, mesh=port_mesh(2, 2),
                                    completion="walks")
    out = eng.compute_whole_graph_batch(np.array([4], np.int32), EPS)
    assert out[0, 4] == pytest.approx(1.0) and out[0].sum() == \
        pytest.approx(1.0)
    with pytest.raises(ValueError, match="completion"):
        NodeShardedForaWholeGraph(tds, mesh=port_mesh(1, 2),
                                  completion="exact")


def test_walk_totals_are_exact(datasets):
    _, tds = datasets["wg256"]
    mesh = port_mesh(2, 2)
    wg = NodeShardedForaWholeGraph(tds, ALPHA, mesh=mesh)
    p, r, oh = wg._prepare(np.array([1, 7, 20, 33], np.int32))
    p, r = wg._run_ring(p, r, oh, 3)
    totals = wg._totals(r, 1e4)
    assert totals.shape == (2, 2) and totals.dtype == np.int64
    keep = np.float32(1.0) - np.float32(ALPHA)
    want = [[int(np.ceil((x.numpy() * keep)[x.numpy() > 0]
                         * np.float32(1e4)).sum()) for x in row] for row in r]
    np.testing.assert_array_equal(totals, want)


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_on_the_cpu(n):
    out = dryrun.dryrun_multichip(n, devices=["cpu"] * n)
    assert out["edge_err"] <= 5e-6 and out["node_err"] <= 5e-6
    assert len(set(out["sweeps"].values())) == 1
    # its sharded BASE part (dryrun_sharded_base): both all-pair engines
    # held to the single-device backward search, every protocol
    # algorithm's preprocessing on the mesh with a row read back
    base = out["base"]
    assert base["edge_bws_err"] <= 5e-6 and base["node_bws_err"] <= 5e-6
    assert sorted(base["store_bytes"]) == sorted(
        ["FWDPUSH", "MC", "NEO4J_METHOD", "FORA_WHOLE_GRAPH",
         "BASE_WHOLE_GRAPH"])
    assert min(base["store_bytes"].values()) > 0
