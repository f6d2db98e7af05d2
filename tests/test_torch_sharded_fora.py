"""The port's edge-sharded engines (``ppr_tpu_torch/parallel/sharded.py``,
``sharded_fora.py``) against the JAX package's on the same mesh shapes:
JAX on its 8 virtual CPU devices (``tests/conftest.py``), the port on
``["cpu"] * S``.

Tolerances are the JAX package's own (``tests/test_sharded_fora.py``):
scores within atol 5e-6, rtol 1e-4 (float reassociation across edge
chunks and collectives), tie-expanded top-k id sets equal at tol 1e-6,
and the same sweep count. The port's 1x1 mesh is the single-device
annealed loop without a hub split, bit for bit, and two runs of an engine
give the same bits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.csr import build_graph as jax_build_graph
from ppr_tpu.graph.io import Dataset as JaxDataset
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.ops.topk import topk_ids_with_ties
from ppr_tpu.parallel import sharded as jsharded
from ppr_tpu.parallel.sharded_fora import ShardedForaTopk as JaxEdge
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models.fora import ForaTopk
from ppr_tpu_torch.parallel import sharded as tsharded
from ppr_tpu_torch.parallel.mesh import make_mesh
from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

ALPHA, EPS, K = 0.15, 0.5, 10
SHAPES = [(4, 2), (2, 4), (2, 2), (4, 1)]


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


def jax_mesh(d, g):
    return jsharded.make_mesh(d * g, data=d, graph=g)


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
    """The JAX engine's ``(dense [B, n_pad], iters, vals, ids)`` per graph
    and mesh shape, each engine built once."""
    cache = {}

    def run(kind, d, g):
        if (kind, d, g) not in cache:
            jds, _ = datasets[kind]
            eng = JaxEdge(jds, ALPHA, K, mesh=jax_mesh(d, g))
            sources = SOURCES[kind]
            sp, b = eng._pad_batch(sources)
            kcap = min(max(4 * K, K + 32), jds.graph.n_pad)
            vals, ids, p_t, iters = eng._call(
                eng._program(K, kcap), *eng._prepare_state(sp), EPS * 0.5)
            cache[kind, d, g] = (np.asarray(p_t).T[:b], int(iters),
                                 np.asarray(vals)[:b], np.asarray(ids)[:b])
        return cache[kind, d, g]

    return run


def assert_same_topk(got, want, k=K):
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-4)
    for i in range(len(got)):
        assert set(topk_ids_with_ties(got[i], k, tol=1e-6).tolist()) == \
            set(topk_ids_with_ties(want[i], k, tol=1e-6).tolist()), i


@pytest.mark.parametrize("kind", ["synth", "tiny", "weighted"])
@pytest.mark.parametrize("d,g", SHAPES)
def test_edge_engine_matches_jax(datasets, jax_runs, kind, d, g):
    _, tds = datasets[kind]
    want, iters, _, _ = jax_runs(kind, d, g)
    eng = ShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(d, g))
    got = eng.compute_topk_batch(SOURCES[kind], K, EPS)
    assert got.shape == want.shape
    assert_same_topk(got, want)
    assert eng.last_iters == iters > 0


@pytest.mark.parametrize("d,g", [(4, 2), (2, 2)])
def test_edge_serving_path_matches_jax(datasets, jax_runs, d, g):
    """``compute_topk_ids_batch``: the JAX engine's tie-expanded ids, the
    values within its bar."""
    _, tds = datasets["synth"]
    _, _, jv, ji = jax_runs("synth", d, g)
    vals, ids = ShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(d, g)) \
        .compute_topk_ids_batch(SOURCES["synth"], K, EPS)
    assert vals.shape == jv.shape and ids.shape == ji.shape
    for i in range(len(ids)):
        assert set(ids[i][:K].tolist()) == set(ji[i][:K].tolist())
        np.testing.assert_allclose(np.sort(vals[i][:K]), np.sort(jv[i][:K]),
                                   atol=5e-6, rtol=1e-4)


def test_edge_dangling_source_short_circuits(datasets):
    """Fora_Topk.java:128-132 on the mesh: a dangling source's row is e_s;
    another row keeps its mass up to the eps*delta truncation."""
    _, tds = datasets["tiny"]
    dense = ShardedForaTopk(tds, ALPHA, 2, mesh=port_mesh(2, 2)) \
        .compute_topk_batch(np.array([4, 0], np.int32), 2, EPS)
    assert dense[0, 4] == pytest.approx(1.0) and dense[0].sum() == \
        pytest.approx(1.0)
    assert dense[1].sum() == pytest.approx(1.0, abs=EPS * 0.5 * 0.5)


@pytest.mark.parametrize("kind", ["synth", "weighted"])
def test_one_by_one_is_the_single_device_loop(datasets, kind):
    """A 1x1 mesh pushes the whole edge list through one chunk: the
    single-device annealed loop (no hub split), bit for bit."""
    _, tds = datasets[kind]
    sources = SOURCES[kind]
    single = ForaTopk(tds, ALPHA, K, push="none")
    want = single.compute_topk_batch(sources, K, EPS)
    eng = ShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(1, 1))
    np.testing.assert_array_equal(eng.compute_topk_batch(sources, K, EPS),
                                  want)
    assert eng.last_iters == single.last_iters


@pytest.mark.parametrize("d,g", [(2, 4), (4, 1)])
def test_edge_engine_is_deterministic(datasets, d, g):
    _, tds = datasets["synth"]
    eng = ShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(d, g))
    a = eng.compute_topk_ids_batch(SOURCES["synth"], K, EPS)
    b = eng.compute_topk_ids_batch(SOURCES["synth"], K, EPS)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_edge_chunks_cover_the_edges(datasets):
    """The chunks split the destination-sorted edges as ``P("graph")``
    does, and their row pointers partition each node's segment."""
    _, tds = datasets["synth"]
    g = tds.graph
    chunks = tsharded.edge_chunks(g, port_mesh(2, 4))
    assert len(chunks) == 2 and all(len(row) == 4 for row in chunks)
    src = torch.cat([c.src for c in chunks[0]])
    assert torch.equal(src, g.edge_src_bydst)
    ptr = sum(c.ptr for c in chunks[1])
    assert torch.equal(ptr, g.bydst_ptr)
    assert chunks[0][1].src.data_ptr() != chunks[1][1].src.data_ptr()


def test_empty_batch(datasets):
    _, tds = datasets["tiny"]
    eng = ShardedForaTopk(tds, ALPHA, K, mesh=port_mesh(2, 2))
    vals, ids = eng.compute_topk_ids_batch(np.zeros(0, np.int32), K, EPS)
    assert vals.shape == (0, 0) and ids.shape == (0, 0)
    assert eng.compute_topk_batch([], K, EPS).shape == (0, tds.graph.n_pad)


@pytest.mark.parametrize("kind", ["synth", "weighted"])
def test_push_sweeps_match_jax(datasets, kind):
    """``make_sharded_push_sweeps``: four frontier-gated push sweeps on a
    4x2 mesh, node-major in the port, batch-major in JAX."""
    jds, tds = datasets[kind]
    jg, tg = jds.graph, tds.graph
    b, rmax = 8, 1e-4
    sources = np.arange(b, dtype=np.int32) * 7 % jg.n
    onehot = np.eye(jg.n_pad, dtype=np.float32)[sources]
    jmesh = jax_mesh(4, 2)
    gs = jsharded.shard_graph(jg, jmesh)
    push = jsharded.make_sharded_push_sweeps(jmesh, ALPHA, 4,
                                             weighted=jg.weighted)
    edges = (gs.edge_src, gs.edge_dst, gs.edge_mask) + (
        (gs.edge_coef,) if jg.weighted else ())
    jp, jr = push(*edges, gs.out_deg, gs.node_mask,
                  jnp.zeros((b, jg.n_pad)), jnp.asarray(onehot),
                  jnp.asarray(onehot), jnp.float32(rmax))
    mesh = port_mesh(4, 2)
    run = tsharded.make_sharded_push_sweeps(mesh, ALPHA, 4)
    put = lambda x: tsharded.put_columns(mesh, torch.from_numpy(x.T))  # noqa
    tp, tr = run(tsharded.shard_graph(tg, mesh), put(np.zeros_like(onehot)),
                 put(onehot), put(onehot), rmax)
    np.testing.assert_allclose(tsharded.gather_columns(tp).T.numpy(),
                               np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tsharded.gather_columns(tr).T.numpy(),
                               np.asarray(jr), atol=1e-6)


def test_walk_counts_conserve_weight(datasets):
    """``make_sharded_walk_counts``: every walker deposits its weight once
    in its own row, at a node its walk can stop at; two calls with one
    seed give the same counts."""
    _, tds = datasets["weighted"]
    mesh = port_mesh(2, 2)
    gs = tsharded.shard_graph(tds.graph, mesh)
    walk = tsharded.make_sharded_walk_counts(mesh, ALPHA)
    starts = np.repeat(np.array([[1], [5], [9], [700]], np.int32), 64, 1)
    weights = np.full(starts.shape, 1.0 / 64, np.float32)
    counts = tsharded.gather_columns(walk(gs, starts, weights, 3)).numpy()
    again = tsharded.gather_columns(walk(gs, starts, weights, 3)).numpy()
    np.testing.assert_array_equal(counts, again)
    np.testing.assert_allclose(counts.sum(axis=0), 1.0, atol=1e-6)
    assert counts[tds.graph.n:].sum() == 0.0


def test_sharded_fora_step_runs(datasets):
    """The fixed-schedule step of the dry run: four push sweeps and a walk
    estimate of the residue keep every row's mass."""
    _, tds = datasets["synth"]
    mesh = port_mesh(2, 2)
    step, example = tsharded.sharded_fora_step(mesh, tds.graph, ALPHA,
                                               num_sweeps=2)
    p, r = step(*example)
    p = tsharded.gather_columns(p).numpy()
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p.sum(axis=0), 1.0, atol=1e-5)


@pytest.mark.parametrize("kwargs", [
    dict(early_exit=True), dict(cohort=True), dict(mesh_engine="ring"),
    dict(mesh_engine="edge", frontier_blocks=4),
], ids=["early-exit", "cohort", "engine", "blocks-edge"])
def test_service_mesh_validation_matches_jax(datasets, kwargs):
    """``PPRService(mesh=...)`` refuses what the JAX service refuses, with
    the same message."""
    from ppr_tpu.service import PPRService as JaxService
    from ppr_tpu_torch.service import PPRService

    jds, tds = datasets["tiny"]
    with pytest.raises(ValueError) as jerr:
        JaxService(jds, mesh=jax_mesh(2, 2), **kwargs)
    with pytest.raises(ValueError) as terr:
        PPRService(tds, mesh=port_mesh(2, 2), **kwargs)
    assert str(terr.value) == str(jerr.value)
