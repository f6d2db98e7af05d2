"""The port's BASE all-pair mesh engines (``ppr_tpu_torch/parallel/
sharded_allpair.py``, ``node_sharded_allpair.py``) against the JAX
package's on the same mesh shapes: JAX on its 8 virtual CPU devices
(``tests/conftest.py``), the port on ``["cpu"] * S``.

Every case of ``tests/test_sharded_allpair.py`` and
``tests/test_node_sharded_allpair.py``, on ``synthetic_powerlaw``,
``synthetic_weighted`` and the ``tiny`` graph: reserves within the JAX
package's atol 5e-6, rtol 1e-4 of JAX's mesh engines (at the same mesh
shape, 4x2, 2x4 and 1x1, on the synth and weighted graphs; at 4x2 for the
other cases), the sweeps of the
JAX backward push on the same padded batch, the stores' rows alike (ids,
order, values). At 1x1 both engines are the port's single-device
``BackwardSearch`` bit for bit (on a sparse graph: a dense one's
single-device push is a matrix product). The partition's real edges
equal JAX's element for element, and a node-sharded device holds
``[n_pad/graph, T/data]``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ppr_tpu.graph.io import Dataset as JaxDataset
from ppr_tpu.graph.io import synthetic_powerlaw, synthetic_weighted
from ppr_tpu.ops.push import backward_push_sweeps as jax_backward_sweeps
from ppr_tpu.parallel import node_sharded_allpair as jnsa
from ppr_tpu.parallel import sharded_allpair as jsa
from ppr_tpu.parallel.sharded import make_mesh as jax_make_mesh
from ppr_tpu_torch.graph.csr import build_graph, graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models.backward_search import BackwardSearch
from ppr_tpu_torch.models.base_allpair import BaseAllPair
from ppr_tpu_torch.parallel import node_sharded_allpair as tnsa
from ppr_tpu_torch.parallel import sharded_allpair as tsa
from ppr_tpu_torch.parallel.mesh import make_mesh
from ppr_tpu_torch.parallel.sharded_fora import pad_batch

ALPHA = 0.15
SHAPES = [(4, 2), (2, 4), (1, 1)]
ENGINES = {"edge": (jsa.ShardedBackwardSearch, tsa.ShardedBackwardSearch),
           "node": (jnsa.NodeShardedBackwardSearch,
                    tnsa.NodeShardedBackwardSearch)}


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
    out = {
        "synth": synthetic_powerlaw(1024, 6, seed=11, dense_threshold=0),
        "weighted": synthetic_weighted(512, 6, seed=13, dense_threshold=0),
        "prep": synthetic_powerlaw(512, 4, seed=7, dense_threshold=0),
        "tiny": JaxDataset(graph=tiny, names=[str(i) for i in range(6)],
                           name="tiny"),
    }
    return {k: (jds, port_dataset(jds)) for k, jds in out.items()}


# (graph, targets, rmax): test_sharded_allpair.py's synth, weighted and
# tight-rmax cases, an odd batch (padding rows dropped), and the tiny
# graph's dangling node, self loop and in-degree-0 nodes
CASES = {
    "synth": ("synth", np.arange(0, 1024, 37), 1e-4),
    "weighted": ("weighted", np.arange(0, 512, 29), 1e-4),
    "tight": ("synth", np.array([0, 3, 17, 50, 101]), 1e-5),
    "odd": ("synth", np.array([5, 9, 33]), 1e-3),
    "tiny": ("tiny", np.arange(6), 1e-4),
}


#: the cases held to JAX's engine at the port's own mesh shape; the
#: others to JAX's 4x2 engine at every port shape
EVERY_SHAPE = ("synth", "weighted")


def jax_sweeps(jg, targets, rmax, unit, min_t):
    """The JAX backward push's sweep count on the padded batch: the
    batch-wide count JAX's mesh loops run too."""
    padded, _ = pad_batch(targets, unit, min_t)
    oh = jnp.eye(jg.n_pad, dtype=jnp.float32)[padded]
    _, _, sweeps = jax_backward_sweeps(jg, jnp.zeros_like(oh), oh,
                                       jnp.float32(rmax), ALPHA)
    return int(sweeps)


@pytest.fixture(scope="module")
def jax_rows(datasets):
    """JAX's mesh engine's rows for ``(engine, case)`` on ``(d, g)``, each
    engine built once."""
    cache = {}

    def rows(engine, case, d, g):
        if case not in EVERY_SHAPE:
            d, g = 4, 2
        if (engine, case, d, g) not in cache:
            kind, targets, rmax = CASES[case]
            cache[engine, case, d, g] = ENGINES[engine][0](
                datasets[kind][0].graph, ALPHA, rmax=rmax,
                mesh=jax_mesh(d, g)).whole_graph(targets)
        return cache[engine, case, d, g]

    return rows


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d,g", SHAPES)
@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_backward_search_matches_jax(datasets, jax_rows, engine, d, g,
                                     case):
    kind, targets, rmax = CASES[case]
    jds, tds = datasets[kind]
    want = jax_rows(engine, case, d, g)
    eng = ENGINES[engine][1](tds.graph, ALPHA, rmax, mesh=port_mesh(d, g))
    got = eng.whole_graph(targets)
    assert got.shape == want.shape == (len(targets), tds.graph.n_pad)
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-4)
    assert eng.last_sweeps == jax_sweeps(
        jds.graph, targets, rmax, d, 8 if engine == "node" else d) > 0
    assert eng.get_duration() > 0


@pytest.mark.parametrize("kind", ["synth", "weighted"])
def test_edge_engine_1x1_is_single_device_bits(datasets, kind):
    _, tds = datasets[kind]
    targets = np.arange(0, tds.graph.n, 41)
    want = BackwardSearch(tds.graph, ALPHA, 1e-4).whole_graph(targets)
    for cls in (tsa.ShardedBackwardSearch, tnsa.NodeShardedBackwardSearch):
        got = cls(tds.graph, ALPHA, 1e-4,
                  mesh=port_mesh(1, 1)).whole_graph(targets)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["synth", "weighted", "tiny"])
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_partition_equals_jax(datasets, kind, shards):
    jds, tds = datasets[kind]
    want = jnsa.partition_edges_by_src_dst(jds.graph, shards)
    got = tnsa.partition_edges_by_src_dst(tds.graph, shards)
    assert got[4] == want[4]
    for a, b in zip(got[:4], want[:4]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, np.asarray(b))


def test_node_sharded_backward_state_o_n_over_s():
    jds = synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0)
    g = port_dataset(jds).graph
    ns = tnsa.NodeShardedBackwardSearch(g, ALPHA, 1e-3, mesh=port_mesh(2, 4))
    parts = ns.whole_graph_shards(np.arange(8, dtype=np.int32))
    n_pad = g.n_pad
    assert [[tuple(x.shape) for x in row] for row in parts] == \
        [[(n_pad // 4, 8 // 2)] * 4] * 2
    # the edge blocks are node-partitioned too: shard s holds the edges
    # whose source lies in its range, nothing else
    src = g.edge_src.numpy()[: g.m]
    for row in ns._shards:
        for s, sh in enumerate(row):
            held = sum(bl.src.numel() for bl in sh.blocks
                       if bl.src is not None)
            assert held == int(((src >= s * n_pad // 4)
                                & (src < (s + 1) * n_pad // 4)).sum())
    assert ns.whole_graph_device(np.arange(8)).shape == (8, n_pad)


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_zero_indeg_target(engine):
    """pi(t, t) = 1 for an in-degree-0 target (Backward_Search.java:
    46-49)."""
    g = build_graph(np.array([3, 0, 1]), np.array([0, 1, 2]), 4,
                    dense_threshold=0, device="cpu")
    out = ENGINES[engine][1](g, ALPHA, 1e-3, mesh=port_mesh(2, 2)) \
        .whole_graph(np.array([3], np.int32))
    assert out[0, 3] == pytest.approx(1.0)
    assert out[0].sum() == pytest.approx(1.0)


@pytest.mark.parametrize("engine,d,g", [("edge", 4, 2), ("node", 2, 4)])
def test_base_allpair_store_rows_match_jax(datasets, tmp_path, monkeypatch,
                                          engine, d, g):
    """The whole preprocessing on the mesh writes JAX's rows (ids, order,
    values); the store reads back on one device, and a single-device
    store on the mesh."""
    monkeypatch.chdir(tmp_path)
    jds, tds = datasets["prep"]
    threshold, k = 1e-3, 5
    jfactory = {"edge": jsa.sharded_base_allpair,
                "node": jnsa.node_sharded_base_allpair}[engine]
    tfactory = {"edge": tsa.sharded_base_allpair,
                "node": tnsa.node_sharded_base_allpair}[engine]
    probe = np.array([0, 3, 14, 50, 301, tds.graph.n - 1])
    rows = {}
    for name, algo in (
            ("jax", jfactory(jds, ALPHA, mesh=jax_mesh(d, g),
                             target_batch=128)),
            ("port", tfactory(tds, ALPHA, mesh=port_mesh(d, g),
                              target_batch=128))):
        assert (algo.name, algo.prep_dirname) == ("BASE", "BASE_ppr_results")
        algo.prep_dirname = f"{name}_store"
        algo.preprocessing(threshold, k, progress=False)
        rows[name] = (algo.compute_whole_graph_batch(probe),
                      list(algo._last_order))
    np.testing.assert_allclose(rows["port"][0], rows["jax"][0], atol=5e-6,
                               rtol=1e-4)
    for a, b in zip(rows["port"][1], rows["jax"][1]):
        np.testing.assert_array_equal(a, b)

    # the mesh's store on one device, a single-device store on the mesh
    single = BaseAllPair(tds, ALPHA)
    single.prep_dirname = "port_store"
    single.attach_store(threshold, k)
    np.testing.assert_array_equal(single.compute_whole_graph_batch(probe),
                                  rows["port"][0])
    single.prep_dirname = "single_store"
    single.preprocessing(threshold, k, progress=False)
    mesh_algo = tfactory(tds, ALPHA, mesh=port_mesh(d, g))
    mesh_algo.prep_dirname = "single_store"
    mesh_algo.attach_store(threshold, k)
    np.testing.assert_allclose(mesh_algo.compute_whole_graph_batch(probe),
                               rows["port"][0], atol=5e-6, rtol=1e-4)
