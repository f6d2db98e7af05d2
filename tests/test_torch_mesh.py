"""The port's mesh (``ppr_tpu_torch/parallel/mesh.py``) and the
partitions of ``parallel/node_sharded.py``.

``make_mesh`` splits and refuses as ``ppr_tpu/parallel/sharded.py:40-55``
does, and with ``devices=None`` it takes only visible cards; the
collectives are held to numpy (``psum`` adds in shard order, so to the
bit); the three partitions equal the JAX package's arrays element for
element on the same graphs."""

import dataclasses

import numpy as np
import pytest
import torch

from ppr_tpu.graph.csr import build_graph as jax_build_graph
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.parallel import node_sharded as jns
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.parallel import mesh as tmesh
from ppr_tpu_torch.parallel import node_sharded as tns


def port_graph(jg):
    return graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")


@pytest.fixture(scope="module")
def graphs(tiny):
    rng = np.random.default_rng(2)
    src = rng.integers(0, 1024, 6144)
    dst = rng.integers(0, 1024, 6144)
    weighted = jax_build_graph(src, dst, n=1024,
                               weights=rng.uniform(0.1, 4.0, 6144),
                               dense_threshold=0)
    out = {"synth": synthetic_powerlaw(2048, 8, seed=5,
                                       dense_threshold=0).graph,
           "tiny": tiny, "weighted": weighted}
    return {k: (g, port_graph(g)) for k, g in out.items()}


@pytest.mark.parametrize("n,kw,shape", [
    (8, {}, (4, 2)), (6, {}, (3, 2)), (3, {}, (3, 1)),
    (8, {"data": 2, "graph": 4}, (2, 4)), (4, {"graph": 4}, (1, 4)),
    (None, {"data": 2, "graph": 2}, (2, 2)),
])
def test_make_mesh_splits_as_jax(n, kw, shape):
    m = tmesh.make_mesh(n, devices=["cpu"] * 8, **kw)
    assert (m.data, m.graph) == shape
    assert m.shape == {"data": shape[0], "graph": shape[1]}
    assert m.axis_names == ("data", "graph")
    assert m.unique_devices() == [torch.device("cpu")]
    assert m.controller == torch.device("cpu")


def test_make_mesh_keeps_device_order():
    devs = [torch.device("cpu")] * 2 + [torch.device("meta")] * 2
    m = tmesh.make_mesh(4, data=2, graph=2, devices=devs)
    assert m.devices == [devs[:2], devs[2:]]


@pytest.mark.parametrize("n,kw,match", [
    (8, {"data": 3, "graph": 2}, "mesh 3x2 != 8"),
    (9, {}, "9 devices asked for; 8 given"),
])
def test_make_mesh_errors(n, kw, match):
    with pytest.raises(ValueError, match=match):
        tmesh.make_mesh(n, devices=["cpu"] * 8, **kw)


def test_make_mesh_without_cards_raises(monkeypatch):
    """``devices=None`` is the visible cards, never the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for args, kw in (((), {}), ((4,), {}), ((), {"data": 2, "graph": 2})):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmesh.make_mesh(*args, **kw)


def test_make_mesh_with_too_few_cards_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 cards; 1 visible"):
        tmesh.make_mesh(4, data=2, graph=2)
    assert tmesh.make_mesh(1).devices == [[torch.device("cuda", 0)]]


@pytest.mark.parametrize("spec,want", [("2x2", (2, 2)), ("1X4", (1, 4)),
                                       ("4x1", (4, 1))])
def test_parse_mesh(spec, want):
    assert tmesh.parse_mesh(spec) == want


@pytest.mark.parametrize("spec", ["2", "ax2", "0x2", "2x2x2"])
def test_parse_mesh_rejects(spec):
    with pytest.raises(ValueError):
        tmesh.parse_mesh(spec)


def _parts(n, shape=(5, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random(shape, dtype=np.float32) for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_psum_adds_in_shard_order(n):
    arrs = _parts(n)
    got = tmesh.psum([torch.from_numpy(a) for a in arrs])
    want = arrs[0]
    for a in arrs[1:]:
        want = want + a
    assert len(got) == n
    for x in got:
        np.testing.assert_array_equal(x.numpy(), want)


@pytest.mark.parametrize("n", [1, 3])
def test_pmax_pmin(n):
    vals = [np.float32(v) for v in np.random.default_rng(n).random(n)]
    parts = [torch.tensor(v) for v in vals]
    assert all(float(x) == max(vals) for x in tmesh.pmax(parts))
    assert all(float(x) == min(vals) for x in tmesh.pmin(parts))


@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_ppermute_moves_one_step(wire):
    arrs = _parts(4)
    got = tmesh.ppermute([torch.from_numpy(a) for a in arrs],
                         [torch.device("cpu")] * 4, wire)
    for i, x in enumerate(got):
        src = torch.from_numpy(arrs[(i - 1) % 4])
        want = src if wire is None else src.to(wire).float()
        assert x.dtype == torch.float32
        assert torch.equal(x, want)


def test_ppermute_keeps_integer_payloads():
    parts = [torch.arange(3) + 10 * i for i in range(3)]
    got = tmesh.ppermute(parts, [torch.device("cpu")] * 3)
    assert [x.tolist() for x in got] == [[20, 21, 22], [0, 1, 2],
                                         [10, 11, 12]]


@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather_concatenates_in_order(dim):
    arrs = _parts(3)
    got = tmesh.all_gather([torch.from_numpy(a) for a in arrs], dim)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(arrs, dim))


def test_shard_generators_are_seeded_per_shard():
    m = tmesh.make_mesh(4, devices=["cpu"] * 4)
    draws = [[torch.rand(4, generator=g_) for g_ in row]
             for row in tmesh.shard_generators(m, 5)]
    again = [[torch.rand(4, generator=g_) for g_ in row]
             for row in tmesh.shard_generators(m, 5)]
    flat = [x for row in draws for x in row]
    assert all(torch.equal(a, b) for ra, rb in zip(draws, again)
               for a, b in zip(ra, rb))
    assert len({tuple(x.tolist()) for x in flat}) == 4


def test_split():
    assert tmesh.split(8, 4) == [slice(0, 2), slice(2, 4), slice(4, 6),
                                 slice(6, 8)]
    with pytest.raises(ValueError, match="do not split"):
        tmesh.split(6, 4)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if b is None or isinstance(b, int):
            assert a == b
        else:
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("kind", ["synth", "tiny", "weighted"])
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_partitions_equal_jax(graphs, kind, shards):
    jg, tg = graphs[kind]
    _equal(tns.partition_edges_by_dst(tg, shards),
           jns.partition_edges_by_dst(jg, shards))
    _equal(tns.partition_edges_by_dst_src(tg, shards),
           jns.partition_edges_by_dst_src(jg, shards))
    _equal(tns.partition_csr_by_node(tg, shards),
           jns.partition_csr_by_node(jg, shards))


def test_partitions_reject_uneven_split(graphs):
    _, tg = graphs["tiny"]
    for fn in (tns.partition_edges_by_dst, tns.partition_edges_by_dst_src,
               tns.partition_csr_by_node):
        with pytest.raises(ValueError, match="not divisible by 3"):
            fn(tg, 3)
