"""Parity of the port's graph store with the JAX package's: the same edges
give the same arrays, field for field, with or without the dense operator."""

import dataclasses

import numpy as np
import pytest
import torch

from ppr_tpu.graph import csr as jcsr
from ppr_tpu.graph import io as jio
from ppr_tpu_torch.device import default_device, resolve_device
from ppr_tpu_torch.graph import csr as tcsr
from ppr_tpu_torch.graph import io as tio

FIELDS = ("indptr", "indices", "edge_src", "edge_dst", "edge_mask",
          "edge_src_bydst", "edge_dst_bydst", "out_deg", "in_deg",
          "node_mask", "dense_out")


def jax_fields(g):
    return {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}


def assert_same_graph(jg, tg):
    assert (tg.n, tg.m, tg.n_pad, tg.m_pad) == (jg.n, jg.m, jg.n_pad, jg.m_pad)
    assert tg.has_dense == jg.has_dense
    for name in FIELDS:
        a, b = getattr(jg, name), getattr(tg, name)
        if a is None:
            assert b is None, name
            continue
        a = np.asarray(a)
        assert b.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[a.dtype], name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    # the row pointer delimits each destination's edges
    dst = tg.edge_dst_bydst.numpy()
    ptr = tg.bydst_ptr.numpy()
    assert ptr[0] == 0 and ptr[-1] == tg.m_pad
    counts = np.bincount(dst, minlength=tg.n_pad)
    np.testing.assert_array_equal(np.diff(ptr), counts)
    # and the by-source pointer each source's edges in the primary order
    src_ptr = tg.bysrc_ptr.numpy()
    assert src_ptr[0] == 0 and src_ptr[-1] == tg.m_pad
    np.testing.assert_array_equal(
        np.diff(src_ptr), np.bincount(tg.edge_src.numpy(), minlength=tg.n_pad))


def _edges(case):
    if case == "tiny":
        return np.array([0, 0, 1, 2, 3, 5]), np.array([1, 2, 2, 0, 0, 5]), 6
    g = (jio.load_default() if case == "got" else
         jio.synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0)).graph
    return (np.asarray(g.edge_src)[: g.m], np.asarray(g.edge_dst)[: g.m], g.n)


@pytest.mark.parametrize("dense_threshold", [4096, 0],
                         ids=["dense", "sparse"])
@pytest.mark.parametrize("case", ["tiny", "got", "synth2048"])
def test_build_graph_matches_jax(case, dense_threshold):
    src, dst, n = _edges(case)
    jg = jcsr.build_graph(src, dst, n, dense_threshold=dense_threshold)
    tg = tcsr.build_graph(src, dst, n, dense_threshold=dense_threshold,
                          device="cpu")
    assert_same_graph(jg, tg)
    assert_same_graph(jg, tcsr.graph_from_numpy(jax_fields(jg), device="cpu"))


@pytest.mark.parametrize("dense_threshold", [4096, 0],
                         ids=["dense", "sparse"])
def test_synthetic_powerlaw_same_edges(dense_threshold):
    jd = jio.synthetic_powerlaw(2048, 8, seed=3,
                                dense_threshold=dense_threshold)
    td = tio.synthetic_powerlaw(2048, 8, seed=3,
                                dense_threshold=dense_threshold, device="cpu")
    assert td.name == jd.name and td.names == jd.names
    assert_same_graph(jd.graph, td.graph)


def test_load_default_matches_jax():
    jd, td = jio.load_default(), tio.load_default(device="cpu")
    assert td.name == jd.name and td.n == jd.n
    assert_same_graph(jd.graph, td.graph)


def test_sentinel_is_padding(tiny):
    tg = tcsr.graph_from_numpy(jax_fields(tiny), device="cpu")
    sentinel = tg.n_pad - 1
    assert tg.n <= sentinel
    assert tg.node_mask[sentinel] == 0 and tg.out_deg[sentinel] == 0
    pad = tg.edge_mask.numpy() == 0
    assert (tg.edge_src.numpy()[pad] == sentinel).all()
    assert (tg.edge_dst_bydst.numpy()[pad] == sentinel).all()


def test_weighted_graphs_not_ported():
    with pytest.raises(NotImplementedError):
        tcsr.build_graph([0], [1], 2, weights=np.ones(1))
    jw = jio.synthetic_weighted(64, 4, seed=1)
    with pytest.raises(NotImplementedError):
        tcsr.graph_from_numpy(jax_fields(jw.graph), device="cpu")


def test_neo4j_csv_loader(tmp_path):
    nodes = tmp_path / "n.csv"
    rels = tmp_path / "r.csv"
    nodes.write_text("﻿:ID,name\na,Arya\nb,Bran\nc,Cersei\n")
    rels.write_text(":START_ID,:END_ID\na,b\nb,c\nc,a\na,c\n")
    jd = jio.load_neo4j_csv(str(nodes), str(rels))
    td = tio.load_neo4j_csv(str(nodes), str(rels), device="cpu")
    assert td.names == ["Arya", "Bran", "Cersei"] and td.name == jd.name
    assert_same_graph(jd.graph, td.graph)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        default_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def _write_inputs(tmp_path):
    (tmp_path / "n.csv").write_text(":ID,name\na,A\nb,B\n")
    (tmp_path / "r.csv").write_text(":START_ID,:END_ID\na,b\n")
    (tmp_path / "e.txt").write_text("1 2\n2 3\n")


_LOADERS = {
    "synthetic_powerlaw": lambda p, **kw: tio.synthetic_powerlaw(64, 4, **kw),
    "load_default": lambda p, **kw: tio.load_default(**kw),
    "load_neo4j_csv": lambda p, **kw: tio.load_neo4j_csv(
        str(p / "n.csv"), str(p / "r.csv"), **kw),
    "load_edge_list": lambda p, **kw: tio.load_edge_list(str(p / "e.txt"),
                                                         **kw),
    "build_graph": lambda p, **kw: tcsr.build_graph([0], [1], 2, **kw),
}


@pytest.mark.parametrize("loader", sorted(_LOADERS))
def test_loaders_place_on_the_card_unless_asked(tmp_path, monkeypatch,
                                                loader):
    """``device=None`` means the card: with none visible every loader
    raises; it never places the graph on the CPU by itself."""
    _write_inputs(tmp_path)
    load = _LOADERS[loader]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load(tmp_path, device="cuda")
    out = load(tmp_path, device="cpu")
    assert getattr(out, "graph", out).device == torch.device("cpu")


@pytest.mark.parametrize("dense_threshold", [4096, 0],
                         ids=["dense", "sparse"])
def test_edge_list_loader(tmp_path, dense_threshold):
    # comments, a blank line, a self loop, sparse ids, a duplicate edge
    path = tmp_path / "snap.txt"
    path.write_text("# Directed graph (each unordered pair of nodes)\n"
                    "# FromNodeId\tToNodeId\n"
                    "100\t7\n7\t100\n7\t7\n\n"
                    "90000\t100\n100  3\n3\t90000\n100\t7\n")
    jd = jio.load_edge_list(str(path), dense_threshold=dense_threshold)
    td = tio.load_edge_list(str(path), dense_threshold=dense_threshold,
                            device="cpu")
    assert td.names == jd.names == ["100", "7", "90000", "3"]
    assert td.name == jd.name == "snap" and (td.n, td.graph.m) == (4, 7)
    assert_same_graph(jd.graph, td.graph)
    with pytest.raises(NotImplementedError):
        tio.load_edge_list(str(path), weighted=True)
