"""The automatic hub count of the port (``ppr_tpu_torch/ops/hub_split.py::
auto_num_hubs``) against the JAX package's (``ppr_tpu/ops/hub_split.py:
47-69``), its count through ``build_hub_split``, and ``"auto"`` through
``resolve_hub_split``, ``ForaTopk.enable_hub_split()`` and
``PPRService(hub_split="auto")``: no split where no node passes the rule's
threshold, else the rule's split exactly.

Given the same prices the two rules give the same count, an exact integer;
the same count gives the same hub ids, matrix and tail, exactly. Served
top-10 sets are tie-expanded and equal to JAX's, reserves within 1e-6
(f32 hub product) and 1e-5 (bf16: the product adds in another order, the
bar of ``tests/test_torch_service.py``). The port's default prices are its
own card-measured constants, not the JAX package's v5e ones, read at call
time, so a test sets prices by setting the module's constants."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.csr import build_graph as jax_build_graph
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.models.fora import ForaTopk as JaxForaTopk
from ppr_tpu.ops import hub_split as jhs
from ppr_tpu.service import PPRService as JaxService
from ppr_tpu_torch.graph.csr import build_graph, graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models.fora import ForaTopk
from ppr_tpu_torch.ops import hub_split as ths
from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs
from ppr_tpu_torch.service import PPRService

#: the JAX package's defaults (TPU v5e), passed to both rules
V5E = dict(tail_ns_per_edge=12.0, hbm_gbps=800.0)
SOURCES = np.array([0, 3, 14, 50, 77, 101, 500, 1999])


def v5e_prices(monkeypatch):
    """The module's prices, which every default reads, set to JAX's."""
    monkeypatch.setattr(ths, "TAIL_NS_PER_EDGE", V5E["tail_ns_per_edge"])
    monkeypatch.setattr(ths, "HUB_COLUMN_GBPS", V5E["hbm_gbps"])


def port_graph(jg):
    return graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")


def port_dataset(jds):
    return Dataset(graph=port_graph(jds.graph), names=jds.names,
                   name=jds.name)


@pytest.fixture(scope="module")
def skewed():
    """``tests/test_hub_split.py::skewed``: most edges land on a few
    hubs."""
    rng = np.random.default_rng(8)
    n, m = 400, 5000
    src = rng.integers(0, n, m)
    w = 1.0 / (np.arange(n) + 1.0)
    dst = rng.choice(n, size=m, p=w / w.sum())
    jg = jax_build_graph(src, dst, n=n, dense_threshold=0)
    return jg, port_graph(jg)


@pytest.fixture(scope="module")
def synth():
    jds = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0)
    return jds, port_dataset(jds)


PRICES = [V5E, dict(tail_ns_per_edge=0.5, hbm_gbps=800.0),
          dict(tail_ns_per_edge=0.05, hbm_gbps=400.0),
          dict(tail_ns_per_edge=12.0, hbm_gbps=800.0,
               max_matrix_bytes=512 * 2 * 128)]


@pytest.mark.parametrize("prices", PRICES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_count_equals_jax(skewed, synth, prices, dtype):
    jdt, tdt = ((np.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    for jg, tg in (skewed, (synth[0].graph, synth[1].graph)):
        want = jhs.auto_num_hubs(jg, jdt, **prices)
        got = ths.auto_num_hubs(tg, tdt, **prices)
        assert isinstance(got, int) and got == want
        assert got >= 128 and got % 128 == 0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_auto_split_equals_jax(skewed, dtype):
    """``build_hub_split(g, auto_num_hubs(g))`` under JAX's prices: the
    same hub ids, matrix and tail as JAX's ``"auto"``, exactly."""
    jg, tg = skewed
    jdt, tdt = ((np.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    js = jhs.build_hub_split(jg, "auto", dtype=jdt)
    ts = ths.build_hub_split(tg, ths.auto_num_hubs(tg, tdt, **V5E), tdt)
    assert ts.num_hubs == js.num_hubs and ts.m_tail == js.m_tail
    np.testing.assert_array_equal(ts.hub_ids.numpy(),
                                  np.asarray(js.hub_ids))
    np.testing.assert_array_equal(
        ts.hub_matrix.float().numpy(),
        np.asarray(js.hub_matrix.astype(jnp.float32)))
    np.testing.assert_array_equal(ts.tail_src.numpy(),
                                  np.asarray(js.tail_src))
    np.testing.assert_array_equal(ts.tail_dst.numpy(),
                                  np.asarray(js.tail_dst))


def test_matrix_counts_multiplicities():
    """Parallel edges to a hub count in its matrix cell, as JAX's
    ``np.add.at`` counts them."""
    src = np.array([0, 0, 0, 1, 2, 2, 3, 1])
    dst = np.array([4, 4, 4, 4, 4, 5, 5, 5])
    jg = jax_build_graph(src, dst, n=6, dense_threshold=0)
    js = jhs.build_hub_split(jg, 2)
    ts = ths.build_hub_split(port_graph(jg), 2)
    np.testing.assert_array_equal(ts.hub_matrix.numpy(),
                                  np.asarray(js.hub_matrix))
    assert ts.hub_matrix[0, 0] == 3.0


def test_defaults_are_the_card_constants(skewed, monkeypatch):
    """The defaults are the module's named card prices, not JAX's v5e
    12 ns an edge and 800 GB/s, read at call time: under JAX's prices the
    default count is JAX's default count."""
    jg, tg = skewed
    assert ths.auto_num_hubs.__kwdefaults__ == dict(
        tail_ns_per_edge=None, hbm_gbps=None, max_matrix_bytes=None)
    assert (ths.TAIL_NS_PER_EDGE, ths.HUB_COLUMN_GBPS) != (12.0, 800.0)
    assert ths.TAIL_NS_PER_EDGE > 0 and ths.HUB_COLUMN_GBPS > 0
    assert ths.MAX_MATRIX_BYTES == 4 << 30 and ths.REF_BATCH == 512
    assert ths.auto_num_hubs(tg) == ths.auto_num_hubs(
        tg, tail_ns_per_edge=ths.TAIL_NS_PER_EDGE,
        hbm_gbps=ths.HUB_COLUMN_GBPS, max_matrix_bytes=ths.MAX_MATRIX_BYTES)
    assert ths.resolve_hub_split(tg, "auto").num_hubs == \
        ths.auto_num_hubs(tg)
    v5e_prices(monkeypatch)
    assert ths.auto_num_hubs(tg) == jhs.auto_num_hubs(jg)


def topk_sets(vals, ids, k=10, tol=0.0):
    return [set(topk_ids_with_ties_from_pairs(vals[i], ids[i], k,
                                              tol=tol).tolist())
            for i in range(len(vals))]


def assert_same_topk(jout, tout, atol):
    (jv, ji), (tv, ti) = jout, tout
    assert topk_sets(np.asarray(jv), np.asarray(ji)) == topk_sets(tv, ti)
    for row in range(len(tv)):
        jscore = dict(zip(np.asarray(ji[row]).tolist(),
                          np.asarray(jv[row]).tolist()))
        for node in topk_ids_with_ties_from_pairs(tv[row], ti[row], 10):
            assert abs(tv[row][list(ti[row]).index(node)]
                       - jscore[int(node)]) <= atol


@pytest.mark.parametrize("prices", ["v5e", "card"])
def test_fora_enable_hub_split_default(synth, monkeypatch, prices):
    """``ForaTopk.enable_hub_split()`` takes ``"auto"`` and an f32 hub
    product, as JAX's does. Under JAX's prices the counts are equal; under
    the card's the count is the port's own, and the f32 product still
    gives JAX's sets (the split only reorders sums)."""
    jds, tds = synth
    if prices == "v5e":
        v5e_prices(monkeypatch)
    jalgo = JaxForaTopk(jds, 0.15, 10, push="none")
    talgo = ForaTopk(tds, 0.15, 10, push="none")
    jalgo.enable_hub_split()
    talgo.enable_hub_split()
    assert talgo.hub_split.dtype == torch.float32
    if prices == "v5e":
        assert talgo.hub_split.num_hubs == jalgo.hub_split.num_hubs
    else:
        assert talgo.hub_split.num_hubs == ths.auto_num_hubs(tds.graph)
    assert_same_topk(jalgo.compute_topk_ids_batch(SOURCES, 10, 0.5),
                     talgo.compute_topk_ids_batch(SOURCES, 10, 0.5), 1e-6)
    assert talgo.last_iters > 0


def test_service_hub_split_auto(synth, monkeypatch):
    """``PPRService(hub_split="auto")`` builds one bf16 split, shared by
    both algorithms, with JAX's count under JAX's prices, and serves JAX's
    hits."""
    jds, tds = synth
    v5e_prices(monkeypatch)
    jsvc = JaxService.from_dataset(jds, alpha=0.15, eps=0.5, k=10, seed=7,
                                   hub_split="auto")
    tsvc = PPRService.from_dataset(tds, alpha=0.15, eps=0.5, k=10, seed=7,
                                   hub_split="auto")
    hs = tsvc._topk_algo.hub_split
    assert hs is tsvc._wg_algo.hub_split and hs.dtype == torch.bfloat16
    assert hs.num_hubs == jsvc._topk_algo.hub_split.num_hubs
    np.testing.assert_array_equal(
        hs.hub_ids.numpy(), np.asarray(jsvc._topk_algo.hub_split.hub_ids))
    jsvc._topk_algo.push = tsvc._topk_algo.push = "none"
    jhits, thits = jsvc.top_k(SOURCES, k=10), tsvc.top_k(SOURCES, k=10)
    for jrow, trow in zip(jhits, thits):
        assert sorted(h.node for h in trow) == sorted(h.node for h in jrow)
        jscore = {h.node: h.score for h in jrow}
        for h in trow:
            assert abs(h.score - jscore[h.node]) <= 1e-5


@pytest.mark.parametrize("graph", ["skewed", "synth"])
@pytest.mark.parametrize("caller", ["service", "fora"])
def test_auto_still_builds_the_rules_split(skewed, synth, graph, caller):
    """Where nodes pass the threshold, ``"auto"`` through either caller is
    ``build_hub_split(g, auto_num_hubs(g))``, bit for bit."""
    tg = skewed[1] if graph == "skewed" else synth[1].graph
    ds = Dataset(graph=tg, names=[str(i) for i in range(tg.n)], name=graph)
    if caller == "service":
        hs = PPRService.from_dataset(ds, alpha=0.15, eps=0.5, k=10,
                                     hub_split="auto")._topk_algo.hub_split
        dtype = torch.bfloat16
    else:
        algo = ForaTopk(ds, 0.15, 10)
        algo.enable_hub_split()
        hs, dtype = algo.hub_split, torch.float32
    assert ths.over_threshold(tg, dtype)[1] > 0
    want = ths.build_hub_split(tg, ths.auto_num_hubs(tg, dtype), dtype)
    assert (hs.num_hubs, hs.m_tail, hs.dtype) == \
        (want.num_hubs, want.m_tail, want.dtype)
    for field in ("hub_ids", "hub_matrix", "tail_src", "tail_dst",
                  "tail_ptr"):
        assert torch.equal(getattr(hs, field), getattr(want, field))


@pytest.mark.parametrize("graph", ["skewed", "synth"])
@pytest.mark.parametrize("over", [0, 1])
def test_no_split_only_where_no_node_passes(skewed, synth, monkeypatch,
                                            graph, over):
    """Prices that put the threshold half an in-link above the largest
    in-degree (no node over it) or below it (the largest only): the rule
    (the JAX package's too) gives its floor of 128 either way, and
    ``resolve_hub_split`` makes no split in the first case and the floor's
    split in the second."""
    jg, tg = skewed if graph == "skewed" else (synth[0].graph,
                                                synth[1].graph)
    top = float(tg.in_deg.max())
    col_ns = tg.n_pad * 2 / ths.HUB_COLUMN_GBPS
    prices = dict(tail_ns_per_edge=col_ns / (top + (0.5 if over == 0
                                                    else -0.5)),
                  hbm_gbps=ths.HUB_COLUMN_GBPS)
    monkeypatch.setattr(ths, "TAIL_NS_PER_EDGE", prices["tail_ns_per_edge"])
    _, h = ths.over_threshold(tg, torch.bfloat16, **prices)
    assert h == int((tg.in_deg[: tg.n] == top).sum()) * over
    assert 0 < h < 128 or h == over == 0
    assert ths.auto_num_hubs(tg, torch.bfloat16) == 128
    assert jhs.auto_num_hubs(jg, jnp.bfloat16, **prices) == 128
    hs = ths.resolve_hub_split(tg, "auto", torch.bfloat16)
    if over:
        assert hs.num_hubs == 128
        assert torch.equal(hs.hub_ids, ths.build_hub_split(
            tg, 128, torch.bfloat16).hub_ids)
    else:
        assert hs is None
        assert ths.resolve_hub_split(tg, 128, torch.bfloat16).num_hubs == 128


def test_a_weighted_graph_still_refuses_auto():
    """No split is never the answer for a weighted graph: ``"auto"`` still
    raises there, under any prices, as the JAX package's split does."""
    g = build_graph(np.array([0, 1, 2]), np.array([1, 2, 0]), 3,
                    weights=np.array([1.0, 2.0, 3.0]), device="cpu")
    with pytest.raises(NotImplementedError):
        ths.resolve_hub_split(g, "auto")
