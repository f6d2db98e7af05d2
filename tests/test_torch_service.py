"""``PPRService`` of the port against the JAX package's (both top-k
engines pinned to ``push="none"``, where the draws of the push+walk rounds
would differ): ``top_k`` with the same node ids and scores
within 1e-6 (1e-5 where the bf16 hub product adds in another order), the
``early_exit``, ``cohort`` (``top_k_stream``) and ``precomputed`` options,
and the same validation errors."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import load_default, synthetic_powerlaw
from ppr_tpu.models import AlgoType as JaxAlgoType
from ppr_tpu.models.base_allpair import BaseAllPair as JaxBase
from ppr_tpu.service import PPRService as JaxService
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import AlgoType
from ppr_tpu_torch.models.base_allpair import BaseAllPair
from ppr_tpu_torch.service import PPRService

SOURCES = [0, 3, 14, 50, 77, 101]


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.fixture(scope="module")
def datasets():
    got = load_default()
    synth = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0)
    small = synthetic_powerlaw(300, 3, seed=3, dense_threshold=0)
    return {"got": (got, port_dataset(got)),
            "synth": (synth, port_dataset(synth)),
            "small": (small, port_dataset(small))}


def assert_same_hits(jhits, thits, names, atol=1e-6):
    assert len(thits) == len(jhits)
    for jrow, trow in zip(jhits, thits):
        # torch.topk and lax.top_k order equal scores differently
        assert sorted(h.node for h in trow) == sorted(h.node for h in jrow)
        jscore = {h.node: h.score for h in jrow}
        for h in trow:
            assert h.name == names[h.node]
            assert abs(h.score - jscore[h.node]) <= atol


@pytest.mark.parametrize("kind,hubs,dtype,atol", [
    ("got", None, None, 1e-6),
    ("synth", None, None, 1e-6),
    ("synth", 128, "f32", 1e-6),
    ("synth", 128, "bf16", 1e-5),
])
def test_top_k_matches_jax(datasets, kind, hubs, dtype, atol):
    jds, tds = datasets[kind]
    jkw, tkw = {}, {}
    if hubs:
        jkw = dict(hub_split=hubs, hub_dtype=(jnp.float32 if dtype == "f32"
                                              else jnp.bfloat16))
        tkw = dict(hub_split=hubs, hub_dtype=(torch.float32 if dtype == "f32"
                                              else torch.bfloat16))
    jsvc = JaxService.from_dataset(jds, alpha=0.15, eps=0.5, k=10, seed=7,
                                   **jkw)
    jsvc._topk_algo.push = "none"
    tsvc = PPRService.from_dataset(tds, alpha=0.15, eps=0.5, k=10, seed=7,
                                   **tkw)
    tsvc._topk_algo.push = "none"
    assert_same_hits(jsvc.top_k(SOURCES, k=10), tsvc.top_k(SOURCES, k=10),
                     tds.names, atol)


def test_dense_fallback_on_tie_overflow(datasets):
    """A row whose tie set fills the selection window is recomputed from
    the dense scores, as in the JAX service."""
    _, tds = datasets["got"]
    svc = PPRService.from_dataset(tds, k=3)
    n_pad = tds.graph.n_pad
    vals = np.full((1, 4), 0.1, np.float32)        # window full of ties
    ids = np.arange(4)[None, :]
    hits = svc._hits_from_ids(vals, ids, 3, np.array([5]), 0.5)
    dense = svc._topk_algo.compute_topk_batch(np.array([5]), 3, 0.5)[0]
    assert dense.shape == (n_pad,)
    assert [h.node for h in hits[0]] == [h.node for h in
                                         svc._hits_dense(dense, 3)]


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(calibrate=True),
])
def test_unported_options_raise(datasets, option):
    """A mesh still raises; ``calibrate``, which raised until FORA's cost
    model was ported, measures the constants and gives both algorithms
    the same ones."""
    _, tds = datasets["got"]
    if "mesh" in option:
        with pytest.raises(NotImplementedError, match="not ported"):
            PPRService(tds, **option)
        return
    svc = PPRService(tds, **option)
    consts = [(a.avg_rand_walk_time_ns, a.spmv_ns_per_edge,
               a.spmv_batch_amortized, a.d2h_bytes_per_s)
              for a in (svc._topk_algo, svc._wg_algo)]
    assert consts[0] == consts[1]
    assert consts[0][2] is True and all(c > 0 for c in consts[0][:2])
    assert consts[0] != (400.0, 4.0, False, 4e9)   # measured, not defaults


def test_unported_options_name_their_item(datasets):
    _, tds = datasets["small"]
    with pytest.raises(NotImplementedError, match="item 18"):
        PPRService(tds, mesh=object(), mesh_engine="node")
    # calibrate (item 11) is ported: the service answers with either
    # constants
    assert PPRService(tds, calibrate=True, k=3).top_k([1, 2])


def test_whole_graph_not_ported(datasets):
    """``whole_graph`` runs FORA whole-graph (it raised until item 11 was
    ported): the JAX service's rows within its accuracy on this graph,
    both packages' completion pinned to propagation."""
    jds, tds = datasets["got"]
    jsvc, tsvc = JaxService(jds), PPRService(tds)
    for svc in (jsvc, tsvc):
        svc._wg_algo.completion = "spmv"
    assert type(tsvc._wg_algo).__name__ == "ForaWholeGraph"
    got = tsvc.whole_graph([1, 5, 50])
    want = np.asarray(jsvc.whole_graph([1, 5, 50]))
    assert got.shape == (3, tds.n)
    # the residue left is at most eps * delta
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=0.5 / tds.n)
    # the push rounds follow the wall clock in both packages, so the rows
    # agree to FORA's bound, eps * delta a node, not to the bit
    assert np.abs(got - want).max() <= 0.5 / tds.n


def test_hub_split_is_shared_by_both_algorithms(datasets):
    _, tds = datasets["synth"]
    svc = PPRService(tds, hub_split=64)
    assert svc._topk_algo.hub_split is svc._wg_algo.hub_split is not None


@pytest.mark.parametrize("kwargs", [
    dict(frontier_blocks=4),
    dict(frontier_blocks=4, mesh_engine="node"),
    dict(precomputed=(0.1, -1), hub_split=16),
    dict(precomputed=(0.1, -1), cohort=True),
    dict(precomputed=(0.1, -1), calibrate=True),
    dict(precomputed=(0.1, -1), frontier_blocks=2),
    dict(early_exit=True, algorithm="POWER_METHOD"),
    dict(cohort=True, algorithm="POWER_METHOD"),
], ids=["blocks", "blocks-node", "pre-hubs", "pre-cohort", "pre-calibrate",
        "pre-blocks", "early-exit-power", "cohort-power"])
def test_validation_errors_match_jax(datasets, kwargs):
    """The conflicts both packages refuse with ``ValueError``, before any
    store is read or engine built."""
    jds, tds = datasets["small"]
    kw = dict(kwargs)
    algo = kw.pop("algorithm", None)
    jkw, tkw = dict(kw), dict(kw)
    if algo:
        jkw["algorithm"] = JaxAlgoType[algo]
        tkw["algorithm"] = AlgoType[algo]
    with pytest.raises(ValueError) as jerr:
        JaxService(jds, **jkw)
    with pytest.raises(ValueError) as terr:
        PPRService(tds, **tkw)
    assert str(terr.value) == str(jerr.value)


def test_n_nodes_and_stream_support(datasets):
    jds, tds = datasets["small"]
    svc = PPRService(tds)
    assert svc.n_nodes == JaxService(jds).n_nodes == 300
    assert not svc.supports_stream
    with pytest.raises(RuntimeError, match="cohort=True"):
        svc.top_k_stream([3], emit=lambda *a: None)
    assert PPRService(tds, cohort=True).supports_stream


@pytest.mark.parametrize("kind,hubs", [("small", None), ("synth", None),
                                       ("synth", 128)])
def test_early_exit_service_matches_jax(datasets, kind, hubs):
    jds, tds = datasets[kind]
    jkw = dict(hub_split=hubs, hub_dtype=jnp.bfloat16) if hubs else {}
    tkw = dict(hub_split=hubs, hub_dtype=torch.bfloat16) if hubs else {}
    jsvc = JaxService(jds, k=3, seed=7, early_exit=True, **jkw)
    jsvc._topk_algo.push = "none"
    tsvc = PPRService(tds, k=3, seed=7, early_exit=True, **tkw)
    tsvc._topk_algo.push = "none"
    assert tsvc._topk_algo.early_exit
    sources = np.random.default_rng(4).integers(0, tds.n, 24)
    assert_same_hits(jsvc.top_k(sources), tsvc.top_k(sources), tds.names,
                     1e-5 if hubs else 1e-6)


def stream(svc, sources):
    """``top_k_stream``'s rows by input position, and its cohorts."""
    rows, cohorts = [None] * len(sources), []

    def emit(idxs, hits_rows):
        cohorts.append(sorted(int(i) for i in idxs))
        for i, row in zip(idxs, hits_rows):
            assert rows[int(i)] is None
            rows[int(i)] = row

    svc.top_k_stream(sources, emit=emit)
    assert all(r is not None for r in rows)
    return rows, cohorts


@pytest.mark.parametrize("early_exit", [False, True])
def test_top_k_stream_matches_jax(datasets, early_exit):
    jds, tds = datasets["synth"]
    jsvc = JaxService(jds, k=3, eps=0.1, cohort=True, early_exit=early_exit)
    jsvc._topk_algo.push = "none"
    tsvc = PPRService(tds, k=3, eps=0.1, cohort=True, early_exit=early_exit)
    tsvc._topk_algo.push = "none"
    sources = np.random.default_rng(5).integers(0, tds.n, 24)
    jrows, jcohorts = stream(jsvc, sources)
    trows, tcohorts = stream(tsvc, sources)
    assert tcohorts == jcohorts and len(tcohorts) > 1
    assert_same_hits(jrows, trows, tds.names)


def test_top_k_stream_rows_match_top_k_ids(datasets):
    """Without early exit a streamed row holds the batch path's ids (the
    per-row schedule reaches the same final sets on this graph)."""
    _, tds = datasets["synth"]
    svc = PPRService(tds, k=10, cohort=True)
    sources = np.random.default_rng(6).integers(0, tds.n, 12)
    rows, _ = stream(svc, sources)
    want = svc.top_k(sources)
    for got_row, want_row in zip(rows, want):
        assert {h.node for h in got_row} == {h.node for h in want_row}


@pytest.mark.parametrize("threshold,k", [(1e-3, -1), (1e-3, 5)])
def test_precomputed_matches_jax(datasets, tmp_path, monkeypatch, threshold,
                                 k):
    """Each package builds its own BASE store of the same graph; a service
    over it answers top-k (and, for a whole-graph store, whole_graph) with
    the same rows as JAX's service over JAX's store."""
    jds, tds = datasets["small"]
    sources = np.array([0, 3, 17, 150, 299])
    out = {}
    for name, ds, base, service in (("jax", jds, JaxBase, JaxService),
                                    ("port", tds, BaseAllPair, PPRService)):
        work = tmp_path / name
        work.mkdir()
        monkeypatch.chdir(work)
        base(ds, 0.15).preprocessing(threshold, k, progress=False)
        svc = service(ds, k=10, precomputed=(threshold, k))
        assert svc._topk_algo is svc._wg_algo
        out[name] = (svc.top_k(sources),
                     svc.whole_graph(sources) if k < 0 else None,
                     svc._topk_algo)
    assert_same_hits(out["jax"][0], out["port"][0], tds.names)
    if k < 0:
        np.testing.assert_allclose(out["port"][1], out["jax"][1], atol=1e-6)
        assert out["port"][1].shape == (len(sources), tds.n)
    # every hit list is the store's row, read directly
    store = out["port"][2]._store
    for s, row in zip(sources, out["port"][0]):
        ids, vals = store.read_row_ordered(int(s))
        dense = np.zeros(tds.graph.n_pad, np.float32)
        dense[ids] = vals
        assert [h.score for h in row] == [float(dense[h.node]) for h in row]


def test_precomputed_without_store_raises(datasets, tmp_path, monkeypatch):
    _, tds = datasets["small"]
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="no finalized BASE store"):
        PPRService(tds, precomputed=0.5)
