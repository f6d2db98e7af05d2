"""The port's Forward Push and BASE against the JAX package's.

Both packages run on the same graph (carried across with
``graph_from_numpy``) and the same sources or thresholds. Tolerances:
reserves and residue sums within 1e-6 (f32 sums in another order over the
same sweeps); BASE store rows must hold the same ids in the same file order
and values within 1e-6 (the kept set ``pi >= threshold`` is the same unless
a value sits within rounding of the threshold, which these cases avoid by
the assertion itself); store bytes within 1% (the npz shards are
compressed, and low-bit rounding moves their size)."""

import dataclasses

import numpy as np
import pytest

from ppr_tpu.graph.io import load_default, synthetic_powerlaw
from ppr_tpu.models import base_allpair as jbase
from ppr_tpu.models import forward_push as jfwp
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import base_allpair as tbase
from ppr_tpu_torch.models import forward_push as tfwp
from ppr_tpu_torch.models.config import AlgoConf, AlgoType

ALPHA = 0.15


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
        ("sparse", synthetic_powerlaw(300, 4, seed=2, dense_threshold=0)),
    )}


def sources_for(jg, b):
    s = np.random.default_rng(b).integers(0, jg.n, b)
    s[0] = np.nonzero(np.asarray(jg.out_deg)[: jg.n] == 0)[0][0]  # dangling
    return s


@pytest.mark.parametrize("rmax", [1e-4, 1e-7])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_forward_push_rows_match_jax(datasets, kind, rmax):
    jds, tds = datasets[kind]
    sources = sources_for(jds.graph, 11)
    jalgo = jfwp.ForwardPush(jds, ALPHA)
    talgo = tfwp.ForwardPush(tds, ALPHA)
    ref = jalgo.compute_whole_graph_batch(sources, rmax)
    out = talgo.compute_whole_graph_batch(sources, rmax)
    assert isinstance(out, np.ndarray) and out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-6)
    np.testing.assert_allclose(talgo.residue_sum(), jalgo.residue_sum(),
                               atol=1e-6)
    assert talgo.last_sweeps > 0
    assert out[0, sources[0]] == 1.0 and talgo.residue_sum()[0] == 0.0
    # the top-k adapter is the whole-graph row thresholded with ties
    talgo.compute_topk_ppr(int(sources[3]), 10, rmax)
    jalgo.compute_topk_ppr(int(sources[3]), 10, rmax)
    assert set(talgo.get_topk_node_ids(10).tolist()) == \
        set(jalgo.get_topk_node_ids(10).tolist())


def test_forward_push_store_reads_back(datasets, tmp_path, monkeypatch):
    """A preprocessing store row equals a direct row (1e-6), as
    tests/test_algorithms.py holds the JAX package."""
    monkeypatch.chdir(tmp_path)
    _, tds = datasets["sparse"]
    fp = AlgoConf(ALPHA).new_algo_obj(AlgoType.FWDPUSH, tds)
    assert isinstance(fp, tfwp.ForwardPush)
    assert fp.prep_dirname == "FWP_ppr_results"
    fp.preprocessing(-1.0, 1e-5, progress=False)
    direct = fp.compute_whole_graph_batch(np.asarray([17, 0]), 1e-5)
    for i, s in enumerate((17, 0)):
        fp.read_preprocessed_ppr(s)
        np.testing.assert_allclose(fp.get_whole_graph_dense(), direct[i],
                                   atol=1e-6)
    assert fp.get_prep_size() > 0
    fp.delete_prep_dir()


def base_rows(algo, n):
    return [algo._store.read_row_ordered(s) for s in range(n)]


@pytest.mark.parametrize("k", [-1, 10])
@pytest.mark.parametrize("threshold", [1e-3, 5e-6])
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_base_store_rows_match_jax(datasets, tmp_path, monkeypatch, kind,
                                   threshold, k):
    jds, tds = datasets[kind]
    rows = {}
    for pkg, mod, ds in (("jax", jbase, jds), ("port", tbase, tds)):
        work = tmp_path / pkg
        work.mkdir()
        monkeypatch.chdir(work)
        # a small target batch, so the sweep runs several device batches
        algo = mod.BaseAllPair(ds, ALPHA, target_batch=64)
        algo.warm_preprocessing(threshold, k)
        algo.preprocessing(threshold, k, progress=False)
        rows[pkg] = (algo, base_rows(algo, ds.n))
    (talgo, trows), (jalgo, jrows) = rows["port"], rows["jax"]
    assert talgo.prep_dirname == jalgo.prep_dirname == "BASE_ppr_results"
    assert sum(len(ids) for ids, _ in trows) > jds.n
    for (tids, tvals), (jids, jvals) in zip(trows, jrows):
        np.testing.assert_array_equal(tids, jids)    # same file order
        np.testing.assert_allclose(tvals, jvals, atol=1e-6)
        if k < 0:
            assert (np.diff(tids) > 0).all()          # target-ascending
            assert (tvals >= np.float32(threshold)).all()
        else:
            assert (np.diff(tvals) <= 0).all()        # descending
    # queries are store reads, with file order kept for the top-k ids
    sources = sources_for(jds.graph, 7)
    np.testing.assert_allclose(
        talgo.compute_topk_batch(sources, k, -1),
        jalgo.compute_topk_batch(sources, k, -1), atol=1e-6)
    talgo.compute_topk_ppr(int(sources[2]), k)
    jalgo.compute_topk_ppr(int(sources[2]), k)
    np.testing.assert_array_equal(talgo.get_topk_node_ids(k),
                                  jalgo.get_topk_node_ids(k))
    assert abs(talgo.get_prep_size() - jalgo.get_prep_size()) \
        <= 0.01 * jalgo.get_prep_size()


def test_base_attach_store(datasets, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, tds = datasets["dense"]
    base = AlgoConf(ALPHA).new_algo_obj(AlgoType.BASE_WHOLE_GRAPH, tds)
    assert isinstance(base, tbase.BaseAllPair) and base.target_batch == 512
    with pytest.raises(RuntimeError, match="preprocessing"):
        base.compute_whole_graph_batch(np.array([1]))
    with pytest.raises(FileNotFoundError, match="no finalized BASE store"):
        base.attach_store(1e-4, -1)
    base.preprocessing(1e-4, -1, progress=False)
    want = base.compute_whole_graph_batch(np.array([3, 9]))
    fresh = tbase.BaseAllPair(tds, ALPHA)
    fresh.attach_store(1e-4, -1)
    np.testing.assert_array_equal(
        fresh.compute_whole_graph_batch(np.array([3, 9])), want)
    fresh.read_preprocessed_ppr(9)
    np.testing.assert_array_equal(fresh.get_whole_graph_dense(), want[1])
    with pytest.raises(ValueError, match="alpha"):
        tbase.BaseAllPair(tds, 0.2).attach_store(1e-4, -1)
    with pytest.raises(ValueError, match="alpha"):
        fresh.attach_store(1e-4, -1, alpha=0.3)
    assert fresh.get_prep_size() > 0
    fresh.delete_prep_dir()
    assert fresh.get_prep_size() == 0
