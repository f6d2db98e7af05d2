"""The port's preprocessing storage against the JAX package's: device
threshold compaction (``ops/compact.threshold_nonzeros``), the npz store
format in both directions, and the Neo4j method's all-pair store rows.

Compaction selects exactly, so its outputs are equal, not close. Store
rows of the Neo4j method agree within 1e-6, the method's own tolerance
(tests/test_torch_neo4j.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import load_default, synthetic_powerlaw
from ppr_tpu.models.neo4j_method import Neo4jMethod as JaxNeo4j
from ppr_tpu.ops.compact import threshold_nonzeros as jax_compact
from ppr_tpu.utils.store import PPRStore as JaxStore
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models.neo4j_method import Neo4jMethod
from ppr_tpu_torch.ops.compact import threshold_nonzeros
from ppr_tpu_torch.utils.store import PPRStore

ALPHA = 0.15


def scores(t, n_pad, n, density, seed):
    """Seeded [t, n_pad] scores: a `density` share positive, the rest 0 or
    negative, padding columns positive (they must be masked out), and some
    entries exactly at 0.25 for the inclusive/exclusive edge."""
    rng = np.random.default_rng(seed)
    p = rng.random((t, n_pad), dtype=np.float32)
    p[rng.random((t, n_pad)) >= density] = 0.0
    p[rng.random((t, n_pad)) < 0.05] = -0.5
    p[rng.random((t, n_pad)) < 0.05] = 0.25
    p[:, n:] = 1.0
    mask = np.zeros(n_pad, np.float32)
    mask[:n] = 1.0
    return p, mask


# (density, threshold, rows, exclusive): the first four take the sparse
# branch, the last two the density guard's dense copy
CASES = [(0.02, 0.0, None, True), (0.05, 0.25, None, False),
         (0.05, 0.25, None, True), (0.1, 0.0, 5, True),
         (0.9, 0.0, None, True), (0.95, 0.1, 8, False)]


@pytest.mark.parametrize("density,threshold,rows,exclusive", CASES)
def test_threshold_nonzeros_matches_jax(density, threshold, rows, exclusive):
    t, n_pad, n = 9, 256, 250
    p, mask = scores(t, n_pad, n, density, seed=int(density * 100) + t)
    ref = jax_compact(jnp.asarray(p), jnp.asarray(mask), threshold,
                      rows=rows, exclusive=exclusive)
    out = threshold_nonzeros(torch.from_numpy(p), torch.from_numpy(mask),
                             threshold, rows=rows, exclusive=exclusive)
    for a, b, dtype in zip(out, ref, (np.int64, np.int64, np.float32)):
        assert a.dtype == dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    assert out[0].size > 0 and (np.diff(out[0] * n_pad + out[1]) > 0).all()
    if rows is not None:
        assert out[0].max() < rows
    dense_branch = out[0].size * 8 >= t * n_pad * 4
    assert dense_branch == (density > 0.5)


def test_threshold_nonzeros_empty():
    p = torch.zeros((3, 128))
    rows, cols, vals = threshold_nonzeros(p, torch.ones(128), 0.0,
                                          exclusive=True)
    assert rows.size == cols.size == vals.size == 0


def write_rows(store, rng, n, starts):
    """Shards of seeded sparse rows, through both of the JAX store's write
    paths (the port has only the ordered one)."""
    rows = {}
    for start in starts:
        sources = np.arange(start, min(start + 4, n))
        dense = rng.random((len(sources), n), dtype=np.float32)
        dense[dense < 0.7] = 0.0
        if start % 8 and isinstance(store, JaxStore):
            store.write_batch(start, sources, dense)
        else:
            store.write_batch_ordered(
                start, sources,
                [np.nonzero(r)[0].astype(np.int32) for r in dense],
                [r[r > 0] for r in dense])
        rows.update(zip(sources.tolist(), dense))
    store.finalize(alpha=ALPHA)
    return rows


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_format_is_shared(tmp_path, writer):
    n = 30
    cls_w, cls_r = (PPRStore, JaxStore) if writer == "port" else \
        (JaxStore, PPRStore)
    store = cls_w(str(tmp_path / "s"), n=n)
    store.reset()
    rows = write_rows(store, np.random.default_rng(5), n, range(0, n, 4))
    other = cls_r(str(tmp_path / "s"), n=n)
    assert other._read_manifest() == store._read_manifest()
    assert other.size_bytes() == store.size_bytes() > 0
    for s, want in rows.items():
        np.testing.assert_array_equal(other.read_row(s), want)
        ids, vals = other.read_row_ordered(s)
        assert ids.dtype == np.int32 and vals.dtype == np.float32
    with pytest.raises(KeyError):
        other.read_row(n + 1)


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_neo4j_preprocessing_matches_jax(tmp_path, monkeypatch, kind):
    jds = (load_default() if kind == "dense" else
           synthetic_powerlaw(300, 4, seed=2, dense_threshold=0))
    tds = port_dataset(jds)
    monkeypatch.chdir(tmp_path)
    talgo, jalgo = Neo4jMethod(tds, ALPHA), JaxNeo4j(jds, ALPHA)
    assert talgo._prep_pending(40)
    talgo.preprocessing(-1.0, 40, batch_size=64, progress=False)
    # a finalized store is preprocessed again from scratch
    assert talgo._prep_pending(40, batch_size=64)
    port_root = talgo._store.root
    jalgo.make_store = lambda param: JaxStore(
        str(tmp_path / "jax" / str(param)), n=jds.graph.n_pad)
    jalgo.preprocessing(-1.0, 40, batch_size=64, progress=False)
    # the JAX package reads the port's store too
    cross = JaxStore(port_root, n=jds.graph.n_pad)
    for s in range(jds.n):
        talgo.read_preprocessed_ppr(s)
        got = talgo.get_whole_graph_dense()
        np.testing.assert_allclose(got, jalgo._store.read_row(s), atol=1e-6)
        np.testing.assert_array_equal(cross.read_row(s), got)
    assert talgo.get_prep_size() > 0
    # a fresh algorithm object answers from the persisted store
    fresh = Neo4jMethod(tds, ALPHA)
    fresh.read_preprocessed_ppr(7, param=40)
    np.testing.assert_array_equal(fresh.get_whole_graph_dense(),
                                  cross.read_row(7))
    talgo.delete_prep_dir()
    assert talgo.get_prep_size() == 0
