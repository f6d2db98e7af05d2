"""The six small helpers of the port against the JAX package's on the same
inputs: ``ops/topk.py``'s ``kth_value``, ``device_top_k`` and ``kth_ppr``,
``graph/csr.py``'s ``graph_from_scipy`` and ``summarize``, and
``utils/store.py``'s ``PPRStore.write_batch``.

Every value is exact: the k-th values, the selected values and id sets,
``kth_ppr``'s float (``None`` on an invalid k), ``summarize``'s dict, the
CSR arrays, and the rows a ``write_batch`` shard reads back through both
packages' stores. (The JAX package's jitted ``kth_value`` raises for
every k, since ``k`` is traced; its body, run eagerly, is the
reference.)"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from ppr_tpu.graph import csr as jcsr
from ppr_tpu.ops import topk as jtopk
from ppr_tpu.utils.store import PPRStore as JaxStore
from ppr_tpu_torch.graph import csr as tcsr
from ppr_tpu_torch.ops import topk as ttopk
from ppr_tpu_torch.utils.store import PPRStore


def scores(seed, shape, ties=False):
    rng = np.random.default_rng(seed)
    x = rng.random(shape).astype(np.float32)
    if ties:
        x = np.round(x * 8) / 8          # many equal values
    x[x < 0.2] = 0.0
    return x


@pytest.mark.parametrize("shape,k,ties", [
    ((37,), 1, False), ((37,), 5, True), ((6, 130), 10, False),
    ((6, 130), 40, True), ((3, 4, 50), 7, False)])
def test_kth_value_and_device_top_k(shape, k, ties):
    x = scores(len(shape) * 10 + k, shape, ties)
    # JAX's kth_value is jitted with k traced, and lax.top_k needs a static
    # k: it raises for every k. Its body, run eagerly, is the reference.
    with pytest.raises(Exception, match="traced"):
        jtopk.kth_value(jnp.asarray(x), k)
    want = np.asarray(jtopk.kth_value.__wrapped__(jnp.asarray(x), k))
    got = ttopk.kth_value(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got.numpy(), want)
    jv, ji = jtopk.device_top_k(jnp.asarray(x), k)
    tv, ti = ttopk.device_top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    # equal values may come in another order: the ids hold those values
    np.testing.assert_array_equal(
        np.take_along_axis(x, ti.numpy(), axis=-1), np.asarray(jv))
    if not ties:
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("values,k", [
    ([0.1, 0.2], 3), ([0.1, 0.2], 0), ([0.1, 0.2], -1), ([], 1),
    ([0.3, 0.1, 0.2], 2), ([0.3, 0.1, 0.2], 3), ([0.5, 0.5, 0.1], 1),
    (list(scores(5, (200,))), 17)])
def test_kth_ppr(values, k):
    want = jtopk.kth_ppr(np.asarray(values, np.float32), k)
    got = ttopk.kth_ppr(np.asarray(values, np.float32), k)
    assert got == want
    if k <= 0 or k > len(values):
        assert got is None
    else:
        assert isinstance(got, float)


def scipy_graphs():
    rng = np.random.default_rng(4)
    n, m = 300, 2400
    rows, cols = rng.integers(0, n, m), rng.integers(0, n, m)
    yield "random", sp.csr_matrix((np.ones(m), (rows, cols)), shape=(n, n))
    yield "coo with a dangling tail", sp.coo_matrix(
        (np.ones(5), ([0, 0, 1, 2, 3], [1, 2, 2, 0, 0])), shape=(9, 9))
    yield "lil", sp.lil_matrix(np.eye(7, k=1))


@pytest.mark.parametrize("name,mat", list(scipy_graphs()))
@pytest.mark.parametrize("dense_threshold", [0, 4096])
def test_graph_from_scipy_and_summarize(name, mat, dense_threshold):
    jg = jcsr.graph_from_scipy(mat, dense_threshold=dense_threshold)
    tg = tcsr.graph_from_scipy(mat, dense_threshold=dense_threshold,
                               device="cpu")
    assert tg.device.type == "cpu"
    for f in dataclasses.fields(jg):
        want = getattr(jg, f.name)
        got = getattr(tg, f.name)
        if want is None or isinstance(want, (int, bool)):
            assert got == want, f.name
        else:
            np.testing.assert_array_equal(got.cpu().numpy(),
                                          np.asarray(want), err_msg=f.name)
    assert tcsr.summarize(tg) == jcsr.summarize(jg)


def test_graph_from_scipy_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcsr.graph_from_scipy(sp.eye(4, format="csr"))


def test_summarize_tiny(tiny):
    tg = tcsr.graph_from_numpy(
        {f.name: getattr(tiny, f.name) for f in dataclasses.fields(tiny)},
        device="cpu")
    s = tcsr.summarize(tg)
    assert s == jcsr.summarize(tiny)
    assert s["dangling"] == 1 and s["n"] == 6 and s["dense"]


@pytest.mark.parametrize("n,batches", [(16, 1), (40, 3)])
def test_write_batch_reads_back_in_both_stores(tmp_path, n, batches):
    """A port store written by ``write_batch``: the same shard files as the
    JAX store's ``write_batch`` would write, read back row for row by
    both packages' stores."""
    mine, ref = tmp_path / "port", tmp_path / "jax"
    store, jstore = PPRStore(str(mine), n=n), JaxStore(str(ref), n=n)
    store.reset()
    jstore.reset()
    all_rows = {}
    for b in range(batches):
        sources = np.arange(b * 4, b * 4 + 4)
        rows = scores(b, (4, n))
        rows[1] = 0.0                      # an empty row
        store.write_batch(int(sources[0]), sources, rows)
        jstore.write_batch(int(sources[0]), sources, rows)
        all_rows.update(zip(sources.tolist(), rows))
    store.finalize()
    jstore.finalize()
    for shard in sorted(p.name for p in mine.iterdir()
                        if p.name.startswith("batch_")):
        with np.load(mine / shard) as a, np.load(ref / shard) as b:
            for key in ("sources", "indptr", "ids", "vals"):
                np.testing.assert_array_equal(a[key], b[key])
                assert a[key].dtype == b[key].dtype
    for reader in (PPRStore(str(mine), n=n), JaxStore(str(mine), n=n)):
        for s, row in all_rows.items():
            np.testing.assert_array_equal(reader.read_row(s), row)
