"""Parity of the port's push operators (dense, sorted segmented sum, the
coo scatter-add, the chunked pushes, hub split) with the JAX package's, on
the CPU.

Tolerances: f32 paths agree within float reassociation (atol 1e-6 on
operands in [0, 1); the batch-major chunked push also rtol 1e-6, as its
hub sums run to ~13); the hub split adds the hub rows in another order
(atol 1e-5). bf16 hubs: the port's CPU path rounds the operand through bf16
and multiplies in f32, as XLA does for JAX's bf16 dot with an f32 result."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import load_default, synthetic_powerlaw
from ppr_tpu.ops import hub_split as jhub
from ppr_tpu.ops import spmv as jspmv
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.ops import hub_split as thub
from ppr_tpu_torch.ops import spmv as tspmv


def port(jg):
    return graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")


@pytest.fixture(scope="module")
def graphs():
    dense = load_default().graph
    sparse = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0).graph
    return {"dense": (dense, port(dense)), "coo_sorted": (sparse, port(sparse))}


def operand(g, b, seed):
    rng = np.random.default_rng(seed)
    a = np.zeros((g.n_pad, b), np.float32)
    a[: g.n] = rng.random((g.n, b), dtype=np.float32)
    return a


def test_safe_inv_deg(graphs):
    jg, tg = graphs["coo_sorted"]
    np.testing.assert_array_equal(
        tspmv._safe_inv_deg(tg.out_deg).numpy(),
        np.asarray(jspmv._safe_inv_deg(jg.out_deg)))


@pytest.mark.parametrize("backend", ["dense", "coo_sorted"])
def test_push_out_t_matches_jax(graphs, backend):
    jg, tg = graphs[backend]
    a_t = operand(jg, 16, 1)
    ref = np.asarray(jspmv.push_out_t(jg, jnp.asarray(a_t)))
    out = tspmv.push_out_t(tg, torch.from_numpy(a_t))
    assert out.shape == (jg.n_pad, 16) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(5,), (3, 5)], ids=["1d", "2d"])
@pytest.mark.parametrize("backend", ["dense", "coo_sorted"])
def test_push_out_matches_jax(graphs, backend, shape):
    jg, tg = graphs[backend]
    rng = np.random.default_rng(2)
    a = np.zeros(shape[:-1] + (jg.n_pad,), np.float32)
    a[..., : jg.n] = rng.random(shape[:-1] + (jg.n,), dtype=np.float32)
    ref = np.asarray(jspmv.push_out(jg, jnp.asarray(a), backend=backend))
    out = tspmv.push_out(tg, torch.from_numpy(a), backend=backend)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("shape", [(5,), (3, 5)], ids=["1d", "2d"])
@pytest.mark.parametrize("kind", ["dense", "coo_sorted"])
def test_push_out_coo_matches_jax(graphs, kind, shape):
    """The ``coo`` backend (ROADMAP.md, queue 1, item 22): the JAX
    package's scatter-add, as ``index_add_``."""
    jg, tg = graphs[kind]
    rng = np.random.default_rng(7)
    a = np.zeros(shape[:-1] + (jg.n_pad,), np.float32)
    a[..., : jg.n] = rng.random(shape[:-1] + (jg.n,), dtype=np.float32)
    ref = np.asarray(jspmv.push_out(jg, jnp.asarray(a), backend="coo"))
    out = tspmv.push_out(tg, torch.from_numpy(a), backend="coo")
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    sorted_ = tspmv.push_out(tg, torch.from_numpy(a), backend="coo_sorted")
    np.testing.assert_allclose(out.numpy(), sorted_.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="unknown backend"):
        tspmv.push_out(tg, torch.from_numpy(a), backend="csr")


@pytest.mark.parametrize("shape", [(5,), (3, 5)], ids=["1d", "2d"])
@pytest.mark.parametrize("num_chunks", [1, 4])
def test_push_out_chunked_matches_jax(graphs, num_chunks, shape):
    jg, tg = graphs["coo_sorted"]
    rng = np.random.default_rng(8)
    a = np.zeros(shape[:-1] + (jg.n_pad,), np.float32)
    a[..., : jg.n] = rng.random(shape[:-1] + (jg.n,), dtype=np.float32)
    ref = np.asarray(jspmv.push_out_chunked(jg, jnp.asarray(a),
                                            num_chunks=num_chunks))
    out = tspmv.push_out_chunked(tg, torch.from_numpy(a),
                                 num_chunks=num_chunks)
    assert out.shape == a.shape
    # a hub's sum runs to ~13 over its chunks; the chunks add in another
    # order than XLA's, so the bar is relative there too
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(5,), (3, 5)], ids=["1d", "2d"])
def test_hybrid_batch_major_matches_jax(graphs, shape):
    jg, tg = graphs["coo_sorted"]
    rng = np.random.default_rng(9)
    a = np.zeros(shape[:-1] + (jg.n_pad,), np.float32)
    a[..., : jg.n] = rng.random(shape[:-1] + (jg.n,), dtype=np.float32)
    ref = np.asarray(jhub.push_out_hybrid(jg, jhub.build_hub_split(jg, 128),
                                          jnp.asarray(a)))
    out = thub.push_out_hybrid(tg, thub.build_hub_split(tg, 128),
                               torch.from_numpy(a))
    assert out.shape == a.shape
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_push_out_chunked_t_matches(graphs):
    jg, tg = graphs["coo_sorted"]
    a_t = operand(jg, 8, 3)
    ref = np.asarray(jspmv.push_out_chunked_t(jg, jnp.asarray(a_t),
                                              num_chunks=3))
    out = tspmv.push_out_chunked_t(tg, torch.from_numpy(a_t), num_chunks=3)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-6)
    one = tspmv.push_out_t(tg, torch.from_numpy(a_t))
    np.testing.assert_allclose(out.numpy(), one.numpy(), atol=1e-6)


def test_hub_split_structure_matches_jax(graphs):
    jg, tg = graphs["coo_sorted"]
    jhs = jhub.build_hub_split(jg, 128)
    ths = thub.build_hub_split(tg, 128)
    assert (ths.num_hubs, ths.m_tail) == (jhs.num_hubs, jhs.m_tail)
    for name in ("hub_ids", "hub_matrix", "tail_src", "tail_dst"):
        np.testing.assert_array_equal(getattr(ths, name).numpy(),
                                      np.asarray(getattr(jhs, name)), name)
    with pytest.raises(NotImplementedError):
        thub.build_hub_split(tg, "auto")


def test_hybrid_f32_matches_jax(graphs):
    jg, tg = graphs["coo_sorted"]
    a_t = operand(jg, 16, 4)
    ref = np.asarray(jhub.push_out_hybrid_t(
        jg, jhub.build_hub_split(jg, 128), jnp.asarray(a_t)))
    out = thub.push_out_hybrid_t(tg, thub.build_hub_split(tg, 128),
                                 torch.from_numpy(a_t))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def test_hybrid_bf16_matches_jax_bf16_and_f32(graphs):
    jg, tg = graphs["coo_sorted"]
    a_t = operand(jg, 16, 5)
    ref_bf16 = np.asarray(jhub.push_out_hybrid_t(
        jg, jhub.build_hub_split(jg, 128, dtype=jnp.bfloat16),
        jnp.asarray(a_t)))
    ths = thub.build_hub_split(tg, 128, dtype=torch.bfloat16)
    assert ths.dtype == torch.bfloat16
    out = thub.push_out_hybrid_t(tg, ths, torch.from_numpy(a_t))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_bf16, atol=1e-5)
    # and within tests/test_hub_split.py's bf16 tolerance of the f32 push
    ref_f32 = np.asarray(jspmv.push_out_t(jg, jnp.asarray(a_t)))
    np.testing.assert_allclose(out.numpy(), ref_f32, rtol=5e-3, atol=5e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_hybrid_chunked_equals_unchunked(graphs, dtype):
    _, tg = graphs["coo_sorted"]
    hs = thub.build_hub_split(tg, 128, dtype=dtype)
    a_t = torch.from_numpy(operand(tg, 8, 6))
    one = thub.push_out_hybrid_t(tg, hs, a_t)
    three = thub.push_out_hybrid_t(tg, hs, a_t, num_chunks=3)
    np.testing.assert_allclose(three.numpy(), one.numpy(), atol=1e-6)
