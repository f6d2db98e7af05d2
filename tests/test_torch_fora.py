"""The port's FORA top-k serving path against the JAX package's.

Both engines are pinned to ``push="none"``: on the CPU their cost
constants (``ppr_tpu/models/fora.py:61-73``) could choose walks under
"auto", whose draws differ between the packages. The
annealed loop must stop on the same sweep; reserves agree within float
reassociation (atol 1e-6), and the tie-expanded top-k id sets are equal
(``torch.topk`` and ``lax.top_k`` order ties differently)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import load_default, synthetic_powerlaw
from ppr_tpu.models import fora as jfora
from ppr_tpu.ops.hub_split import build_hub_split as jax_hubs
from ppr_tpu.ops.push import forward_push_init as jax_init
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import fora as tfora
from ppr_tpu_torch.ops.hub_split import build_hub_split as port_hubs
from ppr_tpu_torch.ops.push import forward_push_init as port_init
from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs

ALPHA, EPS, K = 0.15, 0.5, 10


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.fixture(scope="module")
def datasets():
    out = {}
    for kind, jds in (
        ("sparse", synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0)),
        ("dense", load_default()),
    ):
        out[kind] = (jds, port_dataset(jds))
    return out


def batch(g, b):
    s = np.random.default_rng(b).integers(0, g.n, b)
    s[1] = np.nonzero(np.asarray(g.out_deg)[: g.n] == 0)[0][0]  # dangling
    return s


CASES = [("sparse", None, 16), ("sparse", None, 3), ("sparse", 128, 16),
         ("sparse", 128, 3), ("dense", None, 16)]


@pytest.mark.parametrize("kind,hubs,b", CASES)
def test_annealed_loop_matches_jax(datasets, kind, hubs, b):
    jds, tds = datasets[kind]
    jg, tg = jds.graph, tds.graph
    sources, _ = tfora._pad_sources(batch(jg, b))
    eps = EPS * 0.5
    p, r, oh = jax_init(jg, jnp.asarray(sources, jnp.int32))
    jp, jr, jiters = jfora.annealed_topk_propagate(
        jg, jnp.zeros_like(p), r, oh, jnp.float32(eps), 1.0 / K, 1.0 / jg.n,
        K, ALPHA, hs=jax_hubs(jg, hubs) if hubs else None)
    p, r, oh = port_init(tg, torch.as_tensor(sources, dtype=torch.int32))
    tp, tr, titers = tfora.annealed_topk_propagate(
        tg, torch.zeros_like(p), r, oh, eps, 1.0 / K, 1.0 / tg.n, K, ALPHA,
        hs=port_hubs(tg, hubs) if hubs else None)
    assert int(titers) == int(jiters) > 0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-6)


@pytest.mark.parametrize("kind,hubs,b", CASES)
def test_topk_ids_match_jax(datasets, kind, hubs, b):
    jds, tds = datasets[kind]
    sources = batch(jds.graph, b)
    jalgo = jfora.ForaTopk(jds, ALPHA, K, seed=7, push="none")
    talgo = tfora.ForaTopk(tds, ALPHA, K, seed=7, push="none")
    if hubs:
        jalgo.enable_hub_split(hubs, dtype=jnp.float32)
        talgo.enable_hub_split(hubs, dtype=torch.float32)
    jv, ji = jalgo.compute_topk_ids_batch(sources, K, EPS)
    tv, ti = talgo.compute_topk_ids_batch(sources, K, EPS)
    assert tv.shape == jv.shape == (b, min(max(4 * K, K + 32),
                                               jds.graph.n_pad))
    assert talgo.last_iters > 0
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    for row in range(b):
        assert set(topk_ids_with_ties_from_pairs(tv[row], ti[row], K)) == \
            set(topk_ids_with_ties_from_pairs(jv[row], ji[row], K))
    # the dangling source short-circuits to e_s
    assert ti[1][0] == sources[1] and tv[1][0] == 1.0


def test_topk_batch_dense_matches_jax(datasets):
    jds, tds = datasets["sparse"]
    sources = batch(jds.graph, 5)
    ref = jfora.ForaTopk(jds, ALPHA, K, push="none").compute_topk_batch(
        sources, K, EPS)
    out = tfora.ForaTopk(tds, ALPHA, K, push="none").compute_topk_batch(
        sources, K, EPS)
    assert out.shape == (5, jds.graph.n_pad)
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_pad_sources():
    for sources in (np.array([5, 6, 7]), np.arange(9)):
        padded, b = tfora._pad_sources(sources)
        jpadded, jb = jfora._pad_sources(sources)
        assert b == jb == len(sources)
        assert padded.tolist() == jpadded.tolist()
        assert len(padded) == max(8, b) and not padded[b:].any()


def test_num_chunks_matches_jax(datasets):
    jds, tds = datasets["sparse"]
    jalgo = jfora.ForaTopk(jds, ALPHA, K, push="none")
    talgo = tfora.ForaTopk(tds, ALPHA, K, push="none")
    for budget in (1 << 14, 1 << 20, 2 << 30):
        jalgo.spmv_intermediate_budget = talgo.spmv_intermediate_budget = \
            budget
        assert talgo._num_chunks(16) == jalgo._num_chunks(16)


def test_unported_push_modes_raise(datasets):
    """The push modes that raised until the push+walk rounds were ported
    are taken, "auto" is the default as in the JAX package, and an unknown
    mode raises."""
    jds, tds = datasets["dense"]
    assert tfora.ForaTopk(tds, ALPHA, K).push == \
        jfora.ForaTopk(jds, ALPHA, K).push == "auto"
    for push in ("auto", "reference", "none"):
        assert tfora.ForaTopk(tds, ALPHA, K, push=push).push == push
    with pytest.raises(ValueError, match="push mode"):
        tfora.ForaTopk(tds, ALPHA, K, push="fast")
