"""The port's cohort path and early-exit certificate against the JAX
package's (``ppr_tpu/models/fora.py:321-533, 870-980``).

Both engines run ``push="none"`` on the same graphs and sources: the seeded
power-law graphs and the 6-node ``tiny`` graph (not ``got``). Per stage of
the cohort ladder the port must run at the same width for the same number
of sweeps and retire the same rows; per row it must return the same
tie-expanded top-k id set, with values within 1e-6 relative (f32) or 1e-5
absolute (bf16 hubs, whose product adds in another order, as in
``test_torch_service.py``). ``torch.topk`` and ``lax.top_k`` order ties
differently, so id sets are compared, not orders."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import Dataset as JaxDataset
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.models import fora as jfora
from ppr_tpu.ops.push import forward_push_init as jax_init
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import fora as tfora
from ppr_tpu_torch.ops.push import forward_push_init as port_init
from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs

ALPHA = 0.15


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.fixture(scope="module")
def datasets(tiny):
    out = {}
    for kind, jds in (
        ("pl2048", synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0)),
        ("pl300", synthetic_powerlaw(300, 3, seed=3, dense_threshold=0)),
        ("tiny", JaxDataset(graph=tiny, names=[str(i) for i in range(6)],
                            name="tiny")),
    ):
        out[kind] = (jds, port_dataset(jds))
    return out


def sources_of(ds, b, seed=5):
    return np.random.default_rng(seed).integers(0, ds.graph.n, b)


def engines(jds, tds, k, early_exit, hubs):
    jalgo = jfora.ForaTopk(jds, ALPHA, k, seed=7, push="none",
                           early_exit=early_exit)
    talgo = tfora.ForaTopk(tds, ALPHA, k, seed=7, push="none",
                           early_exit=early_exit)
    if hubs:
        jalgo.enable_hub_split(hubs, dtype=jnp.bfloat16)
        talgo.enable_hub_split(hubs, dtype=torch.bfloat16)
    return jalgo, talgo


def run_cohorts(module, monkeypatch, algo, sources, k, eps):
    """``(stages, cohorts, rows)``: (width, iters) per stage, the sorted
    row indices each cohort retired, and ``{row: (vals, ids)}``."""
    stages = []
    inner = module.annealed_topk_propagate_perrow

    def spy(g, p, *args, **kwargs):
        out = inner(g, p, *args, **kwargs)
        stages.append((int(p.shape[0]), int(out[4])))
        return out

    monkeypatch.setattr(module, "annealed_topk_propagate_perrow", spy)
    cohorts, rows = [], {}
    for idxs, vals, ids in algo.compute_topk_ids_cohorts(sources, k, eps):
        cohorts.append(sorted(int(i) for i in idxs))
        for i, v, nid in zip(idxs, np.asarray(vals), np.asarray(ids)):
            assert int(i) not in rows, "row emitted twice"
            rows[int(i)] = (v, nid)
    monkeypatch.undo()
    return stages, cohorts, rows


def assert_rows_match(trows, jrows, k, hubs):
    assert sorted(trows) == sorted(jrows)
    for i, (tv, ti) in trows.items():
        jv, ji = jrows[i]
        assert tv.shape == jv.shape
        if hubs:
            np.testing.assert_allclose(tv, jv, atol=1e-5)
        else:
            np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-9)
        assert set(topk_ids_with_ties_from_pairs(tv, ti, k)) == \
            set(topk_ids_with_ties_from_pairs(jv, np.asarray(ji), k)), i


# (graph, k, eps, B, early_exit, hubs): one to three stages each
CASES = [("pl2048", 10, 0.5, 24, False, None),
         ("pl2048", 3, 0.1, 24, True, None),
         ("pl2048", 2, 0.1, 24, False, None),
         ("pl2048", 10, 0.5, 24, False, 128),
         ("pl300", 3, 0.1, 24, True, None),
         ("pl300", 10, 0.5, 64, False, None),
         ("tiny", 2, 0.5, 24, True, None)]


@pytest.mark.parametrize("kind,k,eps,b,early_exit,hubs", CASES)
def test_cohort_stages_match_jax(datasets, monkeypatch, kind, k, eps, b,
                                 early_exit, hubs):
    jds, tds = datasets[kind]
    sources = sources_of(jds, b)
    jalgo, talgo = engines(jds, tds, k, early_exit, hubs)
    jstages, jcohorts, jrows = run_cohorts(jfora, monkeypatch, jalgo,
                                           sources, k, eps)
    tstages, tcohorts, trows = run_cohorts(tfora, monkeypatch, talgo,
                                           sources, k, eps)
    assert tstages == jstages
    assert tcohorts == jcohorts
    assert talgo.last_iters == sum(it for _, it in jstages)
    assert_rows_match(trows, jrows, k, hubs)


def test_cohort_ladder_splits(datasets, monkeypatch):
    """The parity cases above do cover multi-stage ladders."""
    jds, tds = datasets["pl2048"]
    _, talgo = engines(jds, tds, 3, True, None)
    stages, cohorts, _ = run_cohorts(tfora, monkeypatch, talgo,
                                     sources_of(jds, 24), 3, 0.1)
    assert len(stages) >= 3 and len(cohorts) >= 3
    assert [w for w, _ in stages] == sorted({w for w, _ in stages},
                                            reverse=True)


def test_cohort_disjoint_cover_and_cotenant_independence(datasets,
                                                         monkeypatch):
    """Every row is emitted exactly once; a row's ids equal a cohort run of
    its source alone (per-row annealing, frozen rows), and its values do
    within 1e-6 relative: a column's sums can round differently at another
    batch width."""
    _, tds = datasets["pl2048"]
    sources = sources_of(tds, 24)
    algo = tfora.ForaTopk(tds, ALPHA, 3, push="none")
    stages, cohorts, rows = run_cohorts(tfora, monkeypatch, algo, sources, 3,
                                        0.1)
    assert len(cohorts) > 1
    flat = [i for c in cohorts for i in c]
    assert sorted(flat) == list(range(len(sources)))
    for i, s in enumerate(sources):
        _, _, solo = run_cohorts(tfora, monkeypatch, algo, np.array([s]), 3,
                                 0.1)
        np.testing.assert_array_equal(rows[i][1], solo[0][1])
        np.testing.assert_allclose(rows[i][0], solo[0][0], rtol=1e-6)


@pytest.mark.parametrize("budget", [20, 44])
def test_cohort_budget_exhaustion_matches_jax(datasets, monkeypatch, capsys,
                                              budget):
    """With a small sweep budget in both packages the ladder gives up on
    the same sweep, emits every row left, and says so on stderr."""
    jds, tds = datasets["pl2048"]
    sources = sources_of(jds, 24)
    jalgo, talgo = engines(jds, tds, 10, False, None)
    out = []
    for module, algo in ((jfora, jalgo), (tfora, talgo)):
        monkeypatch.setattr(module, "MAX_TOPK_SWEEPS", budget)
        out.append(run_cohorts(module, monkeypatch, algo, sources, 10, 0.5))
    (jstages, jcohorts, jrows), (tstages, tcohorts, trows) = out
    assert tstages == jstages
    assert sum(it for _, it in tstages) == budget
    assert tcohorts == jcohorts
    assert sorted(i for c in tcohorts for i in c) == list(range(24))
    assert_rows_match(trows, jrows, 10, None)
    err = capsys.readouterr().err
    assert f"ppr_tpu_torch.fora: cohort sweep budget {budget} exhausted" \
        in err


@pytest.mark.parametrize("kind,k,eps,hubs,fires", [
    ("pl2048", 1, 0.5, None, True), ("pl2048", 1, 0.1, None, True),
    ("pl2048", 1, 0.5, 128, True), ("tiny", 2, 0.5, None, False)])
def test_batch_early_exit_matches_jax(datasets, kind, k, eps, hubs, fires):
    """The certificate stops the batch loop on JAX's sweep, with JAX's
    reserves and ids; where it ``fires`` that is before the plain loop
    stops (on ``tiny`` some row is never certified in time)."""
    jds, tds = datasets[kind]
    jg, tg = jds.graph, tds.graph
    sources, _ = tfora._pad_sources(sources_of(jds, 24))
    jalgo, talgo = engines(jds, tds, k, True, hubs)
    e = eps * 0.5
    p, r, oh = jax_init(jg, jnp.asarray(sources, jnp.int32))
    jp, jr, jiters = jfora.annealed_topk_propagate(
        jg, jnp.zeros_like(p), r, oh, jnp.float32(e), 1.0 / k, 1.0 / jg.n,
        k, ALPHA, hs=jalgo.hub_split, early_exit=True)
    p, r, oh = port_init(tg, torch.as_tensor(sources, dtype=torch.int32))
    tp, tr, titers = tfora.annealed_topk_propagate(
        tg, torch.zeros_like(p), r, oh, e, 1.0 / k, 1.0 / tg.n, k, ALPHA,
        hs=talgo.hub_split, early_exit=True)
    _, _, plain = tfora.annealed_topk_propagate(
        tg, torch.zeros_like(p), r, oh, e, 1.0 / k, 1.0 / tg.n, k, ALPHA,
        hs=talgo.hub_split)
    assert int(titers) == int(jiters)
    assert (int(titers) < int(plain)) == fires
    atol = 1e-5 if hubs else 1e-6
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=atol)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=atol)

    jv, ji = jalgo.compute_topk_ids_batch(sources, k, eps)
    tv, ti = talgo.compute_topk_ids_batch(sources, k, eps)
    assert talgo.last_iters == int(jiters)
    for row in range(len(sources)):
        assert set(topk_ids_with_ties_from_pairs(tv[row], ti[row], k)) == \
            set(topk_ids_with_ties_from_pairs(jv[row], ji[row], k))


def test_early_exit_keeps_the_plain_id_sets(datasets):
    """The certificate only stops a loop whose top-k sets are final."""
    _, tds = datasets["pl2048"]
    sources = sources_of(tds, 24)
    plain = tfora.ForaTopk(tds, ALPHA, 1, push="none")
    fast = tfora.ForaTopk(tds, ALPHA, 1, push="none", early_exit=True)
    pv, pi = plain.compute_topk_ids_batch(sources, 1, 0.5)
    fv, fi = fast.compute_topk_ids_batch(sources, 1, 0.5)
    assert fast.last_iters < plain.last_iters
    for row in range(len(sources)):
        assert set(topk_ids_with_ties_from_pairs(fv[row], fi[row], 1)) == \
            set(topk_ids_with_ties_from_pairs(pv[row], pi[row], 1))


def test_kcap_matches_jax(datasets):
    jds, tds = datasets["pl300"]
    sources = sources_of(jds, 10)
    jalgo, talgo = engines(jds, tds, 10, False, None)
    jv, ji = jalgo.compute_topk_ids_batch(sources, 10, 0.5, kcap=16)
    tv, ti = talgo.compute_topk_ids_batch(sources, 10, 0.5, kcap=16)
    assert tv.shape == jv.shape == (10, 16)
    np.testing.assert_allclose(tv, jv, atol=1e-6)


def test_pow2_width_matches_jax():
    for b in (1, 7, 8, 9, 12, 300, 1024, 1025):
        assert tfora._pow2_width(b) == jfora._pow2_width(b)


@pytest.mark.parametrize("kind", ["pl2048", "pl300", "tiny"])
def test_dangling_ids_are_a_graph_constant(datasets, kind):
    jds, tds = datasets[kind]
    jg = jds.graph
    want = np.nonzero((np.asarray(jg.out_deg) == 0)
                      & (np.asarray(jg.node_mask) > 0))[0]
    assert tds.graph.dang_ids.dtype == torch.int64
    np.testing.assert_array_equal(tds.graph.dang_ids.numpy(), want)
