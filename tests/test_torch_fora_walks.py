"""The rest of FORA in the port (``ppr_tpu_torch/models/fora.py``: the
push rounds, residual completion, the walks, FORA whole-graph and the cost
model) against the JAX package's.

Exact: ``_completion_iters``, the cost model's ``_spmv_completion_ns`` and
``_use_spmv`` (the CPU constants are the JAX package's), the top-k path
choice, ``_kth_over_support`` and ``_whole_graph_walk_setup``. Within f32
reassociation (1e-6), with the same sweep or round count: ``residual_
propagate`` (dense and ``coo_sorted``; with a bf16 hub split the values
within 1e-5 and tie-tolerant top-k sets), ``ForaTopk(push="reference",
completion="spmv")`` and ``ForaWholeGraph(completion="spmv")`` with its
rounds pinned by cost constants so large that only ``max_push_rounds``
stops them. By distribution: the walk completions within the bounds of
``tests/test_algorithms.py:50-84`` (mean max-err < 0.03, precision@10 >
0.9, NDCG > 0.97), and the chunked walk phase's per-row mass (1e-5)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppr_tpu.graph.io import load_default as jax_default
from ppr_tpu.graph.io import synthetic_powerlaw as jax_powerlaw
from ppr_tpu.models import fora as jfora
from ppr_tpu.ops.hub_split import build_hub_split as jax_hubs
from ppr_tpu.ops.push import forward_push_init as jax_init
from ppr_tpu_torch import cli as tcli
from ppr_tpu_torch import harness as th
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import AlgoConf, AlgoType
from ppr_tpu_torch.models import fora as tfora
from ppr_tpu_torch.ops.hub_split import build_hub_split as port_hubs
from ppr_tpu_torch.ops.push import forward_push_init as port_init
from ppr_tpu_torch.ops.topk import topk_ids_with_ties
from ppr_tpu_torch.utils import calibrate
from ppr_tpu_torch.utils.metrics import max_abs_err, ndcg_at_k, precision_at_k

ALPHA, EPS, K = 0.15, 0.5, 10


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the walks are many small ops, which threads only
    slow down beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.fixture(scope="module")
def datasets():
    return {kind: (jds, port_dataset(jds)) for kind, jds in (
        ("sparse", jax_powerlaw(1024, 6, seed=3, dense_threshold=0)),
        ("dense", jax_default()),
    )}


@pytest.fixture(scope="module")
def oracle(datasets):
    _, tds = datasets["dense"]
    sources = np.arange(0, tds.n, 5)
    return sources, AlgoConf(ALPHA).set_conf_power_method(tds) \
        .compute_whole_graph_batch(sources)


def metrics(scores, sources, oracle_rows):
    precs, ndcgs = [], []
    for i in range(len(sources)):
        gnd = topk_ids_with_ties(oracle_rows[i], K)
        ids = topk_ids_with_ties(scores[i], K)
        precs.append(precision_at_k(ids, gnd))
        ndcgs.append(ndcg_at_k(ids, gnd, oracle_rows[i]))
    err = np.mean([max_abs_err(scores[i], oracle_rows[i])
                   for i in range(len(sources))])
    return err, np.mean(precs), np.mean(ndcgs)


@pytest.mark.parametrize("rsum", [0.0, 1e-9, 1e-3, 0.5, 1.0])
@pytest.mark.parametrize("target", [1e-7, 1e-3, 0.6])
@pytest.mark.parametrize("alpha", [0.15, 0.5])
def test_completion_iters_matches_jax(rsum, target, alpha):
    assert tfora._completion_iters(rsum, target, alpha) == \
        jfora._completion_iters(rsum, target, alpha)


@pytest.mark.parametrize("cls", ["ForaTopk", "ForaWholeGraph"])
@pytest.mark.parametrize("completion", ["auto", "spmv", "walks"])
def test_cost_model_matches_jax(datasets, cls, completion):
    jds, tds = datasets["sparse"]
    args = (K,) if cls == "ForaTopk" else ()
    j = getattr(jfora, cls)(jds, ALPHA, *args, completion=completion)
    t = getattr(tfora, cls)(tds, ALPHA, *args, completion=completion)
    assert (t.avg_rand_walk_time_ns, t.spmv_ns_per_edge,
            t.spmv_batch_amortized) == tuple(jfora._default_cost_constants())
    assert t._d2h_rate() == j._d2h_rate() == 4e9
    for prep in (False, True):
        j._in_preprocessing = t._in_preprocessing = prep
        for omega in (10.0, 3e3, 2e6):
            for rsum in (1e-4, 0.05, 1.0):
                for target in (1e-6, 1e-3):
                    for b in (1, 8, 2048):
                        assert t._spmv_completion_ns(rsum, target, b) == \
                            j._spmv_completion_ns(rsum, target, b)
                        assert t._use_spmv(omega, rsum, target, b) == \
                            j._use_spmv(omega, rsum, target, b)


@pytest.mark.parametrize("eps", [10.0, 0.5, 0.05])
@pytest.mark.parametrize("k", [1, 10, 50])
def test_topk_path_choice_matches_jax(datasets, eps, k):
    """``push="auto"`` (the default in both packages) skips the push rounds
    exactly where the JAX package does (``ppr_tpu/models/fora.py:997``);
    ``path_cost`` reports the walk and propagation estimates the JAX cost
    model weighs there, and the choice; another ``push`` decides alone."""
    for kind in ("sparse", "dense"):
        jds, tds = datasets[kind]
        t = tfora.ForaTopk(tds, ALPHA, k)
        j = jfora.ForaTopk(jds, ALPHA, k)
        assert t.push == j.push == "auto"
        e = eps * 0.5
        omega0 = (e + 2.0) * np.log(2.0 / j.pfail) / e / e / j.delta0
        for b in (8, 64, 2048):
            want = j._use_spmv(omega0, 1.0, e * j.delta0, b)
            assert t._skip_push(e, b) == want
            walk, spmv, path = t.path_cost(e, b)
            assert walk == pytest.approx(j.avg_rand_walk_time_ns * omega0,
                                         rel=1e-12)
            assert spmv == j._spmv_completion_ns(1.0, e * j.delta0, b)
            assert path == ("annealed" if want else "push+walks")
        t.push = "none"
        assert t.path_cost(e, 8)[2] == "annealed"
        t.push = "reference"
        assert t.path_cost(e, 2048)[2] == "push+walks"


def _residual_pair(datasets, kind, hubs, dtype, b=16, target=1e-4):
    jds, tds = datasets[kind]
    sources = np.random.default_rng(b).integers(0, jds.graph.n, b)
    p, r, oh = jax_init(jds.graph, jnp.asarray(sources, jnp.int32))
    jp, jr, jit = jfora.residual_propagate(
        jds.graph, p, r, oh, jnp.float32(target), ALPHA,
        hs=jax_hubs(jds.graph, hubs, dtype=dtype[0]) if hubs else None)
    p, r, oh = port_init(tds.graph, torch.as_tensor(sources,
                                                    dtype=torch.int32))
    tp, tr, tit = tfora.residual_propagate(
        tds.graph, p, r, oh, target, ALPHA,
        hs=port_hubs(tds.graph, hubs, dtype=dtype[1]) if hubs else None)
    return (np.asarray(jp), np.asarray(jr), int(jit)), \
        (tp.numpy(), tr.numpy(), tit)


@pytest.mark.parametrize("kind,hubs", [("sparse", None), ("dense", None),
                                       ("sparse", 64)])
def test_residual_propagate_matches_jax(datasets, kind, hubs):
    (jp, jr, jit), (tp, tr, tit) = _residual_pair(
        datasets, kind, hubs, (jnp.float32, torch.float32))
    assert tit == jit > 0
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    np.testing.assert_allclose(tr, jr, atol=1e-6)
    assert tr.sum(axis=1).max() <= np.float32(1e-4)   # below the target


def test_residual_propagate_bf16_hubs_matches_jax(datasets):
    (jp, _, jit), (tp, _, tit) = _residual_pair(
        datasets, "sparse", 64, (jnp.bfloat16, torch.bfloat16))
    assert tit == jit > 0
    np.testing.assert_allclose(tp, jp, atol=1e-5)
    tol = EPS / datasets["sparse"][1].n
    for row in range(tp.shape[0]):
        assert set(topk_ids_with_ties(tp[row], K, tol=tol)) == \
            set(topk_ids_with_ties(jp[row], K, tol=tol))


def test_residual_propagate_stops_at_once_below_target(datasets):
    _, tds = datasets["sparse"]
    p, r, oh = port_init(tds.graph, torch.arange(8, dtype=torch.int32))
    tp, tr, it = tfora.residual_propagate(tds.graph, p, r, oh, 2.0, ALPHA)
    assert it == 0 and torch.equal(tp, p) and torch.equal(tr, r)


@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_topk_reference_spmv_matches_jax(datasets, kind, monkeypatch):
    """``push="reference"`` with propagation completion is deterministic:
    the same rounds, the same result within 1e-6, the same tie-expanded
    top-k sets."""
    jds, tds = datasets[kind]
    sources = np.random.default_rng(7).integers(0, jds.graph.n, 12)
    rounds = []
    real = jfora.residual_propagate

    def count(*args, **kwargs):
        rounds.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jfora, "residual_propagate", count)
    j = jfora.ForaTopk(jds, ALPHA, K, push="reference", completion="spmv")
    t = tfora.ForaTopk(tds, ALPHA, K, push="reference", completion="spmv")
    want = j.compute_topk_batch(sources, K, EPS)
    got = t.compute_topk_batch(sources, K, EPS)
    assert t.last_iters == len(rounds) > 0
    np.testing.assert_allclose(got, want, atol=1e-6)
    tol = EPS / tds.n
    for row in range(len(sources)):
        assert set(topk_ids_with_ties(got[row], K, tol=tol)) == \
            set(topk_ids_with_ties(want[row], K, tol=tol))


@pytest.mark.parametrize("fresh_rounds", [False, True])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_whole_graph_spmv_pinned_rounds_match_jax(datasets, kind,
                                                  fresh_rounds, monkeypatch):
    jds, tds = datasets[kind]
    sources = np.random.default_rng(3).integers(0, jds.graph.n, 10)
    pushes = []
    real = jfora.forward_push_sweeps

    def count(*args, **kwargs):
        pushes.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jfora, "forward_push_sweeps", count)
    monkeypatch.setattr(jfora, "_WARMED_PUSH_SHAPES", set())
    out = []
    for mod, ds in ((jfora, jds), (tfora, tds)):
        algo = mod.ForaWholeGraph(ds, ALPHA, completion="spmv",
                                  max_push_rounds=4,
                                  fresh_rounds=fresh_rounds)
        algo.avg_rand_walk_time_ns = algo.spmv_ns_per_edge = 1e30
        out.append((algo, algo.compute_whole_graph_batch(sources, EPS)))
    (_, want), (t, got) = out
    assert t.last_rounds == len(pushes) - 1 == 4   # JAX warms once
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_kth_over_support_matches_jax():
    rng = np.random.default_rng(0)
    p = rng.random((6, 40), dtype=np.float32)
    p[p < 0.7] = 0.0
    p[0] = 0.0
    p[1, :3] = [0.5, 0.5, 0.5]
    for k in (1, 3, 10, 40, 50):
        want = np.asarray(jfora._kth_over_support(jnp.asarray(p), k))
        got = tfora._kth_over_support(torch.as_tensor(p), k).numpy()
        assert np.array_equal(got, want)


def test_whole_graph_walk_setup_matches_jax():
    rng = np.random.default_rng(1)
    r1 = rng.random((4, 256), dtype=np.float32) * 1e-3
    r1[r1 < 4e-4] = 0.0
    for omega in (17.0, 3.3e4, 9.27e6):
        jom, jw = jfora._whole_graph_walk_setup(jnp.asarray(r1),
                                                jnp.float32(omega))
        tom, tw = tfora._whole_graph_walk_setup(torch.as_tensor(r1), omega)
        assert np.array_equal(tom.numpy(), np.asarray(jom))
        assert np.array_equal(tw.numpy(), np.asarray(jw))


def test_walk_contrib_chunked_branch(datasets, monkeypatch):
    """Shrunk budget: groups and integer passes; every (row, node) walk
    population deposits om * w into its own row, whatever the walks do
    (``tests/test_walk_compaction.py``'s invariant)."""
    _, tds = datasets["dense"]
    g = tds.graph
    rng = np.random.default_rng(3)
    b = 5
    om = np.zeros((b, g.n_pad), np.int32)
    nodes = rng.integers(0, g.n, size=(b, 12))
    om[np.arange(b)[:, None], nodes] = rng.integers(1, 40, size=(b, 12))
    w = np.zeros((b, g.n_pad), np.float32)
    w[om > 0] = rng.random((om > 0).sum(), dtype=np.float32) + 0.5
    want = (om * w.astype(np.float64)).sum(axis=1)
    gen = torch.Generator().manual_seed(0)
    calls = []
    real = tfora._walk_contrib

    def spy(g_, om_, *args):
        calls.append(int(om_.sum()))
        return real(g_, om_, *args)

    monkeypatch.setattr(tfora, "_walk_contrib", spy)
    for budget in (64, 1 << 28):
        monkeypatch.setattr(tfora, "_WALK_CHUNK_BUDGET", budget)
        calls.clear()
        out = tfora._walk_contrib_chunked(
            g, torch.as_tensor(om), torch.as_tensor(w), gen, ALPHA, False)
        np.testing.assert_allclose(out.sum(dim=1).numpy(), want, rtol=1e-5)
        assert (out >= 0).all()
        assert sum(calls) == om.sum()
        # a pass rounds each node's share up: at most one walk over a
        # node's share per node (12 a row here)
        assert max(calls) <= budget + 12
        assert (len(calls) > b) == (budget == 64)


@pytest.mark.parametrize("completion", ["walks", "spmv", "auto"])
def test_fora_whole_graph_accuracy(datasets, oracle, completion):
    _, tds = datasets["dense"]
    sources, rows = oracle
    fora = AlgoConf(ALPHA, seed=2).set_conf_fora_whole_graph(tds)
    fora.completion = completion
    err, prec, ndcg = metrics(fora.compute_whole_graph_batch(sources, EPS),
                              sources, rows)
    assert err < 0.03 and prec > 0.9 and ndcg > 0.97


@pytest.mark.parametrize("completion", ["walks", "spmv"])
def test_fora_topk_accuracy(datasets, oracle, completion):
    _, tds = datasets["dense"]
    sources, rows = oracle
    fora = AlgoConf(ALPHA, seed=3).set_conf_fora_topk(tds, K)
    fora.completion = completion
    _, prec, ndcg = metrics(fora.compute_topk_batch(sources, K, EPS),
                            sources, rows)
    assert prec > 0.9 and ndcg > 0.97
    # "walks" runs the push+walk rounds, "spmv" the annealed loop
    assert bool(fora.last_round_walks) == (completion == "walks")


def test_cohorts_are_one_terminal_cohort_on_the_push_path(datasets):
    _, tds = datasets["sparse"]
    algo = tfora.ForaTopk(tds, ALPHA, K, completion="walks")
    sources = np.arange(5)
    out = list(algo.compute_topk_ids_cohorts(sources, K, EPS))
    assert len(out) == 1 and out[0][0].tolist() == list(range(5))
    assert out[0][1].shape == (5, 42)     # kcap = max(4k, k + 32)


def test_push_warmed_once_per_shape(datasets, monkeypatch):
    """One untimed push a (graph, B) and process, before the timed
    rounds; later calls at that shape push only in the rounds."""
    _, tds = datasets["sparse"]
    monkeypatch.setattr(tfora, "_WARMED_PUSH_SHAPES", set())
    pushes = []
    real = tfora.forward_push_sweeps

    def count(*args, **kwargs):
        pushes.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(tfora, "forward_push_sweeps", count)
    algo = tfora.ForaWholeGraph(tds, ALPHA, completion="spmv")
    algo.compute_whole_graph_batch(np.arange(9), EPS)
    assert len(pushes) == algo.last_rounds + 1
    pushes.clear()
    algo.compute_whole_graph_batch(np.arange(9), EPS)
    assert len(pushes) == algo.last_rounds > 0
    assert len(tfora._WARMED_PUSH_SHAPES) == 1


def test_calibrate_installs_measured_constants(datasets):
    _, tds = datasets["sparse"]
    walk, spmv, amortized, d2h = calibrate.measure(tds.graph, walkers=2048,
                                                   reps=1)
    assert walk > 0 and spmv > 0 and amortized and np.isfinite(d2h)
    algo = tfora.ForaTopk(tds, ALPHA, K)
    calibrate.apply(algo, (1.0, 2.0, True))
    assert (algo.avg_rand_walk_time_ns, algo.spmv_ns_per_edge) == (1.0, 2.0)
    assert algo.d2h_bytes_per_s == 4e9
    assert algo.calibrate(walkers=2048, reps=1)[2] is True


@pytest.fixture
def cheap_sweeps(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    spec = {"whole_graph": {AlgoType.FORA_WHOLE_GRAPH: [10.0, 0.5],
                            AlgoType.MC: [1.0]},
            "topk": {AlgoType.FORA_TOPK: [5.0, 0.5], AlgoType.MC: [1.0]},
            "prep": {AlgoType.FORA_WHOLE_GRAPH: [10.0], AlgoType.MC: [1.0]}}
    monkeypatch.setitem(th.SWEEPS, "got", spec)
    return tmp_path


def _rows(path):
    """``(test, fields)`` of each data row of a result file."""
    out, test = [], None
    for ln in path.read_text().splitlines()[1:]:
        if ln.startswith("Test "):
            test = int(ln.split()[1].rstrip("."))
        elif "," in ln and not ln.startswith("#"):
            out.append((test, ln.split(",")))
    return out


def test_cli_runs_mc_and_fora_whole_graph(cheap_sweeps):
    assert tcli.main(["--db", "synth:107x3@7", "--sweep", "got", "--query",
                      "4", "--algos", "MC,FORA_WHOLE_GRAPH",
                      "--fora-completion", "walks", "--device", "cpu"]) == 0
    text = (cheap_sweeps / "synth_107_7_AlgoPerfResults.txt").read_text()
    for section in ("1.1 FORA_WHOLE_GRAPH", "1.2 MC", "2.2 MC",
                    "3.1 FORA_WHOLE_GRAPH", "3.2 MC"):
        assert section in text
    rows = _rows(cheap_sweeps / "synth_107_7_AlgoPerfResults.txt")
    assert [t for t, _ in rows] == [1, 1, 1, 2, 3, 3]
    assert all(np.isfinite([float(x) for x in r]).all() for _, r in rows)
    errs = [float(r[-1]) for t, r in rows if t != 2]    # max-err
    assert max(errs) < 0.1
    assert all(int(r[3]) > 0 for t, r in rows if t == 3)   # store bytes


def test_cli_fora_topk_walks(cheap_sweeps, monkeypatch):
    seen = []
    real = th.AlgoConf.new_algo_obj

    def spy(self, algo, dataset, k=-1):
        obj = real(self, algo, dataset, k)
        seen.append(obj)
        return obj

    monkeypatch.setattr(th.AlgoConf, "new_algo_obj", spy)
    assert tcli.main(["--db", "synth:107x3@7", "--sweep", "got", "--query",
                      "4", "--tests", "2", "--algos", "FORA_TOPK",
                      "--fora-completion", "walks", "--device", "cpu"]) == 0
    rows = [r for _, r in _rows(cheap_sweeps
                                 / "synth_107_7_AlgoPerfResults.txt")]
    assert [r[0] for r in rows] == ["5.0", "0.5"]
    assert all(float(r[3]) >= 0.5 for r in rows)      # precision
    assert [a.completion for a in seen] == ["walks", "walks"]
    assert all(a.last_round_walks for a in seen)
