"""The port on directed co-purchase graphs with dangling products (the
amazon0302 deployment's shape, ``benchmark/configs/amazon.json``), at a
few thousand nodes on the CPU: FORA top-k through ``PPRService`` with the
automatic bf16 hub split held to the benchmark's plain reference
(``benchmark/reference.py``) at an ``over`` limit that the reference in
bfloat16 fails, and to the JAX package's FORA top-k on the same graph and
batch; dangling sources answered with themselves alone; the annealed
loop's state and dangling counters at their closed forms. Under prices
that put the automatic rule's threshold at amazon0302's 748 in-links, no
node of these graphs passes it, as none of amazon0302's does: ``"auto"``
then makes no hub split, and every edge goes through the sparse push."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import graphgen, reference  # noqa: E402
from ppr_tpu.graph.csr import build_graph as jax_build_graph  # noqa: E402
from ppr_tpu.graph.io import Dataset as JaxDataset  # noqa: E402
from ppr_tpu.models import fora as jfora  # noqa: E402
from ppr_tpu_torch.graph.csr import build_graph  # noqa: E402
from ppr_tpu_torch.graph.io import Dataset  # noqa: E402
from ppr_tpu_torch.models import fora as tfora  # noqa: E402
from ppr_tpu_torch.ops import hub_split as ths  # noqa: E402
from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs  # noqa: E402
from ppr_tpu_torch.service import PPRService  # noqa: E402
from ppr_tpu_torch.utils import timer  # noqa: E402

ALPHA, EPS, K = 0.15, 0.5, 10
#: co-purchase draws at amazon0302's mean out-degree (4.711) and cap (5),
#: its fitted clustering share, and dangling products
GRAPHS = {
    "n3000": dict(nodes=3000, edges=14133, dangling=150, seed=2**31 + 5),
    "n5000": dict(nodes=5000, edges=23555, dangling=280, seed=2**33 + 1),
    "nodang": dict(nodes=3000, edges=14133, dangling=0, seed=2**31 + 9),
}
B = 64
#: ``over`` between the program's readings on these graphs (at most
#: 0.0073) and those of the reference computed in bfloat16 (at least 0.047)
OVER = 0.02
#: amazon0302's ``n_pad``, where the rule's threshold is 748 in-links at
#: the card's prices
AMAZON_N_PAD = 262144


@pytest.fixture(autouse=True)
def clean_recorder():
    timer.RECORDER.clear()
    yield
    timer.RECORDER.clear()


def _draw(nodes, edges, dangling, seed):
    cfg = {"nodes": nodes, "edges": edges, "generator": {
        "out_cap": 5, "dangling": dangling, "in_max_degree": 150.0,
        "local_share": 0.789}}
    return graphgen.draw(cfg, seed)


@pytest.fixture(scope="module", params=sorted(GRAPHS))
def deployment(request):
    """``(name, src, dst, n, service, batch)``: a batch of ``B`` sources,
    uniform after the first six dangling ones (none on ``nodang``)."""
    spec = GRAPHS[request.param]
    src, dst = _draw(**spec)
    n = spec["nodes"]
    g = build_graph(src, dst, n=n, device="cpu")
    svc = PPRService(Dataset(graph=g, names=[str(i) for i in range(n)],
                             name=request.param),
                     alpha=ALPHA, eps=EPS, k=K, hub_split="auto",
                     hub_dtype=torch.bfloat16)
    rng = np.random.default_rng(spec["seed"])
    dang = np.nonzero(np.bincount(src, minlength=n) == 0)[0]
    assert dang.size == spec["dangling"]
    batch = np.concatenate([dang[:6], rng.integers(0, n, B - dang[:6].size)])
    return request.param, src, dst, n, svc, batch


def _recorded(svc, batch):
    with profile(activities=[ProfilerActivity.CPU]):
        hits = svc.top_k(batch)
    (sp,) = [s for s in timer.RECORDER.spans() if s.name == "loop.topk"]
    return hits, sp, timer.RECORDER.counters()


def test_answers_meet_the_reference(deployment):
    name, src, dst, n, svc, batch = deployment
    algo = svc._topk_algo
    assert algo.hub_split.num_hubs == 128        # the rule's floor
    assert algo.hub_split.dtype == torch.bfloat16
    hits = svc.top_k(batch)
    assert algo.last_path == "annealed"
    answers = [(int(s), [(h.node, h.score) for h in row])
               for s, row in zip(batch, hits)]
    op = reference.Operator(src, dst, n, "cpu")
    worst = reference.judge(answers, op, ALPHA, K, EPS)
    assert worst["malformed"] == 0
    assert worst["miss"] <= reference.LIMITS["miss"]
    assert worst["over"] <= OVER
    assert all(0 <= node < n for _, row in answers for node, _ in row)
    out_deg = np.bincount(src, minlength=n)
    for s, row in answers:
        if out_deg[s] == 0:
            assert row == [(s, 1.0)], (s, row)


def test_the_bf16_reference_reads_over_the_limit(deployment):
    """The check above tells the program from the reference computed in
    the precision below its float32 state."""
    name, src, dst, n, svc, batch = deployment
    op = reference.Operator(src, dst, n, "cpu")
    ctl = reference.control_answers(src, dst, n, [int(s) for s in batch],
                                    ALPHA, K, "cpu")
    assert reference.judge(ctl, op, ALPHA, K, EPS)["over"] > OVER


def test_topk_matches_jax(deployment):
    """The port's FORA top-k against the JAX package's on the same graph
    and batch, 128 bf16 hubs on both (the port's automatic count here),
    the annealed loop on both (``push="none"``): scores within float
    reassociation, equal tie-expanded id sets, dangling sources alone."""
    name, src, dst, n, svc, batch = deployment
    assert svc._topk_algo.hub_split.num_hubs == 128
    names = [str(i) for i in range(n)]
    jds = JaxDataset(graph=jax_build_graph(src, dst, n, dense_threshold=0),
                     names=names, name=name)
    jalgo = jfora.ForaTopk(jds, ALPHA, K, seed=7, push="none")
    jalgo.enable_hub_split(128, dtype=jnp.bfloat16)
    talgo = tfora.ForaTopk(svc.dataset, ALPHA, K, seed=7, push="none")
    talgo.enable_hub_split(dtype=torch.bfloat16)
    jv, ji = jalgo.compute_topk_ids_batch(batch, K, EPS)
    tv, ti = talgo.compute_topk_ids_batch(batch, K, EPS)
    assert talgo.last_path == "annealed" and talgo.last_iters > 0
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-6)
    out_deg = np.bincount(src, minlength=n)
    for row, s in enumerate(batch):
        got = topk_ids_with_ties_from_pairs(tv[row], ti[row], K)
        assert set(got) == set(
            topk_ids_with_ties_from_pairs(jv[row], ji[row], K))
        if out_deg[s] == 0:
            assert list(got) == [s] and tv[row][0] == 1.0


def test_the_loop_counts_its_closed_forms(deployment):
    """The state and dangling counters, and one ``loop.dangling_mass``
    span a sweep, under the ``loop.topk`` span (none on a graph without
    dangling nodes, whose counts read 0)."""
    name, src, dst, n, svc, batch = deployment
    g = svc.dataset.graph
    hits, sp, c = _recorded(svc, batch)
    sweeps, calls = c["loop.sweeps"]
    assert calls == 1 and sweeps >= sp.attrs["sweeps"] > 0
    assert sp.attrs["columns"] == B
    assert c["loop.state_elems"] == (sweeps * g.n_pad * B, 1)
    assert c["loop.bf16_copy_elems"] == c["loop.state_elems"]
    n_dang = g.dang_ids.numel()
    assert n_dang == GRAPHS[name]["dangling"]
    assert c["loop.dangling_cols"] == (sweeps * n_dang * B, 1)
    mass = [s for s in timer.RECORDER.spans()
            if s.name == "loop.dangling_mass"]
    assert len(mass) == (sweeps if n_dang else 0)
    assert all(s.root == sp.root for s in mass)


def test_no_bf16_copy_without_a_bf16_hub_product():
    """A float32 hub product, and none: the pre pass writes no bf16 copy,
    and a short batch counts its padding columns in the state and
    dangling counters."""
    spec = GRAPHS["n3000"]
    src, dst = _draw(**spec)
    n = spec["nodes"]
    g = build_graph(src, dst, n=n, device="cpu")
    ds = Dataset(graph=g, names=[str(i) for i in range(n)], name="f32")
    batch = np.nonzero(np.bincount(src, minlength=n) == 0)[0][:3]
    for kw in ({"hub_split": "auto", "hub_dtype": torch.float32}, {}):
        timer.RECORDER.clear()
        svc = PPRService(ds, alpha=ALPHA, eps=EPS, k=K, **kw)
        hits, sp, c = _recorded(svc, batch)
        assert [[(h.node, h.score) for h in row] for row in hits] == \
            [[(int(s), 1.0)] for s in batch]
        cols = sp.attrs["columns"]          # padded to 8 with node 0
        assert cols == 8
        sweeps = c["loop.sweeps"][0]
        assert c["loop.state_elems"] == (sweeps * g.n_pad * cols, 1)
        assert c["loop.bf16_copy_elems"] == (0, 1)
        assert c["loop.dangling_cols"] == (
            sweeps * g.dang_ids.numel() * cols, 1)


@pytest.fixture
def amazon_prices(deployment, monkeypatch):
    """The rule's prices scaled so that its threshold on the deployment's
    graph is the one at amazon0302's ``n_pad``: 748 in-links, over the
    in-degree of every node here."""
    g = deployment[4].dataset.graph
    monkeypatch.setattr(ths, "TAIL_NS_PER_EDGE",
                        ths.TAIL_NS_PER_EDGE * g.n_pad / AMAZON_N_PAD)
    min_deg, over = ths.over_threshold(g, torch.bfloat16)
    assert 748 < min_deg < 749 and over == 0
    assert ths.auto_num_hubs(g, torch.bfloat16) == 128   # the rule's floor


def test_no_split_where_no_node_passes_the_threshold(deployment,
                                                     amazon_prices):
    """``PPRService(hub_split="auto")`` and ``enable_hub_split()`` hold no
    split on both algorithms; the call takes the annealed loop with every
    edge in the sparse push (``hubs`` 0, ``tail_edges`` m) and no bf16
    copy, meets the reference, and gives the JAX package's answers without
    a split."""
    name, src, dst, n, split_svc, batch = deployment
    ds = split_svc.dataset
    g = ds.graph
    svc = PPRService(ds, alpha=ALPHA, eps=EPS, k=K, hub_split="auto",
                     hub_dtype=torch.bfloat16)
    assert svc._topk_algo.hub_split is None
    assert svc._wg_algo.hub_split is None
    talgo = tfora.ForaTopk(ds, ALPHA, K, seed=7, push="none")
    for algo in (talgo, tfora.ForaWholeGraph(ds, ALPHA)):
        algo.enable_hub_split(dtype=torch.bfloat16)
        assert algo.hub_split is None
    hits, sp, c = _recorded(svc, batch)
    assert svc._topk_algo.last_path == "annealed"
    assert sp.attrs["hubs"] == 0 and sp.attrs["tail_edges"] == g.m
    sweeps = c["loop.sweeps"][0]
    assert c["loop.bf16_copy_elems"] == (0, 1)
    assert c["loop.edge_cols"] == (sweeps * g.m * B, 1)
    answers = [(int(s), [(h.node, h.score) for h in row])
               for s, row in zip(batch, hits)]
    op = reference.Operator(src, dst, n, "cpu")
    worst = reference.judge(answers, op, ALPHA, K, EPS)
    assert worst["malformed"] == 0
    assert worst["miss"] <= reference.LIMITS["miss"]
    assert worst["over"] <= OVER
    jds = JaxDataset(graph=jax_build_graph(src, dst, n, dense_threshold=0),
                     names=ds.names, name=name)
    jv, ji = jfora.ForaTopk(jds, ALPHA, K, seed=7, push="none"
                            ).compute_topk_ids_batch(batch, K, EPS)
    tv, ti = talgo.compute_topk_ids_batch(batch, K, EPS)
    np.testing.assert_allclose(tv, np.asarray(jv), atol=1e-6)
    out_deg = np.bincount(src, minlength=n)
    for row, s in enumerate(batch):
        got = topk_ids_with_ties_from_pairs(tv[row], ti[row], K)
        assert set(got) == set(
            topk_ids_with_ties_from_pairs(jv[row], ji[row], K))
        if out_deg[s] == 0:
            assert list(got) == [s] and tv[row][0] == 1.0


def test_an_explicit_count_still_splits(deployment, amazon_prices):
    """Under the same prices an explicit count builds the split it names,
    through both callers and ``resolve_hub_split``."""
    ds = deployment[4].dataset
    svc = PPRService(ds, alpha=ALPHA, eps=EPS, k=K, hub_split=128,
                     hub_dtype=torch.bfloat16)
    assert svc._topk_algo.hub_split.num_hubs == 128
    assert svc._wg_algo.hub_split is svc._topk_algo.hub_split
    algo = tfora.ForaTopk(ds, ALPHA, K)
    algo.enable_hub_split(128, dtype=torch.bfloat16)
    assert algo.hub_split.num_hubs == 128
    assert ths.resolve_hub_split(ds.graph, 128,
                                 torch.bfloat16).num_hubs == 128
