"""The graph draw that every cell's set-up calls (``graphgen.draw``): the
friendship draw as it was, the directed co-purchase draw's guarantees at a
small size and at amazon0302's published size, and the clustering
coefficient against hand counts and a plain loop."""

import hashlib
import itertools
import json
import time

import numpy as np
import pytest

from benchmark import graphgen
from benchmark.manifest import HERE

#: amazon0302 (SNAP; Leskovec, Adamic and Huberman, ACM TWEB 2007)
AMAZON_NODES, AMAZON_EDGES, AMAZON_OUT_CAP = 262111, 1234877, 5


def _sha(src, dst):
    return hashlib.sha256(src.tobytes() + dst.tobytes()).hexdigest()


def _flickr(nodes, edges):
    cfg = json.loads((HERE / "configs" / "flickr.json").read_text())
    return dict(cfg, nodes=nodes, edges=edges)


@pytest.mark.parametrize("seed, sha", [
    (19, "e5af3ac528c22454699dbef73b97126e851d7885303e32361802f97a53e83bf9"),
    (2**31 + 11,
     "b7b760c9233fa5b4b47202b978e7ca89b663375dbf36ad73c4519ff4a5472e7c"),
])
def test_the_friendship_draw_is_the_one_flickr_always_had(seed, sha):
    """flickr's generator keys at 8,000 nodes and 60,000 links: ``draw``
    gives ``generate``'s arrays, and both give the bits that ``generate``
    gave before ``draw`` existed (the hashes)."""
    cfg = _flickr(8000, 60000)
    src, dst = graphgen.draw(cfg, seed)
    old = graphgen.generate(8000, 60000, seed,
                            max_degree=cfg["generator"]["max_degree"],
                            undirected=cfg["generator"]["undirected"])
    assert np.array_equal(src, old[0]) and np.array_equal(dst, old[1])
    assert src.dtype == dst.dtype == np.int64
    assert _sha(src, dst) == sha


def _copurchase(nodes=5000, edges=23500, seed=2**40 + 7, **kw):
    gen = {"out_cap": 5, "dangling": 200, "in_max_degree": 80.0,
           "local_share": 0.5, **kw}
    cfg = {"nodes": nodes, "edges": edges, "generator": gen}
    return cfg, graphgen.draw(cfg, seed)


@pytest.mark.parametrize("kw", [
    {},
    {"local_share": 0.0},
    {"local_share": 0.9, "dangling": 0},
    {"dangling": 300, "out_cap": 5},       # every linking node at the cap
    {"edges": 4800},                       # one link a linking node
    {"out_cap": 12, "dangling": 1000, "edges": 40000},
])
def test_copurchase_graphs_are_simple_capped_and_exact(kw):
    cfg, (src, dst) = _copurchase(**kw)
    gen, n, m = cfg["generator"], cfg["nodes"], cfg["edges"]
    assert src.dtype == dst.dtype == np.int64 and src.size == dst.size == m
    assert src.min() >= 0 and max(src.max(), dst.max()) < n
    assert (src != dst).all()
    keys = src * n + dst
    assert np.unique(keys).size == m and (np.diff(keys) > 0).all()
    deg = graphgen.degree_summary(src, n, dst)
    assert deg["max"] <= gen["out_cap"] and deg["dangling"] == gen["dangling"]
    linking = np.bincount(src, minlength=n)
    linking = linking[linking > 0]
    assert linking.max() - linking.min() <= 1   # as even as the sum allows
    assert deg["mean"] == pytest.approx(m / n)


def test_copurchase_graphs_repeat_from_a_seed():
    _, a = _copurchase(seed=2**31 + 1)
    _, b = _copurchase(seed=2**31 + 1)
    _, c = _copurchase(seed=2**31 + 2)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not (np.array_equal(a[0], c[0]) and np.array_equal(a[1], c[1]))


@pytest.mark.parametrize("kw, error", [
    ({"dangling": 301}, ValueError),          # 4,699 nodes x 5 < 23,500
    ({"edges": 4799}, ValueError),            # a linking node with none
    ({"dangling": 5000}, ValueError),
    ({"local_share": 1.0}, ValueError),
    ({"local_share": -0.1}, ValueError),
    ({"in_max_degree": 4.0}, ValueError),     # under the mean
    ({"undirected": False}, TypeError),       # a key neither draw takes
])
def test_copurchase_refuses_what_it_cannot_draw(kw, error):
    with pytest.raises(error):
        _copurchase(**kw)


def _configuration_clustering(src, dst, n):
    """The clustering of a random graph with the same undirected degrees:
    ``(<k^2> - <k>)^2 / (<k>^3 n)`` (Newman, SIAM Review 2003, eq. 29)."""
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    links = np.unique((lo * n + hi)[lo != hi])
    k = np.bincount(np.r_[links // n, links % n], minlength=n).astype(float)
    return (np.mean(k * k) - k.mean()) ** 2 / (k.mean() ** 3 * n)


@pytest.mark.parametrize("seed", [3, 2**31 + 3])
def test_the_local_share_sets_the_clustering(seed):
    """No local links: the clustering of a random graph with the same
    degrees; then the larger the share, the larger the clustering."""
    cc = {}
    for share in (0.0, 0.3, 0.6):
        cfg, (src, dst) = _copurchase(seed=seed, local_share=share)
        cc[share] = graphgen.average_clustering(src, dst, cfg["nodes"])
        if share == 0.0:
            null = _configuration_clustering(src, dst, cfg["nodes"])
    assert 0.5 * null < cc[0.0] < 2.0 * null
    assert 10 * cc[0.0] < cc[0.3] < cc[0.6]


def _clustering_by_loop(src, dst, n):
    nbrs = [set() for _ in range(n)]
    for s, d in zip(src.tolist(), dst.tolist()):
        if s != d:
            nbrs[s].add(d)
            nbrs[d].add(s)
    total = 0.0
    for v in range(n):
        pairs = list(itertools.combinations(sorted(nbrs[v]), 2))
        if pairs:
            total += sum(b in nbrs[a] for a, b in pairs) / len(pairs)
    return total / n


@pytest.mark.parametrize("src, dst, n, expect", [
    ([0, 1, 2], [1, 2, 0], 3, 1.0),                     # a triangle
    ([0, 1, 2], [1, 2, 0], 4, 0.75),                    # and a lone node
    ([0, 1, 2, 3, 0], [1, 2, 3, 0, 2], 4, 5 / 6),      # 4-cycle, one chord
    ([0, 0, 0], [1, 2, 3], 4, 0.0),                     # a star
    ([0, 1, 1, 2, 0, 2, 0, 1], [1, 0, 2, 1, 2, 0, 0, 1], 3, 1.0),
    ([0], [0], 2, 0.0),                                 # a self-link only
])
def test_average_clustering_by_hand(src, dst, n, expect):
    """The 4-cycle 0-1-2-3 with the chord 0-2: nodes 1 and 3 read 1, nodes
    0 and 2 two linked pairs of three. Both directions, repeats and
    self-links count once or not at all."""
    src, dst = np.array(src), np.array(dst)
    assert graphgen.average_clustering(src, dst, n) == pytest.approx(expect)


@pytest.mark.parametrize("chunk", [graphgen.CHUNK, 7, 1])
def test_average_clustering_equals_a_plain_loop(monkeypatch, chunk):
    """A directed draw with hubs and local links, by chunks of any size."""
    monkeypatch.setattr(graphgen, "CHUNK", chunk)
    cfg, (src, dst) = _copurchase(nodes=400, edges=1800, dangling=20,
                                  in_max_degree=60.0, local_share=0.4)
    assert graphgen.average_clustering(src, dst, 400) == \
        pytest.approx(_clustering_by_loop(src, dst, 400), rel=1e-12)


def test_the_draw_at_amazon0302s_published_size():
    """262,111 products, 1,234,877 co-purchase links, lists capped at 5:
    the counts hold exactly, and the draw takes seconds, not minutes."""
    t = time.perf_counter()
    cfg, (src, dst) = _copurchase(nodes=AMAZON_NODES, edges=AMAZON_EDGES,
                                  seed=2718281801, out_cap=AMAZON_OUT_CAP,
                                  dangling=10000, in_max_degree=2100.0,
                                  local_share=0.8)
    seconds = time.perf_counter() - t
    assert src.size == AMAZON_EDGES
    assert np.unique(src * AMAZON_NODES + dst).size == AMAZON_EDGES
    assert (src != dst).all()
    deg = graphgen.degree_summary(src, AMAZON_NODES, dst)
    assert deg["max"] == AMAZON_OUT_CAP and deg["dangling"] == 10000
    assert deg["mean"] == pytest.approx(4.711, abs=5e-4)
    assert seconds < 60


@pytest.mark.parametrize("workload", ["tiny.batch", "tiny.serve"])
def test_a_copurchase_deployment_runs_from_its_data_alone(tiny_manifest,
                                                          capsys, workload):
    """A configuration file with the co-purchase keys and nothing else new:
    the whole run on the CPU draws it and its answers are correct."""
    import torch

    from benchmark import run

    path = tiny_manifest.root / "benchmark" / "configs" / "tiny.json"
    cfg = json.loads(path.read_text())
    cfg.update(nodes=2000, edges=9400, generator={
        "out_cap": 5, "dangling": 100, "in_max_degree": 150.0,
        "local_share": 0.8})
    path.write_text(json.dumps(cfg))
    out = run.run_cell(tiny_manifest, workload, 2**31 + 17, 0.5, False,
                       torch.device("cpu"))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    graph = next(line for line in capsys.readouterr().err.splitlines()
                 if line.startswith("graph: "))
    assert json.loads(graph[len("graph: "):])["dangling"] == 100
