"""The deployments' graphs, made from a seed (numpy only).

The published edge lists are not in the repository, so a deployment's graph
is drawn at its published size with a degree sequence fitted to the degree
statistics its source publishes. The expected degree of the node of rank
``i`` (ranks a random permutation of the nodes) is ``max_degree * (i +
1) ** -a``, ``a`` solved so that the mean is the published one, ``2 edges /
nodes`` for an undirected graph: the rank law through the published maximum
and mean. Edges join two nodes each drawn with probability proportional to
its expected degree (the Chung-Lu model); self-loops and repeated pairs are
dropped (the published graphs are simple) and draws go on until exactly
``edges`` distinct pairs exist, in the order first drawn. An undirected
graph's pairs are returned in both directions.
"""

from __future__ import annotations

import numpy as np


def rank_exponent(nodes: int, mean_degree: float, max_degree: float) -> float:
    """``a`` with ``max_degree * mean((i + 1) ** -a for i < nodes) ==
    mean_degree``, by bisection."""
    if not 0 < mean_degree < max_degree < nodes:
        raise ValueError("need 0 < mean degree < max degree < nodes")
    ranks = np.arange(1, int(nodes) + 1, dtype=np.float64)
    lo, hi = 0.0, 8.0
    for _ in range(100):
        a = 0.5 * (lo + hi)
        if max_degree * np.mean(ranks ** -a) > mean_degree:
            lo = a
        else:
            hi = a
    return 0.5 * (lo + hi)


def generate(nodes: int, edges: int, seed: int, *, max_degree: float,
             undirected: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """``(src, dst)`` int64 arrays: ``edges`` distinct pairs over ``nodes``
    nodes (each pair as two directed edges when ``undirected``), the same
    for the same arguments."""
    n, m = int(nodes), int(edges)
    if n < 2 or m > n * (n - 1) // (2 if undirected else 1):
        raise ValueError(f"{m} simple edges do not fit on {n} nodes")
    mean = (2.0 if undirected else 1.0) * m / n
    a = rank_exponent(n, mean, max_degree)
    rng = np.random.default_rng(seed)
    weights = (rng.permutation(n) + 1.0) ** -a
    weights /= weights.sum()

    keys = np.empty(0, np.int64)
    while True:
        draw = int((m - keys.size) * 1.25) + 1024
        u = rng.choice(n, size=draw, p=weights)
        v = rng.choice(n, size=draw, p=weights)
        if undirected:
            u, v = np.minimum(u, v), np.maximum(u, v)
        new = u * n + v
        keys = np.concatenate([keys, new[u != v]])
        _, first = np.unique(keys, return_index=True)
        first.sort()                   # first draws, in the order drawn
        keys = keys[first]
        if keys.size >= m:
            keys = keys[:m]
            break
    src, dst = keys // n, keys % n
    if undirected:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    return src, dst


def degree_summary(src: np.ndarray, n: int) -> dict:
    """The drawn graph's out-degrees: what its configuration's published
    statistics are compared with."""
    deg = np.bincount(src, minlength=n)
    return {"mean": float(deg.mean()), "max": int(deg.max()),
            "median": float(np.median(deg)), "min": int(deg.min())}
