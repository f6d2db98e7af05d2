"""The deployments' graphs, made from a seed (numpy only).

The published edge lists are not in the repository, so a deployment's graph
is drawn at its published size, fitted to the statistics its source
publishes. :func:`draw` reads a configuration's ``nodes``, ``edges`` and
``generator``; the generator's keys pick the draw and are its arguments:

- ``undirected`` and ``max_degree``: :func:`generate`, one rank law for
  both ends of every edge (a friendship network);
- ``out_cap``, ``dangling``, ``in_max_degree`` and ``local_share``:
  :func:`copurchase`, capped out-lists, nodes with none, targets by a rank
  law and by a category ring (a co-purchase network).

:func:`degree_summary` and :func:`average_clustering` are the statistics a
drawn graph is fitted against.
"""

from __future__ import annotations

import numpy as np

#: wedges (pairs of a node's neighbours) looked up at once by
#: :func:`average_clustering`: bounds its memory, ~100 MB a chunk
CHUNK = 1 << 22


def draw(cfg: dict, seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The graph of configuration ``cfg`` from ``seed``: ``(src, dst)``
    int64 arrays, by :func:`copurchase` where ``cfg["generator"]`` has an
    ``out_cap``, else by :func:`generate`."""
    gen = cfg["generator"]
    how = copurchase if "out_cap" in gen else generate
    return how(cfg["nodes"], cfg["edges"], int(seed) % (1 << 63), **gen)


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


def _rank_weights(rng, n: int, a: float) -> np.ndarray:
    """Probabilities ``(rank + 1) ** -a`` over a random ranking of ``n``."""
    weights = (rng.permutation(n) + 1.0) ** -a
    return weights / weights.sum()


def generate(nodes: int, edges: int, seed: int, *, max_degree: float,
             undirected: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """``(src, dst)`` int64 arrays: ``edges`` distinct pairs over ``nodes``
    nodes (each pair as two directed edges when ``undirected``), the same
    for the same arguments.

    The expected degree of the node of rank ``i`` (ranks a random
    permutation of the nodes) is ``max_degree * (i + 1) ** -a``, ``a``
    solved so that the mean is the published one, ``2 edges / nodes`` for
    an undirected graph: the rank law through the published maximum and
    mean. Edges join two nodes each drawn with probability proportional to
    its expected degree (the Chung-Lu model); self-loops and repeated pairs
    are dropped (the published graphs are simple) and draws go on until
    exactly ``edges`` distinct pairs exist, in the order first drawn. An
    undirected graph's pairs are returned in both directions.
    """
    n, m = int(nodes), int(edges)
    if n < 2 or m > n * (n - 1) // (2 if undirected else 1):
        raise ValueError(f"{m} simple edges do not fit on {n} nodes")
    mean = (2.0 if undirected else 1.0) * m / n
    a = rank_exponent(n, mean, max_degree)
    rng = np.random.default_rng(seed)
    weights = _rank_weights(rng, n, a)

    keys = np.empty(0, np.int64)
    while True:
        want = int((m - keys.size) * 1.25) + 1024
        u = rng.choice(n, size=want, p=weights)
        v = rng.choice(n, size=want, p=weights)
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


def copurchase(nodes: int, edges: int, seed: int, *, out_cap: int,
               dangling: int, in_max_degree: float,
               local_share: float) -> tuple[np.ndarray, np.ndarray]:
    """``(src, dst)`` int64 arrays: ``edges`` distinct directed pairs over
    ``nodes`` nodes, no self-link, sorted by source then target, the same
    for the same arguments.

    A random ``dangling`` nodes link nowhere. The others' out-degrees are
    as even as the sum allows: ``edges // (nodes - dangling)`` each, one
    more for a random ``edges % (nodes - dangling)`` of them, and none over
    ``out_cap`` (a capped "also bought" list). Of a node's ``k`` out-links,
    ``floor(local_share * k + U)`` (``U`` uniform in [0, 1)) go to the
    nodes that follow it on a random ring, the nearest first: the ring
    stands in for a product category, and two products that follow a third
    follow each other, which closes triangles (the Watts-Strogatz lattice
    on the out-lists). The rest go to targets drawn
    with probability ``(rank + 1) ** -a`` over a random ranking, ``a``
    solved by :func:`rank_exponent` for the maximum ``in_max_degree`` and
    the mean ``edges / nodes``; a draw that repeats a pair or hits its own
    source is drawn again.
    """
    n, m, cap, n_dang = int(nodes), int(edges), int(out_cap), int(dangling)
    linking = n - n_dang
    if not (0 <= n_dang and 0 < linking <= m <= linking * cap):
        raise ValueError(f"{m} links do not fit on {linking} linking nodes "
                         f"of at most {cap} links each, one at least")
    if not 0.0 <= local_share < 1.0:
        raise ValueError(f"local_share {local_share} is not in [0, 1)")
    if n <= cap:
        raise ValueError(f"{n} nodes leave no room for {cap} distinct links")
    a = rank_exponent(n, m / n, in_max_degree)
    rng = np.random.default_rng(seed)

    order = rng.permutation(n)         # the first `linking` have out-links
    base, extra = divmod(m, linking)
    deg = np.zeros(n, np.int64)
    deg[order[:linking]] = base
    deg[order[:extra]] += 1

    ring = rng.permutation(n)          # ring[i]: the node at position i
    pos = np.empty(n, np.int64)
    pos[ring] = np.arange(n)
    local = np.floor(local_share * deg + rng.random(n)).astype(np.int64)
    u = np.repeat(np.arange(n), local)
    step = 1 + np.arange(u.size) - np.repeat(np.cumsum(local) - local, local)
    keys = np.unique(u * n + ring[(pos[u] + step) % n])

    weights = _rank_weights(rng, n, a)
    while True:
        short = deg - np.bincount(keys // n, minlength=n)
        if not short.any():
            break
        u = np.repeat(np.arange(n), short)
        v = rng.choice(n, size=u.size, p=weights)
        keys = np.union1d(keys, (u * n + v)[u != v])
    return keys // n, keys % n


def degree_summary(src: np.ndarray, n: int, dst: np.ndarray | None = None
                   ) -> dict:
    """The drawn graph's out-degrees (``mean``, ``max``, ``median``,
    ``min``, and ``dangling``, the nodes with none) and, given ``dst``, its
    in-degrees (``in_max``, ``in_median``): what its configuration's
    published statistics are compared with."""
    deg = np.bincount(src, minlength=n)
    out = {"mean": float(deg.mean()), "max": int(deg.max()),
           "median": float(np.median(deg)), "min": int(deg.min()),
           "dangling": int((deg == 0).sum())}
    if dst is not None:
        indeg = np.bincount(dst, minlength=n)
        out.update(in_max=int(indeg.max()),
                   in_median=float(np.median(indeg)))
    return out


def average_clustering(src: np.ndarray, dst: np.ndarray, n: int) -> float:
    """The average clustering coefficient as SNAP publishes it: on the
    undirected simple graph (directions, repeats and self-links dropped),
    each node's share of its pairs of neighbours that are linked, a node of
    degree under 2 counting 0, averaged over all ``n`` nodes."""
    n = int(n)
    lo, hi = np.minimum(src, dst), np.maximum(src, dst)
    links = np.unique((lo * n + hi)[lo != hi])     # each link once, lo < hi
    if links.size == 0:
        return 0.0
    # both directions, sorted: node by node, each node's neighbours rising
    adj = np.unique(np.concatenate([links, (links % n) * n + links // n]))
    node, nbr = adj // n, adj % n
    deg = np.bincount(node, minlength=n)
    row_end = np.cumsum(deg)
    # slot s pairs its neighbour with each later one of its row (a wedge)
    later = row_end[node] - np.arange(adj.size) - 1
    total = np.cumsum(later)
    cuts = np.searchsorted(total, np.arange(CHUNK, total[-1], CHUNK))
    closed = np.zeros(n, np.int64)
    for s0, s1 in zip(np.r_[0, cuts], np.r_[cuts, adj.size]):
        c = later[s0:s1]
        s = np.repeat(np.arange(s0, s1), c)
        t = s + 1 + np.arange(s.size) - np.repeat(np.cumsum(c) - c, c)
        key = nbr[s] * n + nbr[t]
        at = np.minimum(np.searchsorted(links, key), links.size - 1)
        closed += np.bincount(node[s[links[at] == key]], minlength=n)
    pairs = deg * (deg - 1) // 2
    return float(np.sum(closed / np.maximum(pairs, 1)) / n)
