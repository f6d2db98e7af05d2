"""The CPU baseline of the port's bench: FORA top-k on scipy sparse + numpy.

A copy of ``bench.CpuFora`` (the JAX package's bench, ``bench.py:38-124``),
reading the port's :class:`~ppr_tpu_torch.graph.csr.Graph` through
``.cpu().numpy()``: the reference's algorithm (push until ``rmax``, then
residual-weighted walks, delta annealed from 1/k down to 1/n), vectorized,
as a stand-in for the reference's Java/Neo4j engine, which cannot run here.
numpy and scipy only; nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np


class CpuFora:
    def __init__(self, ds, alpha, k):
        import scipy.sparse as sp

        g = ds.graph
        self.n = g.n
        self.alpha = alpha
        self.k = k
        src = g.edge_src[: g.m].cpu().numpy()
        dst = g.edge_dst[: g.m].cpu().numpy()
        deg = g.out_deg[: self.n].cpu().numpy().astype(np.float64)
        inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
        self.P = sp.coo_matrix(
            (inv[src], (src, dst)), shape=(self.n, self.n)
        ).tocsr()
        self.deg = deg
        self.dangling = deg == 0
        # CSR for walks
        order = np.argsort(src, kind="stable")
        self.w_dst = dst[order]
        self.w_indptr = np.zeros(self.n + 1, np.int64)
        np.cumsum(np.bincount(src, minlength=self.n), out=self.w_indptr[1:])
        self.min_delta = 1.0 / self.n
        self.pfail = 1.0 / self.n / self.n / math.log(max(self.n / k, math.e))

    def _push(self, p, r, rmax):
        for _ in range(10_000):
            gate = np.where(self.deg > 0, rmax * self.deg, np.inf)
            active = (r >= gate) | (self.dangling & (r > 0))
            if not active.any():
                break
            a = np.where(active, r, 0.0)
            p += self.alpha * a
            a_d = np.where(self.dangling, a, 0.0)
            out = (1 - self.alpha) * (a - a_d)
            r = r - a + out @ self.P
            r[self.src] += (1 - self.alpha) * a_d.sum()
        return p, r

    def _walks(self, starts, rng, max_steps=128):
        cur = starts.copy()
        active = np.ones(cur.shape, bool)
        for _ in range(max_steps):
            if not active.any():
                break
            stop = rng.random(cur.shape) < self.alpha
            act_idx = active & ~stop
            d = self.deg[cur].astype(np.int64)
            u = rng.random(cur.shape)
            pick = np.minimum((u * d).astype(np.int64), np.maximum(d - 1, 0))
            nxt = self.w_dst[np.minimum(self.w_indptr[cur] + pick,
                                        len(self.w_dst) - 1)]
            nxt = np.where(d > 0, nxt, starts)
            cur = np.where(act_idx, nxt, cur)
            active = act_idx
        return cur

    def topk(self, source, eps, rng):
        eps = eps * 0.5
        self.src = source
        ln_t = math.log(2.0 / self.pfail)
        m = self.P.nnz
        delta = 1.0 / self.k
        p = np.zeros(self.n)
        r = np.zeros(self.n)
        r[source] = 1.0
        while True:
            rmax = eps * math.sqrt(delta / 3.0 / m / ln_t)
            rmax *= math.sqrt(m * rmax) * 3.0
            omega = (eps + 2.0) * ln_t / eps / eps / delta
            p, r = self._push(p, r, rmax)
            num_walk = omega * r.sum() * (1 - self.alpha)
            om = np.where(r > 0, np.ceil(r * num_walk), 0).astype(np.int64)
            total = int(om.sum())
            round_p = p.copy()
            if total > 0:
                starts = np.repeat(np.arange(self.n), om)
                w = np.repeat(
                    np.where(om > 0, r / np.maximum(om, 1), 0.0), om
                )
                stops = self._walks(starts, rng)
                np.add.at(round_p, stops, w)
            sup = round_p[round_p > 0]
            kth = np.partition(sup, -self.k)[-self.k] if sup.size >= self.k else 0.0
            if kth >= (1 + eps) * delta or delta <= self.min_delta:
                return round_p
            delta = max(self.min_delta, delta / 4.0)
