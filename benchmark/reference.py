"""The plain reference and the comparison that decides ``correct``.

Plain PyTorch, importing nothing of the program. It builds its own operator
from the edge lists the benchmark generated (``graphgen.py``) and handed to
both sides, and computes Personalized PageRank with the reference's
semantics (Power_Method.java:55-100): ``pi = alpha e_s + (1 - alpha) (P^T
pi + (mass on dangling nodes) e_s)``, ``P[v, u]`` the share ``1 / d_v`` of
each edge ``v -> u``. It iterates the residual form, ``p += alpha r; r =
push((1 - alpha) r)``, until the residue left is below ``tol``; every
push is a plain scatter-add (``index_add_``) in the working precision.

The served answers are judged by FORA top-k's own guarantee
(Fora_Topk.java:110-178, eps' = eps / 2), which holds on both of the
program's paths, the annealed propagation loop and push rounds completed
by walks (the latter with probability 1 - p_fail):

* ``over``: a served score above the exact value, as a share of
  ``eps' max(pi(v), 1/n)``. The annealed loop's reserves are lower bounds,
  so only rounding reads above 0 there; walks may read up to 1.
* ``miss``: the largest exact value of a node left out, above the k-th
  served score ``s_k`` (0 when fewer than k were served), as a share of
  ``eps' s_k / (1 - eps') + eps' / n``. FORA stops only once every node
  left out lies within that of ``s_k``.
* ``malformed``: answers with a node out of range, a node twice or a score
  that is not finite.

A run is correct when no request failed and each number is at most its
limit in :data:`LIMITS`. ``miss`` is held to a limit set from readings at
the cells' own sizes on an NVIDIA H100 80GB HBM3 (PERF.md): sound runs of
the program read at most 0.0088 (and at most 3e-5 on calls of 8 to 128
rows), the control (this reference in bfloat16 in the program's place,
``control.py``) at least 0.344. ``over`` separates nothing from the
control (0.031 to 0.038 against the program's up to 0.0135: both round
in bfloat16) and is held to FORA's guarantee, which the configuration's
eps states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: no request may fail and no answer be malformed; ``over`` at FORA's
#: guarantee; ``miss`` between the program's readings and the control's
LIMITS = {"failed": 0, "malformed": 0, "over": 1.0, "miss": 0.04}
#: the residue left when the reference stops: below f64's resolution of
#: the values judged
TOL = 1e-13
#: elements of one scatter-add's gathered block
_BLOCK = 1 << 26


class Operator:
    """The transition operator of ``src -> dst`` over ``n`` nodes, on
    ``device`` in ``dtype``: each edge's share ``1 / d_v`` and the dangling
    nodes (out-degree 0)."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, n: int,
                 device, dtype: torch.dtype = torch.float64):
        self.n = int(n)
        self.dtype = dtype
        self.device = torch.device(device)
        src_t = torch.as_tensor(np.asarray(src, np.int64), device=device)
        dst_t = torch.as_tensor(np.asarray(dst, np.int64), device=device)
        deg = torch.bincount(src_t, minlength=self.n).to(torch.float64)
        self.src, self.dst = src_t, dst_t
        self.coef = (1.0 / deg[src_t]).to(dtype)
        self.dangling = torch.nonzero(deg == 0).flatten()

    def push(self, x: torch.Tensor) -> torch.Tensor:
        """``P^T x`` for ``x: [n, S]``, by scatter-adds over edge blocks."""
        y = torch.zeros_like(x)
        step = max(1, _BLOCK // max(x.shape[1], 1))
        for a in range(0, self.src.numel(), step):
            s, d = self.src[a:a + step], self.dst[a:a + step]
            y.index_add_(0, d, x.index_select(0, s) * self.coef[a:a + step,
                                                              None])
        return y


def ppr(op: Operator, sources, alpha: float, tol: float = TOL) -> torch.Tensor:
    """``[n, S]`` PPR columns of ``sources`` in ``op.dtype``: the residual
    iteration run for the sweeps that take the residue below ``tol``."""
    sources = torch.as_tensor(np.asarray(sources, np.int64), device=op.device)
    cols = torch.arange(sources.numel(), device=op.device)
    r = torch.zeros((op.n, sources.numel()), dtype=op.dtype, device=op.device)
    r[sources, cols] = 1
    p = torch.zeros_like(r)
    sweeps = math.ceil(math.log(tol) / math.log1p(-alpha))
    for _ in range(sweeps):
        p += alpha * r
        rem = (1.0 - alpha) * r
        dang = rem.index_select(0, op.dangling).sum(dim=0)
        r = op.push(rem)
        r[sources, cols] += dang
    return p


def hits_with_ties(column: np.ndarray, k: int) -> list[tuple[int, float]]:
    """The reference's top-k answer of one column: every node whose value
    is at least the k-th largest positive one, in descending order."""
    pos = np.nonzero(column > 0)[0]
    if pos.size > k:
        kth = np.partition(column[pos], pos.size - k)[pos.size - k]
        pos = pos[column[pos] >= kth]
    order = pos[np.argsort(-column[pos], kind="stable")]
    return [(int(v), float(column[v])) for v in order]


def judge_row(hits, exact: np.ndarray, k: int, eps: float) -> dict:
    """``over``, ``miss`` and ``malformed`` of one answer ``hits`` (node,
    score pairs) against the exact column ``exact`` (float64, ``[n]``)."""
    n = exact.shape[0]
    epsp = eps / 2.0
    nodes = np.asarray([h[0] for h in hits], np.int64)
    scores = np.asarray([h[1] for h in hits], np.float64)
    if (nodes.size and (nodes.min() < 0 or nodes.max() >= n)) \
            or np.unique(nodes).size != nodes.size \
            or not np.isfinite(scores).all():
        return {"over": math.inf, "miss": math.inf, "malformed": 1}
    scores_sorted = np.sort(scores)[::-1]
    floor = float(scores_sorted[k - 1]) if scores.size >= k else 0.0
    over = 0.0
    if nodes.size:
        den = epsp * np.maximum(exact[nodes], 1.0 / n)
        over = max(0.0, float(((scores - exact[nodes]) / den).max()))
    left = exact.copy()
    left[nodes] = -math.inf
    top_left = float(left.max()) if nodes.size < n else 0.0
    den = epsp * floor / (1.0 - epsp) + epsp / n
    miss = max(0.0, (top_left - floor) / den)
    return {"over": over, "miss": miss, "malformed": 0}


def judge(answers, op: Operator, alpha: float, k: int, eps: float,
          block: int = 64) -> dict:
    """The worst ``over`` and ``miss`` and the count of malformed answers
    over ``answers`` (source, hits) pairs, the reference run ``block``
    sources at a time."""
    worst = {"over": 0.0, "miss": 0.0, "malformed": 0}
    for a in range(0, len(answers), block):
        part = answers[a:a + block]
        cols = ppr(op, [s for s, _ in part], alpha).double().cpu().numpy()
        for j, (_, hits) in enumerate(part):
            row = judge_row(hits, cols[:, j], k, eps)
            worst["over"] = max(worst["over"], row["over"])
            worst["miss"] = max(worst["miss"], row["miss"])
            worst["malformed"] += row["malformed"]
    return worst


def control_answers(src, dst, n: int, sources, alpha: float, k: int,
                    device, dtype: torch.dtype = torch.bfloat16,
                    block: int = 64) -> list:
    """The control: the reference in ``dtype`` (the precision below the
    configuration's float32 state) put in the program's place, its top-k
    answers for ``sources`` as (source, hits) pairs."""
    op = Operator(src, dst, n, device, dtype)
    out = []
    for a in range(0, len(sources), block):
        part = list(sources[a:a + block])
        cols = ppr(op, part, alpha).double().cpu().numpy()
        out += [(s, hits_with_ties(cols[:, j], k)) for j, s in enumerate(part)]
    return out
