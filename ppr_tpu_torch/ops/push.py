"""Frontier-masked push sweeps, forward and backward — port of
``ppr_tpu/ops/push.py``.

* Forward push (Forward_Push.java:63-142): the reference's work queue, gated
  by ``r(v)/d_out(v) >= rmax``, is a frontier mask over the dense residue
  ``[B, n_pad]``. A sweep settles every active node at once (reserve +=
  alpha*r, the rest pushed to out-neighbors by ``spmv.push_out``); a
  dangling active node returns its ``(1-alpha)*r`` to the row's source
  (Forward_Push.java:101-115), and a dangling node is active whenever
  ``r > 0`` (the reference's ``r / 0 >= rmax`` is +inf). The fixpoint keeps
  ``sum(p) + sum(r) = 1``. A source with out-degree 0 starts
  short-circuited to reserve ``e_s`` and no residue (Forward_Push.java:
  70-74).
* Backward push (Backward_Search.java:38-100): the reverse sweep with the
  strict gate ``r(v) > rmax`` and ``r(u) += (1-alpha)*r(v)/d_out(u)`` for
  each in-neighbor u, through ``spmv.pull_out_norm``. A target with
  in-degree 0 short-circuits to reserve ``e_t`` (Backward_Search.java:
  46-49).

The JAX package runs each loop as one ``lax.while_loop`` that stops when
the frontier is empty. A sweep with an empty frontier is an exact no-op on
``(p, r)`` (``a = 0``, so nothing is added and the push of 0 is 0), so the
port runs its sweeps without waiting on the card: a device counter grows
only while the frontier is non-empty, and the host reads "done" once every
``CHECK_EVERY`` sweeps, up to ``max_sweeps``. ``sweeps_used`` keeps the JAX
meaning: the sweeps that had work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.csr import Graph
from .spmv import pull_out_norm, push_out

#: sweeps between the host's reads of the device-side "frontier empty"
CHECK_EVERY = 8


def _f32(x: float) -> float:
    """``x`` rounded to f32, held as a Python float (the JAX loops' f32
    constants; a Python scalar reaches the kernels as a scalar argument)."""
    return float(np.float32(x))


def forward_push_init(g: Graph, sources: torch.Tensor):
    """Initial ``(p, r, src_onehot)``, each f32 ``[B, n_pad]``, for int32
    source ids; dangling-source rows start short-circuited."""
    src_onehot = F.one_hot(sources.long(), g.n_pad).to(torch.float32)
    is_shortcircuit = (g.out_deg.index_select(0, sources) == 0)[:, None]
    zero = torch.zeros_like(src_onehot)
    p = torch.where(is_shortcircuit, src_onehot, zero)
    r = torch.where(is_shortcircuit, zero, src_onehot)
    return p, r, src_onehot


def forward_frontier(g: Graph, r: torch.Tensor, rmax: float) -> torch.Tensor:
    """Active mask per (row, node): ``r/d >= rmax``, with ``d == 0`` meaning
    an infinite ratio."""
    deg = g.out_deg.to(torch.float32)
    gated = (g.out_deg > 0) & (r >= _f32(rmax) * deg)
    dangling = (g.out_deg == 0) & (r > 0)
    return (gated | dangling) & (g.node_mask > 0)


def _run_sweeps(step, p, r, max_sweeps: int):
    """Call ``step(p, r) -> (p, r, active_any)`` until a host check sees an
    empty frontier or ``max_sweeps`` sweeps ran; returns ``(p, r,
    sweeps_used)`` with the count of sweeps whose frontier was non-empty."""
    used = torch.zeros((), dtype=torch.int32, device=p.device)
    for sweep in range(max_sweeps):
        p, r, active_any = step(p, r)
        used = used + active_any.to(torch.int32)
        if (sweep + 1) % CHECK_EVERY == 0 and not bool(active_any):
            break
    return p, r, int(used)


def forward_push_sweeps(g: Graph, p: torch.Tensor, r: torch.Tensor,
                        src_onehot: torch.Tensor, rmax: float, alpha: float,
                        max_sweeps: int = 10_000):
    """Masked push sweeps until no node is active (or ``max_sweeps``).

    ``p``, ``r``, ``src_onehot``: f32 ``[B, n_pad]``. Returns ``(p, r,
    sweeps_used)``. Restartable: calling again with a smaller ``rmax``
    refines further."""
    alpha_f = _f32(alpha)
    keep = float(np.float32(1.0) - np.float32(alpha))
    is_dangling = (g.out_deg == 0) & (g.node_mask > 0)

    def step(p_, r_):
        active = forward_frontier(g, r_, rmax)
        a = torch.where(active, r_, 0.0)
        p_ = p_ + alpha_f * a
        # dangling nodes push nothing through any backend (inverse degree 0,
        # no out-edges): their mass goes to the source below
        dang_mass = torch.where(is_dangling, a, 0.0).sum(dim=-1, keepdim=True)
        pushed = push_out(g, keep * a)
        r_ = r_ - a + pushed + (keep * dang_mass) * src_onehot
        return p_, r_, active.any()

    return _run_sweeps(step, p, r, max_sweeps)


def apply_dangling_source_shortcircuit(g: Graph, sources: torch.Tensor,
                                       p: torch.Tensor, r: torch.Tensor,
                                       src_onehot: torch.Tensor):
    """Rows whose source has out-degree 0 get reserve = e_s, residue = 0."""
    is_shortcircuit = (g.out_deg.index_select(0, sources) == 0)[:, None]
    p = torch.where(is_shortcircuit, src_onehot, p)
    r = torch.where(is_shortcircuit, torch.zeros_like(r), r)
    return p, r


def backward_push_sweeps(g: Graph, p: torch.Tensor, r: torch.Tensor,
                         rmax: float, alpha: float, max_sweeps: int = 10_000):
    """Reverse push until no node has residue > ``rmax`` (strict gate).

    One sweep: every active node v settles ``p(v) += alpha*r(v)`` and sends
    ``(1-alpha)*r(v)/d_out(u)`` to each in-neighbor u; mass at a node with no
    in-neighbors vanishes, as in the reference. Returns ``(p, r,
    sweeps_used)``."""
    alpha_f = _f32(alpha)
    keep = float(np.float32(1.0) - np.float32(alpha))
    gate = _f32(rmax)
    real = g.node_mask > 0

    def step(p_, r_):
        active = (r_ > gate) & real
        a = torch.where(active, r_, 0.0)
        p_ = p_ + alpha_f * a
        r_ = r_ - a + pull_out_norm(g, keep * a)
        return p_, r_, active.any()

    return _run_sweeps(step, p, r, max_sweeps)


def apply_zero_indeg_target_shortcircuit(g: Graph, targets: torch.Tensor,
                                         p: torch.Tensor, r: torch.Tensor,
                                         tgt_onehot: torch.Tensor):
    """Rows whose target has in-degree 0 get reserve = e_t, residue = 0
    (Backward_Search.java:46-49)."""
    is_shortcircuit = (g.in_deg.index_select(0, targets) == 0)[:, None]
    p = torch.where(is_shortcircuit, tgt_onehot, p)
    r = torch.where(is_shortcircuit, torch.zeros_like(r), r)
    return p, r
