"""Frontier-masked push sweeps, forward and backward — port of
``ppr_tpu/ops/push.py``.

* Forward push (Forward_Push.java:63-142): the reference's work queue, gated
  by ``r(v)/d_out(v) >= rmax``, is a frontier mask over the dense residue,
  held node-major ``[n_pad, B]``. A sweep settles every active node at once
  (reserve += alpha*r, the rest pushed to out-neighbors by
  ``spmv.push_out_t``); a dangling active node returns its
  ``(1-alpha)*r`` to the row's source (Forward_Push.java:101-115), and a
  dangling node is active whenever ``r > 0`` (the reference's ``r / 0 >=
  rmax`` is +inf). The fixpoint keeps
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
from .spmv import pull_out_norm, push_out_t

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


def _run_sweeps(step, p, r, max_sweeps: int):
    """Call ``step(p, r) -> (p, r, active_any)`` until a host check sees an
    empty frontier or ``max_sweeps`` sweeps ran; returns ``(p, r,
    sweeps_used)`` with the count of sweeps whose frontier was non-empty.
    The state may be a tensor or, on a mesh, parts of one."""
    used = 0
    for sweep in range(max_sweeps):
        p, r, active_any = step(p, r)
        used = used + active_any.to(torch.int32)
        if (sweep + 1) % CHECK_EVERY == 0 and not bool(active_any):
            break
    return p, r, int(used)


class ForwardGate:
    """A device's node-major node arrays for the forward frontier
    ``r/d >= rmax`` (a dangling node whenever ``r > 0``): out-degrees,
    the threshold ``rmax * d``, real nodes, dangling real nodes and their
    ids."""

    def __init__(self, g: Graph, rmax: float, device=None):
        deg = g.out_deg[:, None]
        live = (g.node_mask > 0)[:, None]
        if device is not None:
            deg, live = deg.to(device), live.to(device)
        self.deg = deg
        self.thresh = _f32(rmax) * deg.to(torch.float32)
        self.live = live
        self.dangling = (deg == 0) & live
        self.dang_ids = g.dang_ids.to(deg.device)


def forward_sweep(gates, p, r, src, push, alpha: float):
    """One forward push sweep over parts ``i`` that hold the same node-major
    residue ``r[i]`` on the device of ``gates[i]``: the frontier settles
    ``alpha`` of its residue, ``push([(1-alpha) a_i]) -> [pushed_i]``
    pushes the rest along the out-edges (``push_out_t`` on one device; on a
    mesh each part's edge chunk, then ``psum``), and each dangling node's
    share returns to its column's source (Forward_Push.java:85-141).
    Returns ``(p, r, active_any)`` with the parts' new state and part 0's
    "frontier non-empty"."""
    alpha_f = _f32(alpha)
    keep = float(np.float32(1.0) - np.float32(alpha))
    acts, dangs, p_out = [], [], []
    for gate, p_, r_ in zip(gates, p, r):
        active = (((gate.deg > 0) & (r_ >= gate.thresh))
                  | (gate.dangling & (r_ > 0))) & gate.live
        if not acts:
            active_any = active.any()
        a = torch.where(active, r_, 0.0)
        p_out.append(p_ + alpha_f * a)
        # dangling nodes push nothing (inverse degree 0, no out-edges):
        # their mass goes to the source below
        dangs.append(a.index_select(0, gate.dang_ids).sum(dim=0,
                                                          keepdim=True))
        acts.append(a)
    pushed = push([keep * a for a in acts])
    r_out = [r_ - a + pu + (keep * dm) * s
             for r_, a, pu, dm, s in zip(r, acts, pushed, dangs, src)]
    return p_out, r_out, active_any


def forward_push_sweeps(g: Graph, p: torch.Tensor, r: torch.Tensor,
                        src_onehot: torch.Tensor, rmax: float, alpha: float,
                        max_sweeps: int = 10_000):
    """Masked push sweeps until no node is active (or ``max_sweeps``).

    ``p``, ``r``, ``src_onehot``: f32 ``[B, n_pad]``. Returns ``(p, r,
    sweeps_used)``, ``p`` and ``r`` as ``[B, n_pad]`` views of the
    node-major state the sweeps ran on (:func:`forward_push_sweeps_t`).
    Restartable: calling again with a smaller ``rmax`` refines further."""
    p_t, r_t, used = forward_push_sweeps_t(
        g, p.T.contiguous(), r.T.contiguous(), src_onehot.T.contiguous(),
        rmax, alpha, max_sweeps)
    return p_t.T, r_t.T, used


def forward_push_sweeps_t(g: Graph, p_t: torch.Tensor, r_t: torch.Tensor,
                          src_t: torch.Tensor, rmax: float, alpha: float,
                          max_sweeps: int = 10_000):
    """:func:`forward_push_sweeps` on node-major ``[n_pad, B]`` state, the
    layout K3 gathers rows of: :func:`forward_sweep` on one part, pushed
    by ``push_out_t``, the sweep the mesh drop-in
    (``parallel/mesh_algos.py``) runs shard by shard."""
    gates = [ForwardGate(g, rmax)]

    def step(p_, r_):
        (p_,), (r_,), active_any = forward_sweep(
            gates, [p_], [r_], [src_t], lambda xs: [push_out_t(g, xs[0])],
            alpha)
        return p_, r_, active_any

    return _run_sweeps(step, p_t, r_t, max_sweeps)


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
