"""Alpha-terminated random walks — port of ``ppr_tpu/ops/walk.py``.

``W`` walkers advance in lockstep as int32 lanes instead of one loop per
walk (Monte_Carlo.random_walk, Monte_Carlo.java:60-94, and
random_walk_no_zero_hop, :96-133). Per step each active walker

* stops with probability alpha (a uniform draw ``u < alpha``; the stop test
  runs before the move, Monte_Carlo.java:76-78, so a walk may stop at its
  start node);
* otherwise moves to a uniformly chosen out-neighbor,
  ``indices[indptr[v] + floor(u' * d_v)]`` with ``u' = (u - alpha) / (1 -
  alpha)``, again uniform on [0, 1) given ``u >= alpha``
  (Monte_Carlo.java:84-85);
* at a dangling node (d_v == 0) resets to its start node and keeps walking
  (Monte_Carlo.java:87-90), so a walk from a dangling start returns the
  start (:70-72).

``no_zero_hop`` forces one hop before the first stop test (FORA
whole-graph's walks, Fora_Whole_Graph.java:134).

Randomness comes from the caller's ``torch.Generator``, on the graph's
device; the draws are not the JAX package's (threefry there, Philox here),
so the two packages agree in distribution, not walk by walk.

All of this is PyTorch ops, as XLA generated it on the TPU. The JAX loop
stops on ``any(active)`` on the device; here the host reads that flag once
every ``PHASE_STEPS`` steps (once a phase in :func:`weighted_walk_counts`).
A step with no active walker changes nothing; it only draws numbers.

On a weighted graph the move is Walker's alias method (``walk.py:60-63``):
the uniform picks a CSR slot as above, and a second uniform ``u2``, drawn
from the same generator at the same width right after ``u``, keeps the
slot's own target with probability ``alias_prob[slot]`` or moves to the
global slot ``alias_other[slot]``. Uniform graphs draw no ``u2``, so their
walks are the draws they were.
"""

from __future__ import annotations

import math

import torch

from ..graph.csr import LANES, Graph

#: steps between the host's reads of "any walker active", and the phase
#: length of :func:`weighted_walk_counts`
PHASE_STEPS = 16


def default_max_steps(alpha: float, tail: float = 1e-9) -> int:
    """Smallest L with (1-alpha)^L <= tail (survivor mass below ``tail``)."""
    return max(8, int(math.ceil(math.log(tail) / math.log1p(-alpha))))


def _uniform_neighbor(g: Graph, cur: torch.Tensor, u: torch.Tensor,
                      starts: torch.Tensor,
                      u2: torch.Tensor | None = None) -> torch.Tensor:
    """Next node of each walker: the out-neighbor that the uniform ``u``
    picks (on a weighted graph, through the alias tables with the second
    uniform ``u2``), or the walker's start where ``cur`` is dangling."""
    deg = g.out_deg.index_select(0, cur)
    # floor(u * d) clamped to d-1 guards the u ~= 1.0 edge case; the cast
    # truncates toward zero, as the JAX package's astype(int32)
    pick = torch.minimum((u * deg.to(torch.float32)).to(torch.int32),
                         deg - 1).clamp_min_(0)
    # a dangling last node has indptr == m, which is m_pad when m is a
    # multiple of 128: clamp so the gather stays in bounds (its value is
    # replaced by the start below)
    idx = (g.indptr.index_select(0, cur) + pick).clamp_max_(g.m_pad - 1)
    if g.alias_prob is not None:
        if u2 is None:
            raise ValueError("weighted sampling needs a second uniform")
        accept = u2 < g.alias_prob.index_select(0, idx)
        idx = torch.where(accept, idx, g.alias_other.index_select(0, idx))
    nxt = g.indices.index_select(0, idx)
    return torch.where(deg > 0, nxt, starts)


def _draws(g, width: int, generator, device):
    """``(u, u2)``: a step's uniforms, ``u2`` only on a weighted graph."""
    u = torch.rand(width, generator=generator, device=device)
    u2 = (torch.rand(width, generator=generator, device=device)
          if g.alias_prob is not None else None)
    return u, u2


def _first_hop(g, starts, generator):
    u, u2 = _draws(g, starts.shape[0], generator, starts.device)
    return _uniform_neighbor(g, starts, u, starts, u2)


def _step(g, cur, active, starts, generator, alpha: float):
    """One lockstep step: ``(cur, active)`` after the stop test and move."""
    u, u2 = _draws(g, cur.shape[0], generator, cur.device)
    go = active & (u >= alpha)
    u_move = (u - alpha) * (1.0 / (1.0 - alpha))
    nxt = _uniform_neighbor(g, cur, u_move, starts, u2)
    return torch.where(go, nxt, cur), go


def random_walks(g: Graph, starts: torch.Tensor,
                 generator: torch.Generator, alpha: float, *,
                 no_zero_hop: bool = False,
                 max_steps: int | None = None) -> torch.Tensor:
    """Stop node of each walker, int32 ``[W]``, for int32 ``starts``."""
    if max_steps is None:
        max_steps = default_max_steps(alpha)
    cur = _first_hop(g, starts, generator) if no_zero_hop else starts
    active = torch.ones(starts.shape[0], dtype=torch.bool,
                        device=starts.device)
    for step in range(max_steps):
        cur, active = _step(g, cur, active, starts, generator, alpha)
        if (step + 1) % PHASE_STEPS == 0 and not bool(active.any()):
            break
    return cur


def accumulate_stops(template: torch.Tensor, stops: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """``reserve[..., stop_j] += weight_j`` for every walker j, on every
    leading row of ``template [..., n_pad]`` (a copy)."""
    src = weights.to(template.dtype).expand(*template.shape[:-1],
                                            weights.shape[0])
    return template.index_add(template.dim() - 1, stops, src)


def weighted_walk_counts(g: Graph, starts: torch.Tensor, rows: torch.Tensor,
                         weights: torch.Tensor, generator: torch.Generator,
                         alpha: float, num_rows: int, *,
                         no_zero_hop: bool = False,
                         max_steps: int | None = None,
                         phase_steps: int = PHASE_STEPS,
                         compact_factor: int = 4,
                         deposit: torch.dtype = torch.float64
                         ) -> torch.Tensor:
    """f32 ``[num_rows, n_pad]``: walker j deposits ``weights[j]`` at its
    stop node in row ``rows[j]``.

    The walk of :func:`random_walks`, in phases of ``phase_steps`` steps.
    After a phase about (1-alpha)^phase_steps of the walkers are still
    active (7.4% at 16 steps), so they are compacted, by a stable sort on
    the active flag, into a lane array ``compact_factor`` times narrower
    (never below ``LANES``); every other walker deposits when its phase
    ends. The narrower width is a hard cap: an active walker beyond it
    (Chernoff-negligible at a 25% cap) deposits at its current node. A
    walker still active after ``max_steps`` deposits where it is. The host
    reads "any walker active" once a phase and stops at the first phase
    that ends with none.

    The deposit is one flat ``index_add_`` at ``row * n_pad + node``, into
    f64 counts returned as f32. The JAX package adds in f32 (``deposit=
    torch.float32`` here, which only ``mc_deposit_torch.py`` asks for),
    where each add of a small weight rounds to the bin's ulp, so a row
    that takes millions of deposits (Monte-Carlo at a small eps) loses a
    share of its mass. On the card the adds are atomics, so the order of a node's
    deposits, and the last bits of its sum, vary from run to run.
    """
    if max_steps is None:
        max_steps = default_max_steps(alpha)
    dev = starts.device
    n_pad = g.n_pad
    counts = torch.zeros(num_rows * n_pad, dtype=deposit, device=dev)
    flat = rows.to(torch.int64) * n_pad
    weights = weights.to(deposit)
    cur = _first_hop(g, starts, generator) if no_zero_hop else starts
    active = torch.ones(starts.shape[0], dtype=torch.bool, device=dev)
    steps_done = 0
    while True:
        steps = min(phase_steps, max_steps - steps_done)
        for _ in range(steps):
            cur, active = _step(g, cur, active, starts, generator, alpha)
        steps_done += steps
        width = cur.shape[0]
        next_width = max(LANES, width // compact_factor)
        if steps_done >= max_steps or not bool(active.any()):
            # everyone deposits where they are
            counts.index_add_(0, flat + cur, weights)
            break
        if next_width >= width:
            continue                # already at the minimum width
        order = torch.argsort((~active).to(torch.uint8),
                              stable=True)[:next_width]
        kept = torch.zeros(width, dtype=torch.bool, device=dev)
        kept[order] = True
        counts.index_add_(0, flat + cur,
                          torch.where(kept & active, 0.0, weights))
        active = active.index_select(0, order)
        cur = cur.index_select(0, order)
        flat = flat.index_select(0, order)
        starts = starts.index_select(0, order)
        weights = torch.where(active, weights.index_select(0, order), 0.0)
    return counts.view(num_rows, n_pad).to(torch.float32)


def expand_walkers(omega_per_node: torch.Tensor, cap: int):
    """Assign ``cap`` walker slots to entries: entry i gets
    ``omega_per_node[i]`` of them (the FORA walk phases launch ``omega_i``
    walks from every residual node, Fora_Whole_Graph.java:119-140,
    Fora_Topk.java:155-168). Walker j belongs to the entry whose
    cumulative-sum interval holds j. Returns ``(starts, valid)``: int64
    entry ids ``[cap]`` and the mask of slots below the total.

    The cumulative sum is int64 here (int32 in the JAX package); the
    callers still keep each call's total below 2^31, as there
    (``models/fora._walk_contrib_chunked``)."""
    csum = torch.cumsum(omega_per_node, 0)
    slots = torch.arange(cap, dtype=csum.dtype, device=csum.device)
    starts = torch.searchsorted(csum, slots, right=True)
    valid = slots < csum[-1]
    return starts.clamp_max_(omega_per_node.shape[0] - 1), valid
