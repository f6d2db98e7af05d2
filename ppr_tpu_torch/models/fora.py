"""FORA, whole-graph and top-k — port of ``ppr_tpu/models/fora.py``.

* Whole-graph (Fora_Whole_Graph.java:82-146): rounds of forward push with
  ``rmax`` halved each round while the push time a query stays below the
  predicted completion time (:75-103); then the residue is completed,
  either by the reference's walks (from every residual node v_i,
  ``omega_i = ceil(r_i' * omega)`` no-zero-hop walks, each adding
  ``r_i'/omega_i``, after ``alpha*r_i`` goes to v_i's reserve, :119-140)
  or by deterministic propagation of the residue
  (:func:`residual_propagate`). ``rmax0 = eps*sqrt(delta/(3 m
  ln(2/pfail)))/(1-alpha)``, ``omega = (eps+2)*ln(2/pfail)/eps^2/delta``
  (:86-87); delta = pfail = 1/n (Algo_Conf.java:47-49).

* Top-k (Fora_Topk.java:102-184): eps' = eps/2 (:110); delta anneals from
  1/k down to 1/n by /4 a round (:178). With ``push="reference"`` each
  round runs the incremental forward push at ``rmax = eps'*sqrt(delta/(3
  m ln(2/pfail))) * 3*sqrt(m*rmax)`` (:124, :133, the reference's
  schedule), then completes the residue by walks (``omega_i = ceil(r_i *
  W)``, ``W = omega * rsum * (1-alpha)``, each walk adding ``r_i/omega_i``,
  :148-168) or by :func:`residual_propagate`, and stops once the k-th
  reserve is >= (1+eps')*delta (:173-176). A round's completion is not
  folded back into the push state (:142-168). ``push="none"`` skips the
  pushes: one loop of synchronous propagation sweeps
  (:func:`annealed_topk_propagate`) anneals delta whenever the residue
  settles below ``eps'*delta``; no sampling, so the result is
  deterministic. ``push="auto"``, the default, skips the pushes exactly
  when the cost model picks propagation for the completion.

The cost model (:class:`_ForaCostModel`) prices a walk and an edge of a
propagation sweep; its constants are the JAX package's on the CPU and
measured on the H100 by :mod:`~..utils.calibrate` on the card.

The loop state of the propagation loops (``delta``, ``finished``, the
sweep count) lives on the device. A sweep after ``finished`` is set
changes nothing, and the host reads ``finished`` once every
``CHECK_EVERY`` sweeps, so the loop does not wait on the card every sweep
and still stops on exactly the sweep of the JAX package's
``lax.while_loop``. Unlike that loop, the port evaluates the stopping
count on every sweep, settled or not: in the annealed loop it is a
compare in the pass that updates ``p`` (:mod:`~..ops.sweep_pass`), on
values that pass holds anyway.

``early_exit=True`` adds the JAX package's set-stability certificate,
tested every ``EARLY_CHECK_EVERY`` sweeps: once ``kth(p) > (k+1)th(p) +
rsum`` on a row, no node outside the row's top k can enter it (the reserve
only grows, and no node gains more than the remaining residue), so the id
set is final; values are lower bounds.

Cohort streaming (:meth:`ForaTopk.compute_topk_ids_cohorts`) anneals each
row on its own schedule (:func:`annealed_topk_propagate_perrow`) and hands
back rows as they retire, down a ladder of pow2 widths: a stage at width W
runs until at most W/2 rows are live, then the stragglers go on at the
pow2 width of their count. The ladder is semantics here, not a shape
cache: where a stage stops decides which rows share a cohort, and with
``early_exit`` on which sweeps a row's certificate is tested.

The walk pools are exactly the walks asked for: the JAX package's pow2
pool buckets, traced row offsets and the walk-cap high-water mark
(``PPR_TPU_WALK_CAP_FLOOR``) exist to share remote XLA compiles, and are
left out.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from ..device import synchronize
from ..graph.csr import Graph
from ..ops import sweep_pass
from ..ops.hub_split import (HubSplit, push_scaled_hybrid_t,
                             resolve_hub_split)
from ..ops.push import (apply_dangling_source_shortcircuit, forward_push_init,
                        forward_push_sweeps)
from ..ops.spmv import (_safe_inv_deg, gather_segment_sum,
                        push_out_chunked_t, push_out_t)
from ..ops.walk import expand_walkers, weighted_walk_counts
from ..utils import timer
from .base import PPRAlgorithm, PreprocessingMixin

#: total annealed-sweep budget of a top-k query, shared by the batch loop
#: and the cohort ladder (as the JAX package)
MAX_TOPK_SWEEPS = 600
#: sweeps between the host's reads of the device-side ``finished`` flag
CHECK_EVERY = 8
#: sweeps between tests of the early-exit certificate (the JAX package's
#: ``early_check_every``)
EARLY_CHECK_EVERY = 8
#: the walks of one call of :func:`_walk_contrib`: the chunked walk phase
#: keeps each call's total below this, and so inside int32 (the JAX
#: package's cumulative sum) and one walker pool
_WALK_CHUNK_BUDGET = 1 << 28
#: ``(n_pad, m_pad, dense, device, B, alpha)`` of every push that
#: :class:`ForaWholeGraph` has warmed in this process (see there)
_WARMED_PUSH_SHAPES: set = set()


def _default_cost_constants(device) -> tuple[float, float, bool, float]:
    """``(walk_ns_per_walk, spmv_ns_per_edge, batch_amortized,
    d2h_bytes_per_s)`` for graphs on ``device``.

    The CPU's are the JAX package's CPU constants (400 ns a walk, the
    reference's own, Fora_Whole_Graph.java:35; 4 ns an edge, paid by every
    row of a batch) and 4 GB/s to the host, so that the port picks the JAX
    package's path for the same inputs. The card's were measured on the
    H100 by :func:`~..utils.calibrate.measure` (``chip_smoke.py``'s
    ``[calibrate]``); a sparse sweep there costs the batch once, whatever
    its width (``batch_amortized``)."""
    if torch.device(device).type == "cpu":
        return 400.0, 4.0, False, 4e9
    # calibrate.measure's defaults on synthetic_powerlaw(65536, 16,
    # seed=42), the median of three (chip_smoke.py [calibrate]; NVIDIA H100
    # 80GB HBM3, power limit 700.00 W)
    return 299.3, 1.552, True, 5.75e9


def _completion_iters(rsum: float, target: float, alpha: float) -> int:
    """Propagation sweeps that take residue mass ``rsum`` below
    ``target``."""
    if rsum <= target or rsum <= 0:
        return 0
    return int(math.ceil(math.log(target / rsum) / math.log1p(-alpha)))


def _pad_sources(sources, min_b: int = 8):
    """Pad a source batch to >= 8 rows with node 0, as the JAX package does.

    The annealing is batch-global, so the padding rows can change the sweep
    a small batch stops on; the port keeps them for parity with the JAX
    results. Callers slice results back to the true batch."""
    sources = np.asarray(sources)
    b = len(sources)
    if b >= min_b:
        return sources, b
    return np.concatenate(
        [sources,
         np.zeros(min_b - b, sources.dtype if sources.size else np.int32)]
    ), b


def _pow2_width(b: int, lo: int = 8) -> int:
    """Cohort width of ``b`` rows: the pow2 at or above it, at least 8."""
    w = lo
    while w < b:
        w <<= 1
    return w


def _loop_constants(alpha: float, eps: float):
    """The JAX loops' f32 constants ``alpha``, ``1 - alpha``, ``eps`` and
    ``1 + eps``, held as Python floats so that the ``[n_pad, B]`` passes
    take them as scalar arguments."""
    f32 = np.float32
    return (float(f32(alpha)), float(f32(1.0) - f32(alpha)), float(f32(eps)),
            float(f32(1.0) + f32(eps)))


def _push_residue(g: Graph, r_t: torch.Tensor, src_t: torch.Tensor,
                  keep: float, hs: HubSplit | None, num_chunks: int):
    """One sweep's new residue: ``(1-alpha) r`` pushed along the out-edges
    (the push :func:`_scaled_push` picks), the dangling rows' share
    returned to each column's source."""
    rem = r_t * keep
    dang_mass = rem.index_select(0, g.dang_ids).sum(dim=0, keepdim=True)
    inv_deg, push = _scaled_push(g, hs, num_chunks)
    pushed = push(rem if inv_deg is None else rem * inv_deg[:, None], None)
    return pushed.addcmul_(dang_mass, src_t)


def _set_stable(p_t: torch.Tensor, r_t: torch.Tensor, k: int) -> torch.Tensor:
    """Per column of the node-major state: the top-k id set is final,
    ``kth(p) > (k+1)th(p) + rsum`` (``ppr_tpu/models/fora.py:367-373``).
    Boundary ties never certify (the gap is strict)."""
    kk = min(k + 1, p_t.shape[0])
    if kk <= k:                      # k >= n_pad: every node is in the set
        return torch.ones(p_t.shape[1], dtype=torch.bool, device=p_t.device)
    vals = torch.topk(p_t, kk, dim=0).values               # [k+1, B]
    return vals[k - 1] > vals[kk - 1] + r_t.sum(dim=0)


def residual_propagate(
    g: Graph,
    p: torch.Tensor,           # f32[B, n_pad]
    r: torch.Tensor,           # f32[B, n_pad]
    src_onehot: torch.Tensor,  # f32[B, n_pad]
    target: float,             # stop once every row's residue sum <= target
    alpha: float,
    max_iters: int = 400,
    hs: HubSplit | None = None,
    num_chunks: int = 1,
):
    """Deterministic completion of the residue: propagation sweeps (``p +=
    alpha*r``; ``r = push((1-alpha) r)`` with the dangling rows' share
    back to each column's source, the Power_Method.java:55-100 step)
    while the largest row sum of ``r`` is above ``target``, at most
    ``max_iters`` sweeps. This computes exactly what FORA's walks estimate,
    ``sum_i r_i * pi(v_i, .)``, up to the remaining residue. Returns ``(p,
    r, iters)``, ``iters`` an int.

    The JAX loop tests its condition before every sweep; here the test
    runs on the device each sweep, a sweep whose test failed changes
    nothing, and the host reads it every ``CHECK_EVERY`` sweeps, so the
    loop stops on the JAX loop's sweep."""
    alpha_f, keep, _, _ = _loop_constants(alpha, 0.0)
    target = float(np.float32(target))
    p_t = p.T.contiguous()
    r_t = r.T.contiguous()
    src_t = src_onehot.T.contiguous()
    it = torch.zeros((), dtype=torch.int32, device=p.device)
    live = r_t.sum(dim=0).max() > target
    for sweep in range(max_iters):
        if sweep % CHECK_EVERY == 0 and not bool(live):
            break
        # a sweep that is not live adds r * 0: p is unchanged bit for bit
        p_t = torch.addcmul(p_t, r_t, live * alpha_f)
        r_new = _push_residue(g, r_t, src_t, keep, hs, num_chunks)
        r_t = torch.where(live, r_new, r_t)
        it = it + live.to(torch.int32)
        live = r_t.sum(dim=0).max() > target
    return p_t.T, r_t.T, int(it)


def _scaled_push(g: Graph, hs: HubSplit | None, num_chunks: int):
    """The sweep's push of ``r * keep``, split at its scaling: ``(inv_deg,
    push)``, where ``push(scaled, rhs)`` pushes ``scaled = (r * keep) *
    inv_deg[:, None]``, or ``r * keep`` itself where ``inv_deg`` is None (a
    weighted graph's coefficients, the dense operator), and ``rhs`` is its
    bf16 copy for a bf16 hub product, or None. The one choice of the push
    for :func:`_push_residue` and the annealed loop, with the operators of
    ``push_out_t``, ``push_out_chunked_t`` and ``push_out_hybrid_t``."""
    if hs is not None:
        return _safe_inv_deg(g.out_deg), lambda s, rhs: push_scaled_hybrid_t(
            hs, s, rhs, num_chunks=num_chunks)
    if g.weighted or (num_chunks == 1 and g.has_dense):
        return None, lambda s, rhs: (
            push_out_chunked_t(g, s, num_chunks=num_chunks) if num_chunks > 1
            else push_out_t(g, s))
    return _safe_inv_deg(g.out_deg), lambda s, rhs: gather_segment_sum(
        s, g.edge_src_bydst, g.bydst_ptr, num_chunks)


def annealed_topk_propagate(
    g: Graph,
    p: torch.Tensor,           # f32[B, n_pad]
    r: torch.Tensor,           # f32[B, n_pad]
    src_onehot: torch.Tensor,  # f32[B, n_pad]
    eps: float,                # eps' = eps/2 already applied
    delta0: float,
    min_delta: float,
    k: int,
    alpha: float,
    hs: HubSplit | None = None,
    num_chunks: int = 1,
    early_exit: bool = False,
):
    """The whole FORA top-k delta-annealing loop; returns ``(p, r,
    iters)`` with ``iters`` a device int32 scalar.

    Per sweep: ``p += alpha*r``; ``r = push((1-alpha) r) + dangling mass
    at the source``. The stopping rule "k-th reserve >= (1+eps')*delta" is
    the count ``#{v: p_v >= (1+eps')*delta} >= k`` on every row, tested on
    the sweeps where ``max_row sum(r) <= eps'*delta`` (settled); a settled
    sweep that does not stop anneals delta by /4, down to ``min_delta``,
    and a settled sweep at ``min_delta`` stops. ``early_exit`` also stops
    once every row's certificate holds (:func:`_set_stable`).

    A sweep's passes over the state are :mod:`~..ops.sweep_pass`'s: the
    pre pass (the update of ``p``, the push's scaled operand and its bf16
    copy, the stopping count), the push, the post pass (the dangling mass
    at each column's source, the new residue, its column sums) and the
    finalize (the loop's device scalars). On a card they are its kernels;
    on the CPU their plain versions, the loop's operators before the
    fusion, bit for bit.

    While a ``torch.profiler`` session runs it records each read of
    ``finished`` as the span ``loop.check``, and counts ``loop.sweeps``
    (the sweeps launched, the frozen ones before the stopping read
    included), ``loop.fused_sweeps`` (the pre pass kernel's
    launches over the call: every sweep on a card, 0 on the CPU) and ``loop.edge_cols`` (the sweeps times
    the tail's edges, or the graph's without a hub split, times the
    columns): the work the sparse tail's kernel did; ``loop.state_elems``
    (the sweeps times ``n_pad`` times the columns: the elements each pass
    over the state touches), ``loop.bf16_copy_elems`` (the same where
    the pre pass writes the bf16 copy, else 0) and ``loop.dangling_cols``
    (the sweeps times the dangling rows times the columns: the rows the
    dangling mass gathers). Each sweep's dangling mass is the span
    ``loop.dangling_mass``, which names its operators' kernels in the
    device trace. No count reads the card."""
    alpha_f, keep, eps_f, thresh_scale = _loop_constants(alpha, eps)
    # node-major state [n_pad, B]: the per-edge gather reads [B]-wide rows
    p_t = p.T.contiguous()
    r_t = r.T.contiguous()
    src = src_onehot.argmax(dim=1).to(torch.int32)   # each column's source
    inv_deg, push = _scaled_push(g, hs, num_chunks)
    bf16 = hs is not None and hs.dtype == torch.bfloat16
    state = sweep_pass.LoopState.start(delta0, p.device)
    launched = sweep_pass.pre_launches
    n_dang = g.dang_ids.numel()

    for sweep in range(MAX_TOPK_SWEEPS):
        p_t, scaled, rhs, counts = sweep_pass.sweep_pre(
            p_t, r_t, state, inv_deg, alpha=alpha_f, keep=keep,
            thresh_scale=thresh_scale, bf16=bf16)
        dang = None
        if n_dang:
            with timer.span("loop.dangling_mass"):
                dang = (r_t.index_select(0, g.dang_ids) * keep).sum(dim=0)
        r_t, sums = sweep_pass.sweep_post(push(scaled, rhs), r_t, src, dang,
                                          state)
        # while the loop is live, ``sweep`` is the JAX loop's ``it``; after
        # ``finished`` a certificate changes nothing
        stable = (_set_stable(p_t, r_t, k).all() if early_exit
                  and (sweep + 1) % EARLY_CHECK_EVERY == 0 else None)
        sweep_pass.sweep_finalize(state, counts, sums, k=k, eps=eps_f,
                                  min_delta=min_delta, stable=stable)
        if (sweep + 1) % CHECK_EVERY == 0:
            with timer.span("loop.check"):
                stop = bool(state.finished)
            if stop:
                break
    if timer.recording():
        tail = hs.m_tail if hs is not None else g.m
        n_pad, cols = p_t.shape
        timer.count("loop.sweeps", sweep + 1)
        timer.count("loop.fused_sweeps",
                    sweep_pass.pre_launches - launched)
        timer.count("loop.edge_cols", (sweep + 1) * tail * cols)
        timer.count("loop.state_elems", (sweep + 1) * n_pad * cols)
        timer.count("loop.bf16_copy_elems",
                    (sweep + 1) * n_pad * cols if bf16 else 0)
        timer.count("loop.dangling_cols", (sweep + 1) * n_dang * cols)
    return p_t.T, r_t.T, state.it


def annealed_topk_propagate_perrow(
    g: Graph,
    p: torch.Tensor,           # f32[B, n_pad]
    r: torch.Tensor,           # f32[B, n_pad]
    src_onehot: torch.Tensor,  # f32[B, n_pad]
    eps: float,                # eps' = eps/2 already applied
    delta: torch.Tensor,       # f32[B]: each row's annealing state
    finished: torch.Tensor,    # bool[B]: rows already retired
    live_floor: int,           # the stage ends once live rows <= live_floor
    min_delta: float,
    k: int,
    alpha: float,
    max_iters: int = MAX_TOPK_SWEEPS,
    hs: HubSplit | None = None,
    num_chunks: int = 1,
    early_exit: bool = False,
):
    """One stage of cohort serving: the annealed loop with a schedule per
    row (the reference's single-query loop, Fora_Topk.java:123-179, row by
    row). A row's delta anneals when ITS residue settles, and the row
    retires when its own rule fires; a retired row is frozen, so its result
    is the one a run of that row alone gives. The stage ends once at most
    ``live_floor`` rows are live, or after ``max_iters`` sweeps. Returns
    ``(p, r, delta, finished, iters)``, ``iters`` a device int32 scalar;
    the state carries on into the next stage.

    The JAX loop tests ``live > live_floor`` before every sweep; the host
    here reads it every ``CHECK_EVERY`` sweeps. ``stage_done`` holds that
    test on the device, and every sweep after it is an exact no-op for all
    rows: the returned state and ``iters`` are the JAX loop's. The
    certificate is tested on the stage's own sweeps ``(it + 1) %
    EARLY_CHECK_EVERY == 0``, ``it`` counting from 0 in every stage."""
    alpha_f, keep, eps_f, thresh_scale = _loop_constants(alpha, eps)
    p_t = p.T.contiguous()
    r_t = r.T.contiguous()
    src_t = src_onehot.T.contiguous()
    it = torch.zeros((), dtype=torch.int32, device=p.device)

    for sweep in range(max_iters):
        stage_done = (~finished).sum() <= live_floor
        frozen = finished | stage_done                       # [B]
        p_t = torch.addcmul(p_t, r_t, ~frozen * alpha_f)
        r_new = _push_residue(g, r_t, src_t, keep, hs, num_chunks)
        r_t = torch.where(frozen, r_t, r_new)

        settled = (r_t.sum(dim=0) <= eps_f * delta) & ~frozen
        done = settled & ((p_t >= thresh_scale * delta).sum(dim=0) >= k)
        # while the stage is live, ``sweep`` is the JAX loop's ``it``
        if early_exit and (sweep + 1) % EARLY_CHECK_EVERY == 0:
            done = done | (_set_stable(p_t, r_t, k) & ~stage_done)
        finished = finished | done | (settled & (delta <= min_delta))
        delta = torch.where(settled & ~finished,
                            torch.clamp_min(delta / 4.0, min_delta), delta)
        it = it + (~stage_done).to(torch.int32)
        if (sweep + 1) % CHECK_EVERY == 0 and \
                bool((~finished).sum() <= live_floor):
            break
    return p_t.T, r_t.T, delta, finished, it


def _cohort_compact(p, r, src_onehot, delta, sources, sel):
    """The straggler rows ``sel`` of the cohort state, for the next stage."""
    return tuple(x.index_select(0, sel)
                 for x in (p, r, src_onehot, delta, sources))


def topk_kcap(k: int, n_pad: int, kcap: int | None = None) -> int:
    """The top-K window the serving path selects on the device: ``kcap``
    when given, else ``max(4k, k+32)``, room for the reference's tie
    expansion; at most ``n_pad``."""
    return min(int(kcap) if kcap else max(4 * k, k + 32), n_pad)


def _device_topk_epilogue(g: Graph, sources: torch.Tensor, p: torch.Tensor,
                          src_onehot: torch.Tensor, kcap: int):
    """Dangling-source short-circuit + top-(kcap) selection on the device;
    only ``[B, kcap]`` values and ids go to the host. kcap > k leaves room
    for the reference's tie expansion."""
    deg_src = g.out_deg.index_select(0, sources)[:, None]
    p = torch.where(deg_src == 0, src_onehot, p)
    return torch.topk(p, kcap, dim=-1)


def _walk_contrib(g: Graph, om: torch.Tensor, w: torch.Tensor,
                  generator: torch.Generator, alpha: float,
                  no_zero_hop: bool) -> torch.Tensor:
    """``om[b, v]`` walks from node v in row b, each depositing ``w[b, v]``
    at its stop node in row b: f32 ``[B, n_pad]``. The walker pool is
    exactly ``sum(om)``."""
    b, n_pad = om.shape
    total = int(om.sum())
    slots, _ = expand_walkers(om.reshape(-1), total)  # slot -> (row, node)
    rows = torch.div(slots, n_pad, rounding_mode="floor")
    starts = (slots - rows * n_pad).to(torch.int32)
    return weighted_walk_counts(
        g, starts, rows, w.reshape(-1).index_select(0, slots), generator,
        alpha, num_rows=b, no_zero_hop=no_zero_hop)


def _walk_contrib_chunked(g: Graph, om: torch.Tensor, w: torch.Tensor,
                          generator: torch.Generator, alpha: float,
                          no_zero_hop: bool) -> torch.Tensor:
    """:func:`_walk_contrib` with each call's walk total below
    ``_WALK_CHUNK_BUDGET``.

    The row totals are estimated from f32 row sums (a magnitude, for the
    split decisions only). When the estimate exceeds the budget, rows go in
    consecutive groups whose estimate fits (with a 1% margin), and a group
    whose single rows are too large in ``passes`` integer parts that sum
    exactly to ``om``: each walk keeps its weight, so the passes partition
    the same walks. Groups and passes hold exactly their rows; the JAX
    package's pow2 group heights and traced offsets are left out."""
    b = om.shape[0]
    row_est = om.to(torch.float32).sum(dim=-1).cpu().numpy().astype(
        np.float64)
    if float(row_est.sum()) <= _WALK_CHUNK_BUDGET:
        if int(om.sum()) <= 0:
            return torch.zeros_like(w)
        return _walk_contrib(g, om, w, generator, alpha, no_zero_hop)
    out = torch.zeros_like(w)
    margin = 1.01
    lo = 0
    while lo < b:
        hi = lo + 1
        acc = row_est[lo] * margin
        while hi < b and acc + row_est[hi] * margin <= _WALK_CHUNK_BUDGET:
            acc += row_est[hi] * margin
            hi += 1
        passes = max(1, int(math.ceil(
            row_est[lo:hi].sum() * margin / _WALK_CHUNK_BUDGET)))
        om_g = om[lo:hi]
        for j in range(passes):
            om_j = om_g // passes + (om_g % passes > j).to(om_g.dtype)
            if int(om_j.sum()) > 0:
                out[lo:hi] += _walk_contrib(g, om_j, w[lo:hi], generator,
                                            alpha, no_zero_hop)
        lo = hi
    return out


def _kth_over_support(p: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the k-th largest value, or 0.0 when fewer than k values
    are positive (the reference's null k-th reserve, Fora_Topk.java:
    171-172; it also covers k > n, so an invalid k never stops the
    annealing early)."""
    kth = torch.topk(p, min(k, p.shape[-1]), dim=-1).values[..., -1]
    support = (p > 0).sum(dim=-1)
    return torch.where(support >= k, kth, torch.zeros_like(kth))


def _whole_graph_walk_setup(r1: torch.Tensor, omega: float):
    """``omega_i = ceil(r_i * omega)`` walks from each residual node, each
    worth ``r_i / omega_i``: whole-graph's walks with ``r1 = (1-alpha) r``
    (Fora_Whole_Graph.java:119-140), and a top-k round's with ``r1 = r``
    and ``omega * rsum * (1-alpha)`` walks (Fora_Topk.java:148-168)."""
    om = torch.where(r1 > 0, torch.ceil(r1 * float(np.float32(omega))),
                     0.0).to(torch.int32)
    w = torch.where(om > 0, r1 / om.clamp_min(1).to(torch.float32), 0.0)
    return om, w


class _ForaCostModel:
    """The push / walk / propagation balance of both FORA algorithms.

    Its constants come from :func:`_default_cost_constants` for the
    graph's device; :meth:`calibrate` measures and installs them for this
    graph (:mod:`~..utils.calibrate`)."""

    hub_split: HubSplit | None = None
    #: the CPU's budget for the per-edge gather intermediate ``[m_pad, B]``
    spmv_intermediate_budget = 2 << 30
    #: the same budget for the hub-split tail
    hybrid_tail_budget = 6 << 30
    #: set by ``PreprocessingMixin`` while a preprocessing sweep runs: the
    #: completion choice then prices the transfer of each row's entries
    _in_preprocessing = False

    def _init_cost_constants(self) -> None:
        (self.avg_rand_walk_time_ns, self.spmv_ns_per_edge,
         self.spmv_batch_amortized, self.d2h_bytes_per_s) = \
            _default_cost_constants(self.graph.device)

    def _num_chunks(self, batch: int) -> int:
        """Edge slices that keep the CPU's per-edge gather intermediate
        ``[m, B]`` within budget; 1 on the card, where K3 writes none."""
        if self.graph.device.type != "cpu":
            return 1
        if self.hub_split is not None:
            m_eff = int(self.hub_split.tail_src.shape[0])
            budget = self.hybrid_tail_budget
        else:
            m_eff = self.graph.m_pad
            budget = self.spmv_intermediate_budget
        bytes_ = m_eff * max(batch, 1) * 4
        return max(1, -(-bytes_ // budget))

    def enable_hub_split(self, num_hubs: int | str = "auto",
                         dtype=None) -> None:
        """Use the dense-hub hybrid push with ``num_hubs`` hubs, by default
        the automatic count (:func:`~..ops.hub_split.auto_num_hubs`), or
        none where no node passes its threshold
        (:func:`~..ops.hub_split.resolve_hub_split`); the hub product is
        f32 unless ``dtype=torch.bfloat16``."""
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.hub_split = resolve_hub_split(self.graph, num_hubs, **kwargs)

    def calibrate(self, **kwargs):
        """Measure the walk, sweep and transfer costs on this graph and
        device and install them; returns the constants."""
        from ..utils import calibrate as _cal

        constants = _cal.measure(self.graph, alpha=self.alpha, **kwargs)
        _cal.apply(self, constants)
        return constants

    def _spmv_completion_ns(self, rsum: float, target: float,
                            batch: int) -> float:
        """Estimated cost a query of completing residue ``rsum`` down to
        ``target`` by propagation."""
        iters = _completion_iters(rsum, target, self.alpha)
        per_batch = iters * self.spmv_ns_per_edge * max(self.graph.m, 1)
        return per_batch / max(batch, 1) if self.spmv_batch_amortized \
            else per_batch

    def _d2h_rate(self) -> float:
        return float(self.d2h_bytes_per_s)

    def _completion_costs(self, omega: float, rsum: float, target: float,
                          batch: int = 1) -> tuple[float, float]:
        """The cost model's ``(walk_ns, spmv_ns)`` a query of completing
        residue ``rsum`` by walks and by propagation."""
        walk_cost = self.avg_rand_walk_time_ns * omega * rsum
        spmv_cost = self._spmv_completion_ns(rsum, target, batch)
        if self._in_preprocessing:
            # the all-pair sweep ships each row's positive entries to the
            # host: propagation makes nearly every reachable entry positive
            # (~n a row), while the walks' support is bounded by their count
            per_entry_ns = 8 * 1e9 / self._d2h_rate()
            spmv_cost += self.graph.n * per_entry_ns
            walk_cost += min(float(self.graph.n), omega * rsum) * per_entry_ns
        return walk_cost, spmv_cost

    def _use_spmv(self, omega: float, rsum: float, target: float,
                  batch: int = 1) -> bool:
        """Complete by propagation (True) or by walks: ``completion`` when
        it is not ``"auto"``, else the cheaper by the cost model."""
        if self.completion != "auto":
            return self.completion == "spmv"
        walk_cost, spmv_cost = self._completion_costs(omega, rsum, target,
                                                      batch)
        return spmv_cost < walk_cost


class ForaWholeGraph(PreprocessingMixin, _ForaCostModel, PPRAlgorithm):
    name = "FORA"
    prep_dirname = "FORA_ppr_results"

    def __init__(self, dataset, alpha: float, *, delta: float | None = None,
                 pfail: float | None = None, seed: int = 0,
                 max_push_rounds: int = 30, fresh_rounds: bool = False,
                 completion: str = "auto"):
        super().__init__(dataset, alpha, seed=seed)
        n = dataset.graph.n
        self.delta = delta if delta is not None else 1.0 / n
        self.pfail = pfail if pfail is not None else 1.0 / n
        self.max_push_rounds = max_push_rounds
        #: residue completion: "walks" (the reference's estimator,
        #: Fora_Whole_Graph.java:119-140), "spmv" (deterministic
        #: propagation) or "auto" (the cost model)
        self.completion = completion
        self._init_cost_constants()
        #: True pushes each round afresh from r = e_s, as the reference
        #: (Fora_Whole_Graph.java:94-100); False continues from the last
        #: round's state, which reaches an equivalent fixpoint (push is
        #: confluent) with less work
        self.fresh_rounds = fresh_rounds
        #: push rounds of the last call, and their time a query (ns)
        self.last_rounds: int | None = None
        self.last_push_ns: float | None = None

    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        if len(sources) == 0:
            return np.zeros((0, self.graph.n_pad), np.float32)
        p = self.compute_whole_graph_device(sources, param)
        return p.cpu().numpy()[: len(sources)]

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        """Device reserve ``[B_pad, n_pad]``; rows past ``len(sources)``
        are padding."""
        eps = float(param)
        g = self.graph
        sources, _ = _pad_sources(sources)
        m = max(g.m, 1)
        ln_term = math.log(2.0 / self.pfail)
        rmax = eps * math.sqrt(self.delta / 3.0 / m / ln_term) \
            / (1.0 - self.alpha)
        omega = (eps + 2.0) * ln_term / eps / eps / self.delta
        sources_t = torch.as_tensor(sources, dtype=torch.int32,
                                    device=g.device)
        b = len(sources)

        # --- adaptive push rounds (Fora_Whole_Graph.java:93-103) ---
        p, r, src_onehot = forward_push_init(g, sources_t)
        # one untimed push a (graph, B) and process: the first sparse push
        # of a process builds the kernels with nvcc, and the first call at
        # a new B grows the caching allocator; inside the timed rounds
        # either would make push_ns huge and cut the rounds to one
        warm_key = (g.n_pad, g.m_pad, g.has_dense, str(g.device), b,
                    self.alpha)
        if warm_key not in _WARMED_PUSH_SHAPES:
            forward_push_sweeps(g, p, r, src_onehot, rmax, self.alpha)
            synchronize(g.device)
            _WARMED_PUSH_SHAPES.add(warm_key)
        rsum_local = 1.0
        push_ns = 0.0
        rounds = 0
        target = eps * self.delta
        while (push_ns < min(
                self.avg_rand_walk_time_ns * rsum_local * omega,
                self._spmv_completion_ns(rsum_local, target, b))
               and rounds < self.max_push_rounds):
            t0 = time.perf_counter_ns()
            if rounds and self.fresh_rounds:
                p, r, src_onehot = forward_push_init(g, sources_t)
            p, r, _ = forward_push_sweeps(g, p, r, src_onehot, rmax,
                                          self.alpha)
            synchronize(g.device)
            push_ns += (time.perf_counter_ns() - t0) / b   # a query
            rsum_local = float(r.sum(dim=-1).cpu().numpy().mean()) \
                * (1.0 - self.alpha)
            rmax /= 2.0
            rounds += 1
        self.last_rounds, self.last_push_ns = rounds, push_ns

        # --- completion: eps*delta keeps each node's truncation error
        # within FORA's eps*pi bound for every pi >= delta ---
        rsum_now = float(r.sum(dim=-1).max())
        if self._use_spmv(omega, rsum_now, target, b):
            p, r, _ = residual_propagate(
                g, p, r, src_onehot, target, self.alpha, hs=self.hub_split,
                num_chunks=self._num_chunks(b))
        else:
            # the reference's estimator: residual-weighted no-zero-hop
            # walks (Fora_Whole_Graph.java:119-140)
            r1 = float(np.float32(1.0 - self.alpha)) * r
            p = p + float(np.float32(self.alpha)) * r
            om, w = _whole_graph_walk_setup(r1, omega)
            p = p + _walk_contrib_chunked(g, om, w, self.generator,
                                          self.alpha, True)
        p, _ = apply_dangling_source_shortcircuit(
            g, sources_t, p, torch.zeros_like(p), src_onehot)
        return p


class ForaTopk(_ForaCostModel, PPRAlgorithm):
    name = "FORA-Topk"

    def __init__(self, dataset, alpha: float, k: int, *, seed: int = 0,
                 completion: str = "auto", push: str = "auto",
                 early_exit: bool = False):
        super().__init__(dataset, alpha, seed=seed)
        if push not in ("auto", "reference", "none"):
            raise ValueError(f"unknown push mode {push!r}")
        n = dataset.graph.n
        # Algo_Conf.set_conf_fora_topk (Algo_Conf.java:71-77)
        self.k = int(k)
        self.min_delta = 1.0 / n
        self.delta0 = 1.0 / self.k
        self.pfail = 1.0 / n / n / math.log(max(n / self.k, math.e))
        #: residue completion of the push rounds: "walks", "spmv" or
        #: "auto" (the cost model)
        self.completion = completion
        #: "reference": the push+completion rounds of Fora_Topk.java:
        #: 123-179; "none": no pushes, the annealed propagation loop;
        #: "auto": no pushes exactly when the cost model picks propagation
        self.push = push
        #: stop as soon as every row's top-k id set is certified final
        #: (ids as the full run's; values lower bounds)
        self.early_exit = bool(early_exit)
        #: sweeps the last annealed loop ran (summed over a cohort ladder's
        #: stages), or the rounds of the last push+completion run
        self.last_iters: int | None = None
        #: the walks each round of the last push+walks run launched
        self.last_round_walks: list[int] = []
        #: the path the last batch call took (:meth:`path_cost`)
        self.last_path: str | None = None
        self._init_cost_constants()

    def path_cost(self, eps: float, batch: int) -> tuple[float, float, str]:
        """The path a query at ``eps'`` takes at batch width ``batch``:
        ``(walk_ns, spmv_ns, path)``, the cost model's estimates a query of
        completing the whole residue by walks and by propagation, and
        ``"annealed"`` (the annealed propagation loop, no push rounds) or
        ``"push+walks"`` (the reference's push rounds,
        ``ppr_tpu/models/fora.py:997-1001``)."""
        omega0 = (eps + 2.0) * math.log(2.0 / self.pfail) / eps / eps \
            / self.delta0
        target = eps * self.delta0
        walk_ns, spmv_ns = self._completion_costs(omega0, 1.0, target, batch)
        skip = (self.push == "none" if self.push != "auto"
                else self._use_spmv(omega0, 1.0, target, batch))
        return walk_ns, spmv_ns, "annealed" if skip else "push+walks"

    def _skip_push(self, eps: float, batch: int) -> bool:
        """Whether a query at ``eps'`` runs the annealed loop instead of
        push rounds."""
        return self.path_cost(eps, batch)[2] == "annealed"

    def compute_topk_batch(self, sources: np.ndarray, k: int, param
                           ) -> np.ndarray:
        """Dense ``[B, n_pad]`` top-k scores (host copy)."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        with timer.span("loop.topk") as sp:
            sources, b = _pad_sources(sources)
            result, sources_t, src_onehot = self._compute_topk_device(
                sources, k, param
            )
            result, _ = apply_dangling_source_shortcircuit(
                g, sources_t, result, torch.zeros_like(result), src_onehot
            )
            out = result.cpu().numpy()[:b]
            self._note_loop(sp, len(sources))
        return out

    def compute_topk_ids_batch(self, sources: np.ndarray, k: int, param, *,
                               kcap: int | None = None):
        """Serving path: ``(values [B, K], ids [B, K])`` numpy, selected on
        the device. K = ``kcap`` (default :func:`topk_kcap`) leaves room
        for the reference's tie semantics."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int64))
        with timer.span("loop.topk") as sp:
            sources, b = _pad_sources(sources)
            result, sources_t, src_onehot = self._compute_topk_device(
                sources, k, param
            )
            kcap = topk_kcap(k, g.n_pad, kcap)
            vals, ids = _device_topk_epilogue(g, sources_t, result,
                                              src_onehot, kcap)
            out = vals.cpu().numpy()[:b], ids.cpu().numpy()[:b]
            self._note_loop(sp, len(sources))
        return out

    def _note_loop(self, sp, columns: int) -> None:
        """The ``loop.topk`` span's attributes: the ``path`` the last call
        took, its ``sweeps`` (the annealed loop's count) or ``rounds``
        (push+walks), its ``columns`` (the padded batch), ``hubs``, the
        hub count (0 without a hub split), and ``tail_edges``, the edges
        the sparse tail's kernel sweeps (the graph's without a hub
        split)."""
        if sp is timer.NO_SPAN:
            return
        hs = self.hub_split
        sp.set(path=self.last_path, columns=columns,
               hubs=hs.num_hubs if hs is not None else 0,
               tail_edges=hs.m_tail if hs is not None else self.graph.m,
               **{"sweeps" if self.last_path == "annealed" else "rounds":
                  self.last_iters})

    def compute_topk_ids_cohorts(self, sources: np.ndarray, k: int, param,
                                 *, kcap: int | None = None):
        """Streaming serving path: yields ``(orig_indices, vals, ids)``
        cohorts as rows retire, instead of holding every row until the
        slowest finishes (``ppr_tpu/models/fora.py:870-980``).

        The per-row loop runs at the pow2 width ``W`` until at most ``W/2``
        rows are live; the retired rows are yielded, and the stragglers go
        on from the same state at the pow2 width of their count. A row's
        trajectory is that of a run of the row alone. The stages share one
        budget of ``MAX_TOPK_SWEEPS``; once it is spent, every row left is
        yielded as it stands, and a line on stderr says so.

        When the push rounds run (:meth:`_skip_push` false), the batch is
        one terminal cohort: walks carry no per-row state across widths."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        sources = np.asarray(sources)
        b = len(sources)
        if b == 0:
            return
        eps = float(param) * 0.5      # eps' = eps/2 (Fora_Topk.java:110)
        kcap = topk_kcap(k, g.n_pad, kcap)
        if not self._skip_push(eps, b):
            vals, ids = self.compute_topk_ids_batch(sources, k, param,
                                                    kcap=kcap)
            yield np.arange(b), vals, ids
            return

        budget = MAX_TOPK_SWEEPS      # one budget for all the stages
        iters_used = 0
        W = _pow2_width(b)
        padded = np.zeros(W, np.int64)
        padded[:b] = sources
        sources_t = torch.as_tensor(padded, dtype=torch.int32,
                                    device=g.device)
        p, r, src_onehot = forward_push_init(g, sources_t)
        p = torch.zeros_like(p)
        delta = torch.full((W,), self.delta0, dtype=torch.float32,
                           device=g.device)
        fin0 = np.zeros(W, bool)
        fin0[b:] = True               # pad rows never emit
        finished = torch.as_tensor(fin0, device=g.device)
        orig = np.full(W, -1, np.int64)
        orig[:b] = np.arange(b)

        while True:
            live_floor = W // 2 if W > 8 else 0
            p, r, delta, finished, iters = annealed_topk_propagate_perrow(
                g, p, r, src_onehot, eps, delta, finished, live_floor,
                self.min_delta, k, self.alpha, max_iters=budget - iters_used,
                hs=self.hub_split, num_chunks=self._num_chunks(W),
                early_exit=self.early_exit,
            )
            fin = finished.cpu().numpy()
            iters_used += int(iters)
            self.last_iters = iters_used
            gave_up = iters_used >= budget and not fin.all()
            if gave_up:
                n_unconv = int((~fin & (orig >= 0)).sum())
                print(f"ppr_tpu_torch.fora: cohort sweep budget {budget} "
                      f"exhausted with {n_unconv} unconverged row(s); "
                      f"emitting current estimates", file=sys.stderr,
                      flush=True)
            emit = (fin | gave_up) & (orig >= 0)
            if emit.any():
                rows = torch.as_tensor(np.nonzero(emit)[0], device=g.device)
                vals, ids = _device_topk_epilogue(
                    g, sources_t.index_select(0, rows),
                    p.index_select(0, rows), src_onehot.index_select(0, rows),
                    kcap)
                yield orig[emit], vals.cpu().numpy(), ids.cpu().numpy()
            if fin.all() or gave_up:
                return
            # the stragglers, at the pow2 width of their count (not just
            # W/2: rows that retire together skip the stages between)
            live_idx = np.nonzero(~fin)[0]
            new_w = _pow2_width(len(live_idx))
            sel = np.concatenate([
                live_idx,
                np.full(new_w - len(live_idx), live_idx[0], live_idx.dtype),
            ])
            p, r, src_onehot, delta, sources_t = _cohort_compact(
                p, r, src_onehot, delta, sources_t,
                torch.as_tensor(sel, device=g.device))
            nf = np.zeros(new_w, bool)
            nf[len(live_idx):] = True   # the duplicates never emit
            finished = torch.as_tensor(nf, device=g.device)
            new_orig = np.full(new_w, -1, np.int64)
            new_orig[: len(live_idx)] = orig[live_idx]
            orig = new_orig
            W = new_w

    def _compute_topk_device(self, sources: np.ndarray, k: int, param):
        """``(result, sources, src_onehot)`` on the device, without the
        dangling-source short-circuit."""
        eps = float(param) * 0.5      # eps' = eps/2 (Fora_Topk.java:110)
        g = self.graph
        b = len(sources)
        sources_t = torch.as_tensor(np.asarray(sources), dtype=torch.int32,
                                    device=g.device)
        p, r, src_onehot = forward_push_init(g, sources_t)
        p = torch.zeros_like(p)
        self.last_path = self.path_cost(eps, b)[2]
        if self.last_path == "annealed":
            p, r, iters = annealed_topk_propagate(
                g, p, r, src_onehot, eps, self.delta0, self.min_delta, k,
                self.alpha, hs=self.hub_split,
                num_chunks=self._num_chunks(b), early_exit=self.early_exit,
            )
            self.last_iters = int(iters)
            return p, sources_t, src_onehot

        # the rounds of Fora_Topk.java:123-179
        m = max(g.m, 1)
        ln_term = math.log(2.0 / self.pfail)
        delta = self.delta0
        self.last_round_walks = []
        rounds = 0
        while True:
            rmax = eps * math.sqrt(delta / 3.0 / m / ln_term)
            rmax *= math.sqrt(m * rmax) * 3.0   # Fora_Topk.java:133
            omega = (eps + 2.0) * ln_term / eps / eps / delta
            # the push goes on from the last round's state
            p, r, _ = forward_push_sweeps(g, p, r, src_onehot, rmax,
                                          self.alpha)
            rsum_rw = float(r.sum(dim=-1).cpu().numpy().mean()) \
                * (1.0 - self.alpha)
            target = eps * delta
            # a round's completion is not folded back into (p, r)
            # (Fora_Topk.java:142-168)
            if self._use_spmv(omega, rsum_rw, target, b):
                result, _, _ = residual_propagate(
                    g, p, r, src_onehot, target, self.alpha,
                    hs=self.hub_split, num_chunks=self._num_chunks(b))
            else:
                om, w = _whole_graph_walk_setup(r, omega * rsum_rw)
                self.last_round_walks.append(int(om.sum()))
                result = p + _walk_contrib_chunked(g, om, w, self.generator,
                                                   self.alpha, False)
            rounds += 1
            # Fora_Topk.java:173-178: k-th reserve >= (1+eps')*delta
            kth = _kth_over_support(result, k).cpu().numpy()
            if np.all(kth >= (1.0 + eps) * delta) or delta <= self.min_delta:
                break
            delta = max(self.min_delta, delta / 4.0)
        self.last_iters = rounds
        return result, sources_t, src_onehot

    def compute_whole_graph_batch(self, sources, param):  # top-k only algo
        return self.compute_topk_batch(sources, self.k, param)
