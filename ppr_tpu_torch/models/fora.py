"""FORA top-k serving — port of the ``push="none"`` path of
``ppr_tpu/models/fora.py``.

The top-k algorithm (Fora_Topk.java:102-184) anneals delta from 1/k down to
1/n by /4 per round and stops once the k-th reserve is >= (1+eps')*delta.
The serving path runs it as one loop of synchronous propagation sweeps
(:func:`annealed_topk_propagate`): each sweep moves alpha*r into the reserve
and pushes the rest; whenever the residue settles below ``eps'*delta`` the
stopping rule is tested and delta anneals. There is no sampling, so the
result is deterministic.

The loop state (``delta``, ``finished``, the sweep count) lives on the
device. A sweep after ``finished`` is set changes nothing, and the host
reads ``finished`` once every ``CHECK_EVERY`` sweeps, so the loop does not
wait on the card every sweep and still stops on exactly the sweep of the
JAX package's ``lax.while_loop``. Unlike that loop, the port evaluates the
stopping count on every sweep, settled or not: skipping it would need the
host to read ``settled`` each sweep.

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

Not ported yet: the push+walk rounds (``push="reference"``/``"auto"``),
the cost model that chooses between them (``calibrate``) and FORA
whole-graph (ROADMAP.md, queue 1, item 11).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops.hub_split import HubSplit, build_hub_split, push_out_hybrid_t
from ..ops.push import apply_dangling_source_shortcircuit, forward_push_init
from ..ops.spmv import push_out_chunked_t, push_out_t
from .base import PPRAlgorithm

#: total annealed-sweep budget of a top-k query, shared by the batch loop
#: and the cohort ladder (as the JAX package)
MAX_TOPK_SWEEPS = 600
#: sweeps between the host's reads of the device-side ``finished`` flag
CHECK_EVERY = 8
#: sweeps between tests of the early-exit certificate (the JAX package's
#: ``early_check_every``)
EARLY_CHECK_EVERY = 8


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
    """One sweep's new residue: ``(1-alpha) r`` pushed along the out-edges,
    the dangling rows' share returned to each column's source."""
    rem = r_t * keep
    dang_mass = rem.index_select(0, g.dang_ids).sum(dim=0, keepdim=True)
    if hs is not None:
        pushed = push_out_hybrid_t(g, hs, rem, num_chunks=num_chunks)
    elif num_chunks > 1:
        pushed = push_out_chunked_t(g, rem, num_chunks=num_chunks)
    else:
        pushed = push_out_t(g, rem)
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
    once every row's certificate holds (:func:`_set_stable`)."""
    dev = p.device
    f32 = torch.float32
    alpha_f, keep, eps_f, thresh_scale = _loop_constants(alpha, eps)
    # node-major state [n_pad, B]: the per-edge gather reads [B]-wide rows
    p_t = p.T.contiguous()
    r_t = r.T.contiguous()
    src_t = src_onehot.T.contiguous()
    delta = torch.tensor(delta0, dtype=f32, device=dev)
    finished = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)

    for sweep in range(MAX_TOPK_SWEEPS):
        live = ~finished
        # a frozen sweep adds r * 0: p is unchanged bit for bit
        p_t = torch.addcmul(p_t, r_t, live * alpha_f)
        r_new = _push_residue(g, r_t, src_t, keep, hs, num_chunks)
        r_t = torch.where(live, r_new, r_t)

        settled = live & (r_t.sum(dim=0).max() <= eps_f * delta)
        thresh = thresh_scale * delta
        done = settled & ((p_t >= thresh).sum(dim=0) >= k).all()
        # while the loop is live, ``sweep`` is the JAX loop's ``it``; after
        # ``finished`` a certificate changes nothing
        if early_exit and (sweep + 1) % EARLY_CHECK_EVERY == 0:
            done = done | _set_stable(p_t, r_t, k).all()
        finished = finished | done | (settled & (delta <= min_delta))
        delta = torch.where(settled & ~finished,
                            torch.clamp_min(delta / 4.0, min_delta), delta)
        it = it + live.to(torch.int32)
        if (sweep + 1) % CHECK_EVERY == 0 and bool(finished):
            break
    return p_t.T, r_t.T, it


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


def _device_topk_epilogue(g: Graph, sources: torch.Tensor, p: torch.Tensor,
                          src_onehot: torch.Tensor, kcap: int):
    """Dangling-source short-circuit + top-(kcap) selection on the device;
    only ``[B, kcap]`` values and ids go to the host. kcap > k leaves room
    for the reference's tie expansion."""
    deg_src = g.out_deg.index_select(0, sources)[:, None]
    p = torch.where(deg_src == 0, src_onehot, p)
    return torch.topk(p, kcap, dim=-1)


class ForaTopk(PPRAlgorithm):
    name = "FORA-Topk"

    hub_split: HubSplit | None = None
    #: device budget for the per-edge gather intermediate [m_pad, B]
    spmv_intermediate_budget = 2 << 30
    #: the same budget for the hub-split tail
    hybrid_tail_budget = 6 << 30

    def __init__(self, dataset, alpha: float, k: int, *, seed: int = 0,
                 push: str = "none", early_exit: bool = False):
        super().__init__(dataset, alpha, seed=seed)
        if push != "none":
            raise NotImplementedError(
                f"push={push!r} needs the walks and the FORA cost model, "
                "which are not ported yet (ROADMAP.md, queue 1, item 11)"
            )
        n = dataset.graph.n
        # Algo_Conf.set_conf_fora_topk (Algo_Conf.java:71-77)
        self.k = int(k)
        self.min_delta = 1.0 / n
        self.delta0 = 1.0 / self.k
        self.pfail = 1.0 / n / n / math.log(max(n / self.k, math.e))
        self.push = push
        #: stop as soon as every row's top-k id set is certified final
        #: (ids as the full run's; values lower bounds)
        self.early_exit = bool(early_exit)
        #: sweeps the last annealed loop ran (summed over a cohort ladder's
        #: stages)
        self.last_iters: int | None = None

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

    def enable_hub_split(self, num_hubs: int, dtype=None) -> None:
        """Use the dense-hub hybrid push with ``num_hubs`` hubs (f32 hub
        product unless ``dtype=torch.bfloat16``)."""
        kwargs = {} if dtype is None else {"dtype": dtype}
        self.hub_split = build_hub_split(self.graph, num_hubs, **kwargs)

    def compute_topk_batch(self, sources: np.ndarray, k: int, param
                           ) -> np.ndarray:
        """Dense ``[B, n_pad]`` top-k scores (host copy)."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        sources, b = _pad_sources(sources)
        result, sources_t, src_onehot = self._compute_topk_device(
            sources, k, param
        )
        result, _ = apply_dangling_source_shortcircuit(
            g, sources_t, result, torch.zeros_like(result), src_onehot
        )
        return result.cpu().numpy()[:b]

    def compute_topk_ids_batch(self, sources: np.ndarray, k: int, param, *,
                               kcap: int | None = None):
        """Serving path: ``(values [B, K], ids [B, K])`` numpy, selected on
        the device. K = ``kcap`` (default ``min(max(4k, k+32), n_pad)``)
        leaves room for the reference's tie semantics."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int64))
        sources, b = _pad_sources(sources)
        result, sources_t, src_onehot = self._compute_topk_device(
            sources, k, param
        )
        kcap = min(int(kcap) if kcap else max(4 * k, k + 32), g.n_pad)
        vals, ids = _device_topk_epilogue(g, sources_t, result, src_onehot,
                                          kcap)
        return vals.cpu().numpy()[:b], ids.cpu().numpy()[:b]

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
        yielded as it stands, and a line on stderr says so."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        sources = np.asarray(sources)
        b = len(sources)
        if b == 0:
            return
        eps = float(param) * 0.5      # eps' = eps/2 (Fora_Topk.java:110)
        kcap = min(int(kcap) if kcap else max(4 * k, k + 32), g.n_pad)

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
        sources_t = torch.as_tensor(np.asarray(sources), dtype=torch.int32,
                                    device=g.device)
        p, r, src_onehot = forward_push_init(g, sources_t)
        p = torch.zeros_like(p)
        p, r, iters = annealed_topk_propagate(
            g, p, r, src_onehot, eps, self.delta0, self.min_delta, k,
            self.alpha, hs=self.hub_split,
            num_chunks=self._num_chunks(len(sources)),
            early_exit=self.early_exit,
        )
        self.last_iters = int(iters)
        return p, sources_t, src_onehot

    def compute_whole_graph_batch(self, sources, param):  # top-k only algo
        return self.compute_topk_batch(sources, self.k, param)
