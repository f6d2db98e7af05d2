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

Not ported yet: the push+walk rounds (``push="reference"``/``"auto"``),
the cost model that chooses between them, FORA whole-graph, the cohort
path and the early-exit certificate (ROADMAP.md, queue 1, items 11 and 16).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops.hub_split import HubSplit, build_hub_split, push_out_hybrid_t
from ..ops.push import apply_dangling_source_shortcircuit, forward_push_init
from ..ops.spmv import push_out_chunked_t, push_out_t
from .base import PPRAlgorithm

#: total annealed-sweep budget of a top-k query (as the JAX package)
MAX_TOPK_SWEEPS = 600
#: sweeps between the host's reads of the device-side ``finished`` flag
CHECK_EVERY = 8


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
):
    """The whole FORA top-k delta-annealing loop; returns ``(p, r,
    iters)`` with ``iters`` a device int32 scalar.

    Per sweep: ``p += alpha*r``; ``r = push((1-alpha) r) + dangling mass
    at the source``. The stopping rule "k-th reserve >= (1+eps')*delta" is
    the count ``#{v: p_v >= (1+eps')*delta} >= k`` on every row, tested on
    the sweeps where ``max_row sum(r) <= eps'*delta`` (settled); a settled
    sweep that does not stop anneals delta by /4, down to ``min_delta``,
    and a settled sweep at ``min_delta`` stops."""
    dev = p.device
    f32 = torch.float32
    # the JAX loop's f32 constants, held as Python floats so that the
    # [n_pad, B] passes take them as scalar arguments
    alpha_f = float(np.float32(alpha))
    keep = float(np.float32(1.0) - np.float32(alpha))
    eps_f = float(np.float32(eps))
    thresh_scale = float(np.float32(1.0) + np.float32(eps))
    dang_ids = torch.nonzero((g.out_deg == 0) & (g.node_mask > 0)).flatten()
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
        rem = r_t * keep
        dang_mass = rem.index_select(0, dang_ids).sum(dim=0, keepdim=True)
        if hs is not None:
            pushed = push_out_hybrid_t(g, hs, rem, num_chunks=num_chunks)
        elif num_chunks > 1:
            pushed = push_out_chunked_t(g, rem, num_chunks=num_chunks)
        else:
            pushed = push_out_t(g, rem)
        r_new = pushed.addcmul_(dang_mass, src_t)
        r_t = torch.where(live, r_new, r_t)

        settled = live & (r_t.sum(dim=0).max() <= eps_f * delta)
        thresh = thresh_scale * delta
        done = settled & ((p_t >= thresh).sum(dim=0) >= k).all()
        finished = finished | done | (settled & (delta <= min_delta))
        delta = torch.where(settled & ~finished,
                            torch.clamp_min(delta / 4.0, min_delta), delta)
        it = it + live.to(torch.int32)
        if (sweep + 1) % CHECK_EVERY == 0 and bool(finished):
            break
    return p_t.T, r_t.T, it


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
                 push: str = "none"):
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
        #: sweeps the last annealed loop ran
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

    def compute_topk_ids_batch(self, sources: np.ndarray, k: int, param):
        """Serving path: ``(values [B, K], ids [B, K])`` numpy, selected on
        the device. K = ``min(max(4k, k+32), n_pad)`` leaves room for the
        reference's tie semantics."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int64))
        sources, b = _pad_sources(sources)
        result, sources_t, src_onehot = self._compute_topk_device(
            sources, k, param
        )
        kcap = min(max(4 * k, k + 32), g.n_pad)
        vals, ids = _device_topk_epilogue(g, sources_t, result, src_onehot,
                                          kcap)
        return vals.cpu().numpy()[:b], ids.cpu().numpy()[:b]

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
        )
        self.last_iters = int(iters)
        return p, sources_t, src_onehot

    def compute_whole_graph_batch(self, sources, param):  # top-k only algo
        return self.compute_topk_batch(sources, self.k, param)
