"""Backward Search (single-target reverse push), the building block of BASE
— port of ``ppr_tpu/models/backward_search.py``.

Reference: Backward_Search.java:38-100 — reverse push from a target t over
incoming edges, with the strict gate ``r > rmax`` (:89-94) and the
in-degree-0 short-circuit ``pi(t,t) = 1`` (:46-49). The reference class is
only driven by Base_Whole_Graph, and so is :class:`BackwardSearch`. A
``[T, n_pad]`` residue runs the reverse sweeps for T targets at once
(``ops/push.backward_push_sweeps``); on a sparse graph each sweep's pull
runs K3 on the card (``ops/row_gather.py``).
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.csr import Graph
from ..ops.push import apply_zero_indeg_target_shortcircuit, backward_push_sweeps


def backward_search_batch(g: Graph, targets: torch.Tensor, rmax: float,
                          alpha: float):
    """``(reserve, residue)``, f32 ``[T, n_pad]`` each, for int32 target
    ids; ``reserve[row, v]`` ~ ``pi(v, targets[row])``."""
    tgt_onehot = F.one_hot(targets.long(), g.n_pad).to(torch.float32)
    p = torch.zeros_like(tgt_onehot)
    p, r, _ = backward_push_sweeps(g, p, tgt_onehot, rmax, alpha)
    return apply_zero_indeg_target_shortcircuit(g, targets, p, r, tgt_onehot)


class BackwardSearch:
    def __init__(self, graph: Graph, alpha: float, rmax: float):
        self.graph = graph
        self.alpha = float(alpha)
        self.rmax = float(rmax)
        self.duration_ns = 0  # accumulated, as Backward_Search.java:36,:98-99

    def whole_graph(self, targets: np.ndarray) -> np.ndarray:
        """``pi(., t)`` for a batch of targets, rows indexed by target."""
        p = self.whole_graph_device(targets)   # accounts its own duration
        t0 = time.perf_counter_ns()
        out = p.cpu().numpy()
        self.duration_ns += time.perf_counter_ns() - t0
        return out

    def whole_graph_device(self, targets: np.ndarray) -> torch.Tensor:
        """The reserve ``[T, n_pad]`` on the graph's device (BASE selects
        its entries there). The duration ends once the card is done."""
        g = self.graph
        t0 = time.perf_counter_ns()
        p, _ = backward_search_batch(
            g, torch.as_tensor(np.asarray(targets), dtype=torch.int32,
                               device=g.device),
            self.rmax, self.alpha)
        if p.is_cuda:
            torch.cuda.synchronize(p.device)
        self.duration_ns += time.perf_counter_ns() - t0
        return p

    def get_duration(self) -> int:
        return self.duration_ns
