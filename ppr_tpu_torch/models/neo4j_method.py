"""Library-PageRank baseline ("Neo4j method") — port of
``ppr_tpu/models/neo4j_method.py``.

Reference: Neo4j_Method.java:67-99 runs the library's personalized PageRank
with damping ``d = 1 - alpha`` for a fixed number of iterations, its only
accuracy knob, then normalizes the scores to sum 1 and drops zeros. The
library iteration ignores dangling mass (it leaks, and the normalization
repairs it):

    x_{t+1} = (1-d) * e_s + d * P^T x_t,    x_0 = (1-d) * e_s

batched over sources. On a CUDA graph whose dense operator fits K2
(``ops/dense_power.supports``), the rounds run in one CUDA kernel;
otherwise they are ``push_out`` sweeps (the dense matmul or the sorted
segmented sum).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.csr import Graph
from ..ops import dense_power
from ..ops.spmv import push_out
from .base import PPRAlgorithm, PreprocessingMixin


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """Rows to sum 1; an all-zero row (a padding row) stays zero."""
    total = x.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, x / total, x)


def personalized_pagerank_batch(g: Graph, sources, damping: float,
                                iterations: int) -> torch.Tensor:
    """Normalized ``[B, n_pad]`` scores for a batch of sources, on the
    graph's device."""
    sources = torch.as_tensor(np.asarray(sources), dtype=torch.long,
                              device=g.device)
    base = (1.0 - damping) * F.one_hot(sources, g.n_pad).to(torch.float32)
    x = base
    for _ in range(iterations):
        x = base + damping * push_out(g, x)
    return _normalize(x)


class Neo4jMethod(PreprocessingMixin, PPRAlgorithm):
    name = "Neo4j-Method"
    prep_dirname = "Neo4j_Method_ppr_results"

    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        return self.compute_whole_graph_device(sources, param).cpu().numpy()

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        """Scores on the graph's device (the preprocessing sweep compacts
        them there, without a dense host copy)."""
        iterations = int(param)
        # Neo4j damping = 1 - alpha (Neo4j_Method.java:75)
        damping = 1.0 - self.alpha
        g = self.graph
        if dense_power.supports(g):
            src = torch.as_tensor(np.asarray(sources), dtype=torch.long,
                                  device=g.device)
            onehot = F.one_hot(src, g.n_pad).to(torch.float32)
            x = dense_power.dense_pagerank_iterations(g, onehot, damping,
                                                      iterations)
            return _normalize(x)
        return personalized_pagerank_batch(g, sources, damping, iterations)
