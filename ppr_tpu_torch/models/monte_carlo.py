"""Monte-Carlo PPR — port of ``ppr_tpu/models/monte_carlo.py``.

Monte_Carlo.java's ``computeWholeGraphPPR`` (:136-158) launches ``omega =
3*ln(2/pfail)/eps^2/delta`` walks from the source (:145) and estimates
``pi(s, v)`` as the share of walks that stop at v (:156-157); top-k is a
selection over that estimate (:283-319). Parameter: ``epsilon``.

All ``B * omega`` walks of a batch run in lockstep through
:func:`~..ops.walk.weighted_walk_counts`, each depositing ``1/omega`` in
its source's row. The walker pool is exactly ``B * omega``: the JAX
package pads it to a power of two and passes ``omega`` as a traced scalar
so that the sweep's epsilons share compiled programs, which the port has
no need for. ``max_walk_batch`` bounds the walkers of one call; a batch
whose pool is larger runs in source chunks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops.walk import weighted_walk_counts
from .base import PPRAlgorithm, PreprocessingMixin


def mc_num_walks(eps: float, delta: float, pfail: float) -> int:
    """omega = 3*ln(2/pfail)/eps^2/delta (Monte_Carlo.java:145)."""
    return int(math.ceil(3.0 * math.log(2.0 / pfail) / eps / eps / delta))


def mc_whole_graph_batch(g: Graph, sources: torch.Tensor,
                         generator: torch.Generator, alpha: float,
                         omega: int, *, deposit: torch.dtype = torch.float64
                         ) -> torch.Tensor:
    """f32 ``[B, n_pad]``: ``omega`` walks from each int32 source, each
    depositing ``1/omega`` in its source's row, added in ``deposit``
    (:func:`~..ops.walk.weighted_walk_counts`)."""
    b = sources.shape[0]
    rows = torch.arange(b, device=sources.device).repeat_interleave(omega)
    starts = sources.index_select(0, rows)
    weights = torch.full(rows.shape, float(np.float32(1) / np.float32(omega)),
                         dtype=torch.float32, device=sources.device)
    return weighted_walk_counts(g, starts, rows, weights, generator, alpha,
                                num_rows=b, deposit=deposit)


class MonteCarlo(PreprocessingMixin, PPRAlgorithm):
    name = "Monte-Carlo"
    prep_dirname = "MC_ppr_results"

    def __init__(self, dataset, alpha: float, *, delta: float | None = None,
                 pfail: float | None = None, seed: int = 0,
                 max_walk_batch: int = 4_000_000):
        super().__init__(dataset, alpha, seed=seed)
        n = dataset.graph.n
        # Algo_Conf.set_conf_mc (Algo_Conf.java:29-34): delta = pfail = 1/n
        self.delta = delta if delta is not None else 1.0 / n
        self.pfail = pfail if pfail is not None else 1.0 / n
        self.max_walk_batch = max_walk_batch

    def _source_chunk(self, param) -> int:
        """Sources a call, keeping its walker pool within ``max_walk_batch``
        (at least one source)."""
        omega = mc_num_walks(float(param), self.delta, self.pfail)
        return max(1, self.max_walk_batch // omega)

    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        # one chunk at a time to the host: the device holds one chunk's
        # [chunk, n_pad] output at a time
        sources = np.asarray(sources)
        per_chunk = self._source_chunk(param)
        outs = [self.compute_whole_graph_device(sources[lo:lo + per_chunk],
                                                param).cpu().numpy()
                for lo in range(0, len(sources), per_chunk)]
        if not outs:
            return np.zeros((0, self.graph.n_pad), np.float32)
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        """Device scores ``[B, n_pad]``, computed in source chunks
        (preprocessing batches are clamped to one chunk by
        :meth:`_prep_batch`)."""
        omega = mc_num_walks(float(param), self.delta, self.pfail)
        sources = np.asarray(sources)
        per_chunk = self._source_chunk(param)
        outs = [
            mc_whole_graph_batch(
                self.graph,
                torch.as_tensor(sources[lo:lo + per_chunk], dtype=torch.int32,
                                device=self.graph.device),
                self.generator, self.alpha, omega)
            for lo in range(0, len(sources), per_chunk)
        ]
        return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)

    def _prep_batch(self, param, batch_size: int = 128) -> int:
        # one chunk a preprocessing batch (the memory bound); preprocessing,
        # its warm-up and the resume check all use this height
        return min(batch_size, self._source_chunk(param))
