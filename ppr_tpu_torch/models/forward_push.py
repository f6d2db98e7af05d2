"""Forward Push (local push from the source) — port of
``ppr_tpu/models/forward_push.py``.

Reference: Forward_Push.java, the whole-graph variant at :63-142
(queue-driven residue/reserve updates gated by ``r(v)/d_out(v) >= rmax``).
Parameter: ``rmax``. The queue is the frontier-masked synchronous sweep
(``ops/push.forward_push_sweeps``), batched over sources; top-k is the
whole-graph result thresholded with ties, as Forward_Push.computeTopKPPR
(:389-394) delegates to the whole-graph computation. On a sparse graph each
sweep's push runs K3 on the card (``ops/row_gather.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.push import (apply_dangling_source_shortcircuit, forward_push_init,
                        forward_push_sweeps)
from .base import PPRAlgorithm, PreprocessingMixin


class ForwardPush(PreprocessingMixin, PPRAlgorithm):
    name = "Forward-Push"
    prep_dirname = "FWP_ppr_results"

    _last_rsum_dev: torch.Tensor | None = None
    #: sweeps the last push ran (the frontier was non-empty in each)
    last_sweeps: int | None = None

    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        return self.compute_whole_graph_device(sources, param).cpu().numpy()

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        """The reserve ``[B, n_pad]`` on the graph's device (the
        preprocessing sweep compacts it there). Only the per-row residue sum
        is kept, for :meth:`residue_sum`, not the dense residue."""
        g = self.graph
        sources_t = torch.as_tensor(np.asarray(sources), dtype=torch.int32,
                                    device=g.device)
        p, r, src_onehot = forward_push_init(g, sources_t)
        p, r, self.last_sweeps = forward_push_sweeps(
            g, p, r, src_onehot, float(param), self.alpha)
        p, r = apply_dangling_source_shortcircuit(g, sources_t, p, r,
                                                  src_onehot)
        self._last_rsum_dev = r.sum(dim=-1)
        return p

    def residue_sum(self) -> np.ndarray:
        """Per-row residue mass after the last push (the reference's
        ``getUpdatedRsum``, Forward_Push.java:252-254)."""
        return self._last_rsum_dev.cpu().numpy()
