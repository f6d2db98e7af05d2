"""Accuracy metrics — copies of ``ppr_tpu/utils/metrics.py``
(Gen_Util.computeError, Gen_Util.java:259-326), host-side numpy, against
the power-method ground truth:

* **Precision@k** (:271-279): the denominator is the ground-truth set
  size, which ties can push past k.
* **NDCG@k** (:280-300): gain 2^pi - 1 with the ground-truth ranking as
  the ideal; the algorithm's picks outside the ground-truth top-k gain 0.
* **MaxAbsErr** (:306-321): max |est - exact| over the ground-truth
  support only.
"""

from __future__ import annotations

import numpy as np


def precision_at_k(algo_ids: np.ndarray, gnd_ids: np.ndarray) -> float:
    """|algo top-k ∩ gnd top-k| / |gnd top-k|."""
    if gnd_ids.size == 0:
        return 0.0
    gnd = set(int(i) for i in gnd_ids)
    correct = sum(1 for i in algo_ids if int(i) in gnd)
    return correct / float(len(gnd))


def ndcg_at_k(algo_ids: np.ndarray, gnd_ids: np.ndarray,
              gnd_values: np.ndarray) -> float:
    """NDCG with gain 2^ppr - 1 against the oracle ranking; ``gnd_values``
    is the dense ground-truth vector."""
    if gnd_ids.size == 0:
        return 0.0
    log2 = np.log(2.0)
    gnd_set = set(int(i) for i in gnd_ids)

    zk = 0.0
    for i, node in enumerate(gnd_ids, start=1):
        zk += (2.0 ** float(gnd_values[int(node)]) - 1.0) / np.log(i + 1.0) / log2

    dcg = 0.0
    for i, node in enumerate(algo_ids, start=1):
        v = float(gnd_values[int(node)]) if int(node) in gnd_set else 0.0
        dcg += (2.0 ** v - 1.0) / np.log(i + 1.0) / log2

    return dcg / zk if zk > 0 else 0.0


def max_abs_err(algo_values: np.ndarray, gnd_values: np.ndarray,
                gnd_support: np.ndarray | None = None) -> float:
    """max |est - exact| over the oracle support."""
    gnd_values = np.asarray(gnd_values, np.float64)
    algo_values = np.asarray(algo_values, np.float64)
    if gnd_support is None:
        gnd_support = gnd_values > 0.0
    diff = np.abs(algo_values - gnd_values)
    masked = np.where(gnd_support, diff, 0.0)
    return float(masked.max()) if masked.size else 0.0
