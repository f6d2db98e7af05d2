"""Top-k selection with the reference's tie semantics — port of
``ppr_tpu/ops/topk.py``.

"Top-k" is every node whose score is >= the k-th largest (so ties can make
the set larger than k), or the whole support when it holds fewer than k
nodes (Algo_Util.java:32-53). Selection on the device is ``torch.topk``,
which orders equal values differently from ``lax.top_k``: compare
tie-expanded id sets, not orders. Tie expansion is host numpy.
"""

from __future__ import annotations

import numpy as np
import torch


def kth_value(p: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest value of ``p`` along the last axis (no support
    filtering)."""
    return torch.topk(p, k, dim=-1).values[..., -1]


def device_top_k(p: torch.Tensor, k: int):
    """``(values, indices)`` of the k largest entries of each row, on
    ``p``'s device; indices are int64 (``lax.top_k``'s are int32)."""
    return torch.topk(p, k, dim=-1)


def topk_ids_with_ties(values: np.ndarray, k: int, *, support=None,
                       tol: float = 0.0) -> np.ndarray:
    """Node ids with value >= k-th largest support value, sorted
    descending; ``tol`` > 0 treats values within ``tol`` of the k-th value
    as tied."""
    values = np.asarray(values)
    if support is None:
        support = values > 0.0
    sup_ids = np.nonzero(support)[0]
    sup_vals = values[sup_ids]
    if sup_ids.size == 0:
        return np.zeros((0,), np.int64)
    if sup_ids.size <= k:
        chosen = sup_ids
    else:
        kth = np.partition(sup_vals, -k)[-k]
        chosen = sup_ids[sup_vals >= kth - tol]
    order = np.argsort(-values[chosen], kind="stable")
    return chosen[order]


def topk_ids_with_ties_from_pairs(vals_row: np.ndarray, ids_row: np.ndarray,
                                  k: int, *, tol: float = 0.0) -> np.ndarray:
    """Tie-expanded top-k over a device-selected (values, ids) row pair,
    descending, of length kcap >= k. Ties past the window are cut; callers
    that need exact tie sets detect ``vals_row[-1] >= kth - tol`` and fall
    back to the dense path."""
    vals_row = np.asarray(vals_row)
    ids_row = np.asarray(ids_row)
    sup = vals_row > 0.0
    v, i = vals_row[sup], ids_row[sup]
    if v.size <= k:
        return i
    kth = v[k - 1]
    return i[v >= kth - tol]


def kth_ppr(values: np.ndarray, k: int):
    """Host quickselect-parity helper: the k-th largest, or ``None`` when k
    is invalid (k <= 0 or k > len(values)), as Algo_Util.java:39-53
    returns null."""
    values = np.asarray(values)
    if k <= 0 or k > values.size:
        return None
    return float(np.partition(values, -k)[-k])
