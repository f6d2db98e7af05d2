"""Device-side threshold compaction — port of
``ppr_tpu/ops/compact.py::threshold_nonzeros``.

A preprocessing sweep keeps only the positive (or thresholded) entries of
each ``[T, n_pad]`` score batch. The entries are selected on the device, so
only ``count`` (flat index, value) pairs cross to the host, not the dense
batch. A density guard copies the dense batch instead when the pairs would
move more bytes than it. The JAX package rounds its capacity up to a power
of two to bound XLA recompiles; PyTorch runs eagerly, so the port selects
exactly ``count`` entries.
"""

from __future__ import annotations

import numpy as np
import torch


def _keep(p, threshold: float, exclusive: bool):
    return (p > threshold) if exclusive else (p >= threshold)


def threshold_nonzeros(p: torch.Tensor, node_mask: torch.Tensor,
                       threshold: float, *, rows: int | None = None,
                       exclusive: bool = False):
    """Entries of ``p [T, n_pad]`` with value >= ``threshold``
    (``exclusive=True``: strictly >, e.g. ``> 0`` to match the store's
    keep-positive rule, subnormals included) on real nodes.

    Returns host arrays ``(row i64[count], col i64[count], val f32[count])``
    in row-major order. ``rows`` limits the selection to the first rows.
    """
    t, n_pad = p.shape
    if t * n_pad >= np.iinfo(np.int32).max:
        raise ValueError(f"flat index overflow: batch {t} x {n_pad}; "
                         "use a smaller target batch")
    thr = float(np.float32(threshold))
    keep = _keep(p, thr, exclusive) & (node_mask > 0)[None, :]
    if rows is not None:
        keep[int(rows):] = False
    count = int(keep.sum())
    if count == 0:
        z = np.zeros(0, np.int64)
        return z, z, np.zeros(0, np.float32)
    if count * 8 >= t * n_pad * 4:
        # the (int32 index, f32 value) pairs would move more bytes than
        # the batch
        dense = p.cpu().numpy()
        if rows is not None:
            dense = dense[:rows]
        nm = node_mask.cpu().numpy() > 0
        r, c = np.nonzero(_keep(dense, thr, exclusive) & nm[None, :])
        return r.astype(np.int64), c.astype(np.int64), dense[r, c]
    flat = torch.nonzero(keep.reshape(-1)).squeeze(1)
    vals = p.reshape(-1).index_select(0, flat)
    # one copy to the host, 8 bytes a pair: int32 indices (t * n_pad <
    # 2^31) and the f32 values bit for bit in int32 slots
    packed = torch.cat([flat.to(torch.int32), vals.view(torch.int32)]).cpu()
    flat_h = packed[:count].numpy().astype(np.int64)
    val_h = packed[count:].numpy().view(np.float32)
    return flat_h // n_pad, flat_h % n_pad, val_h
