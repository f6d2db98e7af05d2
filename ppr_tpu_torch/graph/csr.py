"""Array graph store — port of ``ppr_tpu/graph/csr.py``.

A :class:`Graph` is a frozen dataclass of tensors on one device, with the
same fields, dtypes (int32 indices, f32 masks) and padding as the JAX
package's pytree, so the two packages' arrays compare element for element:

* ``n_pad``/``m_pad`` round ``n + 1`` and ``m`` up to multiples of 128. The
  ``+ 1`` keeps the sentinel node ``n_pad - 1`` a padding node, never a real
  one, so padding edges (``edge_src = edge_dst = n_pad - 1``) are inert.
* ``edge_*_bydst`` hold the edges sorted by destination; ``bydst_ptr`` is
  their row pointer (``int64[n_pad + 1]``), and ``bysrc_ptr`` that of the
  primary, source-sorted order. Both are built here once, so every forward
  and reverse sweep reduces its segments in order, with no atomics.

Construction runs on the host in numpy (the argsort path of the JAX
package's ``build_graph``, which gives the same layout as its native C++
path); the arrays then move to the graph's device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device

LANES = 128  # padding unit, kept from the JAX package so n_pad matches


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Graph:
    """Immutable tensor graph snapshot on one device."""

    # --- CSR out-adjacency ---
    indptr: torch.Tensor          # int32[n_pad + 1]
    indices: torch.Tensor         # int32[m_pad] (padded tail = n_pad-1)

    # --- COO edge list, src-sorted ---
    edge_src: torch.Tensor        # int32[m_pad]
    edge_dst: torch.Tensor        # int32[m_pad]
    edge_mask: torch.Tensor       # float32[m_pad]

    # --- same edges sorted by destination, and their row pointer ---
    edge_src_bydst: torch.Tensor  # int32[m_pad]
    edge_dst_bydst: torch.Tensor  # int32[m_pad] (non-decreasing)
    bydst_ptr: torch.Tensor       # int64[n_pad + 1]
    bysrc_ptr: torch.Tensor       # int64[n_pad + 1], row pointer of edge_src

    # --- per-node arrays ---
    out_deg: torch.Tensor         # int32[n_pad]
    in_deg: torch.Tensor          # int32[n_pad]
    node_mask: torch.Tensor       # float32[n_pad]

    # --- optional dense operator (None for large graphs) ---
    dense_out: torch.Tensor | None  # float32[n_pad, n_pad]; row v = 1/d_v

    n: int
    m: int

    @property
    def n_pad(self) -> int:
        return int(self.out_deg.shape[0])

    @property
    def m_pad(self) -> int:
        return int(self.edge_src.shape[0])

    @property
    def has_dense(self) -> bool:
        return self.dense_out is not None

    @property
    def device(self) -> torch.device:
        return self.out_deg.device


def _segment_ptr(sorted_keys: np.ndarray, num_segments: int) -> np.ndarray:
    """Row pointer of a non-decreasing key array: segment s is
    ``[ptr[s], ptr[s+1])``."""
    return np.searchsorted(
        sorted_keys, np.arange(num_segments + 1), side="left"
    ).astype(np.int64)


_INDEX_FIELDS = ("indptr", "indices", "edge_src", "edge_dst",
                 "edge_src_bydst", "edge_dst_bydst", "out_deg", "in_deg")
_FLOAT_FIELDS = ("edge_mask", "node_mask")


def graph_from_numpy(arrays: dict, device=None) -> Graph:
    """A :class:`Graph` from host arrays keyed by field name, plus ``n`` and
    ``m`` — e.g. ``np.asarray`` of each field of a ``ppr_tpu`` graph, which
    carries a graph built by the JAX package across unchanged."""
    if arrays.get("edge_coef") is not None or \
            arrays.get("alias_prob") is not None:
        raise NotImplementedError(
            "weighted graphs and alias tables are not ported yet "
            "(ROADMAP.md, queue 1, slice B)"
        )
    device = resolve_device(device)
    # np.array copies: the tensors own their memory (a JAX array's host
    # view is read-only)
    t = {k: torch.as_tensor(np.array(arrays[k], np.int32), device=device)
         for k in _INDEX_FIELDS}
    t.update({k: torch.as_tensor(np.array(arrays[k], np.float32),
                                 device=device)
              for k in _FLOAT_FIELDS})
    n_pad = int(t["out_deg"].shape[0])
    ptr = _segment_ptr(np.asarray(arrays["edge_dst_bydst"]), n_pad)
    ptr_src = _segment_ptr(np.asarray(arrays["edge_src"]), n_pad)
    dense = arrays.get("dense_out")
    return Graph(
        **t,
        bydst_ptr=torch.as_tensor(ptr, device=device),
        bysrc_ptr=torch.as_tensor(ptr_src, device=device),
        dense_out=(None if dense is None else torch.as_tensor(
            np.array(dense, np.float32), device=device)),
        n=int(arrays["n"]),
        m=int(arrays["m"]),
    )


def build_graph(
    src: np.ndarray,
    dst: np.ndarray,
    n: int,
    *,
    weights: np.ndarray | None = None,
    dense_threshold: int = 4096,
    node_align: int = LANES,
    edge_align: int = LANES,
    device=None,
) -> Graph:
    """Build a :class:`Graph` from a directed COO edge list ``src[i] ->
    dst[i]`` over node ids ``0..n-1`` (parallel edges and self-loops kept).

    When ``n_pad <= dense_threshold`` the dense row-normalized out-operator
    is materialized too (the oracle's and K1's operand)."""
    if weights is not None:
        raise NotImplementedError(
            "weighted graphs are not ported yet (ROADMAP.md, queue 1, slice B)"
        )
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    m = int(src.shape[0])
    if m and (src.min() < 0 or src.max() >= n or dst.min() < 0
              or dst.max() >= n):
        raise ValueError("edge endpoint out of range")

    n_pad = max(_round_up(n + 1, node_align), node_align)
    m_pad = max(_round_up(max(m, 1), edge_align), edge_align)

    order = np.argsort(src, kind="stable")
    src_s = src[order]
    dst_s = dst[order]
    out_deg = np.bincount(src_s, minlength=n_pad).astype(np.int32)
    in_deg = np.bincount(dst_s, minlength=n_pad).astype(np.int32)
    indptr = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(out_deg, out=indptr[1:])

    pad_node = n_pad - 1
    indices = np.full(m_pad, pad_node, dtype=np.int32)
    indices[:m] = dst_s
    edge_src = np.full(m_pad, pad_node, dtype=np.int32)
    edge_src[:m] = src_s
    edge_mask = np.zeros(m_pad, dtype=np.float32)
    edge_mask[:m] = 1.0

    order_d = np.argsort(dst_s, kind="stable")
    edge_src_bydst = np.full(m_pad, pad_node, dtype=np.int32)
    edge_src_bydst[:m] = src_s[order_d]
    edge_dst_bydst = np.full(m_pad, pad_node, dtype=np.int32)
    edge_dst_bydst[:m] = dst_s[order_d]

    node_mask = np.zeros(n_pad, dtype=np.float32)
    node_mask[:n] = 1.0

    dense_out = None
    if n_pad <= dense_threshold:
        dense_out = np.zeros((n_pad, n_pad), dtype=np.float32)
        if m:
            inv_deg = 1.0 / out_deg[src_s].astype(np.float64)
            np.add.at(dense_out, (src_s, dst_s), inv_deg)

    # src-sorted edge_dst is the CSR indices array itself
    return graph_from_numpy(dict(
        indptr=indptr, indices=indices, edge_src=edge_src, edge_dst=indices,
        edge_mask=edge_mask, edge_src_bydst=edge_src_bydst,
        edge_dst_bydst=edge_dst_bydst, out_deg=out_deg, in_deg=in_deg,
        node_mask=node_mask, dense_out=dense_out, n=n, m=m,
    ), device=device)
