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
* ``dang_ids`` lists the dangling real nodes (out-degree 0), whose mass the
  FORA loops return to the source every sweep. It is a graph constant, so
  it is built here once and no sweep loop asks the device for it.

* A weighted graph (``build_graph(weights=...)``) also carries
  ``edge_coef`` (``w_e / W_src``, the share of its source's weight an edge
  takes) in the source-sorted order and ``edge_coef_bydst`` in the
  destination-sorted one, with 0 on padding edges, and Walker alias tables
  (``alias_prob``, ``alias_other``) over the CSR slots for the walks'
  weighted neighbour draw. The coefficient takes the place of ``1/d_out``
  in every push, and ``dense_out`` holds it.

Construction runs on the host: the native C++ builder
(``ppr_tpu_torch/native``) where a compiler is found, for the CSR of an
unweighted graph and for the alias tables, else numpy (the argsort path of
the JAX package's ``build_graph``, with the same layout); the arrays then
move to the graph's device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import native
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
    dang_ids: torch.Tensor        # int64[#dangling]: out_deg 0, real node

    # --- optional dense operator (None for large graphs) ---
    dense_out: torch.Tensor | None  # float32[n_pad, n_pad]; row v = 1/d_v

    n: int
    m: int

    # --- weighted graphs only (None on a uniform graph) ---
    edge_coef: torch.Tensor | None = None        # f32[m_pad], src-sorted
    edge_coef_bydst: torch.Tensor | None = None  # f32[m_pad], dst-sorted
    alias_prob: torch.Tensor | None = None       # f32[m_pad]
    alias_other: torch.Tensor | None = None      # int32[m_pad], global slot

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
    def weighted(self) -> bool:
        return self.edge_coef is not None

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
#: the weighted graph's fields, present together or not at all
_WEIGHTED_FIELDS = {"edge_coef": np.float32, "edge_coef_bydst": np.float32,
                    "alias_prob": np.float32, "alias_other": np.int32}


def graph_from_numpy(arrays: dict, device=None) -> Graph:
    """A :class:`Graph` from host arrays keyed by field name, plus ``n`` and
    ``m`` — e.g. ``np.asarray`` of each field of a ``ppr_tpu`` graph, which
    carries a graph built by the JAX package across unchanged, weighted
    fields and alias tables included."""
    device = resolve_device(device)

    def tensor(value, dtype):
        # np.array copies: the tensors own their memory (a JAX array's
        # host view is read-only)
        return torch.as_tensor(np.array(value, dtype), device=device)

    t = {k: tensor(arrays[k], np.int32) for k in _INDEX_FIELDS}
    t.update({k: tensor(arrays[k], np.float32) for k in _FLOAT_FIELDS})
    given = {k for k in _WEIGHTED_FIELDS if arrays.get(k) is not None}
    if given and given != set(_WEIGHTED_FIELDS):
        raise ValueError(f"a weighted graph needs all of "
                         f"{sorted(_WEIGHTED_FIELDS)}; got {sorted(given)}")
    t.update({k: tensor(arrays[k], dtype)
              for k, dtype in _WEIGHTED_FIELDS.items() if k in given})
    n_pad = int(t["out_deg"].shape[0])
    ptr = _segment_ptr(np.asarray(arrays["edge_dst_bydst"]), n_pad)
    ptr_src = _segment_ptr(np.asarray(arrays["edge_src"]), n_pad)
    dang = np.nonzero((np.asarray(arrays["out_deg"]) == 0)
                      & (np.asarray(arrays["node_mask"]) > 0))[0]
    dense = arrays.get("dense_out")
    return Graph(
        **t,
        bydst_ptr=torch.as_tensor(ptr, device=device),
        bysrc_ptr=torch.as_tensor(ptr_src, device=device),
        dang_ids=torch.as_tensor(dang.astype(np.int64), device=device),
        dense_out=None if dense is None else tensor(dense, np.float32),
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

    ``weights`` (strictly positive, one an edge) makes the graph weighted:
    an edge's coefficient is ``w / w_sum[src]``, computed in float64 and
    stored in float32, and the alias tables are built over the CSR slots.
    When ``n_pad <= dense_threshold`` the dense row-normalized out-operator
    is materialized too (the oracle's and K1's operand): ``1/d_v``, or the
    coefficients, at each row's out-neighbours."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.shape != dst.shape:
        raise ValueError(f"src/dst shape mismatch: {src.shape} vs {dst.shape}")
    if weights is not None:
        weights = np.asarray(weights, np.float64)
        if weights.shape != src.shape:
            raise ValueError("weights shape mismatch")
        if (weights <= 0).any():
            raise ValueError("edge weights must be strictly positive")
    m = int(src.shape[0])
    if m and (src.min() < 0 or src.max() >= n or dst.min() < 0
              or dst.max() >= n):
        raise ValueError("edge endpoint out of range")

    n_pad = max(_round_up(n + 1, node_align), node_align)
    m_pad = max(_round_up(max(m, 1), edge_align), edge_align)

    # CSR order, stable by source: the native counting sort for uniform
    # graphs (the JAX package skips it for weighted ones), else argsort
    csr = native.build_csr_native(src, dst, n, n_pad) \
        if m and weights is None else None
    w_s = None
    if csr is not None:
        indptr, dst_s, src_s, out_deg, in_deg = csr
        src_s = src_s.astype(np.int64)
        dst_s = dst_s.astype(np.int64)
    else:
        order, indptr, dst_s, src_s, out_deg, in_deg = csr_numpy(
            src, dst, n_pad)
        if weights is not None:
            w_s = weights[order]

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

    weighted = {}
    coef = None
    if w_s is not None and m:
        w_sum = np.zeros(n_pad, np.float64)
        np.add.at(w_sum, src_s, w_s)
        coef = w_s / w_sum[src_s]                 # float64
        edge_coef = np.zeros(m_pad, np.float32)   # padding edges carry 0
        edge_coef[:m] = coef
        edge_coef_bydst = np.zeros(m_pad, np.float32)
        edge_coef_bydst[:m] = coef[order_d]
        alias_prob, alias_other = build_alias_tables(indptr, coef, m_pad)
        weighted = dict(edge_coef=edge_coef, edge_coef_bydst=edge_coef_bydst,
                        alias_prob=alias_prob, alias_other=alias_other)

    dense_out = None
    if n_pad <= dense_threshold:
        dense_out = np.zeros((n_pad, n_pad), dtype=np.float32)
        if m:
            scale = coef if coef is not None else \
                1.0 / out_deg[src_s].astype(np.float64)
            np.add.at(dense_out, (src_s, dst_s), scale)

    # src-sorted edge_dst is the CSR indices array itself
    return graph_from_numpy(dict(
        indptr=indptr, indices=indices, edge_src=edge_src, edge_dst=indices,
        edge_mask=edge_mask, edge_src_bydst=edge_src_bydst,
        edge_dst_bydst=edge_dst_bydst, out_deg=out_deg, in_deg=in_deg,
        node_mask=node_mask, dense_out=dense_out, n=n, m=m, **weighted,
    ), device=device)


def graph_from_scipy(mat, **kwargs) -> Graph:
    """Build from a ``scipy.sparse`` matrix where ``mat[i, j] != 0`` is edge
    i->j; ``kwargs`` go to :func:`build_graph` (``device=None`` is the
    card)."""
    coo = mat.tocoo()
    return build_graph(coo.row, coo.col, n=mat.shape[0], **kwargs)


def summarize(g: Graph) -> dict:
    """Host-side summary (for logs and harness headers)."""
    out_deg = g.out_deg[: g.n].cpu().numpy()
    return {
        "n": g.n,
        "m": g.m,
        "n_pad": g.n_pad,
        "m_pad": g.m_pad,
        "dangling": int((out_deg == 0).sum()),
        "max_out_deg": int(out_deg.max()) if g.n else 0,
        "dense": g.has_dense,
    }


def csr_numpy(src: np.ndarray, dst: np.ndarray, n_pad: int):
    """The numpy path of the CSR, ``(order, indptr, dst_s, src_s, out_deg,
    in_deg)``: the stable argsort by source of the JAX package's
    ``build_graph``, with the native builder's arrays (``dst_s`` and
    ``src_s`` int64) and the order that sorts per-edge data alike."""
    order = np.argsort(src, kind="stable")
    src_s = src[order]
    dst_s = dst[order]
    out_deg = np.bincount(src_s, minlength=n_pad).astype(np.int32)
    in_deg = np.bincount(dst_s, minlength=n_pad).astype(np.int32)
    indptr = np.zeros(n_pad + 1, dtype=np.int64)
    np.cumsum(out_deg, out=indptr[1:])
    return order, indptr.astype(np.int32), dst_s, src_s, out_deg, in_deg


def build_alias_tables(indptr: np.ndarray, coef: np.ndarray, m_pad: int):
    """Walker's alias method per CSR segment, ``(prob f32[m_pad], other
    int32[m_pad])``: slot ``j`` of node ``v`` keeps its own target with
    probability ``prob[j]``, else moves to the global slot ``other[j]``;
    padding slots and single-edge nodes keep their own. The native builder
    when it is available (it reads ``coef`` as float32), else this loop
    over the nodes (on the float64 coefficients), as the JAX package's
    ``_build_alias_tables``; ``prob`` is ``float32(q)`` of a float64
    ``q`` on both."""
    tables = native.build_alias_native(indptr, coef, m_pad)
    if tables is not None:
        return tables
    return alias_tables_python(indptr, coef, m_pad)


def alias_tables_python(indptr: np.ndarray, coef: np.ndarray, m_pad: int):
    """:func:`build_alias_tables` by the loop over the nodes, the path
    without a compiler."""
    prob = np.ones(m_pad, np.float32)
    other = np.arange(m_pad, dtype=np.int32)
    indptr = np.asarray(indptr)
    for v in range(len(indptr) - 1):
        lo, hi = int(indptr[v]), int(indptr[v + 1])
        d = hi - lo
        if d <= 1:
            continue
        q = coef[lo:hi].astype(np.float64) * d
        small = [j for j in range(d) if q[j] < 1.0]
        large = [j for j in range(d) if q[j] >= 1.0]
        while small and large:
            s_j = small.pop()
            l_j = large.pop()
            prob[lo + s_j] = q[s_j]
            other[lo + s_j] = lo + l_j
            q[l_j] = q[l_j] - (1.0 - q[s_j])
            (small if q[l_j] < 1.0 else large).append(l_j)
        for j in small + large:
            prob[lo + j] = 1.0
            other[lo + j] = lo + j
    return prob, other
