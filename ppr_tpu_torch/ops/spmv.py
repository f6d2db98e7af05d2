"""Push operators — port of ``ppr_tpu/ops/spmv.py``.

:func:`push_out` computes ``y[u] = sum over edges v->u of a[v] / d_out(v)``
and :func:`pull_out_norm`, the reverse step, ``y[u] = (1/d_out(u)) * sum
over edges u->v of a[v]``, on batched node vectors. On a weighted graph
the edge's coefficient ``c_e = w_e / W_src`` takes the place of the
``1/d_out`` scaling: ``push_out`` sums ``c_e a[v]`` and ``pull_out_norm``
``c_e a[v]`` over ``u``'s out-edges, with no ``1/d_out`` after the sum.
Three backends:

* **dense** (``g.dense_out`` present, the default there): one full-f32
  matmul (TF32 off, the counterpart of the JAX package's
  ``Precision.HIGHEST``); ``dense_out`` holds ``1/d`` or the coefficients.
* **coo_sorted** (the default otherwise): gather the ``[B]``-wide rows of
  the node-major operand at one end of each edge, then sum them per node at
  the other end, over edges sorted by that end: ``push_out`` gathers at
  ``edge_src_bydst`` (with ``edge_coef_bydst``) and sums over
  ``g.bydst_ptr``; ``pull_out_norm`` gathers at ``edge_dst`` (the primary,
  source-sorted order, with ``edge_coef``) and sums over ``g.bysrc_ptr``.
  Each node's sum runs in edge order: no atomics, so a sweep gives the same
  bits every run. On a CUDA operand that gather and sum is one kernel, K3
  (``ops/row_gather.py``), in its coefficient mode on a weighted graph; on
  the CPU it is ``index_select`` (times the coefficient) plus
  ``torch.segment_reduce``.
* **coo**: the per-edge contributions scattered with ``index_add_`` over
  the unsorted edge list, as XLA's scatter-add was on the TPU. No path
  takes it (ROADMAP.md, queue 1, item 22); on the card its adds are atomics
  and its last bits vary from run to run.

:func:`push_out_chunked` (batch-major) and :func:`push_out_chunked_t`
(node-major) walk the edges in slices on the CPU to bound the per-edge
intermediate; on the card they launch K3, which writes none.

All mask padding edges (they sit on the sentinel node, whose row is zero,
and carry coefficient 0) and drop mass at dangling nodes; callers re-inject
it.
"""

from __future__ import annotations

import torch

from ..device import set_exact_f32_matmul
from ..graph.csr import Graph
from . import row_gather


def _safe_inv_deg(deg: torch.Tensor) -> torch.Tensor:
    d = deg.to(torch.float32)
    return torch.where(deg > 0, 1.0 / torch.clamp_min(d, 1.0),
                       torch.zeros_like(d))


def gather_segment_sum(table_t: torch.Tensor, src: torch.Tensor,
                       ptr: torch.Tensor, num_chunks: int = 1,
                       coef: torch.Tensor | None = None) -> torch.Tensor:
    """``out[d] = sum of coef[e] * table_t[src[e]]`` (``coef`` 1 when it is
    ``None``) over the edges ``e`` of segment ``d``, ``[ptr[d], ptr[d+1])``,
    for edges sorted by segment.

    A CUDA operand launches K3 (``row_gather.gather_segment_sum``) whatever
    ``num_chunks`` is: chunking exists only to bound the ``[m, B]`` per-edge
    intermediate, which the kernel never writes. On the CPU ``num_chunks >
    1`` walks the edges in that many consecutive slices, so the intermediate
    is ``[m / num_chunks, B]``; each slice of sorted edges is sorted, its
    row pointer is ``ptr`` clamped to the slice, and ``coef`` is sliced as
    ``src`` is."""
    if table_t.device.type != "cpu":
        return row_gather.gather_segment_sum(table_t, src, ptr, coef=coef)
    if num_chunks <= 1:
        return row_gather.gather_segment_sum_ref(table_t, src, ptr, coef)
    m = src.shape[0]
    chunk = -(-m // num_chunks)
    out = torch.zeros_like(table_t)
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        out = out + row_gather.gather_segment_sum_ref(
            table_t, src[lo:hi], ptr.clamp(lo, hi) - lo,
            None if coef is None else coef[lo:hi])
    return out


def _node_major(g: Graph, a: torch.Tensor):
    """``(a_t [n_pad, B], lead)``: the node-major copy of ``a [..., n_pad]``
    and its leading shape."""
    return a.reshape(-1, g.n_pad).T.contiguous(), a.shape[:-1]


def _check_backend(backend: str) -> None:
    if backend not in ("dense", "coo_sorted", "coo"):
        raise ValueError(f"unknown backend {backend!r}: dense, coo_sorted "
                         "or coo")


def push_out(g: Graph, a: torch.Tensor, *, backend: str | None = None
             ) -> torch.Tensor:
    """``y[u] = sum over edges v->u of a[v] / d_out(v)`` (``c_e a[v]`` on a
    weighted graph), batched over leading dims."""
    if backend is None:
        backend = "dense" if g.has_dense else "coo_sorted"
    _check_backend(backend)
    if backend == "dense":
        set_exact_f32_matmul()
        return torch.matmul(a, g.dense_out)
    if backend == "coo":
        # per-edge contribution gathered at the source, scattered to the
        # destination
        if g.weighted:
            contrib = a.index_select(-1, g.edge_src) * g.edge_coef
        else:
            contrib = (a * _safe_inv_deg(g.out_deg)).index_select(
                -1, g.edge_src)
        return torch.zeros_like(a).index_add_(
            a.dim() - 1, g.edge_dst, contrib * g.edge_mask)
    if g.weighted:
        a_t, lead = _node_major(g, a)
        out_t = gather_segment_sum(a_t, g.edge_src_bydst, g.bydst_ptr,
                                   coef=g.edge_coef_bydst)
    else:
        scaled_t, lead = _node_major(g, a * _safe_inv_deg(g.out_deg))
        out_t = gather_segment_sum(scaled_t, g.edge_src_bydst, g.bydst_ptr)
    return out_t.T.reshape(*lead, g.n_pad)


def push_out_t(g: Graph, a_t: torch.Tensor) -> torch.Tensor:
    """``push_out`` on a node-major operand ``a_t: [n_pad, B]``."""
    if g.has_dense:
        # y^T = D^T @ a^T
        set_exact_f32_matmul()
        return torch.matmul(g.dense_out.T, a_t)
    return push_out_chunked_t(g, a_t, num_chunks=1)


def push_out_chunked_t(g: Graph, a_t: torch.Tensor, *, num_chunks: int = 16
                       ) -> torch.Tensor:
    """:func:`push_out_t` by sorted segmented sum, with the edges in
    ``num_chunks`` sequential slices, bounding the per-edge intermediate to
    ``[m_pad / num_chunks, B]`` (on the CPU; K3 on the card has none)."""
    if g.weighted:
        return gather_segment_sum(a_t, g.edge_src_bydst, g.bydst_ptr,
                                  num_chunks, coef=g.edge_coef_bydst)
    scaled_t = a_t * _safe_inv_deg(g.out_deg)[:, None]
    return gather_segment_sum(scaled_t, g.edge_src_bydst, g.bydst_ptr,
                              num_chunks)


def push_out_chunked(g: Graph, a: torch.Tensor, *, num_chunks: int = 16
                     ) -> torch.Tensor:
    """:func:`push_out_chunked_t` on a batch-major operand ``a [...,
    n_pad]``: K3 on the card, ``num_chunks`` slices of the edges on the
    CPU. On a weighted graph it scales by the coefficients, as every other
    push here does, where the JAX package's scales by ``1/d_out`` (ROADMAP.md,
    queue 1, item 22)."""
    a_t, lead = _node_major(g, a)
    out_t = push_out_chunked_t(g, a_t, num_chunks=num_chunks)
    return out_t.T.reshape(*lead, g.n_pad)


def pull_out_norm(g: Graph, a: torch.Tensor, *, backend: str | None = None
                  ) -> torch.Tensor:
    """``y[u] = (1/d_out(u)) * sum over edges u->v of a[v]`` (``sum of c_e
    a[v]`` on a weighted graph): the reverse push step, batched over
    leading dims."""
    if backend is None:
        backend = "dense" if g.has_dense else "coo_sorted"
    _check_backend(backend)
    if backend == "dense":
        set_exact_f32_matmul()
        return torch.matmul(a, g.dense_out.T)
    if backend == "coo":
        # residue gathered at the edge's destination, scattered to its
        # source
        contrib = a.index_select(-1, g.edge_dst) * g.edge_mask
        if g.weighted:
            return torch.zeros_like(a).index_add_(
                a.dim() - 1, g.edge_src, contrib * g.edge_coef)
        return torch.zeros_like(a).index_add_(
            a.dim() - 1, g.edge_src, contrib) * _safe_inv_deg(g.out_deg)
    # the primary edge order is source-sorted: gather at the destination,
    # sum per source, then (uniform graphs) scale by 1/d_out after the sum,
    # as JAX does
    a_t, lead = _node_major(g, a)
    if g.weighted:
        out_t = gather_segment_sum(a_t, g.edge_dst, g.bysrc_ptr,
                                   coef=g.edge_coef)
        return out_t.T.reshape(*lead, g.n_pad)
    out_t = gather_segment_sum(a_t, g.edge_dst, g.bysrc_ptr)
    return out_t.T.reshape(*lead, g.n_pad) * _safe_inv_deg(g.out_deg)
