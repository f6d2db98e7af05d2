"""Push operators — port of ``ppr_tpu/ops/spmv.py``.

:func:`push_out` computes ``y[u] = sum over edges v->u of a[v] / d_out(v)``
and :func:`pull_out_norm`, the reverse step, ``y[u] = (1/d_out(u)) * sum
over edges u->v of a[v]``, on batched node vectors. Two backends, picked
per graph:

* **dense** (``g.dense_out`` present): one full-f32 matmul (TF32 off, the
  counterpart of the JAX package's ``Precision.HIGHEST``).
* **coo_sorted**: gather the ``[B]``-wide rows of the node-major operand at
  one end of each edge, then sum them per node at the other end, over edges
  sorted by that end: ``push_out`` gathers at ``edge_src_bydst`` and sums
  over ``g.bydst_ptr``; ``pull_out_norm`` gathers at ``edge_dst`` (the
  primary, source-sorted order) and sums over ``g.bysrc_ptr``. Each node's
  sum runs in edge order: no atomics, so a sweep gives the same bits every
  run. On a CUDA operand that gather and sum is one kernel, K3
  (``ops/row_gather.py``); on the CPU it is ``index_select`` plus
  ``torch.segment_reduce``.

Both mask padding edges structurally (they sit on the sentinel node, whose
row is zero) and drop mass at dangling nodes; callers re-inject it.
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
                       ptr: torch.Tensor, num_chunks: int = 1
                       ) -> torch.Tensor:
    """``out[d] = sum of table_t[src[e]]`` over the edges ``e`` of segment
    ``d``, ``[ptr[d], ptr[d+1])``, for edges sorted by segment.

    A CUDA operand launches K3 (``row_gather.gather_segment_sum``) whatever
    ``num_chunks`` is: chunking exists only to bound the ``[m, B]`` per-edge
    intermediate, which the kernel never writes. On the CPU ``num_chunks >
    1`` walks the edges in that many consecutive slices, so the intermediate
    is ``[m / num_chunks, B]``; each slice of sorted edges is sorted, and
    its row pointer is ``ptr`` clamped to the slice."""
    if table_t.device.type != "cpu":
        return row_gather.gather_segment_sum(table_t, src, ptr)
    if num_chunks <= 1:
        return row_gather.gather_segment_sum_ref(table_t, src, ptr)
    m = src.shape[0]
    chunk = -(-m // num_chunks)
    out = torch.zeros_like(table_t)
    for lo in range(0, m, chunk):
        hi = min(lo + chunk, m)
        out = out + row_gather.gather_segment_sum_ref(
            table_t, src[lo:hi], ptr.clamp(lo, hi) - lo)
    return out


def _node_major(g: Graph, a: torch.Tensor):
    """``(a_t [n_pad, B], lead)``: the node-major copy of ``a [..., n_pad]``
    and its leading shape."""
    return a.reshape(-1, g.n_pad).T.contiguous(), a.shape[:-1]


def push_out(g: Graph, a: torch.Tensor, *, backend: str | None = None
             ) -> torch.Tensor:
    """``y[u] = sum over edges v->u of a[v] / d_out(v)`` (batched over
    leading dims)."""
    if backend is None:
        backend = "dense" if g.has_dense else "coo_sorted"
    if backend == "dense":
        set_exact_f32_matmul()
        return torch.matmul(a, g.dense_out)
    if backend != "coo_sorted":
        raise NotImplementedError(
            f"push_out backend {backend!r} is not ported "
            "(ROADMAP.md, queue 1: dense and coo_sorted only)"
        )
    scaled_t, lead = _node_major(g, a * _safe_inv_deg(g.out_deg))
    out_t = gather_segment_sum(scaled_t, g.edge_src_bydst, g.bydst_ptr)
    return out_t.T.reshape(*lead, g.n_pad)


def push_out_t(g: Graph, a_t: torch.Tensor) -> torch.Tensor:
    """``push_out`` on a node-major operand ``a_t: [n_pad, B]``."""
    if g.has_dense:
        # y^T = D^T @ a^T
        set_exact_f32_matmul()
        return torch.matmul(g.dense_out.T, a_t)
    scaled_t = a_t * _safe_inv_deg(g.out_deg)[:, None]
    return gather_segment_sum(scaled_t, g.edge_src_bydst, g.bydst_ptr)


def push_out_chunked_t(g: Graph, a_t: torch.Tensor, *, num_chunks: int = 16
                       ) -> torch.Tensor:
    """:func:`push_out_t` with the edges in ``num_chunks`` sequential slices,
    bounding the per-edge intermediate to ``[m_pad / num_chunks, B]`` (on
    the CPU; K3 on the card has none)."""
    scaled_t = a_t * _safe_inv_deg(g.out_deg)[:, None]
    return gather_segment_sum(scaled_t, g.edge_src_bydst, g.bydst_ptr,
                              num_chunks)


def pull_out_norm(g: Graph, a: torch.Tensor, *, backend: str | None = None
                  ) -> torch.Tensor:
    """``y[u] = (1/d_out(u)) * sum over edges u->v of a[v]`` (the reverse
    push step, batched over leading dims)."""
    if backend is None:
        backend = "dense" if g.has_dense else "coo_sorted"
    if backend == "dense":
        set_exact_f32_matmul()
        return torch.matmul(a, g.dense_out.T)
    if backend != "coo_sorted":
        raise NotImplementedError(
            f"pull_out_norm backend {backend!r} is not ported "
            "(ROADMAP.md, queue 1: dense and coo_sorted only)"
        )
    # the primary edge order is source-sorted: gather at the destination,
    # sum per source, then scale by 1/d_out after the sum, as JAX does
    a_t, lead = _node_major(g, a)
    out_t = gather_segment_sum(a_t, g.edge_dst, g.bysrc_ptr)
    return out_t.T.reshape(*lead, g.n_pad) * _safe_inv_deg(g.out_deg)
