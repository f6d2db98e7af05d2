"""Hub-split hybrid push — port of ``ppr_tpu/ops/hub_split.py``.

The ``H`` nodes of largest in-degree receive their incoming mass through
one dense product instead of a segmented sum over their edges:

    y[hub_h] = sum_v a[v]/d_v * (#edges v->hub_h)  ==  (a * inv_deg) @ M[:, h]

and the remaining (tail) edges go through the sorted gather + segmented sum
of :func:`ppr_tpu_torch.ops.spmv.gather_segment_sum` (K3 on the card). Tail
edges never end at a hub, so the tail result is zero on hub rows and the hub
rows are a plain add.

bf16 hubs: the product runs on bf16 operands with an f32 result, as the
JAX package's ``preferred_element_type=f32`` does. On the card that is
``torch.mm(..., out_dtype=torch.float32)`` (cuBLAS; the JAX package leaves
this GEMM to XLA too). PyTorch has no CPU kernel for that call, so on the
CPU the matrix stays f32 (edge multiplicities are small integers, exact in
both types), the operand is rounded through bf16, and the product runs in
f32 — the same arithmetic.

A weighted graph has no hub split: the hub matrix holds edge
multiplicities scaled by ``1/d_v``, and :func:`build_hub_split` refuses
one, as the JAX package does.

``num_hubs="auto"`` takes :func:`auto_num_hubs`, the JAX package's rule
with prices measured on the H100 in place of its TPU v5e ones
(``hub_knee_torch.py --constants``).

:func:`push_out_hybrid_t` (node-major) is the propagation loops' push;
:func:`push_out_hybrid` is its batch-major form, the JAX package's, which
no path calls (ROADMAP.md, queue 1, item 22).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import set_exact_f32_matmul
from ..graph.csr import Graph, _segment_ptr
from .spmv import _safe_inv_deg, gather_segment_sum


#: K3's device time an edge over the bench graph's tail
#: (``synthetic_powerlaw(65536, 16, seed=42)``, 4096 hubs, 323,184 tail
#: edges) at B = ``REF_BATCH``, by CUDA-graph replays with L2 flushed
#: (``hub_knee_torch.py --constants``; NVIDIA H100 80GB HBM3, 700.00 W)
TAIL_NS_PER_EDGE = 0.4284
#: ``n_pad * 2 / col_ns`` in GB/s, ``col_ns`` the time one more column adds
#: to the bf16 hub product ``[REF_BATCH, n_pad] x [n_pad, H]`` with f32
#: output, the slope over H 2048 -> 4096 by CUDA-graph replays, same
#: graph and script (NVIDIA H100 80GB HBM3, 700.00 W)
HUB_COLUMN_GBPS = 1635.5
#: the batch both prices were measured at: the middle of the range where
#: ``"auto"`` is used (``bench_torch.py`` below B 1024, the serving rungs)
REF_BATCH = 512
#: the JAX package's cap on the hub matrix
MAX_MATRIX_BYTES = 4 << 30


def auto_num_hubs(g: Graph, dtype: torch.dtype = torch.float32, *,
                  tail_ns_per_edge: float = TAIL_NS_PER_EDGE,
                  hbm_gbps: float = HUB_COLUMN_GBPS,
                  max_matrix_bytes: int = MAX_MATRIX_BYTES) -> int:
    """The JAX package's marginal-benefit hub count
    (``ppr_tpu/ops/hub_split.py:47-69``): node v is a hub while the sparse
    cost of its in-edges, ``in_deg(v) * tail_ns_per_edge``, exceeds the
    cost of one more dense column, ``col_ns = n_pad * itemsize /
    hbm_gbps``. The count is capped so that the matrix stays under
    ``max_matrix_bytes`` and rounded down to a multiple of 128, at least
    128.

    On the card the names mean: ``tail_ns_per_edge`` is K3's time an edge
    of the tail at B ``REF_BATCH``; ``hbm_gbps`` is not the memory's rate
    but the effective rate of one more hub column of the bf16 product at
    that batch, which is bound by its operations there, not by reading
    the column (both measured on an NVIDIA H100 80GB HBM3 at 700.00 W; see
    ``TAIL_NS_PER_EDGE`` and ``HUB_COLUMN_GBPS``). Both prices grow with
    B; the rule takes them at one batch and does not follow B. As in the
    JAX package it only needs them to within ~2x."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    col_ns = g.n_pad * itemsize / hbm_gbps   # bytes / (GB/s) == ns
    min_deg = max(col_ns / tail_ns_per_edge, 1.0)
    in_deg = g.in_deg[: g.n].cpu().numpy()
    h = int((in_deg > min_deg).sum())
    h = min(h, max_matrix_bytes // max(g.n_pad * itemsize, 1), g.n)
    return max(128, (h // 128) * 128) if h else 128


@dataclasses.dataclass(frozen=True)
class HubSplit:
    hub_ids: torch.Tensor      # int32[H] node ids (largest in-degree)
    hub_matrix: torch.Tensor   # [n_pad, H]; [v, h] = multiplicity(v->hub_h)
    tail_src: torch.Tensor     # int32[mt_pad] dst-sorted tail edges
    tail_dst: torch.Tensor     # int32[mt_pad]
    tail_ptr: torch.Tensor     # int64[n_pad + 1] row pointer of tail_dst
    num_hubs: int
    m_tail: int
    dtype: torch.dtype         # operand type of the hub product


def build_hub_split(g: Graph, num_hubs: int | str = 512,
                    dtype: torch.dtype = torch.float32) -> HubSplit:
    """Construction from the destination-sorted edge view; ``num_hubs=
    "auto"`` takes :func:`auto_num_hubs` with its card-measured prices.

    The hub matrix is written on the graph's device from each (source,
    hub) pair's edge count, so no ``[n_pad, H]`` f32 matrix is made on the
    host (4.3 GB at n = 2^20 and 1024 hubs). The counts are exact in f32,
    and the bf16 matrix rounds them as the JAX package's cast of its f32
    matrix does."""
    if g.weighted:
        raise NotImplementedError("hub split supports uniform graphs")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hub dtype must be float32 or bfloat16, got {dtype}")
    if num_hubs == "auto":
        num_hubs = auto_num_hubs(g, dtype)
    num_hubs = int(min(num_hubs, g.n))
    in_deg = g.in_deg[: g.n].cpu().numpy()
    hub_ids = np.argsort(-in_deg, kind="stable")[:num_hubs].astype(np.int32)
    is_hub = np.zeros(g.n_pad, bool)
    is_hub[hub_ids] = True

    src = g.edge_src_bydst[: g.m].cpu().numpy()
    dst = g.edge_dst_bydst[: g.m].cpu().numpy()
    hub_pos = np.full(g.n_pad, -1, np.int64)
    hub_pos[hub_ids] = np.arange(num_hubs)

    to_hub = is_hub[dst]
    # raw multiplicities: the consumer scales by 1/d_v first
    cells, counts = np.unique(
        src[to_hub].astype(np.int64) * num_hubs + hub_pos[dst[to_hub]],
        return_counts=True)

    t_src, t_dst = src[~to_hub], dst[~to_hub]
    m_tail = int(t_src.size)
    mt_pad = max(128, ((m_tail + 127) // 128) * 128)
    tail_src = np.full(mt_pad, g.n_pad - 1, np.int32)
    tail_dst = np.full(mt_pad, g.n_pad - 1, np.int32)
    tail_src[:m_tail] = t_src
    tail_dst[:m_tail] = t_dst

    dev = g.device
    store = dtype if dev.type == "cuda" else torch.float32
    hub_matrix = torch.zeros((g.n_pad, num_hubs), dtype=store, device=dev)
    hub_matrix.view(-1)[torch.as_tensor(cells, device=dev)] = \
        torch.as_tensor(counts.astype(np.float32), device=dev).to(store)
    return HubSplit(
        hub_ids=torch.as_tensor(hub_ids, device=dev),
        hub_matrix=hub_matrix,
        tail_src=torch.as_tensor(tail_src, device=dev),
        tail_dst=torch.as_tensor(tail_dst, device=dev),
        tail_ptr=torch.as_tensor(_segment_ptr(tail_dst, g.n_pad), device=dev),
        num_hubs=num_hubs,
        m_tail=m_tail,
        dtype=dtype,
    )


def hub_product_t(hs: HubSplit, scaled_t: torch.Tensor,
                  rhs: torch.Tensor | None = None) -> torch.Tensor:
    """``hub_matrix^T @ scaled_t`` -> f32 ``[H, B]``, with the operand in
    ``hs.dtype``; ``rhs``, where given, is ``scaled_t`` already cast to
    bf16 (the annealed loop's pre pass writes it)."""
    if hs.dtype == torch.float32:
        set_exact_f32_matmul()
        return torch.matmul(hs.hub_matrix.T, scaled_t)
    if rhs is None:
        rhs = scaled_t.to(torch.bfloat16)
    if scaled_t.is_cuda:
        return torch.mm(hs.hub_matrix.T, rhs, out_dtype=torch.float32)
    set_exact_f32_matmul()
    return torch.matmul(hs.hub_matrix.T, rhs.float())


def push_out_hybrid_t(g: Graph, hs: HubSplit, a_t: torch.Tensor, *,
                      num_chunks: int = 1) -> torch.Tensor:
    """Hybrid push on a node-major operand ``a_t: [n_pad, B]``;
    ``num_chunks > 1`` walks the tail edges in sequential slices."""
    return push_scaled_hybrid_t(hs, a_t * _safe_inv_deg(g.out_deg)[:, None],
                                num_chunks=num_chunks)


def push_scaled_hybrid_t(hs: HubSplit, scaled_t: torch.Tensor,
                         rhs: torch.Tensor | None = None, *,
                         num_chunks: int = 1) -> torch.Tensor:
    """:func:`push_out_hybrid_t` of an operand already scaled by
    ``1/d_out`` (``[n_pad, B]``), ``rhs`` its bf16 copy or None."""
    hub_vals_t = hub_product_t(hs, scaled_t, rhs)             # [H, B]
    out_t = gather_segment_sum(scaled_t, hs.tail_src, hs.tail_ptr,
                               num_chunks)
    return out_t.index_add_(0, hs.hub_ids, hub_vals_t)


def push_out_hybrid(g: Graph, hs: HubSplit, a: torch.Tensor) -> torch.Tensor:
    """``push_out`` by the hub split on a batch-major operand ``a [...,
    n_pad]``: :func:`push_out_hybrid_t` on its node-major copy."""
    a_t = a.reshape(-1, g.n_pad).T.contiguous()
    return push_out_hybrid_t(g, hs, a_t).T.reshape(a.shape)
