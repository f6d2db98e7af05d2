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

``auto_num_hubs`` is not ported: its constants were measured on a TPU v5e.
Callers pass an explicit hub count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import set_exact_f32_matmul
from ..graph.csr import Graph, _segment_ptr
from .spmv import _safe_inv_deg, gather_segment_sum


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


def build_hub_split(g: Graph, num_hubs: int = 512,
                    dtype: torch.dtype = torch.float32) -> HubSplit:
    """Host-side construction from the destination-sorted edge view."""
    if num_hubs == "auto":
        raise NotImplementedError(
            "auto_num_hubs runs on TPU v5e constants and is not ported; "
            "pass an explicit hub count (ROADMAP.md, queue 1, item 4)"
        )
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"hub dtype must be float32 or bfloat16, got {dtype}")
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
    hub_matrix = np.zeros((g.n_pad, num_hubs), np.float32)
    np.add.at(hub_matrix, (src[to_hub], hub_pos[dst[to_hub]]), 1.0)

    t_src, t_dst = src[~to_hub], dst[~to_hub]
    m_tail = int(t_src.size)
    mt_pad = max(128, ((m_tail + 127) // 128) * 128)
    tail_src = np.full(mt_pad, g.n_pad - 1, np.int32)
    tail_dst = np.full(mt_pad, g.n_pad - 1, np.int32)
    tail_src[:m_tail] = t_src
    tail_dst[:m_tail] = t_dst

    dev = g.device
    store = dtype if dev.type == "cuda" else torch.float32
    return HubSplit(
        hub_ids=torch.as_tensor(hub_ids, device=dev),
        hub_matrix=torch.as_tensor(hub_matrix, device=dev).to(store),
        tail_src=torch.as_tensor(tail_src, device=dev),
        tail_dst=torch.as_tensor(tail_dst, device=dev),
        tail_ptr=torch.as_tensor(_segment_ptr(tail_dst, g.n_pad), device=dev),
        num_hubs=num_hubs,
        m_tail=m_tail,
        dtype=dtype,
    )


def hub_product_t(hs: HubSplit, scaled_t: torch.Tensor) -> torch.Tensor:
    """``hub_matrix^T @ scaled_t`` -> f32 ``[H, B]``, with the operand in
    ``hs.dtype``."""
    if hs.dtype == torch.float32:
        set_exact_f32_matmul()
        return torch.matmul(hs.hub_matrix.T, scaled_t)
    rhs = scaled_t.to(torch.bfloat16)
    if scaled_t.is_cuda:
        return torch.mm(hs.hub_matrix.T, rhs, out_dtype=torch.float32)
    set_exact_f32_matmul()
    return torch.matmul(hs.hub_matrix.T, rhs.float())


def push_out_hybrid_t(g: Graph, hs: HubSplit, a_t: torch.Tensor, *,
                      num_chunks: int = 1) -> torch.Tensor:
    """Hybrid push on a node-major operand ``a_t: [n_pad, B]``;
    ``num_chunks > 1`` walks the tail edges in sequential slices."""
    scaled_t = a_t * _safe_inv_deg(g.out_deg)[:, None]        # [n_pad, B]
    hub_vals_t = hub_product_t(hs, scaled_t)                  # [H, B]
    out_t = gather_segment_sum(scaled_t, hs.tail_src, hs.tail_ptr,
                               num_chunks)
    return out_t.index_add_(0, hs.hub_ids, hub_vals_t)
