"""K1 and K2: fused dense propagation — ports of
``ppr_tpu/ops/pallas_dense.py::dense_power_iterations`` and
``::dense_pagerank_iterations``.

For graphs with a dense operator ``W = g.dense_out`` of ``n_pad <= 1024``,
one CUDA kernel (``csrc/dense_power.cu``) runs all ``iters`` rounds with
the batch state on chip. K1, the power method:

    p += alpha * r
    r  = (1-alpha) * [ (r - r_dang) @ W + sum(r_dang) * e_src ]

(``dangling_to_source=False`` drops the ``sum(r_dang)`` term). K2, the
Neo4j-library iteration, un-normalized:

    x = (1-d) * e_src + d * x @ W,    x0 = (1-d) * e_src

The products are full f32 (FP32 FMA), as the TPU kernels'
``Precision.HIGHEST``.

The kernels split W's columns across a thread block cluster: each block
streams its 128-column slice of W and reads the round's x from its peers'
shared memory (the source's note gives the design).

``*_ref`` are the same computations in plain PyTorch. A wrapper runs its
plain version only for a tensor that lies on the CPU; for a CUDA tensor it
runs the toolchain probe K0 once (``ops/probe.py``, where the JAX package
runs its canary), then launches its kernel or raises.
"""

from __future__ import annotations

import torch

from ..device import set_exact_f32_matmul
from ..graph.csr import Graph
from . import cuda_build, probe

MAX_N_PAD = 1024

#: K1 launches in this process (reset it to count a run's launches)
launches = 0
#: K2 launches in this process
pagerank_launches = 0


def supports(g: Graph) -> bool:
    """The graph has a dense operator within the kernel's size, on CUDA."""
    return g.has_dense and g.n_pad <= MAX_N_PAD and g.device.type == "cuda"


def _dangling_mask(g: Graph) -> torch.Tensor:
    return ((g.out_deg == 0) & (g.node_mask > 0)).to(torch.float32)


def dense_power_iterations_ref(g: Graph, src_onehot: torch.Tensor,
                               alpha: float, iters: int, *,
                               dangling_to_source: bool = True
                               ) -> torch.Tensor:
    """Plain PyTorch K1: the reserve ``p``, f32 ``[B, n_pad]``."""
    set_exact_f32_matmul()
    dang = _dangling_mask(g)[None, :]
    inv_keep = 1.0 - alpha
    p = torch.zeros_like(src_onehot)
    r = src_onehot
    for _ in range(iters):
        p = p + alpha * r
        r_dang = r * dang
        pushed = torch.matmul(r - r_dang, g.dense_out)
        if dangling_to_source:
            dang_mass = r_dang.sum(dim=-1, keepdim=True)
            r = inv_keep * (pushed + dang_mass * src_onehot)
        else:
            r = inv_keep * pushed
    return p


def dense_pagerank_iterations_ref(g: Graph, src_onehot: torch.Tensor,
                                  damping: float, iters: int) -> torch.Tensor:
    """Plain PyTorch K2: the un-normalized ``x``, f32 ``[B, n_pad]``."""
    set_exact_f32_matmul()
    base = (1.0 - damping) * src_onehot
    x = base
    for _ in range(iters):
        x = base + damping * torch.matmul(x, g.dense_out)
    return x


def _kernel_operands(g: Graph, src_onehot: torch.Tensor, what: str):
    """Check what the CUDA kernels take; returns ``(W, n_pad)``."""
    if not src_onehot.is_cuda:
        raise ValueError(f"unsupported device {src_onehot.device}")
    w = g.dense_out
    if w is None:
        raise ValueError(f"{what} needs a dense operator")
    n = g.n_pad
    if n > MAX_N_PAD or n % 4:
        raise ValueError(f"n_pad={n}: the kernel takes n_pad <= {MAX_N_PAD}, "
                         "a multiple of 4")
    for name, t in (("src_onehot", src_onehot), ("dense_out", w)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != src_onehot.device:
            raise ValueError(f"{name} must be contiguous f32 on "
                             f"{src_onehot.device}")
    if src_onehot.dim() != 2 or src_onehot.shape[1] != n:
        raise ValueError(f"src_onehot must be [B, {n}], got "
                         f"{tuple(src_onehot.shape)}")
    if w.data_ptr() % 16:
        raise ValueError("dense_out must be 16-byte aligned")
    return w, n


def dense_power_iterations(g: Graph, src_onehot: torch.Tensor, alpha: float,
                           iters: int, *, dangling_to_source: bool = True
                           ) -> torch.Tensor:
    """K1, fused propagation; returns the reserve ``p`` (f32
    ``[B, n_pad]``)."""
    global launches
    if src_onehot.device.type == "cpu":
        return dense_power_iterations_ref(
            g, src_onehot, alpha, iters, dangling_to_source=dangling_to_source
        )
    w, n = _kernel_operands(g, src_onehot, "dense_power_iterations")
    b = src_onehot.shape[0]
    out = torch.empty_like(src_onehot)
    if b == 0:
        return out
    index = src_onehot.get_device()
    if index not in probe.probed:
        probe.ensure(src_onehot.device)
    dang = _dangling_mask(g).contiguous()
    rc = cuda_build.call(
        cuda_build.function("ppr_dense_power_iterations"), index,
        w.data_ptr(), src_onehot.data_ptr(), dang.data_ptr(), out.data_ptr(),
        b, n, int(iters), float(alpha), 1.0 - float(alpha),
        int(dangling_to_source))
    if rc:
        cuda_build.check("ppr_dense_power_iterations", rc,
                         "dense_power_iterations")
    launches += 1
    return out


def dense_pagerank_iterations(g: Graph, src_onehot: torch.Tensor,
                              damping: float, iters: int) -> torch.Tensor:
    """K2, the fused Neo4j-style personalized PageRank; returns the
    un-normalized ``x`` (f32 ``[B, n_pad]``). ``iters = 0`` gives
    ``(1-d) * src_onehot``."""
    global pagerank_launches
    if src_onehot.device.type == "cpu":
        return dense_pagerank_iterations_ref(g, src_onehot, damping, iters)
    w, n = _kernel_operands(g, src_onehot, "dense_pagerank_iterations")
    if iters < 0:
        raise ValueError(f"iters={iters} < 0")
    b = src_onehot.shape[0]
    out = torch.empty_like(src_onehot)
    if b == 0:
        return out
    index = src_onehot.get_device()
    if index not in probe.probed:
        probe.ensure(src_onehot.device)
    rc = cuda_build.call(
        cuda_build.function("ppr_dense_pagerank_iterations"), index,
        w.data_ptr(), src_onehot.data_ptr(), out.data_ptr(), b, n,
        int(iters), float(damping), 1.0 - float(damping))
    if rc:
        cuda_build.check("ppr_dense_pagerank_iterations", rc,
                         "dense_pagerank_iterations")
    pagerank_launches += 1
    return out
