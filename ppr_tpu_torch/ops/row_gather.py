"""K3 and the row-gather probes P1-P4 — the sparse tail of every sparse
push, as one CUDA source (``csrc/row_gather.cu``).

* :func:`gather_segment_sum` (K3) computes, for destination-sorted edges
  with row pointer ``ptr``, ``out[d] = sum of table[src[e]]`` over
  ``e in [ptr[d], ptr[d+1])``. It is P4's ``gather_accum`` mode
  (``scripts/bench_pallas_row_gather.py::make``), and it carries the tail of
  ``push_out``, ``push_out_t``, ``pull_out_norm`` and ``push_out_hybrid_t``
  through :func:`ppr_tpu_torch.ops.spmv.gather_segment_sum`. On the TPU that
  tail stayed XLA's gather plus ``segment_sum``: Mosaic could not gather
  fast enough.
* :func:`row_gather` computes ``out[i] = table[idx[i]]``: the probes P1-P3
  (``scripts/probe_mosaic_gather.py``) and P4's ``gather`` mode. As those
  probes were on the TPU, it is a microbenchmark and on no serving or
  protocol path: ``chip_smoke.py`` times it as the gather ceiling of K3.

``*_ref`` are the plain PyTorch versions (``index_select``, then
``segment_reduce`` for K3). A wrapper runs its plain version only for a
tensor that lies on the CPU; for a CUDA tensor it runs the toolchain probe
K0 once (``ops/probe.py``), then launches its kernel or raises. The kernels
trust their indices: every index must lie in ``[0, table.shape[0])`` and
``ptr`` must be non-decreasing from 0 to at most ``src.shape[0]``.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build, probe

#: K3 launches in this process (reset it to count a run's launches)
segment_sum_launches = 0
#: row_gather launches in this process
gather_launches = 0

#: widest column count the launch grid takes (65535 tiles of 32 columns)
MAX_COLS = 65535 * 32


def gather_segment_sum_ref(table: torch.Tensor, src: torch.Tensor,
                           ptr: torch.Tensor) -> torch.Tensor:
    """Plain K3: ``segment_reduce(table.index_select(0, src), ptr)``."""
    return torch.segment_reduce(table.index_select(0, src), "sum",
                                offsets=ptr, axis=0, unsafe=True)


def row_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain P1-P4 gather: ``table.index_select(0, idx)``."""
    return table.index_select(0, idx)


def _check(table: torch.Tensor, index: torch.Tensor, what: str) -> int:
    """Raise unless the kernels take these operands; returns the column
    count."""
    if not table.is_cuda:
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError(f"{what}: table must be a contiguous f32 matrix")
    if index.dtype != torch.int32 or index.dim() != 1 \
            or not index.is_contiguous() or index.device != table.device:
        raise ValueError(f"{what}: indices must be contiguous int32 [m] on "
                         f"{table.device}")
    cols = table.shape[1]
    if cols > MAX_COLS:
        raise ValueError(f"{what}: {cols} columns; the kernel takes at most "
                         f"{MAX_COLS}")
    return cols


_VP, _CI = ctypes.c_void_p, ctypes.c_int


def _load(symbol: str, argtypes):
    lib = cuda_build.load_library("row_gather")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def gather_segment_sum(table: torch.Tensor, src: torch.Tensor,
                       ptr: torch.Tensor) -> torch.Tensor:
    """K3: ``[ptr.shape[0] - 1, cols]`` segment sums of gathered rows."""
    global segment_sum_launches
    if table.device.type == "cpu":
        return gather_segment_sum_ref(table, src, ptr)
    cols = _check(table, src, "gather_segment_sum")
    if ptr.dtype != torch.int64 or ptr.dim() != 1 or ptr.shape[0] < 1 \
            or not ptr.is_contiguous() or ptr.device != table.device:
        raise ValueError("gather_segment_sum: ptr must be contiguous int64 "
                         f"[n_out + 1] on {table.device}")
    n_out = ptr.shape[0] - 1
    if n_out >= 2**31:
        raise ValueError(f"gather_segment_sum: {n_out} segments; the kernel "
                         "takes fewer than 2^31")
    out = torch.empty((n_out, cols), dtype=torch.float32,
                      device=table.device)
    if n_out == 0 or cols == 0:
        return out
    probe.ensure(table.device)
    lib, fn = _load("ppr_gather_segment_sum",
                    [_VP, _VP, _VP, _VP, _CI, _CI, _VP])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), src.data_ptr(), ptr.data_ptr(),
                out.data_ptr(), n_out, cols, stream)
    cuda_build.check(lib, rc, "gather_segment_sum")
    segment_sum_launches += 1
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1-P4: ``[idx.shape[0], cols]`` rows of ``table``."""
    global gather_launches
    if table.device.type == "cpu":
        return row_gather_ref(table, idx)
    cols = _check(table, idx, "row_gather")
    rows = idx.shape[0]
    if rows >= 2**31:
        raise ValueError(f"row_gather: {rows} indices; the kernel takes "
                         "fewer than 2^31")
    out = torch.empty((rows, cols), dtype=torch.float32, device=table.device)
    if rows == 0 or cols == 0:
        return out
    probe.ensure(table.device)
    lib, fn = _load("ppr_row_gather", [_VP, _VP, _VP, _CI, _CI, _VP])
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), rows, cols,
                stream)
    cuda_build.check(lib, rc, "row_gather")
    gather_launches += 1
    return out
