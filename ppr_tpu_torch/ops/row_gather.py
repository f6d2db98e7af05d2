"""K3 and the row-gather probes P1-P4 — the sparse tail of every sparse
push, as one CUDA source (``csrc/row_gather.cu``).

* :func:`gather_segment_sum` (K3) computes, for destination-sorted edges
  with row pointer ``ptr``, ``out[d] = sum of table[src[e]]`` over
  ``e in [ptr[d], ptr[d+1])``. It is P4's ``gather_accum`` mode
  (``scripts/bench_pallas_row_gather.py::make``), and it carries the tail of
  ``push_out``, ``push_out_t``, ``pull_out_norm`` and ``push_out_hybrid_t``
  through :func:`ppr_tpu_torch.ops.spmv.gather_segment_sum`. On the TPU that
  tail stayed XLA's gather plus ``segment_sum``: Mosaic could not gather
  fast enough. With ``coef`` (f32, one an edge) it is the coefficient mode
  of a weighted graph's push, ``out[d] = sum of coef[e] * table[src[e]]``,
  each product rounded to f32 before it is added, as the plain version
  (``index_select``, times ``coef``, ``segment_reduce``) rounds it; on the
  TPU the weighted push was XLA's gather, multiply and ``segment_sum``
  (``ppr_tpu/ops/spmv.py:66-67,110-112,236-237``).
* :func:`row_gather` computes ``out[i] = table[idx[i]]``: the probes P1-P3
  (``scripts/probe_mosaic_gather.py``) and P4's ``gather`` mode. As those
  probes were on the TPU, it is a microbenchmark and on no serving or
  protocol path: ``chip_smoke.py`` times it as the gather ceiling of K3.

The two are one device template: ``row_gather`` is K3 with unit segments
(segment ``i`` is edge ``i``, the row pointer compiled out).

The kernel is laid out around the card's L2 (the source's note has the
design), and this module decides the layout, in plain Python that runs on
any machine: :func:`slab_cols` gives the widest column slab whose rows,
``n_rows x slab x 4`` bytes, take about a third of L2 (the whole width
where the table is small), and :func:`make_plan` makes the slab the
kernel's column tile: 8, 16 or 32 lanes a destination, one 16-byte or
4-byte load each (a slab wider than a warp's 32 loads is cut into tiles of
32). The grid is tile-major, so the blocks that run together read one slab
and every re-read of a row finds it in L2.

``*_ref`` are the plain PyTorch versions (``index_select``, then
``segment_reduce`` for K3). A wrapper runs its plain version only for a
tensor that lies on the CPU; for a CUDA tensor it runs the toolchain probe
K0 once (``ops/probe.py``), then launches its kernel or raises. The kernels
trust their indices: every index must lie in ``[0, table.shape[0])`` and
``ptr`` must be non-decreasing from 0 to at most ``src.shape[0]``.

Once the card is probed (at the first launch), a wrapper launches on the
current stream, does not synchronise and allocates only its output through
``torch.empty``: it can be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_build, probe

#: K3 launches in this process (reset it to count a run's launches), both
#: modes
segment_sum_launches = 0
#: of those, launches of the coefficient mode
segment_sum_coef_launches = 0
#: row_gather launches in this process
gather_launches = 0

#: widest column count the kernels take
MAX_COLS = 65535 * 32
#: the H100's L2, and the share of it that a slab's rows may take: the rest
#: is room for the output and the indices that stream through
L2_BYTES = 50 * 2**20
SLAB_SHARE = 3


@dataclasses.dataclass(frozen=True)
class Plan:
    """The layout of one launch: ``width`` floats a load (4 or 1) and
    ``lanes`` lanes a destination (a warp takes ``32 // lanes``
    destinations). A tile is ``width * lanes`` columns, and the kernel
    walks ``for tile, for group of destinations``: a tile is a slab."""
    width: int
    lanes: int

    @property
    def tile_cols(self) -> int:
        return self.width * self.lanes

    def tiles(self, cols: int) -> int:
        return -(-cols // self.tile_cols)


def slab_cols(n_rows: int, cols: int) -> int:
    """The slab width for a ``[n_rows, cols]`` f32 table: ``cols`` when the
    whole table takes at most ``L2_BYTES / SLAB_SHARE``, else the largest
    of 32, 64, 128, ... columns whose ``n_rows`` rows do (32, one 128-byte
    line a row, at the least)."""
    budget = L2_BYTES // SLAB_SHARE
    if n_rows * cols * 4 <= budget:
        return cols
    slab = 32
    while 2 * slab < cols and n_rows * 2 * slab * 4 <= budget:
        slab *= 2
    return slab


def make_plan(n_rows: int, cols: int, aligned: bool,
              slab: int | None = None) -> Plan:
    """The layout for a ``[n_rows, cols]`` table; ``aligned`` says that the
    table's and the output's bases are 16-byte aligned. A tile is the slab
    or, where the slab is wider than a warp's 32 loads (a small table), 32
    loads of it. ``slab`` overrides :func:`slab_cols`
    (``row_gather_ablation.py`` times other widths)."""
    width = 4 if aligned and cols % 4 == 0 else 1
    if slab is None:
        slab = slab_cols(n_rows, cols)
    span = min(slab, cols)
    lanes = 8 if span <= 8 * width else 16 if span <= 16 * width else 32
    return Plan(width, lanes)


def gather_segment_sum_ref(table: torch.Tensor, src: torch.Tensor,
                           ptr: torch.Tensor,
                           coef: torch.Tensor | None = None) -> torch.Tensor:
    """Plain K3: ``segment_reduce(table.index_select(0, src) [* coef[:,
    None]], ptr)``."""
    rows = table.index_select(0, src)
    if coef is not None:
        rows = rows * coef[:, None]
    return torch.segment_reduce(rows, "sum", offsets=ptr, axis=0,
                                unsafe=True)


def row_gather_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain P1-P4 gather: ``table.index_select(0, idx)``."""
    return table.index_select(0, idx)


def _launch(symbol: str, what: str, table: torch.Tensor,
            index: torch.Tensor, ptr: torch.Tensor | None,
            coef: torch.Tensor | None = None) -> torch.Tensor:
    """Check the operands, allocate the output and launch ``symbol``: K3
    with a row pointer (and, in its coefficient mode, ``coef``), the
    unit-segment gather without."""
    if not table.is_cuda:
        raise ValueError(f"unsupported device {table.device}")
    if table.dtype != torch.float32 or table.dim() != 2 \
            or not table.is_contiguous():
        raise ValueError(f"{what}: table must be a contiguous f32 matrix")
    card = table.get_device()
    if index.dtype != torch.int32 or index.dim() != 1 \
            or not index.is_contiguous() or index.get_device() != card:
        raise ValueError(f"{what}: indices must be contiguous int32 [m] on "
                         f"{table.device}")
    if coef is not None and (
            coef.dtype != torch.float32 or coef.shape != index.shape
            or not coef.is_contiguous() or coef.get_device() != card):
        raise ValueError(f"{what}: coef must be contiguous f32 "
                         f"[{index.shape[0]}] on {table.device}")
    n_rows, cols = table.shape
    if index.shape[0] >= 2**31:
        raise ValueError(f"{what}: {index.shape[0]} indices; the kernel "
                         "takes fewer than 2^31")
    if cols > MAX_COLS:
        raise ValueError(f"{what}: {cols} columns; the kernel takes at most "
                         f"{MAX_COLS}")
    if ptr is None:
        n_out = index.shape[0]
    else:
        if ptr.dtype != torch.int64 or ptr.dim() != 1 or ptr.shape[0] < 1 \
                or not ptr.is_contiguous() or ptr.get_device() != card:
            raise ValueError(f"{what}: ptr must be contiguous int64 "
                             f"[n_out + 1] on {table.device}")
        n_out = ptr.shape[0] - 1
    if n_out >= 2**31:
        raise ValueError(f"{what}: {n_out} output rows; the kernel takes "
                         "fewer than 2^31")
    out = torch.empty((n_out, cols), dtype=torch.float32, device=table.device)
    if n_out == 0 or cols == 0:
        return out
    if card not in probe.probed:
        probe.ensure(table.device)
    table_at, out_at = table.data_ptr(), out.data_ptr()
    plan = make_plan(n_rows, cols, (table_at | out_at) % 16 == 0)
    fn = cuda_build.function(symbol)
    if coef is not None:
        rc = cuda_build.call(fn, card, table_at, index.data_ptr(),
                             coef.data_ptr(), ptr.data_ptr(), out_at, n_out,
                             cols, plan.width, plan.lanes)
    elif ptr is not None:
        rc = cuda_build.call(fn, card, table_at, index.data_ptr(),
                             ptr.data_ptr(), out_at, n_out, cols, plan.width,
                             plan.lanes)
    else:
        rc = cuda_build.call(fn, card, table_at, index.data_ptr(), out_at,
                             n_out, cols, plan.width, plan.lanes)
    if rc:
        cuda_build.check(symbol, rc, what)
    return out


def gather_segment_sum(table: torch.Tensor, src: torch.Tensor,
                       ptr: torch.Tensor,
                       coef: torch.Tensor | None = None) -> torch.Tensor:
    """K3: ``[ptr.shape[0] - 1, cols]`` segment sums of gathered rows, each
    row times ``coef[e]`` when ``coef`` is given (the coefficient mode)."""
    global segment_sum_launches, segment_sum_coef_launches
    if table.device.type == "cpu":
        return gather_segment_sum_ref(table, src, ptr, coef)
    if ptr is None:
        raise ValueError("gather_segment_sum: ptr must be contiguous int64 "
                         "[n_out + 1]")
    if coef is None:
        out = _launch("ppr_gather_segment_sum", "gather_segment_sum", table,
                      src, ptr)
    else:
        out = _launch("ppr_gather_segment_sum_coef", "gather_segment_sum",
                      table, src, ptr, coef)
    if out.numel():
        segment_sum_launches += 1
        if coef is not None:
            segment_sum_coef_launches += 1
    return out


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P1-P4: ``[idx.shape[0], cols]`` rows of ``table``."""
    global gather_launches
    if table.device.type == "cpu":
        return row_gather_ref(table, idx)
    out = _launch("ppr_row_gather", "row_gather", table, idx, None)
    if out.numel():
        gather_launches += 1
    return out
