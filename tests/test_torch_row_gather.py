"""What Python decides for K3 and ``row_gather`` (``ops/row_gather.py``):
the slab width, the layout of a launch, and the order in which the kernel
walks it. No card and no JAX are needed. The walk is written out once in
plain numpy (``for slab, for group of destinations``; a destination's rows
added in edge order, in f32) and run once a layout: it records the order,
which gives the plain version's bits since both add each segment's rows in
edge order. That the kernel keeps that order is held on the card."""

import numpy as np
import pytest
import torch

from ppr_tpu_torch.graph.csr import build_graph
from ppr_tpu_torch.graph.io import load_default, synthetic_powerlaw
from ppr_tpu_torch.ops import row_gather
from ppr_tpu_torch.ops.hub_split import build_hub_split
from ppr_tpu_torch.ops.row_gather import L2_BYTES, SLAB_SHARE, Plan, make_plan

BENCH_ROWS = 65664    # n_pad of the benchmark's 65,536-node graph
GRQC_ROWS = 5120


@pytest.mark.parametrize("cols", [50, 512, 2048, 2050])
@pytest.mark.parametrize("n_rows", [GRQC_ROWS, BENCH_ROWS, 1 << 20])
def test_slab_fits_a_third_of_l2(n_rows, cols):
    slab = row_gather.slab_cols(n_rows, cols)
    budget = L2_BYTES // SLAB_SHARE
    if n_rows * cols * 4 <= budget:
        assert slab == cols        # a small table: the whole width
        return
    assert slab < cols
    assert slab % 32 == 0 and slab & (slab - 1) == 0   # whole 128-byte lines
    # the rows a slab can read fit, unless it is the least slab already
    assert n_rows * slab * 4 <= budget or slab == 32
    # and the next width would not
    assert 2 * slab >= cols or n_rows * 2 * slab * 4 > budget


def test_slab_at_the_paths_shapes():
    # the benchmark's tail: 64 columns, 16.8 MB of rows, 32 slabs at B 2048
    assert row_gather.slab_cols(BENCH_ROWS, 2048) == 64
    assert row_gather.slab_cols(BENCH_ROWS, 512) == 64
    assert row_gather.slab_cols(BENCH_ROWS, 50) == 50
    # the protocol's sparse graph: whole at B 50 and at BASE's batch
    assert row_gather.slab_cols(GRQC_ROWS, 50) == 50
    assert row_gather.slab_cols(GRQC_ROWS, 512) == 512
    assert row_gather.slab_cols(GRQC_ROWS, 2048) == 512
    # a slab is a tile: 16 lanes x 16 bytes at the benchmark's tail, 32
    # tiles at B 2048; a warp's 32 loads where the table is small
    assert make_plan(BENCH_ROWS, 2048, True) == Plan(4, 16)
    assert make_plan(BENCH_ROWS, 2048, True).tiles(2048) == 32
    assert make_plan(BENCH_ROWS, 2050, True) == Plan(1, 32)
    assert make_plan(GRQC_ROWS, 50, True) == Plan(1, 32)
    assert make_plan(GRQC_ROWS, 512, True) == Plan(4, 32)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("cols", [1, 3, 8, 33, 50, 64, 68, 512, 2048, 2050])
@pytest.mark.parametrize("n_rows", [GRQC_ROWS, BENCH_ROWS])
def test_plan_covers_the_columns_in_whole_lanes(n_rows, cols, aligned):
    plan = make_plan(n_rows, cols, aligned)
    assert plan.width == (4 if aligned and cols % 4 == 0 else 1)
    assert plan.lanes in (8, 16, 32)
    assert plan.tile_cols == plan.width * plan.lanes
    # the tiles cover the columns, the last one ragged at most
    tiles = plan.tiles(cols)
    assert (tiles - 1) * plan.tile_cols < cols <= tiles * plan.tile_cols
    # a tile is the slab, or a warp's 32 loads of a wider one
    slab = row_gather.slab_cols(n_rows, cols)
    span = min(slab, cols)
    if plan.lanes < 32:
        assert span <= plan.tile_cols
    if plan.lanes > 8:
        assert span > plan.tile_cols // 2 or plan.lanes == 32
        assert span > 8 * plan.width
    # the narrowest lane count that covers a narrow table in one tile
    if cols <= 8 * plan.width:
        assert plan.lanes == 8 and tiles == 1


def test_plan_slab_override():
    assert make_plan(BENCH_ROWS, 2048, True, 32) == Plan(4, 8)
    assert make_plan(BENCH_ROWS, 2048, True, 64) == Plan(4, 16)
    assert make_plan(BENCH_ROWS, 2048, True, 128) == Plan(4, 32)
    assert make_plan(BENCH_ROWS, 2048, True, 2048) == Plan(4, 32)
    assert make_plan(BENCH_ROWS, 2050, True, 64) == Plan(1, 32)
    assert make_plan(BENCH_ROWS, 2050, True, 16) == Plan(1, 16)


def walk_plan(table, src, ptr, plan, coef=None):
    """The kernel's walk in numpy (each row times ``coef[e]``, rounded to
    f32 before it is added, in the coefficient mode). Every (destination,
    column) must be written exactly once."""
    table, src, ptr = table.numpy(), src.numpy(), ptr.numpy()
    coef = None if coef is None else coef.numpy()
    n_out, cols = ptr.shape[0] - 1, table.shape[1]
    out = np.full((n_out, cols), np.nan, np.float32)
    written = np.zeros((n_out, cols), np.int32)
    per_warp = 32 // plan.lanes
    for tile in range(plan.tiles(cols)):       # a tile is a slab
        c0 = tile * plan.tile_cols
        c1 = min(c0 + plan.tile_cols, cols)
        for group in range(-(-n_out // per_warp)):
            for d in range(group * per_warp,
                           min((group + 1) * per_warp, n_out)):
                acc = np.zeros(c1 - c0, np.float32)
                for e in range(ptr[d], ptr[d + 1]):
                    row = table[src[e], c0:c1]
                    acc += row if coef is None else coef[e] * row
                out[d, c0:c1] = acc
                written[d, c0:c1] += 1
    assert (written == 1).all()
    return torch.from_numpy(out)


def _graph(name):
    if name == "tiny":
        #   0 -> 1, 0 -> 2, 1 -> 2, 2 -> 0, 3 -> 0, 4 (dangling), 5 -> 5
        return build_graph(np.array([0, 0, 1, 2, 3, 5]),
                           np.array([1, 2, 2, 0, 0, 5]), n=6, device="cpu")
    if name == "fallback":
        return load_default(device="cpu").graph
    return synthetic_powerlaw(2000, 8, seed=1, device="cpu").graph


# One walk a layout, as a record of the order the kernel keeps; that the
# kernel itself equals the plain version bit for bit is held on the card
# (tests/test_torch_cuda.py). (graph, edge order, columns, aligned, slab):
# 16-byte tiles of 8 and 16 lanes in several slabs, the last one ragged;
# 4-byte tiles; the wrapper's own choice. The three graphs and the three
# edge orders (the hub split's tail among them) each appear.
WALKS = [("tiny", "bydst", 72, True, 32),
         ("fallback", "tail", 72, True, 64),
         ("powerlaw", "tail", 70, True, 32),
         ("fallback", "bysrc", 72, False, 64),
         ("powerlaw", "bydst", 24, True, None),
         ("tiny", "bysrc", 5, True, None)]


@pytest.mark.parametrize("name,order,cols,aligned,slab", WALKS)
def test_walk_equals_plain_bit_for_bit(name, order, cols, aligned, slab):
    graph = _graph(name)
    if order == "tail":       # the hub split's tail: hubs' segments empty
        hs = build_hub_split(graph, min(64, graph.n // 2))
        src, ptr = hs.tail_src, hs.tail_ptr
        assert bool((ptr[hs.hub_ids.long() + 1] == ptr[hs.hub_ids.long()])
                    .all())
    elif order == "bydst":
        src, ptr = graph.edge_src_bydst, graph.bydst_ptr
    else:
        src, ptr = graph.edge_dst, graph.bysrc_ptr
    table = torch.from_numpy(np.random.default_rng(cols).random(
        (graph.n_pad, cols), dtype=np.float32))
    plan = make_plan(graph.n_pad, cols, aligned, slab)
    if slab is not None:
        assert plan.tiles(cols) > 1
    want = row_gather.gather_segment_sum_ref(table, src, ptr)
    got = walk_plan(table, src, ptr, plan)
    assert torch.equal(got, want)
    # on the CPU the wrapper is the plain version
    assert torch.equal(row_gather.gather_segment_sum(table, src, ptr), want)


@pytest.mark.parametrize("order,cols,aligned,slab", [
    ("bydst", 72, True, 32), ("bysrc", 70, True, None),
    ("bydst", 12, False, None)])
def test_coef_walk_equals_plain_bit_for_bit(order, cols, aligned, slab):
    """The coefficient mode's walk on a weighted graph: ``push_out``'s
    edges with ``edge_coef_bydst``, ``pull_out_norm``'s with
    ``edge_coef``."""
    from ppr_tpu_torch.graph.io import synthetic_weighted

    graph = synthetic_weighted(1000, 8, seed=1, device="cpu").graph
    src, ptr, coef = ((graph.edge_src_bydst, graph.bydst_ptr,
                       graph.edge_coef_bydst) if order == "bydst" else
                      (graph.edge_dst, graph.bysrc_ptr, graph.edge_coef))
    table = torch.from_numpy(np.random.default_rng(cols).random(
        (graph.n_pad, cols), dtype=np.float32))
    plan = make_plan(graph.n_pad, cols, aligned, slab)
    want = row_gather.gather_segment_sum_ref(table, src, ptr, coef)
    assert torch.equal(walk_plan(table, src, ptr, plan, coef), want)
    assert torch.equal(row_gather.gather_segment_sum(table, src, ptr,
                                                     coef=coef), want)


def test_coef_card_widths_cover_every_layout():
    """The card tests' widths of the coefficient mode (aligned and offset
    by a float) reach both load widths at 8, 16 and 32 lanes."""
    from test_torch_cuda import COEF_COLS

    layouts = {(p.width, p.lanes) for b in COEF_COLS for aligned in
               (True, False) for p in [make_plan(2176, b, aligned)]}
    assert layouts == {(w, lanes) for w in (1, 4) for lanes in (8, 16, 32)}


def test_unit_segments_are_a_row_gather():
    """``row_gather`` is K3 with the row pointer ``arange``: the walk with
    unit segments copies ``table[idx]``."""
    table = torch.from_numpy(np.random.default_rng(0).random(
        (300, 68), dtype=np.float32))
    idx = torch.from_numpy(np.random.default_rng(1).integers(
        0, 300, 500).astype(np.int32))
    ptr = torch.arange(501)
    plan = make_plan(300, 68, True, 32)
    got = walk_plan(table, idx, ptr, plan)
    assert torch.equal(got, row_gather.row_gather_ref(table, idx))
    assert torch.equal(got, row_gather.row_gather(table, idx))
