"""Port tests that need an NVIDIA card (marker ``cuda``; they skip without
one). This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerances: K1, K2 and the hub product sum in another order than the plain
versions (2e-5 after 100 or 300 rounds, the JAX package's kernel-vs-XLA
bound; 1e-5 for one product); K3's segment sums run in edge order like the
plain ``segment_reduce``, in f32, and are held to it bit for bit, in the
coefficient mode too (each product rounded before it is added); K0 and
the row gather are exact. Forward Push and BASE rows on the card agree with the CPU's within
1e-6, and with the same sweep count; the cohort ladder and the early exit
stop on the CPU's sweeps, with the same id sets; the batch server's rows
are the service's. The walks deposit with atomics, so they are held to
conservation (1e-6 relative) and to their dangling rule, not to bits;
``expand_walkers`` is exact, and ``residual_propagate`` within 1e-5 of the
CPU with the same sweep count. The ``coo`` backend adds with atomics: within
1e-6 of the sorted one."""

import threading
import time

import numpy as np
import pytest
import torch

from ppr_tpu_torch.graph.io import (load_default, synthetic_powerlaw,
                                    synthetic_weighted)
from ppr_tpu_torch.harness import PerfHarness, TestType
from ppr_tpu_torch.models.base_allpair import BaseAllPair
from ppr_tpu_torch.models.config import AlgoType
from ppr_tpu_torch.models import fora
from ppr_tpu_torch.models.fora import ForaTopk, annealed_topk_propagate
from ppr_tpu_torch.models.forward_push import ForwardPush
from ppr_tpu_torch.models.neo4j_method import (Neo4jMethod,
                                               personalized_pagerank_batch)
from ppr_tpu_torch.models.power_method import PowerMethod, power_method_batch
from ppr_tpu_torch.ops import (cuda_build, dense_power, probe, row_gather,
                               spmv, walk)
from ppr_tpu_torch.ops.hub_split import (build_hub_split, push_out_hybrid,
                                         push_out_hybrid_t)
from ppr_tpu_torch.ops.push import forward_push_init
from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs
from ppr_tpu_torch.service import PPRService
from ppr_tpu_torch.serving import PPRBatchServer
from ppr_tpu_torch.utils import calibrate

pytestmark = pytest.mark.cuda
ALPHA = 0.15
#: K3 coefficient-mode widths: aligned and offset by a float, they take
#: 4-byte loads at 8, 16 and 32 lanes and 16-byte loads at 8, 16 and 32
#: lanes (tests/test_torch_row_gather.py checks that they do)
COEF_COLS = [1, 3, 12, 16, 32, 50, 64, 68, 512, 2048, 2050]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# clusters of 1, 2, 3, 4 and 8 blocks; the batches give ragged row tiles
# and, at n_pad 1024 (15 resident clusters of 8 on an H100 SXM), every
# tile height of both thread layouts: B 1-50 -> 8 rows, 128 -> 16, 300 ->
# 32 (short tiles), 700 -> 64, 1000 -> 72 (tall tiles)
DENSE_N = {128: 107, 256: 200, 384: 300, 512: 500, 1024: 1000}
BATCHES = [1, 7, 50, 128, 300, 700, 1000]


@pytest.fixture(scope="module")
def dense_graphs():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = {}
    for n_pad, n in DENSE_N.items():
        g = (load_default(device="cuda") if n == 107 else
             synthetic_powerlaw(n, 16, seed=11, dense_threshold=1024,
                                device="cuda")).graph
        assert g.n_pad == n_pad and dense_power.supports(g)
        out[n_pad] = g
    return out


def dense_onehot(g, b):
    sources = torch.as_tensor(
        np.random.default_rng(g.n_pad + b).integers(0, g.n, b), device="cuda")
    return torch.nn.functional.one_hot(sources, g.n_pad).float()


@pytest.mark.parametrize("dangling_to_source", [True, False],
                         ids=["to_source", "dropped"])
@pytest.mark.parametrize("iters", [0, 1, 300])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n_pad", sorted(DENSE_N))
def test_k1_matches_plain(dense_graphs, n_pad, b, iters, dangling_to_source):
    g = dense_graphs[n_pad]
    onehot = dense_onehot(g, b)
    before = dense_power.launches
    out = dense_power.dense_power_iterations(
        g, onehot, ALPHA, iters, dangling_to_source=dangling_to_source)
    again = dense_power.dense_power_iterations(
        g, onehot, ALPHA, iters, dangling_to_source=dangling_to_source)
    ref = dense_power.dense_power_iterations_ref(
        g, onehot, ALPHA, iters, dangling_to_source=dangling_to_source)
    torch.cuda.synchronize()
    assert dense_power.launches == before + 2
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    assert torch.equal(out, again)          # a fixed summation order
    if iters <= 1:
        assert torch.equal(out, ref)


@pytest.mark.parametrize("n_pad", [128, 1024])
def test_k1_rejects_bad_operands(dense_graphs, n_pad):
    g = dense_graphs[n_pad]
    for bad in (torch.zeros((2, g.n_pad), device="cuda", dtype=torch.float64),
                torch.zeros((2, g.n_pad + 4), device="cuda"),
                torch.zeros((g.n_pad, 2), device="cuda").T):
        with pytest.raises(ValueError):
            dense_power.dense_power_iterations(g, bad, ALPHA, 10)


def test_power_method_runs_k1(cuda):
    ds = load_default(device=cuda)
    sources = np.arange(0, 100, 7)
    before = dense_power.launches
    out = PowerMethod(ds, ALPHA).compute_whole_graph_batch(sources)
    assert dense_power.launches == before + 1
    sparse = load_default(dense_threshold=0, device=cuda).graph
    ref = power_method_batch(sparse, sources, ALPHA).cpu().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5)


def test_bf16_hub_product_matches_cpu(cuda):
    cpu_g = synthetic_powerlaw(4096, 8, seed=3, dense_threshold=0,
                               device="cpu").graph
    gpu_g = synthetic_powerlaw(4096, 8, seed=3, dense_threshold=0,
                               device=cuda).graph
    a_t = np.random.default_rng(0).random((cpu_g.n_pad, 64),
                                          dtype=np.float32)
    a_t[cpu_g.n:] = 0
    outs = []
    for g in (cpu_g, gpu_g):
        hs = build_hub_split(g, 256, dtype=torch.bfloat16)
        outs.append(push_out_hybrid_t(
            g, hs, torch.from_numpy(a_t).to(g.device)).cpu())
    assert gpu_g.device.type == "cuda"
    torch.testing.assert_close(outs[1], outs[0], atol=1e-5, rtol=0)


def test_annealed_loop_matches_cpu(cuda):
    outs = []
    for dev in ("cpu", cuda):
        g = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                               device=dev).graph
        sources = torch.as_tensor(
            np.random.default_rng(1).integers(0, g.n, 16),
            dtype=torch.int32, device=dev)
        p, r, oh = forward_push_init(g, sources)
        outs.append(annealed_topk_propagate(
            g, torch.zeros_like(p), r, oh, 0.25, 0.1, 1.0 / g.n, 10, ALPHA,
            hs=build_hub_split(g, 128)))
    (cp, _, cit), (gp, _, git) = outs
    assert int(git) == int(cit)
    torch.testing.assert_close(gp.cpu(), cp, atol=1e-6, rtol=0)


def test_k0_doubles(cuda):
    probe.ensure(cuda)
    x = torch.randn((8, 128), device=cuda)
    before = probe.launches
    y = probe.double(x)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(y, probe.double_ref(x))


@pytest.mark.parametrize("iters", [0, 1, 300])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n_pad", sorted(DENSE_N))
def test_k2_matches_plain(dense_graphs, n_pad, b, iters):
    g = dense_graphs[n_pad]
    onehot = dense_onehot(g, b)
    before = dense_power.pagerank_launches
    out = dense_power.dense_pagerank_iterations(g, onehot, 1 - ALPHA, iters)
    again = dense_power.dense_pagerank_iterations(g, onehot, 1 - ALPHA,
                                                  iters)
    ref = dense_power.dense_pagerank_iterations_ref(g, onehot, 1 - ALPHA,
                                                    iters)
    torch.cuda.synchronize()
    assert dense_power.pagerank_launches == before + 2
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    assert torch.equal(out, again)
    if iters == 0:
        assert torch.equal(out, ref)


def test_dense_kernels_cpu_tensor_never_launches(dense_graphs):
    cpu = synthetic_powerlaw(500, 16, seed=11, dense_threshold=1024,
                             device="cpu").graph
    onehot = dense_onehot(dense_graphs[512], 3).cpu()
    before = (dense_power.launches, dense_power.pagerank_launches)
    dense_power.dense_power_iterations(cpu, onehot, ALPHA, 5)
    dense_power.dense_pagerank_iterations(cpu, onehot, 1 - ALPHA, 5)
    assert (dense_power.launches, dense_power.pagerank_launches) == before


def test_k2_rejects_bad_operands(cuda):
    g = load_default(device=cuda).graph
    oh = torch.zeros((2, g.n_pad), device=cuda)
    for bad in (oh.double(), torch.zeros((2, g.n_pad + 4), device=cuda),
                torch.zeros((g.n_pad, 2), device=cuda).T):
        with pytest.raises(ValueError):
            dense_power.dense_pagerank_iterations(g, bad, 1 - ALPHA, 10)
    with pytest.raises(ValueError):
        dense_power.dense_pagerank_iterations(g, oh, 1 - ALPHA, -1)
    big = synthetic_powerlaw(1100, 2, seed=0, device=cuda).graph
    with pytest.raises(ValueError):
        dense_power.dense_pagerank_iterations(
            big, torch.zeros((2, big.n_pad), device=cuda), 1 - ALPHA, 10)


def test_neo4j_method_runs_k2(cuda):
    ds = load_default(device=cuda)
    sources = np.arange(0, 100, 7)
    before = dense_power.pagerank_launches
    out = Neo4jMethod(ds, ALPHA).compute_whole_graph_batch(sources, 300)
    assert dense_power.pagerank_launches == before + 1
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(sources, device=cuda), ds.graph.n_pad).float()
    x = dense_power.dense_pagerank_iterations(ds.graph, onehot, 1 - ALPHA,
                                              300)
    direct = (x / x.sum(-1, keepdim=True)).cpu().numpy()
    np.testing.assert_array_equal(out, direct)
    sparse = load_default(dense_threshold=0, device=cuda).graph
    ref = personalized_pagerank_batch(sparse, sources, 1 - ALPHA, 300)
    np.testing.assert_allclose(out, ref.cpu().numpy(), atol=2e-5)


@pytest.mark.parametrize("test_type,prep", [
    (TestType.WHOLE_GRAPH, False), (TestType.TOPK, False),
    (TestType.WHOLE_GRAPH, True)])
def test_harness_row_matches_cpu(cuda, tmp_path, monkeypatch, test_type,
                                 prep):
    monkeypatch.chdir(tmp_path)
    rows = []
    for dev in ("cpu", cuda):
        ds = load_default(device=dev)
        h = PerfHarness(ds, seed=0, out_dir=str(tmp_path), progress=False)
        rows.append(h.algo_perf_test(AlgoType.NEO4J_METHOD, 16, 10, 100,
                                     -1.0, prep, test_type))
    cpu, gpu = rows
    if test_type == TestType.TOPK:
        assert abs(gpu.avg_precision - cpu.avg_precision) <= 1e-9
        assert abs(gpu.avg_ndcg - cpu.avg_ndcg) <= 1e-9
    else:
        assert abs(gpu.avg_max_err - cpu.avg_max_err) <= 1e-6
        assert gpu.avg_max_err < 1e-6
    assert (gpu.prep_bytes or 0) > 0 if prep else gpu.prep_bytes is None


def k3_operands(cuda, b, *, misalign=False):
    """The destination-sorted edges of a 2048-node graph and a ``[n_pad,
    b]`` table on the card; ``misalign`` offsets the table by one float,
    which sends a width that is a multiple of 4 down the scalar path."""
    g = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                           device=cuda).graph
    values = torch.rand((g.n_pad, b), device=cuda)
    if misalign:
        flat = torch.empty(g.n_pad * b + 1, device=cuda)
        values = flat[1:].view(g.n_pad, b).copy_(values)
    return g, values


@pytest.mark.parametrize("order", ["bydst", "bysrc"])
@pytest.mark.parametrize("misalign", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("b", [1, 3, 50, 64, 68, 512, 2048, 2050])
def test_k3_matches_plain(cuda, b, misalign, order):
    """K3 on the forward push's destination-sorted edges and on the
    backward push's source-sorted ones (BASE pushes 512 targets a batch);
    64, 68, 2048 and 2050 columns are a slab's width, a ragged tile, whole
    16-byte tiles and a ragged 4-byte one."""
    g, table = k3_operands(cuda, b, misalign=misalign)
    src, ptr = ((g.edge_src_bydst, g.bydst_ptr) if order == "bydst"
                else (g.edge_dst, g.bysrc_ptr))
    before = row_gather.segment_sum_launches
    got = row_gather.gather_segment_sum(table, src, ptr)
    ref = row_gather.gather_segment_sum_ref(table, src, ptr)
    torch.cuda.synchronize()
    assert row_gather.segment_sum_launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    # the plain version's bits, and the same bits every run
    assert torch.equal(got, ref)
    assert torch.equal(got, row_gather.gather_segment_sum(table, src, ptr))


@pytest.mark.parametrize("slab", [None, 32, 64], ids=["whole", "32", "64"])
@pytest.mark.parametrize("b", [64, 256, 260])
def test_k3_long_segment_beside_empty_ones(cuda, monkeypatch, b, slab):
    """One segment of 1,000 edges (125 rounds of the unrolled loop) between
    empty ones and short ones, walked whole and in slabs."""
    if slab is not None:
        plan = row_gather.make_plan
        monkeypatch.setattr(row_gather, "make_plan",
                            lambda n, c, a: plan(n, c, a, slab))
    lengths = [0, 3, 0, 0, 1000, 0, 9, 8, 0, 17, 1, 0]
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                       device=cuda)
    rng = np.random.default_rng(5)
    src = torch.as_tensor(rng.integers(0, 300, int(ptr[-1])).astype(np.int32),
                          device=cuda)
    table = torch.rand((300, b), device=cuda)
    got = row_gather.gather_segment_sum(table, src, ptr)
    ref = row_gather.gather_segment_sum_ref(table, src, ptr)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert torch.equal(got, row_gather.gather_segment_sum(table, src, ptr))
    assert not got[[0, 2, 3, 5, 8, 11]].any()


@pytest.mark.parametrize("b", [1, 3, 50, 64, 68, 2048, 2050])
def test_row_gather_matches_plain(cuda, b):
    """The unit-segment case of K3's template, at its tile edges."""
    table = torch.rand((4096, b), device=cuda)
    idx = (torch.arange(8192, device=cuda) * 7919 % 4096).to(torch.int32)
    before = row_gather.gather_launches
    out = row_gather.row_gather(table, idx)
    torch.cuda.synchronize()
    assert row_gather.gather_launches == before + 1
    assert torch.equal(out, row_gather.row_gather_ref(table, idx))


def test_k3_p4_accum_and_empty_segments(cuda):
    """P4's unsorted destinations after a stable sort; 7 of 9 segments
    are empty in the second case."""
    i = torch.arange(8192, device=cuda)
    src = (i * 7919 % 4096).to(torch.int32)
    dst = i * 104729 % 512
    order = torch.sort(dst, stable=True).indices
    ptr = torch.searchsorted(dst[order], torch.arange(513, device=cuda))
    table = torch.rand((4096, 512), device=cuda)
    out = row_gather.gather_segment_sum(table, src[order].contiguous(), ptr)
    want = torch.zeros((512, 512), device=cuda).index_add_(
        0, dst, table.index_select(0, src))
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-5)
    ptr = torch.tensor([0, 0, 0, 2, 2, 2, 2, 5, 5, 5], device=cuda)
    out = row_gather.gather_segment_sum(table, src[:5].contiguous(), ptr)
    torch.cuda.synchronize()
    assert not out[[0, 1, 3, 4, 5, 7, 8]].any()
    torch.testing.assert_close(out[2], table[src[:2].long()].sum(0))


def test_wrappers_capture_in_a_cuda_graph(cuda):
    """K0, ``row_gather`` and K3 launch on the current stream, do not
    synchronise and allocate only through torch: once the card is probed,
    one CUDA graph holds all three, and its replays equal the eager
    results. The sweep loops' CUDA graph depends on it."""
    g, table = k3_operands(cuda, 64)
    x = torch.rand(probe.SHAPE, device=cuda)
    idx = (torch.arange(512, device=cuda) * 7919 % g.n_pad).to(torch.int32)

    def run():
        return (probe.double(x), row_gather.row_gather(table, idx),
                row_gather.gather_segment_sum(table, g.edge_src_bydst,
                                              g.bydst_ptr))

    eager = [t.clone() for t in run()]   # probes, and asks for the waves
    counts = (probe.launches, row_gather.gather_launches,
              row_gather.segment_sum_launches)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    assert (probe.launches, row_gather.gather_launches,
            row_gather.segment_sum_launches) == tuple(c + 1 for c in counts)
    for _ in range(2):
        for t in captured:
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(captured, eager):
            assert torch.equal(got, want)
    # new operands in the captured buffers: a replay computes on them
    x.mul_(3.0)
    table.add_(1.0)
    graph.replay()
    torch.cuda.synchronize()
    for got, want in zip(captured, run()):
        assert torch.equal(got, want)


def test_k3_and_row_gather_reject_bad_operands(cuda):
    table = torch.rand((16, 8), device=cuda)
    src = torch.zeros(4, dtype=torch.int32, device=cuda)
    ptr = torch.tensor([0, 2, 4], device=cuda)
    for bad_table in (table.double(), table.T, table[:, 0], table.half()):
        with pytest.raises(ValueError):
            row_gather.gather_segment_sum(bad_table, src, ptr)
        with pytest.raises(ValueError):
            row_gather.row_gather(bad_table, src)
    for bad_src in (src.long(), src.cpu(), src.reshape(2, 2)):
        with pytest.raises(ValueError):
            row_gather.gather_segment_sum(table, bad_src, ptr)
        with pytest.raises(ValueError):
            row_gather.row_gather(table, bad_src)
    for bad_ptr in (ptr.int(), ptr.cpu(), ptr[:0]):
        with pytest.raises(ValueError):
            row_gather.gather_segment_sum(table, src, bad_ptr)


# --- K3's coefficient mode (weighted graphs) --------------------------------

def weighted_operands(cuda, b, *, misalign=False):
    """The weighted 2048-node graph on the card and a ``[n_pad, b]`` table
    (offset by one float with ``misalign``)."""
    g = synthetic_weighted(2048, 8, seed=3, dense_threshold=0,
                           device=cuda).graph
    values = torch.rand((g.n_pad, b), device=cuda)
    if misalign:
        flat = torch.empty(g.n_pad * b + 1, device=cuda)
        values = flat[1:].view(g.n_pad, b).copy_(values)
    return g, values


@pytest.mark.parametrize("order", ["bydst", "bysrc"])
@pytest.mark.parametrize("misalign", [False, True], ids=["aligned", "offset"])
@pytest.mark.parametrize("b", COEF_COLS)
def test_k3_coef_matches_plain(cuda, b, misalign, order):
    """The coefficient mode on a weighted graph's destination-sorted edges
    (``push_out``, with ``edge_coef_bydst``) and source-sorted ones
    (``pull_out_norm``, with ``edge_coef``), in both layouts and all three
    lane counts (``COEF_COLS``): the plain version's bits, every run."""
    g, table = weighted_operands(cuda, b, misalign=misalign)
    src, ptr, coef = ((g.edge_src_bydst, g.bydst_ptr, g.edge_coef_bydst)
                      if order == "bydst" else
                      (g.edge_dst, g.bysrc_ptr, g.edge_coef))
    before = (row_gather.segment_sum_launches,
              row_gather.segment_sum_coef_launches)
    got = row_gather.gather_segment_sum(table, src, ptr, coef=coef)
    ref = row_gather.gather_segment_sum_ref(table, src, ptr, coef)
    torch.cuda.synchronize()
    assert (row_gather.segment_sum_launches,
            row_gather.segment_sum_coef_launches) == (before[0] + 1,
                                                      before[1] + 1)
    assert torch.equal(got, ref)
    assert torch.equal(got, row_gather.gather_segment_sum(table, src, ptr,
                                                          coef=coef))
    # the unweighted mode is another function
    plain = row_gather.gather_segment_sum(table, src, ptr)
    assert torch.equal(plain, row_gather.gather_segment_sum_ref(table, src,
                                                                 ptr))
    assert not torch.equal(plain, got)


@pytest.mark.parametrize("slab", [None, 32, 64], ids=["whole", "32", "64"])
@pytest.mark.parametrize("b", [12, 64, 256, 260])
def test_k3_coef_ragged_segments_with_empty_ones(cuda, monkeypatch, b, slab):
    """A segment of 1,000 edges between empty and short ones, coefficients
    with zeros among them, walked whole and in slabs."""
    if slab is not None:
        plan = row_gather.make_plan
        monkeypatch.setattr(row_gather, "make_plan",
                            lambda n, c, a: plan(n, c, a, slab))
    lengths = [0, 3, 0, 0, 1000, 0, 9, 8, 0, 17, 1, 0, 2]
    ptr = torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                       device=cuda)
    rng = np.random.default_rng(6)
    m = int(ptr[-1])
    src = torch.as_tensor(rng.integers(0, 300, m).astype(np.int32),
                          device=cuda)
    coef = rng.random(m, dtype=np.float32)
    coef[::7] = 0.0
    coef = torch.as_tensor(coef, device=cuda)
    table = torch.randn((300, b), device=cuda)
    got = row_gather.gather_segment_sum(table, src, ptr, coef=coef)
    ref = row_gather.gather_segment_sum_ref(table, src, ptr, coef)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    assert not got[[0, 2, 3, 5, 8, 11]].any()


def test_k3_coef_captures_in_a_cuda_graph(cuda):
    g, table = weighted_operands(cuda, 64)
    args = (g.edge_src_bydst, g.bydst_ptr)

    def run():
        return row_gather.gather_segment_sum(table, *args,
                                             coef=g.edge_coef_bydst)

    eager = run().clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = run()
    captured.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)
    table.mul_(2.0)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, run())


def test_k3_coef_rejects_bad_operands(cuda):
    table = torch.rand((16, 8), device=cuda)
    src = torch.zeros(4, dtype=torch.int32, device=cuda)
    ptr = torch.tensor([0, 2, 4], device=cuda)
    coef = torch.rand(4, device=cuda)
    for bad in (coef.double(), coef.cpu(), coef[:3], coef.reshape(2, 2)):
        with pytest.raises(ValueError, match="coef"):
            row_gather.gather_segment_sum(table, src, ptr, coef=bad)


def test_weighted_operators_launch_the_coefficient_mode(cuda):
    """Every weighted sparse push reaches K3's coefficient mode on the card
    and matches the CPU; the coo backend (scatter-add with atomics) within
    1e-6 of the sorted one."""
    graphs = [synthetic_weighted(2048, 8, seed=3, dense_threshold=0,
                                 device=dev).graph for dev in ("cpu", cuda)]
    a = np.random.default_rng(2).random((16, graphs[0].n_pad),
                                        dtype=np.float32)
    a[:, graphs[0].n:] = 0
    outs = []
    before = (row_gather.segment_sum_launches,
              row_gather.segment_sum_coef_launches)
    for g in graphs:
        x = torch.from_numpy(a).to(g.device)
        x_t = x.T.contiguous()
        outs.append([op.cpu() for op in (
            spmv.push_out(g, x), spmv.push_out_t(g, x_t),
            spmv.push_out_chunked_t(g, x_t, num_chunks=3),
            spmv.push_out_chunked(g, x, num_chunks=3),
            spmv.pull_out_norm(g, x), spmv.pull_out_norm(g, x[0]))])
    torch.cuda.synchronize()
    assert row_gather.segment_sum_launches == before[0] + 6
    assert row_gather.segment_sum_coef_launches == before[1] + 6
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    g = graphs[1]
    x = torch.from_numpy(a).to(cuda)
    for op in (spmv.push_out, spmv.pull_out_norm):
        torch.testing.assert_close(op(g, x, backend="coo"),
                                   op(g, x, backend="coo_sorted"),
                                   atol=1e-6, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="uniform graphs"):
        build_hub_split(g, 128)


def test_weighted_walks_on_the_card(cuda):
    """The alias step on the card: one step's neighbour frequencies from
    the highest-degree node within 0.01 of the coefficients at 200,000
    draws, and the walk counts conserve their mass."""
    g = synthetic_weighted(2048, 8, seed=3, dense_threshold=0,
                           device=cuda).graph
    deg = g.out_deg[: g.n].cpu().numpy()
    v = int(np.argmax(deg))
    w = 200_000
    gen = torch.Generator(device=cuda).manual_seed(4)
    u = torch.rand(w, generator=gen, device=cuda)
    u2 = torch.rand(w, generator=gen, device=cuda)
    cur = torch.full((w,), v, dtype=torch.int32, device=cuda)
    nxt = walk._uniform_neighbor(g, cur, u, cur, u2).cpu().numpy()
    lo, hi = int(g.indptr[v]), int(g.indptr[v + 1])
    want = np.zeros(g.n_pad)
    np.add.at(want, g.indices[lo:hi].cpu().numpy(),
              g.edge_coef[lo:hi].cpu().numpy())
    freq = np.bincount(nxt, minlength=g.n_pad) / w
    np.testing.assert_allclose(freq, want, atol=0.01)
    starts = torch.as_tensor(np.random.default_rng(0).integers(0, g.n, 1 << 16),
                             dtype=torch.int32, device=cuda)
    counts = walk.weighted_walk_counts(
        g, starts, torch.zeros_like(starts, dtype=torch.int64),
        torch.full((1 << 16,), 1.0 / (1 << 16), device=cuda), gen, ALPHA, 1)
    assert abs(float(counts.sum()) - 1.0) <= 1e-6
    assert not counts[:, g.n:].any()


def test_fora_does_not_chunk_on_the_card(cuda):
    """The chunk count bounds the CPU's per-edge intermediate; K3 writes
    none, so FORA on the card pushes in one piece whatever the budget."""
    ds = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0, device=cuda)
    algo = ForaTopk(ds, ALPHA, 10)
    algo.spmv_intermediate_budget = 1024
    assert algo._num_chunks(2048) == 1


def test_sparse_operators_launch_k3(cuda):
    """Every sparse push reaches K3 on the card and matches the CPU."""
    graphs = [synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                                 device=dev).graph for dev in ("cpu", cuda)]
    a = np.random.default_rng(2).random((16, graphs[0].n_pad),
                                        dtype=np.float32)
    a[:, graphs[0].n:] = 0
    outs = []
    before = row_gather.segment_sum_launches
    for g in graphs:
        x = torch.from_numpy(a).to(g.device)
        x_t = x.T.contiguous()
        hs = build_hub_split(g, 128)
        outs.append([op.cpu() for op in (
            spmv.push_out(g, x), spmv.push_out_t(g, x_t),
            spmv.push_out_chunked_t(g, x_t, num_chunks=3),
            spmv.push_out_chunked(g, x, num_chunks=3),
            push_out_hybrid_t(g, hs, x_t, num_chunks=2),
            push_out_hybrid(g, hs, x),
            spmv.pull_out_norm(g, x), spmv.pull_out_norm(g, x[0]))])
    torch.cuda.synchronize()
    assert row_gather.segment_sum_launches == before + 8
    # the CPU's chunked sums and the hub product add in another order
    # (values up to ~10 at the hubs)
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("dense_threshold", [4096, 0], ids=["dense", "sparse"])
def test_forward_push_matches_cpu(cuda, dense_threshold):
    rows, sweeps, rsums = [], [], []
    sources = np.arange(0, 100, 7)
    before = row_gather.segment_sum_launches
    for dev in ("cpu", cuda):
        algo = ForwardPush(load_default(dense_threshold=dense_threshold,
                                        device=dev), ALPHA)
        rows.append(algo.compute_whole_graph_batch(sources, 1e-7))
        sweeps.append(algo.last_sweeps)
        rsums.append(algo.residue_sum())
    assert sweeps[0] == sweeps[1] > 0
    np.testing.assert_allclose(rows[1], rows[0], atol=1e-6)
    np.testing.assert_allclose(rsums[1], rsums[0], atol=1e-6)
    launched = row_gather.segment_sum_launches - before
    assert launched >= sweeps[1] if dense_threshold == 0 else launched == 0


@pytest.mark.parametrize("dense_threshold", [4096, 0], ids=["dense", "sparse"])
def test_base_rows_match_cpu(cuda, tmp_path, monkeypatch, dense_threshold):
    rows = []
    for dev in ("cpu", cuda):
        work = tmp_path / str(dev)
        work.mkdir()
        monkeypatch.chdir(work)
        base = BaseAllPair(load_default(dense_threshold=dense_threshold,
                                        device=dev), ALPHA, target_batch=64)
        base.preprocessing(5e-5, 10, progress=False)
        rows.append([base._store.read_row_ordered(s) for s in range(107)])
    # the same kept sets and values; ties may order differently, since
    # the dense product sums in another order on the card
    for (gids, gvals), (cids, cvals) in zip(rows[1], rows[0]):
        assert set(gids.tolist()) == set(cids.tolist())
        g_row, c_row = np.zeros(128), np.zeros(128)
        g_row[gids], c_row[cids] = gvals, cvals
        np.testing.assert_allclose(g_row, c_row, atol=1e-6)


def _cohorts(algo, sources, k, eps):
    out = {}
    cohorts = []
    for idxs, vals, ids in algo.compute_topk_ids_cohorts(sources, k, eps):
        cohorts.append(sorted(int(i) for i in idxs))
        for i, v, nid in zip(idxs, vals, ids):
            out[int(i)] = set(topk_ids_with_ties_from_pairs(v, nid, k))
    return cohorts, out


@pytest.mark.parametrize("k,eps,early_exit", [(10, 0.5, False),
                                              (3, 0.1, True)])
def test_cohort_on_the_card_matches_cpu(cuda, k, eps, early_exit):
    """The cohort ladder on the card retires the same rows per stage as on
    the CPU, with the same tie-expanded id sets, and launches K3."""
    sources = np.random.default_rng(5).integers(0, 2048, 24)
    outs = []
    for dev in ("cpu", cuda):
        ds = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                                device=dev)
        algo = ForaTopk(ds, ALPHA, k, push="none", early_exit=early_exit)
        before = row_gather.segment_sum_launches
        outs.append((*_cohorts(algo, sources, k, eps), algo.last_iters,
                     row_gather.segment_sum_launches - before))
    (ccoh, crows, cit, _), (gcoh, grows, git, launched) = outs
    assert gcoh == ccoh and git == cit and grows == crows
    assert launched >= git


def test_batch_early_exit_on_the_card_matches_cpu(cuda):
    sources = np.random.default_rng(5).integers(0, 2048, 24)
    iters = []
    for dev in ("cpu", cuda):
        ds = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                                device=dev)
        algo = ForaTopk(ds, ALPHA, 1, push="none", early_exit=True)
        algo.compute_topk_ids_batch(sources, 1, 0.5)
        iters.append(algo.last_iters)
    assert iters[0] == iters[1] > 0


def test_server_on_the_card_gives_the_service_rows(cuda):
    """The dispatcher thread launches on the graph's card and on that
    card's default stream, and its rows are the service's for the batch it
    dispatches."""
    ds = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0, device=cuda)
    svc = PPRService.from_dataset(ds, k=10, hub_split=128)
    seen = []

    class Spy:
        n_nodes = svc.n_nodes

        def top_k(self, sources, k=None, eps=None):
            seen.append((threading.current_thread().name,
                         torch.cuda.current_device(),
                         torch.cuda.current_stream().cuda_stream))
            return svc.top_k(sources, k=k, eps=eps)

    sources = [3, 14, 50, 7, 3]
    want = svc.top_k(sources + [sources[0]] * 3)[: len(sources)]
    before = row_gather.segment_sum_launches
    with PPRBatchServer(Spy(), max_batch=64, prewarm=True) as server:
        rows = [f.result(timeout=120)
                for f in [server.submit(s) for s in sources]]
    assert row_gather.segment_sum_launches > before
    assert seen[-1] == ("ppr-batch-dispatch", ds.graph.device.index or 0,
                        torch.cuda.default_stream(cuda).cuda_stream)
    for got, w in zip(rows, want):
        assert [h.node for h in got] == [h.node for h in w]
        np.testing.assert_allclose([h.score for h in got],
                                   [h.score for h in w], rtol=1e-6)


def test_cohort_server_on_the_card_streams_the_service_rows(cuda):
    """``PPRService(cohort=True)`` on the card behind the server: the
    dispatcher runs ``top_k_stream``, and each caller gets its own
    source's row, the ids of the CPU service's stream of the same
    sources (rows are independent of their co-tenants)."""
    sources = [int(s) for s in np.random.default_rng(5).integers(0, 2048, 24)]
    want = {}

    def keep(idxs, rows):
        for i, row in zip(idxs, rows):
            want[sources[int(i)]] = {h.node for h in row}

    cpu = PPRService.from_dataset(
        synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0, device="cpu"),
        k=10, cohort=True)
    cpu.top_k_stream(sources, emit=keep)
    svc = PPRService.from_dataset(
        synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0, device=cuda),
        k=10, cohort=True)
    before = row_gather.segment_sum_launches
    with PPRBatchServer(svc, max_batch=64, prewarm=True) as server:
        rows = [f.result(timeout=120)
                for f in [server.submit(s) for s in sources]]
    assert row_gather.segment_sum_launches > before
    for s, got in zip(sources, rows):
        assert {h.node for h in got} == want[s]


def test_walks_on_the_card_conserve_mass_and_reset_dangling(cuda):
    g = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                           device=cuda).graph
    rng = np.random.default_rng(0)
    w = 1 << 16
    starts = torch.as_tensor(rng.integers(0, g.n, w), dtype=torch.int32,
                             device=cuda)
    rows = torch.as_tensor(rng.integers(0, 4, w), device=cuda)
    weights = torch.as_tensor(rng.random(w, dtype=np.float32), device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    for no_zero_hop in (False, True):
        counts = walk.weighted_walk_counts(g, starts, rows, weights, gen,
                                           ALPHA, 4, no_zero_hop=no_zero_hop)
        want = np.bincount(rows.cpu().numpy(),
                           weights.cpu().numpy().astype(np.float64), 4)
        np.testing.assert_allclose(counts.sum(dim=1).double().cpu().numpy(),
                                   want, rtol=1e-6)
        assert (counts >= 0).all() and not counts[:, g.n:].any()
    dangling = int(g.dang_ids[0])
    stops = walk.random_walks(
        g, torch.full((4096,), dangling, dtype=torch.int32, device=cuda),
        gen, ALPHA)
    assert (stops == dangling).all()


def test_expand_walkers_on_the_card_matches_cpu(cuda):
    om = np.random.default_rng(2).integers(0, 5, 3000)
    om[:40] = 0
    for cap in (int(om.sum()), int(om.sum()) // 2, int(om.sum()) + 77):
        cpu = walk.expand_walkers(torch.as_tensor(om), cap)
        card = walk.expand_walkers(torch.as_tensor(om, device=cuda), cap)
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("hubs", [None, 128])
def test_residual_propagate_on_the_card_matches_cpu(cuda, hubs):
    outs = []
    before = row_gather.segment_sum_launches
    for dev in ("cpu", cuda):
        g = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0,
                               device=dev).graph
        sources = torch.as_tensor(np.arange(0, 2048, 97), dtype=torch.int32,
                                  device=dev)
        p, r, oh = forward_push_init(g, sources)
        hs = build_hub_split(g, hubs) if hubs else None
        p, r, iters = fora.residual_propagate(g, torch.zeros_like(p), r, oh,
                                              1e-5, ALPHA, hs=hs)
        outs.append((p.cpu(), r.cpu(), iters))
    (cp, cr, cit), (gp, gr, git) = outs
    assert git == cit > 0
    torch.testing.assert_close(gp, cp, atol=1e-5, rtol=0)
    torch.testing.assert_close(gr, cr, atol=1e-5, rtol=0)
    assert row_gather.segment_sum_launches - before >= git


def test_calibrate_measure_on_the_card(cuda):
    g = synthetic_powerlaw(4096, 8, seed=3, dense_threshold=0,
                           device=cuda).graph
    walk_ns, spmv_ns, amortized, d2h = calibrate.measure(g)
    assert amortized is True
    assert all(np.isfinite(x) and x > 0 for x in (walk_ns, spmv_ns, d2h))


def test_push_warmup_keeps_the_build_out_of_push_ns(cuda, tmp_path,
                                                    monkeypatch):
    """With no K3 library built or loaded, the first whole-graph call of a
    shape builds it with nvcc in its untimed warm push: the timed rounds
    see launches only."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(cuda_build, "FUNCTIONS", {})
    monkeypatch.setattr(fora, "_WARMED_PUSH_SHAPES", set())
    ds = synthetic_powerlaw(2048, 8, seed=3, dense_threshold=0, device=cuda)
    algo = fora.ForaWholeGraph(ds, ALPHA, completion="spmv")
    sources = np.arange(0, 2048, 64)
    algo.compute_whole_graph_batch(sources, 0.5)
    build_s, _ = cuda_build.BUILD_INFO["row_gather"]
    assert build_s > 1.0                        # nvcc ran in this call
    assert algo.last_push_ns * len(sources) < 0.5 * build_s * 1e9


# -- the mesh engines on one card (repeated-device meshes) -----------------

def _mesh_graph(dev, weighted):
    if weighted:
        return synthetic_weighted(4096, 16, seed=5, dense_threshold=0,
                                  device=dev)
    return synthetic_powerlaw(4096, 16, seed=5, dense_threshold=0,
                              device=dev)


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
@pytest.mark.parametrize("b", [3, 64, 512])
def test_k3_over_an_edge_chunk_matches_plain(cuda, weighted, b):
    """The edge engine's push, K3 over a chunk of the sorted edges with
    the row pointer clamped to it, equals the plain version bit for bit
    (its coefficient mode on a weighted graph)."""
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.sharded import edge_chunks

    g = _mesh_graph(cuda, weighted).graph
    rem = torch.rand((g.n_pad, b), device=cuda)
    before = row_gather.segment_sum_launches
    for ch in edge_chunks(g, make_mesh(4, data=1, graph=4,
                                       devices=[cuda] * 4))[0]:
        got = ch.push(rem)
        table = rem if ch.coef is not None else rem * ch.inv_deg[:, None]
        want = row_gather.gather_segment_sum_ref(
            table.cpu(), ch.src.cpu(), ch.ptr.cpu(),
            None if ch.coef is None else ch.coef.cpu())
        assert torch.equal(got.cpu(), want)
    assert row_gather.segment_sum_launches == before + 4


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
@pytest.mark.parametrize("b", [3, 64, 512])
def test_k3_over_a_ring_block_matches_plain(cuda, weighted, b):
    """Every ring block of the node engine (a shard's destinations, one
    source range, the padding left out) through K3 equals the plain
    version bit for bit."""
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.node_sharded import node_shards

    g = _mesh_graph(cuda, weighted).graph
    shards = node_shards(g, make_mesh(4, data=1, graph=4,
                                      devices=[cuda] * 4))[0]
    n_local = g.n_pad // 4
    table = torch.rand((n_local, b), device=cuda)
    for sh in shards:
        for blk in sh.blocks:
            if blk.src is None:
                continue
            want = row_gather.gather_segment_sum_ref(
                table.cpu(), blk.src.cpu(), blk.ptr.cpu(),
                None if blk.coef is None else blk.coef.cpu())
            assert torch.equal(blk.push(table).cpu(), want)


@pytest.mark.parametrize("engine,shape,opts", [
    ("edge", (2, 2), {}), ("edge", (1, 1), {}), ("node", (1, 4), {}),
    ("node", (2, 2), {"ring_dtype": "bf16"}),
    ("node", (1, 4), {"frontier_blocks": 64}),
    ("node", (1, 4), {"frontier_blocks": 8}),
], ids=["edge2x2", "edge1x1", "node1x4", "node2x2-bf16", "node-full",
        "node-low"])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
def test_mesh_on_one_card_matches_cpu(cuda, engine, shape, opts, weighted):
    """A mesh of one card repeated runs K3 on every shard and answers as
    the same mesh of CPU devices: the same sweeps and tie-expanded top-10
    sets, scores within 1e-6 (the card's column sums add in another
    order). Frontier compaction below full capacity picks its blocks by
    their residue sums, so a near-tie of two blocks may go the other way
    on the card: that run is held to the bars of
    ``tests/test_frontier_ring.py`` (rtol 5e-2, atol 5e-3, the card's
    top-10 within the CPU's ties at that bar) and its sweeps to 10%."""
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.node_sharded_fora import NodeShardedForaTopk
    from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

    cls = ShardedForaTopk if engine == "edge" else NodeShardedForaTopk
    sources = np.random.default_rng(3).integers(0, 4096, 64)
    outs = []
    for dev in ("cpu", cuda):
        ds = _mesh_graph(dev, weighted)
        n = shape[0] * shape[1]
        eng = cls(ds, ALPHA, 10, mesh=make_mesh(
            n, data=shape[0], graph=shape[1], devices=[dev] * n), **opts)
        before = (row_gather.segment_sum_launches,
                  row_gather.segment_sum_coef_launches)
        dense = eng.compute_topk_batch(sources, 10, 0.5)
        outs.append((dense, eng.last_iters))
    launched = row_gather.segment_sum_launches - before[0]
    assert launched >= outs[1][1]
    assert (row_gather.segment_sum_coef_launches - before[1]
            == (launched if weighted else 0))
    (cpu, cit), (card, git) = outs
    if opts.get("frontier_blocks", 64) < 64:
        assert abs(git - cit) <= 0.1 * cit
        np.testing.assert_allclose(card, cpu, atol=5e-3, rtol=5e-2)
        for i in range(len(sources)):
            kth = np.sort(cpu[i])[-10]
            assert set(topk_ids_with_ties(card[i], 10).tolist()) <= set(
                topk_ids_with_ties(cpu[i], 10,
                                   tol=5e-3 + 5e-2 * kth).tolist())
        return
    assert git == cit > 0
    np.testing.assert_allclose(card, cpu, atol=1e-6, rtol=0)
    for i in range(len(sources)):
        assert set(topk_ids_with_ties(card[i], 10, tol=1e-6).tolist()) == \
            set(topk_ids_with_ties(cpu[i], 10, tol=1e-6).tolist())


def test_whole_graph_mesh_on_one_card(cuda):
    """The whole-graph engine on one card repeated answers as the same
    mesh of CPU devices: ``spmv`` within 1e-6 on the same ring sweeps;
    ``walks`` (other random streams on the card) with row mass 1 within
    1e-3, within 0.03 of the CPU's ``spmv`` rows and each row's L1
    distance from them below the mass the walks carry. Every ring sweep
    launches K3 once a non-empty block."""
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.node_sharded import node_shards
    from ppr_tpu_torch.parallel.node_sharded_fora import (
        NodeShardedForaWholeGraph)

    sources = np.arange(0, 4096, 512)

    def whole_graph(dev, completion):
        ds = _mesh_graph(dev, False)
        mesh = make_mesh(4, data=1, graph=4, devices=[dev] * 4)
        eng = NodeShardedForaWholeGraph(ds, ALPHA, mesh=mesh,
                                        completion=completion,
                                        max_walkers_per_device=1 << 20)
        before = row_gather.segment_sum_launches
        out = eng.compute_whole_graph_batch(sources, 0.5)
        blocks = sum(bl.src is not None
                     for sh in node_shards(ds.graph, mesh)[0]
                     for bl in sh.blocks)
        return out, eng.last_iters, \
            (row_gather.segment_sum_launches - before, blocks), ds.n

    cpu, cpu_iters, _, n = whole_graph("cpu", "spmv")
    card, iters, (launched, blocks), _ = whole_graph(cuda, "spmv")
    assert iters == cpu_iters and launched >= iters * blocks > 0
    np.testing.assert_allclose(card.sum(axis=1), 1.0, atol=0.5 / n)
    np.testing.assert_allclose(card, cpu, atol=1e-6, rtol=0)
    walks, iters, (launched, blocks), _ = whole_graph(cuda, "walks")
    assert launched >= iters * blocks > 0
    np.testing.assert_allclose(walks.sum(axis=1), 1.0, atol=1e-3)
    diff = np.abs(walks.astype(np.float64) - cpu)
    assert diff.max() < 0.03
    assert diff.sum(axis=1).max() < (1.0 - ALPHA) ** iters


def test_dryrun_on_one_card(cuda):
    from ppr_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(4, devices=[cuda] * 4)
    assert out["edge_err"] <= 5e-6 and out["node_err"] <= 5e-6
    assert out["base"]["edge_bws_err"] <= 5e-6
    assert out["base"]["node_bws_err"] <= 5e-6
    assert min(out["base"]["store_bytes"].values()) > 0


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
@pytest.mark.parametrize("b", [3, 64, 512])
def test_k3_by_source_over_an_edge_chunk_matches_plain(cuda, weighted, b):
    """The all-pair edge engine's reverse step, K3 over a chunk of the
    source-sorted edges (gather at the destinations, sum by source, the
    row pointer clamped to the chunk), equals the plain version bit for
    bit (its coefficient mode on a weighted graph)."""
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.sharded import edge_chunks_bysrc

    g = _mesh_graph(cuda, weighted).graph
    rem = torch.rand((g.n_pad, b), device=cuda)
    before = row_gather.segment_sum_launches
    for ch in edge_chunks_bysrc(g, make_mesh(4, data=1, graph=4,
                                             devices=[cuda] * 4))[0]:
        want = row_gather.gather_segment_sum_ref(
            rem.cpu(), ch.src.cpu(), ch.ptr.cpu(),
            None if ch.coef is None else ch.coef.cpu())
        assert torch.equal(ch.gather(rem).cpu(), want)
    assert row_gather.segment_sum_launches == before + 4


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
@pytest.mark.parametrize("b", [3, 64, 512])
def test_k3_over_a_reverse_ring_block_matches_plain(cuda, weighted, b):
    """Every block of the node-sharded all-pair ring (a shard's sources,
    one destination range, sorted by source) through K3 equals the plain
    version bit for bit."""
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.node_sharded_allpair import reverse_shards

    g = _mesh_graph(cuda, weighted).graph
    shards = reverse_shards(g, make_mesh(4, data=1, graph=4,
                                         devices=[cuda] * 4))[0]
    table = torch.rand((g.n_pad // 4, b), device=cuda)
    for sh in shards:
        for blk in sh.blocks:
            if blk.src is None:
                continue
            want = row_gather.gather_segment_sum_ref(
                table.cpu(), blk.src.cpu(), blk.ptr.cpu(),
                None if blk.coef is None else blk.coef.cpu())
            assert torch.equal(blk.push(table).cpu(), want)


def _mesh_of(dev, d, g):
    from ppr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(d * g, data=d, graph=g, devices=[dev] * (d * g))


@pytest.mark.parametrize("algo,param", [("FWDPUSH", 1e-6),
                                        ("NEO4J_METHOD", 20)])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
def test_mesh_drop_ins_on_one_card_match_cpu(cuda, algo, param, weighted):
    """Forward Push and the Neo4j method on a 2x2 mesh of the card
    repeated answer as the same mesh of CPU devices (within 1e-6: the
    card's column sums add in another order; Forward Push on the same
    sweeps), and launch K3 at least once a chunk and sweep."""
    from ppr_tpu_torch.parallel.mesh_algos import mesh_algo_obj

    sources = np.random.default_rng(4).integers(0, 4096, 16)
    outs = []
    for dev in ("cpu", cuda):
        ds = _mesh_graph(dev, weighted)
        eng = mesh_algo_obj(AlgoType(algo), ds, ALPHA, 10,
                            mesh=_mesh_of(dev, 2, 2))
        before = row_gather.segment_sum_launches
        outs.append((eng.compute_whole_graph_batch(sources, param),
                     getattr(eng, "last_sweeps", param)))
    launched = row_gather.segment_sum_launches - before
    (cpu, c_sweeps), (card, g_sweeps) = outs
    assert g_sweeps == c_sweeps > 0
    assert launched >= g_sweeps * 4
    np.testing.assert_allclose(card, cpu, atol=1e-6, rtol=0)


@pytest.mark.parametrize("engine,shape", [("edge", (2, 2)),
                                          ("node", (1, 4))])
@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
def test_allpair_engines_on_one_card_match_cpu(cuda, engine, shape,
                                               weighted):
    """Both all-pair engines on one card repeated answer as the same mesh
    of CPU devices, on the same sweeps; at 1x1 the card's engine is the
    card's single-device backward search bit for bit."""
    from ppr_tpu_torch.models.backward_search import BackwardSearch
    from ppr_tpu_torch.parallel.node_sharded_allpair import (
        NodeShardedBackwardSearch)
    from ppr_tpu_torch.parallel.sharded_allpair import ShardedBackwardSearch

    cls = ShardedBackwardSearch if engine == "edge" \
        else NodeShardedBackwardSearch
    targets = np.arange(0, 4096, 97)
    outs = []
    for dev in ("cpu", cuda):
        g = _mesh_graph(dev, weighted).graph
        eng = cls(g, ALPHA, 1e-4, mesh=_mesh_of(dev, *shape))
        outs.append((eng.whole_graph(targets), eng.last_sweeps))
    (cpu, cs), (card, gs) = outs
    assert gs == cs > 0
    np.testing.assert_allclose(card, cpu, atol=1e-6, rtol=0)
    g = _mesh_graph(cuda, weighted).graph
    np.testing.assert_array_equal(
        cls(g, ALPHA, 1e-4, mesh=_mesh_of(cuda, 1, 1)).whole_graph(targets),
        BackwardSearch(g, ALPHA, 1e-4).whole_graph(targets))


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "coef"])
def test_fora_whole_graph_and_mc_mesh_on_one_card(cuda, weighted):
    """FORA whole-graph on a 2x2 mesh of the card is within eps/n + 1e-5
    of the power method (its push rounds follow the clock, so it is held
    to the oracle); Monte-Carlo's rows have mass 1 within 1e-3 and lie
    within 0.05 of it."""
    from ppr_tpu_torch.parallel.mesh_algos import (MeshForaWholeGraph,
                                                   MeshMonteCarlo)

    ds = _mesh_graph(cuda, weighted)
    sources = np.array([1, 70, 800, 3000])
    exact = power_method_batch(ds.graph, sources, ALPHA, 200).cpu().numpy()
    wg = MeshForaWholeGraph(ds, ALPHA, mesh=_mesh_of(cuda, 2, 2))
    out = wg.compute_whole_graph_batch(sources, 0.5)
    assert np.abs(out - exact).max() <= 0.5 / ds.n + 1e-5
    mc = MeshMonteCarlo(ds, ALPHA, mesh=_mesh_of(cuda, 2, 2), seed=3)
    walks = mc.compute_whole_graph_batch(sources, 1.0)
    np.testing.assert_allclose(walks.sum(axis=1), 1.0, atol=1e-3)
    assert np.abs(walks - exact).max() < 0.05


def test_cli_mesh_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``--mesh 1x1 --device cuda`` writes the rows of ``--mesh 1x1
    --device cpu`` (Test 1; max-err within 1e-8)."""
    from ppr_tpu_torch import cli

    rows = {}
    for dev in ("cpu", "cuda"):
        out = tmp_path / dev
        out.mkdir()
        monkeypatch.chdir(out)
        assert cli.main(["--db", "synth:107x3@7", "--sweep", "got",
                         "--query", "8", "--tests", "1", "--algos",
                         "FWDPUSH,NEO4J_METHOD", "--mesh", "1x1",
                         "--device", dev, "--out-dir", str(out)]) == 0
        text = (out / "synth_107_7_AlgoPerfResults.txt").read_text()
        rows[dev] = [line.split(",") for line in text.splitlines()
                     if "," in line]
    assert len(rows["cuda"]) == len(rows["cpu"]) == 10
    for a, b in zip(rows["cuda"], rows["cpu"]):
        assert a[0] == b[0] and abs(float(a[-1]) - float(b[-1])) <= 1e-8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hubs", ["auto", 128, 1000])
def test_hub_split_on_the_card_matches_cpu(cuda, dtype, hubs):
    """The hub matrix written on the card from the edge counts: the CPU's
    split (ids, tail, the counts as floats), and ``"auto"`` the same count
    on both devices."""
    ds_c = synthetic_powerlaw(4096, 16, seed=7, dense_threshold=0,
                              device="cpu")
    ds_g = synthetic_powerlaw(4096, 16, seed=7, dense_threshold=0,
                              device=cuda)
    hc = build_hub_split(ds_c.graph, hubs, dtype=dtype)
    hg = build_hub_split(ds_g.graph, hubs, dtype=dtype)
    assert hg.num_hubs == hc.num_hubs and hg.m_tail == hc.m_tail
    assert hg.hub_matrix.dtype == dtype
    assert torch.equal(hg.hub_ids.cpu(), hc.hub_ids)
    assert torch.equal(hg.hub_matrix.float().cpu(), hc.hub_matrix)
    assert torch.equal(hg.tail_src.cpu(), hc.tail_src)
    assert torch.equal(hg.tail_ptr.cpu(), hc.tail_ptr)


@pytest.mark.parametrize("b", [1, 16, 64])
def test_k3_at_the_1m_row_count_matches_plain(cuda, b):
    """K3 over 2^20 + 128 table rows (the 1M cell's n_pad) and a few million
    destination-sorted edges with long and empty segments: bit for bit its
    plain version, twice."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    n_rows, m = (1 << 20) + 128, 3_000_000
    rng = np.random.default_rng(11)
    w = 1.0 / (np.arange(n_rows) + 10.0)
    dst = np.sort(rng.choice(n_rows - 1, size=m, p=w[:-1] / w[:-1].sum()))
    src = torch.as_tensor(rng.integers(0, n_rows, m).astype(np.int32),
                          device=cuda)
    ptr = torch.as_tensor(np.searchsorted(dst, np.arange(n_rows + 1))
                          .astype(np.int64), device=cuda)
    table = torch.rand((n_rows, b), device=cuda, generator=gen)
    got = row_gather.gather_segment_sum(table, src, ptr)
    want = row_gather.gather_segment_sum_ref(table, src, ptr)
    assert torch.equal(got, want)
    assert torch.equal(got, row_gather.gather_segment_sum(table, src, ptr))


def test_fora_auto_hubs_on_the_card_matches_cpu(cuda):
    """``ForaTopk.enable_hub_split()`` (the automatic count, f32 product)
    on the card: the CPU's count, sweeps and top-10 sets."""
    out = {}
    for dev in ("cpu", cuda):
        ds = synthetic_powerlaw(4096, 16, seed=7, dense_threshold=0,
                                device=dev)
        algo = ForaTopk(ds, ALPHA, 10, push="none")
        algo.enable_hub_split()
        vals, ids = algo.compute_topk_ids_batch(np.arange(0, 4096, 97), 10,
                                                0.5)
        out[str(dev)] = (algo.hub_split.num_hubs, algo.last_iters,
                         [set(topk_ids_with_ties_from_pairs(
                             vals[i], ids[i], 10, tol=1e-6).tolist())
                          for i in range(len(vals))])
    assert out["cpu"] == out[str(cuda)]


def test_fora_without_a_split_on_the_card_matches_cpu(cuda, monkeypatch):
    """Where no node passes the automatic rule's threshold (prices that
    put it half an in-link over the graph's largest in-degree),
    ``ForaTopk.enable_hub_split(dtype=bf16)`` makes no split on the card as
    on the CPU: the same count (0), sweeps and top-10 sets; on the card
    the pre pass launches once a sweep launched, and writes no bf16
    copy."""
    from torch.profiler import ProfilerActivity, profile

    from ppr_tpu_torch.ops import hub_split, sweep_pass
    from ppr_tpu_torch.utils import timer

    out = {}
    for dev in ("cpu", cuda):
        ds = synthetic_powerlaw(4096, 16, seed=7, dense_threshold=0,
                                device=dev)
        g = ds.graph
        col_ns = g.n_pad * 2 / hub_split.HUB_COLUMN_GBPS
        monkeypatch.setattr(hub_split, "TAIL_NS_PER_EDGE",
                            col_ns / (float(g.in_deg.max()) + 0.5))
        algo = ForaTopk(ds, ALPHA, 10, push="none")
        algo.enable_hub_split(dtype=torch.bfloat16)
        timer.RECORDER.clear()
        before = sweep_pass.pre_launches
        with profile(activities=[ProfilerActivity.CPU]):
            vals, ids = algo.compute_topk_ids_batch(
                np.arange(0, 4096, 97), 10, 0.5)
        launched = sweep_pass.pre_launches - before
        c = timer.RECORDER.counters()
        (sp,) = [s for s in timer.RECORDER.spans() if s.name == "loop.topk"]
        timer.RECORDER.clear()
        sweeps = c["loop.sweeps"][0]
        assert launched == (sweeps if g.device.type == "cuda" else 0)
        assert c["loop.fused_sweeps"] == (launched, 1)
        assert c["loop.bf16_copy_elems"] == (0, 1)
        assert sp.attrs["hubs"] == 0 and sp.attrs["tail_edges"] == g.m
        out[str(dev)] = (0 if algo.hub_split is None else
                         algo.hub_split.num_hubs, algo.last_iters,
                         [set(topk_ids_with_ties_from_pairs(
                             vals[i], ids[i], 10, tol=1e-6).tolist())
                          for i in range(len(vals))])
    assert out["cpu"][0] == 0
    assert out["cpu"] == out[str(cuda)]


# -- a mesh across processes on the one card --------------------------------

def spanning_rank(work: str, backend: str) -> None:
    """A rank of the card tests' spawns: ``backend`` ranks sharing the card
    run the edge engine on ``global_mesh(2)`` and save what they got."""
    import os

    import torch.distributed as dist

    from ppr_tpu_torch.parallel.distributed import (global_mesh,
                                                    initialize_from_env)
    from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

    assert initialize_from_env(backend, timeout_s=60)
    dev = torch.device("cuda", torch.cuda.current_device())
    if backend == "nccl":
        x = torch.ones(4, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
    mesh = global_mesh(2, devices=[dev])
    ds = synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0, device=dev)
    eng = ShardedForaTopk(ds, ALPHA, 10, mesh=mesh)
    sources = np.arange(8, dtype=np.int32) * 37
    out = {"dense": eng.compute_topk_batch(sources, 10, 0.5),
           "iters": eng.last_iters,
           "ids": eng.compute_topk_ids_batch(sources, 10, 0.5)[1],
           "launches": row_gather.segment_sum_launches,
           "probes": probe.launches}
    torch.save(out, os.path.join(work, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


def spawn_on_the_card(tmp_path, backend: str, nprocs: int = 2):
    import os
    import sys

    from ppr_tpu_torch.parallel.distributed import spawn_local

    here = os.path.dirname(os.path.abspath(__file__))
    code = (f"import sys; sys.path[:0] = [{here!r}, "
            f"{os.path.dirname(here)!r}]; import test_torch_cuda as t; "
            f"t.spanning_rank({str(tmp_path)!r}, {backend!r})")
    spawn_local(nprocs, [sys.executable, "-c", code], timeout_s=180,
                log_dir=str(tmp_path / "logs"))
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(nprocs)]


def test_spanning_edge_mesh_on_the_card_is_one_process(cuda, tmp_path):
    """Two gloo ranks sharing the card, each a position of an edge 1x2
    mesh: the single-process ``["cuda:0"] * 2`` mesh's sweeps and bits on
    both ranks; each rank launched K0 once and K3 on its own chunk."""
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

    ranks = spawn_on_the_card(tmp_path, "gloo")
    ds = synthetic_powerlaw(2048, 8, seed=5, dense_threshold=0,
                            device=cuda)
    mesh = make_mesh(2, data=1, graph=2, devices=[cuda] * 2)
    eng = ShardedForaTopk(ds, ALPHA, 10, mesh=mesh)
    sources = np.arange(8, dtype=np.int32) * 37
    want = eng.compute_topk_batch(sources, 10, 0.5)
    for got in ranks:
        assert got["iters"] == eng.last_iters > 0
        assert got["dense"].tobytes() == want.tobytes()
        assert got["probes"] == 1 and got["launches"] > 0


def test_nccl_refuses_two_ranks_on_one_card(cuda, tmp_path):
    """NCCL takes one rank a card: two NCCL ranks on the one card fail
    (their words are printed), which is why ranks sharing a card use
    gloo."""
    if torch.cuda.device_count() != 1:
        pytest.skip("needs exactly one card")
    with pytest.raises(RuntimeError) as err:
        spawn_on_the_card(tmp_path, "nccl")
    words = [line for line in str(err.value).splitlines()
             if "NCCL" in line or "ncclInvalidUsage" in line
             or "Duplicate GPU" in line]
    print("NCCL's words:", *words[:6], sep="\n  ")
    assert words


# -- the sweep profile and the one trace reader -----------------------------

def test_profile_sweep_on_the_card(cuda, tmp_path, monkeypatch):
    """``profile_sweep_torch.py --quick --hubs 128 --trace`` on the card and
    on the CPU: ``device_ms`` (CUDA events around the call) beside every
    host wall; the CPU's sweeps for ``plain`` (K3 is its plain version bit
    for bit), within one sweep for the hub variants (cuBLAS adds the hub
    product in another order); each traced annealed variant's split names
    K3, and the hub variants' the hub product, by kernel and by operator."""
    import profile_sweep_torch

    monkeypatch.chdir(tmp_path)
    recs = {}
    for dev in ("cpu", "cuda"):
        recs[dev] = profile_sweep_torch.run(profile_sweep_torch.parse_args(
            ["--quick", "--hubs", "128", "--device", dev, "--trace"]))
    cpu, card = recs["cpu"]["summary"], recs["cuda"]["summary"]
    assert set(card) == set(cpu)
    for name, row in card.items():
        assert 0 < row["device_ms"] <= row["total_ms"] + 0.5, name
        assert cpu[name]["device_ms"] is None
        if name.endswith("plain"):
            assert row["iters"] == cpu[name]["iters"], name
        else:
            assert abs(row["iters"] - cpu[name]["iters"]) <= 1, name
    assert set(recs["cuda"]["traces"]) == {"annealed_plain",
                                           "annealed_hub128_bf16"}
    for tag, tr in recs["cuda"]["traces"].items():
        print(tag, [k["name"][:60] for k in tr["by_kernel"][:8]],
              [o["name"] for o in tr["by_op"][:8]])
        assert tr["kernels"] > 0 and 0 < tr["busy_ms"] <= tr["span_ms"]
        assert 0 <= tr["idle_share"] < 1
        assert tr["named"]["K3"]["launches"] > 0
        assert any("ppr_gather_kernel" in k["name"] for k in tr["by_kernel"])
        if "hub" in tag:
            assert tr["named"]["hub mm"]["launches"] > 0
            assert any(o["name"] == "aten::mm" for o in tr["by_op"])


def test_kernel_split_of_a_real_trace(cuda, tmp_path):
    """Three K3 launches and two hub-sized products, traced: the reader
    counts each launch once, K3 by name, the products under ``aten::mm``,
    and busy time within the span."""
    from ppr_tpu_torch.utils.timer import kernel_split, trace

    g = synthetic_powerlaw(4096, 8, seed=3, dense_threshold=0,
                           device=cuda).graph
    table = torch.rand((g.n_pad, 64), device=cuda)
    mat = torch.rand((g.n_pad, 512), device=cuda).to(torch.bfloat16)
    x = table.to(torch.bfloat16)
    row_gather.gather_segment_sum(table, g.edge_src_bydst, g.bydst_ptr)
    torch.mm(mat.T, x, out_dtype=torch.float32)
    torch.cuda.synchronize()
    with trace(str(tmp_path)):
        # idle margins: the profiler keeps only the device events that fall
        # inside its window, and this window's work takes well under 1 ms
        time.sleep(0.05)
        for _ in range(3):
            row_gather.gather_segment_sum(table, g.edge_src_bydst, g.bydst_ptr)
        for _ in range(2):
            torch.mm(mat.T, x, out_dtype=torch.float32)
        torch.cuda.synchronize()
        time.sleep(0.05)
    split = kernel_split(str(tmp_path / "trace.json"),
                         named={"K3": ("ppr_gather_kernel",)})
    print([k["name"][:60] for k in split["by_kernel"]],
          [o["name"] for o in split["by_op"]])
    assert split["named"]["K3"]["launches"] == 3
    assert 0 < split["busy_ms"] <= split["span_ms"]
    assert sum(k["ms"] for k in split["by_kernel"]) >= \
        split["busy_ms"] * (1 - 1e-9)
    mm = [o for o in split["by_op"] if o["name"] == "aten::mm"]
    assert mm and mm[0]["launches"] >= 2
