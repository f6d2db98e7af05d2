"""Port tests that need an NVIDIA card (marker ``cuda``; they skip without
one). This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerances: K1, K2 and the hub product sum in another order than the plain
versions (2e-5 after 100 or 300 rounds, the JAX package's kernel-vs-XLA
bound; 1e-5 for one product); K3's segment sums run in edge order like the
plain ``segment_reduce``, in f32 (rtol 1e-5); K0 and the row gather are
exact. Forward Push and BASE rows on the card agree with the CPU's within
1e-6, and with the same sweep count."""

import numpy as np
import pytest
import torch

from ppr_tpu_torch.graph.io import load_default, synthetic_powerlaw
from ppr_tpu_torch.harness import PerfHarness, TestType
from ppr_tpu_torch.models.base_allpair import BaseAllPair
from ppr_tpu_torch.models.config import AlgoType
from ppr_tpu_torch.models.fora import ForaTopk, annealed_topk_propagate
from ppr_tpu_torch.models.forward_push import ForwardPush
from ppr_tpu_torch.models.neo4j_method import (Neo4jMethod,
                                               personalized_pagerank_batch)
from ppr_tpu_torch.models.power_method import PowerMethod, power_method_batch
from ppr_tpu_torch.ops import dense_power, probe, row_gather, spmv
from ppr_tpu_torch.ops.hub_split import build_hub_split, push_out_hybrid_t
from ppr_tpu_torch.ops.push import forward_push_init

pytestmark = pytest.mark.cuda
ALPHA = 0.15


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
@pytest.mark.parametrize("b", [1, 3, 50, 512, 2048])
def test_k3_matches_plain(cuda, b, misalign, order):
    """K3 on the forward push's destination-sorted edges and on the
    backward push's source-sorted ones (BASE pushes 512 targets a batch)."""
    g, table = k3_operands(cuda, b, misalign=misalign)
    src, ptr = ((g.edge_src_bydst, g.bydst_ptr) if order == "bydst"
                else (g.edge_dst, g.bysrc_ptr))
    before = row_gather.segment_sum_launches
    got = row_gather.gather_segment_sum(table, src, ptr)
    ref = row_gather.gather_segment_sum_ref(table, src, ptr)
    torch.cuda.synchronize()
    assert row_gather.segment_sum_launches == before + 1
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    # the same bits every run
    assert torch.equal(got, row_gather.gather_segment_sum(table, src, ptr))


@pytest.mark.parametrize("b", [1, 3, 50, 2048])
def test_row_gather_matches_plain(cuda, b):
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
            push_out_hybrid_t(g, hs, x_t, num_chunks=2),
            spmv.pull_out_norm(g, x), spmv.pull_out_norm(g, x[0]))])
    torch.cuda.synchronize()
    assert row_gather.segment_sum_launches == before + 6
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
