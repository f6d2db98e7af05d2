"""Port tests that need an NVIDIA card (marker ``cuda``; they skip without
one). This file imports no JAX, so it runs on a machine that has only the
port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_cuda.py

Tolerances: K1, K2 and the hub product sum in another order than the plain
versions (2e-5 after 100 or 300 rounds, the JAX package's kernel-vs-XLA
bound; 1e-5 for one product); K0 is exact."""

import numpy as np
import pytest
import torch

from ppr_tpu_torch.graph.io import load_default, synthetic_powerlaw
from ppr_tpu_torch.harness import PerfHarness, TestType
from ppr_tpu_torch.models.config import AlgoType
from ppr_tpu_torch.models.fora import annealed_topk_propagate
from ppr_tpu_torch.models.neo4j_method import (Neo4jMethod,
                                               personalized_pagerank_batch)
from ppr_tpu_torch.models.power_method import PowerMethod, power_method_batch
from ppr_tpu_torch.ops import dense_power, probe
from ppr_tpu_torch.ops.hub_split import build_hub_split, push_out_hybrid_t
from ppr_tpu_torch.ops.push import forward_push_init

pytestmark = pytest.mark.cuda
ALPHA = 0.15


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.parametrize("dangling_to_source", [True, False],
                         ids=["to_source", "dropped"])
@pytest.mark.parametrize("n,b", [(107, 50), (1000, 1000), (300, 3)])
def test_k1_matches_plain(cuda, n, b, dangling_to_source):
    g = (load_default(device=cuda) if n == 107 else
         synthetic_powerlaw(n, 16, seed=11, dense_threshold=1024,
                            device=cuda)).graph
    assert dense_power.supports(g)
    sources = torch.as_tensor(np.random.default_rng(n).integers(0, g.n, b),
                              device=cuda)
    onehot = torch.nn.functional.one_hot(sources, g.n_pad).float()
    before = dense_power.launches
    out = dense_power.dense_power_iterations(
        g, onehot, ALPHA, 100, dangling_to_source=dangling_to_source)
    ref = dense_power.dense_power_iterations_ref(
        g, onehot, ALPHA, 100, dangling_to_source=dangling_to_source)
    torch.cuda.synchronize()
    assert dense_power.launches == before + 1
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


def test_k1_rejects_bad_operands(cuda):
    g = load_default(device=cuda).graph
    with pytest.raises(ValueError):
        dense_power.dense_power_iterations(
            g, torch.zeros((2, g.n_pad), device=cuda, dtype=torch.float64),
            ALPHA, 10)
    with pytest.raises(ValueError):
        dense_power.dense_power_iterations(
            g, torch.zeros((2, g.n_pad + 4), device=cuda), ALPHA, 10)


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


def dense_case(cuda, n):
    return (load_default(device=cuda) if n == 107 else
            synthetic_powerlaw(n, 16, seed=11, dense_threshold=1024,
                               device=cuda)).graph


@pytest.mark.parametrize("iters", [0, 300])
@pytest.mark.parametrize("n,b", [(107, 50), (1000, 1000), (300, 3)])
def test_k2_matches_plain(cuda, n, b, iters):
    g = dense_case(cuda, n)
    assert dense_power.supports(g)
    sources = torch.as_tensor(np.random.default_rng(n).integers(0, g.n, b),
                              device=cuda)
    onehot = torch.nn.functional.one_hot(sources, g.n_pad).float()
    before = dense_power.pagerank_launches
    out = dense_power.dense_pagerank_iterations(g, onehot, 1 - ALPHA, iters)
    ref = dense_power.dense_pagerank_iterations_ref(g, onehot, 1 - ALPHA,
                                                    iters)
    torch.cuda.synchronize()
    assert dense_power.pagerank_launches == before + 1
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    if iters == 0:
        assert torch.equal(out, ref)


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
