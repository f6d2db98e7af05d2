"""The traffic generator's schedule, the trace reader on a synthetic chrome
trace, the per-layer readers, and a tiny CPU rehearsal of each mix."""

import json
import types

import numpy as np
import pytest
import torch

from benchmark import graphgen, run, traffic
from benchmark.manifest import load_metric
from benchmark.tracing import NO_OP, WINDOW, Trace


def test_poisson_due_times_repeat_from_a_seed():
    a = traffic.due_times(np.random.default_rng([5, 1]), 800.0, 30.0)
    b = traffic.due_times(np.random.default_rng([5, 1]), 800.0, 30.0)
    c = traffic.due_times(np.random.default_rng([6, 1]), 800.0, 30.0)
    assert np.array_equal(a, b) and not np.array_equal(a[:50], c[:50])
    assert (np.diff(a) > 0).all() and a[0] >= 0 and a[-1] < 30.0
    assert a.size == pytest.approx(24000, rel=0.03)


def test_sources_are_uniform_and_seeded():
    s = traffic.sources(np.random.default_rng(1), 1000, 100000)
    assert s.min() >= 0 and s.max() < 1000
    assert np.bincount(s, minlength=1000).std() < 20


def test_the_rank_law_meets_the_published_mean_and_maximum():
    a = graphgen.rank_exponent(80513, 2 * 5899882 / 80513, 5706)
    ranks = np.arange(1, 80514, dtype=np.float64)
    assert 5706 * np.mean(ranks ** -a) == pytest.approx(146.5572, rel=1e-6)
    assert 0.3 < a < 0.4


@pytest.mark.parametrize("undirected", [True, False])
def test_graphs_are_simple_seeded_and_exact(undirected):
    n, m = 3000, 20000
    src, dst = graphgen.generate(n, m, 2**40 + 3, max_degree=400,
                                 undirected=undirected)
    again = graphgen.generate(n, m, 2**40 + 3, max_degree=400,
                              undirected=undirected)
    assert np.array_equal(src, again[0]) and np.array_equal(dst, again[1])
    assert src.size == (2 * m if undirected else m)
    assert (src != dst).all() and src.min() >= 0 and dst.max() < n
    assert np.unique(src * n + dst).size == src.size
    if undirected:
        fwd = set(zip(src.tolist(), dst.tolist()))
        assert all((d, s) in fwd for s, d in fwd)
    deg = graphgen.degree_summary(src, n)
    assert deg["mean"] == pytest.approx(src.size / n)
    assert 0.8 * 400 < deg["max"] <= 400 * 1.3


def _trace():
    """Two kernels linked to operators inside a window of 100 us, one
    unlinked that runs past its end and one after it; an ``aten::mm`` with
    its shapes. No launch call is recorded, so no kernel is moved."""
    return Trace([
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": 1000.0,
         "dur": 100.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1001.0,
         "dur": 5.0, "tid": 1, "args": {
             "External id": 7, "Input Dims": [[2944, 80640], [80640, 2048],
                                              []],
             "Input type": ["c10::BFloat16", "c10::BFloat16", "ScalarType"]}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mul", "ts": 1010.0,
         "dur": 5.0, "tid": 1, "args": {"External id": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 1060.0,
         "dur": 30.0, "tid": 1, "args": {"External id": 9}},
        {"ph": "X", "cat": "kernel", "name": "nvjet_gemm", "ts": 1010.0,
         "dur": 20.0, "args": {"External id": 7}},
        {"ph": "X", "cat": "kernel", "name": "void at::elementwise<float>()",
         "ts": 1025.0, "dur": 15.0, "args": {"External id": 8}},
        {"ph": "X", "cat": "kernel",
         "name": "void ppr_gather_kernel<4>(float const*)", "ts": 1095.0,
         "dur": 10.0, "args": {}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 1200.0,
         "dur": 10.0, "args": {}},
    ])


def test_trace_busy_idle_and_links():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.clock_offset_us is None and tr.kernels_without_launch == 4
    assert tr.launches_without_kernel == 0 and tr.complete
    # every kernel of the trace whole: [1010, 1040], [1095, 1105] and
    # [1200, 1210], 50 us busy
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.idle_share == pytest.approx(0.5)
    assert tr.kernel_s(lambda k, op: "ppr_gather" in k["name"]) == \
        pytest.approx(10e-6)
    ops = dict(tr.device_ops())
    assert ops["aten::mm: nvjet_gemm"] == pytest.approx(20e-6)
    assert ops["aten::mul: elementwise"] == pytest.approx(15e-6)
    assert ops["ppr_gather_kernel"] == pytest.approx(10e-6)
    assert ops["late"] == pytest.approx(10e-6)
    gaps = dict(tr.idle_gaps())
    # [1000, 1010): aten::mm on the host; [1040, 1095): aten::item 30 us of
    # 55 -> its label; nothing idle after the window's end
    assert gaps["aten::mm"] == pytest.approx(10e-6)
    assert gaps["aten::item"] == pytest.approx(55e-6)
    assert NO_OP not in gaps


def test_the_readers_on_the_synthetic_trace():
    rec = traffic.Record(queries_traced=2)
    ctx = types.SimpleNamespace(trace=_trace(), record=rec)
    k3 = load_metric("kernel.k3_us_per_query.batch").read(ctx)
    assert k3 == pytest.approx(5.0)
    loop = load_metric("loop.state_pass_us_per_query.batch").read(ctx)
    assert loop == pytest.approx(7.5)
    roof = load_metric("kernel.hub_mm_roofline.batch").read(ctx)
    flop = 2.0 * 2944 * 80640 * 2048
    assert roof == pytest.approx(100 * flop / 989e12 / 20e-6)
    idle = load_metric("device.idle_share.batch").read(ctx)
    assert idle == pytest.approx(50.0)
    empty = types.SimpleNamespace(trace=None, record=rec)
    assert load_metric("device.idle_share.serve").read(empty) is None
    assert load_metric("kernel.hub_mm_roofline.batch").read(empty) is None


def test_the_serving_readers_take_window_deltas():
    rec = traffic.Record(counters={"dispatches": 4, "dispatched_rows": 1000,
                                   "padded_rows": 24})
    ctx = types.SimpleNamespace(trace=None, record=rec)
    assert load_metric("serving.mean_batch.serve").read(ctx) == 250.0
    assert load_metric("serving.pad_share.serve").read(ctx) == \
        pytest.approx(100 * 24 / 1024)
    none = types.SimpleNamespace(trace=None, record=traffic.Record())
    assert load_metric("serving.mean_batch.serve").read(none) is None


def test_percentiles_count_failures_as_infinite():
    rec = traffic.Record(latency_ms=[float(i) for i in range(1, 100)],
                         failed=1)
    assert run.end_to_end_value("served_p50_ms", rec, 0.0) == 50.0
    assert run.end_to_end_value("served_p99_ms", rec, 0.0) == 99.0
    assert run.end_to_end_value("served_p100_ms", rec, 0.0) == float("inf")


@pytest.mark.parametrize("workload", ["tiny.batch", "tiny.serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_each_mix_rehearsed_on_the_cpu(tiny_manifest, workload, trace):
    out = run.run_cell(tiny_manifest, workload, 2**33 + 5, 1.0, bool(trace),
                       torch.device("cpu"))
    json.dumps(out, allow_nan=False)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in (tiny_manifest.per_layer(workload) if trace
                                else tiny_manifest.end_to_end(workload))}
    assert set(out["metrics"]) <= want
    if not trace:
        assert set(out["metrics"]) == want
    else:
        assert out["device"]["window_s"] > 0
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
