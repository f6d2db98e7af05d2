"""The reader of ``loop.sweep_pass_us_per_query.batch`` on synthetic
traces: the plain operators' kernels of a program without the fused
passes, the fused kernels and the operators left of one with them, and
nothing from an empty trace. And the check on the fused passes: a run
whose sweeps keep their old residue is not correct."""

import types

import pytest
import torch

from benchmark import traffic
from benchmark.manifest import load_metric
from benchmark.tracing import WINDOW, Trace


def _trace(kernels):
    """A window of 1,000 us; each kernel ``(name, op or None, dur)``,
    one after another, its operator on the host just before it."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": 1000.0, "dur": 1000.0}]
    t = 1001.0
    for i, (name, op, dur) in enumerate(kernels):
        args = {}
        if op is not None:
            events.append({"ph": "X", "cat": "cpu_op", "name": op, "ts": t,
                           "dur": 1.0, "tid": 1, "args": {"External id": i}})
            args = {"External id": i}
        events.append({"ph": "X", "cat": "kernel", "name": name,
                       "ts": t + 1.0, "dur": dur, "args": args})
        t += dur + 2.0
    return Trace(events)


def _read(tr, queries=4):
    ctx = types.SimpleNamespace(trace=tr,
                                record=traffic.Record(queries_traced=queries))
    return (load_metric("loop.sweep_pass_us_per_query.batch").read(ctx),
            load_metric("loop.state_pass_us_per_query.batch").read(ctx))


def test_the_plain_operators_read_as_the_older_metric():
    tr = _trace([("void at::vectorized_elementwise_kernel<4>()",
                  "aten::addcmul", 40.0),
                 ("void at::reduce_kernel<512, 1>()", "aten::sum", 20.0),
                 ("void ppr_gather_kernel<4>()", None, 100.0),
                 ("nvjet_gemm", "aten::mm", 30.0),
                 ("void at::index_elementwise_kernel()", "aten::index_add_",
                  8.0)])
    new, old = _read(tr)
    assert new == pytest.approx(15.0) and old == pytest.approx(15.0)


def test_the_fused_kernels_count_and_the_rest_do_not():
    tr = _trace([("void (anonymous namespace)::ppr_sweep_pre_kernel<4, "
                  "true, true>(float*)", None, 60.0),
                 ("void ppr_gather_kernel<4>()", None, 100.0),
                 ("void (anonymous namespace)::ppr_sweep_post_kernel<4>()",
                  None, 12.0),
                 ("void (anonymous namespace)::ppr_sweep_finalize_kernel()",
                  None, 4.0),
                 ("void at::reduce_kernel<512, 1>()", "aten::sum", 4.0),
                 ("nvjet_gemm", "aten::mm", 30.0)])
    new, old = _read(tr)
    assert new == pytest.approx((60 + 12 + 4 + 4) / 4)
    assert old == pytest.approx(1.0)


def test_nothing_to_read():
    assert _read(_trace([("nvjet_gemm", "aten::mm", 30.0)]))[0] is None
    assert _read(_trace([("void ppr_sweep_post_kernel<4>()", None, 5.0)]),
                 queries=0)[0] is None
    ctx = types.SimpleNamespace(trace=None,
                                record=traffic.Record(queries_traced=4))
    assert load_metric("loop.sweep_pass_us_per_query.batch").read(ctx) \
        is None


def test_a_fused_sweep_that_keeps_its_state_is_not_correct(tiny_manifest,
                                                           monkeypatch):
    """The annealed loop's post pass made to hand back the old residue, so
    that no sweep moves any mass: the timed path of the tiny batch cell,
    on the CPU, is not correct."""
    from benchmark import run
    from ppr_tpu_torch.ops import sweep_pass

    monkeypatch.setattr(sweep_pass, "sweep_post",
                        lambda pushed, r, src, dang, state: (r, r.sum(dim=0)))
    out = run.run_cell(tiny_manifest, "tiny.batch", 77, 0.5, False,
                       torch.device("cpu"))
    assert not out["correct"], out["checks"]
