"""The trace reader on synthetic traces with the host's launch calls
(``benchmark/tracing.py``): every kernel counted whole and placed by its
launch, whatever the card's clock; records the profiler lost; and the
traced slice tried anew (``benchmark/run.py`` ``Tracer``,
``benchmark/traffic.py``)."""

import concurrent.futures
import json
import types

import numpy as np
import pytest
import torch

from benchmark import run, spans, traffic
from benchmark.manifest import load_metric
from benchmark.tracing import WINDOW, Trace

#: the least gap from a launch call's start to its kernel's in the trace
LATENCY_US = 5.0


def _events(skew_us=0.0):
    """A window of 1,000 us: the hub product, K3's gather and K5's pre
    pass, each launched by its operator (by the runtime, the driver and
    the runtime's ``Ex`` call) and run ``skew_us`` later on the card's
    clock than on the host's; the host waits in ``aten::item`` after
    them."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": 1000.0, "dur": 1000.0},
              {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 1640.0,
               "dur": 350.0, "tid": 1, "args": {"External id": 9}}]
    # operator, its args, launch call, launch at, kernel, latency, duration
    calls = [
        ("aten::mm", {"Input Dims": [[2944, 8064], [8064, 2048], []],
                      "Input type": ["c10::BFloat16", "c10::BFloat16",
                                     "ScalarType"]},
         ("cuda_runtime", "cudaLaunchKernel"), 1003.0, "nvjet_gemm", 7.0,
         200.0),
        ("ppr_gather", {}, ("cuda_driver", "cuLaunchKernel"), 1220.0,
         "void ppr_gather_kernel<4>(float const*)", LATENCY_US, 300.0),
        ("ppr_sweep", {}, ("cuda_runtime", "cudaLaunchKernelExC"), 1530.0,
         "void (anonymous namespace)::ppr_sweep_pre_kernel<4, true, "
         "true>(float*)", 6.0, 100.0),
    ]
    for eid, (op, args, (cat, call), at, kernel, lat, dur) in enumerate(
            calls, start=1):
        events += [
            {"ph": "X", "cat": "cpu_op", "name": op, "ts": at - 2.0,
             "dur": 4.0, "tid": 1, "args": {"External id": eid, **args}},
            {"ph": "X", "cat": cat, "name": call, "ts": at, "dur": 1.5,
             "tid": 1, "args": {"External id": eid, "correlation": 100 + eid}},
            {"ph": "X", "cat": "kernel", "name": kernel,
             "ts": at + lat + skew_us, "dur": dur,
             "args": {"External id": eid, "correlation": 100 + eid}}]
    return events


class _Rec:
    """A program recorder: counters, spans, and how often it was
    emptied."""

    def __init__(self, counters=None):
        self._counters = dict(counters or {})
        self._spans: list = []
        self.cleared = 0

    def spans(self):
        return list(self._spans)

    def counters(self):
        return dict(self._counters)

    def clear(self):
        self._spans.clear()
        self._counters.clear()
        self.cleared += 1


@pytest.fixture
def program(monkeypatch):
    rec = _Rec({"loop.edge_cols": (1e9, 3), "loop.state_elems": (4e6, 3),
                "loop.bf16_copy_elems": (0.0, 3)})
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    return rec


READERS = ("kernel.k3_us_per_query.batch", "kernel.k3_ps_per_edge_col.batch",
           "kernel.hub_mm_roofline.batch", "kernel.sweep_pass_roofline.batch",
           "loop.sweep_pass_us_per_query.batch", "device.idle_share.batch")


def _readings(tr):
    ctx = types.SimpleNamespace(trace=tr,
                                record=traffic.Record(queries_traced=4))
    return {"kernel_s": tr.kernel_s(lambda k, op: True),
            "busy_s": tr.busy_s, "idle_share": tr.idle_share,
            **{name: load_metric(name).read(ctx) for name in READERS}}


@pytest.mark.parametrize("skew_us", [0.0, -5343.0, 1_250_000.0])
def test_a_card_clock_off_the_hosts_reads_the_same(program, skew_us):
    aligned, moved = Trace(_events()), Trace(_events(skew_us))
    assert moved.clock_offset_us == pytest.approx(skew_us + LATENCY_US)
    assert moved.launches_without_kernel == 0
    assert moved.kernels_without_launch == 0
    want = _readings(aligned)
    assert want["kernel_s"] == pytest.approx(600e-6)
    assert want["idle_share"] == pytest.approx(0.4)
    # no reader gives more than the kernels' whole durations do
    flop = 2.0 * 2944 * 8064 * 2048
    assert want["kernel.hub_mm_roofline.batch"] == \
        pytest.approx(100 * flop / 989e12 / 200e-6)
    assert want["kernel.k3_us_per_query.batch"] == pytest.approx(75.0)
    for name, value in _readings(moved).items():
        assert value == pytest.approx(want[name], rel=1e-9, abs=1e-12), name


@pytest.mark.parametrize("skew_us", [0.0, -5343.0, 1_250_000.0])
def test_the_idle_gaps_name_the_same_host_operators(skew_us):
    gaps = Trace(_events(skew_us)).idle_gaps()
    assert [name for name, _ in gaps] == \
        [name for name, _ in Trace(_events()).idle_gaps()]
    got = dict(gaps)
    # the host waits in aten::item from 1640; the pre pass ends at 1631
    assert got["aten::item"] == pytest.approx(369e-6)
    assert sum(got.values()) == pytest.approx(400e-6)


def test_a_launch_without_its_kernel_is_counted():
    events = _events(1_250_000.0)
    lost = next(e for e in events if e.get("name") == "cuLaunchKernel")
    events = [e for e in events if e.get("cat") != "kernel"
              or e["args"]["correlation"] != lost["args"]["correlation"]]
    # and a kernel with no launch call, and a launch call outside the window
    events += [{"ph": "X", "cat": "kernel", "name": "orphan",
                "ts": 1_251_700.0, "dur": 10.0, "args": {}},
               {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": 2500.0, "dur": 1.0, "args": {"correlation": 999}}]
    tr = Trace(events)
    assert tr.launches_without_kernel == 1 and not tr.complete
    assert tr.kernels_without_launch == 1
    assert tr.clock_offset_us == pytest.approx(1_250_006.0)


def test_without_launch_calls_no_kernel_moves():
    events = [e for e in _events(3000.0) if e.get("cat") not in
              ("cuda_runtime", "cuda_driver")]
    tr = Trace(events)
    assert tr.clock_offset_us is None and tr.kernels_without_launch == 3
    assert tr.complete
    assert min(k["ts"] for k in tr.kernels) == pytest.approx(4010.0)


class _FakeProfile:
    def start(self):
        pass

    def stop(self):
        pass


class _FakeTracer(run.Tracer):
    """The harness's tracer on the CPU with no profiler: its slices read
    the traces it is given, in turn."""

    def __init__(self, traces, **kw):
        super().__init__(torch.device("cpu"), **kw)
        self._traces = list(traces)

    def _profile(self):
        return _FakeProfile()

    def _read(self):
        return self._traces.pop(0)


def _lost():
    events = _events()
    return Trace([e for e in events if e.get("name") != "nvjet_gemm"])


class _Svc:
    """A service that notes which calls the tracer saw, and counts one
    query a source into the recorder while it is on."""

    def __init__(self, rec):
        self.rec, self.calls, self.tracer = rec, 0, None

    def top_k(self, batch):
        if self.tracer.on:
            self.rec._counters.setdefault("queries", []).append(self.calls)
        self.calls += 1
        return [[] for _ in batch]


def test_a_slice_that_lost_records_is_traced_anew(program):
    svc = _Svc(program)
    kept = Trace(_events())
    svc.tracer = tracer = _FakeTracer([_lost(), kept])
    rec = traffic.run_batch(svc, {"batch": 8}, 100,
                            np.random.default_rng(1), 0.0, tracer)
    assert tracer.done and tracer.slices == 2 and tracer.read() is kept
    # the recorder emptied before each slice: it holds batches 4-6 alone
    assert program.cleared == 2
    assert program.counters()["queries"] == [4, 5, 6]
    assert rec.queries_traced == 24 and rec.notes["batches"] == 7


def test_the_last_slice_is_kept_though_it_lost_records(program):
    svc = _Svc(program)
    svc.tracer = tracer = _FakeTracer([_lost() for _ in range(3)])
    traffic.run_batch(svc, {"batch": 8}, 100, np.random.default_rng(1), 0.0,
                      tracer)
    assert tracer.done and tracer.slices == 3
    assert program.counters()["queries"] == [7, 8, 9]
    assert not tracer.read().complete


class _Server:
    """A server that answers each request at once."""

    def __init__(self):
        self.sent = 0

    def submit(self, source):
        self.sent += 1
        fut = concurrent.futures.Future()
        fut.set_result([])
        return fut


def test_an_open_slice_that_lost_records_is_traced_anew(program):
    server = _Server()
    tracer = _FakeTracer([_lost(), Trace(_events())], seconds=0.2)
    sent = traffic.trace_open(server, {"rate_qps": 100}, 50,
                              np.random.default_rng(2), tracer)
    assert tracer.done and tracer.slices == 2 and program.cleared == 2
    assert 0 < sent < server.sent


@pytest.mark.parametrize("lost", [False, True])
def test_the_result_line_says_what_the_trace_did(tiny_manifest, monkeypatch,
                                                 lost):
    if lost:
        monkeypatch.setattr(run.Tracer, "_read", lambda self: _lost())
    out = run.run_cell(tiny_manifest, "tiny.batch", 2**35 + 9, 0.5, True,
                       torch.device("cpu"))
    json.dumps(out, allow_nan=False)
    assert out["correct"], out["checks"]
    dev = out["device"]
    assert dev["trace_slices"] == (3 if lost else 1)
    assert dev["launches_without_kernel"] == (1 if lost else 0)
    assert dev["kernels_without_launch"] == 0
    if lost:
        # nothing is read from a trace whose kernel time is short
        assert dev["clock_offset_us"] == pytest.approx(LATENCY_US)
        assert not {"kernel.k3_us_per_query.batch", "device.idle_share.batch",
                    "service.idle_share.batch"} & set(out["metrics"])
    else:
        # the CPU's trace has no kernels: nothing to tie, nothing moved
        assert dev["clock_offset_us"] is None
