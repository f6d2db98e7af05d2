"""The readers of the program's spans and counters (``benchmark/spans.py``
and the metrics that use it) on a synthetic trace with recorder spans at a
known base: the base and the lags recovered, the idle time split by span,
and nothing read from a program without a recorder."""

import types

import pytest

from benchmark import spans
from benchmark.manifest import load_metric
from benchmark.tracing import WINDOW, Trace

#: the chrome trace's ``baseTimeNanoseconds``: a whole number of seconds
BASE = 1_790_857_026 * 10**9


def _trace(skew_us=0.0, t0=1000.0, dur=1000.0):
    """A window of ``dur`` us from ``t0``; busy [1070, 1100] (the call's
    first kernels), [1300, 1500] (K3) and [1700, 1800] (a recompute),
    each ``skew_us`` later on the clock than the host's events."""
    return Trace([
        {"ph": "X", "cat": "user_annotation", "name": WINDOW, "ts": t0,
         "dur": dur}] + [
        {"ph": "X", "cat": "kernel", "name": n, "ts": a + skew_us,
         "dur": d, "args": {}}
        for n, a, d in (("elementwise", 1070.0, 30.0),
                        ("ppr_gather_kernel", 1300.0, 200.0),
                        ("nvjet", 1700.0, 100.0))])


def _span(name, a_us, b_us):
    return types.SimpleNamespace(name=name, start_ns=BASE + int(a_us * 1e3),
                                 end_ns=BASE + int(b_us * 1e3))


def _spans():
    """One dispatch: its hit lists, a recompute with its own loop, a gap
    of 20 us in no span; the host returns from blocking reads (the
    check, the loops' ends) 10, 20 and 15 us after busy ends."""
    rows = [("serving.take", 1000, 1050), ("serving.dispatch", 1050, 1900),
            ("service.top_k", 1060, 1850), ("loop.topk", 1060, 1520),
            ("loop.check", 1102, 1110), ("service.hits", 1520, 1600),
            ("service.recompute", 1600, 1820), ("loop.topk", 1600, 1815),
            ("serving.resolve", 1850, 1900), ("serving.take", 1920, 2100)]
    return [_span(n, a, b) for n, a, b in rows]


class _Rec:
    def __init__(self, recorded, counters):
        self._spans, self._counters = recorded, counters

    def spans(self):
        return list(self._spans)

    def counters(self):
        return dict(self._counters)


@pytest.fixture
def program(monkeypatch):
    rec = _Rec(_spans(), {"serving.queue_wait": (30.0, 10),
                          "loop.sweeps": (48, 2),
                          "loop.edge_cols": (1e9, 2)})
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    return rec


def test_the_base_and_the_lags_are_recovered():
    tr, rec = _trace(), _spans()
    assert spans.base_ns(tr, rec) == BASE
    lag = spans.lags(tr, rec, BASE)
    assert lag["n"] == 3 and lag["median"] == pytest.approx(15.0)
    assert lag["min"] == pytest.approx(10.0)
    assert lag["max"] == pytest.approx(20.0)
    # a first span 0.2 s into the window, or a few ms before it, rounds
    # to the same base
    for first in (201_000, -3000):
        assert spans.base_ns(_trace(t0=0.0, dur=300_000.0),
                             [_span("serving.take", first, 250_000)]) \
            == BASE


def test_the_idle_time_is_split_by_span():
    split = spans._idle_split(_trace(), _spans())
    # 1000 us, busy 330
    assert split["idle"] == pytest.approx(670e-6)
    # service: [1520, 1600] (hit lists), [1815, 1850] (after the recompute)
    assert split["service"] == pytest.approx(115e-6)
    # serving: [1000, 1060] (take, the dispatch's start), [1850, 1900]
    # (resolve), [1920, 2000] (take)
    assert split["serving"] == pytest.approx(190e-6)
    assert split["uncovered"] == pytest.approx(365e-6)
    # of it, the host in no span: [1900, 1920]; and idle inside the loops:
    # 460 + 215 us of loop.topk less the 330 us busy
    assert split["nospan"] == pytest.approx(20e-6)
    assert split["loop"] == pytest.approx(345e-6)
    assert split["base_ns"] == BASE


@pytest.mark.parametrize("skew_us", [3000.0, -2000.0])
def test_a_drift_of_the_cards_clock_moves_the_lags_not_the_split(skew_us):
    wide = dict(t0=-5000.0, dur=20_000.0)
    still = spans._idle_split(_trace(**wide), _spans())
    moved = spans._idle_split(_trace(skew_us, **wide), _spans())
    for k in ("serving", "service", "idle", "uncovered", "nospan", "loop"):
        assert moved[k] == pytest.approx(still[k])
    assert still["lags"]["max"] == pytest.approx(20.0)
    # late, no busy end precedes a return; early, each is milliseconds on
    assert moved["lags"] is None or moved["lags"]["median"] > 500.0


def test_no_kernel_reads_nothing():
    tr = Trace([{"ph": "X", "cat": "user_annotation", "name": WINDOW,
                 "ts": 1000.0, "dur": 1000.0}])
    assert spans._idle_split(tr, _spans()) is None


def test_the_idle_shares_and_the_rest_make_the_trace_idle_share(program):
    ctx = types.SimpleNamespace(trace=_trace(), record=None)
    serving = load_metric("serving.idle_share.serve").read(ctx)
    service = load_metric("service.idle_share.serve").read(ctx)
    assert serving == pytest.approx(19.0)
    assert service == pytest.approx(11.5)
    assert load_metric("service.idle_share.batch").read(ctx) == \
        pytest.approx(11.5)
    split = ctx._idle_split
    uncovered = 100.0 * split["uncovered"] / split["window"]
    assert serving + service + uncovered == \
        pytest.approx(100.0 * ctx.trace.idle_share)
    assert load_metric("device.idle_share.serve").read(ctx) == \
        pytest.approx(67.0)


def test_the_counter_readers(program):
    ctx = types.SimpleNamespace(trace=_trace(), record=None)
    assert load_metric("serving.queue_wait_ms.serve").read(ctx) == 3.0
    assert load_metric("loop.sweeps_per_call.batch").read(ctx) == 24.0
    assert load_metric("kernel.k3_ps_per_edge_col.batch").read(ctx) == \
        pytest.approx(200e-6 / 1e9 * 1e12)


NEW = ("serving.queue_wait_ms.serve", "serving.idle_share.serve",
       "service.idle_share.serve", "service.idle_share.batch",
       "loop.sweeps_per_call.batch", "kernel.k3_ps_per_edge_col.batch")


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_a_recorder_reads_nothing(name, monkeypatch):
    from ppr_tpu_torch.utils import timer

    monkeypatch.delattr(timer, "RECORDER")
    ctx = types.SimpleNamespace(trace=_trace(), record=None)
    assert spans.recorder() is None
    assert load_metric(name).read(ctx) is None
    assert load_metric(name).read(
        types.SimpleNamespace(trace=None, record=None)) is None


@pytest.mark.parametrize("name", NEW)
def test_an_empty_recorder_reads_nothing(name, monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: _Rec([], {}))
    ctx = types.SimpleNamespace(trace=_trace(), record=None)
    assert load_metric(name).read(ctx) is None
