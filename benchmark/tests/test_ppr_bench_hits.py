"""The reader of ``service.hits_ns_per_hit.batch``: the host time of the
program's ``service.hits`` spans over its counter ``service.hits_built``,
and nothing read where the program records no such counter (an older
commit) or no recorder at all."""

import types

import pytest

from benchmark import spans
from benchmark.manifest import load_metric

NAME = "service.hits_ns_per_hit.batch"


class _Rec:
    def __init__(self, recorded, counters):
        self._spans, self._counters = recorded, counters

    def spans(self):
        return list(self._spans)

    def counters(self):
        return dict(self._counters)


def _span(name, start_ns, end_ns):
    return types.SimpleNamespace(name=name, start_ns=start_ns, end_ns=end_ns)


#: three batches' hit lists (12, 14 and 10 ms) inside their calls
SPANS = [_span("service.top_k", 0, 1_050_000_000),
         _span("loop.topk", 0, 1_030_000_000),
         _span("service.hits", 1_030_000_000, 1_042_000_000),
         _span("service.hits", 2_000_000_000, 2_014_000_000),
         _span("service.hits", 3_000_000_000, 3_010_000_000)]


def _ctx():
    return types.SimpleNamespace(trace=None, record=None)


def test_the_spans_over_the_hits_built(monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: _Rec(
        SPANS, {"service.hits_built": (60_000, 3),
                "service.tie_rows": (12, 3)}))
    # 36 ms over 60,000 hits
    assert load_metric(NAME).read(_ctx()) == pytest.approx(600.0)


@pytest.mark.parametrize("counters", [
    {}, {"loop.sweeps": (72, 1)}, {"service.hits_built": (0, 3)}],
    ids=["none", "no-hit-counter", "no-hits"])
def test_a_missing_or_empty_counter_reads_nothing(monkeypatch, counters):
    monkeypatch.setattr(spans, "recorder", lambda: _Rec(SPANS, counters))
    assert load_metric(NAME).read(_ctx()) is None


def test_no_span_or_no_recorder_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "recorder", lambda: _Rec(
        SPANS[:2], {"service.hits_built": (100, 1)}))
    assert load_metric(NAME).read(_ctx()) is None
    monkeypatch.setattr(spans, "recorder", lambda: None)
    assert load_metric(NAME).read(_ctx()) is None
