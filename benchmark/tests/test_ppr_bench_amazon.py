"""The amazon0302 deployment (``configs/amazon.json``, cell
``amazon.batch``: the configuration's keys drawn at the published size)
and the readers of ``kernel.sweep_pass_roofline.batch`` and
``loop.dangling_us_per_query.batch`` on planted traces."""

import json
import types

import numpy as np
import pytest

from benchmark import graphgen, peaks, spans, traffic
from benchmark.manifest import HERE, load_metric
from benchmark.tracing import WINDOW, Trace

CFG = json.loads((HERE / "configs" / "amazon.json").read_text())


def test_the_configuration_states_its_source():
    pub = CFG["published"]
    assert CFG["name"] == "amazon" and CFG["reduced"] == []
    assert "amazon0302" in CFG["source"] and "TWEB 2007" in CFG["source"]
    assert (CFG["nodes"], CFG["edges"]) == (pub["nodes"],
                                            pub["directed_links"])
    assert CFG["generator"]["out_cap"] == pub["out_cap"] == 5
    assert CFG["engine"] == json.loads(
        (HERE / "configs" / "flickr.json").read_text())["engine"]
    # the dangling products at most what the cap allows
    assert 0 <= CFG["generator"]["dangling"] \
        <= CFG["nodes"] - -(-CFG["edges"] // 5)
    assumed = " ".join(CFG["assumed"])
    for key in ("edge list", "dangling", "in-degree", "spread",
                "local_share"):
        assert key in assumed, key


@pytest.mark.parametrize("seed", [2718281801, 2**32 + 12345])
def test_the_draw_meets_the_published_counts_and_clustering(seed):
    src, dst = graphgen.draw(CFG, seed)
    n, pub = CFG["nodes"], CFG["published"]
    assert src.size == dst.size == pub["directed_links"]
    assert max(src.max(), dst.max()) < n and (src != dst).all()
    assert np.unique(src * n + dst).size == src.size
    deg = graphgen.degree_summary(src, n, dst)
    assert deg["max"] == pub["out_cap"]
    assert deg["mean"] == pytest.approx(pub["mean_out_degree"], abs=5e-4)
    assert deg["dangling"] == CFG["generator"]["dangling"]
    # under the auto hub rule's threshold (748 in-links at n_pad 262,144)
    assert 100 < deg["in_max"] < 748
    cc = graphgen.average_clustering(src, dst, n)
    assert cc == pytest.approx(pub["average_clustering"], abs=0.01)


def _kernel(name, ts, dur, eid):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"External id": eid}}


def _sweep_trace():
    """A window of 1,000 us: K5's three kernels (130 us), and an unrelated
    reduction and K3's gather, which the reader must not count."""
    return Trace([
        {"ph": "X", "cat": "user_annotation", "name": WINDOW,
         "ts": 1000.0, "dur": 1000.0},
        _kernel("void at::reduce_kernel<512, 1>()", 1107.0, 5.0, 4),
        _kernel("void (anonymous namespace)::ppr_sweep_pre_kernel<4, true, "
                "true>(float*)", 1200.0, 100.0, 8),
        _kernel("void (anonymous namespace)::ppr_sweep_post_kernel<4>()",
                1320.0, 25.0, 9),
        _kernel("void (anonymous namespace)::ppr_sweep_finalize_kernel()",
                1350.0, 5.0, 10),
        _kernel("void ppr_gather_kernel<4>()", 1400.0, 80.0, 11),
    ])


def _ctx(tr, queries=4):
    return types.SimpleNamespace(
        trace=tr, record=traffic.Record(queries_traced=queries))


class _Rec:
    def __init__(self, counters, recorded=()):
        self._counters, self._spans = counters, list(recorded)

    def spans(self):
        return list(self._spans)

    def counters(self):
        return dict(self._counters)


@pytest.mark.parametrize("bf16, bytes_per_elem", [(True, 22), (False, 20)])
def test_the_roofline_reader(monkeypatch, bf16, bytes_per_elem):
    """A 1.5e7-element count moves 22 bytes an element with the bf16 copy
    (4.5 passes and 1), 20 without, over the 130 us of ``ppr_sweep*``."""
    elems = 1.5e7
    rec = _Rec({"loop.state_elems": (elems, 3),
                "loop.bf16_copy_elems": (elems if bf16 else 0, 3)})
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    got = load_metric("kernel.sweep_pass_roofline.batch").read(
        _ctx(_sweep_trace()))
    want = 100.0 * elems * bytes_per_elem / peaks.PEAK_BYTES / 130e-6
    assert got == pytest.approx(want)
    assert 0 < got <= 100


@pytest.mark.parametrize("counters", [
    {},
    {"loop.state_elems": (2e7, 3)},          # a program before the copy's
    {"loop.bf16_copy_elems": (2e7, 3)},
    {"loop.state_elems": (0, 1), "loop.bf16_copy_elems": (0, 1)},
])
def test_the_roofline_reader_reads_nothing_without_its_counters(
        monkeypatch, counters):
    monkeypatch.setattr(spans, "recorder", lambda: _Rec(counters))
    reader = load_metric("kernel.sweep_pass_roofline.batch")
    assert reader.read(_ctx(_sweep_trace())) is None


def test_the_roofline_reader_reads_nothing_without_a_recorder(monkeypatch):
    from ppr_tpu_torch.utils import timer

    monkeypatch.delattr(timer, "RECORDER")
    reader = load_metric("kernel.sweep_pass_roofline.batch")
    assert reader.read(_ctx(_sweep_trace())) is None
    assert reader.read(_ctx(None)) is None


#: the planted trace's ``baseTimeNanoseconds``: a whole second
BASE = 1_790_000_000 * 10**9


def _span(name, ts, dur):
    """A program span at ``ts`` us on the trace's clock."""
    return types.SimpleNamespace(name=name, start_ns=BASE + int(ts * 1e3),
                                 end_ns=BASE + int((ts + dur) * 1e3))


def _dangling_trace():
    """A window of 1,000 us: two sweeps' dangling mass (index_select 4 us,
    mul 2, sum 3, each called inside a ``loop.dangling_mass`` span), and
    an index_select, a sum and K3's gather outside, which the reader must
    not count."""
    events = [{"ph": "X", "cat": "user_annotation", "name": WINDOW,
               "ts": 1000.0, "dur": 1000.0}]
    calls = [("aten::index_select", 1100.0, 10.0),
             ("aten::index_select", 1202.0, 4.0), ("aten::mul", 1205.0, 2.0),
             ("aten::sum", 1208.0, 3.0),
             ("aten::sum", 1300.0, 6.0), ("ppr_gather", 1400.0, 50.0),
             ("aten::index_select", 1602.0, 4.0), ("aten::mul", 1605.0, 2.0),
             ("aten::sum", 1608.0, 3.0)]
    for eid, (op, ts, dur) in enumerate(calls):
        events.append({"ph": "X", "cat": "cpu_op", "name": op, "ts": ts,
                       "dur": 1.0, "tid": 1, "args": {"External id": eid}})
        events.append(_kernel(f"void {op}_kernel()", ts + 30.0, dur, eid))
    return Trace(events), [_span("loop.topk", 1050.0, 800.0),
                           _span("loop.dangling_mass", 1201.0, 9.0),
                           _span("loop.dangling_mass", 1601.0, 9.0)]


def test_the_dangling_reader(monkeypatch):
    tr, recorded = _dangling_trace()
    rec = _Rec({"loop.dangling_cols": (3e9, 2)}, recorded)
    monkeypatch.setattr(spans, "recorder", lambda: rec)
    got = load_metric("loop.dangling_us_per_query.batch").read(_ctx(tr))
    assert got == pytest.approx(2 * (4 + 2 + 3) / 4)


@pytest.mark.parametrize("counters, names", [
    ({}, ("loop.dangling_mass",)),                     # a program before it
    ({"loop.dangling_cols": (0, 2)}, ()),              # no dangling node
    ({"loop.dangling_cols": (3e9, 2)}, ()),            # no span recorded
])
def test_the_dangling_reader_reads_nothing_without_its_span_or_counter(
        monkeypatch, counters, names):
    tr, recorded = _dangling_trace()
    recorded = [s for s in recorded if s.name == "loop.topk"
                or s.name in names]
    monkeypatch.setattr(spans, "recorder", lambda: _Rec(counters, recorded))
    reader = load_metric("loop.dangling_us_per_query.batch")
    assert reader.read(_ctx(tr)) is None
    assert reader.read(_ctx(None)) is None


def test_the_dangling_reader_reads_nothing_without_a_recorder(monkeypatch):
    from ppr_tpu_torch.utils import timer

    monkeypatch.delattr(timer, "RECORDER")
    reader = load_metric("loop.dangling_us_per_query.batch")
    assert reader.read(_ctx(_dangling_trace()[0])) is None
