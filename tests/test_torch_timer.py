"""The port's span and counter recorder (``ppr_tpu_torch/utils/timer.py``):
it records only under ``torch.profiler``, on threads the profiler does not
record too, nests spans and shares a dispatch's id, never waits for the
card, and lands in the chrome trace that ``timer.trace`` writes; and the
spans the serving, service and loop layers record on a tiny graph."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppr_tpu_torch.graph.csr import build_graph
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import fora as tfora
from ppr_tpu_torch.serving import PPRBatchServer
from ppr_tpu_torch.service import PPRService
from ppr_tpu_torch.utils import timer

WAIT = 120   # seconds any thread or future may take before the test fails


@pytest.fixture(autouse=True)
def clean_recorder():
    timer.RECORDER.clear()
    yield
    timer.RECORDER.clear()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def tiny():
    """A 400-node undirected graph, six random links a node."""
    rng = np.random.default_rng(11)
    n = 400
    src = np.repeat(np.arange(n), 6)
    dst = rng.integers(0, n, src.size)
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], 1), axis=0)
    s = np.concatenate([pairs[:, 0], pairs[:, 1]])
    d = np.concatenate([pairs[:, 1], pairs[:, 0]])
    g = build_graph(s, d, n=n, device="cpu")
    return Dataset(graph=g, names=[str(i) for i in range(n)], name="tiny")


def test_nothing_is_recorded_without_a_profiler():
    assert not timer.recording()
    sp = timer.span("a", rows=1)
    assert sp is timer.NO_SPAN
    with sp as inner:
        inner.set(x=1)
        timer.count("c", 3.0)
    assert timer.RECORDER.spans() == []
    assert timer.RECORDER.counters() == {}


def test_a_thread_started_before_the_profiler_is_recorded():
    go, done = threading.Event(), threading.Event()

    def worker():
        go.wait(WAIT)
        with timer.span("worker.outer"):
            with timer.span("worker.inner", rows=2):
                timer.count("worker.n", 5.0)
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with _profiled() as prof:
        with timer.span("main"):
            go.set()
            assert done.wait(WAIT)
    t.join(WAIT)
    assert not t.is_alive()
    by = {s.name: s for s in timer.RECORDER.spans()}
    assert set(by) == {"worker.outer", "worker.inner", "main"}
    assert by["worker.inner"].thread == by["worker.outer"].thread \
        == t.native_id
    assert by["worker.inner"].attrs == {"rows": 2}
    # the profiler records the main thread's span, not the worker's
    seen = {e.name for e in prof.events()}
    assert "main" in seen and "worker.outer" not in seen
    assert timer.RECORDER.counters() == {"worker.n": (5.0, 1)}
    for s in by.values():
        assert 0 < s.start_ns <= s.end_ns


def test_parents_and_roots_nest():
    with _profiled():
        with timer.span("dispatch") as d:
            with timer.span("call") as c:
                with timer.span("leaf") as leaf:
                    pass
            with timer.span("resolve") as r:
                pass
        other = []
        t = threading.Thread(target=lambda: other.append(
            timer.span("remote", parent=c).__enter__()))
        t.start()
        t.join(WAIT)
        other[0].__exit__(None, None, None)
        with timer.span("next") as nxt:
            pass
    assert d.parent is None and d.root == d.id
    assert c.parent == d.id and r.parent == d.id and leaf.parent == c.id
    assert other[0].parent == c.id
    assert {s.root for s in (d, c, leaf, r, other[0])} == {d.id}
    assert nxt.parent is None and nxt.root == nxt.id != d.id
    assert timer.RECORDER.current() is None


def test_the_buffer_is_bounded_and_counters_sum():
    rec = timer.Recorder(capacity=4)
    with _profiled():
        for i in range(10):
            with rec.span("s", i=i):
                pass
        rec.count("c", 2.0, 3)
        rec.count("c", 1.0)
    kept = rec.spans()
    assert [s.attrs["i"] for s in kept] == [6, 7, 8, 9]
    assert rec.counters() == {"c": (3.0, 4)}
    assert timer.RECORDER.spans() == []


def test_no_span_or_counter_waits_for_the_card(tiny, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span synchronised the card")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    svc = PPRService(tiny, alpha=0.15, k=5)
    server = PPRBatchServer(svc, max_batch=16)
    try:
        with _profiled():
            with timer.span("a"):
                timer.count("b", 1.0)
            svc.top_k([1, 2, 3])
            futs = [server.submit(s) for s in (4, 5, 6)]
            for f in futs:
                f.result(WAIT)
    finally:
        server.close()
    names = {s.name for s in timer.RECORDER.spans()}
    assert {"a", "service.top_k", "loop.topk", "serving.dispatch"} <= names


def test_a_traced_server_gives_each_dispatch_its_span_tree(tiny):
    svc = PPRService(tiny, alpha=0.15, k=5)
    server = PPRBatchServer(svc, max_batch=16)
    sources = list(range(0, 200, 5))
    try:
        svc.top_k([0] * 8)              # first calls outside the profile
        with _profiled():
            futs = [server.submit(s) for s in sources]
            answers = [f.result(WAIT) for f in futs]
    finally:
        server.close()
    assert len(answers) == len(sources)
    spans = timer.RECORDER.spans()
    disp = [s for s in spans if s.name == "serving.dispatch"]
    assert disp and sum(s.attrs["rows"] for s in disp) == len(sources)
    for d in disp:
        assert d.parent is None and d.root == d.id
        assert d.attrs["width"] >= d.attrs["rows"]
        tree = [s for s in spans if s.root == d.id and s is not d]
        kids = {s.name: s for s in tree if s.parent == d.id}
        assert set(kids) == {"service.top_k", "serving.resolve"}
        top = kids["service.top_k"]
        assert top.attrs == {"rows": d.attrs["width"]}
        inner = {s.name for s in tree if s.parent == top.id}
        assert {"loop.topk", "service.hits"} <= inner
        assert inner <= {"loop.topk", "service.hits", "service.recompute"}
        for s in tree:
            assert d.start_ns <= s.start_ns <= s.end_ns <= d.end_ns
            assert s.thread == d.thread != threading.get_native_id()
    takes = [s for s in spans if s.name == "serving.take"]
    assert takes and all(s.parent is None for s in takes)
    wait_ms, n = timer.RECORDER.counters()["serving.queue_wait"]
    assert n == len(sources) and wait_ms >= 0.0


@pytest.mark.parametrize("push,path,key", [
    ("none", "annealed", "sweeps"), ("reference", "push+walks", "rounds")])
def test_the_loop_span_and_counters(tiny, push, path, key):
    algo = tfora.ForaTopk(tiny, alpha=0.15, k=5, push=push)
    hs_algo = tfora.ForaTopk(tiny, alpha=0.15, k=5, push=push)
    hs_algo.enable_hub_split(8)
    for a, hubs, tail in ((algo, 0, tiny.graph.m), (hs_algo, 8, None)):
        timer.RECORDER.clear()
        tail = tail if tail is not None else a.hub_split.m_tail
        with _profiled():
            a.compute_topk_ids_batch(np.arange(10), 5, 0.5)
        (sp,) = [s for s in timer.RECORDER.spans() if s.name == "loop.topk"]
        assert sp.attrs == {"path": path, key: a.last_iters, "columns": 10,
                            "hubs": hubs, "tail_edges": tail}
        assert a.last_path == path
        counters = timer.RECORDER.counters()
        if path != "annealed":
            assert "loop.sweeps" not in counters
            continue
        sweeps, calls = counters["loop.sweeps"]
        assert calls == 1
        # the loop launches up to CHECK_EVERY - 1 frozen sweeps after it
        # stops, before the host reads ``finished``
        assert a.last_iters <= sweeps < a.last_iters + tfora.CHECK_EVERY
        assert sweeps % tfora.CHECK_EVERY == 0
        checks = [s for s in timer.RECORDER.spans() if s.name == "loop.check"]
        assert len(checks) == sweeps // tfora.CHECK_EVERY
        assert all(c.parent == sp.id for c in checks)
        assert counters["loop.edge_cols"] == (sweeps * tail * 10, 1)


@pytest.mark.parametrize("profiled", [True, False])
def test_the_hit_list_counters(tiny, profiled):
    """Under a profiler ``service.hits_built`` counts the hits built from
    the window and ``service.tie_rows`` the rows that run past k on ties
    (a recomputed row in neither); outside one nothing is recorded."""
    svc = PPRService(tiny, alpha=0.15, k=3)
    vals = np.array([[.5, .4, .3, .2, .1, 0.],     # 3 hits
                     [.5, .3, .3, .3, 0., 0.],     # 4: ties past k
                     [.4, .2, .2, .2, .2, .2],     # recomputed
                     [.0, .0, .0, .0, .0, .0]], np.float32)
    ids = np.arange(24).reshape(4, 6)
    with _profiled() if profiled else contextlib.nullcontext():
        hits = svc._hits_from_ids(vals, ids, 3, np.array([1, 2, 3, 4]), 0.5)
    assert [len(row) for row in hits[:2] + hits[3:]] == [3, 4, 0]
    counters = timer.RECORDER.counters()
    if not profiled:
        assert counters == {} and timer.RECORDER.spans() == []
        return
    assert counters["service.hits_built"] == (7, 1)
    assert counters["service.tie_rows"] == (1, 1)
    (rec,) = [s for s in timer.RECORDER.spans()
              if s.name == "service.recompute"]
    assert rec.attrs == {"rows": 1}
    # a whole call: every hit of the window counted, none recomputed
    timer.RECORDER.clear()
    with _profiled():
        rows = svc.top_k(np.arange(0, 400, 9))
    assert not [s for s in timer.RECORDER.spans()
                if s.name == "service.recompute"]
    counters = timer.RECORDER.counters()
    assert counters["service.hits_built"] == (sum(map(len, rows)), 1)
    assert counters["service.tie_rows"] == (
        sum(len(row) > 3 for row in rows), 1)


def test_trace_writes_the_unrecorded_threads_spans(tmp_path):
    go, done = threading.Event(), threading.Event()
    stamps = {}

    def worker():
        go.wait(WAIT)
        stamps["before"] = time.time_ns()
        with timer.span("worker.dispatch", rows=3):
            time.sleep(0.002)
        stamps["after"] = time.time_ns()
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    with timer.trace(str(tmp_path)):
        with timer.span("main.span"):
            torch.ones(8).add_(1)
        timer.count("c", 2.0)
        go.set()
        assert done.wait(WAIT)
    t.join(WAIT)
    doc = json.loads((tmp_path / "trace.json").read_text())
    base = doc["baseTimeNanoseconds"]
    added = {e["name"]: e for e in doc["traceEvents"]
             if e.get("cat") == "ppr_span"}
    assert set(added) == {"worker.dispatch", "main.span"}
    ev = added["worker.dispatch"]
    assert ev["tid"] == t.native_id and ev["args"]["rows"] == 3
    start = ev["ts"] * 1e3 + base
    assert stamps["before"] - 1e3 <= start
    assert start + ev["dur"] * 1e3 <= stamps["after"] + 1e3
    # the main thread's span is there twice: the profiler's annotation
    # and the recorder's event
    assert sum(e.get("name") == "main.span"
               for e in doc["traceEvents"]) == 2
    assert doc["pprCounters"] == {"c": [2.0, 1]}


def test_trace_keeps_the_attributes_of_a_recorded_threads_span(tiny,
                                                               tmp_path):
    """The CLI's batch test runs on the main thread, which the profiler
    records: the loop's span still reaches ``trace.json`` with its
    attributes."""
    algo = tfora.ForaTopk(tiny, alpha=0.15, k=5)
    with timer.trace(str(tmp_path)):
        with timer.span("cli.batch", rows=8):
            algo.compute_topk_ids_batch(np.arange(8), 5, 0.5)
    doc = json.loads((tmp_path / "trace.json").read_text())
    added = {e["name"]: e for e in doc["traceEvents"]
             if e.get("cat") == "ppr_span"}
    assert set(added) == {"cli.batch", "loop.topk", "loop.check"}
    top = added["loop.topk"]
    assert top["tid"] == threading.get_native_id()
    assert top["args"]["parent"] == added["cli.batch"]["args"]["id"]
    assert {k: top["args"][k] for k in ("path", "sweeps", "columns",
                                        "tail_edges")} == {
        "path": "annealed", "sweeps": algo.last_iters, "columns": 8,
        "tail_edges": tiny.graph.m}
    assert added["cli.batch"]["args"]["rows"] == 8
    assert any(e.get("cat") == "user_annotation" and e["name"] == "loop.topk"
               for e in doc["traceEvents"])
