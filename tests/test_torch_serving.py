"""The port's serving layer (``ppr_tpu_torch/serving.py``) against the JAX
package's (``ppr_tpu/serving.py``).

* The SLO policy: a JAX server and a port server over the same fake
  service are fed the same ``_slo_update`` / ``_note_service_time`` /
  ``_choose_width`` / ``_explore_width`` calls and emulated dispatches
  (the scenarios of ``tests/test_serving.py``), with given service times
  and no sleeps; after every call the cap, the cap moves, the EWMAs, the
  flags and the returned widths must be equal.
* The functional cases of ``tests/test_serving.py`` against the port over a
  fake service or the port's service on a small seeded graph on the CPU.
  Every wait on a future has a timeout, and no test compares a wall-clock
  time with an SLO.
* ``serve_loop`` of both packages on the same request lines with
  ``max_batch=1`` (each request its own width-8 dispatch): the same ids,
  scores within 1e-6 relative.
* The daemon, ``python -m ppr_tpu_torch.serving --device cpu``, in a
  subprocess.
* The server's code itself: its classes and functions other than ``main``
  parse to the same syntax tree in both packages once docstrings are
  stripped (the port rewrote only docstrings and comments there).
"""

import ast
import dataclasses
import io
import json
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

import ppr_tpu.serving as jserving
import ppr_tpu_torch.serving as tserving
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.service import PPRService as JaxService
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.service import PPRService

ROOT = Path(__file__).resolve().parents[1]
WAIT = 120   # seconds any future may take before the test fails


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.fixture(scope="module")
def small():
    jds = synthetic_powerlaw(300, 3, seed=3, dense_threshold=0)
    return jds, port_dataset(jds)


@pytest.fixture(scope="module")
def svc(small):
    return PPRService.from_dataset(small[1], alpha=0.15, k=10, seed=5)


class FakeService:
    """Instant and deterministic: records each batch, echoes its sources."""

    def __init__(self, n_nodes=None, fail_width=None):
        self.batches = []
        self.fail_width = fail_width
        if n_nodes is not None:
            self.n_nodes = n_nodes

    def top_k(self, sources, k=None, eps=None):
        if len(sources) == self.fail_width:
            raise RuntimeError("dispatch failed")
        self.batches.append(list(sources))
        return [[(s, 1.0, str(s))] for s in sources]


# ----------------------------------------------------------- SLO policy
def affine(base, per_row):
    return lambda w: base + per_row * w


MODELS = {
    "steep": affine(5.0, 5.0),           # t(8) = 45 ms
    "fast": affine(1.0, 0.01),
    "inverted": lambda w: 60.0 - 0.2 * w,
    "flat": lambda w: 10.0,
}

# (server kwargs, ops). Ops: ("update", w, ms, backlog), ("note", w, ms),
# ("choose", b), ("explore", w), ("set", attr, value), ("stats", attr,
# value), ("seen", widths), ("warm", {w: ms}), ("dispatch", b, backlog,
# model), ("flood", n, backlog, model): n dispatches each filling the cap.
SCENARIOS = {
    "cold_sample_ignored": (dict(slo_ms=50.0, max_batch=256), [
        ("update", 8, 30_000.0, True), ("update", 8, 2.0, True),
        ("update", 16, 40.0, True), ("update", 16, 40.0, True)]),
    "unattainable_idle_jump": (dict(slo_ms=20.0, max_batch=256), [
        ("update", 8, 45.0, True), ("update", 8, 45.0, True),
        ("set", "_slo_cap", 64), ("seen", [16, 32, 64]),
        ("update", 64, 325.0, False), ("update", 64, 325.0, False)]),
    "unattainable_idle_prefers_wide": (dict(slo_ms=200.0, max_batch=256), [
        ("update", 8, 1790.0, True), ("update", 8, 1790.0, True),
        ("update", 64, 900.0, True), ("update", 64, 900.0, True),
        ("update", 256, 620.0, True), ("update", 256, 620.0, True),
        ("set", "_slo_cap", 64), ("update", 64, 900.0, False)]),
    "flag_clears_on_recovery": (dict(slo_ms=50.0, max_batch=256), [
        ("update", 8, 100.0, True), ("update", 8, 100.0, True)]
        + [("update", 8, 4.0, True)] * 6),
    "stale_ewma_reprobed": (dict(max_batch=64, stale_after=10), [
        ("seen", [64]), ("note", 64, 500.0), ("seen", [8]),
        ("note", 8, 2.0), ("stats", "dispatches", 100), ("choose", 3),
        ("choose", 3)]),
    "breach_jumps_to_fastest": (dict(slo_ms=800.0, max_batch=256), [
        ("warm", {8: 500.0, 64: 420.0, 256: 250.0}), ("set", "_slo_cap", 64),
        ("update", 64, 500.0, True)]),
    "blind_shrink_refused_under_backlog": (dict(slo_ms=800.0), [
        ("warm", {64: 400.0, 128: 395.0}), ("set", "_slo_cap", 64),
        ("update", 64, 440.0, True), ("update", 64, 440.0, False)]),
    "breach_jump_beats_classic_shrink": (dict(slo_ms=800.0), [
        ("warm", {8: 100.0, 16: 150.0, 64: 350.0}), ("set", "_slo_cap", 64),
        ("update", 64, 550.0, True), ("update", 64, 550.0, False),
        ("update", 64, 550.0, False)]),
    "explore_fills_gaps": (dict(slo_ms=5.0, max_batch=64), [
        ("warm", {8: 100.0, 64: 100.0}), ("stats", "slo_unattainable", True),
        ("explore", 8)]),
    "explore_rising_trend": (dict(slo_ms=5.0, max_batch=128), [
        ("warm", {8: 100.0, 16: 90.0, 32: 200.0}),
        ("stats", "slo_unattainable", True), ("explore", 8)]),
    "sustained_backlog_max_throughput": (dict(slo_ms=800.0), [
        ("warm", {16: 289.0, 64: 404.0, 256: 625.0}), ("set", "_slo_cap", 16)]
        + [("update", 16, 289.0, True)] * 3),
    "transient_backlog_holds": (dict(slo_ms=800.0), [
        ("warm", {16: 289.0, 64: 404.0, 256: 625.0}), ("set", "_slo_cap", 64),
        ("update", 64, 420.0, True)]),
    "unattainable_grows_under_backlog": (dict(slo_ms=20.0, max_batch=256), [
        ("flood", 60, True, "steep")]),
    "grows_within_slo": (dict(slo_ms=100.0, max_batch=256), [
        ("flood", 60, True, "fast")]),
    "prewarmed_inverted_converges_wide": (dict(slo_ms=10.0, max_batch=256), [
        ("warm", {w: MODELS["inverted"](w)
                  for w in (8, 16, 32, 64, 128, 256)}),
        *[("dispatch", 1, False, "inverted")] * 10,
        ("flood", 40, True, "inverted")]),
    "unprewarmed_explores_ladder": (dict(slo_ms=5.0, max_batch=64), [
        *[("dispatch", 1, False, "flat")] * 24]),
    "static_cap_notes_ewmas": (dict(max_batch=16), [
        ("flood", 10, True, "fast"), ("dispatch", 3, False, "fast")]),
}


def emulate_dispatch(server, b, backlog, model):
    """The timing half of ``_dispatch_loop`` without the thread: choose the
    width, count the dispatch, fold in the model's service time."""
    width = b
    if server.bucket:
        width = server._choose_width(b)
        server.stats.padded_rows += width - b
    server.stats.dispatches += 1
    server.stats.dispatched_rows += b
    server.stats.batch_sizes.append(b)
    ms = MODELS[model](width)
    if server.slo_ms is not None:
        server._slo_update(width, ms, backlog)
    else:
        server._note_service_time(width, ms)
    return width


def run_scenario(module, kwargs, ops):
    """The server's state after every op of a scenario."""
    server = module.PPRBatchServer(FakeService(), **kwargs)
    trace = []
    try:
        for op in ops:
            kind, args = op[0], op[1:]
            out = None
            if kind == "update":
                server._slo_update(*args)
            elif kind == "note":
                out = server._note_service_time(*args)
            elif kind == "choose":
                out = server._choose_width(*args)
            elif kind == "explore":
                out = server._explore_width(*args)
            elif kind == "set":
                setattr(server, *args)
            elif kind == "stats":
                setattr(server.stats, *args)
            elif kind == "seen":
                server._seen_width.update(args[0])
            elif kind == "warm":
                server._svc_time_ms.update(args[0])
                server._svc_time_at.update({w: 0 for w in args[0]})
                server._seen_width.update(args[0])
            elif kind == "dispatch":
                out = emulate_dispatch(server, *args)
            elif kind == "flood":
                n, backlog, model = args
                out = [emulate_dispatch(server, server._cap(), backlog, model)
                       for _ in range(n)]
            st = server.stats
            trace.append((op, out, server._cap(), server._slo_cap,
                          sorted(server._svc_time_ms.items()),
                          sorted(server._svc_time_at.items()),
                          list(st.cap_moves), st.slo_unattainable,
                          st.slo_unattainable_ever, st.widened_dispatches,
                          st.padded_rows, server._idle_streak,
                          server._backlog_streak))
    finally:
        server.close()
    return trace


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_slo_policy_matches_jax(name):
    kwargs, ops = SCENARIOS[name]
    want = run_scenario(jserving, kwargs, ops)
    got = run_scenario(tserving, kwargs, ops)
    for w, g in zip(want, got):
        assert g == w, w[0]
    assert len(got) == len(want) == len(ops)


def test_slo_scenarios_reach_their_regimes():
    """The scenarios above do drive the policy's branches (read from the
    port's trace; the JAX trace is equal)."""
    last = {name: run_scenario(tserving, *SCENARIOS[name])[-1]
            for name in ("unattainable_grows_under_backlog",
                         "grows_within_slo",
                         "prewarmed_inverted_converges_wide",
                         "unprewarmed_explores_ladder",
                         "sustained_backlog_max_throughput")}
    assert last["unattainable_grows_under_backlog"][7]        # best effort
    assert max(last["unattainable_grows_under_backlog"][1]) > 8
    assert last["grows_within_slo"][2] == 256
    assert last["prewarmed_inverted_converges_wide"][2] == 256
    assert [w for w, _ in last["unprewarmed_explores_ladder"][4]] == \
        [8, 16, 32, 64]
    assert last["sustained_backlog_max_throughput"][6] == [(0, 256)]


# ----------------------------------------------------- functional cases
def _definitions(module) -> dict[str, ast.AST]:
    """Top-level classes and functions, and the methods of classes as
    ``Class.method``, of a module's source, with docstrings stripped."""
    tree = ast.parse(Path(module.__file__).read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and isinstance(
                node.body[0], ast.Expr) and isinstance(
                node.body[0].value, ast.Constant) and isinstance(
                node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        if isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef):
                    out[f"{node.name}.{sub.name}"] = sub
    return out


@pytest.mark.parametrize("name", [
    "ServerStats", "_pow2_bucket", "_ladder", "PPRBatchServer",
    "PPRBatchServer.prewarm", "PPRBatchServer._choose_width",
    "PPRBatchServer._explore_width", "PPRBatchServer._slo_update",
    "PPRBatchServer._dispatch_loop", "PPRBatchServer._take_batch",
    "PPRBatchServer.submit", "serve_loop",
])
def test_server_code_is_the_jax_code(name):
    """The policy, prewarm, dispatcher and ``serve_loop`` are the JAX
    package's line for line: equal syntax trees without docstrings."""
    jdefs, tdefs = _definitions(jserving), _definitions(tserving)
    assert ast.dump(tdefs[name]) == ast.dump(jdefs[name])


def test_pow2_bucket_and_ladder_match_jax():
    for b in (1, 8, 9, 1024, 1025):
        assert tserving._pow2_bucket(b) == jserving._pow2_bucket(b)
    assert tserving._pow2_bucket(1) == 8 and tserving._pow2_bucket(9) == 16
    assert list(tserving._ladder(8, 256)) == list(jserving._ladder(8, 256))


def test_batch_server_matches_sync(svc):
    """The server's rows are the service's rows for the batch it dispatches
    (the sources, padded to width 8 with copies of the first)."""
    sources = [3, 14, 50, 7, 3]
    want = svc.top_k(sources + [sources[0]] * 3, k=10)[: len(sources)]
    with tserving.PPRBatchServer(svc, max_batch=64) as server:
        futs = [server.submit(s) for s in sources]
        got_rows = [f.result(timeout=WAIT) for f in futs]
    for got_row, want_row in zip(got_rows, want):
        assert [h.node for h in got_row] == [h.node for h in want_row]
        np.testing.assert_allclose([h.score for h in got_row],
                                   [h.score for h in want_row])
    assert server.stats.requests == len(sources)
    assert server.stats.dispatched_rows == len(sources)


def test_batch_server_coalesces(svc):
    """Concurrent submissions end up in shared dispatches, padded to pow2
    widths."""
    n_req = 24
    with tserving.PPRBatchServer(svc, max_batch=64,
                                 max_delay_ms=30) as server:
        futs = []
        barrier = threading.Barrier(8)

        def client(base):
            barrier.wait(timeout=WAIT)
            for s in range(base, base + 3):
                futs.append(server.submit(s % 20))

        threads = [threading.Thread(target=client, args=(i * 3,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
            assert not t.is_alive()
        rows = [f.result(timeout=WAIT) for f in futs]
    assert len(rows) == n_req
    assert all(len(r) >= 1 for r in rows)
    assert server.stats.requests == n_req
    assert server.stats.dispatches < n_req
    assert server.stats.mean_batch > 1.0


def test_batch_server_groups_params(svc):
    """Different (k, eps) never share a device batch."""
    want5 = svc.top_k([14] * 8, k=5)[0]
    want10 = svc.top_k([14] * 8, k=10)[0]
    with tserving.PPRBatchServer(svc, max_batch=64,
                                 max_delay_ms=30) as server:
        f1 = server.submit(14, k=5)
        f2 = server.submit(14, k=10)
        r1, r2 = f1.result(timeout=WAIT), f2.result(timeout=WAIT)
    assert [h.node for h in r1] == [h.node for h in want5]
    assert [h.node for h in r2] == [h.node for h in want10]
    assert server.stats.dispatches == 2


def test_batch_server_max_batch_splits():
    fake = FakeService()
    with tserving.PPRBatchServer(fake, max_batch=4,
                                 max_delay_ms=30) as server:
        futs = [server.submit(s % 20) for s in range(10)]
        rows = [f.result(timeout=WAIT) for f in futs]
    assert [r[0][0] for r in rows] == [s % 20 for s in range(10)]
    assert server.stats.dispatches >= 3
    assert max(server.stats.batch_sizes) <= 4
    assert all(len(b) == 8 for b in fake.batches)   # padded to the rung


def test_batch_server_error_fanout():
    """A batch that raises fans the exception to every waiting future, and
    the dispatcher survives to serve the next batch."""
    class Boom(RuntimeError):
        pass

    class Flaky(FakeService):
        calls = 0

        def top_k(self, sources, k=None, eps=None):
            self.calls += 1
            if self.calls == 1:
                raise Boom("device fell over")
            return super().top_k(sources, k, eps)

    with tserving.PPRBatchServer(Flaky(), max_batch=8) as server:
        fut = server.submit(3)
        with pytest.raises(Boom):
            fut.result(timeout=WAIT)
        ok = server.submit(3).result(timeout=WAIT)
    assert ok == [(3, 1.0, "3")]
    assert server.stats.dispatches == 2


def test_batch_server_closed_rejects():
    server = tserving.PPRBatchServer(FakeService(), max_batch=8)
    server.close()
    with pytest.raises(RuntimeError, match="closed"):
        server.submit(1)


def test_serve_loop_jsonl(svc):
    """JSON lines in, correlated responses out, the stats command, and an
    error line for a malformed request."""
    reqs = [json.dumps({"source": 3, "id": "a"}),
            json.dumps({"source": 14, "id": "b", "k": 5}),
            "not json",
            json.dumps({"cmd": "stats", "id": "s"})]
    out = io.StringIO()
    stats = tserving.serve_loop(svc, iter(r + "\n" for r in reqs), out,
                                max_batch=1)
    by_id = {line["id"]: line
             for line in map(json.loads, out.getvalue().splitlines())}
    assert stats.requests == 2
    want_a = svc.top_k([3] * 8, k=10)[0]
    assert by_id["a"]["hits"] == [[h.node, h.score, h.name] for h in want_a]
    want_b = svc.top_k([14] * 8, k=5)[0]
    assert by_id["b"]["hits"] == [[h.node, h.score, h.name] for h in want_b]
    assert "error" in by_id[2]
    assert by_id["s"]["stats"]["requests"] >= 0


def test_latency_stats_recorded():
    with tserving.PPRBatchServer(FakeService(), max_batch=64) as server:
        for f in [server.submit(s) for s in range(1, 10)]:
            f.result(timeout=WAIT)
        stats = server.stats
    assert len(stats.latencies_ms) == 9
    assert all(x > 0 for x in stats.latencies_ms)
    pct = stats.latency_percentiles()
    assert pct["p50"] <= pct["p95"] <= pct["p99"]
    assert pct["p99"] <= max(stats.latencies_ms) + 1e-9


def test_latency_percentiles_match_jax():
    assert tserving.ServerStats().latency_percentiles() == {
        "p50": None, "p95": None, "p99": None}
    xs = list(np.random.default_rng(0).random(101) * 100)
    j, t = jserving.ServerStats(), tserving.ServerStats()
    j.latencies_ms, t.latencies_ms = list(xs), list(xs)
    assert t.latency_percentiles((50, 90, 99.9)) == \
        j.latency_percentiles((50, 90, 99.9))


@pytest.mark.parametrize("n_nodes", [None, 1000])
def test_prewarm_matches_jax(n_nodes):
    """Every rung is dispatched twice, with the same probe batches as the
    JAX server: spread over the service's nodes when it exposes n_nodes,
    copies of the probe source when it does not."""
    batches = {}
    for module in (jserving, tserving):
        fake = FakeService(n_nodes)
        with module.PPRBatchServer(fake, max_batch=64, slo_ms=1000.0,
                                   prewarm=True, probe_source=3) as server:
            assert sorted(server._svc_time_ms) == [8, 16, 32, 64]
            assert server.stats.prewarmed_widths == [8, 16, 32, 64]
        batches[module] = fake.batches
    assert batches[tserving] == batches[jserving]
    assert [len(b) for b in batches[tserving]] == [8, 8, 16, 16, 32, 32,
                                                   64, 64]
    spread = len(set(batches[tserving][-1]))
    assert spread == (64 if n_nodes else 1)


def test_prewarm_n_nodes_from_the_service(svc):
    """The port's service exposes n_nodes, so its prewarm probes real,
    distinct nodes."""
    seen = []

    class Spy:
        n_nodes = svc.n_nodes

        def top_k(self, sources, k=None, eps=None):
            seen.append(list(sources))
            return svc.top_k(sources, k=k, eps=eps)

    with tserving.PPRBatchServer(Spy(), max_batch=16, prewarm=True,
                                 probe_source=1) as server:
        assert server.stats.prewarmed_widths == [8, 16]
    assert svc.n_nodes == 300
    assert seen[-1] == [(1 + i * 7919) % 300 for i in range(16)]


def test_prewarm_transient_failure_skips_rung(monkeypatch):
    monkeypatch.setattr(tserving, "_PREWARM_RETRY_S", 0.0)
    fake = FakeService(fail_width=32)
    with tserving.PPRBatchServer(fake, max_batch=64, slo_ms=1000.0,
                                 prewarm=True) as server:
        assert sorted(server._svc_time_ms) == [8, 16, 64]
        assert server.stats.prewarm_failed_widths == [32]
        assert server.stats.prewarmed_widths == [8, 16, 64]
        assert server.submit(1).result(timeout=WAIT)


class StreamService:
    """Two cohorts: the even rows, then the odd rows once ``release`` is
    set; with ``drop`` row 1 is never emitted."""

    supports_stream = True

    def __init__(self, drop=False):
        self.release = threading.Event()
        self.drop = drop

    def top_k_stream(self, sources, k=None, eps=None, *, emit):
        b = len(sources)
        fast, slow = list(range(0, b, 2)), list(range(1, b, 2))
        emit(np.array(fast), [[(sources[i], 1.0, "")] for i in fast])
        assert self.release.wait(timeout=WAIT)
        if self.drop:
            slow = slow[1:]
        emit(np.array(slow), [[(sources[i], 1.0, "")] for i in slow])


def test_server_resolves_fast_cohort_first():
    """A row's future resolves when ITS cohort retires, while the slow
    cohort is still held back by the service."""
    svc = StreamService()
    with tserving.PPRBatchServer(svc, max_batch=16,
                                 max_delay_ms=200) as server:
        futs = [server.submit(s) for s in (4, 5)]
        assert futs[0].result(timeout=WAIT) == [(4, 1.0, "")]
        assert not futs[1].done()
        svc.release.set()
        assert futs[1].result(timeout=WAIT) == [(5, 1.0, "")]
    assert server.stats.dispatches == 1
    assert len(server.stats.latencies_ms) == 2


def test_server_fails_rows_a_stream_never_emits():
    svc = StreamService(drop=True)
    svc.release.set()
    with tserving.PPRBatchServer(svc, max_batch=16,
                                 max_delay_ms=200) as server:
        futs = [server.submit(s) for s in (4, 5)]
        assert futs[0].result(timeout=WAIT) == [(4, 1.0, "")]
        with pytest.raises(RuntimeError, match="without this row"):
            futs[1].result(timeout=WAIT)


def test_cohort_service_behind_the_server(svc, small):
    """``cohort=True`` services stream through the dispatcher: every future
    resolves, to the rows of a direct ``top_k_stream`` of the batch."""
    csvc = PPRService.from_dataset(small[1], alpha=0.15, k=10, seed=5,
                                   cohort=True)
    sources = [3, 14, 50, 7, 9, 22, 31, 44]
    want = [None] * len(sources)

    def emit(idxs, rows):
        for i, row in zip(idxs, rows):
            want[int(i)] = row

    csvc.top_k_stream(sources, emit=emit)
    with tserving.PPRBatchServer(csvc, max_batch=8,
                                 max_delay_ms=200) as server:
        got = [f.result(timeout=WAIT)
               for f in [server.submit(s) for s in sources]]
    assert server.stats.dispatches == 1
    for g, w in zip(got, want):
        assert [h.node for h in g] == [h.node for h in w]


# ----------------------------------------------------- serve_loop parity
def test_serve_loop_matches_jax(small):
    """The same lines through both packages' serve_loop with max_batch=1:
    each request is its own width-8 dispatch, so the rows are
    deterministic."""
    jds, tds = small
    jsvc = JaxService(jds, k=10, seed=5)
    jsvc._topk_algo.push = "none"
    tsvc = PPRService(tds, k=10, seed=5)
    tsvc._topk_algo.push = "none"
    reqs = [json.dumps({"source": s, "id": f"r{s}"})
            for s in (0, 3, 17, 150, 299)]
    reqs += [json.dumps({"source": 21, "id": "k5", "k": 5}),
             json.dumps({"source": 21, "id": "eps", "eps": 0.2}),
             "{bad", json.dumps({"cmd": "stats", "id": "s"})]
    out = {}
    for name, mod, service in (("jax", jserving, jsvc),
                               ("port", tserving, tsvc)):
        buf = io.StringIO()
        stats = mod.serve_loop(service, iter(r + "\n" for r in reqs), buf,
                               max_batch=1)
        out[name] = ({line["id"]: line for line in
                      map(json.loads, buf.getvalue().splitlines())}, stats)
    (jlines, jstats), (tlines, tstats) = out["jax"], out["port"]
    assert sorted(tlines, key=str) == sorted(jlines, key=str)
    assert tstats.requests == jstats.requests == 7
    assert tstats.dispatches == jstats.dispatches == 7
    assert tstats.padded_rows == jstats.padded_rows == 49
    for rid, jline in jlines.items():
        tline = tlines[rid]
        if "hits" not in jline:
            assert set(tline) == set(jline)
            continue
        jh = {n: (s, name) for n, s, name in jline["hits"]}
        th = {n: (s, name) for n, s, name in tline["hits"]}
        assert sorted(th) == sorted(jh), rid
        for n, (s, name) in th.items():
            assert name == jh[n][1]
            assert abs(s - jh[n][0]) <= 1e-6 * abs(jh[n][0])


# ------------------------------------------------------------- the daemon
def test_daemon_main_on_the_cpu():
    lines = [json.dumps({"source": s, "id": i})
             for i, s in enumerate((3, 14, 150))]
    lines.append(json.dumps({"cmd": "stats", "id": "s"}))
    proc = subprocess.run(
        [sys.executable, "-m", "ppr_tpu_torch.serving", "--db",
         "synth:300x3@3", "--device", "cpu", "--max-batch", "8"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        cwd=ROOT, timeout=WAIT)
    assert proc.returncode == 0, proc.stderr
    out = [json.loads(x) for x in proc.stdout.splitlines()]
    hits = [o for o in out if "hits" in o]
    assert sorted(o["id"] for o in hits) == [0, 1, 2]
    assert all(len(o["hits"]) >= 1 for o in hits)
    assert [o for o in out if "stats" in o][0]["stats"]["requests"] >= 0
    ready = json.loads(proc.stderr.splitlines()[0])
    assert ready["ready"] and ready["n"] == 300 and ready["device"] == "cpu"


def test_daemon_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.main(["--db", "synth:300x3@3"])


@pytest.mark.parametrize("flag,item", [(["--mesh", "2x2"], "item 18"),
                                       (["--calibrate"], "item 11")])
def test_daemon_unported_flags_raise(flag, item, monkeypatch):
    """``--mesh`` still raises (item 18); ``--calibrate``, which raised
    until item 11 was ported, reaches the service."""
    if item == "item 18":
        with pytest.raises(NotImplementedError, match=item):
            tserving.main(["--db", "synth:300x3@3", "--device", "cpu",
                           *flag])
        return
    seen = {}

    def fake_serve_loop(svc, *args, **kwargs):
        seen["svc"] = svc
        return tserving.ServerStats()

    monkeypatch.setattr(tserving, "serve_loop", fake_serve_loop)
    monkeypatch.setattr(sys, "stdin", io.StringIO(""))
    assert tserving.main(["--db", "synth:300x3@3", "--device", "cpu",
                          *flag]) == 0
    algo = seen["svc"]._topk_algo
    assert (algo.avg_rand_walk_time_ns, algo.spmv_ns_per_edge) != (400.0, 4.0)
