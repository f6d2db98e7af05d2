"""The one generator of traffic: it reads a mix's parameters from
``traffic/<mix>.json`` and drives the program with them.

``"kind": "batch"``: one caller in a closed loop calls ``PPRService.top_k``
on ``batch`` sources and sends the next batch when the last returns.

``"kind": "open"``: an open loop submits one request at a time to
``PPRBatchServer`` at Poisson arrivals of ``rate_qps``. Each request is
timed by the benchmark from its due time to the moment its future
resolves. Arrivals in the first ``lead_in_s`` seconds bring the server to
its steady state and are not measured.

Sources are uniform over the nodes, as the reference's ``getQueryNodes``
draws query nodes (Gen_Util.java:99-107). Everything is drawn from the seed.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time

import numpy as np


def sources(rng: np.random.Generator, n: int, count: int) -> np.ndarray:
    return rng.integers(0, n, size=count, dtype=np.int64)


def due_times(rng: np.random.Generator, rate_qps: float,
              seconds: float) -> np.ndarray:
    """Arrival offsets in ``[0, seconds)`` of a Poisson process of rate
    ``rate_qps``."""
    count = int(rate_qps * seconds * 1.2 + 10 * math.sqrt(rate_qps * seconds)
                + 16)
    t = np.cumsum(rng.exponential(1.0 / rate_qps, size=count))
    while t[-1] < seconds:
        t = np.concatenate([t, t[-1] + np.cumsum(
            rng.exponential(1.0 / rate_qps, size=count))])
    return t[t < seconds]


@dataclasses.dataclass
class Record:
    """What a window produced, for the metrics and the check."""

    attempted: int = 0
    failed: int = 0
    completed: int = 0
    window_s: float = 0.0
    #: the clock reading when the first measured request was sent
    first_t: float = 0.0
    #: (source, [(node, score), ...]) of every answer, and each one's
    #: latency from its due time (open loop) in ms
    answers: list = dataclasses.field(default_factory=list)
    latency_ms: list = dataclasses.field(default_factory=list)
    #: the program's server counters over the window
    counters: dict = dataclasses.field(default_factory=dict)
    queries_traced: int = 0
    notes: dict = dataclasses.field(default_factory=dict)


def _pairs(hits) -> list:
    return [(int(h.node), float(h.score)) for h in hits]


def run_batch(svc, mix: dict, n: int, rng, seconds: float, tracer) -> Record:
    """The closed loop: batches until ``seconds`` have passed; the window
    ends when the batch running then returns. ``tracer`` brackets batches
    1 to ``tracer.batches`` of the window, and the next ``tracer.batches``
    after each slice it does not keep; the window runs on until it keeps
    one."""
    b = int(mix["batch"])
    rec = Record()
    t0 = time.perf_counter()
    rec.first_t = t0
    i = first = 0
    while (i == 0 or time.perf_counter() - t0 < seconds
           or (tracer is not None and not tracer.done)):
        batch = sources(rng, n, b)
        if tracer is not None and i >= 1 and not (tracer.on or tracer.done):
            tracer.start()
            first = i
        try:
            hits = svc.top_k(batch)
        except Exception as e:  # noqa: BLE001 - a failed batch is counted
            rec.failed += b
            rec.notes.setdefault("errors", []).append(repr(e))
            hits = None
        if tracer is not None and tracer.on \
                and i == first + tracer.batches - 1:
            tracer.stop()
            rec.queries_traced = tracer.batches * b
        rec.attempted += b
        if hits is not None:
            rec.completed += b
            rec.answers += [(int(s), _pairs(h)) for s, h in zip(batch, hits)]
        i += 1
    rec.window_s = time.perf_counter() - t0
    rec.notes["batches"] = i
    return rec


def _counters(stats) -> dict:
    return {"dispatches": stats.dispatches,
            "dispatched_rows": stats.dispatched_rows,
            "padded_rows": stats.padded_rows}


class _Offer:
    """Requests submitted at their due times, each one's resolution time
    noted by a callback."""

    def __init__(self, due: np.ndarray, src: np.ndarray):
        self.due, self.src = due, src
        self.done = np.full(due.size, np.nan)
        self.futs = [None] * due.size
        self.late = np.zeros(due.size)
        self.last_done = 0.0
        self._lock = threading.Lock()
        self.base = time.perf_counter() + 0.01

    def _on_done(self, i):
        def cb(_fut):
            t = time.perf_counter()
            self.done[i] = t
            with self._lock:
                self.last_done = max(self.last_done, t)
        return cb

    def send(self, server, i: int) -> None:
        """Wait for request ``i``'s due time and submit it."""
        now = time.perf_counter()
        if now < self.base + self.due[i]:
            time.sleep(self.base + self.due[i] - now)
        self.late[i] = time.perf_counter() - (self.base + self.due[i])
        fut = server.submit(int(self.src[i]))
        fut.add_done_callback(self._on_done(i))
        self.futs[i] = fut


def run_open(server, mix: dict, n: int, rng, seconds: float) -> Record:
    """The open loop: lead-in, then ``seconds`` of measured arrivals, then
    a wait of up to ``drain_s`` for every measured request."""
    lead = float(mix.get("lead_in_s", 0.0))
    due = due_times(rng, float(mix["rate_qps"]), lead + seconds)
    offer = _Offer(due, sources(rng, n, due.size))
    rec = Record()
    first = int(np.searchsorted(due, lead))
    rec.first_t = offer.base + lead
    before, n_disp = None, 0
    for i in range(due.size):
        if i == first:
            before = _counters(server.stats)
            n_disp = len(server.stats.batch_sizes)
        offer.send(server, i)
    if before is None:
        before = _counters(server.stats)
        n_disp = len(server.stats.batch_sizes)
    close = offer.base + lead + seconds
    deadline = close + float(mix.get("drain_s", 60.0))
    served = []
    for i in range(first, due.size):
        try:
            rows = offer.futs[i].result(
                timeout=max(0.0, deadline - time.perf_counter()))
        except Exception as e:  # noqa: BLE001 - unresolved or raised
            rec.failed += 1
            errors = rec.notes.setdefault("errors", [])
            if len(errors) < 20:
                errors.append(repr(e)[:200])
            continue
        served.append(i)
        rec.answers.append((int(offer.src[i]), _pairs(rows)))
    # a future's waiters may wake before its callbacks have run
    done = offer.done
    while np.isnan(done[served]).any() and time.perf_counter() < deadline + 1:
        time.sleep(0.001)
    rec.latency_ms = ((done[served] - (offer.base + due[served])) * 1e3
                      ).tolist()
    after = _counters(server.stats)
    sizes = server.stats.batch_sizes[n_disp:]
    rec.counters = {k: after[k] - before[k] for k in after}
    rec.attempted = due.size - first
    rec.completed = len(rec.answers)
    rec.window_s = seconds
    late = offer.late[first:]
    rec.notes.update(
        drain_s=max(0.0, offer.last_done - close),
        late_p99_ms=float(np.percentile(late, 99) * 1e3) if late.size
        else 0.0,
        late_max_ms=float(late.max() * 1e3) if late.size else 0.0,
        completed_in_window=int(np.sum(done[first:] <= close)),
        min_dispatch_rows=min(sizes, default=0),
    )
    return rec


def trace_open(server, mix: dict, n: int, rng, tracer,
               timeout_s: float = 120.0) -> int:
    """The traced slice of an open loop, after the measured window: with
    the server idle (``torch.profiler`` is not safe to start or stop while
    another thread runs operators), the profiler starts, the mix's arrivals
    run for ``tracer.seconds``, every one of them resolves, and the
    profiler stops; again, on fresh arrivals, until the tracer keeps a
    slice. Each slice starts from an idle server; the window's record is
    not touched. Returns the requests the kept slice sent."""
    while not tracer.done:
        due = due_times(rng, float(mix["rate_qps"]), tracer.seconds)
        tracer.start()
        offer = _Offer(due, sources(rng, n, due.size))
        for i in range(due.size):
            offer.send(server, i)
        end = time.perf_counter() + timeout_s
        while np.isnan(offer.done).any() and time.perf_counter() < end:
            time.sleep(0.001)
        tracer.stop()
    return int(due.size)
