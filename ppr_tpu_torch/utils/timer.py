"""The program's span and counter recorder, and device profiling — port of
``ppr_tpu/utils/timer.py``.

:data:`RECORDER` (:class:`Recorder`) keeps the program's spans and counters
in memory: :func:`span` brackets a piece of work at a layer boundary (the
serving layer's batch forming, dispatch and resolve, the service's hit
lists, the top-k loop), :func:`count` adds to a named counter. It records
only while a ``torch.profiler`` session runs in the process, on every
thread, including threads that the profiler itself does not record (a
dispatcher started before the session); with no session a span site costs
one read of the profiler's process-wide flag and returns a shared no-op.
Spans carry ``time.time_ns()`` stamps, the clock of the profiler's chrome
trace (an event's ``ts * 1000 + baseTimeNanoseconds``), and on a thread the
profiler records they also enter ``record_function``. No span or counter
waits for the card.

:func:`trace` wraps ``torch.profiler`` and writes a chrome trace with the
recorder's spans in it, in place of ``jax.profiler``; :func:`kernel_split`
reads the device time out of such a trace.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time

import torch
import torch.autograd.profiler as _profiler

#: spans the recorder keeps; the oldest are dropped past it
CAPACITY = 1 << 16


def recording() -> bool:
    """Whether a ``torch.profiler`` session runs in this process: the
    profiler's process-wide flag, which threads it does not record read
    too (``torch.autograd._profiler_enabled()`` is per thread)."""
    return _profiler._is_profiler_enabled


class Span:
    """One recorded span: ``name``, ``id``, the ``parent`` span's id (None
    at the top), ``root``, the id of the top of its tree (the spans of one
    dispatch share it: the dispatch id), the ``thread``'s native id (the
    profiler's ``tid``), ``start_ns`` and ``end_ns`` on ``time.time_ns()``,
    and ``attrs``. Entered as a context manager, it is the current span of
    its thread until it exits."""

    __slots__ = ("name", "id", "parent", "root", "thread", "start_ns",
                 "end_ns", "attrs", "_rec", "_fn")

    def __init__(self, rec: "Recorder", name: str, parent: "Span | None",
                 attrs: dict):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.id = next(rec._ids)
        self.parent = parent.id if parent is not None else None
        self.root = parent.root if parent is not None else self.id
        self.thread = threading.get_native_id()
        self.start_ns = self.end_ns = 0
        self._fn = None

    def set(self, **attrs) -> None:
        """Add attributes known only once the work ran."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._rec._stack().append(self)
        if recording() and torch.autograd._profiler_enabled():
            # a thread the profiler records shows the span in its trace
            self._fn = _profiler.record_function(self.name)
            self._fn.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.end_ns = time.time_ns()
        if self._fn is not None:
            self._fn.__exit__(None, None, None)
            self._fn = None
        stack = self._rec._stack()
        if stack and stack[-1] is self:
            stack.pop()
        self._rec._spans.append(self)


class _NoSpan:
    """What :meth:`Recorder.span` returns while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs) -> None:
        return None


NO_SPAN = _NoSpan()


class Recorder:
    """Spans and counters of the program, kept in memory (at most
    ``capacity`` spans, the oldest dropped first), recorded only while a
    ``torch.profiler`` session runs (:func:`recording`)."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._counters: dict[str, list] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current(self) -> Span | None:
        """The innermost open span of the calling thread."""
        st = self._stack()
        return st[-1] if st else None

    def span(self, name: str, parent: Span | None = None, **attrs):
        """A span of ``name`` with ``attrs``, a child of ``parent`` or of
        the calling thread's current span; :data:`NO_SPAN` while nothing
        records."""
        if not _profiler._is_profiler_enabled:
            return NO_SPAN
        return Span(self, name, parent if parent is not None
                    else self.current(), attrs)

    def count(self, name: str, value: float, n: int = 1) -> None:
        """Add ``value`` to counter ``name`` and ``n`` to its count."""
        if not _profiler._is_profiler_enabled:
            return
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                self._counters[name] = [value, n]
            else:
                c[0] += value
                c[1] += n

    def spans(self, since_ns: int = 0) -> list[Span]:
        """The kept spans that started at ``since_ns`` or later, in the
        order they ended."""
        return [s for s in list(self._spans) if s.start_ns >= since_ns]

    def counters(self) -> dict[str, tuple[float, int]]:
        """``name -> (sum, count)`` of every counter."""
        with self._lock:
            return {k: (v[0], v[1]) for k, v in self._counters.items()}

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._counters.clear()


#: the program's recorder: every span and counter of the library goes here
RECORDER = Recorder()
#: :meth:`Recorder.span` and :meth:`Recorder.count` of :data:`RECORDER`
span = RECORDER.span
count = RECORDER.count


def _chrome_events(spans: list[Span], base_ns: int, pid) -> list[dict]:
    """Every kept span, attributes in ``args``, as a complete event on
    the trace's clock (``ts`` in microseconds from ``base_ns``)."""
    out = []
    for s in spans:
        if not s.end_ns:
            continue
        args = {"id": s.id, "parent": s.parent, "root": s.root, **s.attrs}
        out.append({"ph": "X", "cat": "ppr_span", "name": s.name,
                    "pid": pid, "tid": s.thread,
                    "ts": (s.start_ns - base_ns) / 1e3,
                    "dur": (s.end_ns - s.start_ns) / 1e3,
                    "args": {k: v if isinstance(v, (int, float, str))
                             or v is None else str(v)
                             for k, v in args.items()}})
    return out


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block, CPU and (with a card) CUDA
    activity, written to ``<log_dir>/trace.json`` (chrome format) with the
    spans :data:`RECORDER` kept in the block, every thread's, with their
    attributes (``cat`` ``"ppr_span"``; on a thread the profiler records,
    its own annotation of the span is there too) and its counters
    (``"pprCounters"``, ``name -> [sum, count]``, the block's own); a
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    since = time.time_ns()
    before = RECORDER.counters()
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"] += _chrome_events(RECORDER.spans(since), base,
                                         os.getpid())
    doc["pprCounters"] = {
        k: [v[0] - before.get(k, (0, 0))[0], v[1] - before.get(k, (0, 0))[1]]
        for k, v in RECORDER.counters().items()}
    with open(path, "w") as f:
        json.dump(doc, f)


def kernel_split(path: str, top: int = 16,
                 named: dict[str, tuple[str, ...]] | None = None) -> dict:
    """The device time in a chrome trace of ``torch.profiler`` (:func:`trace`
    writes one): its kernel events (``cat == "kernel"``), ``busy_ms`` (the
    union of their intervals: kernels that overlap count once),
    ``span_ms`` (the first kernel's start to the last one's end),
    ``idle_share`` (``1 - busy / span``) and ``by_kernel``, the ``top``
    kernel names by device time, each with ms, share of the busy time and
    launches. ``by_op`` sums the kernels by the operator that launched
    them, the ``cpu_op`` event whose ``External id`` a kernel carries
    (kernels the trace does not link are left out). ``named`` maps a label
    to name fragments: ``named[label]`` sums every kernel whose name holds
    one of them, whatever ``top`` keeps."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    # times from the first kernel's start: a trace's ``ts`` is microseconds
    # on a large clock, where adding a kernel's ``dur`` rounds by ~1e-4 us
    t0 = min((e["ts"] for e in kernels), default=0.0)
    busy, span_us = 0.0, 0.0
    for start, end in sorted((e["ts"] - t0, e["ts"] - t0 + e["dur"])
                             for e in kernels):
        busy += max(0.0, end - max(start, span_us))
        span_us = max(span_us, end)

    def rows(groups: dict[str, list]) -> list[dict]:
        return [{"name": name, "ms": us / 1e3,
                 "share": us / busy if busy else None, "launches": n}
                for name, (us, n) in sorted(groups.items(),
                                            key=lambda kv: -kv[1][0])]

    def add(groups, key, e):
        acc = groups.setdefault(key, [0.0, 0])
        acc[0] += e["dur"]
        acc[1] += 1

    by_kernel: dict[str, list] = {}
    by_op: dict[str, list] = {}
    op_of = {e["args"]["External id"]: e["name"] for e in events
             if e.get("cat") == "cpu_op"
             and "External id" in e.get("args", {})}
    for e in kernels:
        add(by_kernel, e["name"], e)
        op = op_of.get(e.get("args", {}).get("External id"))
        if op is not None:
            add(by_op, op, e)
    out = {"kernels": len(kernels), "busy_ms": busy / 1e3,
           "span_ms": span_us / 1e3,
           "idle_share": 1.0 - busy / span_us if span_us > 0 else None,
           "by_kernel": rows(by_kernel)[:top], "by_op": rows(by_op)[:top]}
    if named:
        out["named"] = {}
        for label, parts in named.items():
            hit = [e for e in kernels if any(p in e["name"] for p in parts)]
            us = sum(e["dur"] for e in hit)
            out["named"][label] = {"ms": us / 1e3, "launches": len(hit),
                                   "share": us / busy if busy else None}
    return out
