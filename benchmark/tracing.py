"""The one reader of a ``torch.profiler`` chrome trace in the benchmark.

Its busy-time arithmetic (the union of kernel intervals, each kernel tied
to the operator that launched it by its ``External id``) is a frozen copy of
the program's ``utils/timer.py::kernel_split``. Unlike that function it
measures idle time over the traced window's wall, marked by the
``WINDOW`` annotation the harness records, so host time before the first
kernel and after the last one counts; and it says what the host was doing
in each idle gap.

The harness starts and stops the profiler with the card idle, around the
traced slice alone, so every kernel of the trace is the slice's and counts
in full: its time is a difference of two of the card's stamps, whatever
their clock. That clock may sit off the host's (on the H100 from 5.3 ms
early to ~1.25 s late over a slice of 3 s), so the kernels are placed by
their launches: each kernel is tied to the host's launch call (the
``LaunchKernel`` calls of the runtime and the driver) by ``correlation``,
and every kernel is moved back by the card clock's offset, the least time
from a launch call's start to its kernel's. After a blocking read the
card's queue is empty, so on a clock that keeps to the host's that offset
is the launch latency, a few us. A launch call of the window with no
kernel means the profiler lost records, and the slice's kernel time is
short: it drops a kernel whose stamps fall outside its session, so the
harness keeps the session open, the card idle, for a while on each side
of the window (``benchmark/run.py`` ``TRACE_PAD_S``).
"""

from __future__ import annotations

import bisect
import json
import re

#: the ``record_function`` name the harness puts around the traced slice
WINDOW = "bench.window"
#: the label of a gap or kernel no operator accounts for
NO_OP = "host (no operator)"
#: the categories of the host's calls into CUDA, and the part of the name
#: of those that launch a kernel
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH = "LaunchKernel"


def short_kernel(name: str) -> str:
    """A kernel's name without its return type, namespace or template and
    argument lists."""
    bare = re.sub(r"^void |\(anonymous namespace\)::", "", name)
    bare = re.split(r"[<(]", bare, maxsplit=1)[0]
    return bare.rsplit("::", 1)[-1] or name


def _correlation(e: dict):
    return e.get("args", {}).get("correlation")


class Trace:
    """The kernels, operators and window of one chrome trace, the kernels
    whole and placed by their launches; ``base_ns`` is the trace's
    ``baseTimeNanoseconds`` where it records one."""

    def __init__(self, events: list[dict], base_ns: int | None = None):
        self.base_ns = base_ns
        kernels = [e for e in events if e.get("cat") == "kernel"]
        launches = [e for e in events if e.get("cat") in LAUNCH_CATS
                    and LAUNCH in e.get("name", "")]
        # the latest launch call of each correlation, and each kernel's
        # start after it
        launched: dict = {}
        for e in launches:
            c = _correlation(e)
            if c is not None:
                launched[c] = max(launched.get(c, e["ts"]), e["ts"])
        after = [e["ts"] - launched[c] for e in kernels
                 if (c := _correlation(e)) in launched]
        #: us the card's clock runs after the host's (None: no kernel is
        #: tied to its launch, and none is moved)
        self.clock_offset_us = min(after) if after else None
        shift = self.clock_offset_us or 0.0
        self.kernels = [dict(e, ts=e["ts"] - shift) for e in kernels]
        self.kernels_without_launch = len(kernels) - len(after)
        marks = [e for e in events if e.get("name") == WINDOW
                 and e.get("ph") == "X"]
        if marks:
            self.t0 = min(e["ts"] for e in marks)
            self.t1 = max(e["ts"] + e["dur"] for e in marks)
        else:
            self.t0 = min((e["ts"] for e in self.kernels), default=0.0)
            self.t1 = max((e["ts"] + e["dur"] for e in self.kernels),
                          default=0.0)
        ran = {_correlation(e) for e in kernels}
        self.launches_without_kernel = len(
            {_correlation(e) for e in launches
             if self.t0 <= e["ts"] <= self.t1} - ran - {None})
        self.ops = [e for e in events if e.get("cat") == "cpu_op"]
        self._op_of = {e["args"]["External id"]: e for e in self.ops
                       if "External id" in e.get("args", {})}

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            doc = json.load(f)
        return cls(doc["traceEvents"], doc.get("baseTimeNanoseconds"))

    @property
    def complete(self) -> bool:
        """Whether every launch call of the window has its kernel."""
        return self.launches_without_kernel == 0

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the kernels' intervals, in microseconds."""
        out: list[list[float]] = []
        for start, end in sorted((e["ts"], e["ts"] + e["dur"])
                                 for e in self.kernels):
            if out and start <= out[-1][1]:
                out[-1][1] = max(out[-1][1], end)
            else:
                out.append([start, end])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    @property
    def idle_share(self) -> float | None:
        """The share of the window's wall in which no kernel ran."""
        return 1.0 - self.busy_s / self.window_s if self.t1 > self.t0 \
            else None

    def op_of(self, kernel: dict) -> dict | None:
        """The operator whose launch the kernel carries, if the trace links
        it."""
        return self._op_of.get(kernel.get("args", {}).get("External id"))

    def kernel_s(self, pred) -> float:
        """Device seconds of the kernels for which ``pred(kernel, op)``
        holds (``op`` None where the trace links no operator)."""
        return sum(e["dur"] for e in self.kernels
                   if pred(e, self.op_of(e))) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """The ``top`` (operator: kernel) pairs by device seconds."""
        acc: dict[str, float] = {}
        for e in self.kernels:
            op = self.op_of(e)
            label = (f"{op['name']}: " if op else "") + short_kernel(e["name"])
            acc[label] = acc.get(label, 0.0) + e["dur"] / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                ][:top]

    def _top_level_ops(self) -> list[dict]:
        """Operators not inside another operator of their thread."""
        out = []
        by_tid: dict = {}
        for e in self.ops:
            by_tid.setdefault(e.get("tid"), []).append(e)
        for evs in by_tid.values():
            end = -float("inf")
            for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
                if e["ts"] >= end:
                    out.append(e)
                    end = e["ts"] + e["dur"]
        return sorted(out, key=lambda e: e["ts"])

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle seconds of the window by what the host was doing: each gap
        between busy intervals goes to the top-level operator that overlaps
        it most, or to :data:`NO_OP`."""
        busy = self.busy_intervals()
        edges = [min(max(x, self.t0), self.t1)
                 for x in [self.t0, *(x for iv in busy for x in iv), self.t1]]
        ops = self._top_level_ops()
        starts = [e["ts"] for e in ops]
        longest = max((e["dur"] for e in ops), default=0.0)
        acc: dict[str, float] = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            overlap: dict[str, float] = {}
            i = bisect.bisect_left(starts, a - longest)
            while i < len(ops) and ops[i]["ts"] < b:
                e = ops[i]
                o = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
                if o > 0:
                    overlap[e["name"]] = overlap.get(e["name"], 0.0) + o
                i += 1
            label = max(overlap, key=overlap.get) if overlap else NO_OP
            acc[label] = acc.get(label, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(acc.items(), key=lambda kv: -kv[1])
                ][:top]

    def op_calls(self, name: str) -> list[tuple[dict, float]]:
        """Each call of operator ``name`` that launched kernels, with its
        kernels' device seconds."""
        secs: dict = {}
        for e in self.kernels:
            op = self.op_of(e)
            if op is not None and op["name"] == name:
                key = op["args"]["External id"]
                secs[key] = secs.get(key, 0.0) + e["dur"] / 1e6
        return [(self._op_of[key], s) for key, s in secs.items()]
