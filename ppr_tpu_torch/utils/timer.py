"""Phase timing and device profiling — port of ``ppr_tpu/utils/timer.py``.

:class:`PhaseTimer` accumulates named phases on the host clock (the
reference's ``System.nanoTime()`` bracketing, Gen_Util.java:148-151); a
phase that names a CUDA tensor waits for its card first, since PyTorch
returns before the device finishes. :func:`trace` wraps ``torch.profiler``
and writes a chrome trace, in place of ``jax.profiler``; :func:`kernel_split`
reads the device time out of such a trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating named phase timer; a phase waits for the card of the
    CUDA tensor it names in ``block_on``."""

    def __init__(self):
        self.totals_ns: dict[str, int] = defaultdict(int)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, block_on: torch.Tensor | None = None):
        t0 = time.perf_counter_ns()
        yield
        if block_on is not None and block_on.is_cuda:
            torch.cuda.synchronize(block_on.device)
        self.totals_ns[name] += time.perf_counter_ns() - t0
        self.counts[name] += 1

    def ms(self, name: str) -> float:
        return self.totals_ns[name] / 1e6

    def report(self) -> str:
        lines = [
            f"{name}: {self.ms(name):.3f} ms over {self.counts[name]} calls"
            for name in sorted(self.totals_ns)
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block, CPU and (with a card) CUDA
    activity, written to ``<log_dir>/trace.json`` (chrome format); a no-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
    busy, span = 0.0, 0.0
    for start, end in sorted((e["ts"] - t0, e["ts"] - t0 + e["dur"])
                             for e in kernels):
        busy += max(0.0, end - max(start, span))
        span = max(span, end)

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
           "span_ms": span / 1e3,
           "idle_share": 1.0 - busy / span if span > 0 else None,
           "by_kernel": rows(by_kernel)[:top], "by_op": rows(by_op)[:top]}
    if named:
        out["named"] = {}
        for label, parts in named.items():
            hit = [e for e in kernels if any(p in e["name"] for p in parts)]
            us = sum(e["dur"] for e in hit)
            out["named"][label] = {"ms": us / 1e3, "launches": len(hit),
                                   "share": us / busy if busy else None}
    return out
