"""Timing on a CUDA card, for the scripts that measure the port
(``chip_smoke.py``, ``row_gather_ablation.py``, ``dense_power_ablation.py``).

A call at a small shape costs the host more than the card, so three clocks
are kept apart: :func:`cuda_ms` (one call between two CUDA events: the
host's time to make it is inside), :func:`host_us` (a host clock over
un-synchronised calls) and :func:`graph_ms` (the launches captured once and
replayed as one CUDA graph: no host time inside). :func:`l2_flusher` makes
a kernel's operands cold, as a caller's other passes leave them.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np
import torch


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` gives them:
    the line that stands beside every kept time."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 10, before=None) -> float:
    """Median milliseconds of ``runs`` calls, each between CUDA events,
    after one warm-up call. ``before`` runs ahead of each timed call,
    outside its events (an L2 flush). At a small shape the host's time to
    make the call is inside the events: ``host_us`` and ``graph_ms`` tell
    the two apart."""
    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if before is not None:
            before()
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def l2_flusher(dev):
    """A function that overwrites 64 MB on the card, more than its 50 MB
    L2: what a caller's other passes leave of a kernel's operands."""
    return torch.empty(64 * 2**20, dtype=torch.uint8, device=dev).zero_


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds a call: a host clock over ``calls``
    un-synchronised calls, then one synchronise. It is the time the host
    needs to enqueue the work, as long as the card keeps up."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def graph_ms(fn, launches: int, before=None, replays: int = 5) -> float:
    """Device milliseconds a call: ``launches`` calls of ``fn`` captured
    once in a CUDA graph and replayed, the median of ``replays`` replays
    over ``launches``; no host time is inside. With ``before`` (an L2
    flush) each captured call follows one ``before()``, and the time of a
    graph of the ``before()`` calls alone is taken off."""
    def replay_ms(body) -> float:
        body()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(launches):
                body()
        ms = cuda_ms(graph.replay, runs=replays)
        del graph
        return ms

    if before is None:
        return replay_ms(fn) / launches

    def both():
        before()
        fn()
    return (replay_ms(both) - replay_ms(before)) / launches
