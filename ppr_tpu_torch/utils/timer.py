"""Phase timing and device profiling — port of ``ppr_tpu/utils/timer.py``.

:class:`PhaseTimer` accumulates named phases on the host clock (the
reference's ``System.nanoTime()`` bracketing, Gen_Util.java:148-151); a
phase that names a CUDA tensor waits for its card first, since PyTorch
returns before the device finishes. :func:`trace` wraps ``torch.profiler``
and writes a chrome trace, in place of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
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
