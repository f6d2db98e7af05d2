"""Device microseconds a query of the annealed loop's dangling mass (each
sweep's gather, scale and sum over the dangling rows, ``models/fora.py``),
over the queries traced: the kernels whose operators the host called
inside the program's ``loop.dangling_mass`` spans. The spans sit on the
trace's host clock by :func:`benchmark.spans.base_ns`, as the operators
do, and enclose them (each span's stamps lie inside its profiler range).
A graph without dangling nodes (the counter ``loop.dangling_cols`` 0) and
a program without the span or the counter read None."""

import bisect

from benchmark import spans

#: the program's span around one sweep's dangling mass
SPAN = "loop.dangling_mass"


def read(ctx):
    q = ctx.record.queries_traced
    cols = spans.counter("loop.dangling_cols")
    if ctx.trace is None or not q or not cols or not cols[0]:
        return None
    recorded = spans.spans()
    base = spans.base_ns(ctx.trace, recorded)
    if base is None:
        return None
    ivs = sorted(((s.start_ns - base) / 1e3, (s.end_ns - base) / 1e3)
                 for s in recorded if s.name == SPAN)
    starts = [a for a, _ in ivs]

    def inside(kernel, op) -> bool:
        if op is None:
            return False
        i = bisect.bisect_right(starts, op["ts"]) - 1
        return i >= 0 and op["ts"] + op["dur"] <= ivs[i][1]

    s = ctx.trace.kernel_s(inside)
    return s / q * 1e6 if s > 0 else None
