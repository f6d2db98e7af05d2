"""Sweeps the annealed loop launched a call over the traced slice: the
program's counter ``loop.sweeps`` over its ``loop.topk`` spans
(``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    c = spans.counter("loop.sweeps")
    calls = sum(1 for s in spans.spans() if s.name == "loop.topk")
    return c[0] / calls if c and calls else None
