"""Device picoseconds of K3, the program's segmented gather-sum over the
tail edges (``csrc/row_gather.cu``, kernels named ``ppr_gather*``), an
edge and column swept: its device time in the traced slice over the
program's counter ``loop.edge_cols``, the annealed loop's sweeps times the
tail's edges times the columns (``benchmark/spans.py``)."""

from benchmark import spans


def read(ctx):
    c = spans.counter("loop.edge_cols")
    if ctx.trace is None or not c or not c[0]:
        return None
    s = ctx.trace.kernel_s(lambda k, op: "ppr_gather" in k["name"])
    return s / c[0] * 1e12 if s > 0 else None
