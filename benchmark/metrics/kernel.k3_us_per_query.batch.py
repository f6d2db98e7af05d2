"""Device microseconds a query of K3, the program's segmented gather-sum
over the tail edges (``csrc/row_gather.cu``, kernels named
``ppr_gather*``), over the queries traced."""


def read(ctx):
    q = ctx.record.queries_traced
    if ctx.trace is None or not q:
        return None
    s = ctx.trace.kernel_s(lambda k, op: "ppr_gather" in k["name"])
    return s / q * 1e6 if s > 0 else None
