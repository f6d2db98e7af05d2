"""Device microseconds a query of the annealed loop's passes over the
``[n_pad, B]`` state: the kernels that its elementwise operators and its
column and stopping-count reductions launched, tied to them by the trace's
links, over the queries traced."""

#: the operators of the loop's state passes (``models/fora.py``)
OPS = {"aten::mul", "aten::mul_", "aten::where", "aten::addcmul",
       "aten::addcmul_", "aten::ge", "aten::copy_", "aten::sum"}


def read(ctx):
    q = ctx.record.queries_traced
    if ctx.trace is None or not q:
        return None
    s = ctx.trace.kernel_s(lambda k, op: op is not None and op["name"] in OPS)
    return s / q * 1e6 if s > 0 else None
