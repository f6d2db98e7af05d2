"""Device microseconds a query of the annealed loop's whole passes over
the ``[n_pad, B]`` state, however they are launched: the kernels that the
plain operators of ``loop.state_pass_us_per_query.batch`` launched (tied
to them by the trace's links), plus the program's fused pass kernels
(named ``ppr_sweep*``, ``csrc/sweep_pass.cu``), over the queries traced.
On a program without the fused kernels it reads what the older metric
reads."""

#: the plain operators of the loop's state passes (``models/fora.py``)
OPS = {"aten::mul", "aten::mul_", "aten::where", "aten::addcmul",
       "aten::addcmul_", "aten::ge", "aten::copy_", "aten::sum"}


def read(ctx):
    q = ctx.record.queries_traced
    if ctx.trace is None or not q:
        return None
    s = ctx.trace.kernel_s(lambda k, op: "ppr_sweep" in k["name"]
                           or (op is not None and op["name"] in OPS))
    return s / q * 1e6 if s > 0 else None
