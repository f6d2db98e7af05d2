"""The hub product's share of its roofline: the least time of every
``aten::mm`` call in the traced slice at the published peaks
(``benchmark/peaks.py``), over the device time of the kernels the calls
launched. A call's operations are ``2 M N K`` and its bytes each operand
read once and the result written once, from the shapes and types the trace
records; an ``out_dtype`` argument makes the result float32."""

from benchmark import peaks


def least_seconds(args) -> float:
    (m, k), (_, n) = args["Input Dims"][:2]
    types = args["Input type"]
    a, b = peaks.ITEMSIZE[types[0]], peaks.ITEMSIZE[types[1]]
    out = 4 if "ScalarType" in types[2:] else a
    return peaks.least_seconds(2.0 * m * n * k,
                               m * k * a + k * n * b + m * n * out, types[0])


def read(ctx):
    if ctx.trace is None:
        return None
    calls = ctx.trace.op_calls("aten::mm")
    measured = sum(s for _, s in calls)
    if not measured:
        return None
    return 100.0 * sum(least_seconds(op["args"]) for op, _ in calls) \
        / measured
