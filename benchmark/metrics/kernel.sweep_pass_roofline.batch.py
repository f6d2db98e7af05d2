"""K5's share of its roofline: the least time of the bytes that the
annealed loop's fused passes over its ``[n_pad, B]`` state move, at the
memory's peak (``benchmark/peaks.py``), over the device time of the
kernels named ``ppr_sweep*`` (``csrc/sweep_pass.cu``) in the traced
slice. The elements come from the program's counters ``loop.state_elems``
(sweeps launched x ``n_pad`` x columns) and ``loop.bf16_copy_elems`` (the
same where the pre pass writes the bf16 copy, else 0), the bytes from
:func:`state_bytes`. A program without the counters reads None."""

from benchmark import peaks, spans

#: bytes an element of the state that the pre pass moves: it reads ``p``
#: and ``r`` and writes ``p`` and ``scaled``, f32 each (4.0 passes)
PRE_BYTES = 16
#: and the bf16 copy of ``scaled`` it writes for a bf16 hub product (0.5)
BF16_BYTES = 2
#: the post pass reads the push's output once and writes back only the
#: rows where a column's source lies (1.0 pass)
POST_BYTES = 4


def state_bytes(elems: float, bf16_elems: float) -> float:
    """The bytes the pre and post passes move over ``elems`` elements of
    the state, ``bf16_elems`` of them with the bf16 copy. Left out, so
    that the share errs low: ``inv_deg`` (``n_pad`` floats a pre pass), the
    partial counts and sums and the finalize that adds them (each
    ``[grid rows, B]``, under 1% of a pass at B 2,048), and a frozen
    sweep's copy of the old residue (a post pass reads and writes then)."""
    return (PRE_BYTES + POST_BYTES) * elems + BF16_BYTES * bf16_elems


def read(ctx):
    elems = spans.counter("loop.state_elems")
    bf16 = spans.counter("loop.bf16_copy_elems")
    if ctx.trace is None or not elems or not elems[0] or bf16 is None:
        return None
    s = ctx.trace.kernel_s(lambda k, op: "ppr_sweep" in k["name"])
    if s <= 0:
        return None
    return 100.0 * state_bytes(elems[0], bf16[0]) / peaks.PEAK_BYTES / s
