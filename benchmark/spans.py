"""The program's spans and counters (``ppr_tpu_torch/utils/timer.py``)
over the traced slice, and the slice's idle time split by the span the
host was in.

The program records spans and counters only while ``torch.profiler``
runs, so what its recorder holds after a traced run is the traced slice's
(the harness profiles nothing else, and empties the recorder before each
slice it starts). Spans carry ``time.time_ns()`` stamps; the chrome trace
puts a host event at ``ts`` microseconds after its
``baseTimeNanoseconds``, which :func:`base_ns` takes from the trace where
it records one (:meth:`benchmark.tracing.Trace.load`). That base is a whole
number of seconds (read on an H100 under torch 2.11 and on the CPU under
torch 2.13), so without it :func:`base_ns` rounds it from the slice's first
span and the window's start, which lie well under a second apart; a span
then sits on the window's clock as the profiler's own annotations do
(15-20 us after the operator it closes, on the H100).

The card's events are another matter: in traced runs on the H100 their
clock has sat off the host's by 5.3 ms (early), 17.8 ms (late) and ~1.25 s
(late) over a slice of 3-4 s. :class:`~benchmark.tracing.Trace` moves the
kernels back by that offset, read from each kernel's launch call, but a
drift within the slice stays, so no offset lays a span on the kernels to
0.1 ms. The split needs none. Every ``loop.topk`` span ends in a blocking
copy of its result, and outside those spans the program launches nothing
(the hit lists, the futures and batch forming are host work), so while
the host is in a span and outside every ``loop.topk`` the card is idle:
that time is the span's idle time, on the host's clock alone. The trace
gives the slice's whole idle time; the rest of it is reported as
uncovered, and split in turn: the host's time in no span at all (idle
too, on the host's clock) and what is left, the idle time inside
``loop.topk``. :func:`lags` says how far the placed kernels sit from the
host's spans in a run: each host return from a blocking read (the ends of
``loop.check`` and ``loop.topk``) follows the end of a busy interval by
the copy's latency alone where the kernels are placed by their launches,
and by that and the card clock's drift within the slice where not.

A program without the recorder (an older commit) reads as no spans: every
reader here returns None and none raises.
"""

from __future__ import annotations

import bisect
import statistics
import sys

#: spans whose ends are the host's returns from a blocking read
ANCHORS = ("loop.check", "loop.topk")


def recorder():
    """The program's recorder, or None where the program has none."""
    try:
        from ppr_tpu_torch.utils import timer
    except ImportError:
        return None
    rec = getattr(timer, "RECORDER", None)
    return rec if hasattr(rec, "spans") and hasattr(rec, "counters") \
        else None


def counter(name: str):
    """``(sum, count)`` of the program's counter ``name``, or None."""
    rec = recorder()
    if rec is None:
        return None
    c = rec.counters().get(name)
    return c if c is not None and c[1] else None


def spans() -> list:
    """The spans the program recorded, oldest first."""
    rec = recorder()
    return sorted(rec.spans(), key=lambda s: s.start_ns) if rec else []


def _merge(ivs) -> list[list[float]]:
    out: list[list[float]] = []
    for a, b in sorted(ivs):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _intersect(xs, ys) -> list[list[float]]:
    """Two merged interval lists' intersection."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if a < b:
            out.append([a, b])
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(xs, ys) -> list[list[float]]:
    """``xs`` less ``ys``, both merged."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > a:
                out.append([a, ys[k][0]])
            a = max(a, ys[k][1])
            k += 1
        if a < b:
            out.append([a, b])
    return out


def _length(ivs) -> float:
    return sum(b - a for a, b in ivs)


def base_ns(trace, recorded: list) -> int | None:
    """The trace's ``baseTimeNanoseconds``, as the trace records it, or
    else from the spans: the first span starts inside the window, so the
    distance from the window's start rounds down to it, a quarter of a
    second allowed on either side."""
    if not recorded or trace.t1 <= trace.t0:
        return None
    if trace.base_ns is not None:
        return int(trace.base_ns)
    first = min(s.start_ns for s in recorded)
    return ((first - int(trace.t0 * 1e3) + 250_000_000) // 10**9) * 10**9


def lags(trace, recorded: list, base: int) -> dict | None:
    """The us from each host return from a blocking read in the window to
    the busy end before it on the trace's clock: tens to hundreds of us
    where the card's clock keeps to the host's, milliseconds where it
    drifts."""
    ends = [b for _, b in trace.busy_intervals()]
    out = []
    for s in recorded:
        h = (s.end_ns - base) / 1e3
        if s.name in ANCHORS and trace.t0 <= h <= trace.t1:
            i = bisect.bisect_right(ends, h)
            if i:
                out.append(h - ends[i - 1])
    if not out:
        return None
    q = statistics.quantiles(out, n=4) if len(out) > 1 else out * 3
    return {"n": len(out), "median": statistics.median(out), "q1": q[0],
            "q3": q[2], "min": min(out), "max": max(out)}


def _idle_split(trace, recorded: list) -> dict | None:
    if trace is None or not recorded or not trace.kernels:
        return None
    base = base_ns(trace, recorded)
    window = [[trace.t0, trace.t1]]

    def cover(pred):
        return _intersect(_merge(((s.start_ns - base) / 1e3,
                                  (s.end_ns - base) / 1e3)
                                 for s in recorded if pred(s.name)), window)

    loop = cover(lambda n: n == "loop.topk")
    top = cover(lambda n: n == "service.top_k")
    service = _subtract(top, loop)
    serving = _subtract(_subtract(cover(lambda n: n.startswith("serving.")),
                                  top), loop)
    nospan = _subtract(window, cover(lambda n: True))
    out = {"serving": _length(serving) / 1e6,
           "service": _length(service) / 1e6,
           "nospan": _length(nospan) / 1e6,
           "idle": trace.idle_share * trace.window_s,
           "window": trace.window_s, "base_ns": base,
           "lags": lags(trace, recorded, base)}
    out["uncovered"] = out["idle"] - out["serving"] - out["service"]
    out["loop"] = out["uncovered"] - out["nospan"]
    return out


def idle_split(ctx) -> dict | None:
    """The traced slice's idle seconds by the span the host was in:
    ``service`` (in ``service.top_k``, outside ``loop.topk``), ``serving``
    (in a ``serving.*`` span, outside both) and ``uncovered`` (the rest of
    the trace's ``idle``), itself ``nospan`` (the host in no span) and
    ``loop`` (the rest: idle inside ``loop.topk``), with the slice's
    ``window``, the trace's ``base_ns`` and the host returns' ``lags``.
    Computed once a run, and logged."""
    if "_idle_split" in vars(ctx):
        return ctx._idle_split
    ctx._idle_split = out = _idle_split(ctx.trace, spans())
    if out is not None:
        lag = out["lags"]
        print("spans: idle s " + ", ".join(
            f"{k} {out[k]:.6f}" for k in ("serving", "service", "uncovered",
                                          "nospan", "loop", "idle",
                                          "window"))
            + ("; host returns after the busy end before them: "
               f"median {lag['median']:.1f} us (quartiles {lag['q1']:.1f}-"
               f"{lag['q3']:.1f}, min {lag['min']:.1f}, max "
               f"{lag['max']:.1f}, n {lag['n']})" if lag else ""),
            file=sys.stderr)
        if out["loop"] < 0:
            print("spans: the spans' idle time exceeds the trace's: a "
                  "kernel ran outside loop.topk", file=sys.stderr)
    return out


def idle_share(ctx, part: str) -> float | None:
    """``part``'s idle seconds (:func:`idle_split`) in % of the slice's
    wall."""
    if ctx.trace is None:
        return None
    split = idle_split(ctx)
    if split is None or not split["window"]:
        return None
    return 100.0 * split[part] / split["window"]
