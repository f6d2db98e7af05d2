"""Run one cell of ``BENCHMARK.json`` once on the card.

    python3 benchmark/run.py --workload flickr.batch --seed 7 --seconds 30 \\
        --trace 0

It makes the cell's graph and traffic from ``--seed``, builds the program's
service on it, warms every shape the traffic uses, measures for
``--seconds``, checks the answers that the timed path returned against the
plain reference (``reference.py``), and prints one JSON line last on
standard output. ``--trace 1`` profiles a slice (batches 1-3 of a closed
loop's window; 3 s of an open loop's arrivals after its window, from an
idle server; where the profiler lost records of it, the next such slice,
up to three) and reports the per-layer metrics instead of the end-to-end
ones. Without a CUDA card
(or with fewer than the cell asks for) it exits 2 and prints no result; it
never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import graphgen, reference, spans, traffic  # noqa: E402
from benchmark.manifest import Manifest, load_metric  # noqa: E402
from benchmark.tracing import WINDOW, Trace  # noqa: E402

#: top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "ppr_tpu")
#: answers of the window that the check compares, drawn from the seed
SAMPLE = 128
#: the traced slice: batches of a closed loop, seconds of an open one
TRACE_BATCHES = 3
TRACE_SECONDS = 3.0
#: slices tried before one that lost records is kept
TRACE_TRIES = 3
#: seconds the profiler runs on the card, the card idle, before the
#: slice's window and after it: the profiler drops a kernel whose stamps
#: fall outside its session, and the card's clock has sat off the host's
#: by up to ~1.25 s (late)
TRACE_PAD_S = 2.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is one of
    :data:`FORBIDDEN`."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def rngs(seed: int):
    """The traffic's and the check's generators, independent streams of
    the seed (the graph uses the seed itself)."""
    s = int(seed) % (1 << 63)
    return np.random.default_rng([s, 1]), np.random.default_rng([s, 2])


class Tracer:
    """``torch.profiler`` over a slice of the window, the slice marked by
    the :data:`~benchmark.tracing.WINDOW` annotation. A slice whose trace
    lost records is traced anew, :data:`TRACE_TRIES` slices at most: the
    tracer is ``done`` once it keeps one."""

    def __init__(self, device: torch.device, batches: int = TRACE_BATCHES,
                 seconds: float = TRACE_SECONDS):
        self.device = device
        self.batches, self.seconds = batches, seconds
        self.on = self.done = False
        self.slices = 0
        self.trace: Trace | None = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _pad(self):
        if self.device.type == "cuda":
            time.sleep(TRACE_PAD_S)

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts, record_shapes=True)

    def warm(self):
        """Start and stop the profiler once, so that its first start (the
        device tracer's set-up, seconds on the card) is paid in set-up."""
        with self._profile():
            torch.ones(1, device=self.device).add_(1)
            self._sync()

    def start(self):
        """Open a slice: the program's recorder emptied, so that its spans
        and counters are the slice's, the profiler started, the card idle
        and, on the card, :data:`TRACE_PAD_S` waited."""
        from torch.profiler import record_function

        rec = spans.recorder()
        if rec is not None:
            rec.clear()
        self.slices += 1
        self._prof = self._profile()
        self._prof.start()
        self._sync()
        self._pad()
        self._mark = record_function(WINDOW)
        self._mark.__enter__()
        self.on = True

    def stop(self):
        """Close the slice with the card idle, on the card wait
        :data:`TRACE_PAD_S`, stop the profiler and read its trace; keep it
        where it holds a kernel for every launch call of the slice, or
        where it is the last slice to try."""
        self._sync()
        self._mark.__exit__(None, None, None)
        self._pad()
        self._prof.stop()
        self.on = False
        self.trace = self._read()
        lost = self.trace.launches_without_kernel
        if lost:
            log(f"trace: slice {self.slices} lost records: {lost} launch "
                f"call(s) without a kernel")
        self.done = not lost or self.slices >= TRACE_TRIES

    def read(self) -> Trace | None:
        """The kept slice's trace."""
        return self.trace if self.done else None

    def _read(self) -> Trace:
        tmp = tempfile.mkdtemp(prefix="ppr-bench-trace-")
        try:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            return Trace.load(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)


def build_service(cfg: dict, src, dst, device):
    """The program's service on the cell's graph, as the configuration
    states it; returns it and the seconds each step took."""
    from ppr_tpu_torch.graph.csr import build_graph
    from ppr_tpu_torch.graph.io import Dataset
    from ppr_tpu_torch.service import PPRService

    eng = cfg["engine"]
    t = time.perf_counter()
    g = build_graph(src, dst, n=cfg["nodes"], device=device)
    ds = Dataset(graph=g, names=[str(i) for i in range(cfg["nodes"])],
                 name=cfg["name"])
    t_graph = time.perf_counter() - t
    t = time.perf_counter()
    svc = PPRService(ds, alpha=eng["alpha"], eps=eng["eps"], k=eng["k"],
                     hub_split=eng["hub_split"],
                     hub_dtype=getattr(torch, eng["hub_dtype"]))
    return svc, {"graph_s": t_graph, "service_s": time.perf_counter() - t}


def end_to_end_value(name: str, rec: traffic.Record, setup_s: float):
    """The value of end-to-end metric ``name`` from the window's record."""
    if name == "setup_s":
        return setup_s
    if name == "topk_qps":
        return rec.completed / rec.window_s
    m = re.fullmatch(r"served_p(\d+)_ms", name)
    if m:
        xs = sorted(rec.latency_ms + [math.inf] * rec.failed)
        if not xs:
            return None
        # nearest rank over every measured request, failures as infinite
        i = max(0, math.ceil(int(m.group(1)) / 100.0 * len(xs)) - 1)
        return xs[i]
    raise KeyError(f"no end-to-end metric named {name!r}")


def sample(rec: traffic.Record, rng, size: int = SAMPLE) -> list:
    """The answers the check compares: drawn from the seed, with the
    slowest request of an open loop among them."""
    idx = set(rng.choice(len(rec.answers), size=min(size, len(rec.answers)),
                         replace=False).tolist()) if rec.answers else set()
    if rec.latency_ms:
        idx.add(int(np.argmax(rec.latency_ms)))
    return [rec.answers[i] for i in sorted(idx)]


def finite(x):
    """``x``, an infinite reading as the largest float (JSON has no
    infinity)."""
    return x if math.isfinite(x) else sys.float_info.max


def checks(rec: traffic.Record, worst: dict) -> dict:
    numbers = {"failed": rec.failed, **worst}
    return {k: {"value": finite(v), "limit": reference.LIMITS[k]}
            for k, v in numbers.items()}


class _NoCollector:
    """The cyclic garbage collector off through the window, as ``timeit``
    has it, the set-up's objects frozen first: a full collection over the
    answers the harness keeps would stall the program's threads for the
    harness's sake."""

    def __enter__(self):
        gc.collect()
        gc.freeze()
        gc.disable()

    def __exit__(self, *exc):
        gc.enable()
        gc.unfreeze()


@dataclasses.dataclass
class Measured:
    """One window of a cell, its program freed: what the report and the
    check read."""

    cfg: dict
    src: np.ndarray
    dst: np.ndarray
    rec: traffic.Record
    setup_s: float
    peak: int
    trace: Trace | None
    trace_slices: int
    check_rng: np.random.Generator


def start_server(svc, mix: dict):
    """The program's serving layer as the open mix states it, every rung
    up to its ``max_batch`` prewarmed."""
    from ppr_tpu_torch.serving import PPRBatchServer

    return PPRBatchServer(svc, max_batch=int(mix["max_batch"]),
                          prewarm=True)


def measure(man: Manifest, workload: str, seed: int, seconds: float,
            trace: bool, device: torch.device,
            t_start: float = T_START) -> Measured:
    """Set up ``workload`` from ``seed``, warm it, run its window, and free
    the program; ``t_start`` is when set-up began."""
    cell = man.cell(workload)
    cfg, mix = man.config(cell), man.traffic(cell)
    traffic_rng, check_rng = rngs(seed)
    t = time.perf_counter()
    src, dst = graphgen.draw(cfg, seed)
    setup = {"generate_s": time.perf_counter() - t}
    log("graph: " + json.dumps(graphgen.degree_summary(src, cfg["nodes"],
                                                       dst)))
    svc, steps = build_service(cfg, src, dst, device)
    setup.update(steps)
    tracer = Tracer(device) if trace else None
    if tracer is not None:
        tracer.warm()
    n = cfg["nodes"]
    t = time.perf_counter()
    server = None
    window = _NoCollector()
    if mix["kind"] == "batch":
        # the one shape of the window, twice: first calls, then warm
        warm_rng = np.random.default_rng([int(seed) % (1 << 63), 3])
        for _ in range(2):
            svc.top_k(traffic.sources(warm_rng, n, int(mix["batch"])))
        setup["warm_s"] = time.perf_counter() - t
        with window:
            rec = traffic.run_batch(svc, mix, n, traffic_rng, seconds,
                                    tracer)
    elif mix["kind"] == "open":
        server = start_server(svc, mix)
        setup["warm_s"] = time.perf_counter() - t
        with window:
            rec = traffic.run_open(server, mix, n, traffic_rng, seconds)
            if tracer is not None:
                traffic.trace_open(server, mix, n, traffic_rng, tracer)
        server.close()
    else:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    trace_obj = tracer.read() if tracer is not None else None
    del svc, server
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    setup_s = rec.first_t - t_start
    log(f"setup {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f}" for k, v in setup.items()))
    log(f"window {rec.window_s:.3f} s: attempted {rec.attempted}, "
        f"completed {rec.completed}, failed {rec.failed}; "
        + ", ".join(f"{k} {v}" for k, v in rec.notes.items()
                    if k != "errors"))
    for err in rec.notes.get("errors", [])[:5]:
        log(f"error: {err}")
    if rec.counters:
        log("server counters over the window: " + json.dumps(rec.counters))
    return Measured(cfg, src, dst, rec, setup_s, int(peak), trace_obj,
                    tracer.slices if tracer is not None else 0, check_rng)


def run_cell(man: Manifest, workload: str, seed: int, seconds: float,
             trace: bool, device: torch.device,
             t_start: float = T_START) -> dict:
    """One run of ``workload``; returns the result line's object."""
    m = measure(man, workload, seed, seconds, trace, device, t_start)
    rec, trace_obj, eng = m.rec, m.trace, m.cfg["engine"]
    metrics = {}
    if trace_obj is not None:
        log(f"trace: busy {trace_obj.busy_s} s of a window of "
            f"{trace_obj.window_s} s; card clock offset "
            f"{trace_obj.clock_offset_us} us; "
            f"{trace_obj.launches_without_kernel} launch call(s) without a "
            f"kernel, {trace_obj.kernels_without_launch} kernel(s) without "
            f"a launch call; {m.trace_slices} slice(s)")
        if trace_obj.clock_offset_us is None:
            log("trace: no kernel is tied to its launch call: kernels left "
                "on the card's clock")
        if not trace_obj.complete:
            log(f"trace: every one of {m.trace_slices} slices lost records: "
                "no reading from the trace")
    # an incomplete trace's kernel time is short: nothing reads it
    ctx = types.SimpleNamespace(
        trace=trace_obj if trace_obj is not None and trace_obj.complete
        else None, record=rec)
    for spec in (man.per_layer(workload) if trace
                 else man.end_to_end(workload)):
        value = (load_metric(spec["name"]).read(ctx) if trace
                 else end_to_end_value(spec["name"], rec, m.setup_s))
        if value is not None:
            metrics[spec["name"]] = {"value": finite(value),
                                     "unit": spec["unit"]}
    log("metrics: " + json.dumps(metrics))

    t = time.perf_counter()
    op = reference.Operator(m.src, m.dst, m.cfg["nodes"], device)
    worst = reference.judge(sample(rec, m.check_rng), op, eng["alpha"],
                            eng["k"], eng["eps"])
    log(f"reference check {time.perf_counter() - t:.3f} s")
    checked = checks(rec, worst)
    correct = all(c["value"] <= c["limit"] for c in checked.values())

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": m.peak}
    out = {"correct": correct, "attempted": rec.attempted,
           "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace_obj is not None:
        dev["busy_s"] = trace_obj.busy_s
        dev["window_s"] = trace_obj.window_s
        dev["clock_offset_us"] = trace_obj.clock_offset_us
        dev["launches_without_kernel"] = trace_obj.launches_without_kernel
        dev["kernels_without_launch"] = trace_obj.kernels_without_launch
        dev["trace_slices"] = m.trace_slices
        out["breakdown"] = {"device_ops": trace_obj.device_ops(),
                            "idle_gaps": trace_obj.idle_gaps()}
    out["checks"] = checked
    for k, v in checked.items():
        log(f"check {k}: {v['value']} (limit {v['limit']})")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    man = Manifest()
    cell = man.cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        log(f"{args.workload} needs {cell['chips']} CUDA card(s); "
            f"this process sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    device = torch.device("cuda", 0)
    out = run_cell(man, args.workload, args.seed, args.seconds,
                   bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        log(f"refusing to report: loaded {bad}")
        return 3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
