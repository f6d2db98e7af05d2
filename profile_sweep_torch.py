#!/usr/bin/env python3
"""Propagation-sweep variants on one NVIDIA card — port of
``scripts/profile_sweep.py``.

Times the serving path's hot loop, residual-propagation sweeps over the
bench graph (``synthetic_powerlaw(65536, 16, seed=42, dense_threshold=0)``,
~1.04M edges) at B 256, across the push's operators:

* ``plain``: every edge through K3 (``ops/spmv.py``);
* ``hub{H}_f32``: the dense-hub hybrid, an f32 ``[n_pad, H]`` hub matrix
  through ``torch.mm`` and the tail's edges through K3;
* ``hub{H}_bf16``: the same with a bf16 hub matrix;

and the whole annealed top-k loop for ``plain`` and every bf16 variant.
Each timed call follows an untimed first call (``first_call_s``); beside
its host wall stands ``device_ms``, two CUDA events around the same call
(``None`` on the CPU). ``--trace`` traces one more annealed call of each
variant under ``torch.profiler`` and records the device time by kernel,
the busy time, the span and the idle share (``utils/timer.kernel_split``),
with K3 and the hub product named.

    python3 profile_sweep_torch.py [--quick] [--trace]

One JSON line a row, then ``{"summary": ...}``, as the JAX script prints.
The artifact is ``results/profile_sweep_h100.json`` (``--quick`` writes
one only where ``--out`` points). Runs on the card; ``--device cpu`` runs
on the CPU, and without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

PROG = "profile_sweep_torch"
ALPHA, EPS, K = 0.15, 0.25, 10    # eps' = 0.5 / 2, as the serving path uses
TARGET = 1e-6
#: kernel name fragments ``--trace`` sums: K3, and the hub product's GEMM
#: (cuBLAS names its kernels ``gemm``, ``nvjet`` or ``xmma``)
NAMED = {"K3": ("ppr_gather_kernel",),
         "hub mm": ("gemm", "nvjet", "xmma", "cutlass")}
TRACE_DIR = os.path.join("build", "ppr_tpu_torch", "profile_sweep")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--quick", action="store_true",
                    help="n 4096, deg 8, B 32; no artifact unless --out")
    ap.add_argument("--hubs", default="512,2048,4096",
                    help="comma list of hub counts to profile")
    ap.add_argument("--skip-plain", action="store_true")
    ap.add_argument("--skip-f32", action="store_true")
    ap.add_argument("--skip-residual", action="store_true",
                    help="only time the annealed loop")
    ap.add_argument("--trace", action="store_true",
                    help="trace one more annealed call of each variant")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="artifact (default results/profile_sweep_h100.json"
                         "; none with --quick)")
    args = ap.parse_args(argv)
    if args.quick:
        args.n, args.deg, args.batch = 4096, 8, 32
    elif args.out is None:
        args.out = "results/profile_sweep_h100.json"
    return args


def coverage_curve(g, hubs=(256, 512, 1024, 2048, 4096)):
    """The share of in-edges the ``h`` nodes of largest in-degree take, at
    each ``h`` (``scripts/profile_sweep.py::coverage_curve``)."""
    in_deg = g.in_deg[: g.n].cpu().numpy()
    order = np.sort(in_deg)[::-1]
    cum = np.cumsum(order)
    total = max(int(cum[-1]), 1)
    return {int(h): float(cum[min(h, g.n) - 1] / total) for h in hubs}


def build(args, dev):
    """The profiled graph on ``dev``."""
    from ppr_tpu_torch.graph.io import synthetic_powerlaw

    return synthetic_powerlaw(args.n, args.deg, seed=42, dense_threshold=0,
                              device=dev)


def variants(args, g) -> list:
    """``[(name, hub split or None)]`` in the JAX script's order."""
    import torch

    from ppr_tpu_torch.ops.hub_split import build_hub_split

    out = [] if args.skip_plain else [("plain", None)]
    for h in (int(x) for x in args.hubs.split(",") if x):
        for dt in ((torch.bfloat16,) if args.skip_f32 else
                   (torch.float32, torch.bfloat16)):
            name = f"hub{h}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
            out.append((name, build_hub_split(g, h, dtype=dt)))
    return out


def traced(dev, fn, path: str) -> dict:
    """``fn()`` under ``torch.profiler``, its chrome trace at ``path``;
    the trace's kernel split with K3 and the hub product named."""
    from torch.profiler import ProfilerActivity, profile

    from ppr_tpu_torch.device import synchronize
    from ppr_tpu_torch.utils.timer import kernel_split

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    synchronize(dev)
    with profile(activities=activities) as prof:
        fn()
        synchronize(dev)
    prof.export_chrome_trace(path)
    return dict(kernel_split(path, named=NAMED), trace=path)


def run(args, ds=None, keep: dict | None = None) -> dict:
    """The rows and the summary; ``ds`` is the graph when the caller built
    it (``build``). With ``keep``, each annealed variant's final reserve
    ``p`` (``[B, n_pad]`` on the device) is stored under its row's name,
    and the sources and one-hot rows under ``"sources"`` / ``"onehot"``.
    Raises without a card unless ``--device cpu``."""
    import torch

    from ppr_tpu_torch.device import resolve_device
    from ppr_tpu_torch.models import fora
    from ppr_tpu_torch.ops.push import forward_push_init
    from ppr_tpu_torch.utils.drivers import (describe, graph_record,
                                             timed_events)

    dev = resolve_device(args.device)
    if ds is None:
        ds = build(args, dev)
    g = ds.graph
    head = {"device": describe(dev), **graph_record(g), "batch": args.batch,
            "coverage": coverage_curve(g)}
    print(json.dumps(head), flush=True)

    rng = np.random.default_rng(0)
    sources = torch.as_tensor(rng.integers(0, g.n, args.batch),
                              dtype=torch.int32, device=dev)
    p0, r0, onehot = forward_push_init(g, sources)
    if keep is not None:
        keep.update(sources=sources, onehot=onehot)
    todo = variants(args, g)

    def row(name, it, wall, device_ms, first_s, **more):
        rec = {"iters": it, "total_ms": wall * 1e3, "device_ms": device_ms,
               **more, "first_call_s": first_s}
        results[name] = rec
        print(json.dumps({name: rec}), flush=True)

    results, traces = {}, {}
    for name, hs in todo if not args.skip_residual else []:
        def call():
            return fora.residual_propagate(g, p0, r0, onehot, TARGET, ALPHA,
                                           hs=hs)
        _, first_s, _ = timed_events(dev, call)
        (_, _, it), wall, device_ms = timed_events(dev, call)
        row(name, it, wall, device_ms, first_s,
            sweep_ms=wall / max(it, 1) * 1e3,
            sweep_device_ms=(device_ms / max(it, 1)
                             if device_ms is not None else None))

    # the whole annealed serving loop for plain and the bf16 variants
    for name, hs in [(n_, h_) for n_, h_ in todo
                     if n_ == "plain" or "bf16" in n_]:
        tag = f"annealed_{name}"

        def call():
            return fora.annealed_topk_propagate(
                g, torch.zeros_like(p0), r0, onehot, EPS, 1.0 / K,
                1.0 / g.n, K, ALPHA, hs=hs)
        _, first_s, _ = timed_events(dev, call)
        (p, _, it), wall, device_ms = timed_events(dev, call)
        row(tag, int(it), wall, device_ms, first_s, qps=args.batch / wall)
        if keep is not None:
            keep[tag] = p
        del p
        if args.trace:
            traces[tag] = traced(dev, call,
                                 os.path.join(TRACE_DIR, f"{tag}.json"))
            print(json.dumps({tag: {key: traces[tag][key] for key in (
                "kernels", "busy_ms", "span_ms", "idle_share", "named")}}),
                flush=True)

    print(json.dumps({"summary": results}), flush=True)
    out = {**head, "alpha": ALPHA, "eps": EPS, "k": K, "target": TARGET,
           "hubs": [int(x) for x in args.hubs.split(",") if x],
           "summary": results}
    if traces:
        out["traces"] = traces
    return out


def main(argv=None) -> int:
    from ppr_tpu_torch.utils.drivers import no_card, write_json

    args = parse_args(argv)
    if no_card(args.device, PROG):
        return 1
    out = run(args)
    if args.out:
        write_json(args.out, out)
        print(f"[{PROG}] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
