#!/usr/bin/env python3
"""The hub-count and batch knee at the 1M-node cell on one NVIDIA card —
port of ``scripts/scale_1m_knee.py``.

On ``scale_1m_torch.py``'s graph (``synthetic_powerlaw(2**20, 8, seed=11,
dense_threshold=0)``) it sweeps every batch B of ``--batches`` and hub
count H of ``--hubs`` (bf16 hubs, ``ForaTopk(push="none")``), plus the
automatic rule's count: a warm-up call, then the median of ``--reps`` timed
``compute_topk_ids_batch`` calls (``hub_knee_torch.topk_point``: qps,
sweeps, ms a sweep, peak device memory, tail edges, hub-edge cover). Each
point is appended to the artifact as it finishes.

A point the card cannot hold raises ``torch.cuda.OutOfMemoryError``: it is
recorded with the bytes the allocator was asked for and what it held, and
the cache is emptied before the next point. Those points are the batch
ceiling, which is a result of the sweep. Any other exception ends the run.

``--db SPEC`` sweeps the graph ``cli.load_dataset`` loads for SPEC in
place of ``--n/--deg/--seed``'s (``hub_knee_torch.load``); the artifact's
``graph`` records the operator that ran.

    python3 scale_1m_knee_torch.py [--db SPEC] [--out FILE]

Runs on the card; ``--device cpu`` runs on the CPU (small ``--n``, tests),
and without a card it exits 1. It writes
``results/scale_1m_knee_h100.json``, or
``results/scale_1m_knee_<db>_h100.json`` for a ``--db`` run.
"""

from __future__ import annotations

import argparse
import json
import re
import sys

import numpy as np

PROG = "scale_1m_knee_torch"


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--deg", type=int, default=8)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--batches", default="256,512,1024,1536,2048")
    ap.add_argument("--hubs", default="256,512,768,1024,1920,4096,8192")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--db", default=None, metavar="SPEC",
                    help="load this dataset (cli.load_dataset) in place of "
                         "--n/--deg/--seed's graph")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="default results/scale_1m_knee_h100.json, or "
                         "results/scale_1m_knee_<db>_h100.json with --db")
    args = ap.parse_args(argv)
    if args.out is None:
        from ppr_tpu_torch.utils.drivers import default_out

        args.out = default_out("scale_1m_knee", args.db)
    return args


def oom_row(batch: int, hubs: int, err: Exception, dev) -> dict:
    """The record of a point the card could not hold: the allocation asked
    for (from the allocator's message) and the memory held then."""
    import torch

    from ppr_tpu_torch.utils.drivers import peak_gb

    msg = str(err)
    asked = re.search(r"Tried to allocate ([0-9.]+) (GiB|MiB|KiB|B)", msg)
    scale = {"GiB": 2**30, "MiB": 2**20, "KiB": 2**10, "B": 1}
    return {"batch": batch, "hubs": hubs, "qps": 0.0, "oom": True,
            "asked_bytes": (float(asked.group(1)) * scale[asked.group(2)]
                            if asked else None),
            "allocated_gb": (torch.cuda.memory_allocated(dev) / 1e9
                             if dev.type == "cuda" else None),
            "peak_gb": peak_gb(dev),
            "error": f"{type(err).__name__}: {msg[:240]}"}


def run(args) -> dict:
    """Sweep the points, appending each to ``args.out`` as it finishes;
    returns the record."""
    import torch

    from hub_knee_torch import ALPHA, ints, load, topk_point
    from ppr_tpu_torch.device import resolve_device
    from ppr_tpu_torch.models.fora import ForaTopk
    from ppr_tpu_torch.ops.hub_split import auto_num_hubs
    from ppr_tpu_torch.utils.drivers import (describe, graph_record,
                                             reset_peak, write_json)

    dev = resolve_device(args.device)
    ds, db = load(args, dev)
    g = ds.graph
    rule = auto_num_hubs(g, torch.bfloat16)
    state = {"db": db, "graph": graph_record(g),
             "device": describe(dev), "k": args.k, "eps": args.eps,
             "reps": args.reps, "auto_hubs": rule, "rows": []}
    print(f"[{PROG}] {state['db']} n={g.n} m={g.m} on "
          f"{state['device']['card']}; the rule's count: {rule}", flush=True)
    rng = np.random.default_rng(0)
    for b in ints(args.batches):
        sources = rng.integers(0, g.n, size=b)
        for h in sorted(set(ints(args.hubs)) | {rule}):
            fora = None
            reset_peak(dev)
            try:
                fora = ForaTopk(ds, ALPHA, args.k, push="none")
                fora.enable_hub_split(h, dtype=torch.bfloat16)
                row = topk_point(fora, sources, args.k, args.eps,
                                 args.reps, dev)
            except torch.cuda.OutOfMemoryError as err:
                row = oom_row(b, h, err, dev)
            row["rule"] = h == rule
            fora = None
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            state["rows"].append(row)
            fitted = [r for r in state["rows"] if not r.get("oom")]
            state["best"] = max(fitted, key=lambda r: r["qps"],
                                default=None)
            write_json(args.out, state)
            print(json.dumps(row), flush=True)
    ceiling = {}
    for h in sorted({r["hubs"] for r in state["rows"]}):
        fits = [r["batch"] for r in state["rows"]
                if r["hubs"] == h and not r.get("oom")]
        ceiling[str(h)] = max(fits, default=None)
    state["batch_ceiling"] = ceiling
    knee = {}
    for b in ints(args.batches):
        fitted = [r for r in state["rows"]
                  if r["batch"] == b and not r.get("oom")]
        if fitted:
            best = max(fitted, key=lambda r: r["qps"])
            at_rule = next((r for r in fitted if r["rule"]), None)
            knee[str(b)] = {
                "knee_hubs": best["hubs"], "knee_qps": best["qps"],
                "rule_hubs": rule,
                "rule_qps": at_rule["qps"] if at_rule else None,
                "rule_qps_lost": (best["qps"] - at_rule["qps"]
                                  if at_rule else None)}
    state["knee"] = knee
    write_json(args.out, state)
    return state


def main(argv=None) -> int:
    from ppr_tpu_torch.utils.drivers import no_card

    args = parse_args(argv)
    if no_card(args.device, PROG):
        return 1
    state = run(args)
    print(f"[{PROG}] batch ceiling by hub count {state['batch_ceiling']}; "
          f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
