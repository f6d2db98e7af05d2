#!/usr/bin/env python3
"""Benchmark of the PyTorch port: FORA top-k queries/sec on one NVIDIA card
against the CPU baseline, as ``bench.py`` measures the JAX package.

Workload (``bench.py``'s): top-k SSPPR at alpha=0.15, eps=0.5, k=10 on the
seeded ~1M-edge graph ``synthetic_powerlaw(65536, 16, seed=42,
dense_threshold=0)``, a batch of 2048 sources, bf16 hubs by ``bench.py``'s
rule (:func:`hub_count`: 4096 at B >= 1024, else the automatic count), the
port's FORA top-k serving path (``ForaTopk`` with ``push="none"``; the tail
through K3). Accuracy is precision@10 against the port's power method
(``power_method_batch``, sparse at this size), with the tie tolerance
eps/n and the dense recompute of rows whose tie set fills the selection
window (``bench.py:226-256``). The CPU baseline is the same algorithm on
scipy sparse + numpy (``ppr_tpu_torch/utils/cpu_fora.py``, a copy of
``bench.CpuFora``).

Runs on the card only: without one it exits 1 (there is no CPU fallback).
Prints the card's name and power limit, then ONE JSON line with
``bench.py``'s keys: {"metric", "value", "unit", "vs_baseline", ...}.

    python3 bench_torch.py [--batch 2048] [--cpu-queries 16]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--alpha", type=float, default=0.15)
    ap.add_argument("--cpu-queries", type=int, default=16)
    ap.add_argument("--acc-queries", type=int, default=32)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--no-hub-split", action="store_true",
                    help="disable the dense-hub hybrid push (default: 4096 "
                         "hubs at B >= 1024, else the automatic count; bf16 "
                         "hub matrix)")
    ap.add_argument("--hub-split", type=int, default=None,
                    help="override the hub count")
    args = ap.parse_args(argv)
    if args.hub_split is not None and args.hub_split <= 0:
        ap.error("--hub-split must be positive; use --no-hub-split to "
                 "disable the hybrid push")
    if args.quick:
        args.n, args.deg, args.batch = 4096, 8, 8
        args.cpu_queries, args.acc_queries = 1, 4
    return args


def hub_count(batch: int, hub_split: int | None = None) -> int | str:
    """``bench.py``'s hub count (``bench.py:212-213``): ``hub_split`` when
    given, else 4096 at B >= 1024 and ``"auto"`` below."""
    if hub_split is not None:
        return hub_split
    return 4096 if batch >= 1024 else "auto"


def run(args) -> dict:
    """The bench's record (``bench.py``'s JSON keys); raises without a
    card."""
    import torch

    from ppr_tpu_torch.device import resolve_device
    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.models import AlgoConf
    from ppr_tpu_torch.models.power_method import power_method_batch
    from ppr_tpu_torch.ops.topk import (topk_ids_with_ties,
                                        topk_ids_with_ties_from_pairs)
    from ppr_tpu_torch.utils.cpu_fora import CpuFora
    from ppr_tpu_torch.utils.metrics import precision_at_k

    dev = resolve_device()
    ds = synthetic_powerlaw(args.n, args.deg, seed=42, dense_threshold=0,
                            device=dev)
    g = ds.graph
    rng = np.random.default_rng(0)
    sources = rng.integers(0, g.n, size=args.batch)

    fora = AlgoConf(args.alpha, seed=7).set_conf_fora_topk(ds, args.k)
    if not args.no_hub_split:
        fora.enable_hub_split(hub_count(args.batch, args.hub_split),
                              dtype=torch.bfloat16)

    # a first call, untimed (allocator growth, the K0 probe, the build of
    # the kernels on a fresh checkout), then the timed one
    fora.compute_topk_ids_batch(sources, args.k, args.eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vals, ids = fora.compute_topk_ids_batch(sources, args.k, args.eps)
    dev_s = time.perf_counter() - t0
    dev_qps = args.batch / dev_s

    # tie tolerance = eps*min_delta: estimates of an exact oracle tie at
    # the k-th value can split by float noise far below the algorithm's
    # eps*delta accuracy bound; the raw (tol=0) sets are also reported
    tie_tol = args.eps * (1.0 / g.n)
    n_acc = min(args.batch, args.acc_queries)
    algo_ids_rows = [
        topk_ids_with_ties_from_pairs(vals[i], ids[i], args.k, tol=tie_tol)
        for i in range(n_acc)
    ]
    algo_ids_rows_raw = [
        topk_ids_with_ties_from_pairs(vals[i], ids[i], args.k)
        for i in range(n_acc)
    ]
    # tie sets that could extend past the device selection window get
    # exact (dense) recomputation so reported recall is never understated
    overflow = [
        i for i in range(n_acc)
        if len(algo_ids_rows[i]) == vals.shape[1] and vals[i][-1] > 0.0
    ]
    if overflow:
        dense_rows = fora.compute_topk_batch(sources[overflow], args.k,
                                             args.eps)
        for j, i in enumerate(overflow):
            algo_ids_rows[i] = topk_ids_with_ties(dense_rows[j], args.k,
                                                  tol=tie_tol)
            algo_ids_rows_raw[i] = topk_ids_with_ties(dense_rows[j], args.k)

    # accuracy vs the power method (100 iterations)
    acc_sources = sources[: args.acc_queries]
    oracle = power_method_batch(g, np.asarray(acc_sources, np.int32),
                                args.alpha, 100).cpu().numpy()
    precs, precs_raw = [], []
    for i in range(min(len(acc_sources), len(algo_ids_rows))):
        gnd = topk_ids_with_ties(oracle[i], args.k)
        precs.append(precision_at_k(algo_ids_rows[i], gnd))
        precs_raw.append(precision_at_k(algo_ids_rows_raw[i], gnd))

    # CPU baseline
    cpu = CpuFora(ds, args.alpha, args.k)
    crng = np.random.default_rng(1)
    t0 = time.perf_counter()
    for s in sources[: args.cpu_queries]:
        cpu.topk(int(s), args.eps, crng)
    cpu_qps = args.cpu_queries / (time.perf_counter() - t0)

    return {
        "metric": "fora_topk_queries_per_sec",
        "value": round(dev_qps, 3),
        "unit": "queries/s",
        "vs_baseline": round(dev_qps / cpu_qps, 3),
        "recall_at_10": round(float(np.mean(precs)), 4),
        "recall_at_10_raw": round(float(np.mean(precs_raw)), 4),
        "acc_queries": len(precs),
        "cpu_queries": args.cpu_queries,
        "cpu_baseline_qps": round(cpu_qps, 3),
        "graph": {"n": g.n, "m": g.m},
        "device": torch.cuda.get_device_name(0),
    }


def main(argv=None) -> int:
    import torch

    args = parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: no CUDA device is visible; the port's bench runs "
              "only on a card", file=sys.stderr)
        return 1
    from ppr_tpu_torch.utils.cuda_timing import card_line

    print(card_line(), flush=True)
    print(json.dumps(run(args)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
