#!/usr/bin/env python3
"""The 1M-node cell on one NVIDIA card — port of ``scripts/scale_1m.py``.

On ``synthetic_powerlaw(2**20, 8, seed=11, dense_threshold=0)`` (1,048,576
nodes, ~8.3M edges, built by the native builder where it is available), it
measures:

* FORA top-k serving (``AlgoConf.set_conf_fora_topk``, the automatic bf16
  hub count) at ``--batch``: qps of one timed call after a warm-up, the
  hub count, the share of edges the hubs carry, sweeps, peak device
  memory;
* recall@10 on ``--acc-queries`` sources against ``power_method_batch``
  (100 iterations), a row whose tie set fills the selection window
  recomputed densely (``compute_topk_batch``);
* FORA whole-graph (the automatic hub count) at ``--wg-batch``: qps,
  each row's mass, whose mean is ``mass_conservation``, and the rows of
  the accuracy sources against the oracle: precision@10 (ties within
  eps/n) and the largest relative error on entries above 1/n, which
  FORA bounds by eps;
* raw walks a second over 2^20 walkers (``weighted_walk_counts``, one
  timed call after a warm-up).

It writes ``results/scale_1m_h100.json`` with the JAX artifact's keys
(``results/scale_1m_nodes.json``) and more. Unlike the JAX script, no phase
catches its own failure: a failure exits non-zero.

``--phase topk|wg|walks`` runs one phase (top-k with its recall oracle,
whole-graph with the same oracle rows, or walks) and merges its keys into
the artifact already at ``--out`` when that artifact's ``n`` and ``m`` are
this graph's; otherwise it writes its own. ``--quick`` is the JAX
script's small run (n 2^14, degree 8, B 16, whole-graph B 4, 2^16
walkers) and writes no artifact.

    python3 scale_1m_torch.py [--batch 256] [--phase P] [--quick] [--out F]

Runs on the card; ``--device cpu`` runs on the CPU (small ``--n``, tests),
and without a card it exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

PROG = "scale_1m_torch"
ALPHA, EPS, K = 0.15, 0.5, 10


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--deg", type=int, default=8)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--acc-queries", type=int, default=4)
    ap.add_argument("--wg-batch", type=int, default=16)
    ap.add_argument("--walkers", type=int, default=1 << 20)
    ap.add_argument("--quick", action="store_true",
                    help="n 2^14, deg 8, B 16, wg-batch 4, 2^16 walkers; "
                         "no artifact")
    ap.add_argument("--phase", default="all",
                    choices=["all", "topk", "wg", "walks"],
                    help="run one phase, merged into the artifact at --out "
                         "when its n and m match")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="results/scale_1m_h100.json")
    args = ap.parse_args(argv)
    if args.quick:
        args.n, args.deg, args.batch, args.wg_batch = 1 << 14, 8, 16, 4
        args.walkers = 1 << 16
    return args


def build(args, dev):
    """The cell's graph on ``dev``."""
    from ppr_tpu_torch.graph.io import synthetic_powerlaw

    return synthetic_powerlaw(args.n, args.deg, seed=args.seed,
                              dense_threshold=0, device=dev)


def run(args, ds=None) -> dict:
    """The cell's record; ``ds`` is the graph when the caller built it
    (``build``). Raises without a card unless ``--device cpu``."""
    return measure(args, ds)[0]


def measure(args, ds=None) -> tuple[dict, np.ndarray | None]:
    """``run``'s record and the oracle rows of its accuracy sources
    (``record["acc_sources"]``), ``[acc, n_pad]`` numpy, for a caller's own
    checks of the oracle (``None`` when ``--phase walks`` needs none)."""
    from ppr_tpu_torch import native
    from ppr_tpu_torch.device import resolve_device
    from ppr_tpu_torch.models import AlgoConf
    from ppr_tpu_torch.models.power_method import power_method_batch
    from ppr_tpu_torch.utils.drivers import describe, timed

    dev = resolve_device(args.device)
    if ds is None:
        ds, build_s = timed(dev, lambda: build(args, dev))
    else:
        build_s = None
    g = ds.graph
    rng = np.random.default_rng(0)
    sources = rng.integers(0, g.n, size=args.batch)
    phases = {"topk", "wg", "walks"} if args.phase == "all" else {args.phase}
    out = {"config": "quick" if args.quick else "1M-node single-host"
           if args.n == 1 << 20 else f"{args.n}-node",
           "n": g.n, "m": g.m, "n_pad": g.n_pad,
           "topk_batch": args.batch, "device": describe(dev),
           "builder": "native" if native.available() else "numpy",
           "build_s": build_s}
    print(f"[{PROG}] n={g.n} m={g.m} on {out['device']['card']}",
          flush=True)

    # --- recall oracle first ---
    acc = np.asarray(sources[: args.acc_queries], np.int32)
    oracle = None
    if phases & {"topk", "wg"}:
        oracle = power_method_batch(g, acc, ALPHA, 100).cpu().numpy()
        oracle = oracle[: len(acc)]
        out["oracle_rows"] = len(acc)
        out["acc_sources"] = acc.tolist()
    conf = AlgoConf(ALPHA, seed=7)
    hs = None
    if "topk" in phases:
        hs = topk_phase(args, ds, conf, sources, acc, oracle, out)
    if "wg" in phases:
        wg_phase(args, ds, conf, sources, acc, oracle, hs, out)
    del hs
    if "walks" in phases:
        walk_phase(args, g, rng, out)
    return out, oracle


def topk_phase(args, ds, conf, sources, acc, oracle, out):
    """Top-k serving at the automatic hub count, recall@10 against the
    oracle rows; returns the hub split for the whole-graph phase."""
    import torch

    from ppr_tpu_torch.ops.topk import (topk_ids_with_ties,
                                        topk_ids_with_ties_from_pairs)
    from ppr_tpu_torch.utils.drivers import peak_gb, reset_peak, timed
    from ppr_tpu_torch.utils.metrics import precision_at_k

    g = ds.graph
    dev = g.device
    fora = conf.set_conf_fora_topk(ds, K)
    fora.enable_hub_split("auto", dtype=torch.bfloat16)
    hs = fora.hub_split
    out["auto_hubs"] = hs.num_hubs
    out["hub_edge_cover"] = 1.0 - hs.m_tail / max(g.m, 1)
    out["tail_edges"] = hs.m_tail
    reset_peak(dev)
    _, out["topk_warmup_s"] = timed(
        dev, lambda: fora.compute_topk_ids_batch(sources, K, EPS))
    (vals, ids), topk_s = timed(dev, lambda: fora.compute_topk_ids_batch(
        sources, K, EPS))
    out["fora_topk_qps"] = args.batch / topk_s
    out["topk_s"] = topk_s
    out["topk_sweeps"] = int(fora.last_iters)
    out["topk_path"] = ("annealed loop" if fora._skip_push(
        EPS * 0.5, args.batch) else "push+walks")
    out["topk_peak_gb"] = peak_gb(dev)
    precs, dense_rows = [], 0
    for i in range(len(acc)):
        gnd = topk_ids_with_ties(oracle[i], K)
        algo = topk_ids_with_ties_from_pairs(vals[i], ids[i], K)
        if algo.size == vals.shape[1] and vals[i][-1] > 0.0:
            # the tie window overflowed: exact dense recomputation
            dense = fora.compute_topk_batch(acc[i:i + 1], K, EPS)
            algo = topk_ids_with_ties(dense[0], K)
            dense_rows += 1
        precs.append(precision_at_k(algo, gnd))
    out["recall_at_10"] = float(np.mean(precs))
    out["recall_dense_rows"] = dense_rows
    print(f"[{PROG}] top-k B={args.batch}: {out['fora_topk_qps']:.2f} qps, "
          f"{out['topk_sweeps']} sweeps ({out['topk_path']}), "
          f"{hs.num_hubs} auto hubs carrying "
          f"{100 * out['hub_edge_cover']:.1f}% of the edges, recall@10 "
          f"{out['recall_at_10']:.4f}, peak {out['topk_peak_gb']} GB",
          flush=True)
    del fora, vals, ids
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return hs


def wg_phase(args, ds, conf, sources, acc, oracle, hs, out):
    """Whole-graph at the automatic hub count (the top-k phase's split,
    or its own), dense rows to the host included, held to the oracle rows
    of the accuracy sources."""
    import torch

    from ppr_tpu_torch.ops.topk import topk_ids_with_ties
    from ppr_tpu_torch.utils.drivers import peak_gb, reset_peak, timed
    from ppr_tpu_torch.utils.metrics import precision_at_k

    g = ds.graph
    dev = g.device
    wg = conf.set_conf_fora_whole_graph(ds)
    if hs is None:
        wg.enable_hub_split("auto", dtype=torch.bfloat16)
    else:
        wg.hub_split = hs
    wg_sources = sources[: args.wg_batch]
    reset_peak(dev)
    wg.compute_whole_graph_batch(wg_sources, EPS)       # warm-up
    dense, wg_s = timed(dev, lambda: wg.compute_whole_graph_batch(
        wg_sources, EPS))
    mass = dense.astype(np.float64).sum(axis=1)
    out["fora_whole_graph_qps"] = args.wg_batch / wg_s
    out["mass_conservation"] = float(mass.mean())
    out["mass_rows"] = mass.tolist()
    out["wg_push_rounds"] = wg.last_rounds
    out["wg_peak_gb"] = peak_gb(dev)
    out["wg_finite"] = bool(np.isfinite(dense).all())
    # the rows of the accuracy sources (the first of both batches) against
    # the oracle: its top-10 within the row's top-10 with ties eps/n, and
    # FORA's bound, relative error eps, on every entry above delta = 1/n
    n_acc = min(len(acc), args.wg_batch)
    precs, rel = [], 0.0
    for i in range(n_acc):
        want, got = oracle[i, : g.n], dense[i, : g.n]
        precs.append(precision_at_k(
            topk_ids_with_ties(got, K, tol=EPS / g.n),
            topk_ids_with_ties(want, K)))
        big = want > 1.0 / g.n
        rel = max(rel, float(np.max(np.abs(got[big] - want[big])
                                    / want[big], initial=0.0)))
    out["wg_checked_rows"] = n_acc
    out["wg_precision_at_10"] = float(np.mean(precs))
    out["wg_rel_err_above_delta"] = rel
    print(f"[{PROG}] whole-graph B={args.wg_batch}: "
          f"{out['fora_whole_graph_qps']:.3f} qps, {wg.last_rounds} push "
          f"rounds, mass {out['mass_conservation']:.9f}; on the {n_acc} "
          f"accuracy sources precision@10 {out['wg_precision_at_10']:.4f}, "
          f"relative error above 1/n {rel:.4f}", flush=True)
    del wg, dense
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def walk_phase(args, g, rng, out):
    """Raw walks a second over ``--walkers`` walkers."""
    import torch

    from ppr_tpu_torch.ops.walk import weighted_walk_counts
    from ppr_tpu_torch.utils.drivers import timed

    dev = g.device
    starts = torch.as_tensor(rng.integers(0, g.n, args.walkers),
                             dtype=torch.int32, device=dev)
    rows = torch.zeros(args.walkers, dtype=torch.int64, device=dev)
    w = torch.full((args.walkers,), 1.0 / args.walkers, device=dev)

    def walks(seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return weighted_walk_counts(g, starts, rows, w, gen, ALPHA,
                                    num_rows=1)

    walks(0)                                                 # warm-up
    counts, walk_s = timed(dev, lambda: walks(1))
    out["walks_per_sec"] = args.walkers / walk_s
    out["walks_mass"] = float(counts.double().sum())
    print(f"[{PROG}] walks: {out['walks_per_sec']:.4g} a second over "
          f"{args.walkers} walkers, mass {out['walks_mass']:.9f}",
          flush=True)


def merged(path: str, out: dict) -> dict:
    """``out`` over the artifact at ``path`` when that artifact is of the
    same graph (``n`` and ``m``): one phase's keys replace its own and
    keep the other phases'. Otherwise ``out`` alone."""
    import json
    import os

    if not os.path.exists(path):
        return out
    with open(path) as f:
        prior = json.load(f)
    if (prior.get("n"), prior.get("m")) != (out["n"], out["m"]):
        print(f"[{PROG}] {path} holds another graph (n={prior.get('n')} "
              f"m={prior.get('m')}): not merged", flush=True)
        return out
    return {**prior, **out}


def main(argv=None) -> int:
    from ppr_tpu_torch.utils.drivers import no_card, write_json

    args = parse_args(argv)
    if no_card(args.device, PROG):
        return 1
    out = run(args)
    if args.quick:
        return 0
    if args.phase != "all":
        out = merged(args.out, out)
    write_json(args.out, out)
    print(f"[{PROG}] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
