#!/usr/bin/env python3
"""Monte-Carlo's deposit in f64 (the port's) and in f32 (the JAX
package's) on the same walks, against the power method.

A Monte-Carlo row launches ``omega = 3 ln(2/pfail) / eps^2 / delta`` walks
a source (``delta = pfail = 1/n``: 1.04e7 on amazon at eps 1), each adding
``1/omega`` at its stop node. Added in f32, each add rounds to the bin's
ulp, so a bin that takes millions of adds drifts from its sum. This
script runs each source's walks twice, the generator seeded alike, once
adding in f64 and once in f32, and records for each the row's mass (1
when nothing is lost) and its max-err against the harness's oracle (the
100-iteration power method), at the sources of a protocol row: the
``--draw``-th query set of the harness's generator (``--draw 6`` is the
draw of ``protocol_grid_torch.py``'s ``amazon_t1_MC_p0`` reference, the
banked TPU row).

Usage (on the card; ``--device cpu`` runs on the CPU, and without a card
the script exits 1)::

    python3 mc_deposit_torch.py [--db synth:amazon] [--eps 1.0] [--draw 6]
        [--sources 50] [--out results/mc_deposit_h100.json]
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np

PROG = "mc_deposit_torch"
QUERY, ALPHA, SEED = 50, 0.15, 0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db", default="synth:amazon")
    ap.add_argument("--eps", type=float, default=1.0)
    ap.add_argument("--draw", type=int, default=6)
    ap.add_argument("--sources", type=int, default=QUERY,
                    help="the first this many of the draw's sources")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="results/mc_deposit_h100.json")
    return ap.parse_args(argv)


def run(args) -> dict:
    import torch

    from protocol_grid_torch import advance_draws
    from ppr_tpu_torch import cli
    from ppr_tpu_torch.harness import PerfHarness
    from ppr_tpu_torch.models.monte_carlo import (mc_num_walks,
                                                  mc_whole_graph_batch)
    from ppr_tpu_torch.utils import drivers
    from ppr_tpu_torch.utils.metrics import max_abs_err

    dev = torch.device(args.device)
    ds = cli.load_dataset(args.db, device=args.device)
    with tempfile.TemporaryDirectory() as tmp:
        harness = PerfHarness(ds, alpha=ALPHA, seed=SEED, out_dir=tmp,
                              progress=False)
        advance_draws(harness, args.draw)
        sources = harness.get_query_nodes(QUERY)[:args.sources]
        oracle = harness._oracle_rows(sources)
    n = ds.graph.n
    omega = mc_num_walks(args.eps, 1.0 / n, 1.0 / n)
    out = {"db": args.db, "eps": args.eps, "draw": args.draw, "n": n,
           "omega": omega, "sources": [int(s) for s in sources],
           "card": drivers.describe(dev)["card"]}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        gen = torch.Generator(device=dev).manual_seed(SEED)
        errs, mass = [], []
        t0 = time.perf_counter()
        for i, s in enumerate(sources):
            row = mc_whole_graph_batch(
                ds.graph, torch.tensor([s], dtype=torch.int32, device=dev),
                gen, ALPHA, omega, deposit=dtype)[0].cpu().numpy()
            errs.append(max_abs_err(row, oracle[i]))
            mass.append(float(row.astype(np.float64).sum()))
        out[name] = {"mean_max_err": float(np.mean(errs)),
                     "max_err": errs, "mass": mass,
                     "min_mass": min(mass), "seconds": time.perf_counter() - t0}
        print(f"[{PROG}] {name}: mean max-err {np.mean(errs):.6g}, mass "
              f"{min(mass):.6f}-{max(mass):.6f} over {len(sources)} "
              f"sources of {omega} walks", flush=True)
    drivers.write_json(args.out, out)
    return out


def main(argv=None) -> int:
    from ppr_tpu_torch.utils import drivers

    args = parse_args(argv)
    if drivers.no_card(args.device, PROG):
        return 1
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
