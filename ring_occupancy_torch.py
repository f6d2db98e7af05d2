#!/usr/bin/env python3
"""Residue-frontier occupancy and mass coverage, and the frontier ring's
measured sweep inflation — port of ``scripts/ring_occupancy.py``.

Two measurements per graph:

* **Part A (coverage curve)**: a single-device replica of the node-sharded
  annealed loop (every edge pushed each sweep, by K3 on the card) records,
  before each sweep, the residue mass of each of ``NBLK`` node blocks
  summed over the batch: the occupancy (the share of blocks with any
  mass) and coverage(C) (the share of the mass in the C fullest blocks)
  at C = ``NBLK`` x 1/16 .. 1/2. A frontier sweep that pushes C blocks
  pushes at least coverage(C) of the mass, so the sweep count inflates by
  at most ~1/coverage on the decaying tail.
* **Part B (measured inflation)**: ``NodeShardedForaTopk`` on a 2x4 mesh
  of the run's device repeated (the card, or the CPU), dense against the
  frontier ring at each capacity of 64 blocks and each block order; the
  ratio of the sweep counts is the inflation, the answer ids are checked
  against the dense run's, and each run's largest error against the power
  method is kept.

Both are counts, not link times, so one device repeated gives the real
numbers. The artifact, ``results/ring_occupancy_h100.json``, is what
``gen_scaling_model_torch.py`` and ``python -m
ppr_tpu_torch.parallel.comm_model --frontier-json`` price the frontier
ring with.

    python3 ring_occupancy_torch.py [--graphs synth:65536x8@3] [--batch 512]

Runs on the card; ``--device cpu`` runs on the CPU (small graphs, tests),
and without a card it exits 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

PROG = "ring_occupancy_torch"
NBLK = 512               # global block granularity (= 8 shards x 64 blocks)
FRACS = (1 / 16, 1 / 8, 1 / 4, 1 / 2)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--graphs", default="synth:65536x8@3")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--param", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--orders", default="degree,id")
    ap.add_argument("--caps", default="4,8,16,32")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="results/ring_occupancy_h100.json")
    return ap.parse_args(argv)


def dense_coverage(ds, sources, param, k=10, alpha=0.15, max_iters=600):
    """Part A: per-sweep block mass statistics of the annealed loop
    (``scripts/ring_occupancy.py::dense_coverage``), node-major ``[n_pad,
    B]`` state on the graph's device. Returns ``(rows, aggregate)``."""
    import torch

    from ppr_tpu_torch.ops.spmv import push_out_chunked_t

    g = ds.graph
    dev = g.device
    eps = float(param) * 0.5          # eps' = eps/2 (Fora_Topk.java:110)
    delta, min_delta = 1.0 / k, 1.0 / g.n
    b = len(sources)
    src = torch.as_tensor(np.asarray(sources), dtype=torch.long, device=dev)
    onehot = torch.zeros((g.n_pad, b), dtype=torch.float32, device=dev)
    onehot[src, torch.arange(b, device=dev)] = 1.0
    r = torch.where(g.out_deg.index_select(0, src)[None, :] == 0, 0.0,
                    onehot)
    p = torch.zeros_like(r)
    dangling = ((g.out_deg == 0) & (g.node_mask > 0)).to(torch.float32)
    dangling = dangling[:, None]
    blk = -(-g.n_pad // NBLK)
    pad = NBLK * blk - g.n_pad

    def sweep(p, r):
        p2 = p + alpha * r
        rem = (1.0 - alpha) * r
        dang = (rem * dangling).sum(dim=0, keepdim=True)
        pushed = push_out_chunked_t(g, rem, num_chunks=1)
        return p2, pushed + dang * onehot

    rows = []
    for it in range(max_iters):
        r_pad = torch.nn.functional.pad(r, (0, 0, 0, pad))
        mass = r_pad.view(NBLK, blk, b).sum(dim=(1, 2)).cpu().numpy()
        total = float(mass.sum())
        cum = np.cumsum(np.sort(mass)[::-1])
        row = {"sweep": it, "total_mass": total,
               "occupancy": float((mass > 0).mean())}
        for f in FRACS:
            c = max(1, int(round(NBLK * f)))
            row[f"coverage_{f:.4f}"] = (float(cum[c - 1] / total)
                                        if total > 0 else 1.0)
        rows.append(row)

        p, r = sweep(p, r)
        settled = bool(r.sum(dim=0).max() <= eps * delta)
        cnt = (p >= (1.0 + eps) * delta).sum(dim=0)
        done = settled and bool((cnt >= k).all())
        if done or (settled and delta <= min_delta):
            break
        if settled:
            delta = max(min_delta, delta / 4.0)
    # the mass-weighted mean coverage over the run: early sweeps carry the
    # mass, the near-empty tail sweeps barely matter for deferral
    agg = {"sweeps": len(rows)}
    tot = sum(x["total_mass"] for x in rows) or 1.0
    for f in FRACS:
        key = f"coverage_{f:.4f}"
        agg[key + "_mass_weighted"] = sum(
            x[key] * x["total_mass"] for x in rows) / tot
        agg[key + "_min"] = min(x[key] for x in rows)
    agg["occupancy_max"] = max(x["occupancy"] for x in rows)
    return rows, agg


def engine_run(engine, sources, k, param):
    """One ``NodeShardedForaTopk`` run: ``(vals, ids, sweeps)``, the values
    and ids host arrays of the real rows."""
    import torch

    from ppr_tpu_torch.models.fora import topk_kcap

    srcs, b = engine._pad_batch(np.asarray(sources, np.int32))
    kcap = topk_kcap(k, engine.graph.n_pad)
    vals, ids, _, iters = engine._run(srcs, k, kcap, float(param) * 0.5)
    return (torch.cat([v.cpu() for v in vals]).numpy()[:b],
            torch.cat([i.cpu() for i in ids]).numpy()[:b], int(iters))


def empirical_inflation(ds, sources, param, mesh, k=10, alpha=0.15,
                        orders=("degree", "id"), caps=(4, 8, 16, 32),
                        num_blocks=64):
    """Part B: sweeps of the dense ring and of the frontier ring at each
    capacity on ``mesh``, the answer ids against the dense run's and each
    run's largest error against the power method."""
    from ppr_tpu_torch.models.power_method import PowerMethod
    from ppr_tpu_torch.parallel.node_sharded_fora import NodeShardedForaTopk

    srcs = np.asarray(sources, np.int32)
    truth = PowerMethod(ds, alpha).compute_whole_graph_batch(srcs)

    def oracle_err(engine):
        p = engine.compute_topk_batch(srcs, k, param)
        npad = min(truth.shape[-1], p.shape[-1])
        return float(np.abs(p[:, :npad] - truth[:, :npad]).max())

    dense = NodeShardedForaTopk(ds, alpha, k, mesh=mesh)
    v_d, i_d, it_d = engine_run(dense, srcs, k, param)
    out = {"mesh": mesh.shape, "dense_sweeps": it_d,
           "dense_oracle_err": oracle_err(dense), "frontier": []}
    for order in orders:
        for c in caps:
            eng = NodeShardedForaTopk(ds, alpha, k, mesh=mesh,
                                      frontier_blocks=c,
                                      num_blocks=num_blocks,
                                      block_order=order)
            v_f, i_f, it_f = engine_run(eng, srcs, k, param)
            ok = True
            for row in range(len(srcs)):
                sup = min(k, int((v_d[row] > 0).sum()),
                          int((v_f[row] > 0).sum()))
                if set(i_f[row][:sup].tolist()) \
                        != set(i_d[row][:sup].tolist()):
                    ok = False
            out["frontier"].append({
                "block_order": order,
                "capacity_blocks": c,
                "capacity_frac": c / num_blocks,
                "sweeps": it_f,
                "sweep_inflation": it_f / max(it_d, 1),
                # strict agreement with the dense run's ids; False means
                # tail-rank drift between two valid stopping states, not
                # an error: the oracle errors are the arbiter
                "ids_match_dense": ok,
                "values_equal_dense": bool(np.array_equal(v_f, v_d)),
                "oracle_err": oracle_err(eng),
            })
    return out


def run(args) -> dict:
    """The artifact's record; raises without a card unless ``--device
    cpu``."""
    from ppr_tpu_torch.cli import load_dataset
    from ppr_tpu_torch.device import resolve_device
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.utils.drivers import describe

    dev = resolve_device(args.device)
    out = {"param": args.param, "k": args.k, "batch": args.batch,
           "nblk_global": NBLK, "device": describe(dev), "graphs": {}}
    for spec in args.graphs.split(","):
        ds = load_dataset(spec, device=dev)
        rng = np.random.default_rng(args.seed)
        deg = ds.graph.out_deg[: ds.graph.n].cpu().numpy()
        cand = np.nonzero(deg > 0)[0]
        sources = rng.choice(cand, size=min(args.batch, len(cand)),
                             replace=False).astype(np.int32)
        print(f"[{PROG}] {spec}: n={ds.graph.n} m={ds.graph.m}", flush=True)
        rows, agg = dense_coverage(ds, sources, args.param, k=args.k)
        print(f"[{PROG}]   dense sweeps={agg['sweeps']} "
              f"occ_max={agg['occupancy_max']:.3f} cov(1/8)_mw="
              f"{agg['coverage_0.1250_mass_weighted']:.3f}", flush=True)
        entry = {"n": ds.graph.n, "m": ds.graph.m, "aggregate": agg,
                 "per_sweep": rows}
        mesh = make_mesh(8, data=2, graph=4, devices=[dev] * 8)
        infl = empirical_inflation(
            ds, sources, args.param, mesh, k=args.k,
            orders=tuple(args.orders.split(",")),
            caps=tuple(int(x) for x in args.caps.split(",")))
        entry["empirical"] = infl
        print(f"[{PROG}]   dense ring {infl['dense_sweeps']} sweeps; "
              + ", ".join(
                  f"{x['block_order'][:3]}/C={x['capacity_blocks']}: "
                  f"{x['sweep_inflation']:.2f}x (err "
                  f"{x['oracle_err']:.1e})" for x in infl["frontier"]),
              flush=True)
        out["graphs"][spec] = entry
    return out


def main(argv=None) -> int:
    from ppr_tpu_torch.utils.drivers import no_card, write_json

    args = parse_args(argv)
    if no_card(args.device, PROG):
        return 1
    out = run(args)
    write_json(args.out, out)
    print(f"[{PROG}] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
