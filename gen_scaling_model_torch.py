#!/usr/bin/env python3
"""The two-host scaling model of the mesh engines, priced with the
frontier ring's measured inflation — port of
``scripts/gen_scaling_model.py``.

For each ring-occupancy artifact of ``--occupancy``
(``ring_occupancy_torch.py``), at that artifact's batch: the two-host
prediction of ``ppr_tpu_torch/parallel/comm_model.py``
(``two_host_prediction``) on ``synthetic_powerlaw(--n, --deg, seed=--seed,
dense_threshold=0)``, with the frontier-compacted bf16 ring priced at the
measured (capacity, inflation) point whose modelled sweep is fastest
(``comm_model.rank_frontier``). The first artifact's block is the top
level; each further one is under ``batch_<B>``. ``measured_breakdown`` is
``comm_model.measure_breakdown`` on a 2x2 mesh of the device repeated.

The rates: K3's ns an edge is measured on the device at each batch
(``comm_model.measure_spmv_ns_per_edge``); the link's bytes a
second is ``--link-bytes-per-s`` or, with two cards visible, measured
(``comm_model.measure_link_bytes_per_s``). With neither, the artifact
holds the bytes and the candidates and no prediction. ``link_source``
says which.

    python3 gen_scaling_model_torch.py \\
        [--occupancy results/ring_occupancy_h100.json] \\
        [--link-bytes-per-s RATE] [--out results/scaling_model_h100.json]

Runs on the card; ``--device cpu`` runs on the CPU (small ``--n``, tests),
and without a card it exits 1.
"""

from __future__ import annotations

import argparse
import json
import sys

PROG = "gen_scaling_model_torch"
CHIPS_PER_HOST = 4


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--occupancy", default="results/ring_occupancy_h100.json",
                    help="ring-occupancy artifacts, comma-separated")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--link-bytes-per-s", type=float, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="results/scaling_model_h100.json")
    return ap.parse_args(argv)


def run(args) -> dict:
    from ppr_tpu_torch.device import resolve_device
    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.parallel import comm_model as cm
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.utils.drivers import describe

    dev = resolve_device(args.device)
    g = synthetic_powerlaw(args.n, args.deg, seed=args.seed,
                           dense_threshold=0, device=dev).graph
    link, link_source = args.link_bytes_per_s, "argument"
    if link is None:
        link = (cm.measure_link_bytes_per_s(g.n_pad, 512)
                if dev.type == "cuda" else None)
        link_source = "measured between two cards" if link else "none"
    blocks = []
    for path in args.occupancy.split(","):
        with open(path) as f:
            occ = json.load(f)
        key = next(iter(occ["graphs"]))
        batch = int(occ["batch"])
        cands = occ["graphs"][key]["empirical"]["frontier"]
        ns_edge = cm.measure_spmv_ns_per_edge(g, batch)
        block = {"batch": batch, "spmv_ns_per_edge": ns_edge,
                 "occupancy": {"source": path, "measured_graph": key}}
        if link is not None:
            cands = cm.rank_frontier(
                g, cands, batch=batch, s_graph=2 * CHIPS_PER_HOST,
                spmv_ns_per_edge=ns_edge, link_bytes_per_s=link)
            frontier = dict(cands[0], source=path, measured_graph=key)
            block.update(cm.two_host_prediction(
                g, batch=batch, chips_per_host=CHIPS_PER_HOST,
                spmv_ns_per_edge=ns_edge, link_bytes_per_s=link,
                frontier=frontier))
        block["frontier_candidates_measured"] = cands
        blocks.append(block)
        print(f"[{PROG}] B={batch}: K3 {ns_edge:.4f} ns an edge, link "
              f"{link} ({link_source}), frontier candidates {len(cands)}",
              flush=True)
    out = dict(blocks[0])
    for block in blocks[1:]:
        out[f"batch_{block['batch']}"] = block
    out.update(device=describe(dev), link_bytes_per_s=link,
               link_source=link_source,
               graph={"n": g.n, "m": g.m, "n_pad": g.n_pad,
                      "seed": args.seed})
    out["measured_breakdown"] = cm.measure_breakdown(
        make_mesh(4, data=2, graph=2, devices=[dev] * 4), g, batch=64)
    return out


def main(argv=None) -> int:
    from ppr_tpu_torch.utils.drivers import no_card, write_json

    args = parse_args(argv)
    if no_card(args.device, PROG):
        return 1
    out = run(args)
    write_json(args.out, out)
    for name, blk in [("top", out)] + [
            (k, v) for k, v in out.items() if k.startswith("batch_")]:
        for key in ("node_sharded_2host", "node_sharded_2host_bf16_ring",
                    "node_sharded_2host_frontier_bf16"):
            e = blk.get(key)
            if e:
                print(f"[{PROG}] {name} {key}: efficiency "
                      f"{e['efficiency']:.3f}, overlapped "
                      f"{e['efficiency_overlap']:.3f}")
    print(f"[{PROG}] wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
