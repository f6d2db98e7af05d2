#!/usr/bin/env python3
"""The hub-count and batch knee of FORA top-k on one NVIDIA card, and the
prices of the automatic hub count — port of ``scripts/hub_knee.py``.

On ``bench_torch.py``'s engine and graph (``synthetic_powerlaw(65536, 16,
seed=42, dense_threshold=0)``, ``ForaTopk(push="none")``, bf16 hubs), for
every batch B of ``--batches`` and hub count H of ``--hubs``, plus the
count of the automatic rule (``ops/hub_split.py::auto_num_hubs``): a
warm-up call, then the median of ``--reps`` timed
``compute_topk_ids_batch`` calls, each on a host clock around synchronised
calls. A point records qps, sweeps, ms a sweep, peak device memory, the
tail's edges and the share of edges the hubs carry. The knee at a batch is
its fastest point; beside it stand the rule's count and the qps it loses
there.

``--constants`` measures the rule's two prices at ``REF_BATCH`` and at
every batch of the ladder (on the card only): K3's device time an edge of
the tail at H 4096 (CUDA-graph replays, L2 flushed before each) and the
time one more column adds to the bf16 hub product, the slope of
``torch.mm(M^T, X, out_dtype=f32)`` (the port's hub product, ``M`` the
``[n_pad, H]`` bf16 matrix, ``X`` the ``[n_pad, B]`` operand) over H 2048
-> 4096, as ``n_pad * 2 / col_ns`` GB/s. It prints the rule's count at
each batch's own prices beside the knee.

``--host-split B,H`` times one batch's parts apart through the engine's
own steps, each between synchronised calls: ``forward_push_init``'s
``[B, n_pad]`` one-hot, the annealed loop, ``_device_topk_epilogue``, the
``.cpu()`` copies and the host tie expansion of every row.

    python3 hub_knee_torch.py [--constants] [--out results/hub_knee_h100.json]

Runs on the card; ``--device cpu`` runs on the CPU (small sizes, tests),
and without a card it exits 1. It writes ``results/hub_knee_h100.json``
and never the TPU's ``hub_knee_r4.json`` or ``hub_knee_b2048.json``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np

PROG = "hub_knee_torch"
ALPHA = 0.15
#: the hub count whose tail K3's price is measured over (the bench's), and
#: the two counts the hub column's price is the slope between
TAIL_HUBS, COL_HUBS = 4096, (2048, 4096)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=16)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--batches", default="256,512,1024,2048,4096")
    ap.add_argument("--hubs", default="256,384,512,1024,2048,4096,8192,16384")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--constants", action="store_true",
                    help="measure the automatic count's two prices at "
                         "REF_BATCH and at every batch (card only)")
    ap.add_argument("--host-split", default="2048,4096", metavar="B,H",
                    help="time one batch's parts apart ('none' skips)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default="results/hub_knee_h100.json")
    return ap.parse_args(argv)


def ints(spec: str) -> list[int]:
    return [int(x) for x in spec.split(",") if x]


def measure_prices(g, batch: int) -> dict:
    """The automatic count's two prices on the card at ``batch`` columns:
    ``tail_ns_per_edge``, K3's device time over the tail of a
    ``TAIL_HUBS`` split divided by its edges, and ``hbm_gbps``, ``n_pad *
    2`` bytes over ``col_ns``, the device time one more hub column adds to
    the bf16 hub product between the two counts of ``COL_HUBS``."""
    import torch

    from ppr_tpu_torch.ops.hub_split import build_hub_split
    from ppr_tpu_torch.ops.row_gather import gather_segment_sum
    from ppr_tpu_torch.utils.cuda_timing import graph_ms, l2_flusher

    dev = g.device
    if dev.type != "cuda":
        raise RuntimeError("the hub prices are measured on the card")
    gen = torch.Generator(device=dev).manual_seed(5)
    flush = l2_flusher(dev)
    hs = build_hub_split(g, TAIL_HUBS, dtype=torch.bfloat16)
    table = torch.rand((g.n_pad, batch), device=dev, generator=gen)
    tail_ms = graph_ms(lambda: gather_segment_sum(table, hs.tail_src,
                                                  hs.tail_ptr),
                       20, before=flush)
    m_tail = hs.m_tail
    del table, hs
    x = torch.rand((g.n_pad, batch), device=dev,
                   generator=gen).to(torch.bfloat16)
    mm_ms = {}
    for h in COL_HUBS:
        mat = torch.rand((g.n_pad, h), device=dev,
                         generator=gen).to(torch.bfloat16)
        mm_ms[h] = graph_ms(
            lambda: torch.mm(mat.T, x, out_dtype=torch.float32), 20,
            before=flush)
        del mat
    lo, hi = COL_HUBS
    col_ns = (mm_ms[hi] - mm_ms[lo]) * 1e6 / (hi - lo)
    return {"batch": batch, "tail_hubs": TAIL_HUBS, "m_tail": m_tail,
            "tail_ms": tail_ms, "tail_ns_per_edge": tail_ms * 1e6 / m_tail,
            "mm_ms": {str(h): v for h, v in mm_ms.items()},
            "col_ns": col_ns, "hbm_gbps": g.n_pad * 2 / col_ns}


def topk_point(fora, sources, k: int, eps: float, reps: int, dev) -> dict:
    """One (B, H) point: a warm-up call, then the median of ``reps`` timed
    calls."""
    from ppr_tpu_torch.utils.drivers import peak_gb, reset_peak, timed

    reset_peak(dev)
    fora.compute_topk_ids_batch(sources, k, eps)            # warm-up
    times = [timed(dev, lambda: fora.compute_topk_ids_batch(
        sources, k, eps))[1] for _ in range(reps)]
    s = statistics.median(times)
    sweeps = int(fora.last_iters)
    hs = fora.hub_split
    return {"batch": len(sources), "hubs": hs.num_hubs,
            "s_per_batch": s, "times_s": times,
            "qps": len(sources) / s, "sweeps": sweeps,
            "ms_per_sweep": s * 1e3 / sweeps, "peak_gb": peak_gb(dev),
            "tail_edges": hs.m_tail,
            "hub_edge_cover": 1.0 - hs.m_tail / max(fora.graph.m, 1)}


def host_split(fora, sources, k: int, eps: float, dev) -> dict:
    """One ``compute_topk_ids_batch`` taken apart through the engine's own
    steps, each between synchronised calls (milliseconds), beside the
    whole call's time: ``forward_push_init``'s one-hot alone, the engine's
    device path (``_compute_topk_device``: that init and the annealed loop;
    ``loop`` is the difference), ``_device_topk_epilogue`` at
    ``topk_kcap``, the ``.cpu()`` copies and the host tie expansion."""
    import torch

    from ppr_tpu_torch.models import fora as fora_mod
    from ppr_tpu_torch.ops.push import forward_push_init
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs
    from ppr_tpu_torch.utils.drivers import timed

    g = fora.graph
    fora.compute_topk_ids_batch(sources, k, eps)            # warm-up
    _, whole = timed(dev, lambda: fora.compute_topk_ids_batch(
        sources, k, eps))
    padded, b = fora_mod._pad_sources(sources)
    src = torch.as_tensor(padded, dtype=torch.int32, device=g.device)
    ms = {}
    _, t = timed(dev, lambda: forward_push_init(g, src))
    ms["one_hot_init"] = t * 1e3
    (p, src, onehot), t = timed(
        dev, lambda: fora._compute_topk_device(padded, k, eps))
    device_path = t * 1e3
    ms["loop"] = device_path - ms["one_hot_init"]
    (vals, ids), t = timed(dev, lambda: fora_mod._device_topk_epilogue(
        g, src, p, onehot, fora_mod.topk_kcap(k, g.n_pad)))
    ms["epilogue"] = t * 1e3
    (vals, ids), t = timed(dev, lambda: (vals.cpu().numpy()[:b],
                                         ids.cpu().numpy()[:b]))
    ms["to_host"] = t * 1e3
    tol = eps / g.n
    _, t = timed(dev, lambda: [topk_ids_with_ties_from_pairs(
        vals[i], ids[i], k, tol=tol) for i in range(b)])
    ms["tie_expansion"] = t * 1e3
    return {"batch": b, "hubs": fora.hub_split.num_hubs,
            "sweeps": int(fora.last_iters), "whole_call_ms": whole * 1e3,
            "device_path_ms": device_path, "parts_ms": ms,
            "parts_sum_ms": sum(ms.values())}


def run(args) -> dict:
    """The sweep's record; raises without a card unless ``--device
    cpu``."""
    import torch

    from ppr_tpu_torch.device import resolve_device
    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.models.fora import ForaTopk
    from ppr_tpu_torch.ops import hub_split as hsm
    from ppr_tpu_torch.utils.drivers import describe

    dev = resolve_device(args.device)
    ds = synthetic_powerlaw(args.n, args.deg, seed=args.seed,
                            dense_threshold=0, device=dev)
    g = ds.graph
    bf16 = torch.bfloat16
    batches, hubs = ints(args.batches), ints(args.hubs)
    rule = hsm.auto_num_hubs(g, bf16)
    out = {"db": f"synth:{args.n}x{args.deg}@{args.seed}",
           "graph": {"n": g.n, "m": g.m, "n_pad": g.n_pad},
           "device": describe(dev), "k": args.k, "eps": args.eps,
           "reps": args.reps,
           "rule": {"auto_hubs": rule,
                    "tail_ns_per_edge": hsm.TAIL_NS_PER_EDGE,
                    "hbm_gbps": hsm.HUB_COLUMN_GBPS,
                    "ref_batch": hsm.REF_BATCH,
                    "max_matrix_bytes": hsm.MAX_MATRIX_BYTES},
           "rows": []}
    print(f"[{PROG}] {out['db']} n={g.n} m={g.m} on {out['device']['card']}"
          f"; the rule's count with the shipped prices: {rule}", flush=True)

    if args.constants:
        out["constants"] = {}
        for b in sorted(set(batches) | {hsm.REF_BATCH}):
            pr = measure_prices(g, b)
            pr["rule_hubs"] = hsm.auto_num_hubs(
                g, bf16, tail_ns_per_edge=pr["tail_ns_per_edge"],
                hbm_gbps=pr["hbm_gbps"])
            out["constants"][str(b)] = pr
            print(f"[{PROG}] prices at B={b}: K3 "
                  f"{pr['tail_ns_per_edge']:.4f} ns an edge over "
                  f"{pr['m_tail']} tail edges ({pr['tail_ms']:.4f} ms), one "
                  f"more hub column {pr['col_ns']:.3f} ns = "
                  f"{pr['hbm_gbps']:.1f} GB/s; the rule at these prices: "
                  f"{pr['rule_hubs']} hubs", flush=True)

    rng = np.random.default_rng(0)
    knees = {}
    for b in batches:
        sources = rng.integers(0, g.n, size=b)
        rows = []
        for h in sorted(set(hubs) | {rule}):
            fora = ForaTopk(ds, ALPHA, args.k, push="none")
            fora.enable_hub_split(h, dtype=bf16)
            row = topk_point(fora, sources, args.k, args.eps, args.reps,
                             dev)
            row["rule"] = h == rule
            del fora
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            rows.append(row)
            out["rows"].append(row)
            print(json.dumps(row), flush=True)
        knee = max(rows, key=lambda r: r["qps"])
        at_rule = next(r for r in rows if r["rule"])
        knees[str(b)] = {
            "knee_hubs": knee["hubs"], "knee_qps": knee["qps"],
            "rule_hubs": rule, "rule_qps": at_rule["qps"],
            "rule_qps_lost": knee["qps"] - at_rule["qps"],
            "rule_qps_lost_frac": 1.0 - at_rule["qps"] / knee["qps"]}
        if args.constants:
            knees[str(b)]["rule_hubs_at_batch_prices"] = \
                out["constants"][str(b)]["rule_hubs"]
        print(f"[{PROG}] B={b}: knee H={knee['hubs']} {knee['qps']:.1f} "
              f"qps; the rule's {rule} hubs {at_rule['qps']:.1f} qps, "
              f"{100 * knees[str(b)]['rule_qps_lost_frac']:.1f}% lost",
              flush=True)
    out["knee"] = knees

    if args.host_split != "none":
        b, h = ints(args.host_split)
        fora = ForaTopk(ds, ALPHA, args.k, push="none")
        fora.enable_hub_split(h, dtype=bf16)
        split = host_split(fora, rng.integers(0, g.n, size=b), args.k,
                           args.eps, dev)
        out["host_split"] = split
        print(f"[{PROG}] host split at B={b} H={h}: {json.dumps(split)}",
              flush=True)
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
