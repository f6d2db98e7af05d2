"""The serving knee of a deployment: the highest offered rate the server
sustains, found once by a ladder of fixed rates.

    python3 benchmark/knee.py --config flickr --rates 400,600,800 \\
        --seconds 20 --seed 1 [--out FILE.json]

One process builds the deployment and ``PPRBatchServer`` (max batch 2,048,
every rung prewarmed), times each pow2 rung's warm call of ``top_k``, then
offers each rate in turn through the open mix (``traffic.run_open``, a
lead-in of 3 s, then ``--seconds`` measured). At each rate it reports the
completions a second (measured requests over the window and the drain
after it), p50 and p99 from the due time, and the drain: how long after
the window closed the last measured request resolved.

A rate is kept up when no request failed and the drain stays short: at
most :data:`DRAIN_S` seconds, a few dispatches of the widest rung. A queue
that grows through the window leaves a backlog that takes longer. Each row
also gives a second verdict, ``flat``: whether the median latency of the
requests due in the window's last third stays within 1.3 times (plus 50
ms) that of its first third. The knee is the highest rate kept up
(``knee_flat_qps``: kept up and flat); the ladder stops after two rates in
a row that are not kept up.

``one_regime_qps`` is, from the rung times ``T``, the highest rate at
which a dispatch of rung ``2r`` gathers no more than ``r`` requests for the
next, for some rung ``r``: below it a run that spills into a wider rung
falls back, so the server keeps to one width policy through a run.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import graphgen, run, traffic  # noqa: E402
from benchmark.manifest import HERE  # noqa: E402

#: the longest drain, in seconds, of a rate that is kept up
DRAIN_S = 2.0


def percentile(xs, q: float) -> float:
    xs = sorted(xs)
    return xs[max(0, math.ceil(q / 100.0 * len(xs)) - 1)] if xs else math.nan


def ladder(server, n: int, rates, seconds: float, seed: int,
           max_batch: int) -> list[dict]:
    rows, misses = [], 0
    for i, rate in enumerate(rates):
        mix = {"kind": "open", "rate_qps": rate, "max_batch": max_batch,
               "lead_in_s": 3.0, "drain_s": 60.0}
        rng = np.random.default_rng([seed, 10 + i])
        rec = traffic.run_open(server, mix, n, rng, seconds)
        lat = rec.latency_ms + [math.inf] * rec.failed
        p50, p99 = percentile(lat, 50), percentile(lat, 99)
        drain = rec.notes["drain_s"]
        third = len(rec.latency_ms) // 3
        early = percentile(rec.latency_ms[:third], 50)
        late = percentile(rec.latency_ms[-third:], 50)
        kept = rec.failed == 0 and drain <= DRAIN_S
        rows.append({"offered_qps": rate, "attempted": rec.attempted,
                     "failed": rec.failed,
                     "completed_per_s": rec.completed / (seconds + drain),
                     "p50_first_third_ms": early,
                     "p50_last_third_ms": late,
                     "p50_ms": p50, "p99_ms": p99, "drain_s": drain,
                     "late_p99_ms": rec.notes["late_p99_ms"],
                     "mean_batch": rec.counters["dispatched_rows"]
                     / max(rec.counters["dispatches"], 1),
                     "flat": late <= 1.3 * early + 50.0,
                     "kept_up": kept})
        print(json.dumps(rows[-1]), flush=True)
        misses = 0 if kept else misses + 1
        if misses == 2:
            break
    return rows


def rung_ms(svc, n: int, max_batch: int, seed: int) -> dict:
    """The warm wall time of ``top_k`` at each pow2 rung, in ms (the
    second of two calls on sources drawn from the seed)."""
    rng = np.random.default_rng([seed, 9])
    out, w = {}, 8
    while w <= max_batch:
        batch = traffic.sources(rng, n, w)
        for _ in range(2):
            t = time.perf_counter()
            svc.top_k(batch)
            ms = (time.perf_counter() - t) * 1e3
        out[w] = ms
        w *= 2
    return out


def one_regime_qps(times: dict) -> float:
    """``max over r of r / T(2r)``: see the module's docstring."""
    return max(r * 1e3 / times[2 * r] for r in times if 2 * r in times)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="flickr",
                    help="a name under benchmark/configs, or a .json path")
    ap.add_argument("--rates", required=True, help="comma-separated qps")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=2048)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    path = Path(args.config) if args.config.endswith(".json") \
        else HERE / "configs" / f"{args.config}.json"
    cfg = json.loads(path.read_text())
    t = time.perf_counter()
    src, dst = graphgen.draw(cfg, args.seed)
    svc, _ = run.build_service(cfg, src, dst, device)
    server = run.start_server(svc, {"max_batch": args.max_batch})
    times = rung_ms(svc, cfg["nodes"], args.max_batch, args.seed)
    print(f"set-up {time.perf_counter() - t:.1f} s", file=sys.stderr)
    print(json.dumps({"rung_ms": times,
                      "one_regime_qps": one_regime_qps(times)}), flush=True)
    rates = [float(r) for r in args.rates.split(",")]
    rows = ladder(server, cfg["nodes"], rates, args.seconds, args.seed,
                  args.max_batch)
    server.close()
    kept = [r["offered_qps"] for r in rows if r["kept_up"]]
    flat = [r["offered_qps"] for r in rows if r["kept_up"] and r["flat"]]
    out = {"config": cfg["name"], "seed": args.seed,
           "seconds": args.seconds, "rung_ms": times,
           "one_regime_qps": one_regime_qps(times), "rows": rows,
           "knee_qps": max(kept) if kept else None,
           "knee_flat_qps": max(flat) if flat else None,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}
    print(json.dumps({"knee_qps": out["knee_qps"],
                      "knee_flat_qps": out["knee_flat_qps"]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
