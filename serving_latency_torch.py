#!/usr/bin/env python3
"""Open-loop serving latency of the PyTorch port: p50/p95/p99 under load.

The port of ``scripts/serving_latency.py``. It drives a
:class:`ppr_tpu_torch.serving.PPRBatchServer` with a Poisson arrival
process (open loop: arrivals do NOT wait for completions, so queueing delay
is measured honestly; a closed loop would self-throttle and hide it) at
several fractions of the server's measured capacity, and records
submit-to-result latency percentiles per rate
(``ServerStats.latency_percentiles``'s nearest-rank rule).

    python3 serving_latency_torch.py --db synth:65536x16@42 --hub-split 4096 \\
        --max-batch 2048 --rates 0.5,0.8 --duration-s 10 \\
        --out build/serving_latency_torch.json

``--daemon`` drives the stdio daemon (``python -m ppr_tpu_torch.serving``)
as a subprocess instead, the full wire path (pipe, JSON, scheduler,
device); its ``--rates`` are absolute qps. Everything runs on the card
unless ``--device cpu``, e.g. ``--device cpu --db synth:2048x8
--duration-s 3 --rates 0.25 --max-batch 32``; without a card it exits 1.

``--calibrate`` measures FORA's cost constants on the graph at start-up
(``PPRService(calibrate=True)``; in daemon mode the daemon's
``--calibrate``). The in-process artifact records the constants the cost
model used and the path it takes at each prewarmed rung (the annealed loop
or push+walks, ``ForaTopk.path_cost``). To compare the two, run the script
without and with ``--calibrate`` in turns, each with its own ``--out``.
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import threading
import time
from pathlib import Path


def measure_capacity(server, sources, max_batch: int, reps: int = 3) -> float:
    """Saturated throughput (qps) at the server's max batch, post-warmup.

    In SLO mode the adaptive cap reacts to the flood (growing under the
    backlog it creates); untimed settle floods run first so the timed reps
    measure the policy's steady state, not a mid-growth transient.
    """
    settle = 3 if getattr(server, "slo_ms", None) else 0
    for _ in range(settle):
        for f in [server.submit(s) for s in sources[:max_batch]]:
            f.result()
    t0 = time.perf_counter()
    done = 0
    for r in range(reps):
        futs = [server.submit(s) for s in sources[:max_batch]]
        for f in futs:
            f.result()
        done += len(futs)
    return done / (time.perf_counter() - t0)


def run_rate(server, sources, rate_qps: float, duration_s: float,
             rng: random.Random) -> dict:
    """Fire Poisson arrivals at ``rate_qps`` for ``duration_s``; return
    stats. Every future is waited for before the row is made."""
    n0 = len(server.stats.latencies_ms)
    futs = []
    t_end = time.perf_counter() + duration_s
    next_t = time.perf_counter()
    i = 0
    while time.perf_counter() < t_end:
        now = time.perf_counter()
        if now < next_t:
            time.sleep(min(next_t - now, 0.05))
            continue
        futs.append(server.submit(sources[i % len(sources)]))
        i += 1
        next_t += rng.expovariate(rate_qps)
    t_fire_done = time.perf_counter()
    for f in futs:
        f.result()
    drain_s = time.perf_counter() - t_fire_done
    lat = server.stats.latencies_ms[n0:]
    lat_sorted = sorted(lat)

    def pct(q):
        if not lat_sorted:
            return None
        j = min(len(lat_sorted) - 1,
                max(0, int(round(q / 100.0 * len(lat_sorted))) - 1))
        return round(lat_sorted[j], 3)

    return {
        "offered_qps": round(rate_qps, 2),
        "achieved_qps": round(len(futs) / duration_s, 2),
        "requests": len(futs),
        "p50_ms": pct(50),
        "p95_ms": pct(95),
        "p99_ms": pct(99),
        "mean_ms": round(sum(lat) / len(lat), 3) if lat else None,
        "drain_s": round(drain_s, 3),
    }


def daemon_cmd(args) -> list[str]:
    """The daemon's command line for ``args``."""
    cmd = [sys.executable, "-m", "ppr_tpu_torch.serving", "--db", args.db,
           "--device", args.device,
           "--alpha", str(args.alpha), "--eps", str(args.eps),
           "--k", str(args.k), "--max-batch", str(args.max_batch)]
    if args.hub_split:
        cmd += ["--hub-split", str(args.hub_split)]
    if args.early_exit:
        cmd += ["--early-exit"]
    if args.cohort:
        cmd += ["--cohort"]
    if args.calibrate:
        cmd += ["--calibrate"]
    if args.slo_ms:
        cmd += ["--slo-ms", str(args.slo_ms)]
    if args.prewarm:
        cmd += ["--prewarm"]
    if args.precomputed:
        cmd += ["--precomputed", args.precomputed]
    return cmd


def run_daemon_mode(args) -> int:
    """Drive the stdio JSON-lines daemon as a SUBPROCESS: arrival times are
    Poisson like the in-process mode, latency is measured request-write to
    response-read per request id — the full production wire path (pipe +
    JSON + scheduler + device)."""
    cmd = daemon_cmd(args)
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, bufsize=1)
    try:
        return _drive_daemon(proc, args)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _drive_daemon(proc, args) -> int:
    ready = None
    for _ in range(64):  # skip warnings/log lines before the ready JSON
        line = proc.stderr.readline()
        if not line:
            raise RuntimeError("daemon exited before signalling ready")
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        if obj.get("ready"):
            ready = obj
            break
    if ready is None:
        raise RuntimeError("no ready line from daemon")
    n = int(ready["n"])
    print(f"daemon ready: {ready}", flush=True)
    rng = random.Random(args.seed)
    sources = [rng.randrange(n) for _ in range(args.queries)]

    t_sent: dict[str, float] = {}
    lat_ms: list[float] = []
    done = threading.Event()

    def reader():
        for line in proc.stdout:
            resp = json.loads(line)
            t0 = t_sent.pop(str(resp.get("id")), None)
            if t0 is not None:
                lat_ms.append((time.perf_counter() - t0) * 1e3)
            if not t_sent and done.is_set():
                return

    th = threading.Thread(target=reader, daemon=True)
    th.start()

    def send(i, source):
        rid = str(i)
        t_sent[rid] = time.perf_counter()
        proc.stdin.write(json.dumps({"source": source, "id": rid}) + "\n")
        proc.stdin.flush()

    # warmup: one full batch, then measure at each rate
    for i in range(args.max_batch):
        send(f"w{i}", sources[i % len(sources)])
    while t_sent:
        time.sleep(0.1)
    lat_ms.clear()

    rows = []
    for spec in args.rates.split(","):
        rate = float(spec)
        if rate <= 1.5:
            raise SystemExit("--daemon mode takes absolute qps rates")
        n0 = len(lat_ms)
        t_end = time.perf_counter() + args.duration_s
        next_t = time.perf_counter()
        i = 0
        while time.perf_counter() < t_end:
            now = time.perf_counter()
            if now < next_t:
                time.sleep(min(next_t - now, 0.05))
                continue
            send(i, sources[i % len(sources)])
            i += 1
            next_t += rng.expovariate(rate)
        while t_sent:
            time.sleep(0.05)
        lat = sorted(lat_ms[n0:])

        def pct(q):
            return round(
                lat[min(len(lat) - 1,
                        max(0, int(round(q / 100 * len(lat))) - 1))], 3
            ) if lat else None

        row = {"offered_qps": rate, "requests": i, "p50_ms": pct(50),
               "p95_ms": pct(95), "p99_ms": pct(99)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    done.set()
    proc.stdin.close()
    proc.wait(timeout=60)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(
        {"mode": "daemon", "rows": rows}, indent=1) + "\n")
    print(f"wrote {args.out}")
    return proc.returncode


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db", default="synth:65536x16@42")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the graph and the engine run (default cuda: "
                         "exits 1 when no card is visible)")
    ap.add_argument("--alpha", type=float, default=0.15)
    ap.add_argument("--eps", type=float, default=0.5)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--max-batch", type=int, default=256)
    ap.add_argument("--rates", default="0.25,0.5,0.8",
                    help="load points as fractions of measured capacity "
                         "(values <= 1.5), or absolute qps (values > 1.5)")
    ap.add_argument("--duration-s", type=float, default=30.0)
    ap.add_argument("--queries", type=int, default=4096,
                    help="distinct query sources cycled through")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hub-split", type=int, default=None)
    ap.add_argument("--early-exit", action="store_true",
                    help="enable the annealed loop's top-k set-stability "
                         "fast exit (ids exact; values lower bounds)")
    ap.add_argument("--cohort", action="store_true",
                    help="per-row cohort streaming (requests resolve as "
                         "their rows retire)")
    ap.add_argument("--calibrate", action="store_true",
                    help="measure the walk, sweep and transfer costs at "
                         "start-up so FORA's cost model picks each width's "
                         "path with this graph's and card's constants")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="run the server's latency-targeted adaptive "
                         "dispatch cap instead of the static --max-batch")
    ap.add_argument("--precomputed", default=None, metavar="THRESHOLD[,K]",
                    help="serve from an existing BASE all-pair store "
                         "(pure precomputed reads; no device sweeps in the "
                         "serving path)")
    ap.add_argument("--prewarm", action="store_true",
                    help="daemon mode: pass --prewarm to the daemon "
                         "(in-process mode always prewarms)")
    ap.add_argument("--daemon", action="store_true",
                    help="drive the stdio daemon as a subprocess (full "
                         "wire path); --rates must be absolute qps")
    ap.add_argument("--out", default="build/serving_latency_torch.json")
    return ap.parse_args(argv)


def run(args, ds=None) -> dict:
    """The in-process measurement's record; ``ds`` is the dataset when the
    caller loaded it (``args.db`` otherwise)."""
    from ppr_tpu_torch.cli import load_dataset
    from ppr_tpu_torch.service import PPRService
    from ppr_tpu_torch.serving import PPRBatchServer
    from ppr_tpu_torch.utils import calibrate
    from ppr_tpu_torch.utils.drivers import describe

    if ds is None:
        ds = load_dataset(args.db, device=args.device)
    print(f"dataset {ds.name}: n={ds.graph.n} m={ds.graph.m} on "
          f"{ds.graph.device}", flush=True)
    if args.precomputed:
        parts = args.precomputed.split(",")
        pre = (float(parts[0]), int(parts[1]) if len(parts) > 1 else -1)
        svc = PPRService.from_dataset(ds, alpha=args.alpha, eps=args.eps,
                                      k=args.k, precomputed=pre)
    else:
        svc = PPRService.from_dataset(ds, alpha=args.alpha, eps=args.eps,
                                      k=args.k, hub_split=args.hub_split,
                                      early_exit=args.early_exit,
                                      calibrate=args.calibrate,
                                      cohort=args.cohort)
    rng = random.Random(args.seed)
    sources = [rng.randrange(ds.graph.n) for _ in range(args.queries)]

    rows = []
    # Server-side prewarm: dispatches EVERY pow2 rung up to max_batch and
    # seeds each rung's warm EWMA before any traffic. A client-side warm
    # loop cannot warm wide rungs in SLO mode: the adaptive cap starts at
    # min_batch, so a flood dispatches as narrow batches.
    with PPRBatchServer(svc, max_batch=args.max_batch,
                        slo_ms=args.slo_ms, prewarm=True) as server:
        prewarm_ms = dict(sorted(server._svc_time_ms.items()))
        print(f"prewarmed svc_time_ms: "
              f"{ {w: round(t) for w, t in prewarm_ms.items()} }",
              flush=True)
        server.stats.latencies_ms.clear()

        cap = measure_capacity(server, sources, args.max_batch)
        print(f"measured capacity: {cap:.1f} qps "
              f"(max_batch={args.max_batch})", flush=True)
        # In SLO mode the probe above runs with the policy live, so its
        # number is policy-constrained. The best warm rows-per-second over
        # the prewarmed ladder is what a static cap at that rung would
        # sustain.
        static_est = max((w / (t / 1e3)
                          for w, t in server._svc_time_ms.items()), default=None)
        if static_est:
            print(f"static-cap ceiling estimate (warm EWMA argmax w/t): "
                  f"{static_est:.1f} qps", flush=True)
        server.stats.latencies_ms.clear()

        for spec in args.rates.split(","):
            v = float(spec)
            rate = v * cap if v <= 1.5 else v
            print(f"-- load point {spec} -> {rate:.1f} qps offered", flush=True)
            row = run_rate(server, sources, rate, args.duration_s, rng)
            row["load_fraction"] = v if v <= 1.5 else None
            rows.append(row)
            print(json.dumps(row), flush=True)

    out = {
        "dataset": {"name": ds.name, "n": ds.graph.n, "m": ds.graph.m},
        "device": str(ds.graph.device),
        "card": describe(ds.graph.device)["card"],
        "capacity_qps": round(cap, 2),
        # capacity_qps is measured WITH the active policy (the SLO cap, if
        # any); capacity_static_est_qps is the static-cap ceiling derived
        # from the warm per-width EWMAs (argmax width/t). Load-fraction
        # rows use capacity_qps as their base.
        "capacity_basis": ("slo_policy" if args.slo_ms else "static_cap"),
        "capacity_static_est_qps":
            round(static_est, 2) if static_est else None,
        "load_fraction_base": "capacity_qps",
        "max_batch": args.max_batch,
        "duration_s": args.duration_s,
        "rows": rows,
    }
    algo = svc._topk_algo
    if hasattr(algo, "path_cost"):
        # the constants the cost model used, measured or the code's, and
        # the path it takes at each prewarmed rung (at eps', the query's
        # eps halved, as the loop takes it)
        out["cost_model"] = {
            "calibrate": args.calibrate,
            "constants": calibrate.constants(algo),
            "rungs": [dict(zip(("walk_ns", "spmv_ns", "path"),
                               algo.path_cost(args.eps * 0.5, w)),
                           width=w, prewarm_ms=t)
                      for w, t in prewarm_ms.items()]}
        print("cost model (" + ("calibrated" if args.calibrate else
                                "the code's constants") + "): "
              + json.dumps(out["cost_model"]["constants"]) + "; "
              + ", ".join(f"B {ch['width']} {ch['path']}"
                          for ch in out["cost_model"]["rungs"]), flush=True)
    if args.slo_ms:
        out["slo_ms"] = args.slo_ms
        out["final_dispatch_cap"] = server._cap()
        out["slo_unattainable"] = server.stats.slo_unattainable
        out["slo_unattainable_ever"] = server.stats.slo_unattainable_ever
        out["svc_time_ms"] = {str(w): round(t, 1) for w, t in
                              sorted(server._svc_time_ms.items())}
        out["cap_moves"] = server.stats.cap_moves
        out["prewarm_failed_widths"] = server.stats.prewarm_failed_widths
    return out


def main(argv=None) -> int:
    from ppr_tpu_torch.utils.drivers import no_card, write_json

    args = parse_args(argv)
    if no_card(args.device, "serving_latency_torch"):
        return 1
    if args.daemon:
        return run_daemon_mode(args)
    out = run(args)
    write_json(args.out, out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
