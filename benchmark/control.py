"""The readings that the check's limits are set from, at a cell's own size.

    python3 benchmark/control.py --workload flickr.batch --seeds 1,2,3 \\
        --seconds 5 [--out FILE.json]

For each seed, in one process: the cell's set-up and a short window at its
own load (``run.measure``), the program's answers judged on the run's
sample, then the control on the same sources: the reference computed in
bfloat16, the precision below the configuration's float32 state
(``reference.control_answers``), judged the same way. One JSON line a
seed. Runs on the card only; ``--device cpu`` is for rehearsals.

``--rows R`` reads the program instead on calls of ``R`` rows, the width of
an off-peak dispatch, where FORA's cost model may take push rounds
completed by walks in place of the annealed loop: ``--batches`` calls of
``PPRService.top_k``, each call's wall time beside the readings.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import graphgen, reference, run, traffic  # noqa: E402
from benchmark.manifest import Manifest  # noqa: E402


def readings(man: Manifest, workload: str, seed: int, seconds: float,
             device: torch.device) -> dict:
    t0 = time.perf_counter()
    m = run.measure(man, workload, seed, seconds, False, device, t0)
    eng = m.cfg["engine"]
    answers = run.sample(m.rec, m.check_rng)
    op = reference.Operator(m.src, m.dst, m.cfg["nodes"], device)
    prog = reference.judge(answers, op, eng["alpha"], eng["k"], eng["eps"])
    t = time.perf_counter()
    ctl = reference.control_answers(m.src, m.dst, m.cfg["nodes"],
                                    [s for s, _ in answers], eng["alpha"],
                                    eng["k"], device)
    control = reference.judge(ctl, op, eng["alpha"], eng["k"], eng["eps"])
    return {"workload": workload, "seed": seed, "rows": len(answers),
            "failed": m.rec.failed, "program": prog, "control": control,
            "control_s": time.perf_counter() - t,
            "peak_bytes": m.peak}


def narrow_readings(man: Manifest, workload: str, seed: int, rows: int,
                    batches: int, device: torch.device) -> dict:
    """The program's readings on ``batches`` calls of ``rows`` sources
    each, on the cell's graph from ``seed``."""
    cfg = man.config(man.cell(workload))
    eng, n = cfg["engine"], cfg["nodes"]
    src, dst = graphgen.draw(cfg, seed)
    svc, _ = run.build_service(cfg, src, dst, device)
    rng = np.random.default_rng([seed, 5])
    svc.top_k(traffic.sources(rng, n, rows))          # first call
    answers, call_ms = [], []
    for _ in range(batches):
        batch = traffic.sources(rng, n, rows)
        t = time.perf_counter()
        hits = svc.top_k(batch)
        call_ms.append((time.perf_counter() - t) * 1e3)
        answers += [(int(s), traffic._pairs(h)) for s, h in zip(batch, hits)]
    del svc
    op = reference.Operator(src, dst, n, device)
    prog = reference.judge(answers, op, eng["alpha"], eng["k"], eng["eps"])
    return {"workload": workload, "seed": seed, "rows_a_call": rows,
            "answers": len(answers), "program": prog,
            "call_ms": sorted(call_ms)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rows", type=int, default=0,
                    help="read the program on calls of this many rows")
    ap.add_argument("--batches", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card is visible", file=sys.stderr)
        return 2
    man = Manifest()
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = (narrow_readings(man, args.workload, seed, args.rows,
                               args.batches, device) if args.rows
               else readings(man, args.workload, seed, args.seconds, device))
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
