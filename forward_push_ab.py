#!/usr/bin/env python3
"""The single-device forward push on the card, this tree beside another
commit's: the phases that run ``ops/push.forward_push_sweeps``.

    python3 forward_push_ab.py --parent DIR [--out FILE.json]

Run it from the repository root on a machine with a card. ``--parent``
names an unpacked tree of another commit (``git archive``). Each tree is
timed in processes of its own, in turns (parent, this tree, this tree,
parent), on the bench graph ``synthetic_powerlaw(65536, 16, seed=42,
dense_threshold=0)``:

- ``fwdpush``: ``ForwardPush.compute_whole_graph_device`` at B 2048 and
  the got sweep's smallest rmax (1e-8), as ``chip_smoke.py``'s
  ``[mesh:prep]`` reference runs it;
- ``fora_whole_graph``: ``ForaWholeGraph(completion="spmv")`` at B 64,
  eps 0.5 (``[fora:walks]``), its push rounds chosen by the clock, so the
  rounds and the push time a query are printed beside the batch's time;
- ``fora_topk_walks``: ``ForaTopk(push="reference", completion="walks")``
  at B 64, eps 0.5, k 10 (``[fora:walks]``): push+walk rounds.

Each phase runs once untimed, then five times, each between two
``torch.cuda.synchronize``; the median is printed. The first eight
``fwdpush`` rows of each tree are kept, and their largest difference
between the trees printed (the node-major push adds the dangling mass in
another order). The last line is one JSON object with every run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))

_WORKER = r"""
import json, os, statistics, sys, time
import numpy as np
import torch
from ppr_tpu_torch.graph.io import synthetic_powerlaw
from ppr_tpu_torch.models.fora import ForaTopk, ForaWholeGraph
from ppr_tpu_torch.models.forward_push import ForwardPush

ALPHA, EPS, K = 0.15, 0.5, 10
ds = synthetic_powerlaw(65536, 16, seed=42, dense_threshold=0, device="cuda")
rng = np.random.default_rng(0)
wide = rng.choice(ds.n, 2048, replace=False).astype(np.int32)
narrow = rng.integers(0, ds.n, 64).astype(np.int32)


def timed(fn):
    fn()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return res, statistics.median(times), times


out = {}
fwp = ForwardPush(ds, ALPHA)
p, ms, times = timed(lambda: fwp.compute_whole_graph_device(wide, 1e-8))
np.save(sys.argv[1], p[:8].cpu().numpy())
out["fwdpush"] = {"ms": ms, "runs_ms": times, "sweeps": fwp.last_sweeps}
del p
wg = ForaWholeGraph(ds, ALPHA, seed=7, completion="spmv")
_, ms, times = timed(lambda: wg.compute_whole_graph_batch(narrow, EPS))
out["fora_whole_graph"] = {"ms": ms, "runs_ms": times,
                           "rounds": wg.last_rounds,
                           "push_us_a_query": wg.last_push_ns / 1e3}
tk = ForaTopk(ds, ALPHA, K, seed=7, push="reference", completion="walks")
_, ms, times = timed(lambda: tk.compute_topk_batch(narrow, K, EPS))
out["fora_topk_walks"] = {"ms": ms, "runs_ms": times,
                          "rounds": tk.last_iters}
print(json.dumps(out))
"""


def run_tree(label: str, tree: str, rows_path: str) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", _WORKER, rows_path], cwd=tree,
        env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
        text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{label} failed:\n{proc.stderr[-4000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"[push:ab] {label}: " + "; ".join(
        f"{k} {v['ms']:.2f} ms" + (f" ({v['rounds']} rounds)"
                                   if "rounds" in v else "")
        for k, v in res.items()), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked tree of another commit")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    import numpy as np

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[push:ab] card: {card.strip()}")
    parent = os.path.abspath(args.parent)
    scratch = os.path.join(ROOT, "build", "push_ab")
    os.makedirs(scratch, exist_ok=True)
    runs = []
    for i, (label, tree) in enumerate((("parent", parent),
                                       ("this tree", ROOT),
                                       ("this tree", ROOT),
                                       ("parent", parent))):
        rows = os.path.join(scratch, f"rows_{i}.npy")
        runs.append({"tree": label, **run_tree(label, tree, rows)})
    diff = float(np.abs(np.load(os.path.join(scratch, "rows_0.npy"))
                        - np.load(os.path.join(scratch, "rows_1.npy"))).max())
    print(f"[push:ab] fwdpush's first 8 rows, parent against this tree: "
          f"largest difference {diff:.3e}")
    summary = {"card": card.strip(), "runs": runs, "fwdpush_max_diff": diff}
    line = json.dumps(summary)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
