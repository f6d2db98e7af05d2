#!/usr/bin/env python3
"""The protocol on a mesh across processes, this tree beside another
commit's: ``chip_smoke.py``'s ``[dist:protocol]`` alone.

    python3 dist_protocol_ab.py --parent DIR [--out FILE.json]

Run it from the repository root on a machine with a card. ``--parent``
names an unpacked tree of another commit (``git archive``). Each tree runs
in turns (parent, this tree, this tree, parent) as 4 gloo ranks sharing
the card (``parallel/distributed.py::spawn_local``), each rank importing
that tree's package: ``PerfHarness(mesh=global_mesh(2))`` at 2x2 on the
grqc stand-in, Tests 1-2, Forward Push and BASE, as the smoke runs it.
Each run prints its wall (the slowest rank's, from a barrier after the
set-up and K3's build to the end of the tests), the bytes its ranks sent
and, where the tree has ``Mesh.wire_s``, each rank's seconds in its
collectives over its wall. The last line is one JSON object with every
run.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

_RANK = r"""
import contextlib, json, os, sys, time
tree, work = sys.argv[1], sys.argv[2]
sys.path.insert(0, tree)
import torch
import torch.distributed as dist
from ppr_tpu_torch import cli
from ppr_tpu_torch.device import set_exact_f32_matmul
from ppr_tpu_torch.harness import PerfHarness
from ppr_tpu_torch.ops import cuda_build
from ppr_tpu_torch.parallel.distributed import global_mesh, initialize_from_env

assert initialize_from_env("gloo", timeout_s=300)
rank = dist.get_rank()
dev = torch.device("cuda", torch.cuda.current_device())
set_exact_f32_matmul()
cuda_build.load_library("row_gather")    # built before the clock starts
grqc = cli.load_dataset("synth:grqc", device=dev)
mesh = global_mesh(2, devices=[dev])
out_dir = os.path.join(work, "protocol")
os.makedirs(out_dir, exist_ok=True)
harness = PerfHarness(grqc, seed=0, out_dir=out_dir, progress=False,
                      mesh=mesh)
dist.barrier()
t0 = time.perf_counter()
cwd = os.getcwd()
os.chdir(out_dir)
with open(f"rank{rank}.log", "w") as f, contextlib.redirect_stdout(f):
    harness.algo_perf_batch_test(50, 10, tests=(1, 2),
                                 algos={"FWDPUSH", "BASE_WHOLE_GRAPH"})
os.chdir(cwd)
wall = time.perf_counter() - t0
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump({"wall_s": wall, "wire_bytes": mesh.wire_bytes,
               "wire_s": getattr(mesh, "wire_s", None)}, f)
dist.barrier()
dist.destroy_process_group()
"""


def run_tree(label: str, tree: str, work: str) -> dict:
    from ppr_tpu_torch.parallel.distributed import spawn_local

    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    spawn_local(4, [sys.executable, "-c", _RANK, tree, work],
                timeout_s=600, log_dir=os.path.join(work, "logs"))
    ranks = []
    for r in range(4):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    res = {"tree": label, "wall_s": max(g["wall_s"] for g in ranks),
           "wire_bytes": sum(g["wire_bytes"] for g in ranks),
           "wire_share_by_rank": [
               None if g["wire_s"] is None else g["wire_s"] / g["wall_s"]
               for g in ranks]}
    print(f"[dist:ab] {label}: protocol wall {res['wall_s']:.2f} s, "
          f"{res['wire_bytes']} bytes sent, collectives over the wall by "
          f"rank {res['wire_share_by_rank']}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="an unpacked tree of another commit")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("dist_protocol_ab.py: no CUDA device is visible",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[dist:ab] card: {card.strip()}")
    parent = os.path.abspath(args.parent)
    scratch = os.path.join(ROOT, "build", "dist_ab")
    runs = [run_tree(label, tree, os.path.join(scratch, str(i)))
            for i, (label, tree) in enumerate((("parent", parent),
                                               ("this tree", ROOT),
                                               ("this tree", ROOT),
                                               ("parent", parent)))]
    line = json.dumps({"card": card.strip(), "runs": runs})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
