"""Make the JAX package's reference rows for ``protocol_grid_torch.py``:
each command of :data:`COMMANDS` runs ``python -m ppr_tpu.cli`` on the CPU
(``JAX_PLATFORMS=cpu``) from a fresh directory, and its report is kept,
with the exact command, its seconds and the host's CPU, as one block of
``results/protocol_grid_jax_cpu.json``.

Usage::

    python3 protocol_grid_reference.py [--only NAME,...] [--out FILE]

A block already in ``--out`` is not run again (delete it from the file to
remake it). This script is the one place where the grid touches the JAX
package, and it does so only through the JAX CLI in a child process: it
imports neither JAX nor ``ppr_tpu``.
"""

from __future__ import annotations

import argparse
import fcntl
import json
import os
import platform
import shlex
import shutil
import subprocess
import sys
import time

from ppr_tpu_torch.utils.report import read_protocol_rows

OUT = os.path.join("results", "protocol_grid_jax_cpu.json")
WORK = os.path.join("build", "ppr_tpu_torch", "grid", "jax_cpu")
COMMON = ["--query", "50", "--k", "10", "--budget-s", "0"]

#: name -> the JAX CLI's arguments (``--out-dir`` is added). Each section's
#: first param runs and no other, however fast (``--budget-s 0`` stops a
#: section after it), so a row's draw index is its position in the
#: command's report, and the port's run of the same command draws the same
#: sources on any device. FORA's rows are made
#: with walk completion: FORA's cost model is priced per device, and
#: ``auto`` could pick another completion on each package's device.
COMMANDS = {
    "blogcatalog_t12": ["--db", "synth:blogcatalog", "--tests", "1,2",
                        "--algos", "FWDPUSH,NEO4J_METHOD,BASE_WHOLE_GRAPH"],
    "blogcatalog_t12_walks": ["--db", "synth:blogcatalog", "--tests", "1,2",
                              "--algos", "MC,FORA_WHOLE_GRAPH,FORA_TOPK",
                              "--fora-completion", "walks"],
    "blogcatalog_t3": ["--db", "synth:blogcatalog", "--tests", "3",
                       "--algos", "NEO4J_METHOD,FWDPUSH,BASE_WHOLE_GRAPH"],
    "blogcatalog_t3_walks": ["--db", "synth:blogcatalog", "--tests", "3",
                             "--algos", "MC,FORA_WHOLE_GRAPH",
                             "--fora-completion", "walks"],
    "flickr_t12": ["--db", "synth:flickr", "--tests", "1,2",
                   "--algos", "FWDPUSH,NEO4J_METHOD"],
    # flickr's Test 3 Forward Push (81,920 sources at rmax 5e-5) would take
    # hours here: its reference is the banked TPU row
    "flickr_t3_neo4j": ["--db", "synth:flickr", "--tests", "3",
                        "--algos", "NEO4J_METHOD"],
    "amazon_t12": ["--db", "synth:amazon", "--tests", "1,2",
                   "--algos", "FWDPUSH,NEO4J_METHOD"],
    "amazon_t2": ["--db", "synth:amazon", "--tests", "2",
                  "--algos", "FWDPUSH,NEO4J_METHOD"],
    # amazon's Test 3 Forward Push, Monte-Carlo and FORA: the banked rows
    "amazon_t3_neo4j": ["--db", "synth:amazon", "--tests", "3",
                        "--algos", "NEO4J_METHOD"],
}


def cpu_line() -> str:
    name = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return f"{name}, {os.cpu_count()} CPUs"


def load(path: str) -> dict:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return {"blocks": {}}


def run_block(name: str, args: list[str]) -> dict:
    """Run one JAX CLI command from a fresh directory and return its block
    record: the command, its seconds, the CPU and the report's text."""
    work = os.path.abspath(os.path.join(WORK, name))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    argv = [sys.executable, "-m", "ppr_tpu.cli", *args, *COMMON,
            "--out-dir", "."]
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [os.path.abspath("."), os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    with open(os.path.join(work, "cli.log"), "w") as log:
        subprocess.run(argv, cwd=work, env=env, stdout=log,
                       stderr=subprocess.STDOUT, check=True)
    seconds = time.perf_counter() - t0
    [report] = [f for f in os.listdir(work)
                if f.endswith("_AlgoPerfResults.txt")]
    with open(os.path.join(work, report)) as f:
        text = f.read()
    shutil.rmtree(work, ignore_errors=True)   # the stores
    return {
        "command": "JAX_PLATFORMS=cpu python -m ppr_tpu.cli "
                   + shlex.join([*args, *COMMON]),
        "seconds": round(seconds, 1),
        "cpu": cpu_line(),
        "report": text,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", default=None,
                   help="comma list of COMMANDS names (default: all)")
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    names = args.only.split(",") if args.only else list(COMMANDS)
    for name in names:
        record = load(args.out)
        if name in record["blocks"]:
            print(f"{name}: in {args.out}, not run again")
            continue
        print(f"{name}: {shlex.join(COMMANDS[name])}", flush=True)
        block = run_block(name, COMMANDS[name])
        os.makedirs(WORK, exist_ok=True)
        with open(os.path.join(WORK, "lock"), "w") as lock:
            # another run may be adding blocks to the same file
            fcntl.flock(lock, fcntl.LOCK_EX)
            record = load(args.out)
            record["blocks"][name] = block
            with open(args.out + ".tmp", "w") as f:
                json.dump(record, f, indent=1)
            os.replace(args.out + ".tmp", args.out)
        print(f"{name}: {len(read_protocol_rows(block['report']))} rows in "
              f"{block['seconds']} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
