#!/usr/bin/env python3
"""K3 (``ppr_tpu_torch/csrc/row_gather.cu``) on the card, whole and with
parts switched off, at ``chip_smoke.py``'s K3 shapes.

    python3 row_gather_ablation.py [--parent DIR] [--out FILE.json]

Run it from the repository root on a machine with a card and ``nvcc``.
Each variant is the kernel source built with one more ``-D`` flag into
``build/ablation/`` (all builds started at once):

- ``whole``: the source as it is;
- ``no_policy``: plain ``__ldg`` loads and plain stores, no L2 policy;
- ``unroll_1``, ``unroll_4``, ``unroll_8``: the rows a lane has in flight a
  round (the source's own choice is 2 for 16-byte loads and 8 for 4-byte
  loads);
- ``unroll_2``: 2 for 4-byte loads too;
- ``warps_8``, ``warps_16``: the warps of a block (its own choice is 4);
- ``no_store``: no output is written (a wrong answer);
- ``stream``: every edge reads its own destination's row, so nothing is
  read again from another row (a wrong answer: the ceiling of the access
  pattern).

``whole`` is also timed at other slab widths (tiles of 32, 64 and 128
columns) at the benchmark's tail. ``--parent DIR`` names an unpacked
tree of another commit (``git archive``) whose ``row_gather.cu`` has this
C interface of ``ppr_gather_segment_sum`` (``(table, src, ptr, out,
n_out, cols, width, lanes, stream)``, the layout's arguments): its
kernel is timed beside ``whole`` in turns (parent, whole, whole, parent),
and the host time of its wrappers is measured in a process of its own.

For each shape the script prints the median ms of 10 CUDA-event-timed
launches of every variant (at the benchmark's tail with L2 flushed before
each; one 64-column slab of it is also timed alone and warm, where table
and output lie in L2 whole), the ms a launch of 20 launches replayed as one
CUDA graph, whether
the right variants equal the plain version bit for bit, and the bytes a
second they reach at L2 (every row read plus the output) and against
device memory (each row once).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "ppr_tpu_torch", "csrc", "row_gather.cu")
OUT_DIR = os.path.join(ROOT, "build", "ablation")

FLAGS = {
    "whole": [],
    "unroll_2": ["-DPPR_K3_UNROLL_SCALAR=2"],
    "no_policy": ["-DPPR_K3_NO_POLICY"],
    "unroll_1": ["-DPPR_K3_UNROLL=1", "-DPPR_K3_UNROLL_SCALAR=1"],
    "unroll_4": ["-DPPR_K3_UNROLL=4", "-DPPR_K3_UNROLL_SCALAR=4"],
    "unroll_8": ["-DPPR_K3_UNROLL=8", "-DPPR_K3_UNROLL_SCALAR=8"],
    "warps_8": ["-DPPR_K3_WARPS=8"],
    "warps_16": ["-DPPR_K3_WARPS=16"],
    "no_store": ["-DPPR_K3_NO_STORE"],
    "stream": ["-DPPR_K3_SRC_IS_DST"],
}
WRONG = ("no_store", "stream")   # the variants that compute another answer
SLABS = (32, 64, 128)
GRAPH_LAUNCHES = 20
BASE_BATCH = 512   # BaseAllPair's default target_batch

# the wrappers of a tree, timed on the host: 1,000 un-synchronised calls
_HOST_SNIPPET = """
import json, time, torch
from ppr_tpu_torch.ops import probe, row_gather
dev = torch.device("cuda")
probe.ensure(dev)
def host_us(fn, calls=1000):
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us
x = torch.ones(probe.SHAPE, device=dev)
table = torch.rand((4096, 256), device=dev)
idx = (torch.arange(512, device=dev) * 7919 % 4096).to(torch.int32)
ptr = torch.arange(0, 513, device=dev)
print(json.dumps({
    "k0": host_us(lambda: probe.double(x)),
    "row_gather": host_us(lambda: row_gather.row_gather(table, idx)),
    "k3": host_us(lambda: row_gather.gather_segment_sum(table, idx, ptr)),
}))
"""


def start_builds(parent: str | None = None) -> dict:
    """Start one nvcc per variant with the port's flags; returns the
    running processes by variant name."""
    from ppr_tpu_torch.ops import cuda_build

    os.makedirs(OUT_DIR, exist_ok=True)
    sources = {name: (SOURCE, flags) for name, flags in FLAGS.items()}
    if parent:
        sources["parent"] = (os.path.join(
            parent, "ppr_tpu_torch", "csrc", "row_gather.cu"), [])
    procs = {}
    for name, (src, flags) in sources.items():
        so = os.path.join(OUT_DIR, f"row_gather-{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o", so,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return procs


def finish_builds(procs: dict) -> dict[str, ctypes.CDLL]:
    """Wait for the builds; returns the loaded libraries by variant."""
    from ppr_tpu_torch.ops import cuda_build

    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = {line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")}
        regs = re.findall(r"float4Li16ELb1.*?\n.*?\n.*?Used (\d+) registers",
                          log)
        print(f"[k3:ablation] built {name}: K3's 16-byte, 16-lane kernel "
              f"uses {'/'.join(regs) or '?'} registers", *sorted(spills),
              sep="; ")
        lib = ctypes.CDLL(so)
        if name == "parent":
            # an older source may lack the later entries: type only the
            # one timed here, whose interface it shares
            fn = lib.ppr_gather_segment_sum
            fn.argtypes = list(cuda_build.SIGNATURES["row_gather"][
                "ppr_gather_segment_sum"])
            fn.restype = ctypes.c_int
        else:
            cuda_build.bind(lib, "row_gather")
        libs[name] = lib
    return libs


def launcher(name: str, lib, table, src, ptr, out, slab=None):
    """A function that launches variant ``name`` of K3 into ``out`` on the
    current stream, in the layout the wrapper would choose (``slab``
    overrides its slab width)."""
    import torch

    from ppr_tpu_torch.ops import row_gather

    n_out, cols = out.shape
    plan = row_gather.make_plan(table.shape[0], cols, True, slab)
    args = [table.data_ptr(), src.data_ptr(), ptr.data_ptr(), out.data_ptr(),
            n_out, cols, plan.width, plan.lanes]

    def launch():
        rc = lib.ppr_gather_segment_sum(
            *args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    return launch


def ablation(libs, label, table, src, ptr, *, flush=False,
             slabs=False) -> dict:
    """Time every variant of ``libs`` on one shape and print the
    ``[k3:ablation]`` lines. Returns the row."""
    import torch

    from ppr_tpu_torch.ops import row_gather
    from ppr_tpu_torch.utils.cuda_timing import cuda_ms, graph_ms, l2_flusher

    n_out, cols = ptr.shape[0] - 1, table.shape[1]
    edges = int(ptr[-1])
    rows = int(torch.unique(src[:edges]).numel())
    l2_bytes = 4.0 * (edges + n_out) * cols
    hbm_bytes = 4.0 * ((rows + n_out) * cols + edges) + 8.0 * (n_out + 1)
    want = row_gather.gather_segment_sum_ref(table, src, ptr)
    out = torch.empty_like(want)
    before = l2_flusher(table.device) if flush else None
    plan = row_gather.make_plan(table.shape[0], cols, True)
    row = {"case": label, "segments": n_out, "edges": edges, "cols": cols,
           "tile_cols": plan.tile_cols, "flushed": flush, "variants": {}}

    def time_one(tag, launch, right):
        out.zero_()
        launch()
        torch.cuda.synchronize()
        equal = bool(torch.equal(out, want)) if right else None
        if right and not equal:
            raise RuntimeError(f"[k3:ablation] {label} {tag}: differs from "
                               "the plain version")
        ms = cuda_ms(launch, before=before)
        graph = graph_ms(launch, GRAPH_LAUNCHES, before=before)
        row["variants"][tag] = {"ms": ms, "graph_ms": graph, "equal": equal}
        print(f"[k3:ablation] {label} {tag:>13s}: {ms:.4f} ms (events, "
              f"median of 10{', L2 flushed' if flush else ''}), {graph:.4f} "
              f"ms a launch in a graph of {GRAPH_LAUNCHES}; L2 "
              f"{l2_bytes / graph / 1e9:.2f} TB/s, device memory "
              f"{hbm_bytes / graph / 1e9:.2f} TB/s"
              f"{'; equal bit for bit' if equal else ''}")

    order = list(libs)
    if "parent" in libs:   # in turns: parent, whole, whole, parent
        order = ["parent", "whole"] + [n for n in order
                                       if n not in ("parent", "whole")]
    for name in order:
        time_one(name, launcher(name, libs[name], table, src, ptr, out),
                 name not in WRONG)
    if "parent" in libs:
        for name in ("whole", "parent"):
            time_one(f"{name} again",
                     launcher(name, libs[name], table, src, ptr, out), True)
    if slabs:
        for slab in SLABS:
            time_one(f"slab {slab}", launcher(
                "whole", libs["whole"], table, src, ptr, out, slab), True)
    return row


def host_times(parent: str | None) -> dict:
    """Host microseconds a call of the three ctypes wrappers, this tree's
    and the parent's, each in a process of its own."""
    out = {}
    for name, tree in (("this tree", ROOT), ("parent", parent)):
        if tree is None:
            continue
        proc = subprocess.run(
            [sys.executable, "-c", _HOST_SNIPPET], cwd=tree,
            env={**os.environ, "PYTHONPATH": tree}, capture_output=True,
            text=True, timeout=600)
        if proc.returncode != 0:
            raise SystemExit(f"host timing of {name} failed:\n{proc.stderr}")
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"[k3:ablation] host us a call, {name}: "
              f"{json.dumps(out[name])}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked tree of another commit")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from ppr_tpu_torch.cli import load_dataset
    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.ops.hub_split import build_hub_split
    from ppr_tpu_torch.utils.cuda_timing import card_line

    print(card_line())
    procs = start_builds(args.parent)
    dev = torch.device("cuda")
    bench = synthetic_powerlaw(65536, 16, seed=42, dense_threshold=0,
                               device=dev).graph
    hs = build_hub_split(bench, 4096, torch.bfloat16)
    grqc = load_dataset("synth:grqc", device=dev).graph
    libs = finish_builds(procs)
    gen = torch.Generator(device=dev).manual_seed(3)
    results = {"card": card_line(), "shapes": []}
    for label, n_rows, src, ptr, b in (
        ("bench tail", bench.n_pad, hs.tail_src, hs.tail_ptr, 2048),
        # one slab of it: the table and the output lie in L2 whole
        ("bench tail at B 64", bench.n_pad, hs.tail_src, hs.tail_ptr, 64),
        ("grqc by-dst", grqc.n_pad, grqc.edge_src_bydst, grqc.bydst_ptr, 50),
        ("grqc by-src", grqc.n_pad, grqc.edge_dst, grqc.bysrc_ptr, 50),
        ("grqc by-src, BASE batch", grqc.n_pad, grqc.edge_dst,
         grqc.bysrc_ptr, BASE_BATCH),
    ):
        table = torch.rand((n_rows, b), device=dev, generator=gen)
        tail = label == "bench tail"
        # at the protocol's small shapes: the parent and what the launch's
        # shape could choose between
        use = libs if tail else {k: v for k, v in libs.items() if k in (
            "whole", "parent", "unroll_1", "unroll_2", "unroll_4",
            "unroll_8", "warps_8")}
        results["shapes"].append(ablation(
            use, label, table, src, ptr, flush=tail, slabs=tail))
        del table
    results["host_us"] = host_times(args.parent)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
