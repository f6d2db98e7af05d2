#!/usr/bin/env python3
"""K1 and K2 (``ppr_tpu_torch/csrc/dense_power.cu``) on the card, whole and
with parts switched off, at ``chip_smoke.py``'s K1 / K2 shapes.

    python3 dense_power_ablation.py [--against OTHER.cu] [--out FILE.json]

Run it from the repository root on a machine with a card and ``nvcc``.
Each variant is the kernel source with one or more text edits, built with
nvcc into ``build/ablation/`` (all builds started at once):

- ``whole``: the source as it is;
- ``no_w``: no W chunk is copied into the ring (it holds stale data);
- ``no_x``: the round's x is not staged from the peers' shared memory;
- ``no_bar``: no block barrier before each chunk's product;
- ``no_fma``: no product loop;
- ``bare``: ``no_w``, ``no_x`` and ``no_bar`` at once: the product loop
  and the round's skeleton (state update, cluster barrier) alone;
- ``all_tall``: the tall tiles' thread layout at every tile height (a
  right answer: it times the layout choice).

A variant with a part switched off computes a wrong answer; it only times
what the rest costs. ``--against`` adds another source with the same C
interface (for example the parent commit's, unpacked with ``git
archive``) as the variant ``against``. For each shape the script prints
the median ms of 10 CUDA-event-timed launches of every variant, the
plain PyTorch loop, the CUDA-graph cuBLAS loop and the FP32 bound (as
``chip_smoke.py`` computes them), and the whole variants' max abs error
against the plain loop.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(ROOT, "ppr_tpu_torch", "csrc", "dense_power.cu")
OUT_DIR = os.path.join(ROOT, "build", "ablation")

_ISSUE_W = ("    if (live) {\n      const int k0 = chunk * kChunk;",
            "    if (false) {\n      const int k0 = chunk * kChunk;")
_STAGE_X = ("      store_x(parity);     // its stage was last read two chunks "
            "ago\n      if (c + 1 < nchunks) load_x(own, c + 1);\n", "")
_FIRST_X = ("    load_x(own, 0);\n", "")
_BARRIER = ("      cp_async_wait<kAhead>();\n      __syncthreads();\n",
            "      cp_async_wait<kAhead>();\n")
_PRODUCT = ("for (int k = 0; k < S::KW; k += 4) {",
            "for (int k = 0; k < 0; k += 4) {")
_ALL_TALL = ("static constexpr bool tall = RT >= 8;",
             "static constexpr bool tall = true;")
EDITS = {
    "whole": [],
    "no_w": [_ISSUE_W],
    "no_x": [_STAGE_X, _FIRST_X],
    "no_bar": [_BARRIER],
    "no_fma": [_PRODUCT],
    "bare": [_ISSUE_W, _STAGE_X, _FIRST_X, _BARRIER],
    "all_tall": [_ALL_TALL],
}
WHOLE = ("whole", "against", "all_tall")  # the variants that are right


def variant_sources(against: str | None) -> dict[str, str]:
    """Each variant's source file, written under ``OUT_DIR``."""
    with open(SOURCE) as f:
        text = f.read()
    os.makedirs(OUT_DIR, exist_ok=True)
    paths = {}
    for name, edits in EDITS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{name}: the kernel source no longer holds "
                                 f"{old!r}; update EDITS")
            src = src.replace(old, new)
        paths[name] = os.path.join(OUT_DIR, f"{name}.cu")
        with open(paths[name], "w") as f:
            f.write(src)
    if against:
        paths["against"] = os.path.abspath(against)
    return paths


def build(paths: dict[str, str]) -> dict[str, ctypes.CDLL]:
    """nvcc every variant at once, with the port's flags."""
    from ppr_tpu_torch.ops import cuda_build

    procs = {}
    for name, src in paths.items():
        so = os.path.join(OUT_DIR, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = {line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith("0 ")}
        print(f"[build] {name}: ok", *sorted(spills), sep="; ")
        lib = ctypes.CDLL(so)
        cuda_build.bind(lib, "dense_power")
        libs[name] = lib
    return libs


def launch(lib, which: str, g, onehot, iters: int, alpha: float):
    import torch

    from ppr_tpu_torch.ops import dense_power

    out = torch.empty_like(onehot)
    stream = torch.cuda.current_stream().cuda_stream
    b, n = onehot.shape[0], g.n_pad
    if which == "k1":
        dang = dense_power._dangling_mask(g).contiguous()
        rc = lib.ppr_dense_power_iterations(
            g.dense_out.data_ptr(), onehot.data_ptr(), dang.data_ptr(),
            out.data_ptr(), b, n, iters, alpha, 1.0 - alpha, 1, stream)
    else:
        rc = lib.ppr_dense_pagerank_iterations(
            g.dense_out.data_ptr(), onehot.data_ptr(), out.data_ptr(), b, n,
            iters, 1.0 - alpha, alpha, stream)
    if rc != 0:
        raise RuntimeError(f"{which}: CUDA error {rc}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another dense_power.cu to time")
    ap.add_argument("--out", help="write the results here as JSON")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from ppr_tpu_torch.graph.io import load_default, synthetic_powerlaw
    from ppr_tpu_torch.ops import dense_power

    print(cs.card_line())
    alpha = cs.ALPHA
    libs = build(variant_sources(args.against))
    dev = torch.device("cuda")
    ds_a = load_default(device=dev)
    ds_b = synthetic_powerlaw(1000, 16, seed=11, dense_threshold=1024,
                              device=dev)
    rng = np.random.default_rng(1)
    cases = [("a", ds_a, rng.choice(ds_a.n, 50, replace=False)),
             ("b50", ds_b, rng.choice(1000, 50, replace=False)),
             ("b128", ds_b, rng.choice(1000, 128, replace=False)),
             ("b1000", ds_b, np.arange(1000))]
    results = []
    for which, iters in (("k1", cs.ITERS), ("k2", cs.K2_ITERS)):
        for tag, ds, sources in cases:
            g = ds.graph
            onehot = torch.nn.functional.one_hot(
                torch.as_tensor(sources, device=dev), g.n_pad).float()
            if which == "k1":
                def plain():
                    return dense_power.dense_power_iterations_ref(
                        g, onehot, alpha, iters)
            else:
                def plain():
                    return dense_power.dense_pagerank_iterations_ref(
                        g, onehot, 1.0 - alpha, iters)
            ref = plain()
            row = {"kernel": which, "case": tag, "n_pad": g.n_pad,
                   "batch": len(sources), "iters": iters}
            for name, lib in libs.items():
                out = launch(lib, which, g, onehot, iters, alpha)
                row[name] = cs.cuda_ms(lambda lib=lib: launch(
                    lib, which, g, onehot, iters, alpha))
                if name in WHOLE:
                    row[f"{name}_err"] = (out - ref).abs().max().item()
            row["plain_ms"] = cs.cuda_ms(plain)
            row["library_ms"] = cs.library_loop_ms(onehot, g.dense_out,
                                                   iters)
            row["bound_ms"] = cs.dense_bound(len(sources), g.n_pad, iters)[0]
            results.append(row)
            print(f"[{which}:{tag}] {json.dumps(row)}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
