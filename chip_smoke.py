#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check what it returns.

Run from the repository root, on a machine with a CUDA card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, one or more printed lines each; any failed check raises and the
script exits non-zero:

1. the card (``nvidia-smi`` name and power limit) and the torch build;
2. build: ``ppr_tpu_torch/csrc/dense_power.cu`` (K1, K2),
   ``csrc/probe.cu`` (K0) and ``csrc/row_gather.cu`` (K3 and the
   row-gather probes P1-P4), one nvcc each, started together; ptxas lines;
3. K0, the toolchain probe, against ``2 * x`` bit for bit;
4. K1 against its plain PyTorch version and against the sparse power
   method, at the paths' shapes: the 107-node GOT-scale graph (n_pad 128,
   B 50; ``[k1:a]``) and a 1000-node graph at the kernels' limit (n_pad
   1024) at B 50, 128 and 1000 (``[k1:b50]``, ``[k1:b128]``,
   ``[k1:b1000]``): the largest error, bit-equality of two launches, and
   median times of 10 CUDA-event-timed runs of the kernel, of the plain
   version and of ``library_ms``, the cuBLAS yardstick (``iters`` chained
   FP32 ``torch.matmul`` products, TF32 off, replayed as one CUDA graph),
   beside ``bound_ms``, the FP32 bound (2 B n^2 FLOP a round at 67
   TFLOP/s), and the share;
5. K2 the same way (``[k2:*]``; normalized, against the sparse Neo4j
   iteration; 300 rounds);
6. K3 (``gather_segment_sum``) against its plain version
   (``index_select`` + ``segment_reduce``) at the benchmark's tail (B
   2048) and at the sparse ca-GrQc-scale graph's by-destination (forward
   push, B 50) and by-source (backward push, B 50 and BASE's batch of
   512 targets) edge orders; then ``row_gather`` at P1's shape and P4's
   four configurations, in ns a row beside ``index_select`` (P4's
   ``gather_accum`` is K3 beside ``index_add_``);
7. the serving path: the oracle (``PowerMethod``, through K1) on the
   GOT-scale graph; FORA top-k serving (``PPRService.top_k``) there,
   precision@10 against that oracle; and the benchmark size (65,536
   nodes, ~1M edges, B 2048, 4096 bf16 hubs, the tail through K3):
   throughput, sweep count, peak memory, precision@10 of the timed call
   against the port's power method, which is itself checked against a
   float64 scipy power iteration;
8. a ``torch.profiler`` trace of one more batch at that size: kernel time
   by operator, K3's share, the span from first to last kernel, and the
   device's idle share in it. The chrome trace is written to
   ``build/ppr_tpu_torch/bench_trace.json``;
9. the protocol path: the port's CLI (``ppr_tpu_torch.cli.main``)
   in-process, run from ``build/ppr_tpu_torch/protocol/<run>/`` (its
   preprocessing stores land there, its output goes to ``cli.log``), on
   the GOT-scale graph (Neo4j method Tests 1-3 and FORA top-k Test 2; then
   Forward Push and BASE, Tests 1-3, as a run of their own), on the
   1000-node graph (Tests 1 and 3, through K2 at n_pad 1024), and on the
   sparse ca-GrQc-scale graph (the Neo4j method, then Forward Push and
   BASE, Tests 1 and 2; no K2, K3 in every push). Each row's accuracy is
   held to a bar: the Neo4j rows to fixed bars, the Forward Push and
   BASE rows to the JAX package's values for the same command on the CPU
   (``JAX_ROWS``). A Neo4j store is read back against a direct K2 launch,
   and a Forward Push store against a direct push.

Launch counts are reset before the serving path (7) and read after it,
and again before and after the protocol path (9); a reset also forgets
the probe, so each path runs K0 once before its first hand kernel. The
last three lines are the kernels' JSON record (``launches`` summed over
the two paths; ``row_gather`` is a microbenchmark, as P1-P4 were on the
TPU, so no path launches it; ``ms``, ``plain_ms``, ``library_ms``,
``bound_ms`` and ``bound_by`` at one shape each, and ``shapes`` with
every shape's), the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA card the script prints
no result and exits 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ALPHA, EPS, K = 0.15, 0.5, 10
ITERS = 100
K1_TOL = 2e-5
K2_ITERS = 300
K2_TOL = 2e-5      # x keeps unit mass, so its rounding builds up over rounds
PROTOCOL_ERR = 1e-6
PROTOCOL_DIR = os.path.join("build", "ppr_tpu_torch", "protocol")
K3_TOL = 1e-5      # K3 vs plain, relative to the row's largest magnitude
BASE_BATCH = 512   # BaseAllPair's default target_batch

# The JAX package's rows for the same commands on the CPU (JAX_PLATFORMS=
# cpu python -m ppr_tpu.cli --db <graph> --query 50 --k 10 --algos
# FWDPUSH,BASE_WHOLE_GRAPH, --sweep got --tests 1,2,3 and --tests 1,2):
# max-err for Tests 1 and 3, precision for Test 2, by sweep value. The
# bars: Forward Push max-err within 1% + 1e-7, BASE's within 1e-3 (it
# keeps only pi >= threshold, so its error is that cut, not rounding);
# precision within 0.002, one id of the 500.
JAX_ROWS = {
    "got": {
        (1, "FWDPUSH"): {
            "0.0001": 5.396546423435211e-04, "1e-05": 5.796276032924652e-05,
            "1e-06": 6.0315430164337155e-06, "1e-07": 5.520880222320556e-07,
            "1e-08": 6.280839443206787e-08},
        (1, "BASE_WHOLE_GRAPH"): {
            "0.001": 0.1436264109611511, "0.0005": 0.270123892724514,
            "5e-05": 0.30675475746393205, "1e-06": 0.15523052603006363,
            "5e-07": 0.16317448645830154},
        (2, "BASE_WHOLE_GRAPH"): {
            "0.001": 1.0, "0.0005": 1.0, "5e-05": 1.0, "1e-06": 1.0,
            "5e-07": 1.0},
        (2, "FWDPUSH"): {
            "0.0001": 0.998, "1e-05": 0.9981818181818182,
            "1e-06": 0.9981818181818182, "1e-07": 0.9963636363636365,
            "1e-08": 1.0},
        (3, "FWDPUSH"): {
            "0.0001": 5.382286757230759e-04, "1e-05": 5.965188145637512e-05,
            "1e-06": 6.319507956504822e-06, "1e-07": 6.040185689926147e-07,
            "1e-08": 6.660819053649902e-08},
        (3, "BASE_WHOLE_GRAPH"): {
            "0.001": 0.12949755042791367, "0.0005": 0.29791304767131804,
            "5e-05": 0.22728278249502182, "1e-06": 0.14193972259759902,
            "5e-07": 0.24812805980443955},
    },
    "grqc": {
        (1, "FWDPUSH"): {
            "0.0001": 4.18774276971817e-03, "1e-05": 7.52914845943451e-04,
            "1e-06": 9.821891784667968e-05, "1e-07": 1.0899603366851807e-05,
            "1e-08": 1.169741153717041e-06},
        (1, "BASE_WHOLE_GRAPH"): {
            "0.001": 0.3595228758454323, "0.0005": 0.22844475865364075,
            "5e-05": 0.3870604604482651, "1e-06": 0.24909481287002563,
            "5e-07": 0.30054815113544464},
        (2, "BASE_WHOLE_GRAPH"): {
            "0.001": 0.9940000000000001, "0.0005": 0.998, "5e-05": 1.0,
            "1e-07": 1.0, "5e-08": 1.0},
        (2, "FWDPUSH"): {
            "0.0001": 0.9821818181818182, "1e-06": 0.9981818181818182,
            "5e-08": 0.9946969696969696, "7e-09": 1.0, "7e-10": 1.0},
    },
}


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = 10) -> float:
    """Median milliseconds of ``runs`` calls, each between CUDA events,
    after one warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def scipy_power_method(g, sources, alpha, iters=ITERS) -> np.ndarray:
    """Float64 power iteration with dangling mass to the source."""
    import scipy.sparse as sp

    n = g.n
    src = g.edge_src[: g.m].cpu().numpy()
    dst = g.edge_dst[: g.m].cpu().numpy()
    deg = g.out_deg[:n].cpu().numpy().astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    P = sp.coo_matrix((inv[src], (src, dst)), shape=(n, n)).tocsr()
    dangling = deg == 0
    out = np.zeros((len(sources), g.n_pad))
    for i, s in enumerate(sources):
        p = np.zeros(n)
        r = np.zeros(n)
        r[int(s)] = 1.0
        for _ in range(iters):
            p += alpha * r
            rem = (1 - alpha) * r
            dm = rem[dangling].sum()
            r = rem @ P
            r[int(s)] += dm
        out[i, :n] = p
    return out


def precision(oracle, rows_ids, k=K) -> float:
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties
    from ppr_tpu_torch.utils.metrics import precision_at_k

    return float(np.mean([
        precision_at_k(np.asarray(ids), topk_ids_with_ties(oracle[i], k))
        for i, ids in enumerate(rows_ids)
    ]))


def tie_tolerant_ids(vals, ids, n_rows, tol):
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs

    return [topk_ids_with_ties_from_pairs(vals[i], ids[i], K, tol=tol)
            for i in range(n_rows)]


def rel_err(got, want) -> float:
    """The largest ``|got - want|`` of a row over that row's largest
    ``|want|``."""
    scale = want.abs().amax(dim=1).clamp_min(1e-30)
    return float(((got - want).abs().amax(dim=1) / scale).max())


def k3_phase(dev, bench_g, hs, grqc_g) -> dict:
    """K3 against its plain version at the shapes the paths give it: the
    benchmark's tail edges at B 2048 (FORA serving) and the sparse
    ca-GrQc-scale graph's by-destination (forward push) and by-source
    (backward push) orders at B 50, and by source at BASE's batch of 512
    targets, which takes the 16-byte loads."""
    import torch

    from ppr_tpu_torch.ops import row_gather as rgm

    out = {"max_abs_err": 0.0, "shapes": []}
    gen = torch.Generator(device=dev).manual_seed(3)
    for label, n_rows, src, ptr, b in (
        ("bench tail", bench_g.n_pad, hs.tail_src, hs.tail_ptr, 2048),
        ("grqc by-dst", grqc_g.n_pad, grqc_g.edge_src_bydst,
         grqc_g.bydst_ptr, 50),
        ("grqc by-src", grqc_g.n_pad, grqc_g.edge_dst, grqc_g.bysrc_ptr, 50),
        ("grqc by-src, BASE batch", grqc_g.n_pad, grqc_g.edge_dst,
         grqc_g.bysrc_ptr, BASE_BATCH),
    ):
        table = torch.rand((n_rows, b), device=dev, generator=gen)
        got = rgm.gather_segment_sum(table, src, ptr)
        want = rgm.gather_segment_sum_ref(table, src, ptr)
        torch.cuda.synchronize()
        err, rel = float((got - want).abs().max()), rel_err(got, want)
        ms = cuda_ms(lambda: rgm.gather_segment_sum(table, src, ptr))
        plain_ms = cuda_ms(lambda: rgm.gather_segment_sum_ref(table, src, ptr))
        edges = int(ptr[-1])
        segments = ptr.shape[0] - 1
        rows = int(torch.unique(src[:edges]).numel())
        bound_ms, bound_by = bound(float(edges) * b, 4.0 * (
            (rows + segments) * b + edges) + 8.0 * (segments + 1))
        print(f"[k3] {label}: {segments} segments, {edges} edges, "
              f"B={b}: max abs err {err:.3e} (relative to the row "
              f"{rel:.3e}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
              f"(median of 10), {plain_ms / ms:.2f}x; bound_ms "
              f"{bound_ms:.4f} ({bound_by}: {rows} distinct rows read)")
        check(rel <= K3_TOL, f"K3 {label}: relative error {rel} > {K3_TOL}")
        check(bool(torch.isfinite(got).all()), f"K3 {label}: not finite")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["shapes"].append({"case": label, "segments": segments,
                              "edges": edges, "cols": b, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by})
        del table, got, want
    out.update({key: out["shapes"][0][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by")})
    return out


def gather_probes(dev, k3: dict) -> dict:
    """``row_gather`` at P1's shape (P2 and P3 gather the same rows) and
    P4's ``gather`` configurations, against ``index_select``; P4's
    ``gather_accum`` through K3 (destinations sorted once, stably) against
    ``index_add_``. Adds the accumulate case to ``k3['shapes']``."""
    import torch

    from ppr_tpu_torch.ops import row_gather as rgm

    def ns_per_row(ms, rows):
        return ms * 1e6 / rows

    out = {"max_abs_err": 0.0, "shapes": []}
    gen = torch.Generator(device=dev).manual_seed(4)
    for label, n, b, w, mode in (("P1-P3", 4096, 256, 512, "gather"),
                                 ("P4", 4096, 128, 8192, "gather"),
                                 ("P4", 4096, 512, 8192, "gather"),
                                 ("P4", 4096, 512, 8192, "gather_accum"),
                                 ("P4", 16384, 512, 8192, "gather")):
        table = torch.rand((n, b), device=dev, generator=gen)
        i = torch.arange(w, device=dev)
        src = (i * 7919 % n).to(torch.int32)
        if mode == "gather":
            got = rgm.row_gather(table, src)
            torch.cuda.synchronize()
            check(torch.equal(got, rgm.row_gather_ref(table, src)),
                  f"row_gather {label} [{n}, {b}]: differs from index_select")
            ms = cuda_ms(lambda: rgm.row_gather(table, src))
            plain_ms = cuda_ms(lambda: rgm.row_gather_ref(table, src))
            err, plain = 0.0, "index_select"
            rows = int(torch.unique(src).numel())
            bound_ms, bound_by = bound(0.0, 4.0 * (rows * b + w + w * b))
        else:
            dst = i * 104729 % 512
            order = torch.sort(dst, stable=True).indices
            src_s = src[order].contiguous()
            ptr = torch.searchsorted(dst[order], torch.arange(513, device=dev))

            def plain_accum():
                return torch.zeros((512, b), device=dev).index_add_(
                    0, dst, table.index_select(0, src))

            got = rgm.gather_segment_sum(table, src_s, ptr)
            want = plain_accum()
            torch.cuda.synchronize()
            err, rel = float((got - want).abs().max()), rel_err(got, want)
            check(rel <= K3_TOL, f"K3 {label} accumulate: relative error "
                  f"{rel} > {K3_TOL}")
            ms = cuda_ms(lambda: rgm.gather_segment_sum(table, src_s, ptr))
            plain_ms = cuda_ms(plain_accum)
            plain = "index_select + index_add_"
            rows = int(torch.unique(src).numel())
            bound_ms, bound_by = bound(float(w) * b, 4.0 * (
                rows * b + w + 512 * b) + 8.0 * 513)
        print(f"[p1-p4] {label} {mode} table [{n}, {b}], {w} rows: kernel "
              f"{ns_per_row(ms, w):.2f} ns/row ({ms:.4f} ms), {plain} "
              f"{ns_per_row(plain_ms, w):.2f} ns/row ({plain_ms:.4f} ms); "
              f"max abs err {err:.3e}; bound_ms {bound_ms:.4f} ({bound_by})")
        shape = {"case": f"{label} {mode}", "table": [n, b], "rows": w,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "ns_per_row": ns_per_row(ms, w),
                 "plain_ns_per_row": ns_per_row(plain_ms, w)}
        if mode == "gather":
            out["shapes"].append(shape)
        else:
            k3["shapes"].append(shape)
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
    out.update({key: out["shapes"][0][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by")})
    return out


# Published H100 SXM peaks (NVIDIA's data sheet, dense, 700 W): FP32
# outside the tensor cores and HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for ``flop`` FP32 operations and
    ``nbytes`` moved (each input read once, each output written once), in
    ms, and which of the two sets it."""
    f_ms, b_ms = flop / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def library_loop_ms(x0, w, iters: int) -> float:
    """The library yardstick of K1 / K2: ``iters`` chained cuBLAS FP32
    products ``x <- x @ W`` (TF32 off) into two alternating buffers,
    captured in one CUDA graph and timed as one replay, so the host's
    launch latency is not counted."""
    import torch

    from ppr_tpu_torch.device import set_exact_f32_matmul

    set_exact_f32_matmul()
    bufs = [x0.clone(), torch.empty_like(x0)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # cuBLAS's handle and workspace
        torch.matmul(bufs[0], w, out=bufs[1])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            torch.matmul(bufs[i % 2], w, out=bufs[1 - i % 2])
    ms = cuda_ms(graph.replay)
    del graph
    return ms


def dense_bound(b: int, n: int, iters: int) -> tuple[float, str]:
    """K1 / K2: 2 B n^2 FLOP a round; W, the one-hot and the result."""
    return bound(2.0 * b * n * n * iters, 4.0 * (n * n + 2 * b * n + n))


def dense_phase(dev, ds_a, ds_a_sparse, sources_50):
    """K1 and K2 against their plain versions and the sparse paths at the
    paths' shapes: n_pad 128 B 50 (``a``: the GOT-scale oracle and Neo4j
    Test 1) and n_pad 1024 at B 50 (Test 1), 128 (a preprocessing batch)
    and 1000 (the whole graph), with the times of the kernel, the plain
    version and ``iters`` cuBLAS FP32 products (the library yardstick), the
    FP32 bound and bit-equality of two launches."""
    import torch

    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.models.neo4j_method import personalized_pagerank_batch
    from ppr_tpu_torch.models.power_method import power_method_batch
    from ppr_tpu_torch.ops import dense_power

    ds_b = synthetic_powerlaw(1000, 16, seed=11, dense_threshold=1024,
                              device=dev)
    ds_b_sparse = synthetic_powerlaw(1000, 16, seed=11, dense_threshold=0,
                                     device=dev)
    rng = np.random.default_rng(1)
    cases = [("a", ds_a, ds_a_sparse, sources_50),
             ("b50", ds_b, ds_b_sparse, rng.choice(1000, 50, replace=False)),
             ("b128", ds_b, ds_b_sparse, rng.choice(1000, 128,
                                                    replace=False)),
             ("b1000", ds_b, ds_b_sparse, np.arange(1000))]
    damping = 1.0 - ALPHA
    k1 = {"max_abs_err": 0.0, "shapes": []}
    k2 = {"max_abs_err": 0.0, "shapes": []}
    for name, k, iters, tol in (("k1", k1, ITERS, K1_TOL),
                                ("k2", k2, K2_ITERS, K2_TOL)):
        for tag, ds, ds_sparse, sources in cases:
            g = ds.graph
            check(dense_power.supports(g), f"{name} does not support {tag}")
            onehot = torch.nn.functional.one_hot(
                torch.as_tensor(sources, device=dev), g.n_pad).float()
            if name == "k1":
                def kernel():
                    return dense_power.dense_power_iterations(
                        g, onehot, ALPHA, iters)

                def plain():
                    return dense_power.dense_power_iterations_ref(
                        g, onehot, ALPHA, iters)
                sparse = power_method_batch(ds_sparse.graph, sources, ALPHA,
                                            iters)
            else:
                def kernel():
                    return dense_power.dense_pagerank_iterations(
                        g, onehot, damping, iters)

                def plain():
                    return dense_power.dense_pagerank_iterations_ref(
                        g, onehot, damping, iters)
                sparse = personalized_pagerank_batch(
                    ds_sparse.graph, sources, damping, iters)
            out, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            err_ref = (out - ref).abs().max().item()
            normed = out if name == "k1" else out / out.sum(-1, keepdim=True)
            err_sparse = (normed - sparse).abs().max().item()
            equal = torch.equal(out, again)
            extra = ""
            if name == "k1":
                nd = dense_power.dense_power_iterations(
                    g, onehot, ALPHA, iters, dangling_to_source=False)
                nd_ref = dense_power.dense_power_iterations_ref(
                    g, onehot, ALPHA, iters, dangling_to_source=False)
                err_nd = (nd - nd_ref).abs().max().item()
                extra = f" (no-dangling variant {err_nd:.3e})"
                check(err_nd <= tol, f"K1 {tag} no-dangling: {err_nd}")
                err_ref = max(err_ref, err_nd)
                if tag == "a":
                    k["out_a"] = out.cpu().numpy()
            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(plain)
            library_ms = library_loop_ms(onehot, g.dense_out, iters)
            round_ms = library_ms / iters
            b, n = len(sources), g.n_pad
            bound_ms, bound_by = dense_bound(b, n, iters)
            print(f"[{name}:{tag}] n={g.n} n_pad={n} B={b} iters={iters}: "
                  f"max|kernel-plain|={err_ref:.3e} "
                  f"max|kernel-sparse|={err_sparse:.3e}{extra}, two "
                  f"launches bit-equal: {equal}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, library_ms {library_ms:.4f} ({iters} "
                  f"chained torch.matmul FP32 in one CUDA graph, "
                  f"{round_ms:.4f} ms a product), bound_ms "
                  f"{bound_ms:.4f} ({bound_by}), share {bound_ms / ms:.3f} "
                  f"(medians of 10)")
            for what, err in (("plain", err_ref), ("sparse", err_sparse)):
                check(err <= tol, f"{name} {tag}: |kernel-{what}| = {err}")
            check(equal, f"{name} {tag}: two launches differ")
            check(bool(torch.isfinite(out).all()), f"{name} {tag}: not finite")
            k["max_abs_err"] = max(k["max_abs_err"], err_ref)
            k["shapes"].append({
                "case": tag, "n_pad": n, "batch": b, "iters": iters,
                "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
                "bound_ms": bound_ms, "bound_by": bound_by})
        # the line's headline: shape a (n_pad 128, B 50), as in earlier
        # lines; the n_pad 1024 shapes are in "shapes"
        k.update({key: k["shapes"][0][key] for key in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")})
    return k1, k2


def profile_batch(algo, sources) -> None:
    """Trace one ``compute_topk_ids_batch``; print device time by aten
    operator, the kernels' span and the idle share inside it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join("build", "ppr_tpu_torch", "bench_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        algo.compute_topk_ids_batch(sources, K, EPS)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "kernel"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events]
    check(bool(kernels), "the profiler recorded no kernel")
    busy_us, covered_to = 0.0, float("-inf")
    for start, end in sorted(kernels):
        busy_us += max(0.0, end - max(start, covered_to))
        covered_to = max(covered_to, end)
    span_us = covered_to - min(s for s, _ in kernels)
    sweeps = algo.last_iters
    print(f"[profile] one batch, {sweeps} sweeps: {len(kernels)} kernels, "
          f"busy {busy_us / 1e3:.1f} ms in a span of {span_us / 1e3:.1f} ms "
          f"(idle {100 * (1 - busy_us / span_us):.1f}%), host wall "
          f"{wall_ms:.1f} ms; trace {path}")
    mine = [e["dur"] for e in events
            if "ppr_gather_segment_sum_kernel" in e.get("name", "")]
    check(bool(mine), "the traced batch ran no K3")
    print(f"[profile] {'K3 gather_segment_sum':32s} {sum(mine) / 1e3:9.2f} ms "
          f"{100 * sum(mine) / busy_us:5.1f}% {len(mine):6d} launches "
          f"{sum(mine) / 1e3 / sweeps:7.3f} ms/sweep")
    # kernels also appear under their own names: keep the aten operators
    ops = [e for e in prof.key_averages()
           if e.key.startswith("aten::") and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:16]:
        us = e.self_device_time_total
        print(f"[profile] {e.key:32s} {us / 1e3:9.2f} ms "
              f"{100 * us / busy_us:5.1f}% {e.count:6d} calls "
              f"{us / 1e3 / sweeps:7.3f} ms/sweep")


def reset_launches() -> None:
    """Zero every kernel's launch count; forget the probe, so K0 runs
    again before the next hand-kernel launch."""
    from ppr_tpu_torch.ops import dense_power, probe, row_gather

    dense_power.launches = 0
    dense_power.pagerank_launches = 0
    row_gather.segment_sum_launches = 0
    row_gather.gather_launches = 0
    probe.reset()


def read_launches() -> dict[str, int]:
    from ppr_tpu_torch.ops import dense_power, probe, row_gather

    return {"k1": dense_power.launches, "k2": dense_power.pagerank_launches,
            "k0": probe.launches, "k3": row_gather.segment_sum_launches,
            "gather": row_gather.gather_launches}


def protocol_rows(path: str) -> dict[tuple[int, str], list[list[str]]]:
    """Data rows of a ``<name>_AlgoPerfResults.txt``, by (test, algorithm)
    section."""
    rows: dict[tuple[int, str], list[list[str]]] = {}
    key = None
    with open(path) as f:
        for line in f.read().splitlines():
            m = re.fullmatch(r"(\d)\.\d+ (\w+)", line)
            if m:
                key = (int(m[1]), m[2])
            elif key and "," in line and not line.startswith("#"):
                rows.setdefault(key, []).append(line.split(","))
    return rows


def run_protocol(tag: str, argv: list[str]):
    """``ppr_tpu_torch.cli.main(argv)`` in-process from a fresh
    ``build/ppr_tpu_torch/protocol/<tag>/``, its output in ``cli.log``
    there. Returns the result rows, the wall seconds and the directory."""
    from ppr_tpu_torch import cli

    work = os.path.abspath(os.path.join(PROTOCOL_DIR, tag))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    log = os.path.join(work, "cli.log")
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        os.chdir(work)
        with open(log, "w") as f, contextlib.redirect_stdout(f):
            cli.main([*argv, "--out-dir", work, "--device", "cuda"])
    except BaseException:
        with open(log) as f:
            sys.stderr.write(f.read()[-4000:])
        raise
    finally:
        os.chdir(cwd)
    wall = time.perf_counter() - t0
    [name] = [f for f in os.listdir(work) if f.endswith("_AlgoPerfResults.txt")]
    return protocol_rows(os.path.join(work, name)), wall, work


def check_protocol_rows(tag: str, rows, *, top_iters=40, err_iters=100,
                        err=PROTOCOL_ERR, jax_rows=None) -> None:
    """Print every row and hold it to its bar: the Neo4j rows to max-err
    <= err from ``err_iters`` iterations, precision 1.0 and NDCG >= 0.999
    from ``top_iters``; the Forward Push and BASE rows to ``jax_rows``,
    every one of which must be present; preprocessing bytes > 0; every
    number finite.

    Row formats (Gen_Util.java): Test 1 ``param, ms, err``; Test 2 ``param,
    k, ms, precision, NDCG``; Test 3 ``param, threshold, prep_ms, bytes,
    err``. BASE's rows carry ``-1, threshold`` (Tests 1 and 3) or
    ``threshold, k`` (Test 2), then ``prep_ms, bytes``, then its query ms
    (Tests 1 and 2) and the accuracy fields. So ``prep_ms, bytes`` are the
    third and fourth fields wherever they appear."""
    check(bool(rows), f"[protocol:{tag}] no result rows")
    seen = set()
    for (test, algo), section in sorted(rows.items()):
        base = algo == "BASE_WHOLE_GRAPH"
        for fields in section:
            check(all(np.isfinite(float(x)) for x in fields),
                  f"[protocol:{tag}] {test} {algo} {fields}: not finite")
            value = fields[1] if base and test != 2 else fields[0]
            prep = ""
            if base or test == 3:
                ms, nbytes = float(fields[2]), int(fields[3])
                check(nbytes > 0, f"[protocol:{tag}] empty store: {fields}")
                prep = f"prep_ms {ms:.1f}, store {nbytes} bytes, "
            if test == 2:
                q_ms, prec, ndcg = (float(x) for x in fields[-3:])
                line = (f"{q_ms:.3f} ms/query, precision {prec:.4f}, "
                        f"NDCG {ndcg:.6f}")
                got = prec
            else:
                e = float(fields[-1])
                line = f"max-err {e:.3e}"
                if test == 1:
                    line = f"{float(fields[-2]):.3f} ms/query, {line}"
                got = e
            print(f"[protocol:{tag}] test {test} {algo} param {value}: "
                  f"{prep}{line}")
            if algo == "NEO4J_METHOD":
                param = float(value)
                if test in (1, 3) and param >= err_iters:
                    check(e <= err, f"[protocol:{tag}] test {test} iters "
                          f"{value}: max-err {e} > {err}")
                if test == 2 and param >= top_iters:
                    check(prec == 1.0 and ndcg >= 0.999,
                          f"[protocol:{tag}] test 2 iters {value}: "
                          f"precision {prec}, NDCG {ndcg}")
            want = (jax_rows or {}).get((test, algo), {}).get(value)
            if want is None:
                continue
            seen.add((test, algo, value))
            bar = (0.002 if test == 2 else
                   1e-3 if base else 0.01 * want + 1e-7)
            check(abs(got - want) <= bar,
                  f"[protocol:{tag}] test {test} {algo} {value}: {got} vs "
                  f"JAX's {want} (bar {bar:.3g})")
    missing = {(t, a, v) for (t, a), vals in (jax_rows or {}).items()
               for v in vals} - seen
    check(not missing, f"[protocol:{tag}] rows missing: {sorted(missing)}")


def read_back(algo, work: str, param, sources, direct):
    """Preprocess ``algo`` at ``param`` from ``work`` (a store's root is
    relative to the CWD), read the rows of ``sources`` back and return
    their largest distance from ``direct``, the store's bytes and the
    preprocessing seconds. The store is deleted."""
    err = 0.0
    cwd = os.getcwd()
    try:
        os.chdir(work)
        t0 = time.perf_counter()
        algo.preprocessing(-1.0, param, progress=False)
        secs = time.perf_counter() - t0
        for i, s in enumerate(sources):
            algo.read_preprocessed_ppr(int(s))
            err = max(err, float(np.abs(algo.get_whole_graph_dense()
                                        - direct[i]).max()))
        nbytes = algo.get_prep_size()
        algo.delete_prep_dir()
    finally:
        os.chdir(cwd)
    return err, nbytes, secs


def protocol_path(dev, k2_b128_ms: float) -> dict[str, int]:
    """The protocol CLI on three graphs; returns the path's launch
    counts, read before the stores' read-back checks. ``k2_b128_ms`` is
    K2's time at a preprocessing batch (n_pad 1024, B 128), to split the
    k2max preprocessing rows."""
    import torch

    from ppr_tpu_torch import cli
    from ppr_tpu_torch.models.forward_push import ForwardPush
    from ppr_tpu_torch.models.neo4j_method import Neo4jMethod
    from ppr_tpu_torch.ops import dense_power, row_gather

    reset_launches()
    rows, wall, _ = run_protocol("got", [
        "--db", "synth:107x3@7", "--sweep", "got", "--query", "50",
        "--k", str(K), "--tests", "1,2,3",
        "--algos", "NEO4J_METHOD,FORA_TOPK"])
    counts = read_launches()
    print(f"[protocol:got] synth:107x3@7, 50 queries, Tests 1-3: wall "
          f"{wall:.1f} s; launches K2 {counts['k2']}, K1 {counts['k1']}, "
          f"K0 {counts['k0']}")
    check(counts["k2"] > 0, "the protocol did not launch K2")
    check(counts["k1"] > 0, "the protocol's oracle did not launch K1")
    check(counts["k0"] == 1, f"K0 ran {counts['k0']} times, not once")
    check_protocol_rows("got", rows)
    check(len(rows[(2, "FORA_TOPK")]) == 5, "FORA_TOPK rows missing")

    # Forward Push and BASE as their own run: the same command as the JAX
    # rows they are held to (the query draws follow the algorithm set)
    rows, wall, _ = run_protocol("got_push", [
        "--db", "synth:107x3@7", "--sweep", "got", "--query", "50",
        "--k", str(K), "--tests", "1,2,3",
        "--algos", "FWDPUSH,BASE_WHOLE_GRAPH"])
    print(f"[protocol:got] FWDPUSH,BASE_WHOLE_GRAPH, 50 queries, Tests 1-3: "
          f"wall {wall:.1f} s")
    check_protocol_rows("got", rows, jax_rows=JAX_ROWS["got"])

    rows, wall, work = run_protocol("k2max", [
        "--db", "synth:1000x16@11", "--sweep", "got", "--query", "50",
        "--k", str(K), "--tests", "1,3", "--algos", "NEO4J_METHOD"])
    print(f"[protocol:k2max] synth:1000x16@11 (n_pad 1024), 50 queries, "
          f"Tests 1 and 3: wall {wall:.1f} s; K2 launches so far "
          f"{dense_power.pagerank_launches}")
    check_protocol_rows("k2max", rows)
    prep = {r[0]: float(r[2]) for r in rows[(3, "NEO4J_METHOD")]}
    print(f"[protocol:k2max] prep ms a param, by iterations: {prep}; K2's "
          f"share at {K2_ITERS}: 8 batches x [k2:b128] {k2_b128_ms:.3f} ms "
          f"= {8 * k2_b128_ms:.1f} ms of {prep.get(str(K2_ITERS), 0.0):.1f}")

    k2_before = dense_power.pagerank_launches
    rows, wall, _ = run_protocol("grqc", [
        "--db", "synth:grqc", "--query", "50", "--k", str(K),
        "--tests", "1,2", "--algos", "NEO4J_METHOD"])
    print(f"[protocol:grqc] synth:grqc (5,120 nodes, sparse), 50 queries, "
          f"Tests 1 and 2: wall {wall:.1f} s")
    check(dense_power.pagerank_launches == k2_before,
          "the sparse graph launched K2")
    check_protocol_rows("grqc", rows)

    k3_before = row_gather.segment_sum_launches
    rows, wall, grqc_work = run_protocol("grqc_push", [
        "--db", "synth:grqc", "--query", "50", "--k", str(K),
        "--tests", "1,2", "--algos", "FWDPUSH,BASE_WHOLE_GRAPH"])
    k3_run = row_gather.segment_sum_launches - k3_before
    print(f"[protocol:grqc] FWDPUSH,BASE_WHOLE_GRAPH, 50 queries, Tests 1 "
          f"and 2: wall {wall:.1f} s; K3 launches {k3_run}")
    check(k3_run > 0, "the sparse push did not launch K3")
    check_protocol_rows("grqc", rows, jax_rows=JAX_ROWS["grqc"])

    counts = read_launches()

    # stores read back against direct computations: Forward Push on the
    # sparse graph (through K3), the Neo4j method against K2
    grqc = cli.load_dataset("synth:grqc", device=dev)
    fwp = ForwardPush(grqc, ALPHA)
    sources, rmax = np.array([0, 17, 2600, 5119]), 1e-7
    direct = fwp.compute_whole_graph_device(sources, rmax).cpu().numpy()
    err, nbytes, secs = read_back(fwp, grqc_work, rmax, sources, direct)
    print(f"[protocol:grqc] Forward Push store rows {sources.tolist()} at "
          f"rmax {rmax} vs a direct push: max abs err {err:.3e}; store of "
          f"{grqc.n} rows {nbytes} bytes in {secs:.2f} s")
    check(err <= PROTOCOL_ERR, f"Forward Push store rows differ by {err}")

    ds = cli.load_dataset("synth:1000x16@11", device=dev)
    sources = np.array([0, 1, 500, 999])
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(sources, device=dev), ds.graph.n_pad).float()
    x = dense_power.dense_pagerank_iterations(ds.graph, onehot, 1 - ALPHA,
                                              K2_ITERS)
    direct = (x / x.sum(-1, keepdim=True)).cpu().numpy()
    err, nbytes, _ = read_back(Neo4jMethod(ds, ALPHA), work, K2_ITERS,
                               sources, direct)
    print(f"[protocol:k2max] store rows {sources.tolist()} at iters "
          f"{K2_ITERS} vs a direct K2 launch, normalized: max abs err "
          f"{err:.3e}, store {nbytes} bytes")
    check(err <= PROTOCOL_ERR, f"store rows differ from K2 by {err}")
    return counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs only on a card",
              file=sys.stderr)
        return 1

    from ppr_tpu_torch.cli import load_dataset
    from ppr_tpu_torch.device import set_exact_f32_matmul
    from ppr_tpu_torch.graph.io import load_default, synthetic_powerlaw
    from ppr_tpu_torch.models.config import AlgoConf
    from ppr_tpu_torch.models.power_method import power_method_batch
    from ppr_tpu_torch.ops import cuda_build, dense_power, probe
    from ppr_tpu_torch.service import PPRService

    dev = torch.device("cuda")
    set_exact_f32_matmul()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # --- 2. build: one nvcc per source, started together -----------------
    t0 = time.perf_counter()
    sources_cu = ("dense_power", "probe", "row_gather")
    with ThreadPoolExecutor(len(sources_cu)) as pool:
        list(pool.map(cuda_build.load_library, sources_cu))
    print(f"[build] dense_power.cu (K1, K2), probe.cu (K0) and "
          f"row_gather.cu (K3, P1-P4): {time.perf_counter() - t0:.2f} s")
    for name in sources_cu:
        secs, log = cuda_build.BUILD_INFO[name]
        print(f"[build] {name}.cu: nvcc {secs:.2f} s")
        for line in log.splitlines():
            # the mangled entry names hold the kernel and its template
            # arguments: (RT, mode) (dense_power), the load type
            # (row_gather)
            entry = re.search(r"(ppr_\w+?_kernel)(?:ILi(\d)ELi(\d)E"
                              r"|ILi(\d)E|I6?(\w+?)E)?", line)
            if "entry function" in line and entry:
                arg = (", ".join(entry.group(2, 3)) if entry[2]
                       else entry[4] or entry[5])
                print(f"[build] ptxas: {entry[1]}{f'<{arg}>' if arg else ''}")
            elif "registers" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")

    # --- 3. K0, the toolchain probe -----------------------------------------
    probe.ensure(dev)
    x0 = torch.arange(8 * 128, dtype=torch.float32, device=dev) \
        .reshape(probe.SHAPE) / 7.0
    y0 = probe.double(x0)
    k0_err = (y0 - probe.double_ref(x0)).abs().max().item()
    check(torch.equal(y0, probe.double_ref(x0)), "K0 differs from 2x")
    # the plain version is the one PyTorch call, x * 2.0
    k0_bound, k0_by = bound(x0.numel(), 8.0 * x0.numel())
    k0 = {"max_abs_err": k0_err,
          "ms": cuda_ms(lambda: probe.double(x0)),
          "plain_ms": cuda_ms(lambda: probe.double_ref(x0)),
          "bound_ms": k0_bound, "bound_by": k0_by}
    k0["library_ms"] = k0["plain_ms"]
    print(f"[k0] y = 2x on f32 {list(probe.SHAPE)}: equal bit for bit; "
          f"kernel {k0['ms']:.4f} ms, plain {k0['plain_ms']:.4f} ms "
          f"(median of 10); bound_ms {k0_bound:.2e} ({k0_by})")

    # --- 4-5. K1 and K2 against their plain versions -------------------
    ds_a = load_default(device=dev)
    ds_a_sparse = load_default(dense_threshold=0, device=dev)
    sources_50 = np.random.default_rng(0).choice(ds_a.n, 50, replace=False)
    k1, k2 = dense_phase(dev, ds_a, ds_a_sparse, sources_50)

    # --- 6. K3 and P1-P4 against their plain versions -------------------
    # the benchmark's graph and service, built once here for K3's tail
    # shape and used again by the serving path
    t0 = time.perf_counter()
    ds = synthetic_powerlaw(65536, 16, seed=42, dense_threshold=0,
                            device=dev)
    svc = PPRService.from_dataset(ds, alpha=ALPHA, eps=EPS, k=K,
                                  hub_split=4096, seed=7)
    algo = svc._topk_algo
    hs = algo.hub_split
    torch.cuda.synchronize()
    print(f"[bench] graph n={ds.n} m={ds.graph.m} n_pad={ds.graph.n_pad}, "
          f"hubs {hs.num_hubs} ({hs.hub_matrix.dtype}), tail edges "
          f"{hs.m_tail}, set-up {time.perf_counter() - t0:.2f} s")
    check(hs.hub_matrix.dtype == torch.bfloat16, "hub matrix is not bf16")
    grqc = load_dataset("synth:grqc", device=dev).graph
    k3 = k3_phase(dev, ds.graph, hs, grqc)
    rg = gather_probes(dev, k3)

    # --- launch counts: the serving path from here on --------------------
    reset_launches()

    # --- 7. the serving path: the oracle ----------------------------------
    oracle_a = AlgoConf(ALPHA).set_conf_power_method(ds_a) \
        .compute_whole_graph_batch(sources_50)
    check(dense_power.launches > 0, "PowerMethod did not launch K1")
    check(np.array_equal(oracle_a, k1["out_a"]),
          "PowerMethod's K1 result differs from the direct launch")
    print(f"[oracle] PowerMethod on {ds_a.name} B=50: K1 launches "
          f"{dense_power.launches}, row sums min "
          f"{oracle_a.sum(-1).min():.6f}")

    # --- 7. FORA top-k on the GOT-scale graph --------------------------------
    tol_a = EPS / ds_a.n
    svc_a = PPRService.from_dataset(ds_a, alpha=ALPHA, eps=EPS, k=K)
    vals, ids = svc_a._topk_algo.compute_topk_ids_batch(sources_50, K, EPS)
    hits_a = svc_a.top_k(sources_50, k=K)
    prec_a = precision(oracle_a,
                       tie_tolerant_ids(vals, ids, len(sources_50), tol_a))
    prec_a_raw = precision(oracle_a, [[h.node for h in row]
                                      for row in hits_a])
    print(f"[fora:got] B=50 k={K} sweeps={svc_a._topk_algo.last_iters}: "
          f"precision@10={prec_a:.4f} (tie tol {tol_a:.3e}), "
          f"raw {prec_a_raw:.4f}")
    check(prec_a >= 0.99, f"GOT-scale precision@10 {prec_a} < 0.99")

    # --- 7. the serving path at the benchmark size ------------------------
    sources = np.random.default_rng(0).integers(0, ds.n, 2048)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vals, ids = algo.compute_topk_ids_batch(sources, K, EPS)    # warm-up
    warm_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hits = svc.top_k(sources, k=K)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sweeps = algo.last_iters
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[bench] B=2048 k={K} eps={EPS} H=4096 bf16: top_k "
          f"{dt * 1e3:.1f} ms = {len(sources) / dt:.1f} qps, sweeps "
          f"{sweeps} ({dt * 1e3 / sweeps:.2f} ms/sweep incl. epilogue), "
          f"warm-up call {warm_s:.2f} s, peak device memory {peak_gb:.2f} GB")
    out_deg = ds.graph.out_deg.cpu().numpy()
    check(len(hits) == len(sources) and all(
        len(h) >= K or out_deg[s] == 0 for h, s in zip(hits, sources)),
        "top_k returned short rows for non-dangling sources")
    scores = np.array([h.score for row in hits for h in row])
    check(bool(np.isfinite(scores).all() and (scores > 0).all()),
          "top_k scores not finite and positive")
    # the timed call must return the warm-up call's top-k sets, so the
    # tie-tolerant precision of the warm-up windows below is the timed
    # call's; a row whose ties fill the window is answered densely and may
    # hold more ties
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs

    for i, row in enumerate(hits):
        want = set(topk_ids_with_ties_from_pairs(vals[i], ids[i], K).tolist())
        got = {h.node for h in row}
        tied_window = len(want) == vals.shape[1]
        check(got == want or (tied_window and want <= got),
              f"row {i}: the timed call's top-k differs from the warm-up's")

    n_acc = 32
    oracle = power_method_batch(ds.graph, sources[:n_acc], ALPHA, ITERS) \
        .cpu().numpy()
    exact = scipy_power_method(ds.graph, sources[:4], ALPHA)
    err_oracle = float(np.abs(oracle[:4] - exact).max())
    print(f"[bench] oracle power_method_batch (sparse, 32 rows) vs float64 "
          f"scipy on 4 rows: max abs err {err_oracle:.3e}")
    check(err_oracle <= 1e-5, f"oracle error {err_oracle} > 1e-5")
    tol = EPS / ds.n
    prec = precision(oracle, tie_tolerant_ids(vals, ids, n_acc, tol))
    prec_raw = precision(oracle, [[h.node for h in row]
                                  for row in hits[:n_acc]])
    print(f"[bench] precision@10 of the timed call over {n_acc} rows: "
          f"{prec:.4f} (tie tol {tol:.3e}), raw {prec_raw:.4f}")
    check(prec >= 0.99, f"bench precision@10 {prec} < 0.99")

    # --- launch counts of the serving path ------------------------------
    serving = read_launches()
    print(f"[bench] serving path launches: K1 {serving['k1']}, K3 "
          f"{serving['k3']}, K0 {serving['k0']}")
    check(serving["k1"] > 0, "K1 was not launched on the serving path")
    check(serving["k0"] == 1, "K0 did not run once on the serving path")
    check(serving["k3"] > 0, "K3 was not launched on the serving path")

    # --- 8. where the time goes at the benchmark size ------------------
    profile_batch(algo, sources)

    # --- 9. the protocol path ----------------------------------------------
    protocol = protocol_path(dev, next(
        sh["ms"] for sh in k2["shapes"] if sh["case"] == "b128"))
    check(protocol["k3"] > 0, "K3 was not launched on the protocol path")
    launches = {k: serving[k] + protocol[k] for k in serving}
    print(f"[launches] serving path {serving}, protocol path {protocol}")
    source = "ppr_tpu_torch/csrc/dense_power.cu"
    print(json.dumps({"kernels": [{
        "name": "dense_power_iterations",
        "route": "cuda",
        "source": source,
        "replaces": "ppr_tpu/ops/pallas_dense.py:191",
        "launches": launches["k1"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"],
        "shapes": k1["shapes"],
    }, {
        "name": "dense_pagerank_iterations",
        "route": "cuda",
        "source": source,
        "replaces": "ppr_tpu/ops/pallas_dense.py:227",
        "launches": launches["k2"],
        "max_abs_err": k2["max_abs_err"],
        "ms": k2["ms"],
        "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"],
        "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"],
        "shapes": k2["shapes"],
    }, {
        "name": "canary_probe",
        "route": "cuda",
        "source": "ppr_tpu_torch/csrc/probe.cu",
        "replaces": "ppr_tpu/ops/pallas_dense.py:47",
        "launches": launches["k0"],
        "max_abs_err": k0["max_abs_err"],
        "ms": k0["ms"],
        "plain_ms": k0["plain_ms"],
        "bound_ms": k0["bound_ms"],
        "bound_by": k0["bound_by"],
        "library_ms": k0["library_ms"],
        "shapes": [{"shape": list(probe.SHAPE), "ms": k0["ms"],
                    "plain_ms": k0["plain_ms"],
                    "bound_ms": k0["bound_ms"]}],
    }, {
        "name": "gather_segment_sum",
        "route": "cuda",
        "source": "ppr_tpu_torch/csrc/row_gather.cu",
        "replaces": "scripts/bench_pallas_row_gather.py:41",
        "replaces_mode": "gather_accum",
        "launches": launches["k3"],
        "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": None,   # no one PyTorch call sums gathered rows
        "shapes": k3["shapes"],
    }, {
        "name": "row_gather",
        "route": "cuda",
        "source": "ppr_tpu_torch/csrc/row_gather.cu",
        "replaces": "scripts/probe_mosaic_gather.py:30",
        "also_replaces": ["scripts/probe_mosaic_gather.py:53",
                          "scripts/probe_mosaic_gather.py:82",
                          "scripts/bench_pallas_row_gather.py:41 (gather)"],
        "launches": launches["gather"],
        "path": "none: a microbenchmark, as the TPU probes were",
        "max_abs_err": rg["max_abs_err"],
        "ms": rg["ms"],
        "plain_ms": rg["plain_ms"],
        "bound_ms": rg["bound_ms"],
        "bound_by": rg["bound_by"],
        "library_ms": rg["plain_ms"],   # its plain version: index_select
        "shapes": rg["shapes"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
