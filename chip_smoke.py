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
   row-gather probes P1-P4), one nvcc each, started together; ptxas lines.
   ``row_gather_ablation.py``'s builds of K3 with parts switched off are
   compiled beside them;
3. K0, the toolchain probe, against ``2 * x`` bit for bit. At shapes this
   small one call between two events is the host's time to make it, so
   K0, every ``[p1-p4]`` shape and every ``[k3]`` shape also get
   ``host_us`` (a host clock over 1,000 un-synchronised calls) and
   ``device_ms`` (the launches captured once and replayed as one CUDA
   graph), for the wrapper and for the library call where there is one;
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
   ``gather_accum`` is K3 beside ``index_add_``); then ``[walk]``, the
   walk engine (``weighted_walk_counts``, 2^22 walkers on the bench
   graph) in walks/s with the phase compaction and without it, its mass
   checked, and ``[calibrate]``, ``calibrate.measure`` three times on the
   bench graph beside the H100 constants in the code, and the path FORA
   top-k's cost model picks at every serving rung (the annealed loop at B
   2048, checked);
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
9. the serving layer (``ppr_tpu_torch/serving.py``) on the bench graph and
   service: ``[serving:prewarm]`` (``PPRBatchServer(max_batch=2048,
   prewarm=True)``: first and second call time of each rung 8..2048, the
   probe sources spread over real nodes, K0 probed once on the main thread
   before the dispatcher starts), ``[serving:open-loop]`` (capacity at max
   batch after one untimed flood, Poisson arrivals at 0.5 and 0.8 of it for
   5 s each through ``serving_latency_torch.run_rate``: qps, p50/p95/p99,
   mean batch, dispatches, padded rows; every dispatch on the dispatcher
   thread, the graph's card and its default stream; precision@10 of the
   hit lists the futures return for the 32 oracle sources in the streams),
   ``[serving:slo]`` (the same stream at 0.5 with ``slo_ms`` twice the warm
   time of rung 256: cap moves, ``slo_unattainable``, precision@10),
   ``[serving:cohort]`` (``PPRService(cohort=True)`` behind the server at
   0.5: percentiles beside batch mode's, each dispatch covered once by its
   cohorts, 16 served hit lists against solo ``top_k_stream`` runs,
   precision@10, and a full-width dispatch both ways in turns). The
   servers hold the real services; ``EngineSpy`` records each engine call
   below them (width, time, thread, card, stream, cohorts),
   ``[serving:early-exit]`` (one bench batch with the certificate: sweeps
   and qps beside ``[bench]``'s, the same top-10 sets),
   ``[serving:precomputed]`` (a BASE store of the ca-GrQc stand-in at
   threshold 1e-3, 512 requests through ``serve_loop``, every hit list equal
   to the store's row), ``[serving:daemon]`` (``python -m
   ppr_tpu_torch.serving --db synth:2048x8 --device cuda`` in a process of
   its own: 64 answers, a stats line, exit 0) and ``[bench:json]``
   (``bench_torch.py``'s JSON line, recall_at_10 >= 0.99);
10. the protocol path: the port's CLI (``ppr_tpu_torch.cli.main``)
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
   and a Forward Push store against a direct push;
10b. the protocol at the named datasets' scale
   (``dataset_protocol_path``): ``[protocol:blogcatalog]`` (10,240 nodes;
   Forward Push, the Neo4j method and BASE, Tests 1-2) and
   ``[protocol:amazon]`` (262,144 nodes; Forward Push and the Neo4j
   method, Test 2), each the command of a block of
   ``results/protocol_grid_jax_cpu.json`` and every row held to that
   block's, the JAX package's on the CPU; every K3 launch made in a call
   ``HeldK3(protocol=True)`` holds, one a sweep of each push, reverse
   push, Neo4j and oracle loop;
11. the walk path: ``[mc:bench]`` (Monte-Carlo on the bench graph, 4
   sources at eps 0.5, 9.27M walks a source, mean max-err < 0.05 against
   the power method), ``[fora:walks]`` (``ForaTopk(push="reference")``
   with walk and propagation completion at B 64: rounds, walkers a round,
   ms, precision@10 > 0.9 and NDCG > 0.97; ``ForaWholeGraph`` with both
   completions: push rounds, ms, mean max-err < 0.03) and
   ``[protocol:walks]`` (the CLI with ``--fora-completion walks`` on the
   GOT-scale graph at seeds 0-2, Monte-Carlo, FORA whole-graph and FORA
   top-k, Tests 1-3, and on the ca-GrQc stand-in, FORA whole-graph and
   top-k, Tests 1-2, under ``auto`` and ``walks``): each row held to the
   JAX package's CPU row of the same command and seed (``WALK_JAX_ROWS``;
   max-err <= 1.5 x JAX's + 1e-4, precision >= JAX's - 0.05);
12. weighted graphs and the Neo4j store: ``[weighted]`` (the weighted
   bench graph, ``synthetic_weighted(65536, 16, seed=42)``, which
   builder made it, and the native builder against the numpy paths on the
   host: CSR, parse and alias tables, the same arrays, each one's
   seconds), ``[weighted:k3]`` (K3's coefficient mode against its
   plain version bit for bit at that graph's whole push, B 2048, beside
   the same edges in the unweighted mode, and at the weighted ca-GrQc
   stand-in's shapes, with ``embedding_bag(per_sample_weights=)``),
   ``[weighted:oracle]`` (K1 on ``synthetic_weighted(1000, 16, seed=11)``
   within 2e-5 of the sparse weighted path), ``[weighted:fora]`` (FORA
   top-k at B 2048 with no hub split, precision@10 >= 0.99 against the
   weighted oracle, the power method in float64 by torch's sparse
   product, which does not run K3, and FORA whole-graph at B 64, mean max-err < 0.03),
   ``[weighted:profile]``, ``[weighted:walks]`` (the alias-step walks on
   2^22 walkers, mass 1 within 1e-6; Monte-Carlo on 4 sources, mean
   max-err < 0.05), ``[protocol:weighted]`` (the harness on the weighted
   ca-GrQc stand-in read by ``load_edge_list(weighted=True)``, each row
   held to ``WEIGHTED_JAX_ROWS``) and ``[neostore]`` (the CLI on a Neo4j
   store written by ``tests/test_torch_neostore.py``'s writer: Test 1
   rows equal to ``--db synth:107x3@7``'s; ``--rel NOPE`` raises);
13. the mesh serving engines (``ppr_tpu_torch/parallel/``) on this one card
   through repeated-device meshes (``devices=[cuda] * S``: the
   partitioned arithmetic, the ring and K3 on every shard run for real;
   the times are not a scaling result), at the bench graph's full width,
   B 2048: ``[mesh:ref]`` (the single-device ``ForaTopk`` with
   ``push="none"`` and no hub split, the same f32 operator, which every
   mesh engine is held to), ``[mesh:edge]`` (the edge engine at 1x1, bit
   for bit the reference, and 2x2), ``[mesh:node]`` (the node engine at
   1x4: the f32 ring, the per-shard state shape, the bf16 ring and
   frontier compaction at 64 of 64 blocks, bit for bit the dense ring, and
   at 16 of 64, each held to the dense ring within the bars of
   ``tests/test_ring_bf16.py`` and ``tests/test_frontier_ring.py``): sweeps
   beside the reference's, ms a sweep, qps, peak memory, the rows whose
   top-10 differ from the reference's and precision@10 against the
   oracle, and a ``torch.profiler`` trace of one batch of the edge 2x2
   and the node 1x4 engines (``[mesh:profile ...]``, as ``[profile]``);
   ``[mesh:whole-graph]`` (node 1x4, B 64, ``spmv`` row mass
   within eps/n, every score within eps/n of the oracle and each row's L1
   distance within 2 eps/n, ``walks`` mass
   within 1e-3, ``[fora:walks]``'s mean max-err bar and each row's L1
   error below the mass the walks carry), ``[mesh:weighted]`` (the edge
   engine 2x2 on the weighted bench graph, K3's coefficient mode),
   ``[serving:mesh]`` (``PPRBatchServer`` over ``PPRService(mesh=1x4,
   mesh_engine="node")``, a burst of 512 requests, precision@10 of the
   hit lists), ``[mesh:dryrun]`` (``dryrun_multichip(4, devices=[cuda] *
   4)``) and ``[mesh:k3]`` (K3 against its plain version at an edge
   chunk's, a ring block's and a weighted chunk's shapes, and, by source,
   at the all-pair engines' 2x2 chunk and largest 1x4 reverse ring
   block). Each engine
   held to the reference has tie-expanded top-10 sets equal to its; the
   bf16 ring and frontier compaction at 16 of 64 blocks are held to the
   dense ring within their bars instead. Each mesh engine call's K3
   launches are held to its sweeps times one launch a non-empty edge
   chunk or ring block;
14. the protocol on a mesh (``mesh_protocol_path``), on this card
   repeated: ``[mesh:prep]`` (``parallel/mesh_algos.py``'s drop-ins on
   the bench graph at 2x2: Forward Push at B 2048 and the got sweep's
   smallest rmax and the Neo4j method at B 2048 for 40 iterations, each
   within atol 5e-6, rtol 1e-4 of the single-device engine on the same
   sources, Forward Push on its sweeps; FORA whole-graph at B 64 within
   ``[mesh:whole-graph]``'s oracle bars; Monte-Carlo at B 64 at
   ``[mc:bench]``'s eps, rows of mass 1 within 1e-3 and within 0.05 of
   the oracle), ``[mesh:base]`` (``ShardedBackwardSearch`` 2x2 and
   ``NodeShardedBackwardSearch`` 1x4 on a 512-target batch at 1e-3 against
   ``BackwardSearch``, the same bar and sweeps; then the whole BASE
   all-pair preprocessing of the bench graph on the node engine, three
   stored rows read back against a direct single-device sweep),
   ``[protocol:mesh]`` (the CLI with ``--mesh 1x1 --device cuda`` on
   ``synth:grqc``, Forward Push and BASE, Tests 1-2, and the same tests
   through ``PerfHarness(mesh=2x2)``, every row held to ``JAX_ROWS``),
   then, outside its launch window, ``[mesh:scaling]`` (``scaling_sweep``
   and ``engine_scaling_sweep`` at 1, 2 and 4 devices) and ``[mesh:comm]``
   (``comm_model.main`` at the bench shapes: bytes a sweep, K3's ns an
   edge, the psum's share of a sweep), both labelled as one card's
   partition overhead with no link measured. Every K3 launch of its
   window is made in a call ``HeldK3`` holds (each mesh engine's sweep
   loop and the power-method oracle), and each such call's launches equal
   its loop's sweeps times one launch a chunk or non-empty ring block;
   each phase prints its wall;
14b. the mesh across processes (``dist_path``): 4 gloo ranks share this
   card (NCCL takes one rank a card), started by ``spawn_local`` with a
   deadline, each a ``python3 chip_smoke.py --dist-rank DIR`` process
   (``dist_rank``) on ``global_mesh``: ``[dist:edge]`` (``ShardedForaTopk``
   2x2, B 2048, the bench graph), ``[dist:node]``
   (``NodeShardedForaTopk`` 1x4, bf16 ring, frontier 16 of 64 blocks),
   ``[dist:walks]`` (``NodeShardedForaWholeGraph`` 1x4 with walks, B 64)
   and ``[dist:protocol]`` (``PerfHarness(mesh=global_mesh(2))`` on the
   grqc stand-in, Tests 1-2, Forward Push and BASE): the single-process
   meshes' sweeps, selections, final reserve parts (SHA-256) and walk rows
   bit for bit, precision@10 >= 0.99, rows within ``JAX_ROWS``, one
   report (rank 0's) and BASE stores equal to ``[protocol:mesh]``'s; each
   part's wall, its wire bytes, each rank's seconds in its collectives
   over its wall (``Mesh.wire_s``) and the wall beyond the single
   process's; each
   rank's K3 launches held call by call by ``HeldK3(spanning=True)``, and
   K0 once a rank;
15. the automatic hub count and the 1M cell (``scale_path``):
   ``[hubs:constants]`` (the rule's two prices measured at B 512 on the
   bench graph beside the constants in ``ops/hub_split.py``, each within
   2x), then one launch window: ``[hubs:auto]`` (the rule's count on the
   bench graph; at B 512 one call at that count and one at 4096, in turns,
   each precision@10 >= 0.99; ``bench_torch.py``'s count still 4096 at B
   2048 and ``[bench]``'s sweeps still 77), ``[scale:1m]``
   (``scale_1m_torch.measure`` at B 256 on ``synthetic_powerlaw(2^20, 8,
   seed=11)`` with the automatic count: recall@10 >= 0.99 against the
   power method, itself within 1e-5 of a float64 scipy iteration on the
   same 4 sources; whole-graph rows of mass within 1e-4 of 1, holding the
   oracle's top-10 on those sources and within relative error eps of it
   above 1/n; walks of mass 1; peak memory) and ``[occupancy]``
   (``ring_occupancy_torch`` on the bench graph at B 64: the coverage
   curve, and the node engine on a 2x4 mesh of the card repeated, dense
   against frontier at 16 and 64 of 64 blocks, full capacity equal to
   dense bit for bit), every K3 launch
   made in a call ``HeldK3(single=True)`` holds; then ``[scale:1m:k3]``
   (K3 at the 1M tail's shape on 16 columns against its plain version, bit
   for bit, with ``embedding_bag`` and the bound). The phases print their
   wall;
16. the sweep profile (``profile_sweep_path``): ``[profile_sweep]``
   (``profile_sweep_torch.run`` at B 256 on the bench graph, variants
   ``plain``, ``hub512_bf16`` and ``hub4096_bf16``: the residual and the
   annealed loop's sweeps, host and device ms, every call's K3 launches
   held by ``HeldK3(single=True)``, each annealed variant's tie-expanded
   top-10 sets at precision@10 >= 0.99 against the oracle of the same
   sources, and its ``torch.profiler`` split from the one trace reader,
   ``utils/timer.kernel_split``, naming K3 and the hub product);
16b. the calibrated server (``serving_calibrate_path``):
   ``[serving:calibrate]`` (``serving_latency_torch.run`` with
   ``--calibrate`` at max batch 256, 2 s at 0.5 of capacity: the measured
   constants, each prewarmed rung's path, p50/p99).

Launch counts are reset before the serving path (7) and read after it,
and again before and after the serving layer (9), the protocol path (10),
the dataset protocol path (10b), the walk path (11), the weighted path
and the store path (12) and the mesh path (13: reset after the
single-device references, read before ``[mesh:dryrun]``, and equal to
the sum of the mesh engines' own counts)
and the mesh protocol path (14: after its single-device references,
before ``[mesh:scaling]``), the mesh across processes (14b: in each rank,
before its engines and after them, summed over the ranks), the scale
path (15: after
``[hubs:constants]``, before ``[scale:1m:k3]``), the sweep profile (16:
before ``[profile_sweep]`` and after it) and the calibrated server (16b:
before ``[serving:calibrate]`` and after it, K3 launched and K0 once);
a reset also forgets the probe, so each path runs K0 once before its
first hand kernel. The
weighted path must launch K3 only in its coefficient mode, and never its
plain version; the mesh path must launch K3 in both modes. The last three
lines are the kernels' JSON record (``launches`` summed over the twelve
paths, K3's ``mesh``, ``mesh_protocol``, ``dist``, ``dataset_protocol``,
``scale`` and ``profile_sweep`` entries
with those paths' own;
``row_gather`` is a
microbenchmark, as P1-P4 were on the TPU, so no path launches it; ``ms``,
``plain_ms``, ``library_ms``, ``bound_ms`` and ``bound_by`` at one shape
each, and ``shapes`` with every shape's), the card line, and
``{"ok": true, "device": {...}}``. Without a CUDA card the script prints
no result and exits 1.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import shutil
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ppr_tpu_torch.utils.cuda_timing import (card_line, cuda_ms, graph_ms,
                                             host_us, l2_flusher)
from ppr_tpu_torch.utils.report import (read_protocol_file,
                                        read_protocol_rows, row_failures)
from ppr_tpu_torch.utils.timer import kernel_split

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


# The JAX package's rows for the walk protocol commands on the CPU
# (JAX_PLATFORMS=cpu python -m ppr_tpu.cli --query 50 --k 10 and: --db
# synth:107x3@7 --sweep got --tests 1,2,3 --algos MC,FORA_WHOLE_GRAPH,
# FORA_TOPK --fora-completion walks --seed 0|1|2; --db synth:grqc --tests
# 1,2 --algos FORA_WHOLE_GRAPH,FORA_TOPK --fora-completion auto|walks):
# max-err for Tests 1 and 3, precision for Test 2, by sweep value. The
# bars: max-err <= 1.5 x JAX's + 1e-4, precision >= JAX's - 0.05 (the
# draws differ between the packages, and the push rounds follow each
# one's cost model). Monte-Carlo on grqc is left out: at the sweep's eps
# it is billions of walks a test on the JAX CPU side.
WALK_JAX_ROWS = {
    ("got", 0): {
        (1, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.02730412738630548,
            "5.0": 0.016191387739963828,
            "0.5": 0.0022686132974922657,
            "0.1": 0.0004243522882461548,
            "0.05": 0.00022149592638015747,
        },
        (1, "MC"): {
            "1.0": 0.010360846035182477,
            "0.5": 0.005613534543663264,
            "0.3": 0.003127139285206795,
            "0.1": 0.0012548169307410716,
            "0.05": 0.0010724355839192867,
        },
        (2, "FORA_TOPK"): {
            "10.0": 0.81,
            "5.0": 0.8859999999999999,
            "0.5": 0.9841818181818183,
            "0.1": 0.998,
            "0.05": 0.998,
        },
        (2, "MC"): {
            "1.0": 0.938,
            "0.5": 0.9721818181818181,
            "0.3": 0.9741818181818183,
            "0.1": 0.980909090909091,
            "0.05": 0.996,
        },
        (3, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.0264117590803653,
            "5.0": 0.014999464605934917,
            "0.5": 0.0022262827306985854,
            "0.1": 0.0004321125149726868,
            "0.05": 0.00022086620330810547,
        },
        (3, "MC"): {
            "1.0": 0.011322392020374536,
            "0.5": 0.00499856136739254,
            "0.3": 0.00329219663515687,
            "0.1": 0.0011912510171532631,
            "0.05": 0.0014043285697698594,
        },
    },
    ("got", 1): {
        (1, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.028644241406582296,
            "5.0": 0.015400124713778496,
            "0.5": 0.002072601765394211,
            "0.1": 0.0004391062259674072,
            "0.05": 0.00022046834230422972,
        },
        (1, "MC"): {
            "1.0": 0.010328279249370098,
            "0.5": 0.005444011185318232,
            "0.3": 0.0032218361273407938,
            "0.1": 0.0012013855203986167,
            "0.05": 0.0011477410420775414,
        },
        (2, "FORA_TOPK"): {
            "10.0": 0.8016363636363636,
            "5.0": 0.8732727272727273,
            "0.5": 0.9901818181818183,
            "0.1": 0.9963636363636365,
            "0.05": 1.0,
        },
        (2, "MC"): {
            "1.0": 0.9205454545454544,
            "0.5": 0.9620000000000001,
            "0.3": 0.972,
            "0.1": 0.986181818181818,
            "0.05": 0.9981818181818182,
        },
        (3, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.027976125266868622,
            "5.0": 0.015980213270522653,
            "0.5": 0.002265413082204759,
            "0.1": 0.00044144511222839357,
            "0.05": 0.00023924797773361206,
        },
        (3, "MC"): {
            "1.0": 0.011403322033584119,
            "0.5": 0.005278795920312405,
            "0.3": 0.0031488263607025147,
            "0.1": 0.0011967115476727486,
            "0.05": 0.0009281713329255581,
        },
    },
    ("got", 2): {
        (1, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.02897922755219042,
            "5.0": 0.017025375124067068,
            "0.5": 0.0020814194902777673,
            "0.1": 0.0004184207320213318,
            "0.05": 0.00023182809352874755,
        },
        (1, "MC"): {
            "1.0": 0.011833365261554717,
            "0.5": 0.005006887912750244,
            "0.3": 0.0035585316084325315,
            "0.1": 0.001264622826129198,
            "0.05": 0.000939648412168026,
        },
        (2, "FORA_TOPK"): {
            "10.0": 0.8009090909090909,
            "5.0": 0.9023636363636364,
            "0.5": 0.9880000000000001,
            "0.1": 0.9945454545454546,
            "0.05": 0.9925454545454545,
        },
        (2, "MC"): {
            "1.0": 0.9481818181818181,
            "0.5": 0.9701818181818181,
            "0.3": 0.9761818181818183,
            "0.1": 0.9829090909090908,
            "0.05": 0.9961818181818183,
        },
        (3, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.029912520293146373,
            "5.0": 0.01594538785255281,
            "0.5": 0.002134060487151146,
            "0.1": 0.0004832741618156433,
            "0.05": 0.0002361878752708435,
        },
        (3, "MC"): {
            "1.0": 0.010316955717280507,
            "0.5": 0.005720281451940537,
            "0.3": 0.003554091230034828,
            "0.1": 0.0012210742756724358,
            "0.05": 0.0010930170863866805,
        },
    },
    ("grqc", "auto"): {
        (1, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.0069366940855979916,
            "5.0": 0.005059162080287933,
            "0.5": 4.402697086334228e-06,
            "0.1": 8.702278137207031e-07,
            "0.05": 4.6342611312866213e-07,
        },
        (2, "FORA_TOPK"): {
            "10.0": 0.966,
            "0.5": 1.0,
            "0.1": 1.0,
            "0.01": 1.0,
            "0.001": 1.0,
        },
    },
    ("grqc", "walks"): {
        (1, "FORA_WHOLE_GRAPH"): {
            "10.0": 0.0069366940855979916,
            "5.0": 0.005059162080287933,
            "0.5": 0.0009132426977157593,
            "0.1": 0.0002177491784095764,
            "0.05": 0.00011450469493865966,
        },
        (2, "FORA_TOPK"): {
            "10.0": 0.9781818181818183,
            "0.5": 0.9961818181818181,
            "0.1": 0.9981818181818182,
            "0.01": 1.0,
            "0.001": 1.0,
        },
    },
}

#: the weighted protocol's graph: synthetic_weighted(5120, 3, seed=103),
#: the ca-GrQc stand-in with log-normal weights
WEIGHTED_GRQC = (5120, 3, 103)

# The JAX package's rows for the weighted protocol on the CPU: the file
# write_weighted_edges writes, loaded by ppr_tpu.graph.io.load_edge_list(
# path, weighted=True) and run through ppr_tpu.harness.PerfHarness(ds,
# seed=0).algo_perf_batch_test(50, 10, sweep="grqc", tests=(1, 2),
# algos={"FWDPUSH", "NEO4J_METHOD", "FORA_TOPK"}) (the JAX CLI has no
# --weighted flag); from the repository root, about 30 s:
#   JAX_PLATFORMS=cpu python -c 'import jax; jax.config.update(
#   "jax_platforms", "cpu"); import os, tempfile; from chip_smoke import *;
#   from ppr_tpu.graph.io import load_edge_list; from ppr_tpu.harness
#   import PerfHarness; d = tempfile.mkdtemp(); p = os.path.join(d,
#   "wgrqc.txt"); write_weighted_edges(p); PerfHarness(load_edge_list(p,
#   weighted=True), seed=0, out_dir=d).algo_perf_batch_test(50, 10,
#   sweep="grqc", tests=(1, 2), algos={"FWDPUSH", "NEO4J_METHOD",
#   "FORA_TOPK"}); print(read_protocol_file(os.path.join(d,
#   "wgrqc_AlgoPerfResults.txt")))'
# max-err for Test 1, precision for Test 2, by sweep value. Forward Push
# and the Neo4j method are held to [protocol:grqc]'s bars, FORA top-k to
# [protocol:walks]'s (check_protocol_rows picks the bar by algorithm): its
# cost model may take walks, whose draws differ between the packages.
WEIGHTED_JAX_ROWS = {
    (1, "FWDPUSH"): {
        "0.0001": 0.0032060828804969786, "1e-05": 0.0006496196985244751,
        "1e-06": 8.350193500518799e-05, "1e-07": 1.1266767978668213e-05,
        "1e-08": 1.1584162712097167e-06},
    (2, "FWDPUSH"): {
        "0.0001": 0.996, "1e-06": 1.0, "5e-08": 1.0, "7e-09": 1.0,
        "7e-10": 1.0},
    (1, "NEO4J_METHOD"): {
        "5": 0.06238948196172714, "40": 1.7132461071014404e-05,
        "100": 5.6549906730651854e-08, "200": 5.5618584156036376e-08,
        "300": 7.160007953643798e-08},
    (2, "NEO4J_METHOD"): {
        "5": 0.954, "40": 1.0, "300": 1.0, "500": 1.0, "1000": 1.0},
    (2, "FORA_TOPK"): {
        "10.0": 0.99, "0.5": 1.0, "0.1": 1.0, "0.01": 1.0, "0.001": 1.0},
}


def write_weighted_edges(path: str) -> None:
    """Write the weighted protocol's graph as ``src dst w`` lines: each
    edge of ``synthetic_weighted(*WEIGHTED_GRQC)`` in source-sorted order,
    weighed by its coefficient (the weights normalised per source, which
    give the same coefficients), printed so that it reads back exactly."""
    from ppr_tpu_torch.graph.io import synthetic_weighted

    n, deg, seed = WEIGHTED_GRQC
    g = synthetic_weighted(n, deg, seed=seed, dense_threshold=0,
                           device="cpu").graph
    src = g.edge_src[: g.m].tolist()
    dst = g.edge_dst[: g.m].tolist()
    coef = g.edge_coef[: g.m].double().tolist()
    with open(path, "w") as f:
        f.write("# synthetic_weighted(5120, 3, seed=103): src dst w\n")
        f.writelines(f"{s} {d} {w!r}\n" for s, d, w in zip(src, dst, coef))


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def split_times(fn, launches: int, calls: int, before=None) -> dict:
    """``host_us`` and ``device_ms`` of one wrapper or library call."""
    return {"host_us": host_us(fn, calls),
            "device_ms": graph_ms(fn, launches, before)}


def k3_library(table, src, ptr, coef=None):
    """The one PyTorch call that computes K3's function, for ``library_ms``:
    ``embedding_bag`` in ``sum`` mode with ``ptr`` as its offsets (the last
    one included), and ``coef`` as its ``per_sample_weights`` in the
    coefficient mode. It wants indices of the offsets' type, so they are
    cast here, once, outside every timer. The port never calls it."""
    import torch.nn.functional as F

    edges = int(ptr[-1])
    index = src[:edges].long()
    weights = None if coef is None else coef[:edges]

    def library():
        return F.embedding_bag(index, table, ptr, mode="sum",
                               per_sample_weights=weights,
                               include_last_offset=True)
    return library


def library_times(label, library, want, ms, split, launches, calls,
                  before=None, tag="k3") -> dict:
    """Time K3's library call as the kernel was timed, hold its result
    against the plain version's (``want``), and say, like with like,
    whether the kernel (``ms``, ``split``) is as fast."""
    import torch

    got = library()
    torch.cuda.synchronize()
    rel = rel_err(got, want)
    check(rel <= K3_TOL, f"K3 {label}: embedding_bag's relative error {rel} "
          f"> {K3_TOL}")
    equal = torch.equal(got, want)
    del got
    lib = split_times(library, launches, calls, before)
    out = {"library_ms": cuda_ms(library, before=before),
           "library_host_us": lib["host_us"],
           "library_device_ms": lib["device_ms"],
           "library_equal": equal}
    print(f"[{tag}] {label}: library call embedding_bag(mode='sum') "
          f"{out['library_ms']:.4f} ms between events, host_us "
          f"{out['library_host_us']:.2f}, device_ms "
          f"{out['library_device_ms']:.4f}; equal to the plain version bit "
          f"for bit: {equal}; the kernel is "
          f"{out['library_ms'] / ms:.2f}x as fast between events, "
          f"{out['library_device_ms'] / split['device_ms']:.2f}x in a graph, "
          f"{out['library_host_us'] / split['host_us']:.2f}x on the host")
    return out


def scipy_power_method(g, sources, alpha, iters=ITERS) -> np.ndarray:
    """Float64 power iteration with dangling mass to the source, every
    source a column of one ``[n, B]`` state."""
    import scipy.sparse as sp

    n = g.n
    src = g.edge_src[: g.m].cpu().numpy()
    dst = g.edge_dst[: g.m].cpu().numpy()
    deg = g.out_deg[:n].cpu().numpy().astype(np.float64)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1), 0.0)
    pt = sp.coo_matrix((inv[src], (dst, src)), shape=(n, n)).tocsr()
    dangling = deg == 0
    cols = np.arange(len(sources))
    rows = np.asarray(sources, np.int64)
    p = np.zeros((n, len(sources)))
    r = np.zeros((n, len(sources)))
    r[rows, cols] = 1.0
    for _ in range(iters):
        p += alpha * r
        rem = (1 - alpha) * r
        dm = rem[dangling].sum(axis=0)
        r = pt @ rem
        r[rows, cols] += dm
    out = np.zeros((len(sources), g.n_pad))
    out[:, :n] = p.T
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
    return k3_cases(dev, [
        dict(label="bench tail", n_rows=bench_g.n_pad, src=hs.tail_src,
             ptr=hs.tail_ptr, b=2048, cold=True),
        dict(label="grqc by-dst", n_rows=grqc_g.n_pad,
             src=grqc_g.edge_src_bydst, ptr=grqc_g.bydst_ptr, b=50),
        dict(label="grqc by-src", n_rows=grqc_g.n_pad, src=grqc_g.edge_dst,
             ptr=grqc_g.bysrc_ptr, b=50),
        dict(label="grqc by-src, BASE batch", n_rows=grqc_g.n_pad,
             src=grqc_g.edge_dst, ptr=grqc_g.bysrc_ptr, b=BASE_BATCH),
    ])


def weighted_k3_phase(dev, wbench_g, wgrqc_g) -> dict:
    """``[weighted:k3]``: K3's coefficient mode against its plain version
    at the weighted paths' shapes: the weighted bench graph's whole push
    (every edge, no hub split, B 2048; then the same edges in the
    unweighted mode, for comparison) and the weighted ca-GrQc stand-in's
    by-destination (``push_out``, ``edge_coef_bydst``) and by-source
    (``pull_out_norm``, ``edge_coef``) orders at B 50 and 512."""
    return k3_cases(dev, [
        dict(label="weighted push", n_rows=wbench_g.n_pad,
             src=wbench_g.edge_src_bydst, ptr=wbench_g.bydst_ptr,
             coef=wbench_g.edge_coef_bydst, b=2048, cold=True,
             plain_calls=50),
        # the same edges in the unweighted mode: what the coefficient
        # costs, apart from what the hubs' long segments cost
        dict(label="weighted push's edges, no coefficient",
             n_rows=wbench_g.n_pad, src=wbench_g.edge_src_bydst,
             ptr=wbench_g.bydst_ptr, b=2048, cold=True, plain_calls=50),
        dict(label="wgrqc by-dst", n_rows=wgrqc_g.n_pad,
             src=wgrqc_g.edge_src_bydst, ptr=wgrqc_g.bydst_ptr,
             coef=wgrqc_g.edge_coef_bydst, b=50),
        dict(label="wgrqc by-src", n_rows=wgrqc_g.n_pad,
             src=wgrqc_g.edge_dst, ptr=wgrqc_g.bysrc_ptr,
             coef=wgrqc_g.edge_coef, b=50),
        dict(label="wgrqc by-src, BASE batch", n_rows=wgrqc_g.n_pad,
             src=wgrqc_g.edge_dst, ptr=wgrqc_g.bysrc_ptr,
             coef=wgrqc_g.edge_coef, b=BASE_BATCH),
    ], tag="weighted:k3")


def k3_cases(dev, cases, tag="k3") -> dict:
    """Each case (``label``, ``n_rows``, ``src``, ``ptr``, ``b`` columns,
    ``coef`` for the coefficient mode, ``cold`` when the sweep's
    elementwise passes leave L2 cold, ``plain_calls`` for the plain
    version's host clock): K3 against its plain version bit for bit, two
    launches bit-equal, then times by events, on the host and by CUDA-graph
    replays, beside ``embedding_bag`` and the bound. The first case's times
    head the returned dict."""
    import torch

    from ppr_tpu_torch.ops import row_gather as rgm

    out = {"max_abs_err": 0.0, "shapes": []}
    gen = torch.Generator(device=dev).manual_seed(3)
    flush = l2_flusher(dev)
    for case in cases:
        label, n_rows, src, ptr, b = (case[k] for k in (
            "label", "n_rows", "src", "ptr", "b"))
        coef, cold = case.get("coef"), case.get("cold", False)
        table = torch.rand((n_rows, b), device=dev, generator=gen)
        got = rgm.gather_segment_sum(table, src, ptr, coef=coef)
        want = rgm.gather_segment_sum_ref(table, src, ptr, coef)
        torch.cuda.synchronize()
        err, rel = float((got - want).abs().max()), rel_err(got, want)
        equal = torch.equal(got, want)
        again = torch.equal(got, rgm.gather_segment_sum(table, src, ptr,
                                                        coef=coef))
        before = flush if cold else None
        launches, calls = (20, 200) if cold else (1000, 1000)

        def kernel():
            return rgm.gather_segment_sum(table, src, ptr, coef=coef)

        def plain():
            return rgm.gather_segment_sum_ref(table, src, ptr, coef)

        ms = cuda_ms(kernel, before=before)
        plain_ms = cuda_ms(plain, before=before)
        split = split_times(kernel, launches, calls, before)
        plain_host_us = host_us(plain, case.get("plain_calls", calls))
        edges = int(ptr[-1])
        segments = ptr.shape[0] - 1
        longest = int((ptr[1:] - ptr[:-1]).max())
        rows = int(torch.unique(src[:edges]).numel())
        unique_bytes = 4.0 * ((rows + segments) * b + edges) \
            + 8.0 * (segments + 1) + (4.0 * edges if coef is not None else 0)
        flop = float(edges) * b * (2 if coef is not None else 1)
        bound_ms, bound_by = bound(flop, unique_bytes)
        plan = rgm.make_plan(n_rows, b, True)
        mode = "segments_coef" if coef is not None else "segments"
        print(f"[{tag}] {label} ({mode}): {segments} segments (the "
              f"longest {longest} edges), {edges} "
              f"edges, B={b}, {plan.tiles(b)} tiles of {plan.tile_cols} "
              f"columns: max abs err {err:.3e} (relative to the row "
              f"{rel:.3e}), equal to the plain version bit for bit: {equal}, "
              f"two launches bit-equal: {again}; kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms (median of 10"
              f"{', L2 flushed before each' if cold else ''}), "
              f"{plain_ms / ms:.2f}x; host_us {split['host_us']:.2f} (plain "
              f"{plain_host_us:.2f}), device_ms {split['device_ms']:.4f} (a "
              f"launch of {launches} in one CUDA graph); bound_ms "
              f"{bound_ms:.4f} ({bound_by}: {rows} distinct rows read), "
              f"share {bound_ms / split['device_ms']:.3f}")
        shape = {"case": label, "mode": mode, "segments": segments,
                 "longest_segment": longest,
                 "edges": edges, "cols": b, "tile_cols": plan.tile_cols,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "plain_host_us": plain_host_us,
                 **split,
                 **library_times(label, k3_library(table, src, ptr, coef),
                                 want, ms, split, launches, calls, before,
                                 tag)}
        if cold:
            # what L2 delivers (every row read, the output) and what device
            # memory must (each distinct row once, the output, the indices)
            l2_bytes = 4.0 * (edges + segments) * b
            shape["l2_tb_s"] = l2_bytes / split["device_ms"] / 1e9
            shape["hbm_tb_s"] = unique_bytes / split["device_ms"] / 1e9
            print(f"[{tag}] {label}: {l2_bytes / 1e9:.3f} GB of row reads "
                  f"and output at {shape['l2_tb_s']:.2f} TB/s (L2); "
                  f"{unique_bytes / 1e9:.3f} GB of unique bytes at "
                  f"{shape['hbm_tb_s']:.2f} TB/s (device memory, peak "
                  f"{PEAK_BYTES / 1e12:.2f})")
        check(rel <= K3_TOL, f"K3 {label}: relative error {rel} > {K3_TOL}")
        check(equal, f"K3 {label}: differs from the plain version")
        check(again, f"K3 {label}: two launches differ")
        check(bool(torch.isfinite(got).all()), f"K3 {label}: not finite")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out["shapes"].append(shape)
        del table, got, want
    out.update({key: out["shapes"][0][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "host_us", "device_ms",
        "library_ms", "library_host_us", "library_device_ms")})
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

            def kernel():
                return rgm.row_gather(table, src)

            def library():
                return rgm.row_gather_ref(table, src)

            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(library)
            split = split_times(kernel, 1000, 1000)
            lib = split_times(library, 1000, 1000)
            split.update(library_host_us=lib["host_us"],
                         library_device_ms=lib["device_ms"])
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
            check(torch.equal(got, rgm.gather_segment_sum_ref(
                table, src_s, ptr)), f"K3 {label} accumulate: differs from "
                "the plain version")

            def kernel():
                return rgm.gather_segment_sum(table, src_s, ptr)

            ms = cuda_ms(kernel)
            plain_ms = cuda_ms(plain_accum)
            split = split_times(kernel, 1000, 1000)
            split.update(library_times(
                f"{label} accumulate", k3_library(table, src_s, ptr),
                rgm.gather_segment_sum_ref(table, src_s, ptr), ms, split,
                1000, 1000))
            plain = "index_select + index_add_"
            rows = int(torch.unique(src).numel())
            bound_ms, bound_by = bound(float(w) * b, 4.0 * (
                rows * b + w + 512 * b) + 8.0 * 513)
        print(f"[p1-p4] {label} {mode} table [{n}, {b}], {w} rows: kernel "
              f"{ns_per_row(ms, w):.2f} ns/row ({ms:.4f} ms), {plain} "
              f"{ns_per_row(plain_ms, w):.2f} ns/row ({plain_ms:.4f} ms); "
              f"max abs err {err:.3e}; bound_ms {bound_ms:.4f} ({bound_by})")
        print(f"[p1-p4] {label} {mode} table [{n}, {b}]: " + ", ".join(
            f"{key} {value:.4f}" for key, value in split.items()
            if key != "library_equal")
            + " (host: 1000 un-synchronised calls; device: 1000 launches "
            "in one CUDA graph)")
        shape = {"case": f"{label} {mode}", "table": [n, b], "rows": w,
                 "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                 "bound_by": bound_by, "ns_per_row": ns_per_row(ms, w),
                 "plain_ns_per_row": ns_per_row(plain_ms, w), **split}
        if mode == "gather":
            out["shapes"].append(shape)
        else:
            k3["shapes"].append(shape)
            k3["max_abs_err"] = max(k3["max_abs_err"], err)
    out.update({key: out["shapes"][0][key] for key in (
        "ms", "plain_ms", "bound_ms", "bound_by", "host_us", "device_ms",
        "library_host_us", "library_device_ms")})
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


def kernel_entry(line: str) -> str | None:
    """The kernel a ptxas line names, with its template arguments read out
    of the mangled name: (RT, mode) for ``dense_power.cu``, (load type,
    lanes a destination, segments) for ``row_gather.cu``."""
    entry = re.search(r"(ppr_\w+?_kernel)(?:I((?:6float4|f|Li\d+E|Lb\dE)+)E)?",
                      line)
    if not entry:
        return None
    args = [("float4" if a == "6float4" else "float" if a == "f" else a[2:-1])
            for a in re.findall(r"6float4|f|Li\d+E|Lb\dE", entry[2] or "")]
    return entry[1] + (f"<{', '.join(args)}>" if args else "")


def profile_batch(algo, sources, tag="profile",
                  trace="bench_trace.json") -> None:
    """Trace one ``compute_topk_ids_batch``; print device time by the aten
    operator that launched it, the kernels' span and the idle share inside
    it (``utils/timer.kernel_split``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join("build", "ppr_tpu_torch", trace)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        algo.compute_topk_ids_batch(sources, K, EPS)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(path)
    split = kernel_split(path, named={"K3": ("ppr_gather_kernel",)})
    check(split["kernels"] > 0, "the profiler recorded no kernel")
    sweeps = algo.last_iters
    print(f"[{tag}] one batch, {sweeps} sweeps: {split['kernels']} kernels, "
          f"busy {split['busy_ms']:.1f} ms in a span of "
          f"{split['span_ms']:.1f} ms (idle {100 * split['idle_share']:.1f}%)"
          f", host wall {wall_ms:.1f} ms; trace {path}")
    k3 = split["named"]["K3"]
    check(k3["launches"] > 0, "the traced batch ran no K3")
    for name, row in [("K3 gather_segment_sum", k3)] + [
            (op["name"], op) for op in split["by_op"]]:
        print(f"[{tag}] {name:32s} {row['ms']:9.2f} ms "
              f"{100 * row['share']:5.1f}% {row['launches']:6d} launches "
              f"{row['ms'] / sweeps:7.3f} ms/sweep")


class EngineSpy:
    """Records each call of the engine behind a real ``PPRService``, one
    layer below ``top_k`` / ``top_k_stream``: its width, seconds, thread,
    card, stream and number of distinct sources, and per stream the
    cohorts' row indices. ``walked`` holds the sources of the calls where
    FORA's cost model took the push+walk rounds (their rows are sampled).
    The rows a caller gets are read from the futures, not from here."""

    def __init__(self, svc):
        algo = svc._topk_algo
        self.calls = []
        self.streams = []
        self.walked = set()
        self.walk_calls = 0
        batch = algo.compute_topk_ids_batch
        cohorts = getattr(algo, "compute_topk_ids_cohorts", None)

        def note_path(sources, width, k, param, *args, **kwargs):
            if not algo._skip_push(float(param) * 0.5, width):
                self.walk_calls += 1
                self.walked.update(int(s) for s in sources)

        def compute_topk_ids_batch(sources, *args, **kwargs):
            t0 = time.perf_counter()
            note_path(sources, max(len(sources), 8), *args)
            out = batch(sources, *args, **kwargs)
            self._note(sources, t0)
            return out

        def compute_topk_ids_cohorts(sources, *args, **kwargs):
            t0 = time.perf_counter()
            note_path(sources, len(sources), *args)
            seen = []
            for idxs, vals, ids in cohorts(sources, *args, **kwargs):
                seen.append(np.asarray(idxs))
                yield idxs, vals, ids
            self._note(sources, t0)
            self.streams.append((len(sources), seen))

        algo.compute_topk_ids_batch = compute_topk_ids_batch
        if cohorts is not None:
            algo.compute_topk_ids_cohorts = compute_topk_ids_cohorts

    def _note(self, sources, t0):
        import threading

        import torch

        self.calls.append((len(sources), time.perf_counter() - t0,
                           threading.current_thread().name,
                           torch.cuda.current_device(),
                           torch.cuda.current_stream().cuda_stream,
                           len(set(np.asarray(sources).tolist()))))


class Recorder:
    """The server as ``run_rate`` sees it, keeping each request's source
    and future, so the checks read what the callers got back."""

    def __init__(self, server):
        self.server = server
        self.stats = server.stats
        self.sent = []

    def submit(self, source):
        fut = self.server.submit(source)
        self.sent.append((int(source), fut))
        return fut


def served_precision(oracle, oracle_sources, sent, tol) -> tuple:
    """Precision@10 of every served hit list whose source has an oracle
    row, against that row's top-10 with ties. A hit list carries only its
    exact ties, so the tie tolerance goes on the oracle's side: a hit
    within ``tol`` of the oracle's 10th value counts as right. Returns the
    mean and the number of rows."""
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties

    row_of = {int(s): i for i, s in enumerate(oracle_sources)}
    precs = []
    for s, fut in sent:
        if s not in row_of:
            continue
        o = oracle[row_of[s]]
        gnd = topk_ids_with_ties(o, K)
        kth = o[gnd].min()
        ids = np.array([h.node for h in fut.result(timeout=300)], np.int64)
        precs.append(min(int((o[ids] >= kth - tol).sum()), len(gnd))
                     / len(gnd))
    return float(np.mean(precs)) if precs else 0.0, len(precs)


def topk_ids_tol(vals, ids, tol):
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs

    return topk_ids_with_ties_from_pairs(vals, ids, K, tol=tol)


def window_stats(server, mark) -> dict:
    """Dispatches, mean batch and padded rows since ``mark`` (a dict of the
    counters taken earlier)."""
    st = server.stats
    d = st.dispatches - mark["dispatches"]
    rows = st.dispatched_rows - mark["rows"]
    return {"dispatches": d, "mean_batch": rows / d if d else 0.0,
            "padded_rows": st.padded_rows - mark["padded"]}


def stats_mark(server) -> dict:
    st = server.stats
    return {"dispatches": st.dispatches, "rows": st.dispatched_rows,
            "padded": st.padded_rows}


def service_ms(spy, since: int) -> str:
    """Mean seconds of the service calls since call ``since``, by width."""
    by_width = {}
    for width, secs, *_ in spy.calls[since:]:
        by_width.setdefault(width, []).append(secs * 1e3)
    return ", ".join(f"{w}: {np.mean(t):.1f} ms ({len(t)})"
                     for w, t in sorted(by_width.items()))


def open_loop(tag, server, spy, pool, rate, seconds, seed):
    """``serving_latency_torch.run_rate`` at ``rate`` qps, with the
    dispatch counters of the window and the service time by width; checks
    that every request resolved with a hit list and left a latency sample.
    Returns the row and the ``(source, future)`` pairs sent."""
    import random

    from serving_latency_torch import run_rate

    mark = stats_mark(server)
    n0, c0 = len(server.stats.latencies_ms), len(spy.calls)
    rec = Recorder(server)
    row = run_rate(rec, pool, rate, seconds, random.Random(seed))
    row.update(window_stats(server, mark))
    check(len(server.stats.latencies_ms) - n0 == row["requests"]
          == len(rec.sent) and all(f.done() and f.result()
                                   for _, f in rec.sent),
          f"[{tag}] {row['requests']} requests, "
          f"{len(server.stats.latencies_ms) - n0} resolved")
    print(f"[{tag}] offered {row['offered_qps']:.1f} qps for {seconds} s: "
          f"{row['requests']} requests, all resolved with hit lists, achieved "
          f"{row['achieved_qps']:.1f} qps; p50 {row['p50_ms']:.1f} ms, p95 "
          f"{row['p95_ms']:.1f}, p99 {row['p99_ms']:.1f}, mean "
          f"{row['mean_ms']:.1f}; {row['dispatches']} dispatches, mean batch "
          f"{row['mean_batch']:.1f}, padded rows {row['padded_rows']}, drain "
          f"{row['drain_s']:.3f} s; service time by width "
          f"{service_ms(spy, c0)}")
    return row, rec.sent


def serve_burst(server, sources):
    """Submit ``sources`` at once and wait for every row."""
    return [f.result(timeout=300) for f in [server.submit(int(s))
                                            for s in sources]]


def serving_layer(dev, ds, svc, sources, oracle, bench) -> dict[str, int]:
    """The serving layer on the bench graph and service: ``PPRBatchServer``
    (prewarm, open loop, SLO, cohort streaming), the early exit, the
    precomputed-BASE daemon loop on the ca-GrQc stand-in, the stdio daemon
    in a process of its own, and ``bench_torch.py``'s line. Returns the
    path's launch counts (the daemon process's own are not among them).
    ``bench`` holds [bench]'s ``dt``, ``sweeps``, ``vals`` and ``ids``."""
    import io
    import random
    import subprocess

    import torch

    import bench_torch
    from ppr_tpu_torch.cli import load_dataset
    from ppr_tpu_torch.models.base_allpair import BaseAllPair
    from ppr_tpu_torch.models.fora import ForaTopk
    from ppr_tpu_torch.ops import probe
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties
    from ppr_tpu_torch.service import PPRService
    from ppr_tpu_torch.serving import PPRBatchServer, serve_loop
    from serving_latency_torch import measure_capacity

    n_acc = len(oracle)
    tol = EPS / ds.n
    hs = svc._topk_algo.hub_split
    rng = random.Random(0)
    pool = [rng.randrange(ds.n) for _ in range(4096)]
    # the oracle's sources, one every 64 requests of the pool, so that each
    # stream of 2,048 requests or more serves every one of them
    for j, s in enumerate(sources[:n_acc]):
        pool[64 * j] = int(s)
    index = ds.graph.device.index or 0
    stream0 = torch.cuda.default_stream(dev).cuda_stream
    reset_launches()

    def served_check(tag, sent):
        prec, n_rows = served_precision(oracle, sources[:n_acc], sent, tol)
        check(n_rows >= n_acc and prec >= 0.99,
              f"[{tag}] precision@10 {prec} of {n_rows} served rows < 0.99")
        return prec, n_rows

    # --- [serving:prewarm] ------------------------------------------------
    spy = EngineSpy(svc)
    t0 = time.perf_counter()
    server = PPRBatchServer(svc, max_batch=2048, prewarm=True)
    prewarm_s = time.perf_counter() - t0
    rungs = [8 << i for i in range(9)]
    check(server.stats.prewarmed_widths == rungs,
          f"prewarmed widths {server.stats.prewarmed_widths}")
    check(probe.launches == 1 and index in probe.probed,
          "prewarm did not leave K0 probed once, on this thread")
    firsts = {}
    for width, secs, thread, card, stream, distinct in spy.calls:
        firsts.setdefault(width, []).append(secs * 1e3)
        check(thread == "MainThread", f"prewarm ran on {thread}")
        # n_nodes read: rung w probes w distinct real nodes, not copies
        check(distinct == width and svc.n_nodes == ds.n,
              f"prewarm probed {distinct} distinct sources at width {width}")
    for w in rungs:
        first, second = firsts[w][:2]
        path = ("annealed" if svc._topk_algo._skip_push(EPS * 0.5, w)
                else "push+walks")
        print(f"[serving:prewarm] rung {w:4d}: first call {first:9.1f} ms, "
              f"second {second:8.1f} ms ({w / second * 1e3:7.1f} rows/s); "
              f"EWMA seed {server._svc_time_ms[w]:.1f} ms; the cost "
              f"model's path: {path}")
    print(f"[serving:prewarm] 9 rungs 8..2048 prewarmed in {prewarm_s:.1f} s "
          f"on the main thread; sources spread over n_nodes={svc.n_nodes} "
          f"(rung w probes w distinct nodes); K0 launched once, before the "
          f"dispatcher started")

    # --- [serving:open-loop] ----------------------------------------------
    warm256 = server._svc_time_ms[256]
    serve_burst(server, pool[:2048])        # settle: one untimed flood
    mark, c0 = stats_mark(server), len(spy.calls)
    cap = measure_capacity(server, pool, 2048, reps=4)
    flood = window_stats(server, mark)
    print(f"[serving:open-loop] capacity at max batch 2048: {cap:.1f} qps "
          f"(one untimed flood of 2048 requests, then four timed: "
          f"{flood['dispatches']} dispatches, mean batch "
          f"{flood['mean_batch']:.1f}; service time by width "
          f"{service_ms(spy, c0)}); the warm EWMAs' best rows/s "
          f"{max(w / t for w, t in server._svc_time_ms.items()) * 1e3:.1f}")
    rows, sent = {}, []
    for frac in (0.5, 0.8):
        rows[frac], frac_sent = open_loop(f"serving:open-loop {frac}",
                                          server, spy, pool, frac * cap, 5.0,
                                          int(frac * 10))
        sent += frac_sent
    prec, n_prec = served_check("serving:open-loop", sent)
    threads = {(t, c, st) for _, _, t, c, st, _ in spy.calls[2 * len(rungs):]}
    check(threads == {("ppr-batch-dispatch", index, stream0)},
          f"dispatcher calls ran on {threads}")
    print(f"[serving:open-loop] precision@10 of the {n_prec} hit lists the "
          f"futures returned for the {n_acc} oracle sources in the streams: "
          f"{prec:.4f} (tie tol {tol:.3e}, on the oracle's side); every "
          f"dispatch ran on thread ppr-batch-dispatch, card {index}, the "
          f"default stream; {spy.walk_calls} engine calls (prewarm "
          f"included) took the push+walk rounds")
    print(f"[serving:open-loop] warm EWMAs after the runs: " + ", ".join(
        f"{w}: {t:.1f} ms" for w, t in sorted(server._svc_time_ms.items())))
    server.close()

    # --- [serving:slo] ------------------------------------------------------
    slo_ms = 2.0 * warm256
    server = PPRBatchServer(svc, max_batch=2048, slo_ms=slo_ms, prewarm=True)
    _, slo_sent = open_loop("serving:slo", server, spy, pool, 0.5 * cap, 5.0,
                            7)
    sprec, n_sprec = served_check("serving:slo", slo_sent)
    print(f"[serving:slo] slo_ms {slo_ms:.1f} (2x rung 256's warm prewarm "
          f"time {warm256:.1f} ms): cap moves {server.stats.cap_moves[:24]}"
          f"{' ...' if len(server.stats.cap_moves) > 24 else ''} "
          f"({len(server.stats.cap_moves)} in all), final cap "
          f"{server._cap()}, slo_unattainable "
          f"{server.stats.slo_unattainable} (ever "
          f"{server.stats.slo_unattainable_ever}), widened dispatches "
          f"{server.stats.widened_dispatches}; precision@10 of {n_sprec} "
          f"served rows {sprec:.4f}")
    server.close()

    # --- [serving:cohort] ------------------------------------------------
    csvc = PPRService.from_dataset(ds, alpha=ALPHA, eps=EPS, k=K, seed=7,
                                   cohort=True)
    csvc._topk_algo.hub_split = hs          # the bench service's hub split
    cspy = EngineSpy(csvc)
    server = PPRBatchServer(csvc, max_batch=2048, prewarm=True)
    crow, csent = open_loop("serving:cohort", server, cspy, pool, 0.5 * cap,
                            5.0, 5)
    server.close()
    for width, cohorts in cspy.streams:
        flat = np.sort(np.concatenate(cohorts))
        check(np.array_equal(flat, np.arange(width)),
              f"a width-{width} dispatch's cohorts do not cover it once")
    sizes = [len(c) for w, cs in cspy.streams if w == 2048 for c in cs]
    cprec, n_cprec = served_check("serving:cohort", csent)
    print(f"[serving:cohort] p50 {crow['p50_ms']:.1f} / p95 "
          f"{crow['p95_ms']:.1f} / p99 {crow['p99_ms']:.1f} ms beside batch "
          f"mode's {rows[0.5]['p50_ms']:.1f} / {rows[0.5]['p95_ms']:.1f} / "
          f"{rows[0.5]['p99_ms']:.1f} at {0.5 * cap:.1f} qps; "
          f"{len(cspy.streams)} streamed dispatches, each covered once by its "
          f"cohorts; the prewarm's width-2048 cohorts {sizes[:12]}")
    served_hits = {}
    for s, fut in csent:
        served_hits.setdefault(s, fut.result(timeout=300))
    # a row's cohort trajectory is the annealed per-row loop's: rows that
    # a push+walks dispatch served are samples, and the solo runs take
    # that loop explicitly (at B 1 the cost model picks push+walks)
    solo_rows = [s for s in dict.fromkeys(pool)
                 if s not in cspy.walked][:16]
    check(all(s in served_hits for s in solo_rows),
          "a row to hold against its solo run was not served")
    max_rel, exact = 0.0, 0
    csvc._topk_algo.push = "none"
    for s in solo_rows:
        solo = []
        csvc.top_k_stream([s], emit=lambda idxs, hits: solo.extend(hits))
        got, want = served_hits[s], solo[0]
        check({h.node for h in got} == {h.node for h in want},
              f"row {s}: served ids differ from a solo run")
        exact += int([(h.node, h.score) for h in got]
                     == [(h.node, h.score) for h in want])
        score = {h.node: h.score for h in want}
        top = max(score.values())
        max_rel = max(max_rel, max(abs(h.score - score[h.node]) / top
                                   for h in got))
    csvc._topk_algo.push = "auto"
    # a full-width dispatch both ways, in turns: the work a stream saves
    full = {"batch": [], "cohort": []}
    for _ in range(3):
        for mode, run in (("batch", lambda: svc.top_k(sources)),
                          ("cohort", lambda: csvc.top_k_stream(
                              sources, emit=lambda *a: None))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            full[mode].append((time.perf_counter() - t0) * 1e3)
    print(f"[serving:cohort] 16 served hit lists against solo "
          f"``top_k_stream`` runs of their sources on the annealed loop "
          f"({cspy.walk_calls} engine calls took the push+walk rounds; "
          f"their {len(cspy.walked)} sources are not among the 16): ids "
          f"equal on all 16; "
          f"bit-equal on {exact}; largest score difference {max_rel:.2e} of "
          f"the row's top score; precision@10 of {n_cprec} served rows "
          f"{cprec:.4f} (tie tol {tol:.3e}); B={len(sources)} in turns, ms: "
          f"top_k {', '.join(f'{t:.1f}' for t in full['batch'])}, "
          f"top_k_stream {', '.join(f'{t:.1f}' for t in full['cohort'])}")

    # --- [serving:early-exit] ---------------------------------------------
    ee = ForaTopk(ds, ALPHA, K, seed=7, early_exit=True)
    ee.hub_split = hs
    ee.compute_topk_ids_batch(sources, K, EPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evals, eids = ee.compute_topk_ids_batch(sources, K, EPS)
    edt = time.perf_counter() - t0
    differ = [i for i in range(len(sources)) if set(topk_ids_tol(
        evals[i], eids[i], 0.0)) != set(topk_ids_tol(
            bench["vals"][i], bench["ids"][i], 0.0))]
    print(f"[serving:early-exit] B={len(sources)}: {ee.last_iters} sweeps, "
          f"{edt * 1e3:.1f} ms = {len(sources) / edt:.1f} qps beside "
          f"[bench]'s {bench['sweeps']} sweeps, "
          f"{len(sources) / bench['dt']:.1f} qps; tie-expanded top-10 sets "
          f"equal to the plain batch's on {len(sources) - len(differ)} of "
          f"{len(sources)} rows")
    check(not differ, f"early exit changed the top-10 set of rows "
          f"{differ[:8]}")
    del ee, evals, eids

    # --- [serving:precomputed] --------------------------------------------
    work = os.path.abspath(os.path.join("build", "ppr_tpu_torch", "serving",
                                        "precomputed"))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cwd = os.getcwd()
    try:
        os.chdir(work)    # a BASE store's root is relative to the CWD
        grqc = load_dataset("synth:grqc", device=dev)
        thr = 1e-3        # the cheapest BASE threshold of [protocol:grqc]
        t0 = time.perf_counter()
        BaseAllPair(grqc, ALPHA).preprocessing(thr, -1, progress=False)
        prep_s = time.perf_counter() - t0
        psvc = PPRService.from_dataset(grqc, alpha=ALPHA, k=K,
                                       precomputed=(thr, -1))
        qs = np.random.default_rng(9).integers(0, grqc.n, 512)
        lines = io.StringIO("".join(json.dumps({"source": int(q), "id": j})
                                    + "\n" for j, q in enumerate(qs)))
        out = io.StringIO()
        t0 = time.perf_counter()
        pstats = serve_loop(psvc, lines, out, max_batch=64)
        loop_s = time.perf_counter() - t0
        resp = {r["id"]: r for r in map(json.loads,
                                         out.getvalue().splitlines())}
        store = psvc._topk_algo._store
        for j, q in enumerate(qs):
            ids, vals = store.read_row_ordered(int(q))
            dense = np.zeros(grqc.graph.n_pad, np.float32)
            dense[ids] = vals
            want = [[int(v), float(dense[v])]
                    for v in topk_ids_with_ties(dense, K)]
            got = [[h[0], h[1]] for h in resp[j]["hits"]]
            check(got == want, f"precomputed row {q} differs from the store")
        nbytes = store.size_bytes()
    finally:
        os.chdir(cwd)
    pct = pstats.latency_percentiles()
    print(f"[serving:precomputed] synth:grqc BASE store at threshold {thr} "
          f"(whole-graph rows, {nbytes} bytes, built in "
          f"{prep_s:.2f} s): 512 requests through serve_loop in "
          f"{loop_s:.3f} s = {512 / loop_s:.1f} qps, {pstats.dispatches} "
          f"dispatches, p50 {pct['p50']:.2f} / p99 {pct['p99']:.2f} ms; every "
          f"hit list equals the store's row read directly")

    # --- [serving:daemon] -------------------------------------------------
    reqs = [json.dumps({"source": int(s), "id": j})
            for j, s in enumerate(np.random.default_rng(8).integers(0, 2048,
                                                                     64))]
    reqs.append(json.dumps({"cmd": "stats", "id": "stats"}))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ppr_tpu_torch.serving", "--db",
         "synth:2048x8", "--device", "cuda"], stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        dout, derr = proc.communicate("\n".join(reqs) + "\n", timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    daemon_s = time.perf_counter() - t0
    answers = [json.loads(line) for line in dout.splitlines()]
    hits = [a for a in answers if "hits" in a]
    dstats = [a["stats"] for a in answers if "stats" in a]
    ready = [line for line in derr.splitlines() if '"ready"' in line]
    print(f"[serving:daemon] python -m ppr_tpu_torch.serving --db "
          f"synth:2048x8 --device cuda: exit {proc.returncode} after "
          f"{daemon_s:.1f} s; {len(hits)} hit responses, stats line "
          f"{dstats[:1]}; {ready[:1]}")
    check(proc.returncode == 0, f"the daemon exited {proc.returncode}: "
          f"{derr[-2000:]}")
    check(len(hits) == 64 and all(a["hits"] for a in hits)
          and sorted(a["id"] for a in hits) == list(range(64)),
          "the daemon did not answer the 64 requests")
    check(len(dstats) == 1, "the daemon gave no stats line")

    # --- [bench:json] -------------------------------------------------------
    rec = bench_torch.run(bench_torch.parse_args([]))
    print(f"[bench:json] {json.dumps(rec)}")
    check(rec["recall_at_10"] >= 0.99,
          f"bench_torch recall_at_10 {rec['recall_at_10']} < 0.99")
    counts = read_launches()
    print(f"[serving] serving-layer path launches: K3 {counts['k3']}, K0 "
          f"{counts['k0']}, K1 {counts['k1']}")
    check(counts["k3"] > 0, "the serving layer did not launch K3")
    check(counts["k0"] == 1, f"K0 ran {counts['k0']} times on the serving "
          "layer, not once")
    check_sweep_passes("serving", counts, annealed=True)
    return counts


#: sweeps the annealed loop launched since ``reset_launches``, counted by
#: ``count_annealed_sweeps`` from each call's own sweep count
ANNEALED_SWEEPS = [0]


def count_annealed_sweeps() -> None:
    """Wrap ``fora.annealed_topk_propagate`` (once a process) to add the
    sweeps each call launches to ``ANNEALED_SWEEPS``: its live sweeps,
    rounded up to the ``CHECK_EVERY`` sweeps between its reads of
    ``finished``, at most ``MAX_TOPK_SWEEPS``. Counted apart from the
    kernels, so that ``check_sweep_passes`` can hold their launches to
    it."""
    from ppr_tpu_torch.models import fora

    real = fora.annealed_topk_propagate
    if getattr(real, "counts_sweeps", False):
        return

    def counted(*a, **kw):
        p, r, iters = real(*a, **kw)
        ANNEALED_SWEEPS[0] += min(
            -(-int(iters) // fora.CHECK_EVERY) * fora.CHECK_EVERY,
            fora.MAX_TOPK_SWEEPS)
        return p, r, iters

    counted.counts_sweeps = True
    fora.annealed_topk_propagate = counted


def reset_launches() -> None:
    """Zero every kernel's launch count and the annealed loop's sweeps;
    forget the probe, so K0 runs again before the next hand-kernel
    launch."""
    from ppr_tpu_torch.ops import dense_power, probe, row_gather, sweep_pass

    dense_power.launches = 0
    dense_power.pagerank_launches = 0
    row_gather.segment_sum_launches = 0
    row_gather.segment_sum_coef_launches = 0
    row_gather.gather_launches = 0
    sweep_pass.pre_launches = 0
    sweep_pass.post_launches = 0
    sweep_pass.finalize_launches = 0
    ANNEALED_SWEEPS[0] = 0
    probe.reset()


def read_launches() -> dict[str, int]:
    from ppr_tpu_torch.ops import dense_power, probe, row_gather, sweep_pass

    return {"k1": dense_power.launches, "k2": dense_power.pagerank_launches,
            "k0": probe.launches, "k3": row_gather.segment_sum_launches,
            "k3_coef": row_gather.segment_sum_coef_launches,
            "gather": row_gather.gather_launches,
            "sweep_pre": sweep_pass.pre_launches,
            "sweep_post": sweep_pass.post_launches,
            "sweep_fin": sweep_pass.finalize_launches,
            "sweeps": ANNEALED_SWEEPS[0]}


def check_sweep_passes(tag: str, counts: dict[str, int],
                       annealed: bool = False) -> None:
    """The annealed loop's fused passes on a path: one launch of each of
    ``ppr_sweep_pre``, ``ppr_sweep_post`` and ``ppr_sweep_finalize`` a
    sweep the loop launched there; some, where ``annealed`` (a path that
    runs the loop)."""
    pre, post, fin, sweeps = (counts[key] for key in (
        "sweep_pre", "sweep_post", "sweep_fin", "sweeps"))
    print(f"[{tag}] the annealed loop's passes: pre {pre}, post {post}, "
          f"finalize {fin} launches for its {sweeps} sweeps")
    check(pre == post == fin == sweeps,
          f"[{tag}] the passes launched pre {pre}, post {post}, finalize "
          f"{fin} times for the annealed loop's {sweeps} sweeps")
    check(not annealed or sweeps > 0,
          f"[{tag}] the annealed loop ran no sweep on the path")


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
    return read_protocol_file(os.path.join(work, name)), wall, work


def check_protocol_rows(tag: str, rows, jax_rows=None) -> None:
    """Print every row (``ProtocolRow`` s) and hold it to
    ``report.row_failures``, the bars ``protocol_grid_torch.py`` holds its
    rows to: every number finite, every store non-empty, the Neo4j
    method's own bars (max-err <= 1e-6 from 100 iterations, precision 1.0
    and NDCG >= 0.999 from 40), and the bar of PERF.md section 2 against
    the row of ``jax_rows`` (``{(test, algo): {param: accuracy}}``) of the
    same test, algorithm and param, every one of which must be present:
    the walk paths by distribution, the rest to the JAX row's digits."""
    check(bool(rows), f"[protocol:{tag}] no result rows")
    seen = set()
    for r in rows:
        want = (jax_rows or {}).get((r.test, r.algo), {}).get(r.param)
        if want is not None:
            seen.add((r.test, r.algo, r.param))
        print(f"[protocol:{tag}] {r.summary()}"
              + ("" if want is None else f"; JAX {want:.6g}"))
        failures = row_failures(r, want)
        check(not failures, f"[protocol:{tag}] test {r.test} {r.algo} "
              f"{r.param}: " + "; ".join(failures))
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
    check(sum((r.test, r.algo) == (2, "FORA_TOPK") for r in rows) == 5,
          "FORA_TOPK rows missing")

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
    prep = {r.param: r.prep[0] for r in rows
            if (r.test, r.algo) == (3, "NEO4J_METHOD")}
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
    check_sweep_passes("protocol", counts)

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


#: ``protocol_grid_reference.py``'s blocks that ``[protocol:blogcatalog]``
#: and ``[protocol:amazon]`` run again and are held to: the JAX package's
#: rows of the same commands on the CPU
DATASET_BLOCKS = {"blogcatalog": "blogcatalog_t12", "amazon": "amazon_t2"}
JAX_CPU_ROWS = os.path.join("results", "protocol_grid_jax_cpu.json")


def dataset_protocol_path(dev) -> tuple[dict[str, int], dict]:
    """``[protocol:blogcatalog]`` and ``[protocol:amazon]``: the CLI at the
    named datasets' stand-ins (10,240 and 262,144 nodes) with the commands
    of their ``jax-cpu`` blocks in ``results/protocol_grid_jax_cpu.json``
    (Forward Push, the Neo4j method and BASE, Tests 1-2, on blogcatalog;
    Forward Push and the Neo4j method, Test 2, on amazon), every row held
    to the block's by ``check_protocol_rows``'s bars. Every K3 launch of
    the window is made in a call ``HeldK3(protocol=True)`` holds: each
    push, reverse push and Neo4j loop and the oracle, one launch a sweep.
    Returns the path's launch counts and each run's wall."""
    import shlex

    import torch

    with open(JAX_CPU_ROWS) as f:
        blocks = json.load(f)["blocks"]
    walls = {}
    reset_launches()
    with HeldK3(protocol=True) as held:
        for tag, name in DATASET_BLOCKS.items():
            block = blocks[name]
            argv = shlex.split(block["command"])
            args = argv[argv.index("ppr_tpu.cli") + 1:]
            jax_rows: dict = {}
            for r in read_protocol_rows(block["report"]):
                jax_rows.setdefault((r.test, r.algo), {})[r.param] = \
                    r.accuracy
            mark = held.mark()
            torch.cuda.reset_peak_memory_stats()
            rows, wall, _ = run_protocol(tag, args)
            walls[tag] = round(wall, 3)
            peak = torch.cuda.max_memory_allocated() / 1e9
            print(f"[protocol:{tag}] {' '.join(args)}: wall {wall:.1f} s, "
                  f"peak {peak:.2f} GB; JAX CPU's block {name} "
                  f"({block['seconds']} s on {block['cpu']})")
            check_protocol_rows(tag, rows, jax_rows=jax_rows)
            held.hold(f"protocol:{tag}", mark)
    counts = read_launches()
    print(f"[protocol:datasets] K3 launches {counts['k3']}, all in held "
          f"calls: {counts['k3'] == held.got}; K0 {counts['k0']}")
    check(counts["k3"] == held.got and not held.bad,
          f"[protocol:datasets] {counts['k3']} K3 launches, {held.got} in "
          f"held calls; {held.bad[:4]}")
    check(counts["k0"] == 1, f"K0 ran {counts['k0']} times, not once")
    check_sweep_passes("protocol:datasets", counts)
    check(counts["k1"] == counts["k2"] == 0,
          "the sparse stand-ins launched K1 or K2")
    return counts, {"walls_s": walls, "held_calls": held.calls}


def walk_phase(dev, g) -> dict:
    """``[walk]``: ``weighted_walk_counts`` on the bench graph, 2^22
    walkers from seeded starts, with the phase compaction (16 steps, a
    factor 4) and without it (``compact_factor=1``), in turns after one
    untimed call of each: walks/s of the median of three, and the mass
    (it must be 1 within f32)."""
    import torch

    from ppr_tpu_torch.ops.walk import weighted_walk_counts

    w = 1 << 22
    starts = torch.as_tensor(np.random.default_rng(0).integers(0, g.n, w),
                             dtype=torch.int32, device=dev)
    rows = torch.zeros(w, dtype=torch.int64, device=dev)
    weights = torch.full((w,), 1.0 / w, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    times = {4: [], 1: []}
    for i, cf in enumerate((4, 1, 4, 1, 1, 4, 4, 1)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        counts = weighted_walk_counts(g, starts, rows, weights, gen, ALPHA,
                                      1, compact_factor=cf)
        torch.cuda.synchronize()
        if i >= 2:
            times[cf].append(time.perf_counter() - t0)
        mass = float(counts.sum())
        check(abs(mass - 1.0) <= 1e-6 and not counts[:, g.n:].any(),
              f"[walk] compact_factor {cf}: mass {mass} is not 1")
    out = {cf: w / float(np.median(t)) for cf, t in times.items()}
    print(f"[walk] weighted_walk_counts on the bench graph, {w} walkers "
          f"from seeded starts: {out[4]:.4g} walks/s with the compaction "
          f"(16 steps, factor 4), {out[1]:.4g} without (compact_factor=1); "
          f"ms of each call {', '.join(f'{t * 1e3:.2f}' for t in times[4])}"
          f" and {', '.join(f'{t * 1e3:.2f}' for t in times[1])}; mass 1 "
          f"within 1e-6 in every call")
    return out


def calibrate_phase(dev, ds) -> dict:
    """``[calibrate]``: ``calibrate.measure`` on the bench graph three
    times; the constants in the code beside them; the path FORA top-k
    takes at the bench query for every serving rung, with either set. At
    B 2048 both must pick the annealed loop."""
    from ppr_tpu_torch.models.fora import ForaTopk, _default_cost_constants
    from ppr_tpu_torch.utils import calibrate

    runs = []
    for i in range(3):
        runs.append(calibrate.measure(ds.graph, alpha=ALPHA))
        print(f"[calibrate] measure #{i}: {runs[-1][0]:.1f} ns a walk, "
              f"{runs[-1][1]:.4f} ns an edge of a sweep (the batch's), "
              f"device-to-host {runs[-1][3] / 1e9:.3f} GB/s")
    med = (float(np.median([r[0] for r in runs])),
           float(np.median([r[1] for r in runs])), True,
           float(np.median([r[3] for r in runs])))
    code = _default_cost_constants(dev)
    print(f"[calibrate] median {med[0]:.1f} ns a walk, {med[1]:.4f} ns an "
          f"edge, {med[3] / 1e9:.3f} GB/s; the code's H100 constants "
          f"{code[0]} ns, {code[1]} ns, amortized {code[2]}, "
          f"{code[3] / 1e9:.3f} GB/s")
    rungs = [8 << i for i in range(9)]
    ours = ForaTopk(ds, ALPHA, K)
    measured = ForaTopk(ds, ALPHA, K)
    calibrate.apply(measured, med)
    out = {}
    for w in rungs:
        walk, spmv, path = ours.path_cost(EPS * 0.5, w)
        mwalk, mspmv, mpath = measured.path_cost(EPS * 0.5, w)
        out[w] = path == "annealed"
        print(f"[calibrate] B {w:4d}: walks {walk / 1e3:.1f} us vs "
              f"propagation {spmv / 1e3:.1f} us a query -> {path} (code's "
              f"constants); {mwalk / 1e3:.1f} vs {mspmv / 1e3:.1f} us -> "
              f"{mpath} (this run's)")
    check(out[2048] and measured._skip_push(EPS * 0.5, 2048),
          "[calibrate] the cost model does not pick the annealed loop at "
          "B 2048")
    return {"runs": runs, "median": med, "annealed": out}


def walk_path(dev, ds, hs) -> dict[str, int]:
    """Monte-Carlo, FORA's push+walk rounds and FORA whole-graph on the
    bench graph, then the protocol CLI with the walk completions; returns
    the path's launch counts."""
    import torch

    from ppr_tpu_torch.models.fora import ForaTopk, ForaWholeGraph
    from ppr_tpu_torch.models.monte_carlo import MonteCarlo, mc_num_walks
    from ppr_tpu_torch.models.power_method import power_method_batch
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties
    from ppr_tpu_torch.utils.metrics import max_abs_err, ndcg_at_k

    reset_launches()
    g = ds.graph
    rng = np.random.default_rng(11)

    # --- [mc:bench] -------------------------------------------------------
    src4 = rng.integers(0, g.n, 4)
    oracle4 = power_method_batch(g, src4.astype(np.int32), ALPHA, ITERS) \
        .cpu().numpy()
    mc = MonteCarlo(ds, ALPHA, seed=1)
    omega = mc_num_walks(EPS, mc.delta, mc.pfail)
    mc.compute_whole_graph_batch(src4[:1], EPS)           # untimed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = mc.compute_whole_graph_batch(src4, EPS)
    dt = time.perf_counter() - t0
    err = float(np.mean([max_abs_err(scores[i], oracle4[i])
                         for i in range(4)]))
    mass = scores.sum(axis=1)
    print(f"[mc:bench] Monte-Carlo on the bench graph, 4 sources, eps {EPS}: "
          f"{omega} walks a source in chunks of {mc._source_chunk(EPS)}; "
          f"{dt * 1e3 / 4:.1f} ms a query ({4 * omega / dt:.4g} walks/s); "
          f"mean max-err {err:.4f} against the {ITERS}-iteration power "
          f"method; row mass {mass.min():.7f}..{mass.max():.7f}")
    check(err < 0.05, f"[mc:bench] mean max-err {err} >= 0.05")
    check(np.abs(mass - 1.0).max() <= 1e-5, f"[mc:bench] row mass {mass}")

    # --- [fora:walks] -----------------------------------------------------
    src = rng.integers(0, g.n, 64)
    oracle = power_method_batch(g, src.astype(np.int32), ALPHA, ITERS) \
        .cpu().numpy()
    for completion in ("walks", "spmv"):
        algo = ForaTopk(ds, ALPHA, K, seed=7, push="reference",
                        completion=completion)
        algo.hub_split = hs
        algo.compute_topk_batch(src, K, EPS)               # untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = algo.compute_topk_batch(src, K, EPS)
        dt = time.perf_counter() - t0
        gnd = [topk_ids_with_ties(oracle[i], K) for i in range(64)]
        ids = [topk_ids_with_ties(scores[i], K) for i in range(64)]
        prec = precision(oracle, ids)
        ndcg = float(np.mean([ndcg_at_k(ids[i], gnd[i], oracle[i])
                              for i in range(64)]))
        print(f"[fora:walks] ForaTopk(push='reference', completion="
              f"'{completion}') B 64 eps {EPS} k {K}: {algo.last_iters} "
              f"rounds, walkers a round {algo.last_round_walks or 'none'}; "
              f"{dt * 1e3:.1f} ms a batch; precision@10 {prec:.4f}, NDCG "
              f"{ndcg:.4f}")
        check(prec > 0.9 and ndcg > 0.97, f"[fora:walks] top-k "
              f"{completion}: precision {prec}, NDCG {ndcg}")
    for completion in ("walks", "spmv"):
        algo = ForaWholeGraph(ds, ALPHA, seed=7, completion=completion)
        algo.hub_split = hs
        algo.compute_whole_graph_batch(src, EPS)           # untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = algo.compute_whole_graph_batch(src, EPS)
        dt = time.perf_counter() - t0
        err = float(np.mean([max_abs_err(scores[i], oracle[i])
                             for i in range(64)]))
        print(f"[fora:walks] ForaWholeGraph(completion='{completion}') B 64 "
              f"eps {EPS}: {algo.last_rounds} push rounds "
              f"({algo.last_push_ns / 1e3:.1f} us a query); "
              f"{dt * 1e3:.1f} ms a batch; mean max-err {err:.3e}")
        check(err < 0.03, f"[fora:walks] whole-graph {completion}: mean "
              f"max-err {err}")

    # --- [protocol:walks] -------------------------------------------------
    for seed in (0, 1, 2):
        rows, wall, _ = run_protocol(f"walks_got_s{seed}", [
            "--db", "synth:107x3@7", "--sweep", "got", "--query", "50",
            "--k", str(K), "--tests", "1,2,3", "--seed", str(seed),
            "--algos", "MC,FORA_WHOLE_GRAPH,FORA_TOPK",
            "--fora-completion", "walks"])
        print(f"[protocol:walks] synth:107x3@7 --seed {seed} --fora-"
              f"completion walks, MC, FORA_WHOLE_GRAPH, FORA_TOPK, Tests "
              f"1-3: wall {wall:.1f} s")
        check_protocol_rows(f"walks:got:{seed}", rows,
                            WALK_JAX_ROWS[("got", seed)])
    for completion in ("auto", "walks"):
        rows, wall, _ = run_protocol(f"walks_grqc_{completion}", [
            "--db", "synth:grqc", "--query", "50", "--k", str(K),
            "--tests", "1,2", "--algos", "FORA_WHOLE_GRAPH,FORA_TOPK",
            "--fora-completion", completion])
        print(f"[protocol:walks] synth:grqc --fora-completion {completion}, "
              f"FORA_WHOLE_GRAPH, FORA_TOPK, Tests 1-2: wall {wall:.1f} s")
        check_protocol_rows(f"walks:grqc:{completion}", rows,
                            WALK_JAX_ROWS[("grqc", completion)])
    counts = read_launches()
    print(f"[protocol:walks] walk path launches: K3 {counts['k3']}, K1 "
          f"{counts['k1']}, K0 {counts['k0']}")
    check(counts["k3"] > 0, "the walk path did not launch K3")
    check(counts["k1"] > 0, "the walk path's oracle did not launch K1")
    check(counts["k0"] == 1, f"K0 ran {counts['k0']} times, not once")
    check_sweep_passes("protocol:walks", counts)
    return counts


@contextlib.contextmanager
def counting_plain_k3():
    """Count the calls of K3's plain version while the block runs (a
    weighted push on the card must launch the kernel, never the plain
    pair): yields a one-item list with the count."""
    from ppr_tpu_torch.ops import row_gather

    calls = [0]
    plain = row_gather.gather_segment_sum_ref

    def counted(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    row_gather.gather_segment_sum_ref = counted
    try:
        yield calls
    finally:
        row_gather.gather_segment_sum_ref = plain


def weighted_oracle(g, sources) -> np.ndarray:
    """The PPR rows of ``sources`` on a weighted graph by
    ``power_method_batch``'s iteration, ``ITERS`` rounds, in float64 through
    torch's sparse product: independent of K3's coefficient mode, which the
    weighted path under test runs. Returns ``[B, n_pad]`` float32."""
    import torch

    m = g.m
    op = torch.sparse_coo_tensor(
        torch.stack([g.edge_dst[:m].long(), g.edge_src[:m].long()]),
        g.edge_coef[:m].double(), (g.n_pad, g.n_pad),
        check_invariants=True).coalesce()
    src_t = torch.nn.functional.one_hot(
        torch.as_tensor(np.asarray(sources), dtype=torch.long,
                        device=g.device), g.n_pad).double().T
    dangling = ((g.out_deg == 0) & (g.node_mask > 0))[:, None]
    p = torch.zeros_like(src_t)
    r = src_t
    for _ in range(ITERS):
        p = p + ALPHA * r
        rem = (1.0 - ALPHA) * r
        rem_dang = torch.where(dangling, rem, 0.0)
        r = op @ (rem - rem_dang) + rem_dang.sum(dim=0) * src_t
    return p.T.float().cpu().numpy()


def builder_paths(g, wg) -> None:
    """``[weighted]``: the native builder against the numpy paths on the
    host, at the smoke's sizes: the CSR of the bench graph's edges (in a
    seeded shuffle), the parse of those edges written as a ``src dst``
    file, and the alias tables of the weighted bench graph. Both paths must
    give the same arrays; prints each one's seconds (the best of three for
    the native calls and the numpy CSR, one run of each Python loop)."""
    import tempfile

    from ppr_tpu_torch import native
    from ppr_tpu_torch.graph.csr import alias_tables_python, csr_numpy
    from ppr_tpu_torch.graph.io import parse_edge_list_python

    if not native.available():
        print("[weighted] no C++ compiler: every graph is built by the "
              "numpy paths")
        return

    def best(fn, reps):
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append(time.perf_counter() - t0)
        return out, min(times)

    m = g.m
    perm = np.random.default_rng(5).permutation(m)
    src = g.edge_src[:m].cpu().numpy().astype(np.int64)[perm]
    dst = g.edge_dst[:m].cpu().numpy().astype(np.int64)[perm]
    fast, t_fast = best(
        lambda: native.build_csr_native(src, dst, g.n, g.n_pad), 3)
    slow, t_slow = best(lambda: csr_numpy(src, dst, g.n_pad), 3)
    same_csr = all(np.array_equal(a, b) for a, b in zip(fast, slow[1:]))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_edges.txt")
        np.savetxt(path, np.stack([src, dst], axis=1), fmt="%d")
        cap = max(os.path.getsize(path) // 3 + 16, 1024)
        parsed, t_parse = best(
            lambda: native.parse_edge_list_native(path, cap), 3)
        py, t_py = best(lambda: parse_edge_list_python(path), 1)
    same_parse = all(np.array_equal(a, b) for a, b in zip(parsed, py))
    indptr = wg.indptr.cpu().numpy()
    coef = wg.edge_coef[: wg.m].cpu().numpy().astype(np.float64)
    tables, t_alias = best(
        lambda: native.build_alias_native(indptr, coef, wg.m_pad), 3)
    loop, t_loop = best(lambda: alias_tables_python(indptr, coef, wg.m_pad),
                        1)
    same_alias = all(np.array_equal(a, b) for a, b in zip(tables, loop))
    print(f"[weighted] host build paths, native C++ vs numpy/Python: CSR of "
          f"the bench graph's {m} edges {t_fast * 1e3:.1f} vs "
          f"{t_slow * 1e3:.1f} ms; parse of them as a text file "
          f"{t_parse * 1e3:.1f} vs {t_py * 1e3:.1f} ms; alias tables of the "
          f"weighted bench graph {t_alias * 1e3:.1f} vs {t_loop * 1e3:.1f} "
          f"ms; same arrays: CSR {same_csr}, parse {same_parse}, alias "
          f"{same_alias}")
    check(same_csr and same_parse and same_alias,
          "[weighted] the native builder and the numpy paths disagree")


def weighted_path(dev, wds, unweighted_walk_rate: float) -> dict[str, int]:
    """The weighted graphs' path: ``[weighted:oracle]``, ``[weighted:fora]``
    (with ``[weighted:profile]``), ``[weighted:walks]`` and
    ``[protocol:weighted]``; returns the path's launch counts."""
    import tempfile

    import torch

    from ppr_tpu_torch.graph.io import load_edge_list, synthetic_weighted
    from ppr_tpu_torch.harness import PerfHarness
    from ppr_tpu_torch.models.config import AlgoConf
    from ppr_tpu_torch.models.fora import ForaWholeGraph
    from ppr_tpu_torch.models.monte_carlo import MonteCarlo, mc_num_walks
    from ppr_tpu_torch.models.power_method import power_method_batch
    from ppr_tpu_torch.ops import dense_power
    from ppr_tpu_torch.ops.walk import weighted_walk_counts
    from ppr_tpu_torch.service import PPRService
    from ppr_tpu_torch.utils.metrics import max_abs_err

    reset_launches()
    g = wds.graph
    rng = np.random.default_rng(12)
    with counting_plain_k3() as plain_calls:
        # --- [weighted:oracle] ----------------------------------------------
        dense_ds = synthetic_weighted(1000, 16, seed=11,
                                      dense_threshold=1024, device=dev)
        dense = dense_ds.graph
        sparse = synthetic_weighted(1000, 16, seed=11, dense_threshold=0,
                                    device=dev).graph
        check(dense.n_pad == 1024 and dense_power.supports(dense),
              "[weighted:oracle] K1 does not take the weighted 1000-node "
              "graph")
        src50 = rng.choice(1000, 50, replace=False)
        k1_before = dense_power.launches
        via_k1 = AlgoConf(ALPHA).set_conf_power_method(dense_ds) \
            .compute_whole_graph_batch(src50)
        via_k3 = power_method_batch(sparse, src50, ALPHA, ITERS) \
            .cpu().numpy()
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(src50, device=dev), dense.n_pad).float()
        plain = dense_power.dense_power_iterations_ref(
            dense, onehot, ALPHA, ITERS).cpu().numpy()
        err_sparse = float(np.abs(via_k1 - via_k3).max())
        err_plain = float(np.abs(via_k1 - plain).max())
        mass = via_k1.astype(np.float64).sum(axis=1)
        print(f"[weighted:oracle] PowerMethod on synthetic_weighted(1000, "
              f"16, seed=11), n_pad 1024, B 50, {ITERS} rounds: K1 launches "
              f"{dense_power.launches - k1_before}; max|K1 - sparse "
              f"weighted path (K3 coefficient mode)| {err_sparse:.3e}, "
              f"max|K1 - plain| {err_plain:.3e}; row mass "
              f"{mass.min():.7f}..{mass.max():.7f}")
        check(dense_power.launches > k1_before,
              "[weighted:oracle] the oracle did not launch K1")
        check(err_sparse <= K1_TOL and err_plain <= K1_TOL,
              f"[weighted:oracle] K1 {err_sparse} from the sparse path, "
              f"{err_plain} from its plain version (bar {K1_TOL})")

        # --- [weighted:fora] ------------------------------------------------
        svc = PPRService.from_dataset(wds, alpha=ALPHA, eps=EPS, k=K,
                                      seed=7)
        algo = svc._topk_algo
        check(algo.hub_split is None, "[weighted:fora] a hub split")
        sources = rng.integers(0, g.n, 2048)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        vals, ids = algo.compute_topk_ids_batch(sources, K, EPS)  # warm-up
        warm_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hits = svc.top_k(sources, k=K)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        sweeps = algo.last_iters
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        annealed = algo._skip_push(EPS * 0.5, len(sources))
        n_acc = 32
        oracle = weighted_oracle(g, sources[:n_acc])
        tol = EPS / g.n
        prec = precision(oracle, tie_tolerant_ids(vals, ids, n_acc, tol))
        print(f"[weighted:fora] ForaTopk(push='auto') on the weighted bench "
              f"graph, no hub split, B={len(sources)} k={K} eps={EPS}: "
              f"top_k {dt * 1e3:.1f} ms = {len(sources) / dt:.1f} qps, "
              f"sweeps {sweeps} ({dt * 1e3 / max(sweeps or 1, 1):.2f} "
              f"ms/sweep incl. epilogue), warm-up call {warm_s:.2f} s, peak "
              f"device memory {peak_gb:.2f} GB; the cost model's path: "
              f"{'the annealed loop' if annealed else 'push+walks'}; "
              f"precision@10 over {n_acc} rows {prec:.4f} (tie tol "
              f"{tol:.3e}) against the weighted oracle (the power method, "
              f"{ITERS} iterations, in float64 by torch's sparse product)")
        check(len(hits) == len(sources) and all(hits),
              "[weighted:fora] empty hit lists")
        check(prec >= 0.99, f"[weighted:fora] precision@10 {prec} < 0.99")
        profile_batch(algo, sources, tag="weighted:profile",
                      trace="weighted_trace.json")

        src64 = rng.integers(0, g.n, 64)
        oracle64 = weighted_oracle(g, src64)
        for completion in ("walks", "spmv"):
            wg = ForaWholeGraph(wds, ALPHA, seed=7, completion=completion)
            wg.compute_whole_graph_batch(src64, EPS)           # untimed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = wg.compute_whole_graph_batch(src64, EPS)
            dt = time.perf_counter() - t0
            err = float(np.mean([max_abs_err(scores[i], oracle64[i])
                                 for i in range(64)]))
            print(f"[weighted:fora] ForaWholeGraph(completion='"
                  f"{completion}') B 64 eps {EPS}: {wg.last_rounds} push "
                  f"rounds; {dt * 1e3:.1f} ms a batch; mean max-err "
                  f"{err:.3e}")
            check(err < 0.03, f"[weighted:fora] whole-graph {completion}: "
                  f"mean max-err {err}")

        # --- [weighted:walks] -----------------------------------------------
        w = 1 << 22
        starts = torch.as_tensor(rng.integers(0, g.n, w), dtype=torch.int32,
                                 device=dev)
        rows = torch.zeros(w, dtype=torch.int64, device=dev)
        weights = torch.full((w,), 1.0 / w, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        times = []
        for i in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counts = weighted_walk_counts(g, starts, rows, weights, gen,
                                          ALPHA, 1)
            torch.cuda.synchronize()
            if i:
                times.append(time.perf_counter() - t0)
            total = float(counts.double().sum())
            check(abs(total - 1.0) <= 1e-6 and not counts[:, g.n:].any(),
                  f"[weighted:walks] mass {total} is not 1")
        rate = w / float(np.median(times))
        print(f"[weighted:walks] weighted_walk_counts on the weighted bench "
              f"graph (alias step), {w} walkers: {rate:.4g} walks/s (median "
              f"of 3; ms of each call "
              f"{', '.join(f'{t * 1e3:.2f}' for t in times)}), against "
              f"{unweighted_walk_rate:.4g} on the bench graph ([walk]); mass "
              f"1 within 1e-6 in every call")
        src4 = rng.integers(0, g.n, 4)
        oracle4 = weighted_oracle(g, src4)
        mc = MonteCarlo(wds, ALPHA, seed=1)
        omega = mc_num_walks(EPS, mc.delta, mc.pfail)
        mc.compute_whole_graph_batch(src4[:1], EPS)           # untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = mc.compute_whole_graph_batch(src4, EPS)
        dt = time.perf_counter() - t0
        err = float(np.mean([max_abs_err(scores[i], oracle4[i])
                             for i in range(4)]))
        mass = scores.astype(np.float64).sum(axis=1)
        print(f"[weighted:walks] Monte-Carlo, 4 sources, eps {EPS}: {omega} "
              f"walks a source; {dt * 1e3 / 4:.1f} ms a query "
              f"({4 * omega / dt:.4g} walks/s); mean max-err {err:.4f} "
              f"against the weighted oracle; row mass "
              f"{mass.min():.9f}..{mass.max():.9f}")
        check(err < 0.05, f"[weighted:walks] mean max-err {err} >= 0.05")
        check(np.abs(mass - 1.0).max() <= 1e-6,
              f"[weighted:walks] row mass {mass}")

        # --- [protocol:weighted] --------------------------------------------
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "wgrqc.txt")
            write_weighted_edges(path)
            ds_p = load_edge_list(path, weighted=True, device=dev)
        check(ds_p.graph.weighted and not ds_p.graph.has_dense,
              "[protocol:weighted] the graph is not weighted and sparse")
        work = os.path.abspath(os.path.join(PROTOCOL_DIR, "weighted"))
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        k3_before = read_launches()["k3_coef"]
        cwd = os.getcwd()
        t0 = time.perf_counter()
        try:
            os.chdir(work)
            with open(os.path.join(work, "cli.log"), "w") as f, \
                    contextlib.redirect_stdout(f):
                PerfHarness(ds_p, alpha=ALPHA, seed=0, out_dir=work) \
                    .algo_perf_batch_test(
                        50, K, sweep="grqc", tests=(1, 2),
                        algos={"FWDPUSH", "NEO4J_METHOD", "FORA_TOPK"})
        finally:
            os.chdir(cwd)
        wall = time.perf_counter() - t0
        rows = read_protocol_file(
            os.path.join(work, "wgrqc_AlgoPerfResults.txt"))
        print(f"[protocol:weighted] {ds_p.name}: {ds_p.graph.n} nodes, "
              f"{ds_p.graph.m} weighted edges (load_edge_list(weighted="
              f"True)), PerfHarness Tests 1-2, FWDPUSH, NEO4J_METHOD, "
              f"FORA_TOPK, 50 queries: wall {wall:.1f} s; K3 coefficient-"
              f"mode launches {read_launches()['k3_coef'] - k3_before}")
        check_protocol_rows("weighted", rows, jax_rows=WEIGHTED_JAX_ROWS)
    counts = read_launches()
    print(f"[weighted] weighted path launches: K3 coefficient mode "
          f"{counts['k3_coef']} of K3's {counts['k3']}, K1 {counts['k1']}, "
          f"K2 {counts['k2']}, K0 {counts['k0']}; calls of K3's plain "
          f"version {plain_calls[0]}")
    check(counts["k3_coef"] > 0, "the weighted path did not launch K3's "
          "coefficient mode")
    check_sweep_passes("weighted", counts)
    check(counts["k3"] == counts["k3_coef"],
          "the weighted path launched K3's unweighted mode")
    check(plain_calls[0] == 0, "the weighted path ran K3's plain version "
          "on the card")
    check(counts["k1"] > 0, "the weighted oracle did not launch K1")
    check(counts["k0"] == 1, f"K0 ran {counts['k0']} times, not once")
    return counts


def neostore_path(dev) -> dict[str, int]:
    """``[neostore]``: the CLI on a Neo4j store written to a temporary
    directory (the ``synth:107x3@7`` edges with names, beside edges of a
    second type), against the same command on ``--db synth:107x3@7``;
    ``--rel NOPE`` must raise. Returns the path's launch counts."""
    import io
    import tempfile

    import importlib.util

    from ppr_tpu_torch import cli

    # the store writer lives with the reader's tests; loaded by path, so no
    # installed package named "tests" can stand in for the repository's
    spec = importlib.util.spec_from_file_location(
        "test_torch_neostore", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tests", "test_torch_neostore.py"))
    writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(writer)

    reset_launches()
    args = ["--sweep", "got", "--query", "50", "--k", str(K), "--tests",
            "1,2", "--algos", "NEO4J_METHOD,FORA_TOPK"]
    with tempfile.TemporaryDirectory() as tmp:
        db = os.path.join(tmp, "synth.db")
        t0 = time.perf_counter()
        writer.write_synth_store(db)
        write_s = time.perf_counter() - t0
        store_rows, wall, _ = run_protocol("neostore", ["--db", db, *args])
        raised = None
        try:
            with contextlib.redirect_stdout(io.StringIO()):
                cli.main(["--db", db, "--rel", "NOPE", "--device", "cuda"])
        except ValueError as e:
            raised = str(e)
    synth_rows, synth_wall, _ = run_protocol("neostore_synth",
                                             ["--db", "synth:107x3@7", *args])
    print(f"[neostore] a Neo4j 3.5 store of synth:107x3@7 (107 nodes, 352 "
          f"Relation edges, 20 KNOWS edges) written in {write_s:.2f} s; "
          f"--db <store> --sweep got, NEO4J_METHOD and FORA_TOPK, Tests 1-2: "
          f"wall {wall:.1f} s (--db synth:107x3@7: {synth_wall:.1f} s); "
          f"--rel NOPE raised: {raised!r}")
    check(raised is not None and "NOPE" in raised,
          "[neostore] --rel NOPE did not raise")
    def names(rows):
        return [(r.test, r.algo, r.param) for r in rows]

    check(names(store_rows) == names(synth_rows),
          f"[neostore] rows {names(store_rows)} vs {names(synth_rows)}")
    for got, want in zip(store_rows, synth_rows):
        # Test 1's max-err must be equal; the time columns may differ
        print(f"[neostore] {got.summary()} (synth:107x3@7: "
              f"{want.accuracy:.6g})")
        check(got.test != 1 or got.accuracy == want.accuracy,
              f"[neostore] {got.fields} vs {want.fields}")
    check_protocol_rows("neostore", store_rows)
    counts = read_launches()
    print(f"[neostore] store path launches: K2 {counts['k2']}, K1 "
          f"{counts['k1']}, K3 {counts['k3']}, K0 {counts['k0']}")
    check(counts["k2"] > 0, "the store's Neo4j method did not launch K2")
    check(counts["k0"] == 1, f"K0 ran {counts['k0']} times, not once")
    check_sweep_passes("neostore", counts)
    return counts


def topk_rows_differ(vals, ids, ref_vals, ref_ids, tol=1e-6) -> tuple:
    """Rows whose tie-expanded top-10 (values within ``tol`` of the 10th
    tied) differ from the reference's: ``(beyond, boundary)``, where a
    ``boundary`` row differs only by nodes whose reference value lies
    within ``4 * tol`` of the reference's 10th value (a tie at the edge of
    the window, which a different order of additions may tip), and a
    ``beyond`` row by more."""
    from ppr_tpu_torch.ops.topk import topk_ids_with_ties_from_pairs

    beyond = boundary = 0
    for i in range(len(ids)):
        a = set(topk_ids_with_ties_from_pairs(vals[i], ids[i], K,
                                              tol=tol).tolist())
        b = set(topk_ids_with_ties_from_pairs(ref_vals[i], ref_ids[i], K,
                                              tol=tol).tolist())
        if a == b:
            continue
        ref = dict(zip(ref_ids[i].tolist(), ref_vals[i].tolist()))
        pos = np.sort(ref_vals[i][ref_vals[i] > 0])[::-1]
        kth = pos[K - 1] if len(pos) >= K else 0.0
        if all(abs(ref.get(x, 0.0) - kth) <= 4 * tol for x in a ^ b):
            boundary += 1
        else:
            beyond += 1
    return beyond, boundary


def mesh_path(dev, ds, wds, sources, oracle) -> tuple[dict, dict]:
    """The mesh engines on one card through repeated-device meshes, at the
    bench graph's full width (B 2048, k 10, eps 0.5): ``[mesh:edge]`` at
    1x1 and 2x2, ``[mesh:node]`` at 1x4 (f32 ring, bf16 ring, frontier
    compaction at full and at low capacity), ``[mesh:whole-graph]`` (node
    1x4, B 64), ``[mesh:weighted]`` (edge 2x2 on the weighted bench graph,
    K3's coefficient mode), ``[serving:mesh]`` (``PPRBatchServer`` over
    ``PPRService(mesh=..., mesh_engine="node")``) and ``[mesh:dryrun]``.
    Each engine is held to the single-device ``ForaTopk`` with
    ``push="none"`` and no hub split (the same f32 operator), and to the
    oracle. Returns the launch counts of the mesh engines' calls alone and
    K3's checks at the mesh shards' shapes (``[mesh:k3]``, made after the
    counts are read)."""
    import torch

    from ppr_tpu_torch.models.fora import ForaTopk
    from ppr_tpu_torch.ops.topk import (topk_ids_with_ties,
                                        topk_ids_with_ties_from_pairs)
    from ppr_tpu_torch.parallel.dryrun import dryrun_multichip
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.node_sharded import gather_nodes, node_shards
    from ppr_tpu_torch.parallel.node_sharded_fora import (
        NodeShardedForaTopk, NodeShardedForaWholeGraph)
    from ppr_tpu_torch.parallel.node_sharded_allpair import reverse_shards
    from ppr_tpu_torch.parallel.sharded import edge_chunks, edge_chunks_bysrc
    from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk
    from ppr_tpu_torch.serving import PPRBatchServer
    from ppr_tpu_torch.service import PPRService

    def mesh(d, g):
        return make_mesh(d * g, data=d, graph=g, devices=[dev] * (d * g))

    n_acc = len(oracle)
    tol = EPS / ds.n
    b = len(sources)

    def run(eng, calls=1, srcs=sources):
        out = None
        for _ in range(calls):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = eng.compute_topk_ids_batch(srcs, K, EPS)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        sweeps = eng.last_iters
        peak = torch.cuda.max_memory_allocated() / 1e9
        row = {"ms": dt * 1e3, "qps": len(srcs) / dt, "sweeps": sweeps,
               "ms_per_sweep": dt * 1e3 / sweeps, "peak_gb": peak}
        return out, row

    # --- [mesh:ref]: the single-device references, before the window ----
    single = ForaTopk(ds, ALPHA, K, seed=7, push="none")
    check(single.hub_split is None, "[mesh] the reference has a hub split")
    run(single)                                         # warm-up
    (sv, si), ref = run(single)
    prec_ref = precision(oracle, tie_tolerant_ids(sv, si, n_acc, tol))
    print(f"[mesh:ref] single-device ForaTopk(push='none'), no hub split, "
          f"B={b}: {ref['ms']:.1f} ms = {ref['qps']:.1f} qps, sweeps "
          f"{ref['sweeps']} ({ref['ms_per_sweep']:.2f} ms/sweep), peak "
          f"{ref['peak_gb']:.2f} GB, precision@10 {prec_ref:.4f}")
    check(prec_ref >= 0.99, f"[mesh:ref] precision@10 {prec_ref} < 0.99")
    rows = {"single": ref}
    del single
    wsingle = ForaTopk(wds, ALPHA, K, seed=7, push="none")
    (wv, wi), wref = run(wsingle)
    del wsingle

    # The mesh path's launch window: from here to ``read_launches`` below
    # only mesh engines run, each call through ``counted``, which holds its
    # K3 launches to a floor of sweeps x K3 launches a sweep.
    m14 = mesh(1, 4)
    ring_blocks = sum(bl.src is not None
                      for sh in node_shards(ds.graph, m14)[0]
                      for bl in sh.blocks)

    def chunk_count(g, m):
        return sum(ch.src.numel() > 0 for row in edge_chunks(g, m)
                   for ch in row)

    tally = {"k3": 0, "k3_coef": 0}

    def counted(tag, per_sweep, eng, fn, *args, calls=1):
        """``fn(*args)``, with the K3 launches it made (both modes) added
        to the window's tally and held to ``calls * eng.last_iters *
        per_sweep``: one launch a non-empty edge chunk or ring block and
        sweep."""
        before = read_launches()
        out = fn(*args)
        after = read_launches()
        got = {m: after[m] - before[m] for m in tally}
        for m in tally:
            tally[m] += got[m]
        floor = calls * eng.last_iters * per_sweep
        print(f"[{tag}] K3 launches {got['k3']} (coefficient mode "
              f"{got['k3_coef']}), at least {floor} = {calls} call(s) x "
              f"{eng.last_iters} sweeps x {per_sweep} a sweep")
        check(got["k3"] >= floor, f"[{tag}] {got['k3']} K3 launches, fewer "
              f"than {floor}")
        return out

    reset_launches()

    def hold(tag, out, row, *, exact=False):
        v, i = out
        beyond, boundary = topk_rows_differ(v, i, sv, si)
        prec = precision(oracle, tie_tolerant_ids(v, i, n_acc, tol))
        row.update(precision=prec, rows_beyond=beyond,
                   rows_boundary=boundary)
        print(f"[{tag}] B={b}: {row['ms']:.1f} ms = {row['qps']:.1f} qps, "
              f"sweeps {row['sweeps']} (single-device {ref['sweeps']}, "
              f"difference {row['sweeps'] - ref['sweeps']}), "
              f"{row['ms_per_sweep']:.2f} ms/sweep, peak {row['peak_gb']:.2f}"
              f" GB; tie-expanded top-10 sets (tol 1e-6) differ from the "
              f"single-device engine's on {beyond} rows beyond a boundary "
              f"tie, {boundary} at one; precision@10 {prec:.4f}")
        check(beyond + boundary == 0, f"[{tag}] {beyond + boundary} rows' "
              "tie-expanded top-10 differ from the single-device engine's")
        check(prec >= 0.99, f"[{tag}] precision@10 {prec} < 0.99")
        if exact:
            check(np.array_equal(v, sv), f"[{tag}] values differ from the "
                  "single-device engine's")
        return row

    # --- [mesh:edge] ------------------------------------------------------
    for shape, calls in (((1, 1), 1), ((2, 2), 2)):
        eng = ShardedForaTopk(ds, ALPHA, K, mesh=mesh(*shape))
        tag = f"mesh:edge {shape[0]}x{shape[1]}"
        per = chunk_count(ds.graph, eng.mesh)
        out, row = counted(tag, per, eng, run, eng, calls, calls=calls)
        rows[f"edge{shape[0]}x{shape[1]}"] = hold(tag, out, row,
                                                 exact=shape == (1, 1))
        if shape == (1, 1):
            print(f"[{tag}] values equal to the single-device engine's bit "
                  "for bit")
        check(row["sweeps"] == ref["sweeps"], f"[{tag}] sweeps "
              f"{row['sweeps']} != {ref['sweeps']}")
        if shape == (2, 2):
            counted(tag, per, eng, profile_batch, eng, sources,
                    "mesh:profile edge 2x2", "mesh_edge_trace.json")
        del eng

    # --- [mesh:node] ------------------------------------------------------
    node = NodeShardedForaTopk(ds, ALPHA, K, mesh=m14)
    out, row = counted("mesh:node 1x4 f32", ring_blocks, node, run, node, 2,
                       calls=2)
    rows["node1x4"] = hold("mesh:node 1x4 f32", out, row)
    check(row["sweeps"] == ref["sweeps"], "[mesh:node] sweep count")
    counted("mesh:node 1x4 f32", ring_blocks, node, profile_batch, node,
            sources, "mesh:profile node 1x4", "mesh_node_trace.json")
    src_pad, _ = node._pad_batch(sources)
    _, _, p_local, _ = counted("mesh:node 1x4 f32", ring_blocks, node,
                               node._run, src_pad, K, 4 * K, EPS * 0.5)
    shapes = {tuple(x.shape) for r_ in p_local for x in r_}
    want_shape = node.final_state_shard_shape(b)
    print(f"[mesh:node] per-shard reserve {sorted(shapes)} (node-major "
          f"[n_pad/4, B]), final_state_shard_shape {want_shape}; the whole "
          f"state would be [{ds.graph.n_pad}, {b}]")
    check(shapes == {want_shape}, "[mesh:node] state is not O(n/S)")
    dense = gather_nodes(p_local).T.numpy()[:b]
    del p_local
    dv, di = (x.numpy() for x in torch.topk(torch.from_numpy(dense), 4 * K,
                                            dim=1))

    def within_bars(tag, out, row, rtol, atol):
        """Hold a run to the dense f32 ring within ``rtol`` and ``atol``
        (the bars of ``tests/test_ring_bf16.py`` and
        ``tests/test_frontier_ring.py``): each row's top-10 values, and
        its ids among the dense ring's top-10 with every node within the
        bar of the 10th value counted as tied."""
        v, i = out
        worst = 0.0
        for r_ in range(b):
            want = dv[r_][:K]
            sup = min(K, int((want > 0).sum()), int((v[r_] > 0).sum()))
            bar = atol + rtol * float(want[sup - 1]) if sup else atol
            ok = set(i[r_][:sup].tolist()) <= set(
                topk_ids_with_ties_from_pairs(dv[r_], di[r_], K,
                                              tol=bar).tolist())
            err = np.abs(np.sort(v[r_][:sup])[::-1] - want[:sup])
            check(ok and bool((err <= atol + rtol * want[:sup]).all()),
                  f"[{tag}] row {r_} outside the bars of the dense ring")
            worst = max(worst, float(err.max()) if sup else 0.0)
        beyond, boundary = topk_rows_differ(v, i, sv, si)
        prec = precision(oracle, tie_tolerant_ids(v, i, n_acc, tol))
        row.update(precision=prec, max_err_vs_dense=worst,
                   rows_beyond=beyond, rows_boundary=boundary)
        print(f"[{tag}] B={b}: {row['ms']:.1f} ms = {row['qps']:.1f} qps, "
              f"sweeps {row['sweeps']} (dense ring {rows['node1x4']['sweeps']}"
              f"), {row['ms_per_sweep']:.2f} ms/sweep, peak "
              f"{row['peak_gb']:.2f} GB; every row within rtol {rtol} atol "
              f"{atol} of the dense ring (largest difference {worst:.3e}); "
              f"top-10 sets at tol 1e-6 differ from the single-device "
              f"engine's on {beyond} rows beyond a boundary tie, {boundary} "
              f"at one; precision@10 {prec:.4f}")
        check(prec >= 0.99, f"[{tag}] precision@10 {prec} < 0.99")
        return row

    for label, opts in (("bf16 ring", {"ring_dtype": "bf16"}),
                        ("frontier 64/64", {"frontier_blocks": 64}),
                        ("frontier 16/64", {"frontier_blocks": 16})):
        eng = NodeShardedForaTopk(ds, ALPHA, K, mesh=m14, **opts)
        tag = f"mesh:node 1x4 {label}"
        out, row = counted(tag, ring_blocks, eng, run, eng)
        if label == "frontier 64/64":
            full = counted(tag, ring_blocks, eng, eng.compute_topk_batch,
                           sources, K, EPS)
            check(np.array_equal(full, dense), f"[{tag}] differs from the "
                  "dense ring")
            print(f"[{tag}] the reserve equals the dense ring's bit for bit")
            rows["frontier_full"] = hold(tag, out, row)
            del full
        elif label == "bf16 ring":
            rows["bf16"] = within_bars(tag, out, row, 5e-3, 5e-4)
        else:
            rows["frontier_low"] = within_bars(tag, out, row, 5e-2, 5e-3)
        del eng
    del dense

    # --- [mesh:whole-graph] -----------------------------------------------
    wg_rows = {}
    for completion in ("spmv", "walks"):
        eng = NodeShardedForaWholeGraph(ds, ALPHA, mesh=m14,
                                        completion=completion, seed=3,
                                        max_walkers_per_device=1 << 24)
        tag = f"mesh:whole-graph {completion}"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = counted(tag, ring_blocks, eng, eng.compute_whole_graph_batch,
                      sources[:64], EPS)
        dt = time.perf_counter() - t0
        mass = out.astype(np.float64).sum(axis=1)
        bar = EPS / ds.n if completion == "spmv" else 1e-3
        diff = np.abs(out[:n_acc].astype(np.float64) - oracle[:n_acc])
        err = float(diff.max())
        mean_err = float(diff.max(axis=1).mean())
        l1 = float(diff.sum(axis=1).max())
        # the walks carry the residue the ring sweeps left, (1-alpha)^sweeps
        # of each row; a deposit on the wrong nodes is off by twice that
        walk_mass = (1.0 - ALPHA) ** eng.last_iters
        print(f"[{tag}] node 1x4 B=64: {dt:.2f} s, ring sweeps "
              f"{eng.last_iters}; row mass {mass.min():.7f}..{mass.max():.7f}"
              f" (bar 1 +- {bar:.3e}); against the oracle over {n_acc} rows: "
              f"max abs err {err:.3e}, mean of the rows' max {mean_err:.3e},"
              f" largest row L1 {l1:.3e}")
        check(bool((np.abs(mass - 1.0) <= bar).all()),
              f"[{tag}] row mass off by more than {bar}")
        if completion == "spmv":
            # the ring stops with at most eps/n of a row's mass left as
            # residue: no score is further than that from the oracle, and
            # a row's L1 distance is that mass plus rounding (another eps/n)
            check(err <= EPS / ds.n and l1 <= 2 * EPS / ds.n,
                  f"[{tag}] max abs err {err}, row L1 {l1}: more than "
                  "the residue left")
        else:
            # [fora:walks]'s bar for the single-device walk completion, and
            # a row L1 below the mass the walks carry
            check(mean_err < 0.03, f"[{tag}] mean max-err {mean_err}")
            check(l1 < walk_mass, f"[{tag}] row L1 {l1} >= the walks' mass "
                  f"{walk_mass}")
        wg_rows[completion] = {"s": dt, "sweeps": eng.last_iters,
                               "max_err": err, "mean_max_err": mean_err,
                               "l1": l1}
        del eng, out
    rows["whole_graph"] = wg_rows

    # --- [mesh:weighted] --------------------------------------------------
    weng = ShardedForaTopk(wds, ALPHA, K, mesh=mesh(2, 2))
    coef_before = tally["k3_coef"]
    (v, i), row = counted("mesh:weighted", chunk_count(wds.graph, weng.mesh),
                          weng, run, weng)
    coef_launched = tally["k3_coef"] - coef_before
    beyond, boundary = topk_rows_differ(v, i, wv, wi)
    woracle = weighted_oracle(wds.graph, sources[:n_acc])
    prec = precision(woracle, tie_tolerant_ids(v, i, n_acc, EPS / wds.n))
    row.update(precision=prec, rows_beyond=beyond, rows_boundary=boundary,
               k3_coef_launches=coef_launched, single=wref)
    print(f"[mesh:weighted] edge 2x2 on synthetic_weighted(65536, 16, "
          f"seed=42) B={b}: {row['ms']:.1f} ms = {row['qps']:.1f} qps, sweeps "
          f"{row['sweeps']} (single-device {wref['sweeps']}), "
          f"{row['ms_per_sweep']:.2f} ms/sweep, peak {row['peak_gb']:.2f} GB;"
          f" K3 coefficient-mode launches {coef_launched}; tie-expanded "
          f"top-10 sets (tol 1e-6) differ from the single-device engine's on "
          f"{beyond} rows beyond a boundary tie, {boundary} at one; "
          f"precision@10 {prec:.4f} against the float64 weighted oracle")
    check(coef_launched >= row["sweeps"] * chunk_count(wds.graph, weng.mesh),
          "[mesh:weighted] K3's coefficient mode did not carry the sweeps")
    check(beyond + boundary == 0 and row["sweeps"] == wref["sweeps"],
          "[mesh:weighted] differs from the single-device engine")
    check(prec >= 0.99, f"[mesh:weighted] precision@10 {prec} < 0.99")
    rows["weighted"] = row
    del weng

    # --- [serving:mesh] ---------------------------------------------------
    svc = PPRService.from_dataset(ds, alpha=ALPHA, eps=EPS, k=K, seed=7,
                                  mesh=m14, mesh_engine="node")
    check(isinstance(svc._topk_algo, NodeShardedForaTopk),
          "[serving:mesh] the service has no node engine")
    burst = sources[:512]

    def serve():
        with PPRBatchServer(svc, max_batch=512) as server:
            t0 = time.perf_counter()
            served = serve_burst(server, burst)
            return served, time.perf_counter() - t0, server.stats

    served, dt, stats = counted("serving:mesh", ring_blocks, svc._topk_algo,
                                serve)
    out_deg = ds.graph.out_deg.cpu().numpy()
    check(len(served) == len(burst) and all(
        len(h) >= K or out_deg[s] == 0 for h, s in zip(served, burst)),
        "[serving:mesh] short hit lists")
    precs = []
    for j in range(n_acc):
        o = oracle[j]
        gnd = topk_ids_with_ties(o, K)
        got = np.array([h.node for h in served[j]], np.int64)
        precs.append(min(int((o[got] >= o[gnd].min() - tol).sum()),
                         len(gnd)) / len(gnd))
    prec = float(np.mean(precs))
    print(f"[serving:mesh] PPRBatchServer(max_batch=512) over "
          f"PPRService(mesh=1x4 on {dev}, mesh_engine='node'): a burst of "
          f"{len(burst)} requests in {dt:.2f} s ({len(burst) / dt:.1f} qps), "
          f"{stats.dispatches} dispatches, every hit list full; "
          f"precision@10 of the {n_acc} oracle sources {prec:.4f}")
    check(prec >= 0.99, f"[serving:mesh] precision@10 {prec} < 0.99")
    rows["serving"] = {"s": dt, "qps": len(burst) / dt,
                       "dispatches": stats.dispatches, "precision": prec}
    launches = read_launches()
    print(f"[mesh] launches on the mesh path (mesh engines only): {launches}"
          f"; the engines' own counts add to K3 {tally['k3']}, coefficient "
          f"mode {tally['k3_coef']}")
    check(launches["k3"] == tally["k3"]
          and launches["k3_coef"] == tally["k3_coef"],
          "[mesh] K3 launched outside the mesh engines' calls")
    check_sweep_passes("mesh", launches)
    check(launches["k3"] > 0 and launches["k3_coef"] > 0,
          "[mesh] K3 was not launched in both modes on the mesh path")
    check(launches["k0"] == 1, "[mesh] K0 did not run once on the mesh path")
    del svc, node

    # --- [mesh:dryrun], after the window: it runs a single-device engine --
    t0 = time.perf_counter()
    before = read_launches()["k3"]
    dry = dryrun_multichip(4, devices=[dev] * 4)
    print(f"[mesh:dryrun] dryrun_multichip(4, devices=[{dev}] * 4) passed in "
          f"{time.perf_counter() - t0:.2f} s ({read_launches()['k3'] - before}"
          f" K3 launches, outside the mesh path's count): {dry}")

    # --- [mesh:k3]: K3 against its plain version at the shards' shapes ----
    ch = edge_chunks(ds.graph, mesh(2, 2))[0][0]
    wch = edge_chunks(wds.graph, mesh(2, 2))[0][0]
    ring = node_shards(ds.graph, m14)[0][0]
    blk = max((bl for bl in ring.blocks if bl.src is not None),
              key=lambda bl: bl.src.shape[0])
    # the all-pair engines' shapes (the protocol path's BASE sweeps): K3 by
    # source, on a 2x2 chunk of the source-sorted edges at T/data and on
    # the largest 1x4 reverse ring block at T
    rch = edge_chunks_bysrc(ds.graph, mesh(2, 2))[0][0]
    rblk = max((bl for sh in reverse_shards(ds.graph, m14)[0]
                for bl in sh.blocks if bl.src is not None),
               key=lambda bl: bl.src.shape[0])
    k3m = k3_cases(dev, [
        {"label": "edge 2x2 chunk", "n_rows": ds.graph.n_pad, "src": ch.src,
         "ptr": ch.ptr, "b": b // 2, "cold": True},
        {"label": "node 1x4 ring block", "n_rows": ds.graph.n_pad // 4,
         "src": blk.src, "ptr": blk.ptr, "b": b, "cold": True},
        {"label": "weighted edge 2x2 chunk", "n_rows": wds.graph.n_pad,
         "src": wch.src, "ptr": wch.ptr, "coef": wch.coef, "b": b // 2,
         "cold": True},
        {"label": "by-source edge 2x2 chunk", "n_rows": ds.graph.n_pad,
         "src": rch.src, "ptr": rch.ptr, "b": BASE_BATCH // 2,
         "cold": True},
        {"label": "reverse node 1x4 ring block",
         "n_rows": ds.graph.n_pad // 4, "src": rblk.src, "ptr": rblk.ptr,
         "b": BASE_BATCH, "cold": True},
    ], tag="mesh:k3")
    k3m["engines"] = rows
    return launches, k3m


def loop_sweeps(used: int) -> int:
    """Sweeps a push loop ran when its frontier was non-empty in the first
    ``used``: the host reads the flag every ``CHECK_EVERY`` sweeps and
    stops at the first read that finds it empty (the sweeps after the
    last non-empty one are exact no-ops that still launch K3)."""
    from ppr_tpu_torch.ops.push import CHECK_EVERY

    return (used // CHECK_EVERY + 1) * CHECK_EVERY


class HeldK3:
    """A context in which each call of a mesh engine's sweep loop, and of
    the sparse power method, reads the K3 launches it made and holds them
    to what its sweeps need: a push or a reverse sweep loop
    ``loop_sweeps(sweeps)``, propagation its sweeps rounded up to a host
    read, the Neo4j method its iterations, each times one launch an edge
    chunk or non-empty ring block; the power method one launch an
    iteration on a sparse graph. ``got`` and ``want`` add up the held
    calls, ``bad`` names each call whose counts differ; a call made inside
    a held call is not held again.

    ``single=True`` also holds the single-device loops and engines of the
    scale path: FORA's annealed loop and ``residual_propagate`` (their
    sweeps rounded up to a host read), the forward push
    (``loop_sweeps``), each one launch a sweep unless the graph's dense
    operator carries a push without a hub split; ``NodeShardedForaTopk``
    (its sweeps rounded up to a host read, times one launch a non-empty
    ring block of every data row); and ``ring_occupancy_torch``'s
    coverage loop (one launch a sweep).

    ``protocol=True`` also holds the single-device loops of the protocol
    CLI's Forward Push (``loop_sweeps``), BASE's reverse push
    (``loop_sweeps``) and the Neo4j method (its iterations), each one
    launch a sweep on a sparse graph.

    ``spanning=True`` (a rank of ``[dist:*]``) also holds the serving
    engines on a mesh across processes: ``ShardedForaTopk._run`` and
    ``NodeShardedForaTopk._run`` (their sweeps rounded up to a host read)
    and ``NodeShardedForaWholeGraph.compute_whole_graph_batch`` (its ring
    sweeps), each times one launch a non-empty chunk or ring block of this
    rank's positions; the walks launch none. Every count is this rank's."""

    def __init__(self, single: bool = False, spanning: bool = False,
                 protocol: bool = False):
        self.calls = self.got = self.want = 0
        self.bad: list[str] = []
        self._undo = []
        self._depth = 0
        self.single = single
        self.spanning = spanning
        self.protocol = protocol

    def __enter__(self):
        from ppr_tpu_torch.models import power_method
        from ppr_tpu_torch.ops.push import CHECK_EVERY
        from ppr_tpu_torch.parallel.mesh import is_remote
        from ppr_tpu_torch.parallel.mesh_algos import _EdgeShardedKernels
        from ppr_tpu_torch.parallel.node_sharded_allpair import \
            NodeShardedBackwardSearch
        from ppr_tpu_torch.parallel.sharded_allpair import \
            ShardedBackwardSearch

        def chunks(parts):
            # this rank's chunks: on a mesh across processes each rank
            # launches K3 for its own positions only
            return sum(not is_remote(ch) for row in parts for ch in row)

        def blocks(shards):
            return local_ring_blocks(shards)

        def power_iters(a, kw):
            return int(a[3] if len(a) > 3 else kw.get("iterations", 100))

        for owner, name, want in (
                (_EdgeShardedKernels, "push", lambda a, kw, res:
                 loop_sweeps(res[2]) * chunks(a[0].chunks)),
                (_EdgeShardedKernels, "propagate", lambda a, kw, res:
                 -(-res[2] // CHECK_EVERY) * CHECK_EVERY
                 * chunks(a[0].chunks)),
                (_EdgeShardedKernels, "power_iterations", lambda a, kw, res:
                 int(a[3]) * chunks(a[0].chunks)),
                (ShardedBackwardSearch, "whole_graph_device",
                 lambda a, kw, res: loop_sweeps(a[0].last_sweeps)
                 * chunks(a[0]._chunks)),
                (NodeShardedBackwardSearch, "whole_graph_shards",
                 lambda a, kw, res: loop_sweeps(a[0].last_sweeps)
                 * blocks(a[0]._shards)),
                (power_method, "power_method_batch", lambda a, kw, res:
                 0 if a[0].has_dense else power_iters(a, kw))):
            self._patch(owner, name, want)
        if self.single:
            self._patch_single()
        if self.spanning:
            self._patch_spanning()
        if self.protocol:
            self._patch_protocol()
        return self

    def _patch_protocol(self):
        from ppr_tpu_torch.models import (backward_search, forward_push,
                                          neo4j_method)

        def per_sweep(g):
            return 0 if g.has_dense else 1

        for owner, name, want in (
                (forward_push, "forward_push_sweeps", lambda a, kw, res:
                 min(loop_sweeps(res[2]), kw.get("max_sweeps", 10_000))
                 * per_sweep(a[0])),
                (backward_search, "backward_push_sweeps", lambda a, kw, res:
                 min(loop_sweeps(res[2]), kw.get("max_sweeps", 10_000))
                 * per_sweep(a[0])),
                (neo4j_method, "personalized_pagerank_batch",
                 lambda a, kw, res: int(a[3] if len(a) > 3
                                        else kw["iterations"])
                 * per_sweep(a[0]))):
            self._patch(owner, name, want)

    def _patch_spanning(self):
        from ppr_tpu_torch.models import fora
        from ppr_tpu_torch.parallel.mesh import is_remote
        from ppr_tpu_torch.parallel.node_sharded_fora import (
            NodeShardedForaTopk, NodeShardedForaWholeGraph)
        from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

        def read_rounds(n):
            return -(-int(n) // fora.CHECK_EVERY) * fora.CHECK_EVERY

        def chunks(eng):
            return sum(not is_remote(ch) and ch.src.numel() > 0
                       for row in eng._chunks for ch in row)

        for owner, name, want in (
                (ShardedForaTopk, "_run", lambda a, kw, res:
                 read_rounds(res[3]) * chunks(a[0])),
                (NodeShardedForaTopk, "_run", lambda a, kw, res:
                 read_rounds(res[3])
                 * local_ring_blocks(a[0]._program(a[2], a[3])[1])),
                (NodeShardedForaWholeGraph, "compute_whole_graph_batch",
                 lambda a, kw, res: a[0].last_iters * local_ring_blocks(
                     node_shards_of(a[0])))):
            self._patch(owner, name, want)

    def _patch_single(self):
        import ring_occupancy_torch
        from ppr_tpu_torch.models import fora
        from ppr_tpu_torch.parallel.node_sharded_fora import \
            NodeShardedForaTopk

        def read_rounds(n):
            return -(-int(n) // fora.CHECK_EVERY) * fora.CHECK_EVERY

        def per_sweep(g, hs):
            return 0 if hs is None and g.has_dense else 1

        def ring_blocks(eng, k, kcap):
            _, shards = eng._program(k, kcap)
            return sum(bl.src is not None for row in shards for sh in row
                       for bl in sh.blocks)

        for owner, name, want in (
                (fora, "annealed_topk_propagate", lambda a, kw, res:
                 min(read_rounds(res[2]), fora.MAX_TOPK_SWEEPS)
                 * per_sweep(a[0], kw.get("hs"))),
                (fora, "residual_propagate", lambda a, kw, res:
                 min(read_rounds(res[2]), kw.get("max_iters", 400))
                 * per_sweep(a[0], kw.get("hs"))),
                (fora, "forward_push_sweeps", lambda a, kw, res:
                 min(loop_sweeps(res[2]), kw.get("max_sweeps", 10_000))
                 * per_sweep(a[0], None)),
                (NodeShardedForaTopk, "_run", lambda a, kw, res:
                 read_rounds(res[3]) * ring_blocks(a[0], a[2], a[3])),
                (ring_occupancy_torch, "dense_coverage", lambda a, kw, res:
                 res[1]["sweeps"])):
            self._patch(owner, name, want)

    def _patch(self, owner, name, want):
        orig = getattr(owner, name)

        def held(*a, **kw):
            if self._depth:
                return orig(*a, **kw)
            self._depth += 1
            before = read_launches()["k3"]
            try:
                res = orig(*a, **kw)
            finally:
                self._depth -= 1
            got, w = read_launches()["k3"] - before, want(a, kw, res)
            self.calls += 1
            self.got += got
            self.want += w
            if got != w:
                self.bad.append(f"{owner.__name__}.{name}: {got} K3 "
                                f"launches, want {w}")
            return res

        setattr(owner, name, held)
        self._undo.append((owner, name, orig))

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def mark(self) -> tuple[int, int, int]:
        return self.calls, self.got, self.want

    def hold(self, tag: str, mark: tuple[int, int, int]) -> int:
        """Print and check the held calls since ``mark``; returns their K3
        launches."""
        calls, got, want = (x - y for x, y in zip(self.mark(), mark))
        print(f"[{tag}] K3 launches {got} in {calls} held calls, equal to "
              f"their sweeps x launches a sweep {want}: {got == want}")
        check(got == want and calls > 0,
              f"[{tag}] {got} K3 launches in {calls} calls, want {want}")
        return got


def local_ring_blocks(shards) -> int:
    """The non-empty ring blocks of this rank's positions."""
    from ppr_tpu_torch.parallel.mesh import is_remote

    return sum(bl.src is not None for row in shards for sh in row
               if not is_remote(sh) for bl in sh.blocks)


def node_shards_of(eng):
    """The ring shards a ``NodeShardedForaWholeGraph`` sweeps over, as its
    propagation builds them."""
    from ppr_tpu_torch.parallel.node_sharded import node_shards

    return node_shards(eng.graph, eng.mesh)


def on_card_within(got, want, atol=5e-6, rtol=1e-4) -> tuple[bool, float]:
    """``(every |got - want| <= atol + rtol |want|, the largest |got -
    want|)`` for two tensors on the card, compared there."""
    diff = (got - want).abs()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    return ok, float(diff.max())


def mesh_protocol_path(dev, ds, sources, oracle) -> dict:
    """The protocol on a mesh of this one card repeated, at the bench
    graph's full width: ``[mesh:prep]`` (the drop-ins of
    ``parallel/mesh_algos.py``, each held to the single-device engine on
    the same sources or to the oracle), ``[mesh:base]`` (both all-pair
    engines on a 512-target batch against ``BackwardSearch``, then the
    whole BASE all-pair preprocessing of the bench graph on the
    node-sharded engine, three stored rows read back against a direct
    single-device sweep), ``[protocol:mesh]`` (the CLI with ``--mesh 1x1
    --device cuda`` and ``PerfHarness(mesh=2x2)`` on the ca-GrQc stand-in,
    rows held to ``JAX_ROWS``), then, after the launch window,
    ``[mesh:scaling]`` and ``[mesh:comm]`` (one card: partition overhead,
    no link measured). Every K3 launch of the window is made in a call
    :class:`HeldK3` holds to its loop's sweeps times one launch a chunk or
    non-empty ring block.
    Returns the window's launch counts and what the path measured."""
    import io

    import torch

    from ppr_tpu_torch import cli
    from ppr_tpu_torch.harness import SWEEPS, PerfHarness
    from ppr_tpu_torch.models.backward_search import BackwardSearch
    from ppr_tpu_torch.models.config import AlgoType
    from ppr_tpu_torch.models.forward_push import ForwardPush
    from ppr_tpu_torch.models.neo4j_method import Neo4jMethod
    from ppr_tpu_torch.ops.push import backward_push_sweeps
    from ppr_tpu_torch.parallel import comm_model
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.mesh_algos import (MeshForaWholeGraph,
                                                   MeshForwardPush,
                                                   MeshMonteCarlo,
                                                   MeshNeo4jMethod)
    from ppr_tpu_torch.parallel.node_sharded_allpair import (
        NodeShardedBackwardSearch, node_sharded_base_allpair)
    from ppr_tpu_torch.parallel.scaling import (engine_scaling_sweep,
                                                scaling_sweep)
    from ppr_tpu_torch.parallel.sharded_allpair import ShardedBackwardSearch

    def mesh(d, g):
        return make_mesh(d * g, data=d, graph=g, devices=[dev] * (d * g))

    g = ds.graph
    m22, m14 = mesh(2, 2), mesh(1, 4)
    b = len(sources)
    n_acc = len(oracle)
    rmax = min(SWEEPS["got"]["whole_graph"][AlgoType.FWDPUSH])
    threshold, targets = 1e-3, np.arange(BASE_BATCH)
    walls, out = {}, {}

    def timed(fn, *args):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, \
            torch.cuda.max_memory_allocated() / 1e9

    # --- the single-device references, before the launch window ---------
    t_phase = time.perf_counter()
    fwp = ForwardPush(ds, ALPHA)
    ref_fwp, ref_fwp_s, ref_fwp_gb = timed(fwp.compute_whole_graph_device,
                                           sources, rmax)
    ref_fwp_sweeps = fwp.last_sweeps
    ref_neo, ref_neo_s, _ = timed(Neo4jMethod(ds, ALPHA)
                                  .compute_whole_graph_device, sources, 40)
    ref_bws = BackwardSearch(g, ALPHA, threshold)
    ref_base, ref_base_s, _ = timed(ref_bws.whole_graph_device, targets)
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(targets, device=dev), g.n_pad).float()
    _, _, ref_base_sweeps = backward_push_sweeps(
        g, torch.zeros_like(onehot), onehot, threshold, ALPHA)
    del onehot
    # three rows of the all-pair store, computed directly: the column of
    # each source in every target batch of a single-device sweep
    probe = np.array([int(sources[0]), int(sources[1]), g.n - 1])
    t0 = time.perf_counter()
    cols = [ref_bws.whole_graph_device(np.arange(lo, min(lo + BASE_BATCH,
                                                         g.n)))[:, probe]
            for lo in range(0, g.n, BASE_BATCH)]
    direct = torch.cat(cols).T.cpu().numpy()            # [3, n]
    direct_s = time.perf_counter() - t0
    print(f"[mesh:prep] single-device references on the bench graph: "
          f"ForwardPush B={b} rmax {rmax:g} {ref_fwp_s * 1e3:.1f} ms, "
          f"{ref_fwp_sweeps} sweeps, peak {ref_fwp_gb:.2f} GB; Neo4jMethod "
          f"B={b} 40 iterations {ref_neo_s * 1e3:.1f} ms; BackwardSearch "
          f"{BASE_BATCH} targets at {threshold:g} {ref_base_s * 1e3:.1f} ms, "
          f"{ref_base_sweeps} sweeps; the direct sweep for 3 store rows "
          f"{direct_s:.2f} s")
    walls["references"] = time.perf_counter() - t_phase

    # --- the launch window: only mesh engines and the protocol on a mesh -
    # every K3 launch in it is made by a call ``HeldK3`` holds
    reset_launches()
    with HeldK3() as held:
        # --- [mesh:prep] --------------------------------------------------
        t_phase = time.perf_counter()
        eng = MeshForwardPush(ds, ALPHA, mesh=m22)
        mark = held.mark()
        p, secs, gb = timed(eng.compute_whole_graph_device, sources, rmax)
        ok, err = on_card_within(p[:b], ref_fwp)
        print(f"[mesh:prep] MeshForwardPush 2x2 B={b} rmax {rmax:g}: "
              f"{secs * 1e3:.1f} ms, sweeps {eng.last_sweeps} (single-device "
              f"{ref_fwp_sweeps}), {secs * 1e3 / eng.last_sweeps:.2f} ms a "
              f"sweep, peak {gb:.2f} GB; largest difference from the "
              f"single-device engine {err:.3e} (bar atol 5e-6, rtol 1e-4)")
        check(ok and eng.last_sweeps == ref_fwp_sweeps,
              "[mesh:prep] MeshForwardPush differs from ForwardPush")
        got = held.hold("mesh:prep fwdpush", mark)
        out["fwdpush"] = {"ms": secs * 1e3, "sweeps": eng.last_sweeps,
                          "peak_gb": gb, "max_err": err, "k3": got,
                          "single_ms": ref_fwp_s * 1e3}
        del p, eng, ref_fwp

        eng = MeshNeo4jMethod(ds, ALPHA, mesh=m22)
        mark = held.mark()
        x, secs, gb = timed(eng.compute_whole_graph_device, sources, 40)
        ok, err = on_card_within(x[:b], ref_neo)
        print(f"[mesh:prep] MeshNeo4jMethod 2x2 B={b} 40 iterations: "
              f"{secs * 1e3:.1f} ms ({ref_neo_s * 1e3:.1f} single-device), "
              f"peak {gb:.2f} GB; largest difference {err:.3e}")
        check(ok, "[mesh:prep] MeshNeo4jMethod differs from Neo4jMethod")
        got = held.hold("mesh:prep neo4j", mark)
        out["neo4j"] = {"ms": secs * 1e3, "sweeps": 40, "peak_gb": gb,
                        "max_err": err, "k3": got,
                        "single_ms": ref_neo_s * 1e3}
        del x, eng, ref_neo

        wsrc = sources[:64]
        eng = MeshForaWholeGraph(ds, ALPHA, mesh=m22)
        mark = held.mark()
        wg, secs, gb = timed(eng.compute_whole_graph_batch, wsrc, EPS)
        diff = np.abs(wg[:n_acc].astype(np.float64) - oracle)
        err, l1 = float(diff.max()), float(diff.sum(axis=1).max())
        mass = wg.astype(np.float64).sum(axis=1)
        print(f"[mesh:prep] MeshForaWholeGraph 2x2 B=64 eps {EPS}: "
              f"{secs * 1e3:.1f} ms (first call: its untimed warm-up push "
              f"included), push rounds {eng.last_rounds}, propagation sweeps "
              f"{eng.last_iters}, peak {gb:.2f} GB; against the oracle over "
              f"{n_acc} rows: max abs err {err:.3e} (bar {EPS / ds.n:.3e}), "
              f"largest row L1 {l1:.3e} (bar {2 * EPS / ds.n:.3e}); row mass "
              f"{mass.min():.7f}..{mass.max():.7f}")
        check(err <= EPS / ds.n and l1 <= 2 * EPS / ds.n
              and bool((np.abs(mass - 1.0) <= EPS / ds.n).all()),
              "[mesh:prep] MeshForaWholeGraph outside the oracle's bars")
        got = held.hold("mesh:prep fora whole-graph", mark)
        out["fora_whole_graph"] = {"ms": secs * 1e3, "rounds": eng.last_rounds,
                                   "sweeps": eng.last_iters, "peak_gb": gb,
                                   "max_err": err, "l1": l1, "k3": got}
        del wg, eng

        eng = MeshMonteCarlo(ds, ALPHA, mesh=m22, seed=3)
        before = read_launches()["k3"]
        mc, secs, gb = timed(eng.compute_whole_graph_batch, wsrc, EPS)
        got = read_launches()["k3"] - before
        mass = mc.astype(np.float64).sum(axis=1)
        err = float(np.abs(mc[:n_acc] - oracle).max())
        print(f"[mesh:prep] MeshMonteCarlo 2x2 B=64 eps {EPS} ([mc:bench]'s): "
              f"{secs:.2f} s, peak {gb:.2f} GB; row mass {mass.min():.7f}.."
              f"{mass.max():.7f} (bar 1 +- 1e-3); largest deviation from the "
              f"oracle over {n_acc} rows {err:.3e} (bar 0.05); K3 launches "
              f"{got} (walks only)")
        check(bool((np.abs(mass - 1.0) <= 1e-3).all()) and err < 0.05
              and got == 0, "[mesh:prep] MeshMonteCarlo outside its bars")
        out["monte_carlo"] = {"s": secs, "peak_gb": gb, "max_err": err}
        del mc, eng
        walls["mesh:prep"] = time.perf_counter() - t_phase
        print(f"[mesh:prep] wall {walls['mesh:prep']:.1f} s")

        # --- [mesh:base] --------------------------------------------------
        t_phase = time.perf_counter()
        for label, cls, m in (("ShardedBackwardSearch 2x2",
                               ShardedBackwardSearch, m22),
                              ("NodeShardedBackwardSearch 1x4",
                               NodeShardedBackwardSearch, m14)):
            eng = cls(g, ALPHA, threshold, mesh=m)
            mark = held.mark()
            res, secs, gb = timed(eng.whole_graph_device, targets)
            ok, err = on_card_within(res[:BASE_BATCH], ref_base)
            print(f"[mesh:base] {label}, {BASE_BATCH} targets at "
                  f"{threshold:g}: {secs * 1e3:.1f} ms "
                  f"({ref_base_s * 1e3:.1f} single-device), sweeps "
                  f"{eng.last_sweeps} (single-device "
                  f"{ref_base_sweeps}), peak {gb:.2f} GB; largest difference "
                  f"{err:.3e}")
            check(ok and eng.last_sweeps == ref_base_sweeps,
                  f"[mesh:base] {label} differs from BackwardSearch")
            got = held.hold(f"mesh:base {label}", mark)
            out[label.split()[0]] = {"ms": secs * 1e3,
                                     "sweeps": eng.last_sweeps, "max_err": err,
                                     "k3": got}
            del res, eng
        del ref_base

        algo = node_sharded_base_allpair(ds, ALPHA, mesh=m14)
        algo.prep_dirname = os.path.abspath(os.path.join(
            PROTOCOL_DIR, "mesh_base", algo.prep_dirname))
        shutil.rmtree(algo.prep_dirname, ignore_errors=True)
        batches = -(-g.n // BASE_BATCH)
        mark = held.mark()
        _, secs, gb = timed(algo.preprocessing, threshold, -1)
        calls = held.calls - mark[0]
        worst, extra, bad = 0.0, 0, 0
        for i, s in enumerate(probe):
            ids, vals = algo._store.read_row_ordered(int(s))
            row = np.zeros(g.n, np.float32)
            row[ids] = vals
            want = np.where(direct[i] >= np.float32(threshold), direct[i], 0.0)
            both = (row > 0) & (want > 0)
            gap = np.abs(row[both] - want[both])
            worst = max(worst, float(gap.max()))
            bad += int((gap > 5e-6 + 1e-4 * want[both]).sum())
            # an entry on one side only must sit at the threshold
            only = (row > 0) != (want > 0)
            extra += int((np.abs(np.maximum(row, want)[only] - threshold)
                          > 1e-6).sum())
        print(f"[mesh:base] the whole BASE all-pair preprocessing of the "
              f"bench graph on NodeShardedBackwardSearch 1x4: {g.n} targets "
              f"in "
              f"{batches} batches of {BASE_BATCH} at threshold {threshold:g}: "
              f"{secs:.2f} s, store {algo.get_prep_size()} bytes, peak "
              f"{gb:.2f} GB; rows {probe.tolist()} read back against a direct "
              f"single-device sweep: largest difference {worst:.3e} ({bad} "
              f"outside atol 5e-6, rtol 1e-4), entries on one side only away "
              f"from the threshold {extra}")
        check(bad == 0 and extra == 0,
              "[mesh:base] stored rows differ from the direct sweep")
        got = held.hold("mesh:base all-pair", mark)
        check(calls == batches,
              f"[mesh:base] {calls} reverse sweeps held, want {batches}")
        out["allpair"] = {"s": secs, "batches": batches, "k3": got,
                          "bytes": algo.get_prep_size(), "max_err": worst}
        algo.delete_prep_dir()
        del algo
        walls["mesh:base"] = time.perf_counter() - t_phase
        print(f"[mesh:base] wall {walls['mesh:base']:.1f} s")

        # --- [protocol:mesh] ----------------------------------------------
        t_phase = time.perf_counter()
        mark = held.mark()
        rows, wall, _ = run_protocol("mesh_grqc_1x1", [
            "--db", "synth:grqc", "--query", "50", "--k", str(K),
            "--tests", "1,2", "--algos", "FWDPUSH,BASE_WHOLE_GRAPH",
            "--mesh", "1x1"])
        print(f"[protocol:mesh] python -m ppr_tpu_torch.cli --mesh 1x1 "
              f"--device cuda --db synth:grqc --algos "
              f"FWDPUSH,BASE_WHOLE_GRAPH --tests "
              f"1,2: wall {wall:.1f} s")
        check_protocol_rows("mesh", rows, jax_rows=JAX_ROWS["grqc"])
        work = os.path.abspath(os.path.join(PROTOCOL_DIR, "mesh_grqc_2x2"))
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        grqc = cli.load_dataset("synth:grqc", device=dev)
        harness = PerfHarness(grqc, seed=0, out_dir=work, progress=False,
                              mesh=m22)
        cwd = os.getcwd()
        t0 = time.perf_counter()
        try:
            os.chdir(work)
            with open(os.path.join(work, "harness.log"), "w") as f, \
                    contextlib.redirect_stdout(f):
                harness.algo_perf_batch_test(
                    50, K, tests=(1, 2), algos={"FWDPUSH", "BASE_WHOLE_GRAPH"})
        finally:
            os.chdir(cwd)
        wall2 = time.perf_counter() - t0
        print(f"[protocol:mesh] PerfHarness(mesh=2x2 of {dev} repeated), the "
              f"same Tests 1-2: wall {wall2:.1f} s")
        check_protocol_rows("mesh 2x2",
                            read_protocol_file(harness.writer.path),
                            jax_rows=JAX_ROWS["grqc"])
        # the mesh engines and the power-method oracle of both runs
        proto_k3 = held.hold("protocol:mesh", mark)
        out["protocol"] = {"cli_1x1_s": wall, "harness_2x2_s": wall2,
                           "k3": proto_k3}
        walls["protocol:mesh"] = time.perf_counter() - t_phase
        print(f"[protocol:mesh] wall {walls['protocol:mesh']:.1f} s")

    launches = read_launches()
    print(f"[mesh:protocol] launches on the path: {launches}; {held.calls} "
          f"held calls made K3 {held.got}, their sweeps x launches a sweep "
          f"{held.want}")
    check(not held.bad, f"[mesh:protocol] K3 launches differ from sweeps x "
          f"launches a sweep: {held.bad[:5]}")
    check(launches["k3"] == held.got,
          "[mesh:protocol] K3 launched outside the held calls")
    check_sweep_passes("mesh:protocol", launches)
    check(launches["k3"] > 0, "[mesh:protocol] K3 was not launched")
    check(launches["k0"] == 1, "[mesh:protocol] K0 did not run once")

    # --- [mesh:scaling] and [mesh:comm], after the window ------------------
    t_phase = time.perf_counter()
    label = f"one card: partition overhead, no link measured ({dev} x4)"
    for row in scaling_sweep(g, [1, 2, 4], iters=5, devices=[dev] * 4):
        print(f"[mesh:scaling] sharded_fora_step on {row['mesh']}, batch "
              f"{row['batch']}: {row['steps_per_sec']:.2f} steps/s, "
              f"{row['queries_per_sec']:.2f} queries/s, time a step "
              f"{row['overhead_vs_first']:.3f}x the 1-device mesh's; "
              f"{label}")
        check(row["proxy"] == (row["devices"] > 1),
              "[mesh:scaling] a repeated card must be marked a proxy")
    for row in engine_scaling_sweep(ds, [1, 2, 4], batch=32, iters=2,
                                    devices=[dev] * 4):
        print(f"[mesh:scaling] ShardedForaTopk on {row['mesh']}, batch 32: "
              f"{row['queries_per_sec']:.1f} qps, {row['sweeps']} sweeps, "
              f"{row['overhead_vs_1dev']:.3f}x the 1-device time; {label}")
    walls["mesh:scaling"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        comm_model.main(["--n", "65536", "--deg", "16", "--seed", "42",
                         "--batch", str(b), "--measure"])
    comm = json.loads(buf.getvalue())
    br = comm["measured_breakdown"]
    for key, row in comm["bytes_per_sweep"].items():
        print(f"[mesh:comm] bytes a sweep out of a device at B={b}, {key}: "
              f"edge psum {row['edge_psum']}, node ring {row['node_ring']}, "
              f"bf16 ring {row['node_ring_bf16']}, frontier 16/64 bf16 "
              f"{row['node_ring_frontier_16_64_bf16']}")
    print(f"[mesh:comm] K3 {comm['spmv_ns_per_edge']:.4f} ns an edge (half "
          f"the bench edges, B {b}, L2 flushed); link bytes/s "
          f"{comm['link_bytes_per_s']} and prediction {comm['prediction']} "
          f"({torch.cuda.device_count()} card visible); measure_breakdown "
          f"{br['mesh']} B {br['batch']}: sweep "
          f"{br['t_sweep_full_s'] * 1e3:.3f} ms with psum, "
          f"{br['t_sweep_local_only_s'] * 1e3:.3f} without, "
          f"psum share {br['collective_fraction']:.4f}; {label}")
    check(comm["spmv_ns_per_edge"] > 0 and br["distinct_devices"] == 1,
          "[mesh:comm] no measurement")
    # measured numbers only: the bytes a sweep are the model's formulas
    out["comm"] = {"spmv_ns_per_edge": comm["spmv_ns_per_edge"],
                   "link_bytes_per_s": comm["link_bytes_per_s"],
                   "psum_share": br["collective_fraction"],
                   "sweep_ms": br["t_sweep_full_s"] * 1e3,
                   "sweep_local_only_ms": br["t_sweep_local_only_s"] * 1e3}
    walls["mesh:comm"] = time.perf_counter() - t_phase
    out["walls"] = walls
    print(f"[mesh:protocol] walls (s): {walls}")
    return launches, out


DIST_RANKS = 4
#: seconds the ranks' collectives wait for a lost peer, and the phase's
#: deadline
DIST_COLLECTIVE_S, DIST_DEADLINE_S = 300, 600
DIST_DIR = os.path.join("build", "ppr_tpu_torch", "dist")
#: the node engine's settings at [dist:node]: [mesh:node]'s bf16 ring
#: compacted to 16 of its 64 frontier blocks
DIST_NODE = {"ring_dtype": "bf16", "frontier_blocks": 16}


def digest(x) -> str:
    """SHA-256 of an array's bytes: equal digests are equal bits."""
    import hashlib

    import torch

    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def stash_runs(eng) -> list:
    """Keep each ``eng._run`` result (the selection, the final reserve
    parts and the sweeps) in the returned list."""
    runs, orig = [], eng._run

    def kept(*a, **kw):
        out = orig(*a, **kw)
        runs.append(out)
        return out

    eng._run = kept
    return runs


def serving_case(eng, sources) -> dict:
    """One ``compute_topk_ids_batch`` of B = ``len(sources)`` on ``eng``:
    the selection, the sweeps and each of this process's final reserve
    parts' digest by position."""
    from ppr_tpu_torch.parallel.mesh import is_remote

    runs = stash_runs(eng)
    eng.mesh.synchronize()
    t0 = time.perf_counter()
    vals, ids = eng.compute_topk_ids_batch(sources, K, EPS)
    eng.mesh.synchronize()
    wall = time.perf_counter() - t0
    _, _, finals, iters = runs[-1]
    if finals and not isinstance(finals[0], list):   # the edge engine's rows
        finals = [[x] for x in finals]
    parts = {f"{d},{s}": digest(x) for d, row in enumerate(finals)
             for s, x in enumerate(row) if not is_remote(x)}
    return {"vals": vals, "ids": ids, "sweeps": int(iters), "wall_s": wall,
            "parts": parts}


def dist_rank(work: str) -> int:
    """A rank of ``[dist:*]``: ``DIST_RANKS`` gloo ranks share this card.
    Each joins the group, builds the bench graph, and runs the edge 2x2
    and node 1x4 serving engines at B 2048, the node whole-graph with
    walks at B 64 and ``PerfHarness`` at 2x2 on the grqc stand-in, every
    one on ``global_mesh``, inside ``HeldK3(spanning=True)``. Writes what
    it got to ``work/rank<r>.json`` (and its arrays to ``.npz``)."""
    import torch
    import torch.distributed as dist

    from ppr_tpu_torch import cli
    from ppr_tpu_torch.device import set_exact_f32_matmul
    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.harness import PerfHarness
    from ppr_tpu_torch.ops import cuda_build
    from ppr_tpu_torch.parallel.distributed import (global_mesh,
                                                    initialize_from_env)
    from ppr_tpu_torch.parallel.node_sharded_fora import (
        NodeShardedForaTopk, NodeShardedForaWholeGraph)
    from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

    # NCCL takes one rank a card: the ranks sharing this card use gloo
    check(initialize_from_env("gloo", timeout_s=DIST_COLLECTIVE_S),
          "[dist] no multi-process environment")
    rank = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    set_exact_f32_matmul()
    cuda_build.load_library("row_gather")
    cuda_build.load_library("probe")
    ds = synthetic_powerlaw(65536, 16, seed=42, dense_threshold=0,
                            device=dev)
    sources = np.random.default_rng(0).integers(0, ds.n, 2048)
    grqc = cli.load_dataset("synth:grqc", device=dev)
    m22 = global_mesh(2, devices=[dev])
    m14 = global_mesh(4, devices=[dev])
    out, arrays, walls = {"rank": rank}, {}, {}
    count_annealed_sweeps()
    reset_launches()
    with HeldK3(spanning=True) as held:
        for tag, eng in (("edge", ShardedForaTopk(ds, ALPHA, K, mesh=m22)),
                         ("node", NodeShardedForaTopk(ds, ALPHA, K, mesh=m14,
                                                      **DIST_NODE))):
            wire0, wire_s0 = eng.mesh.wire_bytes, eng.mesh.wire_s
            mark = held.mark()
            res = serving_case(eng, sources)
            arrays[f"{tag}_vals"], arrays[f"{tag}_ids"] = \
                res.pop("vals"), res.pop("ids")
            res.update(wire_bytes=eng.mesh.wire_bytes - wire0,
                       wire_s=eng.mesh.wire_s - wire_s0,
                       k3=held.mark()[1] - mark[1])
            out[tag] = res
            walls[f"dist:{tag}"] = res["wall_s"]
            del eng

        eng = NodeShardedForaWholeGraph(ds, ALPHA, mesh=m14,
                                        completion="walks", seed=3,
                                        max_walkers_per_device=1 << 24)
        wire0, wire_s0 = m14.wire_bytes, m14.wire_s
        m14.synchronize()
        t0 = time.perf_counter()
        rows = eng.compute_whole_graph_batch(sources[:64], EPS)
        walls["dist:walks"] = time.perf_counter() - t0
        arrays["walks_rows"] = rows
        out["walks"] = {"sweeps": eng.last_iters, "rows": digest(rows),
                        "wire_bytes": m14.wire_bytes - wire0,
                        "wire_s": m14.wire_s - wire_s0,
                        "wall_s": walls["dist:walks"]}
        del eng

        protocol = os.path.abspath(os.path.join(work, "protocol"))
        harness = PerfHarness(grqc, seed=0, out_dir=protocol,
                              progress=False, mesh=m22)
        wire0, wire_s0 = m22.wire_bytes, m22.wire_s
        cwd = os.getcwd()
        t0 = time.perf_counter()
        try:
            os.chdir(protocol)
            with open(os.path.join(protocol, f"rank{rank}.log"), "w") as f, \
                    contextlib.redirect_stdout(f):
                harness.algo_perf_batch_test(
                    50, K, tests=(1, 2), algos={"FWDPUSH",
                                                "BASE_WHOLE_GRAPH"})
        finally:
            os.chdir(cwd)
        walls["dist:protocol"] = time.perf_counter() - t0
        out["protocol"] = {"report": harness.writer.path,
                           "writer": harness.writer.enabled,
                           "wire_bytes": m22.wire_bytes - wire0,
                           "wire_s": m22.wire_s - wire_s0}
    out["held"] = {"calls": held.calls, "got": held.got, "want": held.want,
                   "bad": held.bad[:5]}
    out["launches"] = read_launches()
    out["walls"] = walls
    np.savez(os.path.join(work, f"rank{rank}.npz"), **arrays)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def store_arrays(root: str) -> dict:
    """A BASE store's manifest and every shard's arrays."""
    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.endswith(".npz"):
            with np.load(path) as z:
                out[name] = {k: z[k].tobytes() for k in z.files}
        else:
            with open(path) as f:
                out[name] = json.load(f)
    return out


def wire_shares(ranks, tag) -> list[float]:
    """Each rank's seconds in its collectives (``Mesh.wire_s``: gloo's
    staging, the transfer and the wait for the peers) over its wall."""
    return [round(got[tag]["wire_s"] / got[tag]["wall_s"], 4)
            for got in ranks]


def dist_path(dev, ds, sources, oracle) -> tuple[dict, dict]:
    """``[dist:*]``: the mesh across processes, ``DIST_RANKS`` gloo ranks
    sharing this card (``parallel/distributed.py``; NCCL takes one rank a
    card). The single-process meshes of the card repeated give the
    references first: ``ShardedForaTopk`` 2x2 and ``NodeShardedForaTopk``
    1x4 (``DIST_NODE``) at B 2048 on the bench graph, and
    ``NodeShardedForaWholeGraph`` 1x4 with walks at B 64. Then the ranks
    (``dist_rank``) run the same on ``global_mesh``: ``[dist:edge]`` and
    ``[dist:node]`` must give the references' sweeps, selections and
    final reserve parts bit for bit (SHA-256 of each part's bytes) and
    precision@10 >= 0.99 against the oracle, ``[dist:walks]`` the
    reference's rows bit for bit, and ``[dist:protocol]``
    (``PerfHarness(mesh=global_mesh())`` at 2x2 on the grqc stand-in,
    Tests 1-2, Forward Push and BASE) rows within ``JAX_ROWS``'s bars, one
    report written (by rank 0) and BASE stores whose manifests and arrays
    equal those ``[protocol:mesh]``'s 2x2 harness wrote. Every rank's K3
    launches are held call by call (``HeldK3(spanning=True)``), and each
    rank runs K0 once. Returns the K3 and K0 launches summed over the
    ranks and what the phase measured."""
    import torch

    from ppr_tpu_torch.parallel.distributed import spawn_local
    from ppr_tpu_torch.parallel.mesh import make_mesh
    from ppr_tpu_torch.parallel.node_sharded_fora import (
        NodeShardedForaTopk, NodeShardedForaWholeGraph)
    from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

    def mesh(d, g):
        return make_mesh(d * g, data=d, graph=g, devices=[dev] * (d * g))

    t_phase = time.perf_counter()
    refs = {}
    for tag, eng in (("edge", ShardedForaTopk(ds, ALPHA, K, mesh=mesh(2, 2))),
                     ("node", NodeShardedForaTopk(ds, ALPHA, K,
                                                  mesh=mesh(1, 4),
                                                  **DIST_NODE))):
        refs[tag] = serving_case(eng, sources)
        del eng
    eng = NodeShardedForaWholeGraph(ds, ALPHA, mesh=mesh(1, 4),
                                    completion="walks", seed=3,
                                    max_walkers_per_device=1 << 24)
    walk_rows = eng.compute_whole_graph_batch(sources[:64], EPS)
    refs["walks"] = {"sweeps": eng.last_iters, "rows": digest(walk_rows)}
    del eng
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    print(f"[dist] single-process references on {dev} repeated: edge 2x2 "
          f"{refs['edge']['sweeps']} sweeps, node 1x4 {DIST_NODE} "
          f"{refs['node']['sweeps']} sweeps, whole-graph walks 1x4 B 64 "
          f"{refs['walks']['sweeps']} ring sweeps; {ref_s:.1f} s")

    work = os.path.abspath(DIST_DIR)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(os.path.join(work, "protocol"))
    t0 = time.perf_counter()
    spawn_local(DIST_RANKS, [sys.executable, os.path.abspath(__file__),
                             "--dist-rank", work],
                timeout_s=DIST_DEADLINE_S, log_dir=os.path.join(work, "logs"))
    spawn_s = time.perf_counter() - t0
    ranks, arrays = [], []
    for r in range(DIST_RANKS):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
        arrays.append(dict(np.load(os.path.join(work, f"rank{r}.npz"))))
    print(f"[dist] {DIST_RANKS} gloo ranks on {dev}, spawned and joined in "
          f"{spawn_s:.1f} s (each builds the bench graph; its output in "
          f"{os.path.join(DIST_DIR, 'logs')})")

    n_acc, tol, b = len(oracle), EPS / ds.n, len(sources)
    out = {"ranks": DIST_RANKS, "backend": "gloo", "spawn_s": spawn_s}
    for tag, shape in (("edge", "2x2"), ("node", f"1x4 {DIST_NODE}")):
        ref = refs[tag]
        parts = {}
        for got, arr in zip(ranks, arrays):
            parts.update(got[tag]["parts"])
            check(got[tag]["sweeps"] == ref["sweeps"],
                  f"[dist:{tag}] rank {got['rank']}: {got[tag]['sweeps']} "
                  f"sweeps, the single process {ref['sweeps']}")
            check(np.array_equal(arr[f"{tag}_vals"], ref["vals"])
                  and np.array_equal(arr[f"{tag}_ids"], ref["ids"]),
                  f"[dist:{tag}] rank {got['rank']}: the selection differs "
                  "from the single process's")
        check(parts == ref["parts"], f"[dist:{tag}] final reserve parts "
              f"differ from the single process's: {sorted(parts)} vs "
              f"{sorted(ref['parts'])}")
        prec = precision(oracle, tie_tolerant_ids(
            arrays[0][f"{tag}_vals"], arrays[0][f"{tag}_ids"], n_acc, tol))
        check(prec >= 0.99, f"[dist:{tag}] precision@10 {prec} < 0.99")
        wall = max(got[tag]["wall_s"] for got in ranks)
        wire = sum(got[tag]["wire_bytes"] for got in ranks)
        k3 = [got[tag]["k3"] for got in ranks]
        beyond = 1.0 - ref["wall_s"] / wall
        wire_share = wire_shares(ranks, tag)
        print(f"[dist:{tag}] {shape} over {DIST_RANKS} ranks, B={b}: wall "
              f"{wall * 1e3:.1f} ms (single process {ref['wall_s'] * 1e3:.1f}"
              f" ms), {wall * 1e3 / ref['sweeps']:.2f} ms a sweep (single "
              f"process {ref['wall_s'] * 1e3 / ref['sweeps']:.2f}); sweeps "
              f"{ref['sweeps']} on every rank as in one process; the "
              f"selection and the {len(parts)} final reserve parts equal bit "
              f"for bit; precision@10 {prec:.4f}; the wire {wire} bytes out "
              f"of all ranks, {wire / ref['sweeps']:.0f} a sweep; its "
              f"collectives' time over the wall by rank {wire_share}; "
              f"{beyond:.4f} of the wall beyond the single process's; K3 "
              f"launches by rank {k3}")
        out[tag] = {"wall_ms": wall * 1e3, "single_ms": ref["wall_s"] * 1e3,
                    "sweeps": ref["sweeps"], "precision": prec,
                    "wire_bytes": wire,
                    "wire_bytes_per_sweep": wire / ref["sweeps"],
                    "wire_share_by_rank": wire_share,
                    "beyond_single_share": beyond, "k3_by_rank": k3}

    for got, arr in zip(ranks, arrays):
        check(got["walks"]["rows"] == refs["walks"]["rows"]
              and got["walks"]["sweeps"] == refs["walks"]["sweeps"],
              f"[dist:walks] rank {got['rank']}: rows differ from the "
              "single process's")
    mass = arrays[0]["walks_rows"].astype(np.float64).sum(axis=1)
    check(bool((np.abs(mass - 1.0) <= 1e-3).all()),
          "[dist:walks] row mass off by more than 1e-3")
    wall = max(got["walks"]["wall_s"] for got in ranks)
    wire = sum(got["walks"]["wire_bytes"] for got in ranks)
    wire_share = wire_shares(ranks, "walks")
    print(f"[dist:walks] node whole-graph 1x4 with walks, B=64: wall "
          f"{wall:.2f} s, ring sweeps {refs['walks']['sweeps']}, rows equal "
          f"to the single process's bit for bit on every rank, mass "
          f"{mass.min():.7f}..{mass.max():.7f}; the wire {wire} bytes, its "
          f"time over the wall by rank {wire_share}")
    out["walks"] = {"wall_s": wall, "sweeps": refs["walks"]["sweeps"],
                    "wire_bytes": wire, "wire_share_by_rank": wire_share}

    reports = {got["protocol"]["report"] for got in ranks}
    writers = [got["rank"] for got in ranks if got["protocol"]["writer"]]
    check(len(reports) == 1 and writers == [0],
          f"[dist:protocol] reports {reports}, writers {writers}")
    check_protocol_rows("dist 2x2", read_protocol_file(reports.pop()),
                        jax_rows=JAX_ROWS["grqc"])
    single_root = os.path.join(PROTOCOL_DIR, "mesh_grqc_2x2",
                               "BASE_ppr_results", "grqc")
    dist_root = os.path.join(work, "protocol", "BASE_ppr_results", "grqc")
    stores = sorted(os.listdir(single_root))
    check(stores == sorted(os.listdir(dist_root)),
          f"[dist:protocol] BASE stores {sorted(os.listdir(dist_root))} vs "
          f"{stores}")
    for name in stores:
        check(store_arrays(os.path.join(single_root, name))
              == store_arrays(os.path.join(dist_root, name)),
              f"[dist:protocol] BASE store {name} differs from the single "
              "process's")
    wall = max(got["walls"]["dist:protocol"] for got in ranks)
    wire = sum(got["protocol"]["wire_bytes"] for got in ranks)
    wire_share = [round(got["protocol"]["wire_s"]
                        / got["walls"]["dist:protocol"], 4) for got in ranks]
    print(f"[dist:protocol] PerfHarness(mesh=global_mesh()) 2x2 on "
          f"synth:grqc, Tests 1-2, FWDPUSH and BASE_WHOLE_GRAPH: wall "
          f"{wall:.1f} s; one report, by rank 0; the {len(stores)} BASE "
          f"stores' manifests and arrays equal to [protocol:mesh]'s 2x2 "
          f"harness's; the wire {wire} bytes, its time over the wall by "
          f"rank {wire_share}")
    out["protocol"] = {"wall_s": wall, "stores": len(stores),
                       "wire_bytes": wire, "wire_share_by_rank": wire_share}

    launches = {key: sum(got["launches"][key] for got in ranks)
                for key in ranks[0]["launches"]}
    for got in ranks:
        h = got["held"]
        check(not h["bad"] and h["got"] == h["want"] and h["calls"] > 0,
              f"[dist] rank {got['rank']}: K3 launches {h['got']} in "
              f"{h['calls']} held calls, want {h['want']}: {h['bad']}")
        check(got["launches"]["k3"] == h["got"],
              f"[dist] rank {got['rank']}: K3 launched outside the held "
              "calls")
        check(got["launches"]["k0"] == 1,
              f"[dist] rank {got['rank']}: K0 did not run once")
    print(f"[dist] launches summed over the ranks: {launches}; each rank's "
          f"K3 launches equal its held calls' sweeps x its own chunks or "
          f"ring blocks: {[got['held']['got'] for got in ranks]}")
    check_sweep_passes("dist", launches)
    out["k3_launches"] = launches["k3"]
    out["walls"] = {key: max(got["walls"][key] for got in ranks)
                    for key in ranks[0]["walls"]}
    out["walls"]["references"] = ref_s
    print(f"[dist] walls (s): {out['walls']}, phase "
          f"{time.perf_counter() - t_phase:.1f}")
    return launches, out


def hub_constants_phase(g) -> dict:
    """``[hubs:constants]``: the automatic hub count's two prices measured
    at ``REF_BATCH`` on the bench graph (``hub_knee_torch.measure_prices``)
    beside the constants in ``ops/hub_split.py``; each within 2x."""
    import hub_knee_torch
    from ppr_tpu_torch.ops import hub_split as hsm

    t0 = time.perf_counter()
    pr = hub_knee_torch.measure_prices(g, hsm.REF_BATCH)
    tail = pr["tail_ns_per_edge"] / hsm.TAIL_NS_PER_EDGE
    col = pr["hbm_gbps"] / hsm.HUB_COLUMN_GBPS
    print(f"[hubs:constants] B={hsm.REF_BATCH}: K3 "
          f"{pr['tail_ns_per_edge']:.4f} ns an edge over {pr['m_tail']} tail "
          f"edges ({pr['tail_ms']:.4f} ms, replays, L2 flushed) against "
          f"TAIL_NS_PER_EDGE {hsm.TAIL_NS_PER_EDGE} ({tail:.3f}x); one more "
          f"bf16 hub column {pr['col_ns']:.2f} ns = {pr['hbm_gbps']:.1f} GB/s"
          f" (torch.mm at H {' and '.join(pr['mm_ms'])}: "
          f"{', '.join(f'{v:.4f}' for v in pr['mm_ms'].values())} ms) "
          f"against HUB_COLUMN_GBPS {hsm.HUB_COLUMN_GBPS} ({col:.3f}x); "
          f"wall {time.perf_counter() - t0:.1f} s")
    for name, ratio in (("tail_ns_per_edge", tail), ("hbm_gbps", col)):
        check(0.5 <= ratio <= 2.0, f"[hubs:constants] the measured "
              f"{name} is {ratio:.3f}x the committed constant, not within 2x")
    return pr


def scale_path(dev, ds, bench_sweeps: int) -> tuple[dict, dict]:
    """The automatic hub count and the 1M cell: after
    ``[hubs:constants]``, one launch window, every K3 launch in it held
    call by call (``HeldK3(single=True)``):

    * ``[hubs:auto]``: ``auto_num_hubs`` with the shipped prices on the
      bench graph; at B 512 one call of ``compute_topk_ids_batch`` at the
      rule's count and one at 4096, in turns after a warm-up each: qps,
      sweeps, precision@10 against the power method (tie tol eps/n), each
      >= 0.99; ``bench_torch.hub_count`` still 4096 at B 2048 and the
      ``[bench]`` call's sweeps still 77;
    * ``[scale:1m]``: ``scale_1m_torch.measure`` at B 256 (the automatic
      hub count): recall@10 >= 0.99 against ``power_method_batch``, itself
      within 1e-5 of a float64 scipy power iteration on the same 4
      sources (the driver's own, ``record["acc_sources"]``); whole-graph
      rows of mass within 1e-4 of 1, and on those 4 sources the oracle's
      top-10 within each row's (precision@10 1, ties eps/n) and every
      entry above 1/n within relative error eps of it; walks of mass 1
      within 1e-6; peak memory;
    * ``[occupancy]``: ``ring_occupancy_torch`` on the bench graph at B 64:
      Part A's coverage, Part B dense against frontier at 16 and 64 of 64
      blocks on a 2x4 mesh of the card repeated, full capacity equal to
      dense bit for bit.

    Then, outside the window, ``[scale:1m:k3]``: K3 at the 1M tail's shape
    on a 16-column slice against its plain version, bit for bit. Returns
    the window's launches and K3's record at that shape."""
    import torch

    import bench_torch
    import ring_occupancy_torch
    import scale_1m_torch
    from ppr_tpu_torch.models import power_method
    from ppr_tpu_torch.models.fora import ForaTopk
    from ppr_tpu_torch.ops.hub_split import auto_num_hubs, build_hub_split
    from ppr_tpu_torch.parallel.mesh import make_mesh

    wall0 = time.perf_counter()
    prices = hub_constants_phase(ds.graph)
    bf16 = torch.bfloat16
    reset_launches()
    with HeldK3(single=True) as held:
        # --- [hubs:auto] --------------------------------------------------
        t0 = time.perf_counter()
        mark = held.mark()
        rule = auto_num_hubs(ds.graph, bf16)
        sources = np.random.default_rng(1).integers(0, ds.n, 512)
        oracle = power_method.power_method_batch(
            ds.graph, sources[:32], ALPHA, ITERS).cpu().numpy()
        tol = EPS / ds.n
        engines = {}
        for h in (rule, 4096):
            eng = ForaTopk(ds, ALPHA, K, seed=7, push="none")
            eng.enable_hub_split(h, dtype=bf16)
            eng.compute_topk_ids_batch(sources, K, EPS)      # warm-up
            engines[h] = eng
        rows = {}
        for h, eng in engines.items():
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            vals, ids = eng.compute_topk_ids_batch(sources, K, EPS)
            dt = time.perf_counter() - t1
            prec = precision(oracle, tie_tolerant_ids(vals, ids, 32, tol))
            rows[h] = {"hubs": h, "qps": len(sources) / dt,
                       "ms": dt * 1e3, "sweeps": eng.last_iters,
                       "precision": prec,
                       "tail_edges": eng.hub_split.m_tail}
            mark_rule = " (the rule)" if h == rule else ""
            print(f"[hubs:auto] B=512 H={h}{mark_rule}: "
                  f"{dt * 1e3:.1f} ms = {len(sources) / dt:.1f} qps, "
                  f"sweeps {eng.last_iters}, tail edges "
                  f"{eng.hub_split.m_tail}, precision@10 {prec:.4f}")
            check(prec >= 0.99, f"[hubs:auto] H={h} precision@10 {prec}")
        del engines
        torch.cuda.empty_cache()
        bench_hubs = bench_torch.hub_count(2048)
        print(f"[hubs:auto] the rule's count on the bench graph {rule}; "
              f"bench_torch's count at B 2048 {bench_hubs}, at B 512 "
              f"{bench_torch.hub_count(512)!r}; [bench] sweeps "
              f"{bench_sweeps}; wall {time.perf_counter() - t0:.1f} s")
        check(bench_hubs == 4096, "[hubs:auto] bench_torch's rule left 4096 "
              "hubs at B 2048")
        check(bench_sweeps == 77, f"[hubs:auto] [bench] took {bench_sweeps} "
              "sweeps, not 77")
        held.hold("hubs:auto", mark)

        # --- [scale:1m] ---------------------------------------------------
        t0 = time.perf_counter()
        mark = held.mark()
        args = scale_1m_torch.parse_args(["--batch", "256"])
        ds1m = scale_1m_torch.build(args, dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rec, oracle1m = scale_1m_torch.measure(args, ds1m)
        g1m = ds1m.graph
        acc = np.asarray(rec["acc_sources"])
        exact = scipy_power_method(g1m, acc, ALPHA)
        err = float(np.abs(oracle1m - exact).max())
        mass_err = max(abs(m - 1.0) for m in rec["mass_rows"])
        print(f"[scale:1m] synthetic_powerlaw(2^20, 8, seed=11): n={g1m.n} "
              f"m={g1m.m}, built ({rec['builder']}) and placed in "
              f"{build_s:.1f} s; top-k B=256: {rec['fora_topk_qps']:.1f} qps,"
              f" {rec['topk_sweeps']} sweeps ({rec['topk_path']}), "
              f"{rec['auto_hubs']} auto hubs carrying "
              f"{100 * rec['hub_edge_cover']:.1f}% of the edges, peak "
              f"{rec['topk_peak_gb']:.2f} GB, recall@10 "
              f"{rec['recall_at_10']:.4f} ({rec['recall_dense_rows']} rows "
              f"recomputed densely)")
        print(f"[scale:1m] oracle power_method_batch vs float64 scipy on the "
              f"{len(acc)} recall sources: max abs err {err:.3e}")
        print(f"[scale:1m] whole-graph B={args.wg_batch}: "
              f"{rec['fora_whole_graph_qps']:.3f} qps, {rec['wg_push_rounds']}"
              f" push rounds, row mass within {mass_err:.3e} of 1, on the "
              f"{rec['wg_checked_rows']} recall sources precision@10 "
              f"{rec['wg_precision_at_10']:.4f} and relative error "
              f"{rec['wg_rel_err_above_delta']:.3e} above 1/n against the "
              f"oracle, peak {rec['wg_peak_gb']:.2f} GB; walks "
              f"{rec['walks_per_sec']:.4g} a second over {args.walkers} "
              f"walkers, mass {rec['walks_mass']:.9f}; wall "
              f"{time.perf_counter() - t0:.1f} s")
        check(err <= 1e-5, f"[scale:1m] oracle error {err} > 1e-5")
        check(rec["recall_at_10"] >= 0.99,
              f"[scale:1m] recall@10 {rec['recall_at_10']} < 0.99")
        check(rec["wg_finite"] and mass_err <= 1e-4,
              f"[scale:1m] whole-graph row mass off by {mass_err}")
        check(rec["wg_checked_rows"] == args.acc_queries
              and rec["wg_precision_at_10"] == 1.0,
              f"[scale:1m] whole-graph precision@10 "
              f"{rec['wg_precision_at_10']} on {rec['wg_checked_rows']} rows")
        check(rec["wg_rel_err_above_delta"] <= EPS,
              f"[scale:1m] whole-graph relative error "
              f"{rec['wg_rel_err_above_delta']} > eps {EPS} above 1/n")
        check(abs(rec["walks_mass"] - 1.0) <= 1e-6,
              f"[scale:1m] walks mass {rec['walks_mass']}")
        held.hold("scale:1m", mark)

        # --- [occupancy] --------------------------------------------------
        t0 = time.perf_counter()
        mark = held.mark()
        deg = ds.graph.out_deg[: ds.n].cpu().numpy()
        occ_src = np.random.default_rng(0).choice(
            np.nonzero(deg > 0)[0], size=64, replace=False).astype(np.int32)
        _, agg = ring_occupancy_torch.dense_coverage(ds, occ_src, EPS, k=K)
        mesh = make_mesh(8, data=2, graph=4, devices=[dev] * 8)
        infl = ring_occupancy_torch.empirical_inflation(
            ds, occ_src, EPS, mesh, k=K, orders=("degree",), caps=(16, 64))
        print(f"[occupancy] bench graph B=64: Part A {agg['sweeps']} sweeps, "
              f"occupancy max {agg['occupancy_max']:.3f}, coverage(1/8) "
              f"mass-weighted {agg['coverage_0.1250_mass_weighted']:.3f}, "
              f"(1/4) {agg['coverage_0.2500_mass_weighted']:.3f}; Part B "
              f"(2x4 of the card) dense ring {infl['dense_sweeps']} sweeps, "
              f"oracle err {infl['dense_oracle_err']:.2e}; " + ", ".join(
                  f"C={f['capacity_blocks']}/64: {f['sweeps']} sweeps "
                  f"({f['sweep_inflation']:.2f}x), ids match dense "
                  f"{f['ids_match_dense']}, values equal dense "
                  f"{f['values_equal_dense']}, oracle err "
                  f"{f['oracle_err']:.2e}" for f in infl["frontier"])
              + f"; wall {time.perf_counter() - t0:.1f} s")
        full = next(f for f in infl["frontier"]
                    if f["capacity_blocks"] == 64)
        check(full["values_equal_dense"] and full["ids_match_dense"]
              and full["sweeps"] == infl["dense_sweeps"],
              "[occupancy] frontier at full capacity differs from the dense "
              "ring")
        check(agg["sweeps"] == infl["dense_sweeps"],
              f"[occupancy] Part A took {agg['sweeps']} sweeps, the dense "
              f"ring {infl['dense_sweeps']}")
        held.hold("occupancy", mark)
    launches = read_launches()
    print(f"[scale] launches on the path: {launches}; {held.calls} held "
          f"calls made K3 {held.got}, their sweeps x launches a sweep "
          f"{held.want}")
    check(not held.bad, f"[scale] K3 launches differ from sweeps x launches "
          f"a sweep: {held.bad[:5]}")
    check(launches["k3"] == held.got and launches["k3"] > 0,
          "[scale] K3 launched outside the held calls")
    check_sweep_passes("scale", launches, annealed=True)
    check(launches["k0"] == 1, "[scale] K0 did not run once")

    # --- [scale:1m:k3], outside the window ---------------------------------
    hs1m = build_hub_split(g1m, "auto", dtype=bf16)
    k3 = k3_cases(dev, [dict(label="1M tail, 16 columns", n_rows=g1m.n_pad,
                             src=hs1m.tail_src, ptr=hs1m.tail_ptr, b=16,
                             cold=True)], tag="scale:1m:k3")
    del hs1m, ds1m, g1m
    torch.cuda.empty_cache()
    wall = time.perf_counter() - wall0
    print(f"[scale] the new phases' wall: {wall:.1f} s")
    return launches, {"prices": prices, "hubs_auto": list(rows.values()),
                      "scale_1m": rec, "occupancy": {"aggregate": agg,
                                                     "empirical": infl},
                      "k3_1m_tail": {key: k3[key] for key in (
                          "max_abs_err", "ms", "plain_ms", "bound_ms",
                          "bound_by", "library_ms", "host_us", "device_ms",
                          "shapes")},
                      "wall_s": wall}


def profile_sweep_path(dev, ds) -> tuple[dict, dict]:
    """``[profile_sweep]``: ``profile_sweep_torch.run`` at B 256 on the
    bench graph, variants ``plain``, ``hub512_bf16`` and ``hub4096_bf16``,
    every residual and annealed call (the traced ones too) held by
    ``HeldK3(single=True)``; each annealed variant's tie-expanded top-10
    sets at precision@10 >= 0.99 against the oracle of the same sources
    (the first 32); its trace split naming K3 and, for the hub variants,
    the hub product. Returns the window's launches and the record."""
    import profile_sweep_torch
    from ppr_tpu_torch.models import fora
    from ppr_tpu_torch.models.power_method import power_method_batch

    t0 = time.perf_counter()
    args = profile_sweep_torch.parse_args(
        ["--hubs", "512,4096", "--skip-f32", "--trace"])
    n_acc = 32
    sources = np.random.default_rng(0).integers(0, ds.n, args.batch)
    oracle = power_method_batch(ds.graph, sources[:n_acc], ALPHA,
                                ITERS).cpu().numpy()
    reset_launches()
    keep = {}
    with HeldK3(single=True) as held:
        mark = held.mark()
        rec = profile_sweep_torch.run(args, ds, keep=keep)
        held.hold("profile_sweep", mark)
    launches = read_launches()
    check(not held.bad, f"[profile_sweep] K3 launches differ from sweeps x "
          f"launches a sweep: {held.bad[:5]}")
    check(launches["k3"] == held.got and launches["k0"] == 1,
          f"[profile_sweep] launches {launches}: K3 outside the held calls "
          f"or K0 not once")
    check_sweep_passes("profile_sweep", launches, annealed=True)
    check(np.array_equal(keep["sources"].cpu().numpy(), sources),
          "[profile_sweep] the driver's sources are not the oracle's")
    g = ds.graph
    kcap = fora.topk_kcap(K, g.n_pad)
    for name, row in rec["summary"].items():
        extra = ""
        if name.startswith("annealed_"):
            vals, ids = fora._device_topk_epilogue(
                g, keep["sources"], keep.pop(name), keep["onehot"], kcap)
            prec = precision(oracle, tie_tolerant_ids(
                vals.cpu().numpy(), ids.cpu().numpy(), n_acc, EPS / ds.n))
            row["precision_at_10"] = prec
            tr = rec["traces"][name]
            named = tr["named"]
            extra = (f", precision@10 {prec:.4f}; trace: {tr['kernels']} "
                     f"kernels, busy {tr['busy_ms']:.2f} ms in a span of "
                     f"{tr['span_ms']:.2f} (idle "
                     f"{100 * tr['idle_share']:.1f}%), K3 "
                     f"{named['K3']['ms']:.2f} ms "
                     f"{100 * named['K3']['share']:.1f}% in "
                     f"{named['K3']['launches']} launches, hub mm "
                     f"{named['hub mm']['ms']:.2f} ms in "
                     f"{named['hub mm']['launches']} launches; top "
                     + "; ".join(f"{k['name'][:48]} {k['ms']:.2f} ms"
                                 for k in tr["by_kernel"][:4]))
            check(prec >= 0.99, f"[profile_sweep] {name} precision@10 {prec}")
            check(named["K3"]["launches"] > 0,
                  f"[profile_sweep] the trace of {name} names no K3")
            check(("hub" not in name) or named["hub mm"]["launches"] > 0,
                  f"[profile_sweep] the trace of {name} names no hub mm")
        print(f"[profile_sweep] {name}: {row['iters']} sweeps, host "
              f"{row['total_ms']:.2f} ms, device {row['device_ms']:.2f} ms, "
              f"first call {row['first_call_s']:.2f} s{extra}")
    wall = time.perf_counter() - t0
    print(f"[profile_sweep] launches {launches}; wall {wall:.1f} s")
    return launches, {"summary": rec["summary"], "traces": {
        name: {key: tr[key] for key in ("kernels", "busy_ms", "span_ms",
                                         "idle_share", "named", "by_kernel")}
        for name, tr in rec["traces"].items()}, "wall_s": wall}


def serving_calibrate_path(ds) -> tuple[dict, dict]:
    """``[serving:calibrate]``: the latency driver's in-process run with
    ``--calibrate`` at max batch 256, one load point of 2 s on the bench
    graph: the measured constants, each prewarmed rung's path, p50/p99.
    Its own launch window: the calibration and the served batches launch
    K3, K0 once. Returns the window's launches and the record."""
    import serving_latency_torch

    t0 = time.perf_counter()
    largs = serving_latency_torch.parse_args(
        ["--calibrate", "--max-batch", "256", "--rates", "0.5",
         "--duration-s", "2"])
    reset_launches()
    lrec = serving_latency_torch.run(largs, ds)
    launches = read_launches()
    cm = lrec["cost_model"]
    [lrow] = lrec["rows"]
    c = cm["constants"]
    print(f"[serving:calibrate] measured {c['walk_ns']:.1f} ns a walk, "
          f"{c['spmv_ns_per_edge']:.4f} ns an edge, "
          f"{c['d2h_bytes_per_s'] / 1e9:.3f} GB/s to the host; paths "
          + ", ".join(f"B {r['width']} {r['path']} ({r['prewarm_ms']:.1f} "
                      f"ms)" for r in cm["rungs"])
          + f"; capacity {lrec['capacity_qps']:.1f} qps, at 0.5 of it "
          f"p50 {lrow['p50_ms']} p99 {lrow['p99_ms']} ms over "
          f"{lrow['requests']} requests; launches {launches}; wall "
          f"{time.perf_counter() - t0:.1f} s")
    check(cm["calibrate"] and all(
        np.isfinite(c[key]) and c[key] > 0
        for key in ("walk_ns", "spmv_ns_per_edge", "d2h_bytes_per_s")),
        f"[serving:calibrate] constants {c}")
    check(lrow["requests"] > 0 and lrow["p50_ms"] <= lrow["p99_ms"],
          f"[serving:calibrate] row {lrow}")
    check(launches["k3"] > 0 and launches["k0"] == 1,
          f"[serving:calibrate] launches {launches}: no K3, or K0 not once")
    check_sweep_passes("serving:calibrate", launches, annealed=any(
        r["path"] == "annealed" for r in cm["rungs"]))
    return launches, {"constants": c, "rungs": cm["rungs"], "row": lrow}


def sweep_finalize_cases(dev, b: int, counts, sums, eps_f: float,
                         n_rows: int) -> None:
    """``ppr_sweep_finalize`` on the pass kernels' partial counts and sums
    against ``sweep_finalize_ref`` on their column totals, from fresh
    states: an unsettled sweep, settled ones that anneal, finish by the
    count and finish at ``min_delta``, and a frozen one; ``delta``,
    ``finished`` and ``it`` equal bit for bit, and the cases reach each
    outcome."""
    import torch

    from ppr_tpu_torch.ops import sweep_pass

    largest = float(sums.sum(dim=0).max())
    low, high = largest / eps_f / 2, largest / eps_f * 2
    never = n_rows + 1                 # more than any column can count
    outcomes = set()
    for delta, frozen, k, min_delta in (
            (low, False, never, low / 64), (high, False, never, high / 64),
            (high, False, K, high / 64), (high, False, never, high),
            (high, True, never, high / 64)):
        want, got = (sweep_pass.LoopState.start(delta, dev)
                     for _ in range(2))
        want.finished.fill_(frozen)
        got.finished.fill_(frozen)
        kw = dict(k=k, eps=eps_f, min_delta=float(np.float32(min_delta)))
        sweep_pass.sweep_finalize_ref(want, counts.sum(dim=0),
                                      sums.sum(dim=0), **kw)
        sweep_pass.sweep_finalize(got, counts, sums, **kw)
        same = (torch.equal(got.delta, want.delta)
                and torch.equal(got.finished, want.finished)
                and torch.equal(got.it, want.it))
        check(same, f"[loop:sweep] B {b}: the finalize kernel differs from "
              f"its plain version at delta {delta:.3e}, frozen {frozen}, k "
              f"{k}: delta {float(got.delta)!r} / {float(want.delta)!r}, "
              f"finished {bool(got.finished)} / {bool(want.finished)}, it "
              f"{int(got.it)} / {int(want.it)}")
        outcomes.add((bool(want.finished), float(want.delta) != delta,
                       int(want.it)))
    check(len(outcomes) == 4, f"[loop:sweep] B {b}: the finalize cases "
          f"reached {sorted(outcomes)}, not the four outcomes")
    print(f"[loop:sweep] B {b}: finalize equal bit for bit in delta, "
          f"finished and it on 5 cases (unsettled, annealed, done, at "
          f"min_delta, frozen)")


def sweep_pass_phase(dev, n_rows: int = 80640) -> dict:
    """``[loop:sweep]``: the annealed loop's fused passes
    (``ops/sweep_pass.py``) against their plain versions at the flickr
    cell's state (80,640 rows; B 2,048 and 256; a bf16 hub operand): each
    kernel's outputs held to the plain version's bits (the column sums to
    f32 reassociation, the counts exactly; the finalize by
    :func:`sweep_finalize_cases`), then the median of 10
    CUDA-event-timed calls of each beside the plain sequence's and its
    byte bound (4.5 passes over the state for the pre pass, 1 for the
    post pass, at 3.35 TB/s); the launch counts last."""
    import torch

    from ppr_tpu_torch.models.fora import _loop_constants
    from ppr_tpu_torch.ops import sweep_pass
    from ppr_tpu_torch.ops.spmv import _safe_inv_deg

    alpha_f, keep, eps_f, ts = _loop_constants(ALPHA, EPS / 2)
    rng = np.random.default_rng(0)
    before = (sweep_pass.pre_launches, sweep_pass.post_launches,
              sweep_pass.finalize_launches)
    out = {}
    for b in (2048, 256):
        def draw():
            x = rng.random((n_rows, b), dtype=np.float32) * (2.0 / n_rows)
            return torch.as_tensor(x, device=dev)

        p, r, pushed = draw(), draw(), draw()
        inv = _safe_inv_deg(torch.as_tensor(
            rng.integers(0, 300, n_rows).astype(np.int32), device=dev))
        src = torch.as_tensor(rng.integers(0, n_rows, b).astype(np.int32),
                              device=dev)
        dang = (r[:64] * keep).sum(dim=0)
        state = sweep_pass.LoopState.start(1.0 / n_rows, dev)
        kw = dict(alpha=alpha_f, keep=keep, thresh_scale=ts, bf16=True)

        want = sweep_pass.sweep_pre_ref(p, r, state, inv, **kw)
        got = sweep_pass.sweep_pre(p.clone(), r, state, inv, **kw)
        check(all(torch.equal(x, y) for x, y in zip(got[:3], want[:3]))
              and torch.equal(got[3].reshape(-1, b).sum(dim=0).long(),
                              want[3].long()),
              f"[loop:sweep] B {b}: the pre kernel differs from its plain "
              "version")
        want_r, want_s = sweep_pass.sweep_post_ref(pushed.clone(), r, src,
                                                   dang, state)
        got_r, got_s = sweep_pass.sweep_post(pushed.clone(), r, src, dang,
                                             state)
        _, again = sweep_pass.sweep_post(pushed.clone(), r, src, dang, state)
        sum_err = float(((got_s.reshape(-1, b).sum(dim=0) - want_s).abs()
                         / want_s.abs().clamp_min(1e-30)).max())
        check(torch.equal(got_r, want_r) and torch.equal(got_s, again)
              and sum_err < 1e-5,
              f"[loop:sweep] B {b}: the post kernel differs from its plain "
              f"version (sums {sum_err:.2e})")
        counts, sums = got[3], got_s
        sweep_finalize_cases(dev, b, counts, sums, eps_f, n_rows)

        def fin():
            sweep_pass.sweep_finalize(state, counts, sums, k=K, eps=eps_f,
                                      min_delta=1.0 / n_rows)

        pass_bytes = n_rows * b * 4.0
        row = {
            "pre_ms": cuda_ms(lambda: sweep_pass.sweep_pre(p, r, state, inv,
                                                           **kw)),
            "pre_plain_ms": cuda_ms(lambda: sweep_pass.sweep_pre_ref(
                p, r, state, inv, **kw)),
            "pre_bound_ms": 4.5 * pass_bytes / 3.35e12 * 1e3,
            "post_ms": cuda_ms(lambda: sweep_pass.sweep_post(
                pushed, r, src, dang, state)),
            "post_plain_ms": cuda_ms(lambda: sweep_pass.sweep_post_ref(
                pushed, r, src, dang, state)),
            "post_bound_ms": pass_bytes / 3.35e12 * 1e3,
            "finalize_ms": cuda_ms(fin),
            "sum_rel_err": sum_err,
        }
        out[b] = row
        print(f"[loop:sweep] B {b}: equal bit for bit (column sums within "
              f"{sum_err:.1e}, the same bits twice); pre "
              f"{row['pre_ms']:.4f} ms (plain {row['pre_plain_ms']:.4f}, "
              f"bound {row['pre_bound_ms']:.4f}, 4.5 passes), post "
              f"{row['post_ms']:.4f} ms (plain {row['post_plain_ms']:.4f}, "
              f"bound {row['post_bound_ms']:.4f}, 1 pass), finalize "
              f"{row['finalize_ms']:.4f} ms (median of 10, one call "
              "between events)")
    launches = (sweep_pass.pre_launches - before[0],
                sweep_pass.post_launches - before[1],
                sweep_pass.finalize_launches - before[2])
    print(f"[loop:sweep] launches: pre {launches[0]}, post {launches[1]}, "
          f"finalize {launches[2]}")
    out["launches"] = launches
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the smoke runs only on a card",
              file=sys.stderr)
        return 1

    from ppr_tpu_torch.cli import load_dataset
    from ppr_tpu_torch.device import set_exact_f32_matmul
    from ppr_tpu_torch import native
    from ppr_tpu_torch.graph.io import (load_default, synthetic_powerlaw,
                                        synthetic_weighted)
    from ppr_tpu_torch.models.config import AlgoConf
    from ppr_tpu_torch.models.power_method import power_method_batch
    from ppr_tpu_torch.ops import cuda_build, dense_power, probe
    from ppr_tpu_torch.service import PPRService

    dev = torch.device("cuda")
    set_exact_f32_matmul()
    card = card_line()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}")

    # --- 2. build: one nvcc per source, started together; K3's builds
    # with parts switched off run beside them --------------------------------
    t0 = time.perf_counter()
    import row_gather_ablation

    ablation_procs = row_gather_ablation.start_builds()
    sources_cu = ("dense_power", "probe", "row_gather", "sweep_pass")
    with ThreadPoolExecutor(len(sources_cu)) as pool:
        list(pool.map(cuda_build.load_library, sources_cu))
    print(f"[build] dense_power.cu (K1, K2), probe.cu (K0), row_gather.cu "
          f"(K3, P1-P4) and sweep_pass.cu (the annealed loop's passes): "
          f"{time.perf_counter() - t0:.2f} s")
    for name in sources_cu:
        secs, log = cuda_build.BUILD_INFO[name]
        print(f"[build] {name}.cu: nvcc {secs:.2f} s")
        for line in log.splitlines():
            entry = kernel_entry(line)
            if "entry function" in line and entry:
                print(f"[build] ptxas: {entry}")
            elif "registers" in line or "spill" in line:
                print(f"[build] ptxas: {line.strip()}")
    ablation_libs = row_gather_ablation.finish_builds(ablation_procs)

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
          "bound_ms": k0_bound, "bound_by": k0_by,
          **split_times(lambda: probe.double(x0), 1000, 1000)}
    k0["library_ms"] = k0["plain_ms"]
    lib = split_times(lambda: probe.double_ref(x0), 1000, 1000)
    k0.update(library_host_us=lib["host_us"],
              library_device_ms=lib["device_ms"])
    print(f"[k0] y = 2x on f32 {list(probe.SHAPE)}: equal bit for bit; "
          f"kernel {k0['ms']:.4f} ms, plain {k0['plain_ms']:.4f} ms "
          f"(median of 10, one call between events); host_us "
          f"{k0['host_us']:.2f} vs x * 2.0 {k0['library_host_us']:.2f} "
          f"(1000 un-synchronised calls); device_ms {k0['device_ms']:.5f} "
          f"vs {k0['library_device_ms']:.5f} (1000 launches in one CUDA "
          f"graph); bound_ms {k0_bound:.2e} ({k0_by})")

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
    sweep = sweep_pass_phase(dev)
    table = torch.rand((ds.graph.n_pad, 2048), device=dev)
    k3["ablation"] = row_gather_ablation.ablation(
        ablation_libs, "bench tail", table, hs.tail_src, hs.tail_ptr,
        flush=True, slabs=True)
    del table, ablation_libs

    # --- the walk engine and the cost model's constants --------------------
    walk_rates = walk_phase(dev, ds.graph)
    costs = calibrate_phase(dev, ds)

    # --- launch counts: the serving path from here on --------------------
    count_annealed_sweeps()
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
    annealed = algo._skip_push(EPS * 0.5, len(sources))
    print(f"[bench] B=2048 k={K} eps={EPS} H=4096 bf16: top_k "
          f"{dt * 1e3:.1f} ms = {len(sources) / dt:.1f} qps, sweeps "
          f"{sweeps} ({dt * 1e3 / sweeps:.2f} ms/sweep incl. epilogue), "
          f"warm-up call {warm_s:.2f} s, peak device memory {peak_gb:.2f} "
          f"GB; push={algo.push!r}: the cost model's path at B 2048 is "
          f"{'the annealed loop' if annealed else 'push+walks'}")
    check(annealed and costs["annealed"][2048],
          "[bench] the cost model left the annealed loop at B 2048")
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
    check_sweep_passes("bench", serving, annealed=True)

    # --- 8. where the time goes at the benchmark size ------------------
    profile_batch(algo, sources)

    # --- 9. the serving layer ---------------------------------------------
    layer = serving_layer(dev, ds, svc, sources, oracle, {
        "dt": dt, "sweeps": sweeps, "vals": vals, "ids": ids})

    # --- 10. the protocol path ---------------------------------------------
    protocol = protocol_path(dev, next(
        sh["ms"] for sh in k2["shapes"] if sh["case"] == "b128"))
    check(protocol["k3"] > 0, "K3 was not launched on the protocol path")
    # --- 10b. the protocol at the named datasets' scale ---------------------
    ds_proto, ds_proto_out = dataset_protocol_path(dev)

    # --- 11. the walk path ------------------------------------------------
    walks = walk_path(dev, ds, hs)

    # --- 12. weighted graphs and the Neo4j store -------------------------
    t0 = time.perf_counter()
    wds = synthetic_weighted(65536, 16, seed=42, dense_threshold=0,
                             device=dev)
    torch.cuda.synchronize()
    n, deg, seed = WEIGHTED_GRQC
    wgrqc = synthetic_weighted(n, deg, seed=seed, dense_threshold=0,
                               device=dev).graph
    print(f"[weighted] bench graph synthetic_weighted(65536, 16, seed=42): "
          f"n={wds.n} m={wds.graph.m} n_pad={wds.graph.n_pad}, weighted "
          f"{wds.graph.weighted}, built by the "
          f"{'native C++' if native.available() else 'numpy'} builder "
          f"(alias tables included) and placed on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    check(wds.graph.weighted and wds.graph.m == ds.graph.m,
          "[weighted] the weighted bench graph is not the bench graph's "
          "edges")
    builder_paths(ds.graph, wds.graph)
    k3c = weighted_k3_phase(dev, wds.graph, wgrqc)
    del wgrqc
    weighted = weighted_path(dev, wds, walk_rates[4])

    # --- 13. the mesh engines on one card --------------------------------
    mesh, k3_mesh = mesh_path(dev, ds, wds, sources, oracle)
    del wds
    # --- 14. the protocol on a mesh of the card ----------------------------
    mesh_proto, mesh_proto_out = mesh_protocol_path(dev, ds, sources, oracle)
    # --- 14b. the mesh across processes, ranks sharing this card ----------
    spanning, spanning_out = dist_path(dev, ds, sources, oracle)
    store = neostore_path(dev)
    # --- 15. the automatic hub count and the 1M cell ------------------------
    scale, scale_out = scale_path(dev, ds, sweeps)
    # --- 16. the sweep profile and the calibrated server -------------------
    sweep_prof, sweep_out = profile_sweep_path(dev, ds)
    cal, cal_out = serving_calibrate_path(ds)
    launches = {k: serving[k] + layer[k] + protocol[k] + ds_proto[k]
                + walks[k] + weighted[k] + mesh[k] + mesh_proto[k]
                + spanning[k] + store[k] + scale[k] + sweep_prof[k] + cal[k]
                for k in serving}
    print(f"[launches] serving path {serving}, serving layer {layer}, "
          f"protocol path {protocol}, dataset protocol path {ds_proto}, "
          f"walk path {walks}, weighted path "
          f"{weighted}, mesh path {mesh}, mesh protocol path {mesh_proto}, "
          f"mesh across processes (summed over its ranks) {spanning}, "
          f"store path {store}, scale path {scale}, sweep profile "
          f"{sweep_prof}, calibrated server {cal}")
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
        "host_us": k0["host_us"],
        "device_ms": k0["device_ms"],
        "library_host_us": k0["library_host_us"],
        "library_device_ms": k0["library_device_ms"],
        "shapes": [{"shape": list(probe.SHAPE), "ms": k0["ms"],
                    "plain_ms": k0["plain_ms"],
                    "bound_ms": k0["bound_ms"]}],
    }, {
        "name": "gather_segment_sum",
        "route": "cuda",
        "source": "ppr_tpu_torch/csrc/row_gather.cu",
        "replaces": "scripts/bench_pallas_row_gather.py:41",
        "replaces_mode": "gather_accum",
        "modes": ["segments", "segments_coef"],
        "launches": launches["k3"],
        "launches_coef": launches["k3_coef"],
        "launches_coef_weighted_path": weighted["k3_coef"],
        "max_abs_err": max(k3["max_abs_err"], k3c["max_abs_err"],
                           k3_mesh["max_abs_err"]),
        "ms": k3["ms"],
        "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"],
        "library_ms": k3["library_ms"],   # embedding_bag in sum mode
        "host_us": k3["host_us"],
        "device_ms": k3["device_ms"],
        "library_host_us": k3["library_host_us"],
        "library_device_ms": k3["library_device_ms"],
        "shapes": k3["shapes"],
        "ablation": k3["ablation"],
        "coef": {key: k3c[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "host_us", "device_ms", "library_host_us",
            "library_device_ms", "shapes")},
        "mesh": {"launches": mesh["k3"], "launches_coef": mesh["k3_coef"],
                 **{key: k3_mesh[key] for key in (
                     "max_abs_err", "ms", "plain_ms", "bound_ms",
                     "bound_by", "library_ms", "host_us", "device_ms",
                     "shapes", "engines")}},
        "mesh_protocol": {"launches": mesh_proto["k3"],
                          **mesh_proto_out},
        "dist": {"launches": spanning["k3"], **spanning_out},
        "dataset_protocol": {"launches": ds_proto["k3"], **ds_proto_out},
        "scale": {"launches": scale["k3"], **scale_out},
        "profile_sweep": {"launches": sweep_prof["k3"], **sweep_out},
        "serving_calibrate": {"launches": cal["k3"], **cal_out},
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
        "host_us": rg["host_us"],
        "device_ms": rg["device_ms"],
        "library_host_us": rg["library_host_us"],
        "library_device_ms": rg["library_device_ms"],
        "shapes": rg["shapes"],
    }, {
        "name": "sweep_pass",
        "route": "cuda",
        "source": "ppr_tpu_torch/csrc/sweep_pass.cu",
        "replaces": "none: the annealed loop's passes, fused by XLA on the "
                    "TPU",
        "launches": {"pre": launches["sweep_pre"],
                     "post": launches["sweep_post"],
                     "finalize": launches["sweep_fin"],
                     "sweeps": launches["sweeps"]},
        "path": "the annealed loop: FORA top-k's path on the card",
        "microbenchmark_launches": sweep["launches"],
        "shapes": {b: sweep[b] for b in (2048, 256)},
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-rank"]:
        sys.exit(dist_rank(sys.argv[2]))
    sys.exit(main())
