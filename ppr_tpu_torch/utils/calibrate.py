"""Cost constants of FORA's push / walk / propagation balance, measured —
port of ``ppr_tpu/utils/calibrate.py``.

The reference bakes in 400 ns a walk, measured on its JVM
(Fora_Whole_Graph.java:35). :func:`measure` times a walk and an edge of a
propagation sweep on the graph's device, and the rate of a copy to the
host, in the format of ``models/fora._default_cost_constants``;
:func:`apply` installs them on a FORA algorithm; :func:`constants` reads
them back. On the card every timed region ends in
``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..device import synchronize
from ..graph.csr import Graph
from ..ops.spmv import push_out
from ..ops.walk import weighted_walk_counts


def measure(g: Graph, *, alpha: float = 0.15, walkers: int = 1 << 16,
            batch: int = 32, reps: int = 3, seed: int = 0):
    """``(walk_ns_per_walk, spmv_ns_per_edge, True, d2h_bytes_per_s)``.

    A walk: ``walkers`` walks from random starts through
    ``weighted_walk_counts``, ``reps`` times after one untimed call. An
    edge: ``push_out`` of a ``[batch, n_pad]`` operand, per edge of the
    graph and per call (the whole batch shares it, hence ``True``). The
    copy: ``min(batch, 8)`` rows of the push's result to the host, a
    second slice after an untimed first one, so the path is warm."""
    dev = g.device
    rng = np.random.default_rng(seed)
    starts = torch.as_tensor(rng.integers(0, g.n, walkers), dtype=torch.int32,
                             device=dev)
    rows = torch.zeros(walkers, dtype=torch.int64, device=dev)
    weights = torch.full((walkers,), 1.0 / walkers, dtype=torch.float32,
                         device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    weighted_walk_counts(g, starts, rows, weights, gen, alpha, num_rows=1)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        weighted_walk_counts(g, starts, rows, weights, gen, alpha,
                             num_rows=1)
    synchronize(dev)
    walk_ns = (time.perf_counter() - t0) / reps / walkers * 1e9

    a = torch.as_tensor(rng.random((batch, g.n_pad), np.float32),
                        device=dev) * g.node_mask
    out = push_out(g, a)
    synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = push_out(g, a)
    synchronize(dev)
    spmv_ns_per_edge = (time.perf_counter() - t0) / reps / max(g.m, 1) * 1e9

    # two distinct slices, both computed before the clock starts; the
    # first copy warms the path, the second is timed
    h = min(batch, 8)
    warm_probe, probe = out[:h].contiguous(), out[h:2 * h].contiguous()
    synchronize(dev)
    warm_probe.cpu()
    t0 = time.perf_counter()
    host = probe.cpu()
    d2h_bytes_per_s = host.numel() * 4 / max(time.perf_counter() - t0, 1e-9)

    return walk_ns, spmv_ns_per_edge, True, d2h_bytes_per_s


def apply(algo, constants) -> None:
    """Install measured constants on a FORA algorithm: the 3-tuple ``(walk,
    spmv, amortized)`` or the 4-tuple of :func:`measure`, which adds the
    rate of a copy to the host."""
    (algo.avg_rand_walk_time_ns, algo.spmv_ns_per_edge,
     algo.spmv_batch_amortized) = constants[:3]
    if len(constants) > 3:
        algo.d2h_bytes_per_s = constants[3]


def constants(algo) -> dict:
    """The cost constants a FORA algorithm holds, by name."""
    return {"walk_ns": float(algo.avg_rand_walk_time_ns),
            "spmv_ns_per_edge": float(algo.spmv_ns_per_edge),
            "spmv_batch_amortized": bool(algo.spmv_batch_amortized),
            "d2h_bytes_per_s": float(algo.d2h_bytes_per_s)}
