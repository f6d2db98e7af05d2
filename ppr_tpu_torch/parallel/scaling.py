"""Query throughput at 1 -> N devices — port of
``ppr_tpu/parallel/scaling.py``.

:func:`scaling_sweep` times the fixed-schedule edge-sharded FORA step
(:func:`~.sharded.sharded_fora_step`) on meshes of growing size, and
:func:`engine_scaling_sweep` the end-to-end :class:`~.sharded_fora.
ShardedForaTopk` at a fixed total batch (strong scaling). Each row names
its devices: on distinct cards the rows measure scaling; on one device
repeated (``devices=["cuda:0"] * 4``, or the CPU) every mesh shares the
same silicon, so the rows measure the cost of the partition (more launches,
the sums of ``psum``) and no link, and carry ``"proxy": true``.

Usage: ``python -m ppr_tpu_torch.parallel.scaling [--n N] [--deg D]
[--devices 1,2,4] [--engine] [--device cuda|cpu]``; on the card it takes
the visible cards and repeats card 0 when fewer are visible than the
largest count.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..graph.csr import Graph
from .mesh import Mesh, make_mesh
from .sharded import sharded_fora_step


def _mesh_note(mesh: Mesh) -> dict:
    """Where a row ran: its distinct devices, and whether it is a proxy
    (a device repeated, or the CPU) rather than a scaling measurement."""
    distinct = mesh.unique_devices()
    proxy = len(distinct) < mesh.size or distinct[0].type == "cpu"
    return {"mesh": mesh.shape, "device_type": distinct[0].type,
            "distinct_devices": len(distinct), "proxy": proxy}


def _default_counts(devices) -> list[int]:
    """Powers of two up to the device count (the visible cards' when
    ``devices`` is ``None``)."""
    n = torch.cuda.device_count() if devices is None else len(devices)
    return [d for d in (1, 2, 4, 8) if d <= n]


def scaling_sweep(g: Graph, device_counts: list[int] | None = None, *,
                  alpha: float = 0.15, num_sweeps: int = 4,
                  walkers_per_row: int = 256, iters: int = 5,
                  devices=None) -> list[dict]:
    """Steps a second of :func:`~.sharded.sharded_fora_step` on
    ``make_mesh(nd, devices=devices)`` for each ``nd`` of
    ``device_counts`` (default: powers of two up to the device count);
    ``devices=None`` takes the visible cards and raises without enough.
    ``efficiency`` is the JAX package's: queries/s over the smallest
    mesh's queries/s a device times ``nd``; ``overhead_vs_first`` the time
    a step over the first row's."""
    if device_counts is None:
        device_counts = _default_counts(devices)
    results = []
    base_qps = t_first = None
    for nd in device_counts:
        mesh = make_mesh(nd, devices=devices)
        step, example = sharded_fora_step(mesh, g, alpha,
                                          num_sweeps=num_sweeps,
                                          walkers_per_row=walkers_per_row)
        step(*example)                     # warm-up: builds, allocator
        mesh.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step(*example)
            mesh.synchronize()
        dt = (time.perf_counter() - t0) / iters
        b = sum(row[0].shape[1] for row in example[1])
        qps = b / dt
        if base_qps is None:
            base_qps, t_first = qps / nd, dt
        results.append({
            "devices": nd, "batch": b, "steps_per_sec": 1.0 / dt,
            "queries_per_sec": qps, "efficiency": qps / (base_qps * nd),
            "overhead_vs_first": dt / t_first, **_mesh_note(mesh)})
    return results


def engine_scaling_sweep(ds, device_counts: list[int] | None = None, *,
                         alpha: float = 0.15, k: int = 10, eps: float = 0.5,
                         batch: int = 32, iters: int = 3,
                         devices=None) -> list[dict]:
    """End-to-end :class:`~.sharded_fora.ShardedForaTopk` queries a second
    at a fixed total ``batch``, on meshes of ``device_counts`` (ascending,
    from 1). On distinct cards ``queries_per_sec`` should grow with the
    devices; on a proxy row (one device repeated) the total silicon is
    fixed, so ``overhead_vs_1dev = t(N) / t(1)`` is the number to read,
    and ``efficiency`` is ``t(1) / t(N)``."""
    from .sharded_fora import ShardedForaTopk

    if device_counts is None:
        device_counts = _default_counts(devices)
    if device_counts != sorted(device_counts) or device_counts[0] != 1:
        # overhead_vs_1dev and efficiency are defined against the 1-device
        # row; another first row would mislabel them
        raise ValueError(f"device_counts must be ascending and start at 1, "
                         f"got {device_counts}")
    sources = np.random.default_rng(11).integers(
        0, ds.graph.n, size=batch).astype(np.int32)
    results = []
    t_base = None
    for nd in device_counts:
        mesh = make_mesh(nd, devices=devices)
        engine = ShardedForaTopk(ds, alpha=alpha, k=k, mesh=mesh)
        engine.compute_topk_ids_batch(sources, k, eps)    # warm-up
        t0 = time.perf_counter()
        for _ in range(iters):
            engine.compute_topk_ids_batch(sources, k, eps)
        dt = (time.perf_counter() - t0) / iters
        if t_base is None:
            t_base = dt
        note = _mesh_note(mesh)
        results.append({
            "sweep": "engine_strong", "devices": nd, "batch": batch,
            "queries_per_sec": batch / dt, "time_per_batch_s": dt,
            "sweeps": engine.last_iters, "overhead_vs_1dev": dt / t_base,
            "efficiency": t_base / (dt * (1 if note["proxy"] else nd)),
            **note})
    return results


def main(argv=None) -> int:
    """``python -m ppr_tpu_torch.parallel.scaling``: one JSON line a row."""
    import argparse
    import json

    from ..device import resolve_device
    from ..graph.io import synthetic_powerlaw

    ap = argparse.ArgumentParser(prog="ppr_tpu_torch.parallel.scaling")
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--deg", type=int, default=8)
    ap.add_argument("--devices", default="1,2,4",
                    help="comma list of mesh sizes, e.g. 1,2,4,8")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--engine", action="store_true",
                    help="also sweep the end-to-end ShardedForaTopk engine")
    ap.add_argument("--batch", type=int, default=32,
                    help="fixed total query batch for the engine sweep")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default): the visible cards, card 0 "
                         "repeated when fewer than the largest mesh; cpu: "
                         "CPU devices (a proxy)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    counts = [int(x) for x in args.devices.split(",")]
    if dev.type == "cpu":
        devices = [dev] * max(counts)
    else:
        cards = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
        devices = cards if len(cards) >= max(counts) \
            else [cards[0]] * max(counts)
    ds = synthetic_powerlaw(args.n, args.deg, seed=3, dense_threshold=0,
                            device=devices[0])
    for row in scaling_sweep(ds.graph, counts, iters=args.iters,
                             devices=devices):
        print(json.dumps(row))
    if args.engine:
        for row in engine_scaling_sweep(ds, counts, batch=args.batch,
                                        iters=args.iters, devices=devices):
            print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
