"""Communication model of the mesh engines — port of
``ppr_tpu/parallel/comm_model.py``.

A sweep of an engine on a ``(data, graph)`` mesh moves bytes between
devices and pushes edges on each; this module counts the first, prices
both with rates the caller measured, and measures the collective's share
of an edge-sharded sweep (:func:`measure_breakdown`).

Bytes a sweep, out of each device:

* **edge-sharded engines** (``sharded_fora``, ``sharded_allpair``,
  ``mesh_algos``): one ``psum`` of the ``[n_pad, B/data]`` partial sums
  over ``graph``; a ring all-reduce moves ``2 (S-1)/S * n_pad * B/data *
  4`` bytes (:func:`psum_bytes_per_sweep`).
* **node-sharded ring engines** (``node_sharded``, ``node_sharded_fora``,
  ``node_sharded_allpair``): ``S-1`` hops of ``[n_pad/S, B/data]`` chunks
  (:func:`ring_bytes_per_sweep`), about half the ``psum``'s at large S;
  half again with the bf16 ring, and a share ``C/64`` with frontier
  compaction (:func:`frontier_ring_bytes_per_sweep`).

Compute a sweep, a device: ``m/S`` edges at a measured cost an edge. No
rate has a default: :func:`predict_sweep` and :func:`two_host_prediction`
take the link's bytes a second and the ns an edge as arguments, and
:func:`main` measures both on the card (K3 over an edge chunk; a copy
between two cards when two are visible, else no link rate and no
efficiency).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..graph.csr import Graph
from .mesh import Mesh, psum
from .sharded import edge_chunks, put_columns


def psum_bytes_per_sweep(n_pad: int, b_local: int, s_graph: int,
                         payload_bytes: int = 4) -> int:
    """Ring all-reduce bytes out of each device a sweep (edge-sharded
    engines)."""
    if s_graph <= 1:
        return 0
    return int(2 * (s_graph - 1) / s_graph * n_pad * b_local * payload_bytes)


def ring_bytes_per_sweep(n_pad: int, b_local: int, s_graph: int,
                         payload_bytes: int = 4) -> int:
    """Ring bytes out of each device a sweep (node-sharded engines);
    ``payload_bytes=2`` prices the bf16 ring."""
    if s_graph <= 1:
        return 0
    n_local = n_pad // s_graph
    return int((s_graph - 1) * n_local * b_local * payload_bytes)


def frontier_ring_bytes_per_sweep(n_pad: int, b_local: int, s_graph: int,
                                  capacity_frac: float = 1.0,
                                  payload_bytes: int = 4,
                                  num_blocks: int = 64) -> int:
    """Ring bytes out of each device a sweep with frontier compaction
    (``frontier_blocks=C``): the values shrink to ``capacity_frac =
    C/num_blocks`` of the dense chunk, plus ``C`` int32 block ids a hop.
    The deferral adds sweeps, not bytes a sweep: price it with
    ``sweep_inflation`` in :func:`predict_sweep`."""
    if s_graph <= 1:
        return 0
    n_local = n_pad // s_graph
    vals = (s_graph - 1) * int(n_local * capacity_frac) * b_local \
        * payload_bytes
    ids = (s_graph - 1) * int(num_blocks * capacity_frac) * 4
    return vals + ids


@dataclasses.dataclass
class SweepPrediction:
    engine: str
    s_graph: int
    batch: int
    b_local: int
    payload_bytes: int
    comm_bytes: int
    t_comm_s: float
    t_compute_s: float
    t_sweep_s: float
    #: strong-scaling efficiency against one device: T(1) / (S * T(S))
    efficiency: float
    #: the upper bound: ring hops overlapped with the blocks' pushes,
    #: ``t = max(t_comm, t_compute)``; the serial number is the lower bound
    t_sweep_overlap_s: float = 0.0
    efficiency_overlap: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def predict_sweep(g: Graph, *, spmv_ns_per_edge: float,
                  link_bytes_per_s: float, engine: str = "edge_sharded",
                  s_graph: int = 2, s_data: int = 1, batch: int = 512,
                  payload_bytes: int = 4, capacity_frac: float = 1.0,
                  sweep_inflation: float = 1.0) -> SweepPrediction:
    """One propagation sweep on an ``s_data x s_graph`` mesh
    (``ppr_tpu/parallel/comm_model.py:124``). ``data`` moves nothing
    (independent query rows), so the ``graph`` axis sets the efficiency:
    the compute shrinks as ``m/S`` while the collective grows with the
    state's width. ``capacity_frac < 1`` prices the frontier-compacted
    ring; pass its measured ``sweep_inflation`` so the deferral's cost is
    inside the number."""
    b_local = max(1, batch // max(s_data, 1))
    if engine == "edge_sharded":
        comm = psum_bytes_per_sweep(g.n_pad, b_local, s_graph,
                                    payload_bytes)
    elif engine == "node_sharded":
        if capacity_frac < 1.0:
            comm = frontier_ring_bytes_per_sweep(
                g.n_pad, b_local, s_graph, capacity_frac, payload_bytes)
        else:
            comm = ring_bytes_per_sweep(g.n_pad, b_local, s_graph,
                                        payload_bytes)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    t_comm = comm / link_bytes_per_s
    t_compute_1 = g.m * spmv_ns_per_edge * 1e-9          # every edge, 1 dev
    t_compute = t_compute_1 / max(s_graph, 1)
    t_sweep = (t_compute + t_comm) * sweep_inflation
    t_overlap = max(t_compute, t_comm) * sweep_inflation
    devices = max(s_graph, 1)                             # a data group's
    eff = t_compute_1 / (devices * t_sweep)
    eff_ov = t_compute_1 / (devices * t_overlap) if t_overlap else 0.0
    return SweepPrediction(
        engine=engine, s_graph=s_graph, batch=batch, b_local=b_local,
        payload_bytes=payload_bytes, comm_bytes=comm, t_comm_s=t_comm,
        t_compute_s=t_compute, t_sweep_s=t_sweep, efficiency=eff,
        t_sweep_overlap_s=t_overlap, efficiency_overlap=min(eff_ov, 1.0))


def two_host_prediction(g: Graph, *, spmv_ns_per_edge: float,
                        link_bytes_per_s: float, batch: int = 512,
                        chips_per_host: int = 4,
                        frontier: dict | None = None) -> dict:
    """One host to two (``ppr_tpu/parallel/comm_model.py:178``): data
    parallel over the extra devices moves nothing between hosts
    (efficiency 1 but for dispatch); graph parallel puts the ``psum`` or
    the ring on the link whose rate is ``link_bytes_per_s``. ``frontier``
    (``capacity_frac``, ``sweep_inflation``) adds a frontier-compacted
    bf16 ring at that measured point."""
    rates = dict(spmv_ns_per_edge=spmv_ns_per_edge,
                 link_bytes_per_s=link_bytes_per_s)
    s1 = predict_sweep(g, engine="edge_sharded", s_graph=chips_per_host,
                       batch=batch, **rates)
    s2 = predict_sweep(g, engine="edge_sharded", s_graph=2 * chips_per_host,
                       batch=batch, **rates)
    n2 = predict_sweep(g, engine="node_sharded", s_graph=2 * chips_per_host,
                       batch=batch, **rates)
    n2_bf16 = predict_sweep(g, engine="node_sharded",
                            s_graph=2 * chips_per_host, batch=batch,
                            payload_bytes=2, **rates)
    n2_frontier = None
    if frontier is not None:
        n2_frontier = predict_sweep(
            g, engine="node_sharded", s_graph=2 * chips_per_host,
            batch=batch, payload_bytes=2,
            capacity_frac=float(frontier["capacity_frac"]),
            sweep_inflation=float(frontier.get("sweep_inflation", 1.0)),
            **rates)
    return {
        "graph": {"n_pad": int(g.n_pad), "m": int(g.m)},
        "batch": batch,
        "chips_per_host": chips_per_host,
        "data_parallel_2host": {
            "efficiency": 1.0,
            "note": "independent query rows; no cross-host collectives",
        },
        "graph_parallel_1host": s1.as_dict(),
        "graph_parallel_2host": s2.as_dict(),
        "node_sharded_2host": n2.as_dict(),
        "node_sharded_2host_bf16_ring": n2_bf16.as_dict(),
        "node_sharded_2host_frontier_bf16": (
            dict(n2_frontier.as_dict(),
                 capacity_frac=frontier["capacity_frac"],
                 sweep_inflation=frontier.get("sweep_inflation", 1.0))
            if n2_frontier is not None else None),
        "two_host_relative_efficiency": (
            s2.efficiency / s1.efficiency if s1.efficiency else 0.0),
        "assumptions": rates,
    }


def rank_frontier(g: Graph, candidates: list[dict], *, batch: int,
                  s_graph: int, spmv_ns_per_edge: float,
                  link_bytes_per_s: float) -> list[dict]:
    """The measured (capacity, inflation) points of ``candidates`` (a
    ring-occupancy artifact's ``empirical.frontier`` entries), fastest
    modelled sweep first: a frontier-compacted bf16 ring over ``s_graph``
    devices (``ppr_tpu/parallel/comm_model.py:364-378``)."""
    def t_sweep(f):
        return predict_sweep(
            g, engine="node_sharded", s_graph=s_graph, batch=batch,
            payload_bytes=2, capacity_frac=f["capacity_frac"],
            sweep_inflation=f["sweep_inflation"],
            spmv_ns_per_edge=spmv_ns_per_edge,
            link_bytes_per_s=link_bytes_per_s).t_sweep_s
    return sorted(candidates, key=t_sweep)


def measure_breakdown(mesh: Mesh, g: Graph, *, alpha: float = 0.15,
                      batch: int = 64, num_sweeps: int = 16,
                      iters: int = 5) -> dict:
    """The measured collective share of an edge-sharded sweep
    (``ppr_tpu/parallel/comm_model.py:253``): ``num_sweeps`` sweeps (each
    chunk's push through K3, then ``psum`` over ``graph``) timed beside
    the same sweeps without the ``psum`` (numerically wrong on purpose:
    the same pushes, no collective). On distinct cards the difference is
    the collective's time; on one device repeated it is the cost of the
    adds and copies ``psum`` makes there, and no link is measured."""
    keep = float(np.float32(1.0) - np.float32(alpha))
    chunks = edge_chunks(g, mesh)
    rng = np.random.default_rng(0)
    r0 = put_columns(mesh, torch.from_numpy(
        rng.random((g.n_pad, batch)).astype(np.float32)))

    def sweeps(with_psum: bool):
        r = [list(row) for row in r0]
        for _ in range(num_sweeps):
            for d, row in enumerate(chunks):
                parts = [ch.push(r[d][s]) for s, ch in enumerate(row)]
                if with_psum:
                    parts = psum(parts)
                r[d] = [keep * x for x in parts]
        return r

    timings = {}
    for name, with_psum in (("full", True), ("local_only", False)):
        sweeps(with_psum)                 # warm-up
        mesh.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            sweeps(with_psum)
            mesh.synchronize()
        timings[name] = (time.perf_counter() - t0) / iters / num_sweeps
    t_full, t_local = timings["full"], timings["local_only"]
    distinct = mesh.unique_devices()
    return {
        "mesh": mesh.shape,
        "batch": batch,
        "num_sweeps": num_sweeps,
        "t_sweep_full_s": t_full,
        "t_sweep_local_only_s": t_local,
        "collective_s": max(0.0, t_full - t_local),
        "collective_fraction": (max(0.0, 1.0 - t_local / t_full)
                                if t_full > 0 else 0.0),
        "platform": distinct[0].type,
        "distinct_devices": len(distinct),
        "model_psum_bytes": psum_bytes_per_sweep(
            g.n_pad, max(1, batch // mesh.data), mesh.graph),
    }


def measure_spmv_ns_per_edge(g: Graph, batch: int, reps: int = 10) -> float:
    """Nanoseconds an edge of one push of a ``[n_pad, batch]`` table over
    half the destination-sorted edges (the first chunk of a 1x2 mesh), on
    the graph's device: K3 between CUDA events with L2 flushed first on
    the card, the plain version on the CPU's clock."""
    dev = g.device
    mesh = Mesh([[dev, dev]])
    ch = edge_chunks(g, mesh)[0][0]
    table = torch.rand((g.n_pad, batch), device=dev)
    edges = int(ch.src.shape[0])
    if dev.type == "cuda":
        from ..utils.cuda_timing import cuda_ms, l2_flusher

        ms = cuda_ms(lambda: ch.gather(table), runs=reps,
                     before=l2_flusher(dev))
    else:
        ch.gather(table)
        t0 = time.perf_counter()
        for _ in range(reps):
            ch.gather(table)
        ms = (time.perf_counter() - t0) / reps * 1e3
    return ms * 1e6 / edges


def measure_link_bytes_per_s(n_pad: int, b_local: int,
                             reps: int = 10) -> float | None:
    """Bytes a second of a ``[n_pad, b_local]`` f32 copy from card 0 to
    card 1 (the median of ``reps``), or ``None`` with fewer than two cards
    visible."""
    if torch.cuda.device_count() < 2:
        return None
    src = torch.rand((n_pad, b_local), device="cuda:0")
    dst = torch.empty_like(src, device="cuda:1")
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        t0 = time.perf_counter()
        dst.copy_(src)
        torch.cuda.synchronize(0)
        torch.cuda.synchronize(1)
        times.append(time.perf_counter() - t0)
    return src.numel() * 4 / float(np.median(times[1:]))


def main(argv=None) -> int:
    """``python -m ppr_tpu_torch.parallel.comm_model``: the bytes a sweep
    of each engine, K3's rate measured on this machine, the link's
    (measured or given) and, when a link rate is known, the two-host
    prediction, as one JSON object. ``--frontier-json`` adds the
    frontier-compacted ring priced at the measured (capacity, inflation)
    point of a ring-occupancy artifact (``ring_occupancy_torch.py``)
    whose modelled sweep is fastest."""
    import argparse
    import json

    from ..device import resolve_device
    from ..graph.io import synthetic_powerlaw
    from .mesh import make_mesh

    ap = argparse.ArgumentParser(prog="ppr_tpu_torch.parallel.comm_model")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--deg", type=int, default=8)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--chips-per-host", type=int, default=4)
    ap.add_argument("--measure", action="store_true",
                    help="also time the edge engine's sweep with and "
                         "without its psum: over the visible cards when "
                         "two or more are visible, else on a 2x2 mesh of "
                         "the one device repeated")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--link-bytes-per-s", type=float, default=None,
                    help="the link's rate (default: measured between two "
                         "cards; none with fewer)")
    ap.add_argument("--frontier-json", default=None,
                    help="ring-occupancy artifact (ring_occupancy_torch."
                         "py); the prediction adds a frontier-compacted "
                         "ring priced at the measured capacity and "
                         "inflation that minimise the modelled sweep")
    ap.add_argument("--frontier-graph", default=None,
                    help="graph key inside --frontier-json (default: "
                         "synth:<n>x<deg>@<seed>)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds = synthetic_powerlaw(args.n, args.deg, seed=args.seed,
                            dense_threshold=0, device=dev)
    g = ds.graph
    out = {"device": {"type": dev.type,
                      "name": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": (torch.cuda.device_count()
                                if dev.type == "cuda" else 1)},
           "graph": {"n_pad": int(g.n_pad), "m": int(g.m)},
           "batch": args.batch}
    out["bytes_per_sweep"] = {
        f"graph={s}": {
            "edge_psum": psum_bytes_per_sweep(g.n_pad, args.batch, s),
            "node_ring": ring_bytes_per_sweep(g.n_pad, args.batch, s),
            "node_ring_bf16": ring_bytes_per_sweep(g.n_pad, args.batch, s,
                                                   payload_bytes=2),
            "node_ring_frontier_16_64_bf16": frontier_ring_bytes_per_sweep(
                g.n_pad, args.batch, s, 0.25, payload_bytes=2)}
        for s in (args.chips_per_host, 2 * args.chips_per_host)}
    ns_edge = measure_spmv_ns_per_edge(g, args.batch)
    link = args.link_bytes_per_s
    if link is None and dev.type == "cuda":
        link = measure_link_bytes_per_s(g.n_pad, args.batch)
    out["spmv_ns_per_edge"] = ns_edge
    out["link_bytes_per_s"] = link
    frontier = None
    if args.frontier_json:
        with open(args.frontier_json) as f:
            occ = json.load(f)
        key = args.frontier_graph or f"synth:{args.n}x{args.deg}@{args.seed}"
        cands = occ["graphs"][key]["empirical"]["frontier"]
        if link is not None:
            cands = rank_frontier(
                g, cands, batch=args.batch,
                s_graph=2 * args.chips_per_host, spmv_ns_per_edge=ns_edge,
                link_bytes_per_s=link)
            frontier = dict(cands[0], source=args.frontier_json,
                            measured_graph=key)
        out["frontier_candidates_measured"] = cands
    out["prediction"] = None if link is None else two_host_prediction(
        g, batch=args.batch, chips_per_host=args.chips_per_host,
        spmv_ns_per_edge=ns_edge, link_bytes_per_s=link, frontier=frontier)
    if args.measure:
        count = torch.cuda.device_count() if dev.type == "cuda" else 0
        mesh = (make_mesh(count) if count >= 2 else
                make_mesh(4, data=2, graph=2, devices=[dev] * 4))
        out["measured_breakdown"] = measure_breakdown(
            mesh, g, batch=min(args.batch, 64))
    print(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
