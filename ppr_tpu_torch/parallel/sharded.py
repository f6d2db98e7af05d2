"""Edge-sharded push and walks on a ``(data, graph)`` mesh — port of
``ppr_tpu/parallel/sharded.py``.

* ``data``: the query batch. The node-major ``[n_pad, B]`` state is split
  into ``data`` column blocks, each its own contiguous ``[n_pad, B/data]``
  tensor, so K3 gathers whole rows of it.
* ``graph``: the destination-sorted edge list is cut into ``graph``
  contiguous chunks (:func:`edge_chunks`). A chunk of sorted edges is
  sorted, so each shard's share of a push is K3 over its chunk with the
  row pointer clamped to it (:class:`EdgeChunk`), and :func:`~.mesh.psum`
  over ``graph`` completes the push. Node vectors are replicated along
  ``graph``: every shard of a data row holds the row's whole state and
  applies the same elementwise steps, as every device of the JAX program
  does.
* Walks split the walker pool over ``graph``: each shard walks its own
  walkers over a replica of the CSR, and the stop counts are summed over
  ``graph``.

:func:`run_annealed` is the loop control of both FORA top-k mesh engines:
the single-device port's (``models/fora.py``), with its flags combined
over the mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import Graph, graph_from_numpy
from ..models.fora import CHECK_EVERY, _loop_constants
from ..ops.spmv import _safe_inv_deg, gather_segment_sum
from ..ops.walk import weighted_walk_counts
from . import mesh as mesh_mod
from .mesh import Mesh, is_remote, psum

_GRAPH_FIELDS = ("indptr", "indices", "edge_src", "edge_dst", "edge_mask",
                 "edge_src_bydst", "edge_dst_bydst", "out_deg", "in_deg",
                 "node_mask", "edge_coef", "edge_coef_bydst", "alias_prob",
                 "alias_other")


def host_arrays(g: Graph) -> dict:
    """The graph's arrays on the host, keyed as ``graph_from_numpy`` takes
    them (no dense operator: the mesh pushes are all sparse)."""
    out = {f: getattr(g, f).cpu().numpy() for f in _GRAPH_FIELDS
           if getattr(g, f) is not None}
    out.update(n=g.n, m=g.m)
    return out


@dataclasses.dataclass
class EdgeChunk:
    """One ``graph`` shard's contiguous chunk ``[lo, hi)`` of the sorted
    edges and the node arrays its push needs, on the shard's device. Read
    by destination (:func:`edge_chunks`), ``src`` holds the edges' sources
    and ``ptr`` segments them by destination; read by source
    (:func:`edge_chunks_bysrc`), ``src`` holds their destinations and
    ``ptr`` segments them by source."""

    src: torch.Tensor            # int32[hi - lo], the rows K3 gathers
    ptr: torch.Tensor            # int64[n_pad + 1], clamped to the chunk
    coef: torch.Tensor | None    # f32[hi - lo] on a weighted graph
    inv_deg: torch.Tensor        # f32[n_pad]
    dang_ids: torch.Tensor       # int64[#dangling]
    out_deg: torch.Tensor        # int32[n_pad]

    def gather(self, table: torch.Tensor) -> torch.Tensor:
        """``out[v] = sum of coef[e] * table[src[e]]`` over the chunk's
        edges of segment ``v`` (``coef`` 1 on an unweighted graph): K3 on
        the card, its coefficient mode on a weighted graph."""
        return gather_segment_sum(table, self.src, self.ptr, coef=self.coef)

    def push(self, rem: torch.Tensor) -> torch.Tensor:
        """This chunk's share of ``push_out_t(rem)``: ``[n_pad, B]``."""
        if self.coef is None:
            return self.gather(rem * self.inv_deg[:, None])
        return self.gather(rem)


def _chunks(g: Graph, mesh: Mesh, rows, ptr, coef) -> list[list[EdgeChunk]]:
    """``[data][graph]`` chunks of ``m_pad`` edges sorted by segment:
    shard ``(d, s)`` holds chunk ``s`` of ``graph`` equal chunks (the JAX
    package's ``P("graph")`` split), replicated over ``data``."""
    out_deg = g.out_deg.cpu().numpy()
    inv_deg = _safe_inv_deg(g.out_deg.cpu()).numpy()
    dang = g.dang_ids.cpu().numpy()
    size = -(-g.m_pad // mesh.graph)

    def chunk(d, s, dev):
        lo, hi = min(s * size, g.m_pad), min((s + 1) * size, g.m_pad)

        def put(x):
            return torch.tensor(np.ascontiguousarray(x), device=dev)

        return EdgeChunk(
            src=put(rows[lo:hi]), ptr=put(np.clip(ptr, lo, hi) - lo),
            coef=None if coef is None else put(coef[lo:hi]),
            inv_deg=put(inv_deg), dang_ids=put(dang), out_deg=put(out_deg))

    return mesh.grid(chunk)


def edge_chunks(g: Graph, mesh: Mesh) -> list[list[EdgeChunk]]:
    """``[data][graph]`` chunks of the destination-sorted edges: K3 over a
    chunk gathers at the sources and sums by destination, the forward
    push (``ppr_tpu/parallel/sharded_fora.py:45``)."""
    return _chunks(g, mesh, g.edge_src_bydst.cpu().numpy(),
                   g.bydst_ptr.cpu().numpy(),
                   g.edge_coef_bydst.cpu().numpy() if g.weighted else None)


def edge_chunks_bysrc(g: Graph, mesh: Mesh) -> list[list[EdgeChunk]]:
    """``[data][graph]`` chunks of the source-sorted (primary) edges: K3
    over a chunk gathers at the destinations and sums by source, the
    reverse push (``ppr_tpu/parallel/sharded_allpair.py:41``). Padding
    edges sit on the sentinel node, whose residue is always zero."""
    return _chunks(g, mesh, g.edge_dst.cpu().numpy(),
                   g.bysrc_ptr.cpu().numpy(),
                   g.edge_coef.cpu().numpy() if g.weighted else None)


@dataclasses.dataclass
class GraphShard:
    """A shard of :func:`shard_graph`: a replica of the graph on the
    shard's device (its CSR for the walks, its node arrays) and the shard's
    edge chunk for the pushes."""

    graph: Graph
    chunk: EdgeChunk


def shard_graph(g: Graph, mesh: Mesh) -> list[list[GraphShard]]:
    """``[data][graph]`` shards of ``g``: node arrays and the CSR
    replicated, the destination-sorted edges in ``graph`` chunks
    (``ppr_tpu/parallel/sharded.py:58``)."""
    arrays = host_arrays(g)
    chunks = edge_chunks(g, mesh)
    return mesh.grid(lambda d, s, dev: GraphShard(
        graph_from_numpy(arrays, device=dev), chunks[d][s]))


def put_columns(mesh: Mesh, x_t):
    """``[data][graph]`` parts of a node-major ``x_t [n_pad, B]``: data
    shard ``d`` takes columns ``d*B/data ..`` as a contiguous tensor of
    its own on every device of its row."""
    x_t = torch.as_tensor(x_t)
    cols = mesh_mod.split(x_t.shape[1], mesh.data)
    return mesh.grid(lambda d, s, dev: x_t[:, cols[d]].contiguous()
                     .to(dev, copy=True))


def gather_columns(parts, mesh: Mesh | None = None) -> torch.Tensor:
    """The node-major ``[n_pad, B]`` of replicated column parts, on the
    host (graph shard 0 of each data row; every rank of a ``mesh`` across
    processes calls it and gets it)."""
    rows = [row[:1] for row in parts]
    if mesh is not None:
        rows = mesh_mod.fetch(mesh, rows)
    return torch.cat([row[0].cpu() for row in rows], dim=1)


def collect_rows(parts, device, mesh: Mesh | None = None) -> torch.Tensor:
    """Batch-major ``[B, n_pad]`` on ``device``, contiguous, from
    ``[data][graph]`` node-major parts: each data row's column block is
    its parts stacked in shard order (pass ``[row[:1] for row in parts]``
    where a row's parts are replicas). Across processes every rank of
    ``mesh`` calls it and gets the whole."""
    if mesh is not None:
        parts = mesh_mod.fetch(mesh, parts)
    cols = [torch.cat([x.to(device) for x in row], dim=0) for row in parts]
    return torch.cat(cols, dim=1).T.contiguous()


def onehot_t(sources: np.ndarray, n_pad: int, device) -> torch.Tensor:
    """Node-major one-hot ``[n_pad, B]`` of ``sources``, made on
    ``device``."""
    b = len(sources)
    out = torch.zeros((n_pad, b), dtype=torch.float32, device=device)
    out[torch.as_tensor(np.asarray(sources, np.int64), device=device),
        torch.arange(b, device=device)] = 1.0
    return out


def run_annealed(mesh: Mesh, sweep, stats, *, eps: float, delta0: float,
                 min_delta: float, alpha: float,
                 max_iters: int = 600) -> int:
    """The FORA top-k annealing loop over a mesh; returns its sweep count.

    ``sweep(live)`` advances every shard one sweep, ``live`` a bool scalar
    a device (``{device: tensor}``); a sweep with ``live`` false must leave
    the state as it was. ``stats(thresh)`` returns, for each data row, the
    row's largest column residue sum and whether every column of the row
    counts ``k`` reserves at or above ``thresh`` (0-dim tensors, for the
    rows this rank holds a shard of). The
    flags are combined on the mesh's first device (one ``pmax`` over
    ``data`` a sweep, across processes too) and handed to every device, so
    every shard runs the same sweeps; the host reads ``finished`` every
    ``CHECK_EVERY`` sweeps (across processes on gloo's host wire it also
    waits on the card at every ``pmax``), and the loop stops on the sweep
    of the JAX package's ``lax.while_loop``."""
    _, _, eps_f, thresh_scale = _loop_constants(alpha, eps)
    dev = mesh.controller
    delta = torch.tensor(delta0, dtype=torch.float32, device=dev)
    finished = torch.zeros((), dtype=torch.bool, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(max_iters):
        live = ~finished
        sweep(mesh_mod.broadcast(live, mesh))
        rsum, done = stats(mesh_mod.broadcast(thresh_scale * delta, mesh))
        # one collective: the largest residue sum, and min(done) as
        # -max(-done)
        flags = mesh_mod.pmax([torch.stack([x, -y.to(x.dtype)])
                               for x, y in zip(rsum, done)], mesh)[0]
        rsum_max, every = flags[0], flags[1] < 0
        settled = live & (rsum_max <= eps_f * delta)
        finished = finished | (settled & every) \
            | (settled & (delta <= min_delta))
        delta = torch.where(settled & ~finished,
                            torch.clamp_min(delta / 4.0, min_delta), delta)
        it = it + live.to(torch.int32)
        if (i + 1) % CHECK_EVERY == 0 and bool(finished):
            break
    return int(it)


def make_sharded_push_sweeps(mesh: Mesh, alpha: float, num_sweeps: int):
    """``run(gs, p, r, src_t, rmax) -> (p, r)``: ``num_sweeps`` forward
    push sweeps (``ppr_tpu/parallel/sharded.py:95-175``) on the shards
    ``gs`` of :func:`shard_graph`, with ``[data][graph]`` node-major state
    parts (:func:`put_columns`).

    A sweep: the frontier ``r/d >= rmax`` (a dangling node whenever ``r >
    0``) settles ``alpha`` of its residue, pushes the rest of the
    non-dangling residue along its chunk's edges (``psum`` over ``graph``)
    and returns the dangling rows' share to each column's source
    (Forward_Push.java:85-141)."""
    alpha_f, keep, _, _ = _loop_constants(alpha, 0.0)

    def run(gs, p, r, src_t, rmax):
        rmax_f = float(np.float32(rmax))
        p = [list(row) for row in p]
        r = [list(row) for row in r]
        for _ in range(num_sweeps):
            for d, shards in enumerate(gs):
                partials, acts, dangs = [], [], []
                for s, sh in enumerate(shards):
                    if is_remote(sh):
                        partials.append(sh)
                        acts.append(sh)
                        dangs.append(sh)
                        continue
                    g = sh.graph
                    deg = g.out_deg[:, None]
                    live = (g.node_mask > 0)[:, None]
                    dangling = (deg == 0) & live
                    r_ = r[d][s]
                    active = (((deg > 0) & (r_ >= rmax_f * deg.float()))
                              | (dangling & (r_ > 0))) & live
                    a = torch.where(active, r_, 0.0)
                    p[d][s] = p[d][s] + alpha_f * a
                    a_dang = torch.where(dangling, a, 0.0)
                    dangs.append(a_dang.sum(dim=0, keepdim=True))
                    acts.append(a)
                    partials.append(sh.chunk.push(keep * (a - a_dang)))
                pushed = psum(partials)
                for s, sh in enumerate(shards):
                    if not is_remote(sh):
                        r[d][s] = (r[d][s] - acts[s] + pushed[s]
                                   + (keep * dangs[s]) * src_t[d][s])
        return p, r

    return run


def make_sharded_walk_counts(mesh: Mesh, alpha: float,
                             max_steps: int = 128):
    """``call(gs, starts, weights, seed) -> counts``: walkers ``starts [B,
    W]`` (host arrays; rows split over ``data``, walkers over ``graph``)
    walk on each shard's CSR replica, walker ``j`` of row ``b`` deposits
    ``weights[b, j]`` at its stop node, and the counts are summed over
    ``graph``: ``[data][graph]`` node-major parts ``[n_pad, B/data]``
    (``ppr_tpu/parallel/sharded.py:178``). Each shard draws from a
    generator of its own (:func:`~.mesh.shard_generators`); on a weighted
    graph the move is the alias step."""

    def call(gs, starts, weights, seed: int):
        starts = np.asarray(starts, np.int32)
        weights = np.asarray(weights, np.float32)
        rows_of = mesh_mod.split(starts.shape[0], mesh.data)
        cols_of = mesh_mod.split(starts.shape[1], mesh.graph)
        gens = mesh_mod.shard_generators(mesh, seed)
        out = []
        for d, shards in enumerate(gs):
            parts = []
            for s, sh in enumerate(shards):
                if is_remote(sh):
                    parts.append(sh)
                    continue
                dev = sh.graph.device
                st = starts[rows_of[d], cols_of[s]]
                b_l, w_l = st.shape
                rows = torch.arange(b_l, device=dev).repeat_interleave(w_l)
                counts = weighted_walk_counts(
                    sh.graph, torch.as_tensor(st.reshape(-1), device=dev),
                    rows, torch.as_tensor(
                        weights[rows_of[d], cols_of[s]].reshape(-1),
                        device=dev),
                    gens[d][s], alpha, num_rows=b_l, max_steps=max_steps)
                parts.append(counts.T.contiguous())
            out.append(psum(parts))
        return out

    return call


def sharded_fora_step(mesh: Mesh, g: Graph, alpha: float = 0.15,
                      num_sweeps: int = 4,
                      walkers_per_row: int | None = None):
    """One FORA-style step on the mesh, push sweeps then a walk estimate
    of the residue (``ppr_tpu/parallel/sharded.py:274``). Returns ``(step,
    example)``: ``step(p, r, src_t, rmax, seed) -> (p + counts, r)`` over
    ``[data][graph]`` node-major parts, and example arguments."""
    b = max(mesh.data * 2, 2)
    if walkers_per_row is None:
        walkers_per_row = mesh.graph * 64
    gs = shard_graph(g, mesh)
    push = make_sharded_push_sweeps(mesh, alpha, num_sweeps)
    walk = make_sharded_walk_counts(mesh, alpha)
    sources = np.arange(b, dtype=np.int32) % g.n
    starts = np.broadcast_to(sources[:, None], (b, walkers_per_row))

    def step(p, r, src_t, rmax, seed):
        p, r = push(gs, p, r, src_t, rmax)
        rsum = gather_columns(r, mesh).sum(dim=0).numpy()
        weights = np.broadcast_to((rsum / walkers_per_row)[:, None],
                                  (b, walkers_per_row))
        counts = walk(gs, starts, weights, seed)
        # plain walks realise the alpha-stop at their origin, so the walk
        # estimate covers the whole residue
        return [[x if is_remote(x) else x + c for x, c in zip(prow, crow)]
                for prow, crow in zip(p, counts)], r

    src = onehot_t(sources, g.n_pad, "cpu")
    example = (put_columns(mesh, torch.zeros_like(src)),
               put_columns(mesh, src), put_columns(mesh, src), 1e-4, 0)
    return step, example
