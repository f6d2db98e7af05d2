"""BASE all-pair preprocessing with the node dimension sharded: the
reverse push in O(n/S) state a device — port of
``ppr_tpu/parallel/node_sharded_allpair.py``.

:class:`~.sharded_allpair.ShardedBackwardSearch` replicates the ``[n_pad,
T/data]`` state on every device of a data row. Here nodes are split into
``graph`` contiguous ranges of ``n_local = n_pad / graph``:

* shard ``(d, s)`` holds the node-major ``[n_local, T/data]`` reserve and
  residue of range ``s`` and every edge whose SOURCE ``u`` lies in it
  (:func:`partition_edges_by_src_dst`): the reverse step adds ``(1-alpha)
  r(v) / d_out(u)`` into ``u``, so its sums are local to the source's
  owner;
* each sweep the residue chunks travel the ``graph`` ring
  (:func:`~.node_sharded.ring_push`): at hop ``t`` shard ``s`` holds shard
  ``(s - t) mod S``'s chunk and pushes the block of its edges whose
  destinations lie there, one K3 launch a non-empty block (gather at the
  destination, sum by source; the coefficient mode on a weighted graph).

The strict gate, the mass dying at in-degree-0 frontier nodes and the
in-degree-0 target short-circuit are those of
:mod:`.sharded_allpair`; the "frontier non-empty" flag is combined over
both axes, so every shard runs the same sweeps.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..graph.csr import Graph
from ..ops.push import _f32, _run_sweeps
from ..ops.spmv import _safe_inv_deg
from . import mesh as mesh_mod
from .mesh import Mesh, is_remote, make_mesh
from .node_sharded import Block, _check_split, _devices, _lanes, \
    local_onehot, make_block, ring_push
from .sharded import collect_rows
from .sharded_allpair import MeshBaseAllPair
from .sharded_fora import pad_batch


def partition_edges_by_src_dst(g: Graph, num_shards: int):
    """``(src_local [S, S, E], dst_local [S, S, E], mask [S, S, E], coef
    [S, S, E] or None, n_local)``: block ``(d, s)`` holds the edges whose
    source (the reverse step's sum) lies in range ``d`` and destination
    (its gather) in range ``s``, both rebased, in source order; padding
    entries have mask 0, the range's last node as source and 0 as
    destination (``ppr_tpu/parallel/node_sharded_allpair.py:38``)."""
    n_local = _check_split(g, num_shards)
    src = g.edge_src.cpu().numpy()[: g.m]
    dst = g.edge_dst.cpu().numpy()[: g.m]
    coef = g.edge_coef.cpu().numpy()[: g.m] if g.weighted else None
    d_shard = src // n_local
    s_shard = dst // n_local
    counts = np.zeros((num_shards, num_shards), np.int64)
    np.add.at(counts, (d_shard, s_shard), 1)
    e_max = _lanes(int(counts.max()) if g.m else 0)
    src_out = np.full((num_shards, num_shards, e_max), n_local - 1,
                      np.int32)
    dst_out = np.zeros((num_shards, num_shards, e_max), np.int32)
    mask_out = np.zeros((num_shards, num_shards, e_max), np.float32)
    coef_out = (np.zeros((num_shards, num_shards, e_max), np.float32)
                if g.weighted else None)
    key = d_shard * num_shards + s_shard
    order = np.argsort(key, kind="stable")   # stable keeps source order
    sorted_key = key[order]
    blocks = np.arange(num_shards * num_shards)
    starts = np.searchsorted(sorted_key, blocks)
    ends = np.searchsorted(sorted_key, blocks, side="right")
    for d in range(num_shards):
        for s in range(num_shards):
            blk = order[starts[d * num_shards + s]:ends[d * num_shards + s]]
            cnt = len(blk)
            src_out[d, s, :cnt] = src[blk] - d * n_local
            dst_out[d, s, :cnt] = dst[blk] - s * n_local
            mask_out[d, s, :cnt] = 1.0
            if g.weighted:
                coef_out[d, s, :cnt] = coef[blk]
    return src_out, dst_out, mask_out, coef_out, n_local


@dataclasses.dataclass
class ReverseShard:
    """What shard ``(d, s)`` holds for the reverse ring: ``blocks[s_dst]``,
    K3's operands for its edges whose destinations lie in range ``s_dst``
    (gathered at the destination, summed by source), and its range's
    inverse out-degrees and real-node mask."""

    device: torch.device
    base: int
    weighted: bool
    blocks: list[Block]
    inv_deg: torch.Tensor        # f32[n_local]
    live: torch.Tensor           # bool[n_local, 1]


def reverse_shards(g: Graph, mesh: Mesh) -> list[list[ReverseShard]]:
    """``[data][graph]`` :class:`ReverseShard` s of ``g`` over the blocks
    of :func:`partition_edges_by_src_dst`."""
    src_b, dst_b, mask_b, coef_b, n_local = partition_edges_by_src_dst(
        g, mesh.graph)
    inv_deg = _safe_inv_deg(g.out_deg.cpu()).numpy()
    live = g.node_mask.cpu().numpy() > 0

    def shard(_, d, dev):
        lo = d * n_local
        blocks = []
        for s in range(mesh.graph):
            cnt = int(mask_b[d, s].sum())
            # gathered at the destination, summed by the source
            blocks.append(make_block(
                dst_b[d, s, :cnt], src_b[d, s, :cnt],
                None if coef_b is None else coef_b[d, s, :cnt],
                n_local, dev))
        return ReverseShard(
            device=dev, base=lo, weighted=g.weighted, blocks=blocks,
            inv_deg=torch.tensor(inv_deg[lo:lo + n_local], device=dev),
            live=torch.tensor(live[lo:lo + n_local], device=dev)[:, None])

    return mesh.grid(shard)


def make_node_sharded_backward(mesh: Mesh, g: Graph, *, alpha: float,
                               max_sweeps: int = 10_000):
    """The reverse-push program (``ppr_tpu/parallel/
    node_sharded_allpair.py:83``): ``(run, shards)`` with ``run(targets,
    rmax) -> (p, sweeps)`` for a host int32 batch whose length is a
    multiple of ``data``; ``p`` holds the reserve as ``[data][graph]``
    node-major parts ``[n_local, T/data]``, the in-degree-0 short-circuit
    applied."""
    alpha_f = _f32(alpha)
    keep = float(np.float32(1.0) - np.float32(alpha))
    shards = reverse_shards(g, mesh)
    n_local = g.n_pad // mesh.graph
    in_deg = g.in_deg.cpu().numpy()

    def run(targets, rmax: float):
        gate = _f32(rmax)
        targets = np.asarray(targets, np.int32)
        cols = mesh_mod.split(len(targets), mesh.data)
        p, r, onehot = [], [], []
        for c, row in zip(cols, shards):
            oh = [sh if is_remote(sh) else
                  local_onehot(targets[c], sh.base, n_local, sh.device)
                  for sh in row]
            onehot.append(oh)
            r.append(list(oh))
            p.append([x if is_remote(x) else torch.zeros_like(x)
                      for x in oh])

        def step(p, r):
            p_out, r_out, anys = [], [], []
            for d, row in enumerate(shards):
                acts, chunks, pd = [], [], []
                for s, sh in enumerate(row):
                    if is_remote(sh):
                        for out in (acts, chunks, pd):
                            out.append(sh)
                        continue
                    active = (r[d][s] > gate) & sh.live
                    a = torch.where(active, r[d][s], 0.0)
                    pd.append(p[d][s] + alpha_f * a)
                    chunks.append((keep * a,))   # circulates the ring
                    acts.append(a)
                    anys.append(active.any().to(torch.int32))
                acc = ring_push(_devices(row), chunks,
                                lambda pl: pl[0], lambda s: row[s].blocks,
                                None)
                rd = []
                for s, sh in enumerate(row):
                    if is_remote(sh):
                        rd.append(sh)
                        continue
                    pulled = acc[s] if acc[s] is not None \
                        else torch.zeros_like(acts[s])
                    if not sh.weighted:
                        pulled = pulled * sh.inv_deg[:, None]
                    rd.append(r[d][s] - acts[s] + pulled)
                p_out.append(pd)
                r_out.append(rd)
            return p_out, r_out, mesh_mod.pmax(anys, mesh)[0] > 0

        p, r, used = _run_sweeps(step, p, r, max_sweeps)
        # the in-degree-0 target short-circuit (Backward_Search.java:46-49)
        for d, (c, row) in enumerate(zip(cols, shards)):
            zero = torch.as_tensor(in_deg[targets[c]] == 0)
            for s, sh in enumerate(row):
                if not is_remote(sh):
                    p[d][s] = torch.where(zero.to(sh.device)[None, :],
                                          onehot[d][s], p[d][s])
        return p, used

    return run, shards


class NodeShardedBackwardSearch:
    """:class:`~..models.backward_search.BackwardSearch` with the reverse
    push node-sharded: each device holds ``[n_pad/graph, T/data]``."""

    def __init__(self, graph: Graph, alpha: float, rmax: float, *,
                 mesh: Mesh | None = None, max_sweeps: int = 10_000):
        self.graph = graph
        self.alpha = float(alpha)
        self.rmax = float(rmax)
        self.duration_ns = 0
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_local = graph.n_pad // self.mesh.graph
        self._run, self._shards = make_node_sharded_backward(
            self.mesh, graph, alpha=self.alpha, max_sweeps=max_sweeps)
        #: sweeps of the last call (its frontier was non-empty in each)
        self.last_sweeps: int | None = None

    def whole_graph_shards(self, targets: np.ndarray):
        """The reserve as ``[data][graph]`` node-major parts ``[n_local,
        T_pad/data]`` on their devices (the batch padded with node 0 to
        at least 8 and a multiple of ``data``)."""
        t0 = time.perf_counter_ns()
        padded, _ = pad_batch(targets, self.mesh.data)
        parts, self.last_sweeps = self._run(padded, self.rmax)
        self.mesh.synchronize()
        self.duration_ns += time.perf_counter_ns() - t0
        return parts

    def whole_graph_device(self, targets: np.ndarray) -> torch.Tensor:
        """The reserve ``[T_pad, n_pad]`` on the graph's device, assembled
        from the shards for the store's selection; rows past
        ``len(targets)`` are padding."""
        parts = self.whole_graph_shards(targets)
        t0 = time.perf_counter_ns()
        out = collect_rows(parts, self.graph.device, self.mesh)
        self.mesh.synchronize()
        self.duration_ns += time.perf_counter_ns() - t0
        return out

    def whole_graph(self, targets: np.ndarray) -> np.ndarray:
        return self.whole_graph_device(targets).cpu().numpy()[: len(targets)]

    def get_duration(self) -> int:
        """Accumulated ns across calls (Backward_Search.java:36, :98-106)."""
        return self.duration_ns


def node_sharded_base_allpair(dataset, alpha: float, *,
                              mesh: Mesh | None = None, seed: int = 0,
                              target_batch: int = 512) -> MeshBaseAllPair:
    """A :class:`~..models.base_allpair.BaseAllPair` whose reverse push
    runs node-sharded (``ppr_tpu/parallel/node_sharded_allpair.py:270``)."""
    return MeshBaseAllPair(dataset, alpha,
                           mesh=mesh if mesh is not None else make_mesh(),
                           engine=NodeShardedBackwardSearch, seed=seed,
                           target_batch=target_batch)
