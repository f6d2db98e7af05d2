"""BASE all-pair preprocessing on a ``(data, graph)`` mesh, edge-sharded:
the reverse push of every target — port of
``ppr_tpu/parallel/sharded_allpair.py``.

BASE's preprocessing (Base_Whole_Graph.java:58-165) runs a reverse push
from every node as target, the reference's heaviest offline job. The
single-device engine batches T targets into one ``[T, n_pad]`` program
(:mod:`~..models.base_allpair`); here the same sweeps run on a mesh:

* ``data`` splits the targets: each data row holds the node-major ``[n_pad,
  T/data]`` reserve and residue, replicated on every device of the row;
* ``graph`` cuts the source-sorted (primary) edges into contiguous chunks
  (:func:`~.sharded.edge_chunks_bysrc`): a shard's share of the reverse
  step ``y[u] = sum over edges u->v of rem[v]`` is one K3 launch over its
  chunk (gather at the destinations, sum by source; the coefficient mode
  on a weighted graph), and :func:`~.mesh.psum` over ``graph``, in shard
  order, completes it. The ``1/d_out(u)`` scale follows the sum on an
  unweighted graph, in the JAX package's order.

The strict gate ``r > rmax`` (Backward_Search.java:89-94), mass dying at
in-degree-0 frontier nodes (:73-96) and the in-degree-0 target
short-circuit ``pi(t, t) = 1`` (:46-49) are those of
``ops/push.backward_push_sweeps``. The "frontier non-empty" flag is
combined over ``data``, so every shard runs the batch's sweeps; a sweep
with an empty frontier is an exact no-op, so the host reads the flag every
``CHECK_EVERY`` sweeps. On a 1x1 mesh the arithmetic is the single-device
engine's, bit for bit.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..graph.csr import Graph
from ..models.base_allpair import BaseAllPair
from ..ops.push import _f32, _run_sweeps
from . import mesh as mesh_mod
from .mesh import Mesh, is_remote, make_mesh, psum
from .sharded import collect_rows, edge_chunks_bysrc, onehot_t
from .sharded_fora import pad_batch


def make_sharded_backward_sweeps(mesh: Mesh, g: Graph, *, alpha: float,
                                 max_sweeps: int = 10_000):
    """The reverse-push program (``ppr_tpu/parallel/sharded_allpair.py:
    59``): ``(run, chunks)`` with ``run(targets, rmax) -> (p, sweeps)`` for
    a host int32 batch ``targets`` whose length is a multiple of ``data``,
    and the ``[data][graph]`` edge chunks it pushes; ``p`` holds the
    reserve as ``[data][graph]`` node-major parts ``[n_pad, T/data]``
    (each row's graph replicas equal), the in-degree-0 short-circuit
    applied, and ``sweeps`` counts the sweeps whose frontier was
    non-empty."""
    alpha_f = _f32(alpha)
    keep = float(np.float32(1.0) - np.float32(alpha))
    chunks = edge_chunks_bysrc(g, mesh)
    node_mask = g.node_mask.cpu()
    in_deg = g.in_deg.cpu().numpy()
    live = {dev: (node_mask > 0).to(dev)[:, None]
            for dev in mesh.unique_devices()}

    def run(targets, rmax: float):
        gate = _f32(rmax)
        targets = np.asarray(targets, np.int32)
        cols = mesh_mod.split(len(targets), mesh.data)
        p, r, onehot = [], [], []
        for c, row in zip(cols, chunks):
            oh = [ch if is_remote(ch) else
                  onehot_t(targets[c], g.n_pad, ch.src.device) for ch in row]
            onehot.append(oh)
            r.append(list(oh))
            p.append([x if is_remote(x) else torch.zeros_like(x)
                      for x in oh])

        def step(p, r):
            p_out, r_out, anys = [], [], []
            for d, row in enumerate(chunks):
                acts, partials, pd = [], [], []
                speaker = mesh.speaker(d)
                for s, ch in enumerate(row):
                    if is_remote(ch):
                        for out in (acts, partials, pd):
                            out.append(ch)
                        continue
                    r_ = r[d][s]
                    active = (r_ > gate) & live[ch.src.device]
                    a = torch.where(active, r_, 0.0)
                    pd.append(p[d][s] + alpha_f * a)
                    # the reverse step: gather the residue at the chunk's
                    # destinations, sum by source
                    partials.append(ch.gather(keep * a))
                    acts.append(a)
                    if s == speaker:      # the graph replicas agree
                        anys.append(active.any().to(torch.int32))
                pulled = psum(partials)
                rd = []
                for s, ch in enumerate(row):
                    if is_remote(ch):
                        rd.append(ch)
                        continue
                    pl = pulled[s] if ch.coef is not None \
                        else pulled[s] * ch.inv_deg[:, None]
                    rd.append(r[d][s] - acts[s] + pl)
                p_out.append(pd)
                r_out.append(rd)
            return p_out, r_out, mesh_mod.pmax(anys, mesh)[0] > 0

        p, r, used = _run_sweeps(step, p, r, max_sweeps)
        # the in-degree-0 target short-circuit (Backward_Search.java:46-49)
        for d, (c, row) in enumerate(zip(cols, chunks)):
            zero = torch.as_tensor(in_deg[targets[c]] == 0)
            for s, ch in enumerate(row):
                if not is_remote(ch):
                    p[d][s] = torch.where(zero.to(ch.src.device)[None, :],
                                          onehot[d][s], p[d][s])
        return p, used

    return run, chunks


class ShardedBackwardSearch:
    """:class:`~..models.backward_search.BackwardSearch` with the reverse
    push on a mesh, edge-sharded."""

    def __init__(self, graph: Graph, alpha: float, rmax: float, *,
                 mesh: Mesh | None = None, max_sweeps: int = 10_000):
        self.graph = graph
        self.alpha = float(alpha)
        self.rmax = float(rmax)
        self.duration_ns = 0
        self.mesh = mesh if mesh is not None else make_mesh()
        self._run, self._chunks = make_sharded_backward_sweeps(
            self.mesh, graph, alpha=self.alpha, max_sweeps=max_sweeps)
        #: sweeps of the last call (its frontier was non-empty in each)
        self.last_sweeps: int | None = None

    def whole_graph(self, targets: np.ndarray) -> np.ndarray:
        """``pi(., t)`` for a batch of targets, rows indexed by target."""
        p = self.whole_graph_device(targets)   # accounts its own duration
        t0 = time.perf_counter_ns()
        out = p.cpu().numpy()[: len(targets)]
        self.duration_ns += time.perf_counter_ns() - t0
        return out

    def whole_graph_device(self, targets: np.ndarray) -> torch.Tensor:
        """The reserve ``[T_pad, n_pad]`` on the graph's device; rows past
        ``len(targets)`` are padding (the batch is padded to a multiple of
        ``data``: the rows recompute target 0)."""
        t0 = time.perf_counter_ns()
        padded, _ = pad_batch(targets, self.mesh.data, self.mesh.data)
        parts, self.last_sweeps = self._run(padded, self.rmax)
        out = collect_rows([row[:1] for row in parts], self.graph.device,
                           self.mesh)
        self.mesh.synchronize()
        self.duration_ns += time.perf_counter_ns() - t0
        return out

    def get_duration(self) -> int:
        return self.duration_ns


class MeshBaseAllPair(BaseAllPair):
    """:class:`BaseAllPair` whose reverse push runs on a mesh, through the
    engine class ``engine`` (:class:`ShardedBackwardSearch` or
    ``NodeShardedBackwardSearch``). Its name and store directory are
    BASE's: a store written on a mesh reads back on one device."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh, engine,
                 seed: int = 0, target_batch: int = 512):
        super().__init__(dataset, alpha, seed=seed,
                         target_batch=target_batch)
        self.mesh = mesh
        self._engine = engine

    def _make_bws(self, threshold: float):
        return self._engine(self.graph, self.alpha, threshold,
                            mesh=self.mesh)


def sharded_base_allpair(dataset, alpha: float, *, mesh: Mesh | None = None,
                         seed: int = 0, target_batch: int = 512
                         ) -> MeshBaseAllPair:
    """A :class:`BaseAllPair` whose preprocessing sweep runs on the mesh,
    edge-sharded (``ppr_tpu/parallel/sharded_allpair.py:200``)."""
    return MeshBaseAllPair(dataset, alpha,
                           mesh=mesh if mesh is not None else make_mesh(),
                           engine=ShardedBackwardSearch, seed=seed,
                           target_batch=target_batch)
