"""Mesh drop-ins for every protocol algorithm: the harness's and the CLI's
``--mesh`` — port of ``ppr_tpu/parallel/mesh_algos.py``.

The offline preprocessing sweeps of FORA whole-graph
(Fora_Whole_Graph.java:82-146), Forward Push (Forward_Push.java:63-142),
the Neo4j method (Neo4j_Method.java:67-99) and Monte-Carlo
(Monte_Carlo.java:136-158), and their queries, run on a ``(data, graph)``
mesh here; :func:`mesh_algo_obj` is the mesh's ``AlgoConf.new_algo_obj``
(Gen_Util.java:66-97), and it gives FORA top-k and BASE their mesh engines
(:mod:`.sharded_fora`, :mod:`.sharded_allpair`).

:class:`_EdgeShardedKernels` holds the edge-sharded programs, in the layout
of :mod:`.sharded_fora`: ``data`` splits the batch, each data row holding
the node-major ``[n_pad, B/data]`` state replicated on its devices;
``graph`` cuts the destination-sorted edges into contiguous chunks, each
pushed by one K3 launch (its coefficient mode on a weighted graph), and
:func:`~.mesh.psum` over ``graph``, in shard order, completes a push.

* :meth:`~_EdgeShardedKernels.push`: frontier-masked sweeps to the
  ``rmax`` fixpoint, the single-device engine's ``ops/push.forward_sweep``
  and loop with the frontier read from the replicated residue, so every
  shard agrees; a sweep with an empty frontier is an exact no-op, so the
  host reads the flag every ``CHECK_EVERY`` sweeps.
* :meth:`~_EdgeShardedKernels.propagate`: residue propagation until every
  row's residue sum is at most a target (FORA's deterministic completion,
  ``models/fora.residual_propagate``); an extra sweep is not a no-op here,
  so a sweep whose test failed leaves the state as it was, and the loop
  stops on the JAX loop's sweep.
* :meth:`~_EdgeShardedKernels.power_iterations`: the Neo4j method's damped
  iterations; the normalization follows them, on the whole rows.
* :class:`MeshMonteCarlo` walks on the walker grid of
  :func:`~.sharded.make_sharded_walk_counts`.

On a 1x1 mesh the Forward Push, Neo4j-method and BASE drop-ins compute the
single-device engines' bits on a sparse graph. The wrappers keep each
algorithm's ``name`` and ``prep_dirname``, so a store written on a mesh
resumes on one device and the other way round.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..graph.csr import Graph
from ..models.config import AlgoType
from ..models.fora import ForaWholeGraph
from ..models.forward_push import ForwardPush
from ..models.monte_carlo import MonteCarlo, mc_num_walks
from ..models.neo4j_method import Neo4jMethod, _normalize
from ..ops.push import CHECK_EVERY, ForwardGate, _f32, _run_sweeps, \
    forward_sweep
from . import mesh as mesh_mod
from .mesh import Mesh, is_remote, make_mesh, psum
from .sharded import (collect_rows, edge_chunks, make_sharded_walk_counts,
                      onehot_t, shard_graph)
from .sharded_allpair import sharded_base_allpair
from .sharded_fora import ShardedForaTopk
from .sharded_fora import pad_batch as _pad_rows


class _EdgeShardedKernels:
    """The edge-sharded programs for one (mesh, graph)
    (``ppr_tpu/parallel/mesh_algos.py:64``). Every state argument and
    result is ``[data][graph]`` node-major parts ``[n_pad, B/data]``; the
    parts passed in are not written in place."""

    def __init__(self, mesh: Mesh, g: Graph, alpha: float,
                 max_sweeps: int = 10_000):
        self.mesh = mesh
        self.g = g
        self.alpha = float(alpha)
        self.max_sweeps = max_sweeps
        self.alpha_f = _f32(alpha)
        self.keep = float(np.float32(1.0) - np.float32(alpha))
        self.chunks = edge_chunks(g, mesh)
        self._out_deg = g.out_deg.cpu().numpy()

    def prepare(self, sources: np.ndarray, *, init_shortcircuit: bool):
        """``(p, r, onehot)`` for a padded batch (its length a multiple of
        ``data``). ``init_shortcircuit`` starts a dangling source's row
        at reserve ``e_s`` and residue 0 (``ops/push.forward_push_init``,
        Forward_Push.java:70-74); otherwise ``p`` is 0 and ``r`` the
        one-hot."""
        sources = np.asarray(sources, np.int32)
        cols = mesh_mod.split(len(sources), self.mesh.data)
        p, r, onehot = [], [], []
        for d, (c, row) in enumerate(zip(cols, self.mesh.devices)):
            srcs = sources[c]
            short = torch.as_tensor(self._out_deg[srcs] == 0)[None, :]
            prow, rrow, orow = [], [], []
            for s, dev in enumerate(row):
                if not self.mesh.is_local(d, s):
                    for out in (prow, rrow, orow):
                        out.append(self.mesh.remote(d, s))
                    continue
                oh = onehot_t(srcs, self.g.n_pad, dev)
                zero = torch.zeros_like(oh)
                if init_shortcircuit:
                    sc = short.to(dev)
                    prow.append(torch.where(sc, oh, zero))
                    rrow.append(torch.where(sc, zero, oh))
                else:
                    prow.append(zero)
                    rrow.append(oh)
                orow.append(oh)
            p.append(prow)
            r.append(rrow)
            onehot.append(orow)
        return p, r, onehot

    def push(self, p, r, onehot, rmax: float):
        """Frontier-masked push sweeps to the ``rmax`` fixpoint
        (``ppr_tpu/parallel/mesh_algos.py:134``): each data row runs
        ``ops/push.forward_sweep`` over its graph replicas, each pushing
        its chunk, summed by ``psum``. Returns ``(p, r, sweeps)``,
        ``sweeps`` those whose frontier was non-empty."""
        gates = {dev: ForwardGate(self.g, rmax, dev)
                 for dev in self.mesh.unique_devices()}

        def step(p, r):
            p_out, r_out, anys = [], [], []
            for d, row in enumerate(self.chunks):
                mine = [s for s, ch in enumerate(row) if not is_remote(ch)]
                if not mine:
                    p_out.append(p[d])
                    r_out.append(r[d])
                    continue

                def push(xs, row=row, mine=mine):
                    # this rank's chunks push; the row's psum crosses ranks
                    parts = list(row)
                    for s, x in zip(mine, xs):
                        parts[s] = row[s].push(x)
                    pushed = psum(parts)
                    return [pushed[s] for s in mine]

                pd, rd, any_d = forward_sweep(
                    [gates[row[s].src.device] for s in mine],
                    [p[d][s] for s in mine], [r[d][s] for s in mine],
                    [onehot[d][s] for s in mine], push, self.alpha)
                p_out.append(list(row))
                r_out.append(list(row))
                for s, pn, rn in zip(mine, pd, rd):
                    p_out[d][s], r_out[d][s] = pn, rn
                anys.append(any_d.to(torch.int32))
            return p_out, r_out, mesh_mod.pmax(anys, self.mesh)[0] > 0

        return _run_sweeps(step, p, r, self.max_sweeps)

    def _rsum_max(self, r) -> torch.Tensor:
        """The largest column residue sum over the mesh (``pmax`` over
        ``data``), on the controller."""
        return mesh_mod.pmax([row[s].sum(dim=0).max()
                              for d, row in enumerate(r)
                              if (s := self.mesh.speaker(d)) is not None],
                             self.mesh)[0]

    def propagate(self, p, r, onehot, target: float):
        """Synchronous propagation sweeps while the largest row residue sum
        is above ``target`` (``ppr_tpu/parallel/mesh_algos.py:202``).
        Returns ``(p, r, sweeps)``."""
        alpha_f, keep = self.alpha_f, self.keep
        target = _f32(target)
        p = [list(row) for row in p]
        r = [list(row) for row in r]
        it = torch.zeros((), dtype=torch.int32, device=self.mesh.controller)
        live = self._rsum_max(r) > target
        for sweep in range(self.max_sweeps):
            if sweep % CHECK_EVERY == 0 and not bool(live):
                break
            lv = mesh_mod.broadcast(live, self.mesh)
            for d, row in enumerate(self.chunks):
                partials, dangs = [], []
                for s, ch in enumerate(row):
                    if is_remote(ch):
                        partials.append(ch)
                        dangs.append(ch)
                        continue
                    dev = ch.src.device
                    # a sweep that is not live adds r * 0: p is unchanged
                    p[d][s] = torch.addcmul(p[d][s], r[d][s],
                                            lv[dev] * alpha_f)
                    rem = r[d][s] * keep
                    dangs.append(rem.index_select(0, ch.dang_ids)
                                 .sum(dim=0, keepdim=True))
                    partials.append(ch.push(rem))
                pushed = psum(partials)
                for s, ch in enumerate(row):
                    if is_remote(ch):
                        continue
                    nxt = torch.addcmul(pushed[s], dangs[s], onehot[d][s])
                    r[d][s] = torch.where(lv[ch.src.device], nxt, r[d][s])
            it = it + live.to(torch.int32)
            live = self._rsum_max(r) > target
        return p, r, int(it)

    def power_iterations(self, onehot, damping: float, iterations: int):
        """``x <- (1-d) e_s + d P^T x``, ``iterations`` times from ``x =
        (1-d) e_s`` (Neo4j_Method.java:73-99), not normalized: the caller
        normalizes the whole rows (``ppr_tpu/parallel/mesh_algos.py:
        262``)."""
        x, base = [], []
        for orow in onehot:
            b = [oh if is_remote(oh) else (1.0 - damping) * oh
                 for oh in orow]
            base.append(b)
            x.append(list(b))
        for _ in range(int(iterations)):
            for d, row in enumerate(self.chunks):
                pushed = psum([ch if is_remote(ch) else ch.push(x[d][s])
                               for s, ch in enumerate(row)])
                x[d] = [ch if is_remote(ch) else
                        base[d][s] + damping * pushed[s]
                        for s, ch in enumerate(row)]
        return x


class MeshForwardPush(ForwardPush):
    """Forward Push whose sweeps run edge-sharded on a mesh."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh, seed: int = 0):
        super().__init__(dataset, alpha, seed=seed)
        self.mesh = mesh
        self._kern = _EdgeShardedKernels(mesh, self.graph, alpha)

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        """The reserve ``[B_pad, n_pad]`` on the graph's device; rows past
        ``len(sources)`` are padding."""
        sources_p, _ = _pad_rows(sources, self.mesh.data)
        p, r, onehot = self._kern.prepare(sources_p, init_shortcircuit=True)
        p, r, self.last_sweeps = self._kern.push(p, r, onehot, float(param))
        dev = self.graph.device
        r0, p0 = mesh_mod.fetch(self.mesh, [[row[:1] for row in r],
                                            [row[:1] for row in p]])
        self._last_rsum_dev = torch.cat(
            [row[0].sum(dim=0).to(dev) for row in r0])[: len(sources)]
        return collect_rows(p0, dev)

    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        return self.compute_whole_graph_device(sources, param) \
            .cpu().numpy()[: len(sources)]


class MeshNeo4jMethod(Neo4jMethod):
    """The Neo4j method's power iterations on a mesh, edge-sharded."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh, seed: int = 0):
        super().__init__(dataset, alpha, seed=seed)
        self.mesh = mesh
        self._kern = _EdgeShardedKernels(mesh, self.graph, alpha)

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        sources_p, _ = _pad_rows(sources, self.mesh.data)
        _, _, onehot = self._kern.prepare(sources_p, init_shortcircuit=False)
        # Neo4j damping = 1 - alpha (Neo4j_Method.java:75)
        x = self._kern.power_iterations(onehot, 1.0 - self.alpha, int(param))
        return _normalize(collect_rows([row[:1] for row in x],
                                       self.graph.device, self.mesh))

    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        return self.compute_whole_graph_device(sources, param) \
            .cpu().numpy()[: len(sources)]


class MeshForaWholeGraph(ForaWholeGraph):
    """FORA whole-graph on a mesh: push rounds chosen by wall clock, then
    the residue completed by propagation, edge-sharded. Its rows are held
    to the oracle, not to another engine's: the rounds follow the clock.
    The walk completion on a mesh is
    :class:`~.node_sharded_fora.NodeShardedForaWholeGraph`'s."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh,
                 delta: float | None = None, pfail: float | None = None,
                 seed: int = 0, max_push_rounds: int = 30):
        super().__init__(dataset, alpha, delta=delta, pfail=pfail, seed=seed,
                         max_push_rounds=max_push_rounds, completion="spmv")
        self.mesh = mesh
        self._kern = _EdgeShardedKernels(mesh, self.graph, alpha)
        self._push_warmed = False
        #: propagation sweeps of the last call
        self.last_iters: int | None = None

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        eps = float(param)
        g = self.graph
        kern = self._kern
        sources_p, _ = _pad_rows(sources, self.mesh.data)
        b = len(sources_p)
        m = max(g.m, 1)
        ln_term = math.log(2.0 / self.pfail)
        rmax = eps * math.sqrt(self.delta / 3.0 / m / ln_term) \
            / (1.0 - self.alpha)
        omega = (eps + 2.0) * ln_term / eps / eps / self.delta
        target = eps * self.delta

        p, r, onehot = kern.prepare(sources_p, init_shortcircuit=True)
        # one untimed push first: the first sparse push of a process builds
        # the kernels, which must not enter the rounds' balance
        if not self._push_warmed:
            kern.push(p, r, onehot, rmax)
            self.mesh.synchronize()
            self._push_warmed = True
        # push rounds on the single-device engine's wall-clock balance
        # (Fora_Whole_Graph.java:93-103)
        rsum_local, push_ns, rounds = 1.0, 0.0, 0
        while (push_ns < min(self.avg_rand_walk_time_ns * rsum_local * omega,
                             self._spmv_completion_ns(rsum_local, target, b))
               and rounds < self.max_push_rounds):
            t0 = time.perf_counter_ns()
            p, r, _ = kern.push(p, r, onehot, rmax)
            self.mesh.synchronize()
            # across processes the slowest rank's clock decides for all
            push_ns += self.mesh.agree_max(time.perf_counter_ns() - t0) / b
            r0 = mesh_mod.fetch(self.mesh, [row[:1] for row in r])
            rsum_local = float(torch.cat(
                [row[0].sum(dim=0).cpu() for row in r0]).mean()) \
                * (1.0 - self.alpha)
            rmax /= 2.0
            rounds += 1
        self.last_rounds, self.last_push_ns = rounds, push_ns
        p, r, self.last_iters = kern.propagate(p, r, onehot, target)
        return collect_rows([row[:1] for row in p], g.device, self.mesh)


class MeshMonteCarlo(MonteCarlo):
    """Monte-Carlo on the walker grid of
    :func:`~.sharded.make_sharded_walk_counts`: rows split over ``data``,
    walkers over ``graph``, the stop counts summed over ``graph``.

    Each row walks its ``omega`` walks, in lane passes of at most
    ``max_walk_batch`` walkers a device (the single-device engine's
    budget a call), the lanes padded to a multiple of ``graph`` with
    walkers of weight 0. The JAX package budgets ``max_walk_batch`` over
    the whole grid and rounds the passes to powers of two to bound its
    recompiles; the port needs neither, and the passes, not the walks,
    change. A weighted graph's walks take the alias step."""

    def __init__(self, dataset, alpha: float, *, mesh: Mesh,
                 delta: float | None = None, pfail: float | None = None,
                 seed: int = 0, max_walk_batch: int = 4_000_000):
        super().__init__(dataset, alpha, delta=delta, pfail=pfail, seed=seed,
                         max_walk_batch=max_walk_batch)
        self.mesh = mesh
        self._gs = shard_graph(self.graph, mesh)
        self._walk = make_sharded_walk_counts(mesh, self.alpha)
        self._seeds = np.random.default_rng(seed)

    def compute_whole_graph_device(self, sources: np.ndarray, param
                                   ) -> torch.Tensor:
        omega = mc_num_walks(float(param), self.delta, self.pfail)
        sources_p, _ = _pad_rows(sources, self.mesh.data)
        b = len(sources_p)
        unit = self.mesh.graph
        # a device holds b/data rows of w/graph lanes a pass
        w_cap = max(unit, self.max_walk_batch * self.mesh.size // b
                    // unit * unit)
        weight = np.float32(1) / np.float32(omega)
        counts = None
        for lane0 in range(0, omega, w_cap):
            w = min(w_cap, -(-(omega - lane0) // unit) * unit)
            lane_w = np.where(lane0 + np.arange(w) < omega, weight,
                              np.float32(0)).astype(np.float32)
            c = self._walk(self._gs,
                           np.broadcast_to(sources_p[:, None], (b, w)),
                           np.broadcast_to(lane_w, (b, w)),
                           int(self._seeds.integers(1 << 31)))
            counts = c if counts is None else [
                [x if is_remote(x) else x + y for x, y in zip(crow, nrow)]
                for crow, nrow in zip(counts, c)]
        return collect_rows([row[:1] for row in counts], self.graph.device,
                            self.mesh)

    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        return self.compute_whole_graph_device(sources, param) \
            .cpu().numpy()[: len(sources)]


def mesh_algo_obj(algo_type: AlgoType, dataset, alpha: float, k: int, *,
                  mesh: Mesh | None = None, seed: int = 0):
    """The mesh's ``AlgoConf.new_algo_obj`` (Gen_Util.java:66-97): the same
    theory-derived parameters, the engines on the ``(data, graph)`` mesh
    (``ppr_tpu/parallel/mesh_algos.py:489``)."""
    mesh = mesh if mesh is not None else make_mesh()
    if algo_type == AlgoType.BASE_WHOLE_GRAPH:
        return sharded_base_allpair(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.FORA_TOPK:
        return ShardedForaTopk(dataset, alpha=alpha, k=k, mesh=mesh)
    if algo_type == AlgoType.FORA_WHOLE_GRAPH:
        return MeshForaWholeGraph(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.FWDPUSH:
        return MeshForwardPush(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.NEO4J_METHOD:
        return MeshNeo4jMethod(dataset, alpha, mesh=mesh, seed=seed)
    if algo_type == AlgoType.MC:
        return MeshMonteCarlo(dataset, alpha, mesh=mesh, seed=seed)
    raise ValueError(f"no mesh variant for {algo_type}")
