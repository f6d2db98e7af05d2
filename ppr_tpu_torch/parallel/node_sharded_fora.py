"""FORA on a mesh with the node dimension sharded: the O(n/S)-memory
engines — port of ``ppr_tpu/parallel/node_sharded_fora.py``.

:class:`NodeShardedForaTopk` runs the δ-annealing top-k loop of
:func:`~..models.fora.annealed_topk_propagate` over the ring partition of
:mod:`.node_sharded`: shard ``(d, s)`` holds the node-major ``[n_local,
B/data]`` reserve and residue of its node range and the edge blocks whose
destination lies in it; a sweep circulates the residue chunks around the
``graph`` ring and pushes each visiting chunk through its block (K3).
Loop control is :func:`~.sharded.run_annealed`, with the row sums and
the stopping counts summed over ``graph`` first. The epilogue is a
distributed top-k: each shard selects its range's top ``kcap``, the
candidates are concatenated in shard order and selected again, so no
shard ever holds ``[n_pad, B]``.

* ``ring_dtype="bf16"``: each hop sends the chunk as bf16 and widens it to
  f32 on arrival (hop 0 uses the unrounded local chunk); the sums and
  the decisions stay f32.
* ``frontier_blocks=C``: each shard cuts its range into ``num_blocks``
  blocks (in descending in-degree order with ``block_order="degree"``),
  pushes only the ``C`` blocks that hold the most residue this sweep and
  sends just those (``[C, blk, B]`` values and their ``C`` ids). The
  residue of the other blocks stays where it is: push order is free in
  forward push (Forward_Push.java:60-88), and the stopping rule reads the
  whole residue. With ``C = num_blocks`` every block goes every sweep and
  the arithmetic is the dense ring's, bit for bit.

:class:`NodeShardedForaWholeGraph` is FORA whole-graph on the same
partition: synchronous ring sweeps (each multiplies the residue by exactly
``1 - alpha``, so the count to any target is closed-form), then the
residue is completed by more sweeps (``completion="spmv"``) or by the
reference's walks (``"walks"``, Fora_Whole_Graph.java:119-140), which stay
on their shard while the CSR slices rotate (:func:`~.node_sharded.
ring_walks`). The JAX package sizes its walk pools in pow2 buckets to
bound recompiles; here each shard's pool is exactly its walks, and
``max_walkers_per_device`` caps it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..graph.csr import Graph
from ..models.fora import (MAX_TOPK_SWEEPS, _loop_constants,
                           _whole_graph_walk_setup, topk_kcap)
from ..ops.walk import default_max_steps, expand_walkers
from . import mesh as mesh_mod
from .mesh import Mesh, is_remote, make_mesh, psum
from .node_sharded import (_devices, csr_slices, gather_nodes, local_onehot,
                           make_node_sharded_propagate_ring, node_shards,
                           ring_push, ring_sweep, ring_walks, wire_dtype)
from .sharded import run_annealed
from .sharded_fora import pad_batch


def degree_order(g: Graph, s_graph: int) -> np.ndarray:
    """``[S, n_local]``: each range's local nodes by descending in-degree
    (stable), the in-degree counted over the padded destination-sorted
    edges as in the JAX package."""
    n_local = g.n_pad // s_graph
    in_deg = np.bincount(g.edge_dst_bydst.cpu().numpy(),
                         minlength=g.n_pad)[: g.n_pad]
    return np.stack([
        np.argsort(-in_deg[s * n_local:(s + 1) * n_local],
                   kind="stable").astype(np.int32)
        for s in range(s_graph)])


def _frontier_sweep(shards, p, r, onehot, live, alpha: float, wire,
                    nb: int, blk: int, c: int):
    """One frontier-compacted sweep of a data row: each shard pushes the
    ``c`` of its ``nb`` blocks that carry the most residue and sends only
    those around the ring; the rest of its residue stays in place."""
    alpha_f, keep, _, _ = _loop_constants(alpha, 0.0)
    mine = [x for x in r if not is_remote(x)]
    if not mine:        # another rank's row
        return list(p), list(r)
    n_local = mine[0].shape[0]
    pad = nb * blk - n_local
    payloads, masks, dangs, p_new = [], [], [], []
    for s, sh in enumerate(shards):
        if is_remote(sh):
            for out in (payloads, masks, dangs, p_new):
                out.append(sh)
            continue
        b_l = r[s].shape[1]
        r_basis = r[s] if sh.perm is None else r[s].index_select(0, sh.perm)
        mass = torch.nn.functional.pad(r_basis, (0, 0, 0, pad)) \
            .view(nb, blk, b_l).sum(dim=(1, 2))
        sel = torch.sort(torch.topk(mass, c).indices).values
        m_blk = torch.zeros(nb, dtype=torch.float32, device=sh.device)
        m_blk[sel] = 1.0
        m_flat = m_blk.repeat_interleave(blk)[:n_local]
        m = m_flat if sh.perm is None else torch.zeros_like(m_flat) \
            .index_copy_(0, sh.perm, m_flat)
        masks.append(m[:, None])
        r_push = r[s] * masks[s]
        p_new.append(torch.addcmul(p[s], r_push, live[sh.device] * alpha_f))
        rem = r_push * keep
        dangs.append(rem.index_select(0, sh.dang_ids)
                     .sum(dim=0, keepdim=True))
        chunk = rem if sh.weighted else rem * sh.inv_deg[:, None]
        if sh.perm is not None:
            chunk = chunk.index_select(0, sh.perm)
        comp = torch.nn.functional.pad(chunk, (0, 0, 0, pad)) \
            .view(nb, blk, b_l).index_select(0, sel)
        payloads.append((comp, sel))

    def table(payload):
        comp, sel = payload
        dense = torch.zeros((nb,) + tuple(comp.shape[1:]), dtype=comp.dtype,
                            device=comp.device)
        dense.index_copy_(0, sel, comp)
        return dense.view(nb * blk, -1)[:n_local]

    acc = ring_push(_devices(shards), payloads, table,
                    lambda s: shards[s].blocks, wire)
    dang = psum(dangs)
    r_new = []
    for s, sh in enumerate(shards):
        if is_remote(sh):
            r_new.append(sh)
            continue
        kept = r[s] * (1.0 - masks[s])
        a = kept if acc[s] is None else kept + acc[s]
        nxt = torch.addcmul(a, dang[s], onehot[s])
        r_new.append(torch.where(live[sh.device], nxt, r[s]))
    return p_new, r_new


def make_node_sharded_annealed_topk(
    mesh: Mesh, g: Graph, *, alpha: float, k: int, kcap: int,
    delta0: float, min_delta: float, max_iters: int = MAX_TOPK_SWEEPS,
    ring_dtype: str = "f32", frontier_blocks: int | None = None,
    num_blocks: int = 64, block_order: str = "degree",
):
    """The end-to-end program (``ppr_tpu/parallel/node_sharded_fora.py:
    100``): ``(fn, shards)`` with ``fn(sources, eps) -> (vals, ids, p_local,
    iters)``. ``sources`` is the padded batch (host int32), ``eps`` is
    ``eps'``; ``vals`` and ``ids`` are each data row's ``[B/data, kcap]``
    on its first device, ``p_local`` the ``[data][graph]`` reserve parts
    ``[n_local, B/data]`` with the dangling-source short-circuit, and
    ``iters`` the sweep count."""
    wire = wire_dtype(ring_dtype)
    if block_order not in ("degree", "id"):
        raise ValueError(f"block_order must be 'degree' or 'id', got "
                         f"{block_order!r}")
    col_perm = None
    if frontier_blocks is not None and block_order == "degree":
        col_perm = degree_order(g, mesh.graph)
    # the JAX package's _put_blocks: the frontier's order is pre-mapped
    # into every block's sources, so a hop pays no permutation
    shards = node_shards(g, mesh, col_perm)
    n_local = g.n_pad // mesh.graph
    nb = max(1, min(int(num_blocks), n_local))
    blk = -(-n_local // nb)
    c = None if frontier_blocks is None else max(1, min(int(frontier_blocks),
                                                        nb))
    out_deg = g.out_deg.cpu().numpy()

    def fn(sources, eps):
        cols = mesh_mod.split(len(sources), mesh.data)
        p, r, onehot, deg_src = [], [], [], []
        for cs, row in zip(cols, shards):
            srcs = sources[cs]
            oh = [sh if is_remote(sh) else
                  local_onehot(srcs, sh.base, n_local, sh.device)
                  for sh in row]
            dangling = out_deg[srcs] == 0
            # dangling-source rows start (and stay) at zero; the epilogue
            # short-circuits them to e_s (Fora_Topk.java:128-132)
            deg_src.append([sh if is_remote(sh) else
                            torch.as_tensor(dangling, device=sh.device)
                            for sh in row])
            r.append([x if is_remote(x) else torch.where(z[None, :], 0.0, x)
                      for z, x in zip(deg_src[-1], oh)])
            p.append([x if is_remote(x) else torch.zeros_like(x)
                      for x in oh])
            onehot.append(oh)

        def sweep(live):
            for d, row in enumerate(shards):
                if c is None:
                    p[d], r[d] = ring_sweep(row, p[d], r[d], onehot[d],
                                            alpha, wire, live)
                else:
                    p[d], r[d] = _frontier_sweep(row, p[d], r[d], onehot[d],
                                                 live, alpha, wire, nb, blk,
                                                 c)

        def stats(thresh):
            rsum, done = [], []
            for d, row in enumerate(shards):
                s = mesh.speaker(d)
                if s is None:
                    continue
                rows = psum([x if is_remote(x) else x.sum(dim=0)
                             for x in r[d]])[s]
                cnt = psum([x if is_remote(x) else
                            (x >= thresh[sh.device]).sum(dim=0)
                            for x, sh in zip(p[d], row)])[s]
                rsum.append(rows.max())
                done.append((cnt >= k).all())
            return rsum, done

        iters = run_annealed(mesh, sweep, stats, eps=eps, delta0=delta0,
                             min_delta=min_delta, alpha=alpha,
                             max_iters=max_iters)
        vals, ids, p_local = [], [], []
        kc = min(kcap, n_local)
        for d, row in enumerate(shards):
            finals = [x if is_remote(x) else torch.where(z[None, :], oh, x)
                      for z, oh, x in zip(deg_src[d], onehot[d], p[d])]
            cand_v, cand_i = [], []
            for sh, x in zip(row, finals):
                if is_remote(sh):
                    cand_v.append(sh)
                    cand_i.append(sh)
                    continue
                v, i = torch.topk(x, kc, dim=0)
                cand_v.append(v)
                cand_i.append(i + sh.base)
            p_local.append(finals)
            # shard order keeps the candidates of a tie in node order
            all_v = mesh_mod.all_gather(cand_v, 0)
            all_i = mesh_mod.all_gather(cand_i, 0)
            if is_remote(row[0]):
                # the row's selection is its first shard's to hand out
                vals.append(row[0])
                ids.append(row[0])
                continue
            v, sel = torch.topk(all_v, min(kcap, all_v.shape[0]), dim=0)
            vals.append(v.T)
            ids.append(all_i.gather(0, sel).T)
        return vals, ids, p_local, iters

    return fn, shards


class NodeShardedForaTopk:
    """FORA top-k on a mesh with O(n/S) state a shard: the serving surface
    of :class:`~.sharded_fora.ShardedForaTopk`, with the annealed loop's
    decision points; the results differ from the single-device engine's
    only by the order in which the ring's blocks are added (and by the
    bf16 wire when ``ring_dtype="bf16"``)."""

    name = "FORA-Topk-node-sharded"

    def __init__(self, dataset, alpha: float = 0.15, k: int = 10, *,
                 mesh: Mesh | None = None,
                 max_iters: int = MAX_TOPK_SWEEPS, ring_dtype: str = "f32",
                 frontier_blocks: int | None = None, num_blocks: int = 64,
                 block_order: str = "degree"):
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        self.k = int(k)
        self.delta0 = 1.0 / self.k
        self.min_delta = 1.0 / self.graph.n
        self.max_iters = max_iters
        self.ring_dtype = ring_dtype
        self.frontier_blocks = frontier_blocks
        self.num_blocks = num_blocks
        self.block_order = block_order
        wire_dtype(ring_dtype)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n_local = self.graph.n_pad // self.mesh.graph
        self._programs: dict = {}
        #: sweeps of the last query
        self.last_iters: int | None = None

    def _pad_batch(self, sources) -> tuple[np.ndarray, int]:
        return pad_batch(sources, self.mesh.data)

    def _program(self, k: int, kcap: int):
        key = (k, kcap)
        if key not in self._programs:
            self._programs[key] = make_node_sharded_annealed_topk(
                self.mesh, self.graph, alpha=self.alpha, k=k, kcap=kcap,
                delta0=1.0 / k, min_delta=self.min_delta,
                max_iters=self.max_iters, ring_dtype=self.ring_dtype,
                frontier_blocks=self.frontier_blocks,
                num_blocks=self.num_blocks, block_order=self.block_order)
        return self._programs[key]

    def _run(self, sources: np.ndarray, k: int, kcap: int, eps: float):
        fn, _ = self._program(k, kcap)
        out = fn(np.asarray(sources, np.int32), eps)
        self.last_iters = out[3]
        return out

    def compute_topk_ids_batch(self, sources, k: int, param, *,
                               kcap: int | None = None):
        """Serving path: ``(values [B, K], ids [B, K])`` numpy, selected
        across the mesh; only ``[B, K]`` reaches the host."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return (np.zeros((0, 0), np.float32), np.zeros((0, 0), np.int64))
        eps = float(param) * 0.5          # eps' = eps/2 (Fora_Topk.java:110)
        sources_p, b = self._pad_batch(sources)
        kcap = topk_kcap(k, g.n_pad, kcap)
        vals, ids, _, _ = self._run(sources_p, k, kcap, eps)
        vals, ids = mesh_mod.fetch(self.mesh, [vals, ids])
        return (torch.cat([v.cpu() for v in vals]).numpy()[:b],
                torch.cat([i.cpu() for i in ids]).numpy()[:b])

    def compute_topk_batch(self, sources, k: int, param) -> np.ndarray:
        """Dense ``[B, n_pad]`` scores, the shards gathered to the host (a
        test and verification path)."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        eps = float(param) * 0.5
        sources_p, b = self._pad_batch(sources)
        _, _, p_local, _ = self._run(sources_p, k,
                                     topk_kcap(k, g.n_pad), eps)
        return gather_nodes(p_local, self.mesh).T.numpy()[:b]

    def final_state_shard_shape(self, batch: int) -> tuple[int, int]:
        """A shard's reserve, node-major: ``(n_pad / graph, B_pad /
        data)``, O(n/S) by design (the JAX package's batch-major shard is
        its transpose)."""
        b_pad = -(-max(8, batch) // self.mesh.data) * self.mesh.data
        return (self.n_local, b_pad // self.mesh.data)


# --------------------------------------------------------------------------
# FORA whole-graph: ring sweeps, then spmv or walk completion
# --------------------------------------------------------------------------

def make_node_sharded_walk_totals(mesh: Mesh, g: Graph, alpha: float):
    """``fn(r, omega) -> int64 [data, graph]``: each shard's walk count
    ``sum(ceil((1-alpha) r omega))`` over its residue chunk
    (``ppr_tpu/parallel/node_sharded_fora.py:542``), exact."""
    _, keep, _, _ = _loop_constants(alpha, 0.0)

    def fn(r, omega):
        totals = mesh_mod.fetch(mesh, [[
            x if is_remote(x) else _whole_graph_walk_setup(x * keep, omega)[0]
            .sum(dtype=torch.int64) for x in row] for row in r])
        return np.array([[int(x) for x in row] for row in totals], np.int64)

    return fn


def make_node_sharded_walk_completion(mesh: Mesh, g: Graph, alpha: float,
                                      *, max_steps: int | None = None):
    """``fn(p, r, generators, omega) -> p``: residual completion by walks
    over the node-sharded state (``ppr_tpu/parallel/node_sharded_fora.py:
    566``). Each shard adds ``alpha r`` to its reserve and expands its
    residue chunk into ``omega_i = ceil(r_i' omega)`` no-zero-hop walks of
    weight ``r_i'/omega_i`` each (``r' = (1-alpha) r``,
    Fora_Whole_Graph.java:119-140); the walkers stay on their shard, the
    CSR slices rotate, and the deposits come home through the counts
    ring. Every array a shard holds is O(n/S) or O(its walks)."""
    if max_steps is None:
        max_steps = default_max_steps(alpha)
    alpha_f, keep, _, _ = _loop_constants(alpha, 0.0)
    slices, n_local = csr_slices(g, mesh)

    def fn(p, r, generators, omega):
        b_l = next(x for row in r for x in row
                   if not is_remote(x)).shape[1]
        walkers, p_new = [], []
        for prow, rrow, row in zip(p, r, mesh.devices):
            wrow, prow_new = [], []
            for s, (x, y, dev) in enumerate(zip(prow, rrow, row)):
                if is_remote(x):
                    wrow.append(x)
                    prow_new.append(x)
                    continue
                om, w = _whole_graph_walk_setup(y * keep, omega)
                prow_new.append(torch.add(x, y, alpha=alpha_f))
                flat = om.reshape(-1)
                total = int(flat.sum(dtype=torch.int64))
                slots, _ = expand_walkers(flat, total) if total else (
                    torch.zeros(0, dtype=torch.int64, device=dev), None)
                wrow.append((
                    (s * n_local + torch.div(slots, b_l,
                                             rounding_mode="floor"))
                    .to(torch.int32),
                    slots % b_l, w.reshape(-1).index_select(0, slots)))
            walkers.append(wrow)
            p_new.append(prow_new)
        counts = ring_walks(mesh, slices, walkers, generators, alpha,
                            max_steps, n_local, b_l, no_zero_hop=True)
        return [[x if is_remote(x) else x + c for x, c in zip(prow, crow)]
                for prow, crow in zip(p_new, counts)]

    return fn


class NodeShardedForaWholeGraph:
    """FORA whole-graph on a mesh with O(n/S) state a shard
    (Fora_Whole_Graph.java:82-146): ring sweeps to a closed-form residue
    target, then ``completion="spmv"`` (more sweeps, down to ``eps *
    delta``) or ``"walks"`` (the rotating-adjacency walk ring)."""

    name = "FORA-node-sharded"

    def __init__(self, dataset, alpha: float = 0.15, *,
                 mesh: Mesh | None = None, completion: str = "spmv",
                 seed: int = 0, max_walkers_per_device: int = 1 << 26,
                 ring_dtype: str = "f32"):
        if completion not in ("spmv", "walks"):
            raise ValueError(f"completion must be 'spmv' or 'walks', got "
                             f"{completion!r}")
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        n = self.graph.n
        self.delta = 1.0 / n
        self.pfail = 1.0 / n
        self.completion = completion
        self.mesh = mesh if mesh is not None else make_mesh()
        self.max_walkers_per_device = max_walkers_per_device
        self.ring_dtype = ring_dtype
        self.generators = mesh_mod.shard_generators(self.mesh, seed)
        self._prepare, self._run_ring = make_node_sharded_propagate_ring(
            self.mesh, self.graph, self.alpha, ring_dtype=ring_dtype)
        self._totals = make_node_sharded_walk_totals(self.mesh, self.graph,
                                                     self.alpha)
        self._walks = None
        #: ring sweeps of the last call
        self.last_iters: int | None = None

    def _iters_to(self, rsum_from: float, rsum_to: float) -> int:
        if rsum_to >= rsum_from or rsum_from <= 0:
            return 0
        return int(math.ceil(math.log(rsum_to / rsum_from)
                             / math.log1p(-self.alpha)))

    def compute_whole_graph_batch(self, sources, param) -> np.ndarray:
        eps = float(param)
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        src_pad, b = pad_batch(sources, self.mesh.data)
        b_pad = len(src_pad)
        ln_term = math.log(2.0 / self.pfail)
        omega = (eps + 2.0) * ln_term / eps / eps / self.delta
        target = eps * self.delta

        p, r, onehot = self._prepare(src_pad)
        if self.completion == "spmv":
            iters = self._iters_to(1.0, target)
            p, r = self._run_ring(p, r, onehot, iters)
        else:
            # push until the walks fit the shards' pools: every row spawns
            # ~omega * rsum walkers and rsum(t) = (1-alpha)^t exactly; the
            # 0.5 margin absorbs the skew between shards
            budget = self.max_walkers_per_device * self.mesh.size
            rsum_target = min(1.0, 0.5 * budget / (omega * b_pad))
            iters = max(1, self._iters_to(1.0, rsum_target))
            p, r = self._run_ring(p, r, onehot, iters)
            per_dev = self._totals(r, omega)
            for _ in range(64):
                if per_dev.max() <= self.max_walkers_per_device:
                    break
                # each sweep shrinks every count by (1 - alpha)
                p, r = self._run_ring(p, r, onehot, 4)
                iters += 4
                per_dev = self._totals(r, omega)
            else:
                raise ValueError(
                    f"walk pool {int(per_dev.max())} exceeds the per-device "
                    "budget; raise max_walkers_per_device or use "
                    "completion='spmv'")
            if self._walks is None:
                self._walks = make_node_sharded_walk_completion(
                    self.mesh, g, self.alpha)
            p = self._walks(p, r, self.generators, omega)
        self.last_iters = iters
        out = gather_nodes(p, self.mesh).T.numpy().copy()
        # a dangling source never leaves itself: pi(s, s) = 1 exactly
        deg_src = g.out_deg.cpu().numpy()[src_pad]
        rows = np.nonzero(deg_src == 0)[0]
        if len(rows):
            out[rows] = 0.0
            out[rows, src_pad[rows]] = 1.0
        return out[:b]
