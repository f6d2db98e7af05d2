"""Node-sharded propagation and walks: the state's node dimension split
over ``graph`` — port of ``ppr_tpu/parallel/node_sharded.py``.

The edge-sharded engines (:mod:`.sharded`) replicate the node dimension on
every shard. Here nodes are split into ``graph`` contiguous ranges of
``n_local = n_pad / graph``: shard ``(d, s)`` holds the node-major
``[n_local, B/data]`` reserve and residue of its range, and the edges
whose destination lies in it, so every segment sum is local.

* :func:`make_node_sharded_propagate_ring`: each shard also splits its
  edges by the source's range (:func:`partition_edges_by_dst_src`), and the
  residue chunks circulate the ``graph`` ring: at hop ``t`` shard ``s``
  holds shard ``(s - t) mod S``'s chunk and pushes that block's edges into
  its own range (K3 over the block, its coefficient mode on a weighted
  graph). Every array a shard holds is O(n/S). ``ring_dtype="bf16"``
  sends each hop's chunk as bf16 and widens it to f32 on arrival; hop 0
  uses the unrounded local chunk.
* :func:`make_node_sharded_propagate`: the residue is all-gathered onto
  every shard each sweep (O(n) transients), and each shard pushes its
  edges (:func:`partition_edges_by_dst`) into its range.
* :func:`make_node_sharded_walk_counts`: walkers stay on their shard and
  the CSR slices rotate (:func:`partition_csr_by_node`); the stop counts
  circulate the same ring, so every array is O(n/S).

Dangling mass is a ``[1, B]`` ``psum`` returned to each column's source
(Power_Method.java:74-80). The partitions are host numpy arrays equal to
the JAX package's; the engines derive K3's operands from them (a row
pointer per block, the padding entries left out).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..graph.csr import Graph
from ..models.fora import _loop_constants
from ..ops.spmv import _safe_inv_deg, gather_segment_sum
from ..ops.walk import PHASE_STEPS
from . import mesh as mesh_mod
from .mesh import Mesh, is_remote, ppermute, psum

_WIRE = {"f32": None, "bf16": torch.bfloat16}


def wire_dtype(ring_dtype: str):
    """The ring's wire type: ``None`` for ``"f32"``, bf16 for ``"bf16"``."""
    if ring_dtype not in _WIRE:
        raise ValueError(f"ring_dtype must be 'f32' or 'bf16', got "
                         f"{ring_dtype!r}")
    return _WIRE[ring_dtype]


def _check_split(g: Graph, num_shards: int) -> int:
    if g.n_pad % num_shards:
        raise ValueError(f"n_pad {g.n_pad} not divisible by {num_shards}")
    return g.n_pad // num_shards


def _lanes(e_max: int) -> int:
    """Pad a per-shard edge count to a multiple of 128, at least 128."""
    return max(128, -(-e_max // 128) * 128)


def partition_edges_by_dst(g: Graph, num_shards: int):
    """``(src [S, E], dst_local [S, E], coef [S, E] or None, n_local)``:
    shard ``s`` takes the destination-sorted edges whose destination lies
    in its range, ``dst`` rebased to it; padding entries have the sentinel
    ``n_pad - 1`` as source (its residue is always zero) and the range's
    last node as destination (``ppr_tpu/parallel/node_sharded.py:35``)."""
    n_local = _check_split(g, num_shards)
    dst_sorted = g.edge_dst_bydst.cpu().numpy()
    src_sorted = g.edge_src_bydst.cpu().numpy()
    coef_sorted = g.edge_coef_bydst.cpu().numpy() if g.weighted else None
    bounds = np.searchsorted(dst_sorted, np.arange(0, g.n_pad + 1, n_local))
    e_max = _lanes(int(np.diff(bounds).max()))
    src_out = np.full((num_shards, e_max), g.n_pad - 1, np.int32)
    dst_out = np.zeros((num_shards, e_max), np.int32)
    coef_out = (np.zeros((num_shards, e_max), np.float32) if g.weighted
                else None)
    for s in range(num_shards):
        lo, hi = bounds[s], bounds[s + 1]
        cnt = hi - lo
        src_out[s, :cnt] = src_sorted[lo:hi]
        dst_out[s, :cnt] = dst_sorted[lo:hi] - s * n_local
        dst_out[s, cnt:] = n_local - 1
        if g.weighted:
            coef_out[s, :cnt] = coef_sorted[lo:hi]
    return src_out, dst_out, coef_out, n_local


def partition_edges_by_dst_src(g: Graph, num_shards: int):
    """``(src_local [S, S, E], dst_local [S, S, E], mask [S, S, E], coef
    [S, S, E] or None, n_local)``: block ``(d, s)`` holds the edges with
    destination in range ``d`` and source in range ``s``, both rebased,
    in destination order; padding entries have mask 0, source 0 and the
    range's last node as destination
    (``ppr_tpu/parallel/node_sharded.py:73``)."""
    n_local = _check_split(g, num_shards)
    dst_sorted = g.edge_dst_bydst.cpu().numpy()[: g.m]
    src_sorted = g.edge_src_bydst.cpu().numpy()[: g.m]
    coef_sorted = (g.edge_coef_bydst.cpu().numpy()[: g.m] if g.weighted
                   else None)
    d_shard = dst_sorted // n_local
    s_shard = src_sorted // n_local
    counts = np.zeros((num_shards, num_shards), np.int64)
    np.add.at(counts, (d_shard, s_shard), 1)
    e_max = _lanes(int(counts.max()) if g.m else 0)
    src_out = np.zeros((num_shards, num_shards, e_max), np.int32)
    dst_out = np.full((num_shards, num_shards, e_max), n_local - 1,
                      np.int32)
    mask_out = np.zeros((num_shards, num_shards, e_max), np.float32)
    coef_out = (np.zeros((num_shards, num_shards, e_max), np.float32)
                if g.weighted else None)
    key = d_shard * num_shards + s_shard
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    blocks = np.arange(num_shards * num_shards)
    starts = np.searchsorted(sorted_key, blocks)
    ends = np.searchsorted(sorted_key, blocks, side="right")
    for d in range(num_shards):
        for s in range(num_shards):
            blk = order[starts[d * num_shards + s]:ends[d * num_shards + s]]
            cnt = len(blk)
            src_out[d, s, :cnt] = src_sorted[blk] - s * n_local
            dst_out[d, s, :cnt] = dst_sorted[blk] - d * n_local
            mask_out[d, s, :cnt] = 1.0
            if g.weighted:
                coef_out[d, s, :cnt] = coef_sorted[blk]
    return src_out, dst_out, mask_out, coef_out, n_local


def partition_csr_by_node(g: Graph, num_shards: int):
    """``(indptr_local [S, n_local + 1], indices [S, E], alias_prob [S, E]
    or None, alias_other [S, E] or None, n_local)``: shard ``s``'s slice of
    the CSR, ``indptr`` rebased to 0, ``indices`` global node ids, alias
    slots rebased to the slice (``ppr_tpu/parallel/node_sharded.py:306``)."""
    n_local = _check_split(g, num_shards)
    indptr = g.indptr.cpu().numpy()
    indices = g.indices.cpu().numpy()
    weighted = g.alias_prob is not None
    prob = g.alias_prob.cpu().numpy() if weighted else None
    other = g.alias_other.cpu().numpy() if weighted else None
    bounds = indptr[np.arange(0, g.n_pad + 1, n_local)]
    counts = np.diff(bounds)
    e_max = _lanes(int(counts.max()) if len(counts) else 0)
    ip_out = np.zeros((num_shards, n_local + 1), np.int32)
    idx_out = np.full((num_shards, e_max), g.n_pad - 1, np.int32)
    prob_out = np.ones((num_shards, e_max), np.float32) if weighted else None
    other_out = (np.tile(np.arange(e_max, dtype=np.int32), (num_shards, 1))
                 if weighted else None)
    for s in range(num_shards):
        lo, hi = int(bounds[s]), int(bounds[s + 1])
        ip_out[s] = indptr[s * n_local:(s + 1) * n_local + 1] - lo
        idx_out[s, : hi - lo] = indices[lo:hi]
        if weighted:
            prob_out[s, : hi - lo] = prob[lo:hi]
            other_out[s, : hi - lo] = other[lo:hi] - lo
    return ip_out, idx_out, prob_out, other_out, n_local


# -- K3 operands and the node-major state --------------------------------

@dataclasses.dataclass
class Block:
    """K3's operands for one block of edges on one device: sources into
    the visiting table, a row pointer over the shard's ``n_local``
    destinations and, on a weighted graph, the coefficients. ``src`` is
    ``None`` for a block with no edges."""

    src: torch.Tensor | None
    ptr: torch.Tensor | None
    coef: torch.Tensor | None

    def push(self, table: torch.Tensor) -> torch.Tensor | None:
        """The block's contribution ``[n_local, B]``, or ``None`` when it
        has no edges."""
        if self.src is None:
            return None
        return gather_segment_sum(table, self.src, self.ptr, coef=self.coef)


def make_block(src, dst, coef, n_local: int, device) -> Block:
    """A :class:`Block` from host arrays of real (unpadded) edges sorted by
    ``dst``."""
    if len(src) == 0:
        return Block(None, None, None)

    def put(x):
        return torch.tensor(np.ascontiguousarray(x), device=device)

    ptr = np.searchsorted(dst, np.arange(n_local + 1)).astype(np.int64)
    return Block(put(np.asarray(src, np.int32)), put(ptr),
                 None if coef is None else put(np.asarray(coef, np.float32)))


@dataclasses.dataclass
class NodeShard:
    """What shard ``(d, s)`` of a node-sharded engine holds for its range:
    the ring's blocks ``blocks[s_src]`` (their sources remapped when the
    chunk travels in a permuted order), the range's inverse degrees,
    dangling ids and out-degrees, and the frontier's column order."""

    device: torch.device
    base: int
    weighted: bool
    blocks: list[Block]
    inv_deg: torch.Tensor        # f32[n_local]
    dang_ids: torch.Tensor       # int64[#dangling in range], local ids
    out_deg: torch.Tensor        # int32[n_local]
    perm: torch.Tensor | None = None   # int64[n_local], frontier order


def node_shards(g: Graph, mesh: Mesh,
                col_perm: np.ndarray | None = None) -> list[list[NodeShard]]:
    """``[data][graph]`` :class:`NodeShard` s of ``g`` over the ring blocks
    of :func:`partition_edges_by_dst_src`. ``col_perm [S, n_local]``
    (``col_perm[s, j]`` the local node of range ``s`` at position ``j``)
    remaps each block's sources into the permuted order the frontier ring
    sends (``ppr_tpu/parallel/node_sharded_fora.py:56``)."""
    s_graph = mesh.graph
    src_b, dst_b, mask_b, coef_b, n_local = partition_edges_by_dst_src(
        g, s_graph)
    if col_perm is not None:
        inv = np.empty_like(col_perm)
        np.put_along_axis(inv, col_perm, np.broadcast_to(
            np.arange(n_local), col_perm.shape), axis=1)
        for s_src in range(s_graph):
            src_b[:, s_src, :] = inv[s_src][src_b[:, s_src, :]]
    out_deg = g.out_deg.cpu().numpy()
    inv_deg = _safe_inv_deg(g.out_deg.cpu()).numpy()
    dang = g.dang_ids.cpu().numpy()

    def shard(d, s, dev):
        lo = s * n_local
        blocks = []
        for s_src in range(s_graph):
            cnt = int(mask_b[s, s_src].sum())
            blocks.append(make_block(
                src_b[s, s_src, :cnt], dst_b[s, s_src, :cnt],
                None if coef_b is None else coef_b[s, s_src, :cnt],
                n_local, dev))
        local_dang = dang[(dang >= lo) & (dang < lo + n_local)] - lo
        return NodeShard(
            device=dev, base=lo, weighted=g.weighted, blocks=blocks,
            inv_deg=torch.tensor(inv_deg[lo:lo + n_local], device=dev),
            dang_ids=torch.tensor(local_dang.astype(np.int64), device=dev),
            out_deg=torch.tensor(out_deg[lo:lo + n_local], device=dev),
            perm=None if col_perm is None else torch.tensor(
                col_perm[s].astype(np.int64), device=dev))

    return mesh.grid(shard)


def put_nodes(mesh: Mesh, x_t) -> list[list[torch.Tensor]]:
    """``[data][graph]`` parts of a node-major ``x_t [n_pad, B]``: shard
    ``(d, s)`` takes range ``s``'s rows of data shard ``d``'s columns, a
    contiguous tensor of its own on its device."""
    x_t = torch.as_tensor(x_t)
    cols = mesh_mod.split(x_t.shape[1], mesh.data)
    rows = mesh_mod.split(x_t.shape[0], mesh.graph)
    return mesh.grid(lambda d, s, dev: x_t[rows[s], cols[d]].contiguous()
                     .to(dev, copy=True))


def gather_nodes(parts, mesh: Mesh | None = None) -> torch.Tensor:
    """The node-major ``[n_pad, B]`` of node-sharded parts, on the host
    (every rank of a ``mesh`` across processes calls it and gets it)."""
    if mesh is not None:
        parts = mesh_mod.fetch(mesh, parts)
    return torch.cat([torch.cat([x.cpu() for x in row], dim=0)
                      for row in parts], dim=1)


def local_onehot(sources: np.ndarray, base: int, n_local: int,
                 device) -> torch.Tensor:
    """``[n_local, B]``: the rows ``base ..`` of the node-major one-hot of
    ``sources``."""
    ids = torch.arange(base, base + n_local, device=device)
    srcs = torch.as_tensor(np.asarray(sources, np.int64), device=device)
    return (ids[:, None] == srcs[None, :]).to(torch.float32)


def ring_push(devices, payloads, table_of, blocks_of, wire):
    """One sweep's ring: ``acc[s]`` sums, over hops ``t = 0 .. S-1``, block
    ``(s - t) mod S`` of shard ``s`` pushed from the payload visiting
    ``s`` at hop ``t`` (``table_of(payload)`` is its dense table). The
    payloads (tuples of tensors; :class:`~.mesh.Remote` at another rank's
    positions) move one step after each hop but the last; float parts
    travel as ``wire`` when it is set. Returns ``acc`` (``None`` where a
    shard had no edges at all, the payload's :class:`~.mesh.Remote` at
    another rank's position)."""
    n = len(devices)
    acc = [x if is_remote(x) else None for x in payloads]
    for t in range(n):
        for s in range(n):
            if is_remote(payloads[s]):
                continue
            add = blocks_of(s)[(s - t) % n].push(table_of(payloads[s]))
            if add is not None:
                acc[s] = add if acc[s] is None else acc[s] + add
        if t < n - 1:
            payloads = ppermute(payloads, devices, wire)
    return acc


def _devices(shards) -> list:
    """The ring's devices (``None`` at another rank's position)."""
    return [None if is_remote(sh) else sh.device for sh in shards]


def ring_sweep(shards, p, r, onehot, alpha: float, wire, live=None):
    """One propagation sweep of a data row over the dense ring: ``p +=
    alpha*r``; ``r = ring_push((1-alpha) r [/ d]) + dangling mass at the
    source``. With ``live`` (a bool scalar a device) a sweep on a
    non-live flag leaves ``(p, r)`` as they were. Returns the new row
    lists."""
    alpha_f, keep, _, _ = _loop_constants(alpha, 0.0)
    chunks, dangs, p_new = [], [], []
    for s, sh in enumerate(shards):
        if is_remote(sh):
            p_new.append(sh)
            dangs.append(sh)
            chunks.append(sh)
            continue
        if live is None:
            p_new.append(torch.add(p[s], r[s], alpha=alpha_f))
        else:
            # a frozen sweep adds r * 0: p is unchanged bit for bit
            p_new.append(torch.addcmul(p[s], r[s], live[sh.device] * alpha_f))
        rem = r[s] * keep
        dangs.append(rem.index_select(0, sh.dang_ids)
                     .sum(dim=0, keepdim=True))
        chunks.append((rem if sh.weighted else rem * sh.inv_deg[:, None],))
    acc = ring_push(_devices(shards), chunks, lambda pl: pl[0],
                    lambda s: shards[s].blocks, wire)
    dang = psum(dangs)
    r_new = []
    for s, sh in enumerate(shards):
        if is_remote(sh):
            r_new.append(sh)
            continue
        a = acc[s] if acc[s] is not None else torch.zeros_like(r[s])
        nxt = torch.addcmul(a, dang[s], onehot[s])
        r_new.append(nxt if live is None
                     else torch.where(live[sh.device], nxt, r[s]))
    return p_new, r_new


def make_node_sharded_propagate_ring(mesh: Mesh, g: Graph, alpha: float,
                                     ring_dtype: str = "f32"):
    """``(prepare, run)``: node-sharded propagation with the residue chunks
    circulating the ``graph`` ring (``ppr_tpu/parallel/node_sharded.py:126``).

    ``prepare(sources) -> (p, r, onehot)`` places the state, ``[data]
    [graph]`` node-major parts ``[n_local, B/data]`` (``p`` zero, ``r``
    and ``onehot`` the sources' one-hot); ``run(p, r, onehot, num_iters)
    -> (p, r)`` runs ``num_iters`` sweeps. Each shard holds its own chunk
    and one visiting chunk: O(n/S) state. ``ring_dtype="bf16"`` sends the
    visiting chunk as bf16 (at most S-1 roundings of 2^-8 a value)."""
    wire = wire_dtype(ring_dtype)
    shards = node_shards(g, mesh)
    n_local = g.n_pad // mesh.graph

    def prepare(sources):
        sources = np.asarray(sources, np.int32)
        cols = mesh_mod.split(len(sources), mesh.data)
        p, r, onehot = [], [], []
        for c, row in zip(cols, shards):
            oh = [sh if is_remote(sh) else
                  local_onehot(sources[c], sh.base, n_local, sh.device)
                  for sh in row]
            p.append([x if is_remote(x) else torch.zeros_like(x)
                      for x in oh])
            r.append([x if is_remote(x) else x.clone() for x in oh])
            onehot.append(oh)
        return p, r, onehot

    def run(p, r, onehot, num_iters: int):
        p = [list(row) for row in p]
        r = [list(row) for row in r]
        for _ in range(int(num_iters)):
            for d, row in enumerate(shards):
                p[d], r[d] = ring_sweep(row, p[d], r[d], onehot[d], alpha,
                                        wire)
        return p, r

    return prepare, run


def make_node_sharded_propagate(mesh: Mesh, g: Graph, alpha: float):
    """``(step, prepare, run)``: node-sharded propagation whose residue is
    all-gathered onto every shard each sweep
    (``ppr_tpu/parallel/node_sharded.py:505``): shard ``s`` gathers the
    whole ``[n_pad, B/data]`` residue and pushes the edges of
    :func:`partition_edges_by_dst` into its range. ``step(p, r, onehot)``
    is one sweep, ``run(p, r, onehot, num_iters)`` several, ``prepare``
    as :func:`make_node_sharded_propagate_ring`'s."""
    alpha_f, keep, _, _ = _loop_constants(alpha, 0.0)
    src_sh, dst_sh, coef_sh, n_local = partition_edges_by_dst(g, mesh.graph)
    inv_deg = _safe_inv_deg(g.out_deg.cpu())
    dang = g.dang_ids.cpu()
    per_dev = {dev: (inv_deg.to(dev), dang.to(dev))
               for dev in mesh.unique_devices()}
    blocks = mesh.grid(lambda d, s, dev: make_block(
        src_sh[s], dst_sh[s], None if coef_sh is None else coef_sh[s],
        n_local, dev))
    prepare, _ = make_node_sharded_propagate_ring(mesh, g, alpha)

    def step(p, r, onehot):
        p_out, r_out = [], []
        for d, row in enumerate(mesh.devices):
            rems = [x if is_remote(x) else x * keep for x in r[d]]
            p_out.append([x if is_remote(x) else
                          torch.add(x, y, alpha=alpha_f)
                          for x, y in zip(p[d], r[d])])
            # one gather a row: every rank of the row makes it once
            gathered = mesh_mod.all_gather(rems, 0)
            r_row = []
            for s, dev in enumerate(row):
                if not mesh.is_local(d, s):
                    r_row.append(mesh.remote(d, s))
                    continue
                full = gathered.to(dev)
                inv, dang_ids = per_dev[dev]
                dang_mass = full.index_select(0, dang_ids).sum(
                    dim=0, keepdim=True)
                table = full if g.weighted else full * inv[:, None]
                r_row.append(torch.addcmul(blocks[d][s].push(table),
                                           dang_mass, onehot[d][s]))
            r_out.append(r_row)
        return p_out, r_out

    def run(p, r, onehot, num_iters: int):
        for _ in range(int(num_iters)):
            p, r = step(p, r, onehot)
        return p, r

    return step, prepare, run


# -- the rotating-adjacency walk ring ------------------------------------

def csr_slices(g: Graph, mesh: Mesh):
    """``([data][graph] slices, n_local)``: shard ``s``'s CSR slice of
    :func:`partition_csr_by_node` as ``(indptr int64, indices, alias_prob,
    alias_other int64)`` tensors on each device of column ``s`` (the alias
    tables ``None`` on a uniform graph)."""
    ip, idx, prob, other, n_local = partition_csr_by_node(g, mesh.graph)

    def put(x, dev, dtype=None):
        if x is None:
            return None
        return torch.tensor(x if dtype is None else x.astype(dtype),
                            device=dev)

    return mesh.grid(lambda d, s, dev: (
        put(ip[s], dev, np.int64), put(idx[s], dev),
        put(None if prob is None else prob[s], dev),
        put(None if other is None else other[s], dev, np.int64))), n_local


def ring_move(devices, slices, cur, u, u2, need, starts, n_local: int):
    """One move of every walker of a data row: ``S`` hops, at hop ``t``
    shard ``s`` holds slice ``(s - t) mod S`` and moves its walkers that
    stand in that range (to the neighbour ``u`` picks, through the alias
    tables with ``u2`` on a weighted graph, or back to the start from a
    dangling node); the slices rotate after every hop and are home after
    the last. Returns ``(next nodes, slices)``."""
    n = len(devices)
    nxt = list(cur)
    for t in range(n):
        for s in range(n):
            c = cur[s]
            if is_remote(c) or c.numel() == 0:
                continue
            ip, idx, prob, other = slices[s]
            b0 = ((s - t) % n) * n_local
            here = need[s] & (c >= b0) & (c < b0 + n_local)
            lv = (c - b0).clamp(0, n_local - 1).to(torch.int64)
            lo = ip.index_select(0, lv)
            deg = ip.index_select(0, lv + 1) - lo
            pick = torch.minimum((u[s] * deg.to(torch.float32))
                                 .to(torch.int64), deg - 1).clamp_min(0)
            slot = (lo + pick).clamp_max(idx.shape[0] - 1)
            if prob is not None:
                accept = u2[s] < prob.index_select(0, slot)
                slot = torch.where(accept, slot, other.index_select(0, slot))
            cand = torch.where(deg > 0, idx.index_select(0, slot), starts[s])
            nxt[s] = torch.where(here, cand, nxt[s])
        slices = ppermute(slices, devices)
    return nxt, slices


def ring_walks(mesh: Mesh, slices, walkers, generators, alpha: float,
               max_steps: int, n_local: int, b_local: int, *,
               no_zero_hop: bool = False):
    """Walk every shard's walkers over the rotating CSR slices and deposit
    their weights at their stop nodes through the counts ring.

    ``walkers[d][s]`` is ``(starts int32, rows int64, weights)`` on shard
    ``(d, s)``: walker ``j`` starts at the global node ``starts[j]`` and
    deposits ``weights[j]`` in column ``rows[j]`` of its data row. A step
    stops a walker with probability ``alpha`` before its move
    (Monte_Carlo.java:76-90); ``no_zero_hop`` moves every walker once
    first (Fora_Whole_Graph.java:134). The host reads "any walker active"
    every ``PHASE_STEPS`` steps; a step with none changes nothing. Counts
    are added in float64 and returned as f32 ``[data][graph]`` parts
    ``[n_local, b_local]``."""
    weighted = next(x for row in slices for x in row
                    if not is_remote(x))[2] is not None
    slices = [list(row) for row in slices]
    cur, active = [], []
    for row in walkers:
        cur.append([w if is_remote(w) else w[0] for w in row])
        active.append([w if is_remote(w) else
                       torch.ones_like(w[0], dtype=torch.bool) for w in row])

    def draws(d):
        us, u2s = [], []
        for s, w in enumerate(walkers[d]):
            if is_remote(w):
                us.append(w)
                u2s.append(w)
                continue
            st, gen = w[0], generators[d][s]
            us.append(torch.rand(st.shape[0], generator=gen,
                                 device=st.device))
            u2s.append(torch.rand(st.shape[0], generator=gen,
                                  device=st.device) if weighted else None)
        return us, u2s

    starts = [list(row) for row in cur]
    if no_zero_hop:
        for d, row in enumerate(mesh.devices):
            u, u2 = draws(d)
            cur[d], slices[d] = ring_move(row, slices[d], cur[d], u, u2,
                                          active[d], starts[d], n_local)
    for step in range(max_steps):
        for d, row in enumerate(mesh.devices):
            u, u2 = draws(d)
            go = [x if is_remote(x) else a & (x >= alpha)
                  for a, x in zip(active[d], u)]
            u_move = [x if is_remote(x) else
                      (x - alpha) * (1.0 / (1.0 - alpha)) for x in u]
            nxt, slices[d] = ring_move(row, slices[d], cur[d], u_move, u2,
                                       go, starts[d], n_local)
            cur[d] = [c if is_remote(c) else torch.where(g_, x, c)
                      for g_, x, c in zip(go, nxt, cur[d])]
            active[d] = go
        if (step + 1) % PHASE_STEPS == 0 and not bool(mesh_mod.pmax(
                [a if is_remote(a) else a.any().to(torch.int32)
                 for row in active for a in row], mesh)[0]):
            break

    out = []
    for d, row in enumerate(mesh.devices):
        n = len(row)
        counts = [torch.zeros(n_local * b_local, dtype=torch.float64,
                              device=dev) if mesh.is_local(d, s)
                  else mesh.remote(d, s) for s, dev in enumerate(row)]
        for t in range(n):
            for s in range(n):
                if is_remote(cur[d][s]):
                    continue
                stops, cols, w = cur[d][s], walkers[d][s][1], walkers[d][s][2]
                if stops.numel():
                    b0 = ((s - t) % n) * n_local
                    here = (stops >= b0) & (stops < b0 + n_local)
                    lv = (stops - b0).clamp(0, n_local - 1).to(torch.int64)
                    counts[s].index_add_(
                        0, lv * b_local + cols,
                        torch.where(here, w.to(torch.float64), 0.0))
            counts = ppermute(counts, row)
        out.append([c if is_remote(c) else
                    c.view(n_local, b_local).to(torch.float32)
                    for c in counts])
    return out


def make_node_sharded_walk_counts(mesh: Mesh, g: Graph, alpha: float,
                                  max_steps: int = 128):
    """``call(starts, weights, seed) -> counts``: walkers stay on their
    shard and the CSR slices rotate (``ppr_tpu/parallel/node_sharded.py:
    343``). ``starts`` and ``weights`` are host ``[B, W]`` arrays, rows
    split over ``data`` and walkers over ``graph``; the counts come back as
    ``[data][graph]`` node-major parts ``[n_local, B/data]``. Each shard
    draws from its own generator, seeded from ``seed`` and its index."""
    slices, n_local = csr_slices(g, mesh)

    def call(starts, weights, seed: int):
        starts = np.asarray(starts, np.int32)
        weights = np.asarray(weights, np.float32)
        rows_of = mesh_mod.split(starts.shape[0], mesh.data)
        cols_of = mesh_mod.split(starts.shape[1], mesh.graph)
        b_l = starts.shape[0] // mesh.data

        def walkers_of(d, s, dev):
            st = starts[rows_of[d], cols_of[s]]
            return (torch.as_tensor(st.reshape(-1), device=dev),
                    torch.arange(b_l, device=dev).repeat_interleave(
                        st.shape[1]),
                    torch.as_tensor(weights[rows_of[d], cols_of[s]]
                                    .reshape(-1), device=dev))

        walkers = mesh.grid(walkers_of)
        return ring_walks(mesh, slices, walkers,
                          mesh_mod.shard_generators(mesh, seed), alpha,
                          max_steps, n_local, b_l)

    return call
