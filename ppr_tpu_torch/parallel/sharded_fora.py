"""FORA top-k on a device mesh, edge-sharded — port of
``ppr_tpu/parallel/sharded_fora.py``.

The δ-annealing loop of :func:`~..models.fora.annealed_topk_propagate`
(Fora_Topk.java:102-184: delta annealed /4 from 1/k to 1/n, stop once the
k-th reserve is >= (1+eps')*delta) on a ``(data, graph)`` mesh:

* ``data`` splits the batch: each data row holds the node-major ``[n_pad,
  B/data]`` reserve, residue and source one-hot, its own contiguous
  tensors, replicated on every device of the row;
* ``graph`` splits the destination-sorted edges into contiguous chunks:
  each shard's push is K3 over its chunk (:class:`~.sharded.EdgeChunk`),
  and :func:`~.mesh.psum` over ``graph``, in shard order, completes it.

Loop control is :func:`~.sharded.run_annealed`: the flags are combined
over the mesh, every shard runs the same sweeps, and the count equals the
JAX package's. The dangling-source short-circuit (Fora_Topk.java:128-132)
and the top-kcap selection run on each data row's first device, so only
``[B, kcap]`` reaches the host. Every edge is pushed through K3: the mesh
engines have no hub split, as in the JAX package. On a 1x1 mesh the
arithmetic is the single-device annealed loop's without a hub split, bit
for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.fora import MAX_TOPK_SWEEPS, _loop_constants, topk_kcap
from . import mesh as mesh_mod
from .mesh import Mesh, is_remote, make_mesh, psum
from .sharded import EdgeChunk, edge_chunks, onehot_t, run_annealed


def pad_batch(sources, unit: int, min_b: int = 8) -> tuple[np.ndarray, int]:
    """``(sources padded, b)``: the batch padded with node 0 to a multiple
    of ``unit`` (the mesh's ``data``) and to at least ``min_b`` rows, as
    the single-device engine pads (``models/fora._pad_sources``); the
    consumers drop the padding rows (``_pad_rows`` of
    ``ppr_tpu/parallel/mesh_algos.py:52`` too)."""
    sources = np.asarray(sources, np.int32)
    b = len(sources)
    b_pad = -(-max(min_b, b) // unit) * unit
    if b_pad > b:
        sources = np.concatenate([sources, np.zeros(b_pad - b, np.int32)])
    return sources, b


def make_sharded_annealed_topk(mesh: Mesh, chunks: list[list[EdgeChunk]],
                               *, alpha: float, k: int, kcap: int,
                               delta0: float, min_delta: float,
                               max_iters: int = MAX_TOPK_SWEEPS):
    """The end-to-end program (``ppr_tpu/parallel/sharded_fora.py:63``):
    ``fn(sources, p, r, src, eps) -> (vals, ids, p_final, iters)``.

    ``sources`` holds the padded batch (host int32); ``p``, ``r`` and
    ``src`` are ``[data][graph]`` node-major parts (:func:`prepare_state`)
    and are not written in place; ``eps`` is ``eps'``. ``vals`` and ``ids``
    are each data row's ``[B/data, kcap]`` on the row's first device,
    ``p_final`` the rows' short-circuited reserves ``[n_pad, B/data]``
    (:class:`~.mesh.Remote` where another rank owns that device), and
    ``iters`` the sweep count."""
    alpha_f, keep, _, _ = _loop_constants(alpha, 0.0)

    def fn(sources, p, r, src, eps):
        p = [list(row) for row in p]
        r = [list(row) for row in r]

        def sweep(live):
            for d, row in enumerate(chunks):
                partials, dangs = [], []
                for s, ch in enumerate(row):
                    if is_remote(ch):
                        partials.append(ch)
                        dangs.append(ch)
                        continue
                    lv = live[ch.src.device]
                    # a frozen sweep adds r * 0: p is unchanged bit for bit
                    p[d][s] = torch.addcmul(p[d][s], r[d][s], lv * alpha_f)
                    rem = r[d][s] * keep
                    dangs.append(rem.index_select(0, ch.dang_ids)
                                 .sum(dim=0, keepdim=True))
                    partials.append(ch.push(rem))
                pushed = psum(partials)
                for s, ch in enumerate(row):
                    if is_remote(ch):
                        continue
                    r_new = torch.addcmul(pushed[s], dangs[s], src[d][s])
                    r[d][s] = torch.where(live[ch.src.device], r_new,
                                          r[d][s])

        def stats(thresh):
            # the graph replicas of a row agree bit for bit (each holds the
            # same psum), so a rank's first shard of the row speaks for it
            rsum, done = [], []
            for d, row in enumerate(chunks):
                s = mesh.speaker(d)
                if s is None:
                    continue
                t = thresh[row[s].src.device]
                rsum.append(r[d][s].sum(dim=0).max())
                done.append(((p[d][s] >= t).sum(dim=0) >= k).all())
            return rsum, done

        iters = run_annealed(mesh, sweep, stats, eps=eps, delta0=delta0,
                             min_delta=min_delta, alpha=alpha,
                             max_iters=max_iters)
        vals, ids, finals = [], [], []
        b_l = len(sources) // mesh.data
        for d, row in enumerate(chunks):
            ch = row[0]
            if is_remote(ch):
                vals.append(ch)
                ids.append(ch)
                finals.append(ch)
                continue
            srcs = torch.as_tensor(sources[d * b_l:(d + 1) * b_l],
                                   dtype=torch.int64, device=ch.src.device)
            deg_src = ch.out_deg.index_select(0, srcs)[None, :]
            p_final = torch.where(deg_src == 0, src[d][0], p[d][0])
            v, i = torch.topk(p_final, kcap, dim=0)
            vals.append(v.T)
            ids.append(i.T)
            finals.append(p_final)
        return vals, ids, finals, iters

    return fn


def prepare_state(mesh: Mesh, chunks, sources: np.ndarray, n_pad: int):
    """``(p, r, src)`` ``[data][graph]`` node-major parts for the padded
    batch: ``p`` zero, ``src`` the one-hot, ``r`` the one-hot except on
    rows whose source is dangling, which start (and stay) at zero; the
    epilogue short-circuits them to ``e_s`` (Fora_Topk.java:128-132)."""
    b_l = len(sources) // mesh.data
    p, r, src = [], [], []
    for d, row in enumerate(chunks):
        srcs = sources[d * b_l:(d + 1) * b_l]
        prow, rrow, srow = [], [], []
        for ch in row:
            if is_remote(ch):
                prow.append(ch)
                rrow.append(ch)
                srow.append(ch)
                continue
            dev = ch.src.device
            oh = onehot_t(srcs, n_pad, dev)
            deg = ch.out_deg.index_select(
                0, torch.as_tensor(srcs, dtype=torch.int64, device=dev))
            rrow.append(torch.where(deg[None, :] == 0, 0.0, oh))
            prow.append(torch.zeros_like(oh))
            srow.append(oh)
        p.append(prow)
        r.append(rrow)
        src.append(srow)
    return p, r, src


class ShardedForaTopk:
    """FORA top-k on a mesh, edge-sharded: the serving surface of
    :class:`~..models.fora.ForaTopk` (``compute_topk_ids_batch``,
    ``compute_topk_batch``) with the annealed loop's decision points; the
    results differ from the single-device engine's only by the order in
    which the chunks' partial sums are added."""

    name = "FORA-Topk-sharded"

    def __init__(self, dataset, alpha: float = 0.15, k: int = 10, *,
                 mesh: Mesh | None = None,
                 max_iters: int = MAX_TOPK_SWEEPS):
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        self.k = int(k)
        self.delta0 = 1.0 / self.k
        self.min_delta = 1.0 / self.graph.n
        self.max_iters = max_iters
        self.mesh = mesh if mesh is not None else make_mesh()
        # the JAX package's _shard_edges (sharded_fora.py:45)
        self._chunks = edge_chunks(self.graph, self.mesh)
        self._programs: dict = {}
        #: sweeps of the last query
        self.last_iters: int | None = None

    def _pad_batch(self, sources) -> tuple[np.ndarray, int]:
        return pad_batch(sources, self.mesh.data)

    def _program(self, k: int, kcap: int):
        key = (k, kcap)
        if key not in self._programs:
            self._programs[key] = make_sharded_annealed_topk(
                self.mesh, self._chunks, alpha=self.alpha, k=k, kcap=kcap,
                delta0=1.0 / k, min_delta=self.min_delta,
                max_iters=self.max_iters)
        return self._programs[key]

    def _run(self, sources: np.ndarray, k: int, kcap: int, eps: float):
        fn = self._program(k, kcap)
        out = fn(sources, *prepare_state(self.mesh, self._chunks, sources,
                                         self.graph.n_pad), eps)
        self.last_iters = out[3]
        return out

    def compute_topk_ids_batch(self, sources, k: int, param, *,
                               kcap: int | None = None):
        """Serving path: ``(values [B, K], ids [B, K])`` numpy, selected on
        the mesh; only ``[B, K]`` reaches the host."""
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
        """Dense ``[B, n_pad]`` scores (a host copy of the whole state: a
        test and verification path)."""
        k = int(k) if k and k > 0 else self.k
        g = self.graph
        if len(sources) == 0:
            return np.zeros((0, g.n_pad), np.float32)
        eps = float(param) * 0.5
        sources_p, b = self._pad_batch(sources)
        _, _, finals, _ = self._run(sources_p, k,
                                    topk_kcap(k, g.n_pad), eps)
        finals = mesh_mod.fetch(self.mesh, finals)
        return torch.cat([x.cpu() for x in finals], dim=1).T.numpy()[:b]
