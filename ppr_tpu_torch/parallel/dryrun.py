"""The mesh dry run — port of the contract of
``__graft_entry__.py::dryrun_multichip`` (its lines 73-230).

:func:`dryrun_multichip` builds an ``n_devices`` mesh and runs every
engine of :mod:`ppr_tpu_torch.parallel` on small seeded graphs, holding
each to the single-device engine: a correctness run, not a compile check.
Its sharded BASE part, :func:`dryrun_sharded_base`, holds both all-pair
engines to the single-device backward search and runs each protocol
algorithm's preprocessing through :func:`~.mesh_algos.mesh_algo_obj`,
reading a stored row back. ``devices=["cuda:0"] * 4`` runs it on one
card, ``["cpu"] * 8`` on the CPU; ``mesh=global_mesh()`` runs it on a
mesh across processes (every rank calls it; the stores go to a directory
rank 0 names, which the ranks must share).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import numpy as np

from ..graph.io import synthetic_powerlaw
from ..models.backward_search import BackwardSearch
from ..models.config import AlgoType
from ..models.fora import ForaTopk
from ..ops.topk import topk_ids_with_ties
from .mesh import Mesh, is_remote, make_mesh
from .mesh_algos import mesh_algo_obj
from .node_sharded import (gather_nodes, make_node_sharded_propagate_ring,
                           make_node_sharded_walk_counts)
from .node_sharded_allpair import NodeShardedBackwardSearch
from .node_sharded_fora import NodeShardedForaTopk, NodeShardedForaWholeGraph
from .sharded import gather_columns, sharded_fora_step
from .sharded_allpair import ShardedBackwardSearch
from .sharded_fora import ShardedForaTopk


def dryrun_multichip(n_devices: int | None = None, devices=None, *,
                     mesh: Mesh | None = None) -> dict:
    """Run the mesh engines on ``mesh`` (default ``make_mesh(n_devices,
    devices=devices)``) and check them; raises ``AssertionError`` on a
    mismatch. Returns what it measured (errors and sweep counts)."""
    if mesh is None:
        mesh = make_mesh(n_devices, devices=devices)
    ds = synthetic_powerlaw(512, 4, seed=1, dense_threshold=0,
                            device=mesh.controller)
    k, eps = 10, 0.5
    sources = np.arange(8, dtype=np.int32) * 13 % ds.graph.n
    out = {"mesh": mesh.shape}

    single = ForaTopk(ds, 0.15, k, seed=7, push="none")
    dense_single = single.compute_topk_batch(sources, k, eps)

    def same_as_single(dense, what):
        np.testing.assert_allclose(dense, dense_single, atol=5e-6,
                                   rtol=1e-4, err_msg=what)
        for i in range(len(sources)):
            got = set(topk_ids_with_ties(dense[i], k, tol=1e-6).tolist())
            want = set(topk_ids_with_ties(dense_single[i], k,
                                          tol=1e-6).tolist())
            assert got == want, f"{what} row {i}: top-k != single-device"
        return float(np.abs(dense - dense_single).max())

    edge = ShardedForaTopk(ds, alpha=0.15, k=k, mesh=mesh)
    out["edge_err"] = same_as_single(edge.compute_topk_batch(sources, k, eps),
                                     "edge engine")
    node = NodeShardedForaTopk(ds, alpha=0.15, k=k, mesh=mesh)
    dense_node = node.compute_topk_batch(sources, k, eps)
    out["node_err"] = same_as_single(dense_node, "node engine")
    out["sweeps"] = {"single": single.last_iters, "edge": edge.last_iters,
                     "node": node.last_iters}
    assert edge.last_iters == node.last_iters == single.last_iters, \
        out["sweeps"]

    # frontier compaction at full capacity is the dense ring, bit for bit
    frontier = NodeShardedForaTopk(ds, alpha=0.15, k=k, mesh=mesh,
                                   frontier_blocks=16, num_blocks=16)
    np.testing.assert_array_equal(
        frontier.compute_topk_batch(sources, k, eps), dense_node)

    # the reserve shards are O(n/S)
    src_pad, _ = node._pad_batch(sources)
    _, _, p_local, _ = node._run(src_pad, k, 4 * k, eps * 0.5)
    want_shape = node.final_state_shard_shape(len(src_pad))
    for row in p_local:
        for part in row:
            if is_remote(part):
                continue
            assert tuple(part.shape) == want_shape, (
                f"node-sharded state not O(n/S): {tuple(part.shape)}")
    out["state_shard"] = want_shape

    # the walk completion of FORA whole-graph conserves mass
    wg = NodeShardedForaWholeGraph(ds, alpha=0.15, mesh=mesh,
                                   completion="walks", seed=2)
    mass = wg.compute_whole_graph_batch(sources[:4], 2.0).sum(axis=1)
    np.testing.assert_allclose(mass, 1.0, atol=1e-3)
    out["walk_mass_err"] = float(np.abs(mass - 1.0).max())

    # one ring run and its bf16 twin
    rows = np.arange(mesh.data * 2, dtype=np.int32) * 13 % ds.graph.n
    runs = {}
    for dt in ("f32", "bf16"):
        prepare, run = make_node_sharded_propagate_ring(mesh, ds.graph, 0.15,
                                                        ring_dtype=dt)
        p, r, onehot = prepare(rows)
        p, _ = run(p, r, onehot, 8)
        runs[dt] = gather_nodes(p, mesh).numpy()
    assert np.isfinite(runs["f32"]).all()
    np.testing.assert_allclose(runs["bf16"], runs["f32"], atol=3e-3)
    out["bf16_err"] = float(np.abs(runs["bf16"] - runs["f32"]).max())

    # one batch of walk counts over the rotating CSR slices
    walk = make_node_sharded_walk_counts(mesh, ds.graph, 0.15)
    starts = np.broadcast_to(rows[:, None], (len(rows), 64 * mesh.graph))
    counts = gather_nodes(walk(starts, np.full(starts.shape, 1.0 / 64
                                                / mesh.graph, np.float32),
                               3), mesh).numpy()
    assert np.isfinite(counts).all()
    np.testing.assert_allclose(counts.sum(axis=0), 1.0, atol=1e-5)

    # the fixed-schedule edge-sharded step: push sweeps, then walks that
    # spread the residue left (__graft_entry__.py:189-195)
    step, example = sharded_fora_step(mesh, ds.graph, alpha=0.15,
                                      num_sweeps=2)
    p, _ = step(*example)
    mass = gather_columns(p, mesh).sum(dim=0).numpy()
    assert np.isfinite(mass).all()
    np.testing.assert_allclose(mass, 1.0, atol=1e-5)
    out["step_mass_err"] = float(np.abs(mass - 1.0).max())
    out["base"] = dryrun_sharded_base(mesh=mesh)
    mesh.synchronize()
    return out


def dryrun_sharded_base(n_devices: int | None = None, devices=None, *,
                        mesh: Mesh | None = None) -> dict:
    """The sharded BASE part of the dry run (``__graft_entry__.py:
    168-230``): both all-pair engines against the single-device backward
    search, then each protocol algorithm's preprocessing on the mesh with
    a stored row read back, in a temporary directory. Raises
    ``AssertionError`` on a mismatch; returns the errors and store
    bytes."""
    if mesh is None:
        mesh = make_mesh(n_devices, devices=devices)
    ds = synthetic_powerlaw(512, 4, seed=1, dense_threshold=0,
                            device=mesh.controller)
    targets = np.arange(6, dtype=np.int32) * 11 % ds.graph.n
    want = BackwardSearch(ds.graph, 0.15, 1e-3).whole_graph(targets)
    out = {}
    for label, engine in (("edge", ShardedBackwardSearch),
                          ("node", NodeShardedBackwardSearch)):
        got = engine(ds.graph, 0.15, 1e-3, mesh=mesh).whole_graph(targets)
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-4,
                                   err_msg=f"{label} all-pair engine")
        out[f"{label}_bws_err"] = float(np.abs(got - want).max())

    prep_ds = synthetic_powerlaw(256, 4, seed=3, dense_threshold=0,
                                 device=mesh.controller)
    source = 13 % prep_ds.n
    stores = {}
    with _shared_tempdir(mesh) as td:
        for algo_type, param in ((AlgoType.FWDPUSH, 1e-3),
                                 (AlgoType.MC, 2.0),
                                 (AlgoType.NEO4J_METHOD, 5),
                                 (AlgoType.FORA_WHOLE_GRAPH, 2.0),
                                 (AlgoType.BASE_WHOLE_GRAPH, 1e-3)):
            algo = mesh_algo_obj(algo_type, prep_ds, 0.15, 10, mesh=mesh)
            # the store's root is relative to prep_dirname: keep it in td
            algo.prep_dirname = os.path.join(td, algo.prep_dirname)
            if algo_type == AlgoType.BASE_WHOLE_GRAPH:
                algo.preprocessing(param, -1, progress=False)
            else:
                algo.preprocessing(-1.0, param, progress=False)
            algo.read_preprocessed_ppr(source)
            row = np.asarray(algo.get_whole_graph_dense())
            assert np.isfinite(row).all() and row.sum() > 0.5, algo_type
            assert algo.get_prep_size() > 0, algo_type
            stores[algo_type.value] = algo.get_prep_size()
            algo.delete_prep_dir()
    out["store_bytes"] = stores
    return out


@contextlib.contextmanager
def _shared_tempdir(mesh: Mesh):
    """A temporary directory: rank 0's, named to every rank of a mesh across
    processes, and removed by rank 0 once every rank is done with it."""
    path = tempfile.mkdtemp() if mesh.is_writer else None
    if mesh.spans:
        import torch.distributed as dist

        box = [path]
        dist.broadcast_object_list(box, src=0, group=mesh.group)
        path = box[0]
    try:
        yield path
    finally:
        mesh.barrier()
        if mesh.is_writer:
            shutil.rmtree(path, ignore_errors=True)
