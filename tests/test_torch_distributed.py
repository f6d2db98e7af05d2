"""A mesh across processes (``ppr_tpu_torch/parallel/distributed.py``, the
cross-process collectives of ``parallel/mesh.py``) against the same mesh in
one process, and against the JAX package's mesh engines.

The ranks are gloo processes on the CPU, one torch thread each, started
by ``distributed.spawn_local`` with a deadline (and a collective timeout
on their process group), so a lost rank fails one fixture, not the run.
Each spawn runs one of the ``SPAWNS`` below: every rank calls
:func:`run_case` on ``global_mesh(...)`` and saves what it got; the
parent calls the same function on ``make_mesh(..., devices=["cpu"] *
S)`` and the tests hold every rank's results to the single process's,
bit for bit (sweep counts, reserves, rows, stores). The module imports no
JAX at import time: the ranks import it to run :func:`rank_main`, and the
JAX references are made in the parent, held within the bars of the
port's parity files (``test_torch_sharded_fora.py``,
``test_torch_node_sharded_fora.py``, ``test_torch_mesh_algos.py``,
``test_torch_sharded_allpair.py``)."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from ppr_tpu_torch.graph.io import synthetic_powerlaw
from ppr_tpu_torch.models.config import AlgoType
from ppr_tpu_torch.ops.topk import topk_ids_with_ties
from ppr_tpu_torch.parallel import distributed
from ppr_tpu_torch.parallel import mesh as mesh_mod
from ppr_tpu_torch.parallel.mesh import is_remote, make_mesh

ALPHA, EPS, K = 0.15, 0.5, 10
HERE = os.path.dirname(os.path.abspath(__file__))
#: seconds a rank's collective waits for a lost peer, and the spawn's
#: deadline
COLLECTIVE_TIMEOUT_S, SPAWN_TIMEOUT_S = 120, 240
SOURCES = np.random.default_rng(1).integers(0, 1024, 6).astype(np.int32)
PROBE = np.array([0, 3, 14, 50, 301, 511])
#: (ranks, devices a rank, the meshes' graph axes)
SPAWNS = {
    "grid": (4, 1, (2,)),        # 2x2, a position a rank
    "ring": (4, 1, (4,)),        # 1x4, a position a rank
    "pairs": (2, 2, (2, 4)),     # 2x2 a row a rank; 1x4 two positions each
}


def graph():
    return synthetic_powerlaw(1024, 6, seed=13, dense_threshold=0,
                              device="cpu")


def prep_graph():
    return synthetic_powerlaw(512, 4, seed=7, dense_threshold=0,
                              device="cpu")


def part_input(d: int, s: int, rows: int = 4) -> torch.Tensor:
    """Position ``(d, s)``'s input to the collectives, the same in every
    process."""
    return torch.as_tensor(np.random.default_rng([d, s]).standard_normal(
        (rows, 5)).astype(np.float32))


def ring_input(d: int, s: int):
    """Position ``(d, s)``'s ring payload: its fields (f32, int64, none),
    their row count that of its data row's ring (a ring carries one shape,
    the rings of the rows differ)."""
    x = part_input(d, s, 3 + 2 * d)
    return x, (x[:, 0] * 1000).to(torch.int64), None


def collectives(mesh) -> dict:
    """Each collective on every data row; ``{name: {(d, s): result}}`` at
    this rank's positions."""
    out = {}

    def local(name, d, parts):
        for s, x in enumerate(parts):
            if not is_remote(x):
                out.setdefault(name, {})[d, s] = x

    for d in range(mesh.data):
        parts = mesh.grid(lambda d_, s, dev: part_input(d_, s))[d]
        ring = mesh.grid(lambda d_, s, dev: ring_input(d_, s))[d]
        floats = [x if is_remote(x) else x[0] for x in ring]
        local("psum", d, mesh_mod.psum(parts))
        local("ppermute", d, mesh_mod.ppermute(floats, mesh.devices[d]))
        local("ppermute_bf16", d, mesh_mod.ppermute(
            floats, mesh.devices[d], torch.bfloat16))
        local("ppermute_int", d, mesh_mod.ppermute(
            [x if is_remote(x) else (x * 100).to(torch.int32)
             for x in floats], mesh.devices[d]))
        local("ppermute_fields", d, mesh_mod.ppermute(
            ring, mesh.devices[d], torch.bfloat16))
        gathered = mesh_mod.all_gather(parts, 1)
        if not is_remote(gathered):
            out.setdefault("all_gather", {})[d] = gathered
    scalars = mesh.grid(lambda d, s, dev: part_input(d, s)[0, 0])
    flat = [x for row in scalars for x in row]
    out["pmax"] = float(mesh_mod.pmax(flat, mesh)[0])
    out["pmin"] = float(mesh_mod.pmin(flat, mesh)[0])
    ints = [x if is_remote(x) else (x * 1000).to(torch.int32) for x in flat]
    out["pmax_int"] = int(mesh_mod.pmax(ints, mesh)[0])
    return out


def edge_topk(mesh) -> dict:
    from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

    eng = ShardedForaTopk(graph(), ALPHA, K, mesh=mesh)
    dense = eng.compute_topk_batch(SOURCES, K, EPS)
    vals, ids = eng.compute_topk_ids_batch(SOURCES, K, EPS)
    return {"dense": dense, "iters": eng.last_iters, "vals": vals,
            "ids": ids}


def node_topk(mesh) -> dict:
    from ppr_tpu_torch.parallel.node_sharded_fora import NodeShardedForaTopk

    ds, out = graph(), {}
    for name, kw in (("dense", {}),
                     ("frontier", dict(frontier_blocks=4, num_blocks=16)),
                     ("frontier_bf16", dict(frontier_blocks=4, num_blocks=16,
                                            ring_dtype="bf16"))):
        eng = NodeShardedForaTopk(ds, ALPHA, K, mesh=mesh, **kw)
        dense = eng.compute_topk_batch(SOURCES, K, EPS)
        vals, ids = eng.compute_topk_ids_batch(SOURCES, K, EPS)
        out[name] = {"dense": dense, "iters": eng.last_iters, "vals": vals,
                     "ids": ids}
    return out


def whole_graph(mesh) -> dict:
    from ppr_tpu_torch.parallel.node_sharded_fora import \
        NodeShardedForaWholeGraph

    ds, out = graph(), {}
    for completion in ("spmv", "walks"):
        eng = NodeShardedForaWholeGraph(ds, ALPHA, mesh=mesh,
                                        completion=completion, seed=3)
        out[completion] = {
            "rows": eng.compute_whole_graph_batch(SOURCES[:4], 0.5),
            "iters": eng.last_iters}
    return out


def drop_ins(mesh, work: str) -> dict:
    """The six ``mesh_algo_obj`` drop-ins' rows (BASE's from its store)."""
    from ppr_tpu_torch.parallel.mesh_algos import mesh_algo_obj

    ds, out = graph(), {}
    for algo_type, param in ((AlgoType.FWDPUSH, 1e-5),
                             (AlgoType.NEO4J_METHOD, 20),
                             (AlgoType.MC, 2.0),
                             (AlgoType.FORA_WHOLE_GRAPH, 0.5),
                             (AlgoType.FORA_TOPK, EPS),
                             (AlgoType.BASE_WHOLE_GRAPH, 1e-3)):
        algo = mesh_algo_obj(algo_type, ds, ALPHA, K, mesh=mesh, seed=3)
        if algo_type == AlgoType.BASE_WHOLE_GRAPH:
            algo.prep_dirname = os.path.join(work, "drop_in_base")
            algo.preprocessing(param, -1, progress=False)
            rows = algo.compute_whole_graph_batch(SOURCES)
        elif algo_type == AlgoType.FORA_TOPK:
            rows = algo.compute_topk_batch(SOURCES, K, param)
        else:
            rows = algo.compute_whole_graph_batch(SOURCES, param)
        out[algo_type.value] = {"rows": rows,
                                "sweeps": getattr(algo, "last_sweeps", None)}
    return out


def allpair_store(mesh, engine: str, work: str) -> dict:
    """The whole BASE preprocessing on the mesh: the rows read back, the
    store's arrays, and the shards this rank wrote."""
    import ppr_tpu_torch.utils.store as store_mod
    from ppr_tpu_torch.parallel.node_sharded_allpair import \
        node_sharded_base_allpair
    from ppr_tpu_torch.parallel.sharded_allpair import sharded_base_allpair

    factory = {"edge": sharded_base_allpair,
               "node": node_sharded_base_allpair}[engine]
    algo = factory(prep_graph(), ALPHA, mesh=mesh, target_batch=128)
    algo.prep_dirname = os.path.join(work, f"{engine}_store")
    writes = []
    save = store_mod.np.savez_compressed

    def counted(path, **arrays):
        writes.append(os.path.basename(path))
        save(path, **arrays)

    store_mod.np.savez_compressed = counted
    try:
        algo.preprocessing(1e-3, 5, progress=False)
    finally:
        store_mod.np.savez_compressed = save
    mesh.barrier()
    rows = algo.compute_whole_graph_batch(PROBE)
    return {"rows": rows, "order": list(algo._last_order),
            "files": store_files(algo._store.root), "writes": writes}


def store_files(root: str) -> dict:
    """Every file of a store: a shard's arrays, the manifest's JSON."""
    import json

    out = {}
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if name.endswith(".npz"):
            with np.load(path) as z:
                out[name] = {k: z[k] for k in z.files}
        else:
            with open(path) as f:
                out[name] = json.load(f)
    return out


def service(mesh, engine: str) -> list:
    from ppr_tpu_torch.service import PPRService

    kw = {"frontier_blocks": 4} if engine == "node" else {}
    svc = PPRService(graph(), mesh=mesh, mesh_engine=engine, **kw)
    return [[(h.node, h.score) for h in row]
            for row in svc.top_k(SOURCES, k=K)]


def harness_rows(mesh, work: str) -> list[tuple]:
    """Test 1's Forward Push and BASE rows through ``PerfHarness(mesh=)``,
    read by every rank after rank 0 wrote them: each row's first and last
    fields (the sweep value and the max error; the times between them
    differ from run to run)."""
    from ppr_tpu_torch.harness import PerfHarness

    out_dir = os.path.join(work, "harness")
    cwd = os.getcwd()
    os.makedirs(out_dir, exist_ok=True)
    os.chdir(out_dir)       # BASE's store goes under the working directory
    try:
        h = PerfHarness(prep_graph(), seed=0, out_dir=out_dir,
                        progress=False, warmup=False, mesh=mesh)
        h.algo_perf_test(AlgoType.FWDPUSH, 4, -1, 1e-4)
        h.algo_perf_test(AlgoType.BASE_WHOLE_GRAPH, 4, -1, -1, 1e-3)
    finally:
        os.chdir(cwd)
    mesh.barrier()
    with open(h.writer.path) as f:
        return [(fields[0], fields[-1]) for fields in
                (line.strip().split(",") for line in f)]


def run_case(spawn: str, meshes: list, work: str) -> dict:
    """What a spawn computes, on its meshes (across processes in a rank,
    in one process in the parent)."""
    if spawn == "grid":
        mesh, = meshes
        return {"layout": (mesh.devices, mesh.owner),
                "collectives": collectives(mesh), "edge": edge_topk(mesh),
                "drop_ins": drop_ins(mesh, work),
                "edge_store": allpair_store(mesh, "edge", work),
                "service": service(mesh, "edge"),
                "harness": harness_rows(mesh, work)}
    if spawn == "ring":
        from ppr_tpu_torch.parallel.dryrun import dryrun_multichip

        mesh, = meshes
        return {"layout": (mesh.devices, mesh.owner),
                "collectives": collectives(mesh), "node": node_topk(mesh),
                "whole_graph": whole_graph(mesh),
                "node_store": allpair_store(mesh, "node", work),
                "service": service(mesh, "node"),
                "dryrun": dryrun_multichip(mesh=mesh)["sweeps"]}
    grid, ring = meshes
    return {"collectives": collectives(ring), "edge": edge_topk(grid),
            "node": node_topk(ring)}


def rank_main(spawn: str, work: str) -> None:
    """A rank of ``spawn``: join the group, run :func:`run_case` on the
    spawn's meshes, save the result as ``work/rank<r>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    assert distributed.initialize_from_env("gloo",
                                           timeout_s=COLLECTIVE_TIMEOUT_S)
    _, per_rank, axes = SPAWNS[spawn]
    meshes = [distributed.global_mesh(g, devices=["cpu"] * per_rank)
              for g in axes]
    out = run_case(spawn, meshes, os.path.join(work, "span"))
    out["wire_bytes"] = sum(m.wire_bytes for m in meshes)
    out["wire_s"] = sum(m.wire_s for m in meshes)
    torch.save(out, os.path.join(work, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``runs(spawn) -> (single-process result, [every rank's result])``,
    each spawn run once."""
    cache = {}

    def get(spawn):
        if spawn not in cache:
            nprocs, per_rank, axes = SPAWNS[spawn]
            work = str(tmp_path_factory.mktemp(spawn))
            code = (f"import sys; sys.path[:0] = [{HERE!r}, "
                    f"{os.path.dirname(HERE)!r}]; import "
                    f"test_torch_distributed as t; "
                    f"t.rank_main({spawn!r}, {work!r})")
            distributed.spawn_local(nprocs, [sys.executable, "-c", code],
                                    timeout_s=SPAWN_TIMEOUT_S,
                                    log_dir=os.path.join(work, "logs"))
            size = nprocs * per_rank
            meshes = [make_mesh(size, graph=g, devices=["cpu"] * size)
                      for g in axes]
            single = run_case(spawn, meshes, os.path.join(work, "single"))
            cache[spawn] = single, [
                torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
        return cache[spawn]

    return get


def assert_same(got, want, where="") -> None:
    """``got`` equals ``want`` bit for bit, through dicts, lists and
    arrays."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            assert_same(got[key], want[key], f"{where}/{key}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, torch.Tensor)):
        a, b = np.asarray(got), np.asarray(want)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert a.tobytes() == b.tobytes(), where
    else:
        assert got == want, where


def assert_same_topk(got, want, k=K):
    """The JAX parity files' bar: scores within atol 5e-6, rtol 1e-4 and
    the tie-expanded top-k sets equal."""
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-4)
    for i in range(len(got)):
        assert set(topk_ids_with_ties(got[i], k, tol=1e-6).tolist()) == \
            set(topk_ids_with_ties(want[i], k, tol=1e-6).tolist()), i


# -- the entry points ------------------------------------------------------

def test_initialize_from_env_without_the_environment(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.initialize_from_env() is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert distributed.initialize_from_env("gloo") is False


def test_global_mesh_in_one_process_is_make_mesh():
    for graph_axis in (None, 1, 4):
        mesh = distributed.global_mesh(graph_axis, devices=["cpu"] * 8)
        want = make_mesh(8, graph=graph_axis, devices=["cpu"] * 8)
        assert mesh.devices == want.devices and not mesh.spans


@pytest.mark.parametrize("spawn", ["grid", "ring"])
def test_global_mesh_layout_is_make_mesh(runs, spawn):
    """Rank order is device order: the grid is ``make_mesh``'s, and rank
    ``r`` owns the positions of its devices."""
    single, ranks = runs(spawn)
    nprocs, per_rank, _ = SPAWNS[spawn]
    devices, owner = ranks[0]["layout"]
    assert devices == single["layout"][0]
    flat = [r for row in owner for r in row]
    assert flat == [i // per_rank for i in range(nprocs * per_rank)]
    for got in ranks:
        assert got["layout"] == ranks[0]["layout"]


def test_a_ranks_view_of_the_grid():
    """Rank 1 of a 2x2 grid owned a position a rank: its position holds a
    value, the others :class:`Remote` markers naming their owners; it
    speaks for row 0 from position 1 and for no other row, and its
    controller is its own device."""
    owner = [[0, 1], [2, 3]]
    devices = [["cpu"] * 2, ["cpu"] * 2]
    mesh = mesh_mod.Mesh(devices, owner=owner, rank=1)
    grid = mesh.grid(lambda d, s, dev: (d, s))
    assert grid[0][1] == (0, 1)
    assert [x.owner for x in (grid[0][0], grid[1][0], grid[1][1])] \
        == [0, 2, 3]
    assert all(is_remote(x) and x is not None
               for x in (grid[0][0], grid[1][0], grid[1][1]))
    assert (mesh.speaker(0), mesh.speaker(1)) == (1, None)
    assert mesh.controller == torch.device("cpu")
    assert mesh.unique_devices() == [torch.device("cpu")]
    assert not mesh.is_writer and not mesh.spans
    assert mesh_mod.Mesh(devices, owner=owner, rank=0).is_writer
    with pytest.raises(ValueError, match="owns no position"):
        mesh_mod.Mesh(devices, owner=owner, rank=7)


def test_one_process_fetch_and_agree_are_identities():
    mesh = make_mesh(4, data=2, graph=2, devices=["cpu"] * 4)
    parts = [[torch.ones(2)] * 2, [torch.zeros(2)] * 2]
    assert mesh_mod.fetch(mesh, parts) is parts
    assert mesh.agree_max(3.5) == 3.5
    mesh.barrier()


def test_spawn_deadline_kills_the_ranks(tmp_path):
    """A rank that never returns costs the spawn's deadline, then every
    rank is killed."""
    code = "import time; time.sleep(60)"
    with pytest.raises(RuntimeError, match="deadline"):
        distributed.spawn_local(2, [sys.executable, "-c", code],
                                timeout_s=1.0, log_dir=str(tmp_path))


def test_spawn_reports_a_failed_rank(tmp_path):
    code = ("import os, sys, time; r = int(os.environ['RANK']); "
            "sys.exit(3) if r == 1 else time.sleep(60)")
    with pytest.raises(RuntimeError, match="a rank failed"):
        distributed.spawn_local(2, [sys.executable, "-c", code],
                                timeout_s=30.0, log_dir=str(tmp_path))


def test_dist_protocol_ab_needs_a_card(capsys):
    """The A/B driver of ``[dist:protocol]`` exits 1 without a card, before
    it starts a rank."""
    import dist_protocol_ab

    assert dist_protocol_ab.main(["--parent", "."]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# -- the collectives ------------------------------------------------------

@pytest.mark.parametrize("spawn", sorted(SPAWNS))
@pytest.mark.parametrize("name", ["psum", "ppermute", "ppermute_bf16",
                                  "ppermute_int", "ppermute_fields",
                                  "all_gather"])
def test_collective_equals_one_process(runs, spawn, name):
    """psum (added in shard order), the ring step with and without the bf16
    wire (each data row's ring of its own size; a payload of several
    fields, its int field and its empty one as they were), and all_gather:
    each rank's results at its positions are the single process's, bit for
    bit."""
    single, ranks = runs(spawn)
    want = single["collectives"][name]
    seen = set()
    for got in ranks:
        for key, x in got["collectives"][name].items():
            assert_same(x, want[key], f"{name}{key}")
            seen.add(key)
    assert seen == set(want)


@pytest.mark.parametrize("spawn", sorted(SPAWNS))
def test_pmax_pmin_equal_one_process(runs, spawn):
    single, ranks = runs(spawn)
    for got in ranks:
        for name in ("pmax", "pmin", "pmax_int"):
            assert got["collectives"][name] == single["collectives"][name]


def test_bf16_wire_rounds_once():
    """The bf16 ring step across processes rounds as the single-process
    one: to bf16 and back."""
    x = part_input(0, 1, 5)
    mesh = make_mesh(2, data=1, graph=2, devices=["cpu"] * 2)
    moved = mesh_mod.ppermute([part_input(0, 0, 3), x], mesh.devices[0],
                              torch.bfloat16)
    assert_same(moved[0], x.to(torch.bfloat16).to(torch.float32))


# -- the engines ----------------------------------------------------------

@pytest.mark.parametrize("spawn", ["grid", "pairs"])
def test_edge_topk_equals_one_process(runs, spawn):
    """ShardedForaTopk at 2x2, a position a rank and a row a rank: the
    single process's sweeps, reserves and selection, on every rank."""
    single, ranks = runs(spawn)
    for got in ranks:
        assert_same(got["edge"], single["edge"])
    assert single["edge"]["iters"] > 0


@pytest.mark.parametrize("spawn", ["ring", "pairs"])
@pytest.mark.parametrize("variant", ["dense", "frontier", "frontier_bf16"])
def test_node_topk_equals_one_process(runs, spawn, variant):
    """NodeShardedForaTopk at 1x4, dense and frontier-compacted, f32 and
    bf16 rings: the single process's sweeps and bits on every rank."""
    single, ranks = runs(spawn)
    for got in ranks:
        assert_same(got["node"][variant], single["node"][variant])


@pytest.mark.parametrize("completion", ["spmv", "walks"])
def test_node_whole_graph_equals_one_process(runs, completion):
    """NodeShardedForaWholeGraph at 1x4, the walk ring included: rows bit
    for bit (the walks draw from generators seeded by shard index)."""
    single, ranks = runs("ring")
    for got in ranks:
        assert_same(got["whole_graph"][completion],
                    single["whole_graph"][completion])
    rows = single["whole_graph"][completion]["rows"]
    np.testing.assert_allclose(rows.sum(axis=1), 1.0, atol=1e-3)


@pytest.mark.parametrize("algo", [t.value for t in (
    AlgoType.FWDPUSH, AlgoType.NEO4J_METHOD, AlgoType.MC,
    AlgoType.FORA_WHOLE_GRAPH, AlgoType.FORA_TOPK,
    AlgoType.BASE_WHOLE_GRAPH)])
def test_drop_in_rows_equal_one_process(runs, algo):
    """The six protocol drop-ins at 2x2. FORA whole-graph picks its push
    rounds by the clock (on a mesh across processes the slowest rank's),
    so its rows are held to the oracle's bars, as on one process; every
    other drop-in gives the single process's bits."""
    single, ranks = runs("grid")
    want = single["drop_ins"][algo]
    if algo != AlgoType.FORA_WHOLE_GRAPH.value:
        for got in ranks:
            assert_same(got["drop_ins"][algo], want)
        return
    from ppr_tpu_torch.models.power_method import power_method_batch

    ds = graph()
    exact = power_method_batch(ds.graph, SOURCES, ALPHA, 200).numpy()
    for got in ranks:
        rows = got["drop_ins"][algo]["rows"]
        assert_same(rows, ranks[0]["drop_ins"][algo]["rows"])
        assert np.abs(rows - exact).max() <= 0.5 / ds.graph.n + 1e-5
        np.testing.assert_allclose(rows.sum(axis=1), 1.0,
                                   atol=0.5 / ds.graph.n)


@pytest.mark.parametrize("spawn,key", [("grid", "edge_store"),
                                       ("ring", "node_store")])
def test_allpair_store_equals_one_process_written_once(runs, spawn, key):
    """The whole BASE preprocessing on the mesh: the store's arrays and
    manifest are the single process's byte for byte, rank 0 wrote every
    shard and no other rank wrote one, and every rank reads the rows
    back."""
    single, ranks = runs(spawn)
    want = single[key]
    assert want["writes"]
    for rank, result in enumerate(ranks):
        got = result[key]
        assert_same(got["files"], want["files"])
        assert_same(got["rows"], want["rows"])
        assert_same(got["order"], want["order"])
        assert got["writes"] == (want["writes"] if rank == 0 else [])


@pytest.mark.parametrize("spawn", ["grid", "ring"])
def test_service_on_a_spanning_mesh(runs, spawn):
    """PPRService(mesh=global_mesh(...)), the same call on every rank: the
    single process's hits on every rank."""
    single, ranks = runs(spawn)
    for got in ranks:
        assert got["service"] == single["service"]
    assert all(len(row) == K for row in single["service"])


def test_harness_report_written_once(runs):
    """PerfHarness(mesh=global_mesh(...)): rank 0 writes the report, whose
    rows but their timings are the single process's."""
    single, ranks = runs("grid")
    assert len(single["harness"]) == 2
    for got in ranks:
        assert got["harness"] == single["harness"]


def test_dryrun_on_a_spanning_mesh(runs):
    """``dryrun_multichip(mesh=global_mesh(...))`` holds every engine to
    the single-device one on every rank (it raises otherwise)."""
    single, ranks = runs("ring")
    for got in ranks:
        assert got["dryrun"] == single["dryrun"]


@pytest.mark.parametrize("spawn", sorted(SPAWNS))
def test_the_wire_carried_bytes(runs, spawn):
    """Every rank sent bytes, and gloo's host wire timed its collectives."""
    _, ranks = runs(spawn)
    assert all(got["wire_bytes"] > 0 and got["wire_s"] > 0 for got in ranks)


# -- against the JAX package's mesh engines -------------------------------

def jax_graph(n, deg, seed):
    from ppr_tpu.graph.io import synthetic_powerlaw as jax_powerlaw

    return jax_powerlaw(n, deg, seed=seed, dense_threshold=0)


def jax_mesh(d, g):
    from ppr_tpu.parallel.sharded import make_mesh as jax_make_mesh

    return jax_make_mesh(d * g, data=d, graph=g)


def test_edge_topk_matches_jax(runs):
    from ppr_tpu.parallel.sharded_fora import ShardedForaTopk as JaxEdge

    _, ranks = runs("grid")
    jds = jax_graph(1024, 6, 13)
    eng = JaxEdge(jds, ALPHA, K, mesh=jax_mesh(2, 2))
    sp, b = eng._pad_batch(SOURCES)
    kcap = min(max(4 * K, K + 32), jds.graph.n_pad)
    _, _, p_t, iters = eng._call(eng._program(K, kcap),
                                 *eng._prepare_state(sp), EPS * 0.5)
    for got in ranks:
        assert_same_topk(got["edge"]["dense"], np.asarray(p_t).T[:b])
        assert got["edge"]["iters"] == int(iters)


def test_node_topk_matches_jax(runs):
    from ppr_tpu.parallel.node_sharded_fora import \
        NodeShardedForaTopk as JaxNode

    _, ranks = runs("ring")
    jds = jax_graph(1024, 6, 13)
    eng = JaxNode(jds, ALPHA, K, mesh=jax_mesh(1, 4))
    sp, b = eng._pad_batch(SOURCES)
    kcap = min(max(4 * K, K + 32), jds.graph.n_pad)
    _, _, p, iters = eng._run(sp, K, kcap, EPS * 0.5)
    for got in ranks:
        assert_same_topk(got["node"]["dense"]["dense"], np.asarray(p)[:b])
        assert got["node"]["dense"]["iters"] == int(iters)


@pytest.mark.parametrize("algo,param", [("FWDPUSH", 1e-5),
                                        ("NEO4J_METHOD", 20)])
def test_drop_ins_match_jax(runs, algo, param):
    from ppr_tpu.parallel import mesh_algos as jma

    _, ranks = runs("grid")
    cls = {"FWDPUSH": jma.MeshForwardPush,
           "NEO4J_METHOD": jma.MeshNeo4jMethod}[algo]
    want = cls(jax_graph(1024, 6, 13), ALPHA, mesh=jax_mesh(2, 2)) \
        .compute_whole_graph_batch(SOURCES, param)
    for got in ranks:
        np.testing.assert_allclose(got["drop_ins"][algo]["rows"], want,
                                   atol=5e-6, rtol=1e-4)


@pytest.mark.parametrize("spawn,key,engine", [
    ("grid", "edge_store", "edge"), ("ring", "node_store", "node")])
def test_allpair_store_matches_jax(runs, spawn, key, engine, tmp_path,
                                   monkeypatch):
    from ppr_tpu.parallel import node_sharded_allpair as jnsa
    from ppr_tpu.parallel import sharded_allpair as jsa

    monkeypatch.chdir(tmp_path)
    _, ranks = runs(spawn)
    factory = {"edge": jsa.sharded_base_allpair,
               "node": jnsa.node_sharded_base_allpair}[engine]
    d, g = (2, 2) if engine == "edge" else (1, 4)
    algo = factory(jax_graph(512, 4, 7), ALPHA, mesh=jax_mesh(d, g),
                   target_batch=128)
    algo.preprocessing(1e-3, 5, progress=False)
    want = algo.compute_whole_graph_batch(PROBE)
    for got in ranks:
        np.testing.assert_allclose(got[key]["rows"], want, atol=5e-6,
                                   rtol=1e-4)
        for a, b in zip(got[key]["order"], algo._last_order):
            np.testing.assert_array_equal(a, b)
