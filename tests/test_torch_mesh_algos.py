"""The port's protocol drop-ins on a mesh (``ppr_tpu_torch/parallel/
mesh_algos.py``), the harness's and the CLI's ``--mesh``, against the JAX
package's drop-ins on the same mesh shapes: JAX on its 8 virtual CPU
devices (``tests/conftest.py``), the port on ``["cpu"] * S``.

Every case of ``tests/test_mesh_algos.py``. Forward Push and the Neo4j
method: rows within the JAX package's atol 5e-6, rtol 1e-4 of JAX's
drop-ins and the same sweep counts, at 4x2, 2x4 and 1x1; at 1x1 the
port's single-device engines bit for bit. FORA whole-graph: within eps/n
+ 1e-5 of the exact rows (its push rounds follow the wall clock, so it is
held to the oracle), its propagation sweeps equal to JAX's on the same
state. Monte-Carlo: rows of mass 1 within 1e-3 and within 0.05 of the
exact rows (the packages draw different walks). Stores move between a
mesh and one device both ways; ``--mesh 2x2 --device cpu`` writes the JAX
CLI's ``--mesh 2x2`` Test 1 rows within 1e-8."""

import dataclasses

import numpy as np
import pytest
import torch

from ppr_tpu import cli as jcli
from ppr_tpu.graph.csr import build_graph as jax_build_graph
from ppr_tpu.graph.io import Dataset as JaxDataset
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.parallel import mesh_algos as jma
from ppr_tpu.parallel.sharded import make_mesh as jax_make_mesh
from ppr_tpu_torch import cli as tcli
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.harness import PerfHarness, TestType
from ppr_tpu_torch.models.config import AlgoConf, AlgoType
from ppr_tpu_torch.models.power_method import power_method_batch
from ppr_tpu_torch.parallel import mesh_algos as tma
from ppr_tpu_torch.parallel.mesh import make_mesh
from ppr_tpu_torch.parallel.sharded_allpair import MeshBaseAllPair
from ppr_tpu_torch.parallel.sharded_fora import ShardedForaTopk

ALPHA = 0.15
SHAPES = [(4, 2), (2, 4), (1, 1)]


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


def jax_mesh(d, g):
    return jax_make_mesh(d * g, data=d, graph=g)


def port_mesh(d, g):
    return make_mesh(d * g, data=d, graph=g, devices=["cpu"] * (d * g))


@pytest.fixture(scope="module")
def ds():
    jds = synthetic_powerlaw(1024, 6, seed=13, dense_threshold=0)
    return jds, port_dataset(jds)


def _sources(n, k=6, seed=0):
    return np.random.default_rng(seed).integers(0, n, size=k) \
        .astype(np.int32)


def exact_rows(tds, sources):
    """The power method's rows after 200 iterations (f32, within ~1e-7 of
    the fixpoint)."""
    return power_method_batch(tds.graph, sources, ALPHA, 200).numpy()


@pytest.mark.parametrize("d,g", SHAPES)
def test_forward_push_matches_jax(ds, d, g):
    jds, tds = ds
    sources, rmax = _sources(jds.graph.n), 1e-5
    jalgo = jma.MeshForwardPush(jds, ALPHA, mesh=jax_mesh(d, g))
    want = jalgo.compute_whole_graph_batch(sources, rmax)
    sp, _ = jma._pad_rows(sources, d)
    _, p_t, r_t, oh = jalgo._kern.prepare(sp, init_shortcircuit=True)
    _, _, jsweeps = jalgo._kern.push(p_t, r_t, oh, rmax)
    algo = tma.MeshForwardPush(tds, ALPHA, mesh=port_mesh(d, g))
    got = algo.compute_whole_graph_batch(sources, rmax)
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=1e-4)
    assert algo.last_sweeps == int(jsweeps) > 0
    np.testing.assert_allclose(algo.residue_sum() + got.sum(axis=1), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("d,g", SHAPES)
def test_neo4j_matches_jax(ds, d, g):
    jds, tds = ds
    sources = _sources(jds.graph.n, seed=1)
    jalgo = jma.MeshNeo4jMethod(jds, ALPHA, mesh=jax_mesh(d, g))
    algo = tma.MeshNeo4jMethod(tds, ALPHA, mesh=port_mesh(d, g))
    for iters in (1, 20):
        np.testing.assert_allclose(
            algo.compute_whole_graph_batch(sources, iters),
            jalgo.compute_whole_graph_batch(sources, iters),
            atol=5e-6, rtol=1e-4)


def test_1x1_is_the_single_device_engines(ds):
    """On a 1x1 mesh Forward Push and the Neo4j method compute the
    single-device engines' bits (the same sweeps, K3 over the whole edge
    list, the same order of additions)."""
    _, tds = ds
    sources = _sources(tds.graph.n, k=8, seed=2)
    conf = AlgoConf(ALPHA, seed=3)
    for t, param in ((AlgoType.FWDPUSH, 1e-6), (AlgoType.NEO4J_METHOD, 20)):
        single = conf.new_algo_obj(t, tds, 10)
        algo = tma.mesh_algo_obj(t, tds, ALPHA, 10, mesh=port_mesh(1, 1))
        np.testing.assert_array_equal(
            algo.compute_whole_graph_batch(sources, param),
            single.compute_whole_graph_batch(sources, param))
        if t == AlgoType.FWDPUSH:
            assert algo.last_sweeps == single.last_sweeps


@pytest.mark.parametrize("d,g", SHAPES)
def test_fora_whole_graph_oracle(ds, d, g):
    """The residue is completed to eps*delta: the rows agree with the
    exact rows within that truncation (the push rounds follow the wall
    clock, so engine-to-engine equality is not defined)."""
    _, tds = ds
    sources, eps = _sources(tds.graph.n, k=4, seed=2), 0.5
    algo = tma.MeshForaWholeGraph(tds, ALPHA, mesh=port_mesh(d, g))
    out = algo.compute_whole_graph_batch(sources, eps)
    assert np.abs(out - exact_rows(tds, sources)).max() \
        <= eps / tds.graph.n + 1e-5
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=eps / tds.graph.n)
    assert algo.last_rounds >= 1 and algo.last_iters > 0


@pytest.mark.parametrize("d,g", SHAPES)
def test_propagate_stops_on_jax_sweep(ds, d, g):
    """The completion's propagation from the same state: JAX's sweep
    count (an extra sweep is not a no-op) and values."""
    jds, tds = ds
    sources, target = _sources(jds.graph.n, k=8, seed=4), 1e-4
    jk = jma._EdgeShardedKernels(jax_mesh(d, g), jds.graph, ALPHA)
    _, p_t, r_t, oh = jk.prepare(sources, init_shortcircuit=True)
    jp, _, jit = jk.propagate(p_t, r_t, oh, target)
    tk = tma._EdgeShardedKernels(port_mesh(d, g), tds.graph, ALPHA)
    p, r, it = tk.propagate(*tk.prepare(sources, init_shortcircuit=True),
                            target)
    assert it == int(jit) > 0
    got = torch.cat([row[0] for row in p], dim=1).numpy()
    np.testing.assert_allclose(got, np.asarray(jp), atol=5e-6, rtol=1e-4)
    assert max(float(row[0].sum(dim=0).max()) for row in r) <= target


@pytest.mark.parametrize("d,g", [(4, 2), (1, 1)])
def test_monte_carlo_statistical(ds, d, g):
    _, tds = ds
    sources = _sources(tds.graph.n, k=4, seed=3)
    mc = tma.MeshMonteCarlo(tds, ALPHA, mesh=port_mesh(d, g), seed=5)
    out = mc.compute_whole_graph_batch(sources, 1.0)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)
    # eps 1.0 at n 1024: ~23k walks a source, noise ~1e-2
    assert np.abs(out - exact_rows(tds, sources)).max() < 0.05


def test_monte_carlo_lane_passes(ds):
    """A walker budget below a row's omega walks splits the lanes into
    passes; every row still walks its omega walks (mass 1)."""
    _, tds = ds
    mc = tma.MeshMonteCarlo(tds, ALPHA, mesh=port_mesh(2, 2), seed=5,
                            max_walk_batch=2 * 4096)
    out = mc.compute_whole_graph_batch(_sources(tds.graph.n, k=4), 1.0)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)


def test_monte_carlo_weighted_statistical():
    """Weighted walks on the mesh take the alias step: the weighted exact
    rows within 0.05 (uniform steps would miss them on these skewed
    weights)."""
    rng = np.random.default_rng(9)
    n, m = 512, 4096
    src, dst = rng.integers(0, n, size=m), rng.integers(0, n, size=m)
    w = rng.uniform(0.05, 8.0, size=m)
    jg = jax_build_graph(src, dst, n=n, weights=w, dense_threshold=0)
    tds = port_dataset(JaxDataset(graph=jg, names=[str(i) for i in range(n)],
                                  name="wmc"))
    P = np.zeros((n, n))
    np.add.at(P, (src, dst), w)
    row = P.sum(axis=1)
    dangling = row == 0
    P[~dangling] /= row[~dangling][:, None]
    sources = np.array([3, 50, 200], np.int32)
    exact = np.zeros((3, jg.n_pad))
    for i, s in enumerate(sources):
        p, r = np.zeros(n), np.zeros(n)
        r[s] = 1.0
        for _ in range(200):
            p += ALPHA * r
            rem = (1 - ALPHA) * r
            dm = rem[dangling].sum()
            r = rem @ P
            r[s] += dm
        exact[i, :n] = p
    mc = tma.MeshMonteCarlo(tds, ALPHA, mesh=port_mesh(4, 2), seed=4)
    out = mc.compute_whole_graph_batch(sources, 0.5)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-3)
    assert np.abs(out - exact).max() < 0.05


def test_mesh_algo_obj_covers_all_types(ds):
    """Every algorithm has a mesh engine, under the single-device
    engine's name and store directory."""
    _, tds = ds
    mesh = port_mesh(4, 2)
    conf = AlgoConf(ALPHA)
    want = {AlgoType.BASE_WHOLE_GRAPH: MeshBaseAllPair,
            AlgoType.FORA_TOPK: ShardedForaTopk,
            AlgoType.FORA_WHOLE_GRAPH: tma.MeshForaWholeGraph,
            AlgoType.FWDPUSH: tma.MeshForwardPush,
            AlgoType.NEO4J_METHOD: tma.MeshNeo4jMethod,
            AlgoType.MC: tma.MeshMonteCarlo}
    for t, cls in want.items():
        algo = tma.mesh_algo_obj(t, tds, ALPHA, 10, mesh=mesh)
        assert type(algo) is cls and algo.mesh is mesh
        if t != AlgoType.FORA_TOPK:
            single = conf.new_algo_obj(t, tds, 10)
            assert (algo.name, algo.prep_dirname) == \
                (single.name, single.prep_dirname)
    with pytest.raises(ValueError, match="no mesh variant"):
        tma.mesh_algo_obj("POWER", tds, ALPHA, 10, mesh=mesh)


@pytest.mark.parametrize("t,param", [(AlgoType.FWDPUSH, 1e-5),
                                     (AlgoType.NEO4J_METHOD, 20)])
def test_store_moves_between_mesh_and_one_device(tmp_path, monkeypatch, t,
                                                 param):
    """A store written on the mesh reads back on one device, and a
    single-device store on the mesh (same name and directory)."""
    monkeypatch.chdir(tmp_path)
    tds = port_dataset(synthetic_powerlaw(256, 4, seed=3,
                                          dense_threshold=0))
    sources = _sources(tds.graph.n, k=5, seed=6)
    single = AlgoConf(ALPHA).new_algo_obj(t, tds, 10)
    algo = tma.mesh_algo_obj(t, tds, ALPHA, 10, mesh=port_mesh(2, 4))
    direct = algo.compute_whole_graph_batch(sources, param)
    for writer, reader in ((algo, single), (single, algo)):
        writer.preprocessing(-1.0, param, progress=False)
        for i, s in enumerate(sources):
            reader.read_preprocessed_ppr(int(s), param)
            np.testing.assert_allclose(reader.get_whole_graph_dense(),
                                       direct[i], atol=5e-6, rtol=1e-4)
        reader._store = None
        writer.delete_prep_dir()


def test_harness_runs_on_mesh(tmp_path, monkeypatch):
    """The protocol harness with a mesh: Forward Push's preprocessing
    test and BASE's top-k test through the mesh engines, rows written."""
    jds = synthetic_powerlaw(512, 4, seed=21, dense_threshold=0)
    tds = port_dataset(jds)
    monkeypatch.chdir(tmp_path)       # the stores are relative to the CWD
    h = PerfHarness(tds, out_dir=str(tmp_path), progress=False,
                    mesh=port_mesh(2, 4))
    res = h.algo_perf_test(AlgoType.FWDPUSH, 6, -1, 1e-4, -1.0, True,
                           TestType.WHOLE_GRAPH)
    assert res.prep_ms is not None and res.prep_bytes > 0
    assert res.avg_max_err < 0.05
    res2 = h.algo_perf_test(AlgoType.BASE_WHOLE_GRAPH, 6, 10, -1, 1e-3,
                            False, TestType.TOPK)
    assert res2.avg_precision is not None
    out = tmp_path / f"{tds.name}_AlgoPerfResults.txt"
    assert out.exists() and len(out.read_text().strip().splitlines()) >= 2


def _test1_rows(path):
    """Test 1's data rows of a result file, by section."""
    rows, section = {}, None
    for line in path.read_text().splitlines():
        if line[:2] == "1." and " " in line:
            section = line
        elif line.startswith("Test 2"):
            break
        elif section and "," in line:
            rows.setdefault(section, []).append(line.split(","))
    return rows


def test_cli_mesh_rows_match_jax_cli(tmp_path, monkeypatch):
    """``--mesh 2x2 --device cpu`` on a process without a card writes the
    JAX CLI's ``--mesh 2x2`` Test 1 rows: the same params, max-err within
    1e-8."""
    argv = ["--db", "synth:107x3@7", "--sweep", "got", "--query", "8",
            "--k", "5", "--tests", "1", "--algos", "FWDPUSH,NEO4J_METHOD",
            "--mesh", "2x2"]
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        out = tmp_path / pkg
        out.mkdir()
        monkeypatch.chdir(out)
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            assert main(argv + ["--out-dir", str(out)] + extra) == 0
    name = "synth_107_7_AlgoPerfResults.txt"
    port = _test1_rows(tmp_path / "port" / name)
    ref = _test1_rows(tmp_path / "jax" / name)
    assert sorted(port) == sorted(ref) == ["1.2 FWDPUSH", "1.3 NEO4J_METHOD"]
    for section, rows in ref.items():
        assert len(port[section]) == len(rows) == 5
        for got, want in zip(port[section], rows):
            assert got[0] == want[0]
            assert abs(float(got[-1]) - float(want[-1])) <= 1e-8, section


def test_cli_mesh_without_enough_cards_raises(ds, tmp_path, monkeypatch):
    """On the card (the default ``--device cuda``) the mesh takes the
    visible cards and raises when there are fewer than ``D*G``; it never
    falls back to the CPU."""
    _, tds = ds
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli, "load_dataset", lambda *a, **k: tds)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="needs 4 cards; 1 visible"):
        tcli.main(["--db", "synth:107x3@7", "--mesh", "2x2", "--tests", "1",
                   "--out-dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())
