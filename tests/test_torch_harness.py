"""The port's protocol harness and CLI against the JAX package's.

Both harnesses run on the same graph (carried across with
``graph_from_numpy``) with the same seed, so they draw the same query
nodes. Tolerances: max-abs-error fields within 1e-6 (the algorithms' own,
tests/test_torch_neo4j.py and tests/test_torch_base.py); precision and
NDCG within 1e-9, since the same top-k sets give the same sums;
preprocessing bytes within 1%, since the npz shards are compressed and the
values differ in their last bits. Time fields are dropped.

Where FORA top-k rows are compared, both engines are pinned to
``push="none"``: under "auto" the cost model may pick the push+walk rounds,
whose draws differ between the packages."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ppr_tpu import cli as jcli
from ppr_tpu import harness as jh
from ppr_tpu.graph.io import synthetic_powerlaw
from ppr_tpu.models import AlgoConf as JaxAlgoConf
from ppr_tpu.models import fora as jfora
from ppr_tpu_torch import cli as tcli
from ppr_tpu_torch import harness as th
from ppr_tpu_torch.graph import io as tio
from ppr_tpu_torch.graph.csr import graph_from_numpy
from ppr_tpu_torch.graph.io import Dataset
from ppr_tpu_torch.models import fora as tfora
from ppr_tpu_torch.models.config import AlgoConf, AlgoType
from ppr_tpu_torch.parallel import distributed
from ppr_tpu_torch.parallel.mesh import make_mesh
from ppr_tpu_torch.utils.timer import Recorder

Q, K = 8, 5


def port_dataset(jds):
    jg = jds.graph
    tg = graph_from_numpy(
        {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)},
        device="cpu")
    return Dataset(graph=tg, names=jds.names, name=jds.name)


@pytest.fixture(scope="module")
def datasets():
    return {kind: (jds, port_dataset(jds)) for kind, jds in (
        ("dense", synthetic_powerlaw(300, 4, seed=1)),
        ("sparse", synthetic_powerlaw(600, 4, seed=5, dense_threshold=0)),
    )}


def tiny_spec(algo_type, params=(5, 40)):
    return {test: {algo_type: list(params)}
            for test in ("whole_graph", "topk", "prep")}


def pin_fora(monkeypatch):
    for conf, mod in ((JaxAlgoConf, jfora), (AlgoConf, tfora)):
        monkeypatch.setattr(
            conf, "set_conf_fora_topk",
            lambda self, dataset, k, mod=mod: mod.ForaTopk(
                dataset, self.alpha, k=k, seed=self.seed, push="none"))


# per (test, BASE section?): the kind of each field of a row, as
# Gen_Util.java writes them; "time" fields are dropped
_FIELDS = {
    ("1", False): ("exact", "time", "err"),
    ("2", False): ("exact", "exact", "time", "rank", "rank"),
    ("3", False): ("exact", "exact", "time", "bytes", "err"),
    ("1", True): ("exact", "exact", "time", "bytes", "time", "err"),
    ("2", True): ("exact", "exact", "time", "bytes", "time", "rank", "rank"),
    ("3", True): ("exact", "exact", "time", "bytes", "err"),
}


def report_rows(path):
    """The result file's lines below its timestamp; each data row as its
    (kind, field) pairs without the time fields."""
    out, test, base = [], None, False
    for line in path.read_text().splitlines()[1:]:
        if line.startswith("Test "):
            test = line.split()[1].rstrip(".")
        elif re.fullmatch(r"\d\.\d+ \w+", line):
            base = line.endswith(" BASE_WHOLE_GRAPH")
        if "," not in line:
            out.append((None, line))
            continue
        kinds = _FIELDS[(test, base)]
        fields = line.split(",")
        assert len(fields) == len(kinds), line
        out.append((test, [(kind, f) for kind, f in zip(kinds, fields)
                           if kind != "time"]))
    return out


def assert_same_report(port_path, jax_path):
    port, ref = report_rows(port_path), report_rows(jax_path)
    assert len(port) == len(ref)
    for (test, got), (_, want) in zip(port, ref):
        if test is None:
            assert got == want
            continue
        assert [k for k, _ in got] == [k for k, _ in want]
        for (kind, a), (_, b) in zip(got, want):
            if kind == "exact":
                assert a == b
            elif kind == "err":
                assert abs(float(a) - float(b)) <= 1e-6
            elif kind == "rank":
                assert abs(float(a) - float(b)) <= 1e-9
            else:
                assert int(a) > 0 and abs(int(a) - int(b)) <= 0.01 * int(b)


def run_protocol_both(datasets, tmp_path, monkeypatch, kind, algo, params):
    """Tests 1-3 over ``params`` for ``algo`` through both harnesses;
    returns their results, after checking rows and result files alike."""
    jds, tds = datasets[kind]
    monkeypatch.setitem(jh.SWEEPS, "tiny", tiny_spec(jh.AlgoType(algo),
                                                     params))
    monkeypatch.setitem(th.SWEEPS, "tiny", tiny_spec(AlgoType(algo), params))
    results = {}
    for pkg, mod, ds in (("jax", jh, jds), ("port", th, tds)):
        out = tmp_path / pkg
        out.mkdir()
        monkeypatch.chdir(out)
        h = mod.PerfHarness(ds, seed=0, out_dir=str(out), progress=False)
        results[pkg] = h.algo_perf_batch_test(Q, K, sweep="tiny",
                                              tests=(1, 2, 3))
    assert len(results["port"]) == len(results["jax"]) == 3 * len(params)
    for got, want in zip(results["port"], results["jax"]):
        assert (got.algo, got.test_type, got.param) == \
            (want.algo, want.test_type, want.param)
        for field in ("avg_max_err", "avg_precision", "avg_ndcg"):
            a, b = getattr(got, field), getattr(want, field)
            assert (a is None) == (b is None), field
            if a is not None:
                assert abs(a - b) <= (1e-6 if field == "avg_max_err"
                                      else 1e-9), field
        assert (got.prep_bytes is None) == (want.prep_bytes is None)
    name = f"{jds.name}_AlgoPerfResults.txt"
    assert_same_report(tmp_path / "port" / name, tmp_path / "jax" / name)
    return results


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_neo4j_protocol_matches_jax(datasets, tmp_path, monkeypatch, kind):
    results = run_protocol_both(datasets, tmp_path, monkeypatch, kind,
                                "NEO4J_METHOD", (5, 40))
    # each preprocessing test deletes its store
    for pkg in ("jax", "port"):
        assert not os.listdir(tmp_path / pkg / "Neo4j_Method_ppr_results"
                              / datasets[kind][1].name)
    # iters 40 is exact to ~1e-5 on these graphs; 5 is not
    errs = [r.avg_max_err for r in results["port"] if r.avg_max_err]
    assert errs[1] < 1e-4 < errs[0]


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_query_nodes_match_jax(datasets, kind):
    jds, tds = datasets[kind]
    a = jh.PerfHarness(jds, seed=7).get_query_nodes(20)
    b = th.PerfHarness(tds, seed=7).get_query_nodes(20)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fora_topk_row_matches_jax(datasets, tmp_path, monkeypatch, kind):
    jds, tds = datasets[kind]
    pin_fora(monkeypatch)
    res = []
    for mod, ds, sub in ((jh, jds, "jax"), (th, tds, "port")):
        h = mod.PerfHarness(ds, seed=1, out_dir=str(tmp_path / sub),
                            progress=False)
        res.append(h.algo_perf_test(mod.AlgoType.FORA_TOPK, Q, K, 0.5, -1.0,
                                    False, mod.TestType.TOPK))
    want, got = res
    assert got.avg_precision > 0.85
    assert abs(got.avg_precision - want.avg_precision) <= 1e-9
    assert abs(got.avg_ndcg - want.avg_ndcg) <= 1e-9


def test_sweeps_equal_jax():
    assert set(th.SWEEPS) == set(jh.SWEEPS)
    for name, spec in jh.SWEEPS.items():
        assert set(th.SWEEPS[name]) == set(spec), name
        for test, arrays in spec.items():
            port = th.SWEEPS[name][test]
            # same algorithms in the same order (it numbers the sections)
            assert [a.value for a in port] == [a.value for a in arrays]
            for algo, params in arrays.items():
                assert port[AlgoType(algo.value)] == params, (name, test)


@pytest.fixture
def small(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ds = tcli.load_dataset("synth:200x4@3", device="cpu")
    return ds, th.PerfHarness(ds, seed=0, out_dir=str(tmp_path),
                              progress=False)


def report(tmp_path, ds):
    return (tmp_path / f"{ds.name}_AlgoPerfResults.txt").read_text()


def test_batch_test_algos_filter(small, tmp_path):
    ds, h = small
    h.algo_perf_batch_test(query_num=2, k=5, sweep="got", tests=(2,),
                           algos={"NEO4J_METHOD"})
    text = report(tmp_path, ds)
    # the reference's numbering is kept: NEO4J_METHOD is 2.5 of got topk
    assert "2.5 NEO4J_METHOD" in text
    assert "FORA_TOPK" not in text and "MC" not in text


def test_batch_test_algos_start_index(small, tmp_path):
    ds, h = small
    h.algo_perf_batch_test(query_num=2, k=5, sweep="got", tests=(2,),
                           algos={"NEO4J_METHOD:2"})
    text = report(tmp_path, ds)
    assert "skipped (already recorded): [5, 40]" in text
    rows = [ln for ln in text.splitlines() if "," in ln and ln[0] != "#"]
    assert len(rows) == 3 and rows[0].startswith("100,5,")
    with pytest.raises(ValueError, match="exactly one"):
        h.algo_perf_batch_test(query_num=2, k=5, sweep="got", tests=(1, 2),
                               algos={"NEO4J_METHOD:2"})


def test_batch_test_budget_note(small, tmp_path):
    ds, h = small
    h.algo_perf_batch_test(query_num=2, k=5, sweep="got", tests=(1,),
                           budget_s=0.0, algos={"NEO4J_METHOD"})
    assert "# remaining params skipped (budget 0s exceeded): " \
        "[40, 100, 200, 300]" in report(tmp_path, ds)


def test_batch_test_skips_undefined_prep(small, tmp_path, monkeypatch):
    ds, h = small
    monkeypatch.setitem(th.SWEEPS, "noprep", {
        "whole_graph": th.SWEEPS["got"]["whole_graph"],
        "topk": th.SWEEPS["got"]["topk"]})
    h.algo_perf_batch_test(query_num=2, k=5, sweep="noprep", tests=(3,),
                           algos={"NEO4J_METHOD"})
    text = report(tmp_path, ds)
    assert "Test 3 skipped: no preprocessing sweep" in text
    assert "Test 3. Preprocessing test" not in text


@pytest.mark.parametrize("tests,algos,section", [
    ((2,), {"MC"}, "2.3 MC"),
    ((1,), None, "1.1 FORA_WHOLE_GRAPH"),
    ((3,), {"MC", "NEO4J_METHOD"}, "3.4 MC"),
])
def test_unported_algorithm_raises_at_its_section(small, tmp_path,
                                                  monkeypatch, tests, algos,
                                                  section):
    """Monte-Carlo and FORA whole-graph, which raised at their section
    until they were ported, now write their rows there (each array cut to
    its cheapest param)."""
    ds, h = small
    monkeypatch.setitem(th.SWEEPS, "got", {
        test: {a: params[:1] for a, params in arrays.items()}
        for test, arrays in th.SWEEPS["got"].items()})
    h.algo_perf_batch_test(query_num=2, k=5, sweep="got", tests=tests,
                           algos=algos)
    fields = report(tmp_path, ds).split(section + "\n")[1] \
        .splitlines()[0].split(",")
    spec = {1: "whole_graph", 2: "topk", 3: "prep"}[tests[0]]
    param = th.SWEEPS["got"][spec][AlgoType(section.split()[1])][0]
    assert float(fields[0]) == param
    assert all(np.isfinite(float(x)) for x in fields)


def test_harness_unported_options_raise(datasets):
    _, tds = datasets["dense"]
    # a mesh is taken: every algorithm comes from mesh_algo_obj
    # (tests/test_torch_mesh_algos.py runs them), and a mesh across
    # processes too (tests/test_torch_distributed.py): its entry points no
    # longer raise, and in one process they are make_mesh's
    mesh = make_mesh(4, data=2, graph=2, devices=["cpu"] * 4)
    assert th.PerfHarness(tds, mesh=mesh).mesh is mesh
    assert distributed.initialize_from_env() is False
    spanning = distributed.global_mesh(devices=["cpu"] * 4)
    assert spanning.devices == mesh.devices and not spanning.spans
    assert th.PerfHarness(tds, mesh=spanning).writer.enabled
    # the walk completion is ported: every mode is taken, as in JAX
    for mode in ("auto", "spmv", "walks"):
        assert th.PerfHarness(tds, fora_completion=mode).fora_completion \
            == mode
    with pytest.raises(ValueError, match="unknown FORA completion"):
        th.PerfHarness(tds, fora_completion="exact")


def test_parser_defaults_match_jax():
    port = vars(tcli.build_parser().parse_args([]))
    ref = vars(jcli.build_parser().parse_args([]))
    assert port.pop("db") == tio.REFERENCE_GOT_DIR
    # the port's own flag (the JAX CLI picks its platform through JAX)
    assert port.pop("device") == "cuda"
    ref.pop("db")
    assert port == ref
    args = tcli.build_parser().parse_args(["--query", "3", "--k", "5"])
    assert args.alpha == 0.15 and args.eps == 0.5 and args.query == 3


def same_dataset(tds, jds):
    tg, jg = tds.graph, jds.graph
    assert (tds.name, tds.names) == (jds.name, jds.names)
    assert (tg.n, tg.m, tg.n_pad, tg.has_dense) == \
        (jg.n, jg.m, jg.n_pad, jg.has_dense)
    for field in ("edge_src", "edge_dst", "out_deg"):
        np.testing.assert_array_equal(getattr(tg, field).numpy(),
                                      np.asarray(getattr(jg, field)))


SNAP = """# Directed graph: a SNAP-style edge list
# FromNodeId\tToNodeId
10\t20
20\t30
30\t10
30\t30

10\t5000
7\t10
5000\t7
"""


@pytest.mark.parametrize("spec", ["synth:300x4@1", "synth:150x3",
                                  "synth:grqc", "snap"])
def test_load_dataset_matches_jax(tmp_path, spec):
    if spec == "snap":
        spec = str(tmp_path / "edges.txt")
        (tmp_path / "edges.txt").write_text(SNAP)
    same_dataset(tcli.load_dataset(spec, device="cpu"),
                 jcli.load_dataset(spec))


def test_load_dataset_rejects(tmp_path):
    with pytest.raises(SystemExit, match="dataset not found"):
        tcli.load_dataset(str(tmp_path / "missing"))
    # a Neo4j store, which raised until it was ported (ROADMAP.md, queue 1,
    # item 15), loads as the JAX package loads it; an unknown --rel is
    # rejected by both
    from test_torch_neostore import write_store

    db = str(tmp_path / "tiny.db")
    write_store(db, [0, 1, 2, 6], [1, 2, 0, 3], [f"n{i}" for i in range(7)])
    same_dataset(tcli.load_dataset(db, rel="Relation", device="cpu"),
                 jcli.load_dataset(db, rel="Relation"))
    for load, kwargs in ((tcli.load_dataset, {"device": "cpu"}),
                         (jcli.load_dataset, {})):
        with pytest.raises(ValueError, match="no relationship type"):
            load(db, rel="NOPE", **kwargs)


def test_cli_main(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["--db", "synth:107x3@7", "--sweep", "got", "--query",
                      "4", "--k", "5", "--tests", "1,2,3", "--algos",
                      "NEO4J_METHOD,FORA_TOPK", "--out-dir", "out",
                      "--trace-dir", "trace", "--device", "cpu"]) == 0
    text = (tmp_path / "out" / "synth_107_7_AlgoPerfResults.txt").read_text()
    for section in ("1.3 NEO4J_METHOD", "2.2 FORA_TOPK", "2.5 NEO4J_METHOD",
                    "3.3 NEO4J_METHOD"):
        assert section in text
    assert len([ln for ln in text.splitlines() if "," in ln]) == 20
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert "on cpu" in capsys.readouterr().out


def test_cli_main_push_algorithms(tmp_path, monkeypatch):
    """``--algos FWDPUSH,BASE_WHOLE_GRAPH`` reaches their sections of all
    three tests, five params each, and ``--budget-s`` cuts a section with a
    note row."""
    monkeypatch.chdir(tmp_path)
    assert tcli.main(["--db", "synth:107x3@7", "--sweep", "got", "--query",
                      "3", "--k", "5", "--tests", "1,2,3", "--algos",
                      "FWDPUSH,BASE_WHOLE_GRAPH", "--out-dir", "out",
                      "--device", "cpu"]) == 0
    text = (tmp_path / "out" / "synth_107_7_AlgoPerfResults.txt").read_text()
    for section in ("1.2 FWDPUSH", "1.5 BASE_WHOLE_GRAPH",
                    "2.1 BASE_WHOLE_GRAPH", "2.4 FWDPUSH", "3.2 FWDPUSH",
                    "3.5 BASE_WHOLE_GRAPH"):
        assert section in text
    rows = [ln for ln in text.splitlines() if "," in ln]
    assert len(rows) == 30
    assert "-1,0.001," in text and "0.001,5," in text
    assert tcli.main(["--db", "synth:107x3@7", "--sweep", "got", "--query",
                      "2", "--tests", "1", "--algos", "BASE_WHOLE_GRAPH",
                      "--budget-s", "0", "--out-dir", "cut",
                      "--device", "cpu"]) == 0
    assert "# remaining params skipped (budget 0s exceeded): " \
        "[0.0005, 5e-05, 1e-06, 5e-07]" in \
        (tmp_path / "cut" / "synth_107_7_AlgoPerfResults.txt").read_text()


def test_cli_unported_flags_raise(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # --mesh runs the protocol on the mesh engines (rows against the JAX
    # CLI's --mesh rows: tests/test_torch_mesh_algos.py)
    assert tcli.main(["--db", "synth:107x3@7", "--mesh", "1x1",
                      "--device", "cpu", "--query", "2", "--tests", "1",
                      "--algos", "NEO4J_METHOD"]) == 0
    rows = (tmp_path / "synth_107_7_AlgoPerfResults.txt").read_text()
    assert "1.3 NEO4J_METHOD\n5," in rows
    with pytest.raises(ValueError, match="DATAxGRAPH"):
        tcli.main(["--db", "synth:107x3@7", "--mesh", "2", "--device",
                   "cpu"])
    # --fora-completion walks is ported (tests/test_torch_fora_walks.py
    # runs it); the flag parses as in the JAX CLI
    assert tcli.build_parser().parse_args(
        ["--fora-completion", "walks"]).fora_completion == "walks"
    with pytest.raises(SystemExit, match="dataset not found"):
        tcli.main(["--db", str(tmp_path / "nothing"), "--device", "cpu"])
    if not os.path.isdir(tio.REFERENCE_GOT_DIR):   # the CSVs are not committed
        with pytest.raises(SystemExit, match="dataset not found"):
            tcli.main(["--device", "cpu"])


def test_cli_without_a_card_exits(tmp_path, monkeypatch):
    """With no card visible the CLI stops with the "no CUDA device" error
    unless ``--device cpu`` asks for the CPU; it writes no rows."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--db", "synth:107x3@7", "--sweep", "got", "--query", "2",
            "--tests", "1", "--algos", "NEO4J_METHOD", "--out-dir", "out"]
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcli.main(argv + extra)
    assert not (tmp_path / "out").exists()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tcli.load_dataset("synth:grqc")
    with pytest.raises(SystemExit):
        tcli.build_parser().parse_args(["--device", "tpu"])


@pytest.mark.parametrize("algos,tests", [("NEO4J_METHOD", "1,3"),
                                         ("FORA_TOPK", "2")])
def test_cli_device_cpu_rows_match_jax_cli(tmp_path, monkeypatch, algos,
                                           tests):
    """``--device cpu`` on a process without a card writes the JAX CLI's
    rows for the same command (the rows the port wrote before the flag)."""
    pin_fora(monkeypatch)
    argv = ["--db", "synth:107x3@7", "--sweep", "got", "--query", "4",
            "--k", "5", "--tests", tests, "--algos", algos]
    for pkg, main, extra in (("jax", jcli.main, []),
                             ("port", tcli.main, ["--device", "cpu"])):
        out = tmp_path / pkg
        out.mkdir()
        monkeypatch.chdir(out)
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            assert main(argv + ["--out-dir", str(out)] + extra) == 0
    name = "synth_107_7_AlgoPerfResults.txt"
    assert_same_report(tmp_path / "port" / name, tmp_path / "jax" / name)


def test_phase_timer():
    """The recorder's spans time a phase (the former ``PhaseTimer``):
    under ``torch.profiler`` each call is one span with its wall time."""
    timer = Recorder()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with timer.span("sum"):
                torch.ones(1000).sum()
    spans = timer.spans()
    assert [s.name for s in spans] == ["sum"] * 3
    assert all(s.end_ns > s.start_ns > 0 for s in spans)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fwdpush_protocol_matches_jax(datasets, tmp_path, monkeypatch, kind):
    results = run_protocol_both(datasets, tmp_path, monkeypatch, kind,
                                "FWDPUSH", (1e-4, 1e-7))
    for pkg in ("jax", "port"):
        assert not os.listdir(tmp_path / pkg / "FWP_ppr_results"
                              / datasets[kind][1].name)
    # whole-graph and preprocessing errors shrink with rmax
    errs = [r.avg_max_err for r in results["port"] if r.avg_max_err]
    assert errs[1] < errs[0] and errs[3] < errs[2]
    assert min(r.avg_precision for r in results["port"]
               if r.avg_precision is not None) > 0.9


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_base_protocol_matches_jax(datasets, tmp_path, monkeypatch, kind):
    results = run_protocol_both(datasets, tmp_path, monkeypatch, kind,
                                "BASE_WHOLE_GRAPH", (1e-3, 1e-5))
    # BASE preprocesses in every test, keyed by (threshold, k or -1), and
    # keeps its stores
    for pkg in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / pkg / "BASE_ppr_results"
                                 / datasets[kind][1].name)) == \
            ["0.001_-1", f"0.001_{K}", "1e-05_-1", f"1e-05_{K}"]
    port = results["port"]
    assert all(r.param == -1 and r.prep_bytes > 0 for r in port)
    assert [r.test_type for r in port] == [th.TestType.WHOLE_GRAPH] * 2 + \
        [th.TestType.TOPK] * 2 + [th.TestType.WHOLE_GRAPH] * 2
