"""``protocol_grid_torch.py`` on the CPU: the one reader of the protocol's
row format on the banked reports, the query draws against the JAX
harness's, a small grid through both packages held to its bars, stamps and
a cut store's resume."""

import contextlib
import json
import os
import shlex
import types

import numpy as np
import pytest
import torch

import protocol_grid_torch as grid
from ppr_tpu_torch.utils import report
from ppr_tpu_torch.utils.report import (ProtocolRow, read_protocol_file,
                                        read_protocol_rows)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "synth:300x4@5"
# the JAX CLI's commands of the small grid's references: the first param
# of each section of the got sweep's Tests 1 and 2, and of its
# deterministic Test 3 sections, one param a section (--budget-s 0)
COMMON = ["--db", TINY, "--sweep", "got", "--query", "50", "--k", "10",
          "--budget-s", "0"]
JAX_COMMANDS = {
    "tiny_t12": [*COMMON, "--tests", "1,2", "--fora-completion", "walks",
                 "--algos", "FWDPUSH,NEO4J_METHOD,BASE_WHOLE_GRAPH,MC,"
                            "FORA_WHOLE_GRAPH,FORA_TOPK"],
    "tiny_t3": [*COMMON, "--tests", "3",
                "--algos", "FWDPUSH,NEO4J_METHOD,BASE_WHOLE_GRAPH"],
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread: many small ops, which threads only slow down
    beside other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def chdir(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def banked(ds):
    with open(os.path.join(ROOT, "results", f"{ds}_AlgoPerfResults.txt")) as f:
        return read_protocol_rows(f.read())


# --- (a) the reader ---------------------------------------------------------
@pytest.mark.parametrize("ds,n_rows,n_blocks", [
    ("blogcatalog", 77, 12), ("flickr", 50, 8), ("amazon", 40, 7)])
def test_reader_splits_banked_reports(ds, n_rows, n_blocks):
    rows = banked(ds)
    assert len(rows) == n_rows
    blocks = {}
    for r in rows:
        blocks.setdefault(r.block, []).append(r.draw)
    # a block is one invocation; its rows drew 0, 1, 2, ... in file order
    assert len(blocks) == n_blocks
    for draws in blocks.values():
        assert draws == list(range(len(draws)))
    # the file reader chip_smoke.py reads through gives the same rows
    assert read_protocol_file(os.path.join(
        ROOT, "results", f"{ds}_AlgoPerfResults.txt")) == rows


@pytest.mark.parametrize("ds,block,test,algo,param,draw,acc", [
    # a row after skipped params and budget notes still counts only rows
    ("flickr", "2026-08-19 11:00:29", 1, "BASE_WHOLE_GRAPH", "0.005", 19,
     0.07448651680722833),
    ("flickr", "2026-08-19 11:00:29", 2, "MC", "5.0", 26, 0.8639999999999999),
    ("blogcatalog", "2026-08-19 10:33:43", 3, "BASE_WHOLE_GRAPH", "0.001",
     42, 0.005180228650569916),
    # --algos X:N skips draw nothing: the banked param is the block's first
    ("amazon", "2026-08-21 01:41:48", 3, "FWDPUSH", "5e-05", 0,
     0.0051873791217803954),
    ("amazon", "2026-08-20 22:24:36", 3, "FORA_WHOLE_GRAPH", "500.0", 0,
     0.007336272299289704),
])
def test_reader_draw_index(ds, block, test, algo, param, draw, acc):
    [row] = [r for r in banked(ds) if r.block == block and r.test == test
             and r.algo == algo and r.param == param]
    assert row.draw == draw
    assert row.accuracy == acc
    if test == 3:
        assert row.prep is not None and row.query_ms is None


def test_minimum_set_has_a_reference_each():
    jobs = grid.jobs_for(grid.DATASETS)
    assert len(jobs) == 15 + 15 + 10 + 4
    for job in jobs:
        ref = grid.find_reference(job, grid.reference_rows(job))
        if job.dataset == "blogcatalog" and job.algo.startswith("FORA"):
            continue      # their references are the JAX CPU's, with walks
        assert ref is not None, job.tag
        assert ref["row"].param == str(job.param)
    # amazon's FORA preprocessing ran with walks (run_amazon_prep.sh)
    [fora] = [j for j in jobs if j.tag.startswith("amazon_t3_FORA")]
    assert fora.completion == "walks"
    ref = grid.find_reference(fora, grid.reference_rows(fora))
    assert ref["completion"] == "walks" and ref["row"].draw == 0


# --- (b) the draws ---------------------------------------------------------
def test_advancing_draws_matches_jax_harness(tmp_path):
    from ppr_tpu.graph.io import synthetic_powerlaw as jax_synth
    from ppr_tpu.harness import PerfHarness as JaxHarness

    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.harness import PerfHarness

    jh = JaxHarness(jax_synth(300, 4, seed=5), out_dir=str(tmp_path / "j"))
    want = [jh.get_query_nodes(50) for _ in range(7)]
    ds = synthetic_powerlaw(300, 4, seed=5, device="cpu")
    for j in range(7):
        h = PerfHarness(ds, out_dir=str(tmp_path / "t"), progress=False)
        grid.advance_draws(h, j)
        np.testing.assert_array_equal(h.get_query_nodes(50), want[j])


# --- (c) a small grid through both packages ---------------------------------
@pytest.fixture(scope="module")
def jax_reference(tmp_path_factory):
    """The JAX CLI's reports of the small grid, in the reference file's
    format, and their rows."""
    from ppr_tpu import cli as jcli

    blocks, rows = {}, []
    for name, args in JAX_COMMANDS.items():
        work = tmp_path_factory.mktemp(name)
        with chdir(work):
            assert jcli.main([*args, "--out-dir", str(work)]) == 0
        [report] = [f for f in os.listdir(work) if f.endswith("Results.txt")]
        text = (work / report).read_text()
        blocks[name] = {"command": "JAX_PLATFORMS=cpu python -m ppr_tpu.cli "
                                   + shlex.join(args), "report": text}
        rows += read_protocol_rows(text)
    path = tmp_path_factory.mktemp("ref") / "jax_cpu.json"
    path.write_text(json.dumps({"blocks": blocks}))
    return str(path), rows


def tiny_jobs():
    jobs = []
    for test in (1, 2, 3):
        for algo in grid.section_algos("got", test):
            if test == 3 and algo in report.WALK_ALGOS:
                continue
            walks = "walks" if algo.startswith("FORA") else "auto"
            jobs.append(grid.Job("tiny", test, algo, 0, walks, db=TINY,
                                 sweep="got"))
    return jobs


def grid_args(tmp, jax_cpu, **kw):
    args = grid.parse_args(["--device", "cpu", "--jax-cpu", jax_cpu,
                            "--stamps", str(tmp / "done"),
                            "--grid", str(tmp / "grid"),
                            "--out", str(tmp / "grid.json")])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_small_grid_within_bars(tmp_path, jax_reference):
    jax_cpu, jax_rows = jax_reference
    jobs = tiny_jobs()
    assert len(jobs) == len(jax_rows) == 13
    out = grid.run(grid_args(tmp_path, jax_cpu), jobs, inprocess=True)
    assert out["counts"] == {"pass": 13}, [
        (r["tag"], r.get("accuracy"), r.get("reference"))
        for r in out["rows"] if r.get("verdict") != "pass"]
    for r in out["rows"]:
        # each row drew its reference row's sources
        [ref] = [x for x in jax_rows if (x.test, x.algo) ==
                 (r["job"]["test"], r["job"]["algo"])]
        assert r["draw"] == ref.draw
        assert r["reference"]["source"] == "jax-cpu"
        if r["job"]["test"] == 3 or r["job"]["algo"] == "BASE_WHOLE_GRAPH":
            assert r["store_bytes"] > 0 and r["prep_ms"] > 0
        # the deterministic rows agree far inside their bars
        if r["job"]["algo"] in ("FWDPUSH", "NEO4J_METHOD") \
                and r["job"]["test"] != 2:
            assert abs(r["accuracy"] - ref.accuracy) <= 1e-6 * max(
                ref.accuracy, 1e-3)


def neo4j_t2(iters, precision, ndcg):
    return ProtocolRow("", 2, "NEO4J_METHOD",
                       [str(iters), "10", "1.5", str(precision), str(ndcg)],
                       0)


def test_bars():
    bar = report.reference_bar
    assert bar(1, "FWDPUSH", 1e-3) == report.Bar(
        "abs", 0.01 * 1e-3 + 1e-7, "|max-err - ref| <= 1% ref + 1e-7")
    assert (bar(3, "BASE_WHOLE_GRAPH", 0.3).kind,
            bar(3, "BASE_WHOLE_GRAPH", 0.3).limit) == ("abs", 1e-3)
    assert bar(2, "NEO4J_METHOD", 0.9).limit == 0.002
    assert bar(1, "MC", 2e-3) == report.Bar(
        "max", 1.5 * 2e-3 + 1e-4, "max-err <= 1.5 x ref + 1e-4")
    assert bar(2, "FORA_TOPK", 0.94).holds(0.9, 0.94)
    assert not bar(2, "MC", 0.94).holds(0.88, 0.94)
    t1 = ProtocolRow("", 1, "NEO4J_METHOD", ["100", "1.0", "2e-06"], 0)
    assert report.own_bar(t1) is not None
    t1.fields = ["40", "1.0", "2e-04"]
    assert report.own_bar(t1) is None
    # from 40 iterations precision 1.0 and NDCG >= 0.999, both
    assert report.own_bar(neo4j_t2(40, 1.0, 0.9995)) is None
    assert report.own_bar(neo4j_t2(40, 1.0, 0.99)) is not None
    assert report.own_bar(neo4j_t2(5, 0.9, 0.95)) is None


@pytest.mark.parametrize("row,want,ok", [
    (neo4j_t2(40, 1.0, 0.99), 1.0, False),
    (neo4j_t2(40, 1.0, 0.9999), 1.0, True),
    (neo4j_t2(5, 0.954, 0.97), 0.955, True),
    (neo4j_t2(5, 0.95, 0.97), 0.954, False),
    (ProtocolRow("", 1, "MC", ["1.0", "34.5", "1.2e-4"], 0), 5.2e-3, True),
    (ProtocolRow("", 1, "MC", ["1.0", "34.5", "9e-3"], 0), 5.2e-3, False),
    (ProtocolRow("", 3, "FWDPUSH", ["1e-05", "-1", "9.0", "0", "1e-4"], 0),
     1e-4, False),
    (ProtocolRow("", 1, "FWDPUSH", ["1e-06", "1.0", "nan"], 0), None,
     False),
])
def test_smoke_and_grid_hold_a_row_alike(row, want, ok, capsys):
    """chip_smoke.py's check and the grid's verdict are one bar."""
    import chip_smoke

    ref = None if want is None else {
        "source": "jax-cpu", "where": "test", "completion": "auto",
        "row": types.SimpleNamespace(accuracy=want, draw=0)}
    verdict = grid.verdict_for(row, ref)["verdict"]
    assert verdict == ("pass" if ok else "fail" if ref else "no reference")
    jax_rows = {} if want is None else {(row.test, row.algo):
                                        {row.param: want}}
    if ok:
        chip_smoke.check_protocol_rows("t", [row], jax_rows)
    else:
        with pytest.raises(RuntimeError):
            chip_smoke.check_protocol_rows("t", [row], jax_rows)


# --- (d) stamps and a cut store's resume ------------------------------------
def test_stamped_job_reruns_nothing(tmp_path, jax_reference, monkeypatch):
    jax_cpu, _ = jax_reference
    [job] = [j for j in tiny_jobs() if (j.test, j.algo) == (1, "FWDPUSH")]
    args = grid_args(tmp_path, jax_cpu)
    first = grid.run(args, [job], inprocess=True)
    assert first["counts"] == {"pass": 1}
    ran = []
    monkeypatch.setattr(grid, "run_job", lambda *a, **kw: ran.append(a))
    monkeypatch.setattr(grid, "launch", lambda *a, **kw: ran.append(a))
    again = grid.run(args, [job], inprocess=True)
    assert ran == [] and again["rows"] == first["rows"]


def test_cut_job_resumes_from_its_last_shard(tmp_path, jax_reference,
                                             monkeypatch):
    from ppr_tpu_torch.utils.store import PPRStore

    jax_cpu, jax_rows = jax_reference
    [job] = [j for j in tiny_jobs() if (j.test, j.algo) == (3, "FWDPUSH")]
    args = grid_args(tmp_path, jax_cpu)
    written = []
    orig = PPRStore.write_batch_ordered

    class Cut(Exception):
        pass

    def write(self, start, *a, **kw):
        if len(written) == 2 and not resumed:
            raise Cut        # the cap's kill, after two complete shards
        written.append(start)
        return orig(self, start, *a, **kw)

    resumed = False
    monkeypatch.setattr(PPRStore, "write_batch_ordered", write)

    def cut_run(job_, draw, work, out_dir, device, timeout_s, log_path):
        # the child, cut: it runs in this process until the cap's kill
        with chdir(work):
            with pytest.raises(Cut):
                grid.run_job(job_, draw, out_dir, device)
        return "cut", 1.5

    monkeypatch.setattr(grid, "launch", cut_run)
    cut = grid.run(args, [job])["rows"][0]
    assert cut["status"] == "cut"
    assert (cut["shards"], cut["shards_before"]) == (2, 0)
    assert cut["elapsed_s"] == 1.5

    resumed = True
    done = grid.run(args, [job], inprocess=True)["rows"][0]
    # 300 sources in batches of 128: shards 0 and 128 were kept, only the
    # last one was computed again
    assert written == [0, 128, 256]
    assert (done["status"], done["attempts"], done["resumed_shards"]) == (
        "done", 2, 2)
    assert done["elapsed_s"] > 1.5
    [ref] = [r for r in jax_rows if (r.test, r.algo) == (3, "FWDPUSH")]
    assert done["verdict"] == "pass"
    assert abs(done["accuracy"] - ref.accuracy) <= 1e-6 * ref.accuracy
    assert not os.path.exists(os.path.join(args.stamps, "cut",
                                           job.tag + ".json"))


def test_cap_kills_the_child(tmp_path, jax_reference):
    """A real child process past its cap is killed and recorded as cut."""
    jax_cpu, _ = jax_reference
    [job] = [j for j in tiny_jobs() if (j.test, j.algo) == (1, "FWDPUSH")]
    job = grid.Job(**{**vars(job), "cap_s": 0.5})
    rec = grid.run(grid_args(tmp_path, jax_cpu), [job])["rows"][0]
    assert rec["status"] == "cut" and rec["seconds"] < 30
    assert rec["shards"] == 0 and rec["attempts"] == 1


def test_no_card_exits_1(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert grid.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# --- the host phases and the deposit witness ---------------------------------
def test_phases_count_their_own_seconds():
    """A phase's seconds leave out those of the phases it calls, so the
    phases of a call add up to its wall."""
    import time

    class Owner:
        def inner(self):
            time.sleep(0.05)

        def outer(self):
            time.sleep(0.02)
            self.inner()
            self.inner()

    with grid.Phases() as ph:
        ph.wrap(Owner, "outer", "outer")
        ph.wrap(Owner, "inner", "inner")
        t0 = time.perf_counter()
        Owner().outer()
        wall = time.perf_counter() - t0
    assert ph.s["inner"] >= 0.1
    # without the inner calls' 0.1 s
    assert 0.02 <= ph.s["outer"] < 0.1
    assert abs(ph.s["inner"] + ph.s["outer"] - wall) < 0.005
    assert Owner.outer.__name__ == "outer"      # unwrapped on exit


@pytest.mark.parametrize("test", [1, 2])
def test_base_host_phases(tmp_path, test):
    """BASE's host work after its sweep is timed: the grouping by source,
    each source's top-k (Test 2 only) and the rest of its call."""
    job = grid.Job("tiny", test, "BASE_WHOLE_GRAPH", 0, db=TINY, sweep="got")
    with chdir(tmp_path):
        rec = grid.run_job(job, 0, str(tmp_path), "cpu")
    ph = rec["phases_s"]
    assert {"compute", "select", "group", "base_rest",
            "store_write"} <= set(ph)
    assert ("topk" in ph) == (test == 2)


def test_mc_deposit_witness(tmp_path):
    """The f64 deposit keeps every walk's mass and the f32 one, on the same
    walks, loses some; the sources are the draw's."""
    import mc_deposit_torch as mcd
    from ppr_tpu_torch.graph.io import synthetic_powerlaw
    from ppr_tpu_torch.harness import PerfHarness
    from ppr_tpu_torch.models.monte_carlo import mc_num_walks

    out = mcd.run(mcd.parse_args([
        "--device", "cpu", "--db", TINY, "--eps", "0.5", "--draw", "2",
        "--sources", "3", "--out", str(tmp_path / "mc.json")]))
    h = PerfHarness(synthetic_powerlaw(300, 4, seed=5, device="cpu"),
                    out_dir=str(tmp_path), progress=False)
    grid.advance_draws(h, 2)
    assert out["sources"] == h.get_query_nodes(50)[:3].tolist()
    assert out["omega"] == mc_num_walks(0.5, 1 / 300, 1 / 300)
    assert all(abs(m - 1.0) < 1e-6 for m in out["f64"]["mass"])
    assert all(m32 <= m64 + 1e-6 for m32, m64 in
               zip(out["f32"]["mass"], out["f64"]["mass"]))
    assert out["f64"]["mean_max_err"] < 0.05
    assert json.loads((tmp_path / "mc.json").read_text())["eps"] == 0.5
    assert mcd.main(["--device", "cuda"]) == (0 if torch.cuda.is_available()
                                              else 1)
