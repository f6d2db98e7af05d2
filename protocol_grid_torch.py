#!/usr/bin/env python3
"""The reference protocol's grid on the card, job by job — the port's
counterpart of ``scripts/run_protocol_sweeps.sh``, ``run_prep_sweeps.sh``,
``bank_small_prep.sh``, ``run_amazon_prep*.sh`` and ``round5_grid*.sh``.

A job is one param of one section: ``(dataset, test, algorithm, param
index, flags)``, run through the port's :class:`PerfHarness` as
``round5_grid.sh`` runs one through the JAX CLI (``--algos ALGO:N
--budget-s 1``; here ``--budget-s 0``: the section's N-th param and no
other, however fast it is). Each job:

* runs in a child process of its own, from its own directory under
  ``build/ppr_tpu_torch/grid/<dataset>/<tag>/`` (its preprocessing stores
  live there), writing its report into a fresh out-dir there, never into
  ``results/`` (the report writer appends);
* draws its queries at the *draw index* of its reference row: the port
  harness's generator is advanced by that many draws of ``query_num``
  before the section, so the row's 50 sources are the reference row's;
* has a time cap. A job that finishes leaves a stamp under ``--stamps``
  and is never run again; a job its cap cuts records its seconds and the
  store shards it finished, and the next call runs it again from the same
  directory, where the npz store resumes from its last complete shard;
* is held to its reference row — the JAX package's row for the same
  dataset, test, algorithm, param, flags and draw index: a ``jax-cpu``
  row of ``results/protocol_grid_jax_cpu.json`` (made by
  ``protocol_grid_reference.py``) or, failing one, a ``tpu-banked`` row of
  ``results/<dataset>_AlgoPerfResults.txt``, whose time columns are never
  compared — by PERF.md section 2's bars
  (:func:`ppr_tpu_torch.utils.report.row_failures`, the bars
  ``chip_smoke.py`` holds its protocol rows to).

Jobs run cheapest first within a dataset, by the seconds ``--out`` holds
for each (:func:`measured_s`). After every job
the artifact ``--out`` (default ``results/protocol_grid_h100.json``) is
written from every stamp and cut record: each row with its wall, prep ms,
store bytes, store-read ms, peak device memory, host phases, reference,
bar and verdict, and the card's ``nvidia-smi`` line.

Usage (on the card; ``--device cpu`` runs on the CPU, and without a card
the script exits 1)::

    python3 protocol_grid_torch.py [--datasets blogcatalog,flickr,amazon]
        [--tests 1,2,3] [--only TAG,...] [--all] [--deadline-s S]
        [--stamps DIR] [--out FILE] [--list | --collect]
    python3 protocol_grid_torch.py --profile TAG [--profile-batches 4]

``--all`` adds every param of every section beyond each section's first
(the minimum set); ``--list`` prints the jobs with their references and
runs nothing; ``--collect`` writes ``--out`` from the stamps and cut
records and runs nothing. ``--profile TAG`` traces a window of that job's
steady state under ``torch.profiler`` (device time by kernel, idle share)
and writes
``build/ppr_tpu_torch/grid/profile_<TAG>.json``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import shlex
import shutil
import signal
import subprocess
import sys
import time

from ppr_tpu_torch.utils.report import (ProtocolRow, read_protocol_rows,
                                        reference_bar, row_failures)

PROG = "protocol_grid_torch"
QUERY, K, ALPHA, SEED = 50, 10, 0.15, 0
GRID = os.path.join("build", "ppr_tpu_torch", "grid")
STAMPS = os.path.join(GRID, "done")
OUT = os.path.join("results", "protocol_grid_h100.json")
JAX_CPU = os.path.join("results", "protocol_grid_jax_cpu.json")
DATASETS = ("blogcatalog", "flickr", "amazon")
SECTIONS = {1: "whole_graph", 2: "topk", 3: "prep"}

#: FORA completion of the banked TPU blocks made with one forced; every
#: other banked block ran ``auto``. ``scripts/run_amazon_prep.sh`` ran
#: amazon's FORA preprocessing with ``--fora-completion walks``.
BANKED_COMPLETION = {("amazon", "2026-08-20 22:24:36"): "walks"}

#: The seconds a job is taken to cost until ``--out`` holds its measured
#: ``elapsed_s``; jobs run cheapest first within a dataset.
DEFAULT_S = 600.0


def measured_s(path: str = OUT) -> dict[str, float]:
    """Each job's measured seconds (``elapsed_s``: every attempt, its
    process included) by tag, from an artifact of this driver."""
    rows = (_read(path) or {}).get("rows", [])
    return {r["tag"]: r["elapsed_s"] for r in rows if "elapsed_s" in r}


#: Jobs of the minimum set that run under a cap and may be cut (the rest
#: must finish): amazon's Test 3 walk sweeps.
CAPPED = {("amazon", 3, "MC"), ("amazon", 3, "FORA_WHOLE_GRAPH")}
CAP_S, CAPPED_S = 2400.0, 900.0


@dataclasses.dataclass(frozen=True)
class Job:
    """One param of one section. ``db`` is a ``--db`` spec; ``sweep`` the
    harness's ``SWEEPS`` key."""

    dataset: str
    test: int
    algo: str
    index: int = 0
    completion: str = "auto"
    db: str = ""
    sweep: str = ""
    cap_s: float = CAP_S

    @property
    def spec(self) -> str:
        return self.db or f"synth:{self.dataset}"

    @property
    def sweep_name(self) -> str:
        return self.sweep or self.dataset

    @property
    def tag(self) -> str:
        extra = "" if self.completion == "auto" else f"_{self.completion}"
        return f"{self.dataset}_t{self.test}_{self.algo}_p{self.index}{extra}"

    @property
    def param(self):
        from ppr_tpu_torch.harness import SWEEPS
        from ppr_tpu_torch.models.config import AlgoType

        return SWEEPS[self.sweep_name][SECTIONS[self.test]][
            AlgoType(self.algo)][self.index]

    @property
    def algos_arg(self) -> str:
        return f"{self.algo}:{self.index}" if self.index else self.algo

    def cli_args(self) -> list[str]:
        """The CLI command this job is, but for its draw index."""
        args = ["--db", self.spec, "--query", str(QUERY), "--k", str(K),
                "--tests", str(self.test), "--algos", self.algos_arg,
                "--budget-s", "0"]
        if self.sweep:
            args += ["--sweep", self.sweep]
        if self.completion != "auto":
            args += ["--fora-completion", self.completion]
        return args


def section_algos(sweep: str, test: int) -> list[str]:
    from ppr_tpu_torch.harness import SWEEPS

    return [a.value for a, params in SWEEPS[sweep][SECTIONS[test]].items()
            if params]


def jobs_for(datasets, tests=(1, 2, 3), every_param=False,
             seconds: dict[str, float] | None = None) -> list[Job]:
    """The grid's jobs: each section's first param (the minimum set), or
    with ``every_param`` every param; within a dataset the first params
    first, each group cheapest first by ``seconds`` (:func:`measured_s`;
    :data:`DEFAULT_S` for a job it lacks).
    FORA carries walk completion where its reference's command did:
    amazon's preprocessing (``run_amazon_prep.sh``) and blogcatalog's
    first params, whose reference rows the JAX CPU makes with it; the
    banked rows of every other param ran ``auto``."""
    from ppr_tpu_torch.harness import SWEEPS
    from ppr_tpu_torch.models.config import AlgoType

    out = []
    for ds in datasets:
        mine = []
        for test in tests:
            for algo in section_algos(ds, test):
                n = len(SWEEPS[ds][SECTIONS[test]][AlgoType(algo)])
                cap = CAPPED_S if (ds, test, algo) in CAPPED else CAP_S
                for i in range(n if every_param else 1):
                    walks = algo.startswith("FORA") and (
                        (ds, test) == ("amazon", 3)
                        or (ds == "blogcatalog" and i == 0))
                    mine.append(Job(ds, test, algo, i,
                                    "walks" if walks else "auto", cap_s=cap))
        mine.sort(key=lambda j: (j.index != 0, (seconds or {}).get(
            j.tag, DEFAULT_S)))
        out += mine
    return out


# --- references ------------------------------------------------------------
def _flag(argv: list[str], name: str, default=None):
    return argv[argv.index(name) + 1] if name in argv else default


def reference_rows(job: Job, jax_cpu: str = JAX_CPU,
                   banked_dir: str = "results") -> list[dict]:
    """Every candidate reference row of ``job``'s dataset: the rows of the
    ``jax-cpu`` blocks whose command names its ``--db`` and ``--sweep``
    first, then those of the banked TPU report, each ``{"source",
    "where", "completion", "row"}`` with its
    :class:`~ppr_tpu_torch.utils.report.ProtocolRow`."""
    out = []
    if os.path.exists(jax_cpu):
        with open(jax_cpu) as f:
            blocks = json.load(f)["blocks"]
        for name, block in blocks.items():
            argv = shlex.split(block["command"])
            if (_flag(argv, "--db"), _flag(argv, "--sweep")) != (
                    job.spec, job.sweep or None):
                continue
            for r in read_protocol_rows(block["report"]):
                out.append({"source": "jax-cpu",
                            "where": f"{jax_cpu}:{name}",
                            "command": block["command"],
                            "completion": _flag(argv, "--fora-completion",
                                                "auto"),
                            "row": r})
    path = os.path.join(banked_dir, f"{job.dataset}_AlgoPerfResults.txt")
    if not job.db and os.path.exists(path):
        with open(path) as f:
            for r in read_protocol_rows(f.read()):
                out.append({"source": "tpu-banked",
                            "where": f"{path} @ {r.block}",
                            "completion": BANKED_COMPLETION.get(
                                (job.dataset, r.block), "auto"),
                            "row": r})
    return out


def find_reference(job: Job, candidates: list[dict]) -> dict | None:
    """The first candidate for ``job``'s test, algorithm, param and FORA
    completion (``jax-cpu`` before ``tpu-banked``)."""
    want = str(job.param)
    for c in candidates:
        r = c["row"]
        if (r.test, r.algo, r.param) != (job.test, job.algo, want):
            continue
        if job.algo.startswith("FORA") and c["completion"] != job.completion:
            continue
        return c
    return None


# --- the child: one job in this process -------------------------------------
class Phases:
    """Host seconds of a job by phase: ``oracle`` (the power method),
    ``compute`` (the algorithm's device batches, queries and preprocessing
    alike), ``select`` (a preprocessing batch's selection and its copy to
    the host), ``store_write``, ``store_read``, and BASE's host work after
    its sweep: ``group`` (the kept entries grouped by source), ``topk``
    (each source's top-k with ties, Test 2) and ``base_rest`` (the rest of
    its preprocessing call: the loops over target batches and sources).
    A phase counts its own seconds, not those of the phases it calls. A
    device phase waits for the card where its call returns (one
    synchronization a call, which the uninstrumented CLI does not make);
    a host phase does not."""

    def __init__(self):
        self.s: dict[str, float] = {}
        self._undo = []
        self._inner: list[float] = []

    def wrap(self, owner, name: str, key: str, dev=None) -> None:
        from ppr_tpu_torch.device import synchronize

        orig = getattr(owner, name)

        def timed(*a, **kw):
            self._inner.append(0.0)
            t0 = time.perf_counter()
            try:
                out = orig(*a, **kw)
                if dev is not None:
                    synchronize(dev)
            finally:
                took = time.perf_counter() - t0
                inner = self._inner.pop()
                if self._inner:
                    self._inner[-1] += took
                self.s[key] = self.s.get(key, 0.0) + took - inner
            return out

        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


def instrument(phases: Phases, dev) -> None:
    from ppr_tpu_torch.models import base, base_allpair
    from ppr_tpu_torch.models.backward_search import BackwardSearch
    from ppr_tpu_torch.models.fora import ForaTopk, ForaWholeGraph
    from ppr_tpu_torch.models.forward_push import ForwardPush
    from ppr_tpu_torch.models.monte_carlo import MonteCarlo
    from ppr_tpu_torch.models.neo4j_method import Neo4jMethod
    from ppr_tpu_torch.models.power_method import PowerMethod
    from ppr_tpu_torch.utils.store import PPRStore

    phases.wrap(PowerMethod, "compute_whole_graph_batch", "oracle", dev)
    for cls in (ForwardPush, Neo4jMethod, MonteCarlo, ForaWholeGraph,
                ForaTopk):
        for name in ("compute_whole_graph_device",
                     "compute_whole_graph_batch", "compute_topk_batch"):
            if name in vars(cls):
                phases.wrap(cls, name, "compute", dev)
    phases.wrap(BackwardSearch, "whole_graph_device", "compute", dev)
    phases.wrap(base, "threshold_nonzeros", "select", dev)
    phases.wrap(base_allpair, "threshold_nonzeros", "select", dev)
    phases.wrap(PPRStore, "write_batch_ordered", "store_write")
    phases.wrap(PPRStore, "read_row_ordered", "store_read")
    phases.wrap(base_allpair, "group_by_source", "group")
    phases.wrap(base_allpair.BaseAllPair, "_topk_row", "topk")
    phases.wrap(base_allpair.BaseAllPair, "preprocessing", "base_rest")


def advance_draws(harness, draws: int, query_num: int = QUERY) -> None:
    """Move ``harness``'s query generator past ``draws`` query sets, as
    ``draws`` earlier rows of one invocation would have."""
    for _ in range(draws):
        harness.get_query_nodes(query_num)


def run_job(job: Job, draw: int, out_dir: str, device: str = "cuda") -> dict:
    """Run ``job`` in this process from the current directory (where its
    stores live), its report into ``out_dir``; returns the child record:
    seconds, peak device memory, the store-read ms a query, host phases."""
    import torch

    from ppr_tpu_torch import cli
    from ppr_tpu_torch.harness import PerfHarness
    from ppr_tpu_torch.utils import drivers

    dev = torch.device(device)
    t0 = time.perf_counter()
    ds = cli.load_dataset(job.spec, device=device)
    load_s = time.perf_counter() - t0
    harness = PerfHarness(ds, alpha=ALPHA, seed=SEED, out_dir=out_dir,
                          fora_completion=job.completion)
    advance_draws(harness, draw)
    drivers.reset_peak(dev)
    with Phases() as phases:
        instrument(phases, dev)
        t0 = time.perf_counter()
        [res] = harness.algo_perf_batch_test(
            QUERY, K, sweep=job.sweep_name, tests=(job.test,), budget_s=0,
            algos={job.algos_arg})
        wall_s = time.perf_counter() - t0
    return {"wall_s": wall_s, "load_s": load_s,
            "peak_gb": drivers.peak_gb(dev),
            "query_ms": res.avg_ms,
            "phases_s": {k: round(v, 3) for k, v in phases.s.items()}}


def child_main(spec: str) -> int:
    """``--child``: one job from its JSON, the record into its out-dir."""
    from ppr_tpu_torch.utils import drivers

    arg = json.loads(spec)
    job = Job(**arg["job"])
    record = run_job(job, arg["draw"], arg["out_dir"], arg["device"])
    drivers.write_json(os.path.join(arg["out_dir"], "child.json"), record)
    return 0


# --- the parent: jobs, stamps, cut records, the artifact ---------------------
def store_shards(work: str) -> int:
    """Complete npz shards under a job's directory (its stores)."""
    n = 0
    for _, _, files in os.walk(work):
        n += sum(f.startswith("batch_") and f.endswith(".npz")
                 for f in files)
    return n


def _read(path: str) -> dict | None:
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def launch(job: Job, draw: int, work: str, out_dir: str, device: str,
           timeout_s: float, log_path: str) -> tuple[str, float]:
    """Run ``job`` in a child process from ``work``; ``(status,
    seconds)`` with status ``done``, ``cut`` (its cap killed it) or
    ``error``."""
    spec = json.dumps({"job": dataclasses.asdict(job), "draw": draw,
                       "out_dir": out_dir, "device": device})
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.abspath(__file__)),
         os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    with open(log_path, "a") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--child", spec],
            cwd=work, env=env, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            rc = proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            return "cut", time.perf_counter() - t0
    return ("done" if rc == 0 else "error"), time.perf_counter() - t0


def run_one(job: Job, ref: dict | None, args, card: str,
            inprocess: bool = False) -> dict:
    """Run ``job`` unless stamped; returns its record (stamp, cut or
    error). ``inprocess`` runs it in this process (tests; no cap)."""
    from ppr_tpu_torch.utils import drivers

    stamp = os.path.join(args.stamps, job.tag + ".json")
    done = _read(stamp)
    if done is not None:
        return done
    cut_path = os.path.join(args.stamps, "cut", job.tag + ".json")
    prior = _read(cut_path) or {"attempts": 0, "elapsed_s": 0.0}
    draw = ref["row"].draw if ref else 0
    work = os.path.abspath(os.path.join(args.grid, job.dataset, job.tag))
    os.makedirs(work, exist_ok=True)
    attempt = prior["attempts"] + 1
    out_dir = os.path.join(work, f"attempt{attempt}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    shards_before = store_shards(work)
    log_path = os.path.join(work, "job.log")
    timeout_s = min(job.cap_s, max(args.deadline - time.monotonic(), 1.0))
    print(f"[grid] {job.tag}: draw {draw}, cap {timeout_s:.0f} s, "
          f"attempt {attempt}, {shards_before} shard(s) to resume from",
          flush=True)
    if inprocess:
        t0 = time.perf_counter()
        with _chdir(work):
            child = run_job(job, draw, out_dir, args.device)
        drivers.write_json(os.path.join(out_dir, "child.json"), child)
        status, secs = "done", time.perf_counter() - t0
    else:
        status, secs = launch(job, draw, work, out_dir, args.device,
                              timeout_s, log_path)
    record = {"tag": job.tag, "job": dataclasses.asdict(job),
              "param": str(job.param), "draw": draw,
              "command": "python -m ppr_tpu_torch.cli "
                         + shlex.join(job.cli_args())
                         + f"  (query generator advanced by {draw} draws)",
              "attempts": attempt,
              "elapsed_s": round(prior["elapsed_s"] + secs, 3),
              "card": card}
    if status != "done":
        record.update(status=status, seconds=round(secs, 3),
                      shards=store_shards(work),
                      shards_before=shards_before, cap_s=timeout_s)
        if status == "error":
            with open(log_path) as f:
                record["log_tail"] = f.read()[-3000:]
        drivers.write_json(cut_path, record)
        return record
    [report] = [f for f in os.listdir(out_dir)
                if f.endswith("_AlgoPerfResults.txt")]
    with open(os.path.join(out_dir, report)) as f:
        [row] = read_protocol_rows(f.read())
    child = _read(os.path.join(out_dir, "child.json"))
    got = row.accuracy
    prep = row.prep
    record.update(
        status="done", seconds=round(secs, 3), fields=row.fields,
        accuracy=got, query_ms=row.query_ms, read_ms=(
            child["query_ms"] if prep is not None else None),
        prep_ms=prep[0] if prep else None,
        store_bytes=prep[1] if prep else None,
        wall_s=round(child["wall_s"], 3), load_s=round(child["load_s"], 3),
        peak_gb=child["peak_gb"], phases_s=child["phases_s"],
        resumed_shards=shards_before)
    record.update(verdict_for(row, ref))
    drivers.write_json(stamp, record)
    if os.path.exists(cut_path):
        os.remove(cut_path)
    shutil.rmtree(work, ignore_errors=True)     # the stores: done with
    return record


@contextlib.contextmanager
def _chdir(path: str):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def verdict_for(row: ProtocolRow, ref: dict | None) -> dict:
    """``row``'s verdict against its reference ``ref`` (a
    :func:`find_reference` candidate, or None) by
    :func:`~ppr_tpu_torch.utils.report.row_failures`."""
    if ref is None:
        return {"reference": None, "verdict": "no reference"}
    want = ref["row"].accuracy
    bar = reference_bar(row.test, row.algo, want)
    failures = row_failures(row, want)
    reference = {"source": ref["source"], "where": ref["where"],
                 "draw": ref["row"].draw, "accuracy": want,
                 "completion": ref["completion"]}
    if "command" in ref:
        reference["command"] = ref["command"]
    return {"reference": reference,
            "bar": {"kind": bar.kind, "limit": bar.limit, "text": bar.text},
            "failures": failures,
            "verdict": "fail" if failures else "pass"}


def artifact(jobs: list[Job], refs: dict, stamps: str, grid: str) -> dict:
    """Every job's record: its stamp with its verdict under the current
    bars and ``refs``, else its cut record, else ``not run``; the counts of verdicts over every job and over the minimum set
    (each section's first param), the cards the records name, and the
    ``--profile`` windows found under ``grid``."""
    rows = []
    for job in jobs:
        rec = (_read(os.path.join(stamps, job.tag + ".json"))
               or _read(os.path.join(stamps, "cut", job.tag + ".json")))
        if rec is not None and rec["status"] == "done":
            # judged anew, so a stamp is held to the bars and references
            # of this run
            rec.update(verdict_for(ProtocolRow(
                "", job.test, job.algo, rec["fields"], rec["draw"]),
                refs.get(job.tag)))
        elif rec is None:
            ref = refs.get(job.tag)
            rec = {"tag": job.tag, "job": dataclasses.asdict(job),
                   "param": str(job.param), "status": "not run",
                   "reference_source": ref["source"] if ref else None}
        rows.append(rec)
    count: dict[str, int] = {}
    minimum: dict[str, int] = {}
    for r in rows:
        key = r.get("verdict", r["status"])
        count[key] = count.get(key, 0) + 1
        if r["job"]["index"] == 0:
            minimum[key] = minimum.get(key, 0) + 1
    profiles = {}
    if os.path.isdir(grid):
        for f in sorted(os.listdir(grid)):
            if f.startswith("profile_") and f.endswith(".json"):
                profiles[f[len("profile_"):-len(".json")]] = _read(
                    os.path.join(grid, f))
    return {"cards": sorted({r["card"] for r in rows if "card" in r}),
            "query_num": QUERY, "k": K, "alpha": ALPHA,
            "counts": count, "counts_minimum_set": minimum,
            "profiles": profiles, "rows": rows}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--datasets", default=",".join(DATASETS))
    ap.add_argument("--tests", default="1,2,3")
    ap.add_argument("--only", default=None,
                    help="comma list of job tags (default: every job)")
    ap.add_argument("--all", action="store_true",
                    help="every param of every section, not only the first")
    ap.add_argument("--deadline-s", type=float, default=float("inf"),
                    help="start no job after this many seconds; cap each "
                         "at what is left")
    ap.add_argument("--stamps", default=STAMPS)
    ap.add_argument("--grid", default=GRID,
                    help="the jobs' working directories")
    ap.add_argument("--jax-cpu", default=JAX_CPU)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--list", action="store_true",
                    help="print the jobs and their references; run nothing")
    ap.add_argument("--collect", action="store_true",
                    help="write --out from the stamps; run nothing")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--profile", default=None, metavar="TAG")
    ap.add_argument("--profile-batches", type=int, default=4)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def run(args, jobs: list[Job] | None = None, inprocess: bool = False) -> dict:
    """Run the grid's jobs not yet stamped; returns the artifact."""
    import torch

    from ppr_tpu_torch.utils import drivers

    if jobs is None:
        jobs = jobs_for(args.datasets.split(","),
                        tuple(int(t) for t in args.tests.split(",")),
                        every_param=args.all, seconds=measured_s(args.out))
        if args.only:
            keep = set(args.only.split(","))
            jobs = [j for j in jobs if j.tag in keep]
    args.deadline = time.monotonic() + args.deadline_s
    card = drivers.describe(torch.device(args.device))["card"]
    refs = {j.tag: find_reference(j, reference_rows(j, args.jax_cpu))
            for j in jobs}
    if args.list:
        for j in jobs:
            r = refs[j.tag]
            print(f"{j.tag:40s} param {j.param!s:8s} "
                  f"{measured_s(args.out).get(j.tag, '?')!s:>9s} s "
                  f"cap {j.cap_s:.0f} s  ref "
                  + (f"{r['source']} draw {r['row'].draw} acc "
                     f"{r['row'].accuracy:.6g} ({r['where']})" if r else
                     "none"))
        return artifact(jobs, refs, args.stamps, args.grid)
    if args.collect:
        out = artifact(jobs, refs, args.stamps, args.grid)
        drivers.write_json(args.out, out)
        return out
    for job in jobs:
        if time.monotonic() > args.deadline - 30:
            print(f"[grid] deadline: {job.tag} and later jobs left for the "
                  f"next call", flush=True)
            break
        rec = run_one(job, refs[job.tag], args, card, inprocess=inprocess)
        print(f"[grid] {job.tag}: {rec['status']}"
              + (f", {rec.get('verdict')}: got {rec.get('accuracy')} vs "
                 f"{(rec.get('reference') or {}).get('accuracy')}, prep "
                 f"{rec.get('prep_ms')} ms, store {rec.get('store_bytes')} "
                 f"B, wall {rec.get('wall_s')} s" if rec["status"] == "done"
                 else f" after {rec.get('seconds')} s, "
                      f"{rec.get('shards')} shard(s)"), flush=True)
        drivers.write_json(args.out,
                           artifact(jobs, refs, args.stamps, args.grid))
    out = artifact(jobs, refs, args.stamps, args.grid)
    drivers.write_json(args.out, out)
    return out


def algo_class(algo: str):
    from ppr_tpu_torch.models.fora import ForaTopk, ForaWholeGraph
    from ppr_tpu_torch.models.forward_push import ForwardPush
    from ppr_tpu_torch.models.monte_carlo import MonteCarlo
    from ppr_tpu_torch.models.neo4j_method import Neo4jMethod

    return {"MC": MonteCarlo, "FWDPUSH": ForwardPush,
            "FORA_WHOLE_GRAPH": ForaWholeGraph, "FORA_TOPK": ForaTopk,
            "NEO4J_METHOD": Neo4jMethod}[algo]


def profile(args) -> dict:
    """Trace a steady-state window of one job: after its warm-up, the
    calls of ``--profile-batches`` batches of its device computation
    (preprocessing batches, BASE's target batches, or its query batches)
    under ``torch.profiler``, each with its selection and store write.
    Returns and writes device time by kernel, the kernels' busy time, span
    and the idle share in the window."""
    import torch
    from torch.profiler import ProfilerActivity

    from ppr_tpu_torch.models.backward_search import BackwardSearch
    from ppr_tpu_torch.utils import drivers
    from ppr_tpu_torch.utils.store import PPRStore
    from ppr_tpu_torch.utils.timer import kernel_split

    [job] = [j for j in jobs_for(DATASETS, every_param=True)
             if j.tag == args.profile]
    ref = find_reference(job, reference_rows(job, args.jax_cpu))
    work = os.path.abspath(os.path.join(args.grid, job.dataset,
                                        "profile_" + job.tag))
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    trace = os.path.join(work, "trace.json")
    prof = torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    state = {"calls": 0, "t0": 0.0, "wall": 0.0}
    prep = job.test == 3 or job.algo == "BASE_WHOLE_GRAPH"

    class WindowDone(Exception):
        pass

    def hooked(*a, **kw):
        # the window's unit: a store shard (preprocessing), BASE's target
        # batch, or the timed query batch; the first call is the warm-up's
        state["calls"] += 1
        last = 2 if not prep else 1 + args.profile_batches
        if state["calls"] == 2:
            torch.cuda.synchronize()
            prof.start()
            state["t0"] = time.perf_counter()
        elif prep and state["calls"] > last:
            stop()
        out = orig(*a, **kw)
        if not prep and state["calls"] == last:
            stop()
        return out

    def stop():
        torch.cuda.synchronize()
        state["wall"] = time.perf_counter() - state["t0"]
        prof.stop()
        raise WindowDone

    if job.algo == "BASE_WHOLE_GRAPH":
        owner, name = BackwardSearch, "whole_graph_device"
    elif prep:
        owner, name = PPRStore, "write_batch_ordered"
        state["calls"] = 1               # the warm-up writes no shard
    else:
        owner = algo_class(job.algo)
        name = ("compute_topk_batch" if job.test == 2
                else "compute_whole_graph_batch")
    orig = getattr(owner, name)
    setattr(owner, name, hooked)
    try:
        with _chdir(work):
            run_job(job, ref["row"].draw if ref else 0, work, args.device)
    except WindowDone:
        pass
    finally:
        setattr(owner, name, orig)
    if not state["wall"]:
        raise SystemExit(f"{PROG}: the job ended before its window closed")
    prof.export_chrome_trace(trace)
    split = kernel_split(trace)
    wall_us = state["wall"] * 1e6
    out = {"tag": job.tag, "card": drivers.describe(
               torch.device(args.device))["card"],
           "window": f"{args.profile_batches} "
                     + ("target batches" if job.algo == "BASE_WHOLE_GRAPH"
                        else "store shards" if prep else "query batches"),
           "wall_ms": round(wall_us / 1e3, 3),
           "kernels": split["kernels"],
           "busy_ms": round(split["busy_ms"], 3),
           "span_ms": round(split["span_ms"], 3),
           "idle_share_of_wall": round(1 - split["busy_ms"] * 1e3 / wall_us,
                                       4),
           "by_kernel": [{"name": k["name"][:120], "ms": round(k["ms"], 3),
                          "share": (round(k["share"], 4)
                                    if k["share"] is not None else None),
                          "launches": k["launches"]}
                         for k in split["by_kernel"]]}
    path = os.path.join(args.grid, f"profile_{job.tag}.json")
    drivers.write_json(path, out)
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(out, indent=1))
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.child is not None:
        return child_main(args.child)
    from ppr_tpu_torch.utils import drivers

    if drivers.no_card(args.device, PROG):
        return 1
    if args.profile:
        profile(args)
        return 0
    out = run(args)
    print(json.dumps(out["counts"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
