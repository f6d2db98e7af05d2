"""Benchmark harness — port of ``ppr_tpu/harness.py`` (Gen_Util's
performance tests).

* ``get_query_nodes`` (Gen_Util.java:99-107): uniform random source ids
  with replacement, from a seeded numpy generator (the JAX package's, so
  both draw the same queries).
* ``algo_perf_test`` (:109-257): per-algorithm timing loop; top-k tests
  record avg time / precision / NDCG, whole-graph tests avg time / max-abs
  error, preprocessing tests time ``preprocessing()`` and the per-query
  store reads; rows are appended to ``<dataset>_AlgoPerfResults.txt`` in
  the JAX package's formats (:139-142, :179, :188-203, :244-247).
* ``algo_perf_batch_test`` (:328-646): the three tests over the sweep
  arrays of ``SWEEPS``, the same arrays as the JAX package's.

BASE preprocesses in every test: its sweep value is the threshold, its
``param`` is -1, its store is keyed by ``(threshold, k or -1)``, its
queries are store reads even in Test 3, and its store is not deleted
after a test. ``fora_completion`` goes to every algorithm with a
``completion`` (both FORA algorithms), as in the JAX harness: ``auto``
lets FORA's cost model choose, ``spmv`` and ``walks`` force a completion.
A device mesh raises ``NotImplementedError`` (ROADMAP.md, queue 1, item
18).

Two timing modes: ``batched=True`` times all Q queries as one device batch
(per-query time = batch time / Q); ``batched=False`` times each query
alone, as the reference does (Gen_Util.java:146-151). A timed region ends
with the scores on the host, so it includes the device's work.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from .graph.io import Dataset
from .models.config import AlgoConf, AlgoType
from .models.power_method import PowerMethod
from .ops.topk import topk_ids_with_ties
from .utils.metrics import max_abs_err, ndcg_at_k, precision_at_k
from .utils.report import PerfResultWriter, progress_printer


class TestType:
    WHOLE_GRAPH = "WHOLE_GRAPH"
    TOPK = "TOPK"


# --- sweep specs: Gen_Util.java's per-dataset parameter arrays -------------
# GOT (active in the reference, Gen_Util.java:451-478); the other four
# datasets' arrays are the commented-out testsets at :334-449.
SWEEPS: dict[str, dict] = {
    "got": {
        "topk": {
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 5.0e-4, 5.0e-5, 1.0e-6, 5.0e-7],
            AlgoType.FORA_TOPK: [10.0, 5.0, 0.5, 0.1, 0.05],
            AlgoType.MC: [1.0, 0.5, 0.3, 0.1, 0.05],
            AlgoType.FWDPUSH: [1.0e-4, 1.0e-5, 1.0e-6, 1.0e-7, 1.0e-8],
            AlgoType.NEO4J_METHOD: [5, 40, 100, 200, 300],
        },
        "whole_graph": {
            AlgoType.FORA_WHOLE_GRAPH: [10.0, 5.0, 0.5, 0.1, 0.05],
            AlgoType.FWDPUSH: [1.0e-4, 1.0e-5, 1.0e-6, 1.0e-7, 1.0e-8],
            AlgoType.NEO4J_METHOD: [5, 40, 100, 200, 300],
            AlgoType.MC: [1.0, 0.5, 0.3, 0.1, 0.05],
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 5.0e-4, 5.0e-5, 1.0e-6, 5.0e-7],
        },
        "prep": {
            AlgoType.FORA_WHOLE_GRAPH: [10.0, 5.0, 0.5, 0.1, 0.05],
            AlgoType.FWDPUSH: [1.0e-4, 1.0e-5, 1.0e-6, 1.0e-7, 1.0e-8],
            AlgoType.NEO4J_METHOD: [5, 40, 100, 200, 300],
            AlgoType.MC: [1.0, 0.5, 0.3, 0.1, 0.05],
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 5.0e-4, 5.0e-5, 1.0e-6, 5.0e-7],
        },
    },
    "blogcatalog": {  # Gen_Util.java:334-362
        "whole_graph": {
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 7.0e-4, 5.0e-4, 1.0e-4, 5.0e-5],
            AlgoType.FORA_WHOLE_GRAPH: [50.0, 10.0, 5.0, 1.0, 0.5],
            AlgoType.MC: [5.0, 1.0, 0.7, 0.5, 0.3],
            AlgoType.FWDPUSH: [1.0e-6, 7.0e-7, 5.0e-7, 3.0e-7, 1.0e-7],
            AlgoType.NEO4J_METHOD: [1, 5, 10, 40, 100],
        },
        "topk": {
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 7.0e-4, 5.0e-4, 1.0e-4, 5.0e-5],
            AlgoType.FORA_TOPK: [1.0, 0.5, 0.1, 0.05, 0.01],
            AlgoType.MC: [5.0, 1.0, 0.5, 0.1, 0.05],
            AlgoType.FWDPUSH: [1.0e-6, 5.0e-7, 1.0e-7, 5.0e-8, 1.0e-8],
            AlgoType.NEO4J_METHOD: [1, 5, 10, 40, 100],
        },
        "prep": {  # Gen_Util.java:355-362
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 7.0e-4, 5.0e-4, 1.0e-4, 5.0e-5],
            AlgoType.FORA_WHOLE_GRAPH: [50.0, 10.0, 5.0, 1.0, 0.5],
            AlgoType.MC: [5.0, 1.0, 0.7, 0.5, 0.3],
            AlgoType.FWDPUSH: [1.0e-6, 7.0e-7, 5.0e-7, 3.0e-7, 1.0e-7],
            AlgoType.NEO4J_METHOD: [1, 5, 10, 40, 100],
        },
    },
    "flickr": {  # Gen_Util.java:364-389
        "topk": {
            AlgoType.BASE_WHOLE_GRAPH: [5.0e-4, 3.0e-4, 1.0e-4, 7.0e-5, 5.0e-5],
            AlgoType.FORA_TOPK: [50.0, 10.0, 1.0, 0.1, 0.05],
            AlgoType.MC: [5.0, 1.0, 0.3, 0.1, 0.05],
            AlgoType.FWDPUSH: [5.0e-7, 1.0e-7, 5.0e-8, 1.0e-8, 5.0e-9],
            AlgoType.NEO4J_METHOD: [5, 10, 40, 100, 200],
        },
        "whole_graph": {
            AlgoType.FORA_WHOLE_GRAPH: [500.0, 50.0, 10.0, 5.0, 3.0, 1.0, 0.5],
            AlgoType.FWDPUSH: [5.0e-5, 1.0e-6, 5.0e-8, 1.0e-8, 5.0e-9],
            AlgoType.NEO4J_METHOD: [1, 5, 10, 40, 100],
            AlgoType.MC: [10.0, 5.0, 1.0, 0.5, 0.3],
            AlgoType.BASE_WHOLE_GRAPH: [0.005, 0.001, 5.0e-4, 1.0e-4, 7.0e-5],
        },
        "prep": {  # Gen_Util.java:377-382
            AlgoType.BASE_WHOLE_GRAPH: [0.01, 0.005, 0.001, 7.0e-4, 5.0e-4,
                                        1.0e-4, 7.0e-5, 5.0e-5, 3.0e-5,
                                        1.0e-5],
            AlgoType.FORA_WHOLE_GRAPH: [500.0, 200.0, 100.0, 20.0, 10.0],
            AlgoType.FWDPUSH: [5.0e-5, 1.0e-5, 5.0e-6, 1.0e-6, 7.0e-7],
            AlgoType.NEO4J_METHOD: [1, 5, 10, 40, 100],
            AlgoType.MC: [20.0, 10.0, 7.0, 5.0, 3.0],
        },
    },
    "grqc": {  # Gen_Util.java:391-419
        "topk": {
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 5.0e-4, 5.0e-5, 1.0e-7, 5.0e-8],
            AlgoType.FORA_TOPK: [10.0, 0.5, 0.1, 0.01, 0.001],
            AlgoType.MC: [3.0, 1.0, 0.2, 0.1, 0.05],
            AlgoType.FWDPUSH: [1.0e-4, 1.0e-6, 5.0e-8, 7.0e-9, 7.0e-10],
            AlgoType.NEO4J_METHOD: [5, 40, 300, 500, 1000],
        },
        "whole_graph": {
            AlgoType.FORA_WHOLE_GRAPH: [10.0, 5.0, 0.5, 0.1, 0.05],
            AlgoType.FWDPUSH: [1.0e-4, 1.0e-5, 1.0e-6, 1.0e-7, 1.0e-8],
            AlgoType.NEO4J_METHOD: [5, 40, 100, 200, 300],
            AlgoType.MC: [1.0, 0.5, 0.3, 0.1, 0.05],
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 5.0e-4, 5.0e-5, 1.0e-6, 5.0e-7],
        },
        "prep": {  # Gen_Util.java:412-419
            AlgoType.FORA_WHOLE_GRAPH: [10.0, 5.0, 0.5, 0.3, 0.1],
            AlgoType.FWDPUSH: [1.0e-4, 1.0e-5, 1.0e-6, 5.0e-7, 1.0e-7],
            AlgoType.NEO4J_METHOD: [5, 40, 100, 200, 300],
            AlgoType.MC: [1.0, 0.5, 0.3, 0.2, 0.1],
            AlgoType.BASE_WHOLE_GRAPH: [0.001, 5.0e-4, 5.0e-5, 1.0e-6, 5.0e-7],
        },
    },
    "amazon": {  # Gen_Util.java:421-449
        "topk": {
            AlgoType.BASE_WHOLE_GRAPH: [1.0e-3, 5.0e-4, 1.0e-4, 5.0e-5],
            AlgoType.FORA_TOPK: [50.0, 10.0, 5.0, 1.0, 0.5],
            AlgoType.MC: [10.0, 5.0, 1.0, 0.5, 0.3],
            AlgoType.FWDPUSH: [5.0e-5, 1.0e-5, 5.0e-6, 1.0e-6, 5.0e-7],
            AlgoType.NEO4J_METHOD: [5, 10, 100, 200, 300],
        },
        "whole_graph": {
            AlgoType.BASE_WHOLE_GRAPH: [1.0e-4, 5.0e-5, 4.0e-5, 3.0e-5, 2.0e-5],
            AlgoType.FORA_WHOLE_GRAPH: [50.0, 10.0, 5.0, 3.0, 1.0],
            AlgoType.MC: [1.0, 0.7, 0.5, 0.3, 0.1],
            AlgoType.FWDPUSH: [1.0e-6, 5.0e-7, 3.0e-7, 5.0e-8, 1.0e-8],
            AlgoType.NEO4J_METHOD: [1, 5, 10, 40, 100],
        },
        "prep": {  # Gen_Util.java:441-448 (BASE's prep array is empty there)
            AlgoType.FORA_WHOLE_GRAPH: [500.0, 200.0, 70.0, 50.0, 30.0],
            AlgoType.BASE_WHOLE_GRAPH: [],
            AlgoType.MC: [50.0, 20.0, 10.0, 7.0, 5.0],
            AlgoType.FWDPUSH: [1.0e-5, 5.0e-5, 1.0e-6, 5.0e-7, 3.0e-7],
            AlgoType.NEO4J_METHOD: [1],
        },
    },
}


@dataclasses.dataclass
class PerfResult:
    algo: str
    test_type: str
    param: object
    avg_ms: float
    avg_precision: float | None = None
    avg_ndcg: float | None = None
    avg_max_err: float | None = None
    prep_ms: float | None = None
    prep_bytes: int | None = None


class PerfHarness:
    def __init__(self, dataset: Dataset, alpha: float = 0.15, *, seed: int = 0,
                 out_dir: str = ".", batched: bool = True,
                 progress: bool = True, warmup: bool = True,
                 fora_completion: str = "auto", mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the sharded engines are not ported yet (ROADMAP.md, queue 1, "
                "item 18)"
            )
        if fora_completion not in ("auto", "spmv", "walks"):
            raise ValueError(f"unknown FORA completion {fora_completion!r}")
        self.fora_completion = fora_completion
        self.dataset = dataset
        self.alpha = alpha
        self.seed = seed
        self.batched = batched
        self.progress = progress
        #: in batched mode, run the query batch once untimed first, so the
        #: kernels' build and first launches stay out of per-query times
        self.warmup = warmup
        self.writer = PerfResultWriter(dataset.name, out_dir)
        self._rng = np.random.default_rng(seed)
        self._oracle_cache: dict[tuple, np.ndarray] = {}

    def get_query_nodes(self, query_num: int) -> np.ndarray:
        """Uniform random with replacement (Gen_Util.java:99-107), seeded."""
        return self._rng.integers(0, self.dataset.n, size=query_num)

    # --- oracle ----------------------------------------------------------
    def _oracle_rows(self, sources: np.ndarray) -> np.ndarray:
        key = tuple(int(s) for s in sources)
        if key not in self._oracle_cache:
            pm = PowerMethod(self.dataset, self.alpha)
            self._oracle_cache[key] = pm.compute_whole_graph_batch(sources)
        return self._oracle_cache[key]

    # --- core perf test (Gen_Util.algo_perf_test parity) ------------------
    def algo_perf_test(
        self,
        algo_type: AlgoType,
        query_num: int,
        k: int,
        param,
        threshold: float = -1.0,
        to_be_preprocessed: bool = False,
        test_type: str = TestType.WHOLE_GRAPH,
    ) -> PerfResult:
        conf = AlgoConf(self.alpha, seed=self.seed)
        algo = conf.new_algo_obj(algo_type, self.dataset, k)
        if hasattr(algo, "completion"):
            algo.completion = self.fora_completion
        sources = self.get_query_nodes(query_num)
        oracle_rows = self._oracle_rows(sources)
        report = progress_printer(query_num, enabled=self.progress)

        is_base = algo_type == AlgoType.BASE_WHOLE_GRAPH
        prep_ms = prep_bytes = None
        if to_be_preprocessed or is_base:
            # BASE's store is keyed by (threshold, k or -1), the others' by
            # param; BASE has no resumable store, so it always warms
            prep_key = (k if test_type == TestType.TOPK else -1) if is_base \
                else param
            # warm the prep path untimed (as the query warm-up below); a
            # store that fully resumes does no device work, so no warm-up
            if self.warmup and (is_base or algo._prep_pending(param)):
                algo.warm_preprocessing(threshold, prep_key)
            t0 = time.perf_counter()
            algo.preprocessing(threshold, prep_key, progress=self.progress)
            prep_ms = (time.perf_counter() - t0) * 1e3
            prep_bytes = algo.get_prep_size()

        def run_queries() -> tuple[np.ndarray, float]:
            """Returns (scores[B, n_pad], avg per-query ms)."""
            if to_be_preprocessed and not is_base:
                # preprocessed query path = store reads (Gen_Util.java:222-227)
                t0 = time.perf_counter()
                rows = []
                for i, s in enumerate(sources):
                    algo.read_preprocessed_ppr(int(s))
                    rows.append(algo.get_whole_graph_dense())
                    report(i)
                return np.stack(rows), (time.perf_counter() - t0) * 1e3 / query_num
            if self.batched:
                def run():
                    if test_type == TestType.TOPK:
                        return algo.compute_topk_batch(sources, k, param)
                    return algo.compute_whole_graph_batch(sources, param)

                if self.warmup:
                    run()
                t0 = time.perf_counter()
                scores = run()
                return np.asarray(scores), (
                    (time.perf_counter() - t0) * 1e3 / query_num
                )
            # reference protocol: one query at a time (Gen_Util.java:146-151)
            rows, total = [], 0.0
            for i, s in enumerate(sources):
                t0 = time.perf_counter()
                if test_type == TestType.TOPK:
                    algo.compute_topk_ppr(int(s), k, param)
                else:
                    algo.compute_whole_graph_ppr(int(s), param)
                total += time.perf_counter() - t0
                rows.append(algo.get_whole_graph_dense())
                report(i)
            return np.stack(rows), total * 1e3 / query_num

        scores, avg_ms = run_queries()

        result = PerfResult(
            algo=algo_type.value, test_type=test_type, param=param,
            avg_ms=avg_ms, prep_ms=prep_ms, prep_bytes=prep_bytes,
        )
        if test_type == TestType.TOPK:
            precs, ndcgs = [], []
            for row in range(query_num):
                gnd_ids = topk_ids_with_ties(oracle_rows[row], k)
                algo_ids = topk_ids_with_ties(scores[row], k)
                precs.append(precision_at_k(algo_ids, gnd_ids))
                ndcgs.append(ndcg_at_k(algo_ids, gnd_ids, oracle_rows[row]))
            result.avg_precision = float(np.mean(precs))
            result.avg_ndcg = float(np.mean(ndcgs))
        else:
            result.avg_max_err = float(np.mean([
                max_abs_err(scores[i], oracle_rows[i])
                for i in range(query_num)
            ]))

        self._write_row(result, k, threshold, to_be_preprocessed)
        if to_be_preprocessed and not is_base:
            algo.delete_prep_dir()  # Gen_Util.java:249-251
        return result

    def _write_row(self, res: PerfResult, k, threshold, to_be_preprocessed):
        """Row formats of Gen_Util.java:139-142/:179/:188-203/:244-247."""
        fields: list = [res.param]
        if res.test_type == TestType.TOPK:
            if res.prep_ms is not None:
                # BASE: [threshold, k, prep_ms, bytes, ms, precision, NDCG]
                fields = [threshold, k, f"{res.prep_ms:.3f}", res.prep_bytes]
            else:
                fields = [res.param, k]
            fields += [f"{res.avg_ms:.3f}", res.avg_precision, res.avg_ndcg]
        else:
            if res.prep_ms is not None:
                fields += [threshold, f"{res.prep_ms:.3f}", res.prep_bytes]
            if not to_be_preprocessed:
                fields += [f"{res.avg_ms:.3f}"]
            fields += [res.avg_max_err]
        self.writer.row(*fields)

    # --- batch test (algo_perf_batch_test parity, Gen_Util.java:328-646) ----
    def algo_perf_batch_test(self, query_num: int = 50, k: int = 10,
                             sweep: str | None = None,
                             tests: tuple = (1, 2, 3),
                             budget_s: float | None = None,
                             algos: set | None = None,
                             ) -> list[PerfResult]:
        """Run the three protocol tests. ``tests`` selects a subset;
        ``budget_s`` caps wall time per (algorithm, test) section — once a
        section exceeds it, the remaining sweep params are skipped with an
        explicit note row in the result file. The arrays transcribe the
        reference verbatim and are cheap-to-expensive in all but one case
        (amazon's prep FWDPUSH leads with its tightest rmax,
        Gen_Util.java:444), so truncation usually drops only the expensive
        tail — and never silently either way. ``algos`` (a set of
        AlgoType-value strings) restricts each test to those algorithms,
        keeping the reference's section numbering — for resuming a
        budget-cut sweep without repaying its completed sections. An
        entry may carry a start index, ``"MC:2"``: the section skips its
        first 2 params (with an explicit note row) — for banking the NEXT
        param of a sweep whose earlier params are already recorded (their
        stores are deleted after each test, Gen_Util.java:249-251, so a
        plain re-run would repay them in full)."""
        spec = SWEEPS.get(sweep or self.dataset.name) or SWEEPS["got"]
        self.writer.header()
        results = []

        starts: dict[str, int] = {}
        if algos is not None:
            names = set()
            for a in algos:
                name, _, idx = str(a).partition(":")
                names.add(name)
                if idx:
                    starts[name] = int(idx)
            algos = names
        if starts and len(tests) != 1:
            # a start index is per-SECTION state; applying it to every
            # selected test would silently drop unrecorded params from the
            # other tests' result sections
            raise ValueError(
                "--algos start indices (e.g. 'MC:2') require exactly one "
                "--tests selection; run each test's resume separately"
            )

        def selected(algo) -> bool:
            return algos is None or algo.value in algos

        def run_section(algo, params, runner):
            start = starts.get(algo.value, 0)
            if start:
                self.writer.section(
                    f"# first {start} param(s) skipped (already recorded): "
                    f"{list(params[:start])}"
                )
                params = params[start:]
            t0 = time.perf_counter()
            for j, param in enumerate(params):
                if budget_s is not None and j > 0 \
                        and time.perf_counter() - t0 > budget_s:
                    skipped = params[j:]
                    self.writer.section(
                        f"# remaining params skipped (budget "
                        f"{budget_s:.0f}s exceeded): {skipped}"
                    )
                    break
                results.append(runner(param))

        if 1 in tests:
            self.writer.section("Test 1. Whole-Graph test")
            for i, (algo, params) in enumerate(
                    spec["whole_graph"].items(), 1):
                if not selected(algo):
                    continue
                self.writer.section(f"1.{i} {algo.value}")
                run_section(algo, params, lambda p, a=algo: (
                    # BASE: the sweep value is the threshold, param is -1
                    self.algo_perf_test(a, query_num, -1, -1, p, False,
                                        TestType.WHOLE_GRAPH)
                    if a == AlgoType.BASE_WHOLE_GRAPH else
                    self.algo_perf_test(a, query_num, -1, p, -1.0, False,
                                        TestType.WHOLE_GRAPH)))

        if 2 in tests:
            self.writer.section("Test 2. Top-k test")
            for i, (algo, params) in enumerate(spec["topk"].items(), 1):
                if not selected(algo):
                    continue
                self.writer.section(f"2.{i} {algo.value}")
                run_section(algo, params, lambda p, a=algo: (
                    # BASE: the sweep value is the threshold, param is -1
                    self.algo_perf_test(a, query_num, k, -1, p, False,
                                        TestType.TOPK)
                    if a == AlgoType.BASE_WHOLE_GRAPH else
                    self.algo_perf_test(a, query_num, k, p, -1.0, False,
                                        TestType.TOPK)))

        if 3 in tests:
            prep_spec = spec.get("prep")
            if prep_spec is None:
                # custom/partial sweep specs may omit the preprocessing
                # section; falling back to the whole-graph arrays would burn
                # hours on big graphs for a test the spec doesn't define
                self.writer.section(
                    "# Test 3 skipped: no preprocessing sweep defined for "
                    "this dataset"
                )
                return results
            self.writer.section("Test 3. Preprocessing test")
            for i, (algo, params) in enumerate(prep_spec.items(), 1):
                if not selected(algo):
                    continue
                self.writer.section(f"3.{i} {algo.value}")
                run_section(algo, params, lambda p, a=algo: (
                    # BASE: the sweep value is the threshold, param is -1
                    self.algo_perf_test(a, query_num, -1, -1, p, True,
                                        TestType.WHOLE_GRAPH)
                    if a == AlgoType.BASE_WHOLE_GRAPH else
                    self.algo_perf_test(a, query_num, -1, p, -1.0, True,
                                        TestType.WHOLE_GRAPH)))
        return results
