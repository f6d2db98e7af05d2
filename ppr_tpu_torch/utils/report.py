"""Progress and result-file reporting — a copy of
``ppr_tpu/utils/report.py``, so the two packages write the same rows.

* :func:`progress_printer` — the 10%-increment progress lines the reference
  precomputes into ``prog_pct_map`` (Gen_Util.java:117-122, and the same
  pattern inside every preprocessing loop, e.g. Monte_Carlo.java:186-191).
* :class:`PerfResultWriter` — the append-only
  ``<dataset>_AlgoPerfResults.txt`` report with a timestamp header and
  comma-separated rows (Gen_Util.java:505-510, row formats at :139-142,
  :179, :188-203, :244-247).
* :func:`read_protocol_rows` — the one reader of that format: the rows of
  every block with their draw indices, and :func:`row_failures`, the bars
  a row is held to (``chip_smoke.py`` and ``protocol_grid_torch.py`` read
  and judge reports through them).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import re


def progress_printer(total: int, *, enabled: bool = True):
    """Returns callback(idx) printing 'Progress: P%' at 10% increments.

    Any threshold *crossed* by ``idx`` fires (batched loops report only
    batch-end indices, so exact matches would skip most marks)."""
    marks = sorted(
        {max(0, total * p // 100): p for p in range(10, 100, 10)}.items()
    ) + [(max(total - 1, 0), 100)]
    state = {"next": 0}

    def report(idx: int) -> None:
        if not enabled:
            return
        while state["next"] < len(marks) and idx >= marks[state["next"]][0]:
            print(f"Progress: {marks[state['next']][1]}%")
            state["next"] += 1

    return report


class PerfResultWriter:
    def __init__(self, dataset_name: str, out_dir: str = ".", *,
                 enabled: bool = True):
        """``enabled=False`` writes nothing: the ranks of a mesh across
        processes other than rank 0."""
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, f"{dataset_name}_AlgoPerfResults.txt")
        self.enabled = enabled

    def _append(self, text: str) -> None:
        if not self.enabled:
            return
        with open(self.path, "a") as f:
            f.write(text)

    def header(self) -> None:
        stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M:%S")
        self._append(stamp + "\n")

    def section(self, title: str) -> None:
        self._append(f"\n{title}\n")

    def row(self, *fields) -> None:
        self._append(",".join(str(f) for f in fields) + "\n")


# --- reading the report back ----------------------------------------------
_STAMP = re.compile(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d")
_SECTION = re.compile(r"(\d)\.\d+ (\w+)")


@dataclasses.dataclass
class ProtocolRow:
    """One data row of a ``<dataset>_AlgoPerfResults.txt``.

    ``draw`` is the row's draw index: the rows before it in its block. The
    harness draws one query set a row it runs and none for a skipped param
    (``--algos X:N``, the budget), so a row's sources are the ``draw``-th
    set of its invocation's generator."""

    block: str          # the invocation's timestamp line
    test: int
    algo: str
    fields: list[str]
    draw: int

    @property
    def param(self) -> str:
        """The sweep value: BASE's Tests 1 and 3 rows lead with ``-1`` and
        carry the threshold second."""
        if self.algo == "BASE_WHOLE_GRAPH" and self.test != 2:
            return self.fields[1]
        return self.fields[0]

    @property
    def accuracy(self) -> float:
        """Max-err for Tests 1 and 3, precision for Test 2."""
        return float(self.fields[-2 if self.test == 2 else -1])

    @property
    def prep(self) -> tuple[float, int] | None:
        """``(prep_ms, store bytes)`` of a preprocessed row: the third and
        fourth fields wherever they appear (Test 3, and BASE's rows)."""
        if self.test == 3 or self.algo == "BASE_WHOLE_GRAPH":
            return float(self.fields[2]), int(self.fields[3])
        return None

    @property
    def query_ms(self) -> float | None:
        """ms a query (Tests 1 and 2; a Test 3 row times only its prep)."""
        if self.test == 3:
            return None
        return float(self.fields[-3 if self.test == 2 else -2])

    @property
    def ndcg(self) -> float | None:
        """NDCG of a Test 2 row (its last field)."""
        return float(self.fields[-1]) if self.test == 2 else None

    def summary(self) -> str:
        """``test T ALGO param P: [prep_ms, store bytes,] [ms/query,]
        accuracy`` for a log line."""
        prep = self.prep
        out = f"test {self.test} {self.algo} param {self.param}: "
        if prep is not None:
            out += f"prep_ms {prep[0]:.1f}, store {prep[1]} bytes, "
        if self.query_ms is not None:
            out += f"{self.query_ms:.3f} ms/query, "
        if self.test == 2:
            return out + f"precision {self.accuracy:.4f}, NDCG {self.ndcg:.6f}"
        return out + f"max-err {self.accuracy:.3e}"


def read_protocol_rows(text: str) -> list[ProtocolRow]:
    """Every data row of a report's text, in file order, with its block and
    draw index. A timestamp line opens a block (one invocation's
    ``header``); a ``T.i ALGO`` line opens a section; note rows (``#``)
    are skipped."""
    out: list[ProtocolRow] = []
    block, key, draws = "", None, 0
    for line in text.splitlines():
        if _STAMP.fullmatch(line):
            block, key, draws = line, None, 0
            continue
        m = _SECTION.fullmatch(line)
        if m:
            key = (int(m[1]), m[2])
        elif key and "," in line and not line.startswith("#"):
            out.append(ProtocolRow(block, key[0], key[1], line.split(","),
                                   draws))
            draws += 1
    return out


def read_protocol_file(path: str) -> list[ProtocolRow]:
    """:func:`read_protocol_rows` of the report at ``path``."""
    with open(path) as f:
        return read_protocol_rows(f.read())


# --- the bars a row is held to (PERF.md section 2) ---------------------------
#: the walk paths: held by distribution, as the packages draw different
#: walks (threefry against Philox) and each cost model sets its own push
#: rounds
WALK_ALGOS = ("MC", "FORA_WHOLE_GRAPH", "FORA_TOPK")


@dataclasses.dataclass(frozen=True)
class Bar:
    """A row's bar against its reference row's accuracy ``want``: ``abs``
    (``|got - want| <= limit``), ``max`` (``got <= limit``) or ``min``
    (``got >= limit``)."""

    kind: str
    limit: float
    text: str

    def holds(self, got: float, want: float) -> bool:
        if self.kind == "abs":
            return abs(got - want) <= self.limit
        return got <= self.limit if self.kind == "max" else got >= self.limit


def reference_bar(test: int, algo: str, want: float) -> Bar:
    """The bar of a row of ``test`` and ``algo`` against the JAX package's
    row of the same command and draw, whose accuracy is ``want`` (max-err
    for Tests 1 and 3, precision for Test 2). The walk paths are held by
    distribution, the deterministic ones to the reference's digits: BASE's
    error is its ``pi >= threshold`` cut, not rounding, and 0.002 of
    precision is one id of 500."""
    if algo in WALK_ALGOS:
        if test == 2:
            return Bar("min", want - 0.05, "precision >= ref - 0.05")
        return Bar("max", 1.5 * want + 1e-4, "max-err <= 1.5 x ref + 1e-4")
    if test == 2:
        return Bar("abs", 0.002, "|precision - ref| <= 0.002")
    if algo == "BASE_WHOLE_GRAPH":
        return Bar("abs", 1e-3, "|max-err - ref| <= 1e-3")
    return Bar("abs", 0.01 * want + 1e-7, "|max-err - ref| <= 1% ref + 1e-7")


def own_bar(row: ProtocolRow) -> str | None:
    """The Neo4j method's bars on its own: max-err <= 1e-6 from 100
    iterations; precision 1.0 and NDCG >= 0.999 from 40. A failure text,
    or None."""
    if row.algo != "NEO4J_METHOD":
        return None
    iters, got = float(row.param), row.accuracy
    if row.test != 2 and iters >= 100 and got > 1e-6:
        return f"max-err {got} > 1e-6 at {row.param} iterations"
    if row.test == 2 and iters >= 40 and not (got == 1.0
                                              and row.ndcg >= 0.999):
        return (f"precision {got}, NDCG {row.ndcg} at {row.param} "
                f"iterations (1.0 and >= 0.999)")
    return None


def row_failures(row: ProtocolRow, want: float | None = None) -> list[str]:
    """Why ``row`` misses its bars: a number not finite, an empty store,
    the Neo4j method's own bars, and, given its reference row's accuracy
    ``want``, :func:`reference_bar`. Empty when the row holds."""
    out = []
    if not all(math.isfinite(float(x)) for x in row.fields):
        out.append(f"not finite: {row.fields}")
    if row.prep is not None and row.prep[1] <= 0:
        out.append(f"empty store: {row.fields}")
    own = own_bar(row)
    if own is not None:
        out.append(own)
    if want is not None:
        bar = reference_bar(row.test, row.algo, want)
        if not bar.holds(row.accuracy, want):
            out.append(f"{row.accuracy} against the reference's {want} "
                       f"({bar.text})")
    return out
