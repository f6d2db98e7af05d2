"""Progress and result-file reporting — a copy of
``ppr_tpu/utils/report.py``, so the two packages write the same rows.

* :func:`progress_printer` — the 10%-increment progress lines the reference
  precomputes into ``prog_pct_map`` (Gen_Util.java:117-122, and the same
  pattern inside every preprocessing loop, e.g. Monte_Carlo.java:186-191).
* :class:`PerfResultWriter` — the append-only
  ``<dataset>_AlgoPerfResults.txt`` report with a timestamp header and
  comma-separated rows (Gen_Util.java:505-510, row formats at :139-142,
  :179, :188-203, :244-247).
"""

from __future__ import annotations

import datetime
import os


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
