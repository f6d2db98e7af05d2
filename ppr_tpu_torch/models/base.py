"""Algorithm base classes — port of ``PPRAlgorithm`` and
``PreprocessingMixin`` from ``ppr_tpu/models/base.py``.

The native query unit is a batch of sources: algorithms implement
``compute_whole_graph_batch`` / ``compute_topk_batch`` returning dense
``[B, n_pad]`` host arrays, and the reference's single-query methods
(Whole_Graph_Util_Interface.java, Topk_Util_Interface.java) are thin
adapters over a batch of one. Randomness comes from one ``torch.Generator``
per algorithm, seeded once, on the graph's device.

:class:`PreprocessingMixin` is the reference's Preprocessing_Interface
(Preprocessing_Interface.java:3-16) over :class:`~..utils.store.PPRStore`.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..graph.io import Dataset
from ..ops.compact import threshold_nonzeros
from ..ops.topk import topk_ids_with_ties
from ..utils.report import progress_printer
from ..utils.store import PPRStore


class PPRAlgorithm:
    """Shared state: dataset handle, alpha, seeded generator, last results."""

    name = "ppr"

    def __init__(self, dataset: Dataset, alpha: float, *, seed: int = 0):
        self.dataset = dataset
        self.graph = dataset.graph
        self.alpha = float(alpha)
        self.generator = torch.Generator(device=self.graph.device)
        self.generator.manual_seed(seed)
        self._last_scores: np.ndarray | None = None   # [n_pad]
        self._last_topk_scores: np.ndarray | None = None

    # --- batched API -----------------------------------------------------
    def compute_whole_graph_batch(self, sources: np.ndarray, param
                                  ) -> np.ndarray:
        raise NotImplementedError

    def compute_topk_batch(self, sources: np.ndarray, k: int, param
                           ) -> np.ndarray:
        """Default: whole-graph scores; top-k is a selection over them."""
        return self.compute_whole_graph_batch(sources, param)

    # --- Whole_Graph_Util_Interface --------------------------------------
    def compute_whole_graph_ppr(self, source: int, param) -> None:
        batch = self.compute_whole_graph_batch(np.asarray([source]), param)
        self._last_scores = np.asarray(batch[0])
        self._last_topk_scores = None

    def get_whole_graph_ppr(self) -> dict[int, float]:
        scores = self._require(self._last_scores)
        support = np.nonzero(scores > 0.0)[0]
        return {int(v): float(scores[v]) for v in support}

    def get_whole_graph_dense(self) -> np.ndarray:
        return self._require(self._last_scores)

    def print_whole_graph_result(self) -> None:
        scores = self._require(self._last_scores)
        order = topk_ids_with_ties(scores, scores.size)
        print(f"{self.name} PPR:")
        for v in order:
            print(f"@{self.dataset.names[int(v)]}\t{scores[int(v)]}")

    # --- Topk_Util_Interface ---------------------------------------------
    def compute_topk_ppr(self, source: int, k: int, param) -> None:
        batch = self.compute_topk_batch(np.asarray([source]), k, param)
        self._last_topk_scores = np.asarray(batch[0])
        self._last_scores = self._last_topk_scores

    def get_topk_node_ids(self, k: int) -> np.ndarray:
        scores = self._require(
            self._last_topk_scores if self._last_topk_scores is not None
            else self._last_scores
        )
        return topk_ids_with_ties(scores, k)

    def print_topk_result(self, k: int) -> None:
        ids = self.get_topk_node_ids(k)[:k]
        scores = self._require(self._last_scores)
        print(f"\n{self.name}-Top{k} PPR:")
        for v in ids:
            print(f"@{self.dataset.names[int(v)]}\t{scores[int(v)]}")

    @staticmethod
    def _require(arr):
        if arr is None:
            raise RuntimeError("no PPR computed yet")
        return arr


class PreprocessingMixin:
    """Preprocessing_Interface backed by :class:`~..utils.store.PPRStore`.

    The reference runs the whole-graph algorithm on every node in turn and
    writes one text file per source (e.g. Monte_Carlo.java:181-232). Here
    sources go in device batches: each batch's scores stay on the device
    (``compute_whole_graph_device``), their positive entries are selected
    there (``ops/compact.threshold_nonzeros``), and the batch lands as one
    npz shard of the store, which resumes from its last complete shard.
    """

    prep_dirname: str = "PREP_ppr_results"
    _store: PPRStore | None = None

    def make_store(self, param) -> PPRStore:
        root = os.path.join(self.prep_dirname, self.dataset.name, str(param))
        # a mesh engine's store: one writer among the mesh's processes
        return PPRStore(root, n=self.graph.n_pad,
                        mesh=getattr(self, "mesh", None))

    #: True while ``preprocessing`` or its warm-up runs: FORA's cost model
    #: then prices the transfer of each row's entries to the host
    _in_preprocessing = False

    def _prep_batch(self, param, batch_size: int = 128) -> int:
        """The source-batch height the sweep uses. Algorithms with a walker
        budget a call clamp it (``MonteCarlo``); the warm-up and the resume
        check use the same height."""
        return batch_size

    def _prep_pending(self, param, batch_size: int = 128) -> bool:
        """True when ``preprocessing(param)`` would do device work: the
        store is finalized (a new run starts from scratch) or a batch shard
        is missing."""
        store = self.make_store(param)
        if store._read_manifest().get("finalized"):
            return True
        bs = self._prep_batch(param, batch_size)
        return any(not store.has_batch(s) for s in range(0, self.graph.n, bs))

    def preprocessing(self, threshold, param, *, batch_size: int = 128,
                      progress: bool = True) -> None:
        batch_size = self._prep_batch(param, batch_size)
        store = self.make_store(param)
        store.reset()
        report = progress_printer(self.graph.n, enabled=progress)
        self._in_preprocessing = True
        try:
            self._preprocessing_sweep(store, param, batch_size, report)
        finally:
            self._in_preprocessing = False
        store.finalize(alpha=self.alpha)
        self._store = store

    def _compact_batch(self, sources: np.ndarray, param):
        """Positive entries of one batch: ``(rows, cols, vals)`` host arrays
        in row-major order (strict ``> 0``, the store's keep rule)."""
        return threshold_nonzeros(
            self.compute_whole_graph_device(sources, param),
            self.graph.node_mask, 0.0, rows=len(sources), exclusive=True,
        )

    def _preprocessing_sweep(self, store: PPRStore, param, batch_size: int,
                             report) -> None:
        n = self.graph.n
        for start in range(0, n, batch_size):
            if store.has_batch(start):
                continue
            sources = np.arange(start, min(start + batch_size, n))
            rows, cols, vals = self._compact_batch(sources, param)
            ptr = np.concatenate(
                [[0], np.cumsum(np.bincount(rows, minlength=len(sources)))])
            store.write_batch_ordered(
                start, sources,
                [cols[ptr[i]:ptr[i + 1]].astype(np.int32)
                 for i in range(len(sources))],
                [vals[ptr[i]:ptr[i + 1]] for i in range(len(sources))],
            )
            report(min(start + batch_size, n) - 1)

    def warm_preprocessing(self, threshold, param, *,
                           batch_size: int = 128) -> None:
        """Run one source batch through the path ``preprocessing`` times and
        discard it (the harness calls this untimed, as it warms queries):
        the first launch builds the kernels and fills the allocator."""
        n = min(self._prep_batch(param, batch_size), self.graph.n)
        self._in_preprocessing = True
        try:
            self._compact_batch(np.arange(n), param)
        finally:
            self._in_preprocessing = False

    def attach_store(self, param) -> None:
        """Attach a store persisted earlier, to answer queries from it."""
        self._store = self.make_store(param)

    def read_preprocessed_ppr(self, source: int, param=None) -> None:
        if self._store is None:
            if param is None:
                raise RuntimeError(
                    "no store attached: run preprocessing() or "
                    "attach_store(param) first"
                )
            self.attach_store(param)
        self._last_scores = self._store.read_row(int(source))
        self._last_topk_scores = None

    def get_prep_size(self) -> int:
        return self._store.size_bytes() if self._store else 0

    def delete_prep_dir(self) -> None:
        if self._store:
            self._store.delete()
