"""BASE: all-pair backward-search preprocessing and the file-read query
path — port of ``ppr_tpu/models/base_allpair.py``.

Reference: Base_Whole_Graph.java — ``preprocessing`` (:58-165) runs
Backward_Search with ``rmax = threshold`` on every node as target (:76-92),
keeps only ``pi(v,t) >= threshold`` transposed into per-source rows, and
writes one file per source: the raw, target-ascending list for whole-graph
mode (k < 0, :120-132), or the top-k-with-ties list sorted descending for
top-k mode (:133-162). Queries are file reads (``computeWholeGraphPPR``
:167-186; ``getTopKNodeIds`` returns file order, :207-210).

Targets go in device batches of ``target_batch`` reverse pushes; the kept
entries are selected on the device (``ops/compact.threshold_nonzeros``),
grouped by source on the host, and written as the store's npz shards of
1024 sources each.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.compact import threshold_nonzeros
from ..ops.topk import topk_ids_with_ties
from ..utils.report import progress_printer
from ..utils.store import PPRStore
from .backward_search import BackwardSearch
from .base import PPRAlgorithm


class BaseAllPair(PPRAlgorithm):
    name = "BASE"
    prep_dirname = "BASE_ppr_results"

    def __init__(self, dataset, alpha: float, *, seed: int = 0,
                 target_batch: int = 512):
        super().__init__(dataset, alpha, seed=seed)
        self.target_batch = target_batch
        self._store: PPRStore | None = None
        self._threshold: float | None = None
        self._k: int | None = None
        self._last_order: list[np.ndarray] = []

    def _make_bws(self, threshold: float):
        """The reverse-push engine of a sweep at ``threshold``: the
        single-device :class:`BackwardSearch` here; the mesh variants
        (``parallel/sharded_allpair.py``, ``node_sharded_allpair.py``)
        override it."""
        return BackwardSearch(self.graph, self.alpha, threshold)

    # --- Preprocessing_Interface ------------------------------------------
    def make_store(self, threshold, k) -> PPRStore:
        root = os.path.join(self.prep_dirname, self.dataset.name,
                            f"{threshold}_{k}")
        # a mesh engine's store: one writer among the mesh's processes
        return PPRStore(root, n=self.graph.n_pad,
                        mesh=getattr(self, "mesh", None))

    def warm_preprocessing(self, threshold: float, k: int = -1) -> None:
        """Run one target batch through the reverse push and the device
        selection, and discard it (the harness calls this untimed)."""
        threshold = float(threshold)
        targets = np.arange(min(self.target_batch, self.graph.n))
        reserve = self._make_bws(threshold).whole_graph_device(targets)
        threshold_nonzeros(reserve, self.graph.node_mask, threshold,
                           rows=len(targets))

    def preprocessing(self, threshold: float, k: int = -1, *,
                      progress: bool = True) -> None:
        """Run the all-pair sweep and persist per-source rows."""
        threshold = float(threshold)
        k = int(k)
        n = self.graph.n
        bws = self._make_bws(threshold)
        report = progress_printer(n, enabled=progress)

        # pi(s, t) >= threshold as COO triplets, selected on the device so
        # only the kept entries cross to the host
        v_parts, t_parts, val_parts = [], [], []
        for start in range(0, n, self.target_batch):
            targets = np.arange(start, min(start + self.target_batch, n))
            reserve = bws.whole_graph_device(targets)   # [T, n_pad]
            keep_t, keep_v, vals = threshold_nonzeros(
                reserve, self.graph.node_mask, threshold, rows=len(targets))
            v_parts.append(keep_v)
            t_parts.append(targets[keep_t])
            val_parts.append(vals)
            report(min(start + self.target_batch, n) - 1)

        v_all = np.concatenate(v_parts) if v_parts else np.zeros(0, np.int64)
        t_all = np.concatenate(t_parts) if t_parts else np.zeros(0, np.int64)
        val_all = (np.concatenate(val_parts) if val_parts
                   else np.zeros(0, np.float32))
        # group by source; the stable sort keeps targets ascending within a
        # source (the reference's insertion order over ascending targets)
        order = np.argsort(v_all, kind="stable")
        v_all, t_all, val_all = v_all[order], t_all[order], val_all[order]
        row_ptr = np.searchsorted(v_all, np.arange(n + 1))

        store = self.make_store(threshold, k)
        store.reset()
        shard = 0
        ids_list, vals_list, sources = [], [], []
        for s in range(n):
            lo, hi = row_ptr[s], row_ptr[s + 1]
            ids = t_all[lo:hi].astype(np.int32)
            vals = val_all[lo:hi].astype(np.float32)
            if k >= 0 and ids.size:
                dense = np.zeros(self.graph.n_pad, np.float32)
                dense[ids] = vals
                chosen = topk_ids_with_ties(dense, k)
                ids, vals = chosen.astype(np.int32), dense[chosen]
            sources.append(s)
            ids_list.append(ids)
            vals_list.append(vals)
            if len(sources) == 1024 or s == n - 1:
                store.write_batch_ordered(shard, np.asarray(sources),
                                          ids_list, vals_list)
                shard += 1024
                ids_list, vals_list, sources = [], [], []
        store.finalize(threshold=threshold, k=k, alpha=self.alpha)
        self._store, self._threshold, self._k = store, threshold, k

    def attach_store(self, threshold: float, k: int = -1, *,
                     alpha: float | None = None) -> None:
        """Attach a store persisted earlier, to answer queries from it. The
        store's path encodes only (threshold, k); its manifest records the
        alpha it was computed under, and a mismatch with ``alpha`` (default:
        this instance's) raises."""
        store = self.make_store(float(threshold), int(k))
        if not os.path.exists(os.path.join(store.root, "manifest.json")):
            raise FileNotFoundError(
                f"no finalized BASE store at {store.root}; run "
                f"preprocessing({threshold}, {k}) first"
            )
        want_alpha = self.alpha if alpha is None else float(alpha)
        stored_alpha = store._read_manifest().get("alpha")
        if stored_alpha is not None and abs(stored_alpha - want_alpha) > 1e-12:
            raise ValueError(
                f"store at {store.root} was preprocessed with "
                f"alpha={stored_alpha}, not {want_alpha}"
            )
        self._store = store
        self._threshold, self._k = float(threshold), int(k)

    # --- query path (file reads, like the reference) ----------------------
    def compute_whole_graph_batch(self, sources: np.ndarray, param=None
                                  ) -> np.ndarray:
        if self._store is None:
            raise RuntimeError("BASE requires preprocessing() before queries")
        out = np.zeros((len(sources), self.graph.n_pad), np.float32)
        self._last_order = []
        for i, s in enumerate(sources):
            ids, vals = self._store.read_row_ordered(int(s))
            out[i, ids] = vals
            self._last_order.append(ids)
        return out

    def get_topk_node_ids(self, k: int) -> np.ndarray:
        """File order, as Base_Whole_Graph.getTopKNodeIds (:207-210)."""
        if self._last_order:
            return np.asarray(self._last_order[-1], np.int64)
        return super().get_topk_node_ids(k)

    def compute_whole_graph_ppr(self, source: int, param=None) -> None:
        batch = self.compute_whole_graph_batch(np.asarray([source]), param)
        self._last_scores = batch[0]
        self._last_topk_scores = None

    def compute_topk_ppr(self, source: int, k: int, param=None) -> None:
        self.compute_whole_graph_ppr(source, param)

    def read_preprocessed_ppr(self, source: int) -> None:
        self.compute_whole_graph_ppr(source)

    def get_prep_size(self) -> int:
        return self._store.size_bytes() if self._store else 0

    def delete_prep_dir(self) -> None:
        if self._store:
            self._store.delete()
