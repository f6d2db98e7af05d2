"""PPR retrieval service — port of ``ppr_tpu/service.py`` for one device.

    svc = PPRService.from_dataset(load_default(), alpha=0.15, hub_split=64)
    hits = svc.top_k([3, 14, 50], k=10)      # per source: [TopKHit, ...]

Top-k queries run FORA top-k with device-side selection: the annealed
propagation loop, or push+walk rounds where FORA's cost model prices walks
lower; :meth:`PPRService.whole_graph` runs FORA whole-graph.
``hub_split=H`` builds the dense-hub hybrid push once, with a bf16 hub
product unless ``hub_dtype`` says otherwise, and both algorithms use it
(``hub_split="auto"``: the automatic count, or no split where no node
passes its threshold, ``ops/hub_split.py::resolve_hub_split``);
``calibrate=True`` measures the cost constants on the graph once and gives
them to both. ``early_exit=True`` stops the annealed loop once every row's
top-k set is certified final; ``cohort=True`` adds
:meth:`PPRService.top_k_stream`, which hands back rows as they retire;
``precomputed=(threshold, k)`` answers every query from a BASE all-pair
store made earlier. On a weighted graph ``hub_split`` raises
``ValueError``, as in the JAX package: the hybrid push covers uniform
``1/d`` edges only.

``mesh=`` (a :class:`~.parallel.mesh.Mesh`) serves top-k from a mesh
engine: ``mesh_engine="edge"`` (:class:`~.parallel.sharded_fora.
ShardedForaTopk`, the edges split over ``graph``, node state replicated)
or ``"node"`` (:class:`~.parallel.node_sharded_fora.NodeShardedForaTopk`,
O(n/S) state a shard, with ``frontier_blocks=C`` its frontier-compacted
ring); :meth:`PPRService.whole_graph` stays on the dataset's device. A
mesh across processes (``parallel/distributed.py::global_mesh``) is
taken too: every rank builds the service with the same arguments, makes
the same calls, and gets the same hits.

While a ``torch.profiler`` session runs, :meth:`PPRService.top_k` records
the span ``service.top_k`` (``rows``), and in it the engine's
``loop.topk``, ``service.hits`` (the hit lists from the device's window)
and ``service.recompute`` (``rows``: the dense recompute of rows whose
ties overflow the window); ``utils/timer.py`` keeps them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .graph.io import Dataset
from .models import AlgoConf, AlgoType
from .ops.hub_split import resolve_hub_split
from .ops.topk import topk_ids_with_ties
from .utils import calibrate as calibrate_mod
from .utils import timer


@dataclasses.dataclass
class TopKHit:
    node: int
    score: float
    name: str


class PPRService:
    def __init__(self, dataset: Dataset, alpha: float = 0.15, *,
                 eps: float = 0.5, k: int = 10, seed: int = 0,
                 algorithm: AlgoType = AlgoType.FORA_TOPK,
                 hub_split: int | str | None = None, hub_dtype=None,
                 calibrate: bool = False, mesh=None,
                 precomputed: tuple | None = None,
                 early_exit: bool = False, mesh_engine: str = "edge",
                 cohort: bool = False, frontier_blocks: int | None = None):
        """``precomputed=(threshold, k)`` (or a bare threshold, ``k = -1``)
        serves every query from an existing BASE store, the reference's
        BASE query mode (Base_Whole_Graph.java:167-186): pure store reads.
        ``mesh`` runs the FORA top-k serving path on a mesh engine,
        ``mesh_engine`` picks it ("edge" or "node"), and
        ``frontier_blocks`` compacts the node engine's ring; all three are
        validated as in the JAX package."""
        self.dataset = dataset
        self.eps = eps
        self.k = k
        self._cohort = bool(cohort)
        conf = AlgoConf(alpha, seed=seed)
        if precomputed is not None:
            conflicts = [name for name, v in (
                ("mesh", mesh), ("hub_split", hub_split),
                ("calibrate", calibrate or None),
                ("cohort", cohort or None),
                ("frontier_blocks", frontier_blocks),
            ) if v is not None] + (
                ["algorithm"] if algorithm != AlgoType.FORA_TOPK else []
            )
            if conflicts:
                raise ValueError(
                    f"precomputed= serves pure BASE store reads; "
                    f"{', '.join(conflicts)} would be silently ignored — "
                    f"drop them or drop precomputed"
                )
            thr, pk = (precomputed if isinstance(precomputed, (tuple, list))
                       else (precomputed, -1))
            base = conf.new_algo_obj(AlgoType.BASE_WHOLE_GRAPH, dataset, k)
            base.attach_store(thr, pk, alpha=alpha)
            self._topk_algo = self._wg_algo = base
            return
        if frontier_blocks is not None and (
                mesh is None or mesh_engine != "node"):
            raise ValueError(
                "frontier_blocks requires mesh= and mesh_engine='node' "
                "(the ring-exchange engine); drop it or switch engines"
            )
        if mesh is not None and algorithm == AlgoType.FORA_TOPK:
            if mesh_engine == "node":
                from .parallel.node_sharded_fora import NodeShardedForaTopk

                self._topk_algo = NodeShardedForaTopk(
                    dataset, alpha=alpha, k=k, mesh=mesh,
                    frontier_blocks=frontier_blocks,
                )
            elif mesh_engine == "edge":
                from .parallel.sharded_fora import ShardedForaTopk

                self._topk_algo = ShardedForaTopk(dataset, alpha=alpha, k=k,
                                                  mesh=mesh)
            else:
                raise ValueError(
                    f"mesh_engine must be 'edge' or 'node', got "
                    f"{mesh_engine!r}"
                )
        else:
            self._topk_algo = conf.new_algo_obj(algorithm, dataset, k)
        what = "the mesh engines" if mesh is not None else str(algorithm)
        if early_exit:
            if not hasattr(self._topk_algo, "early_exit"):
                raise ValueError(
                    f"early_exit is only supported by the single-device "
                    f"FORA top-k serving engine, not {what}"
                )
            self._topk_algo.early_exit = True
        if cohort and not hasattr(self._topk_algo, "compute_topk_ids_cohorts"):
            raise ValueError(
                f"cohort streaming is only supported by the single-device "
                f"FORA top-k serving engine, not {what}"
            )
        self._wg_algo = conf.new_algo_obj(
            AlgoType.FORA_WHOLE_GRAPH
            if algorithm == AlgoType.FORA_TOPK else algorithm,
            dataset, k,
        )
        if hub_split and dataset.graph.weighted:
            # loud, as in the JAX package: the hybrid push has no weighted
            # variant (ops/hub_split.py)
            raise ValueError(
                "hub_split= is unsupported on weighted graphs (the dense-hub "
                "hybrid SpMV only covers uniform 1/d edge weights) — drop "
                "hub_split or load the graph unweighted"
            )
        algos = [a for a in (self._topk_algo, self._wg_algo)
                 if hasattr(a, "enable_hub_split")]
        if hub_split and algos:
            # built once and shared: the hub matrix can be gigabytes
            hs = resolve_hub_split(
                dataset.graph, hub_split,
                dtype=hub_dtype if hub_dtype is not None else torch.bfloat16,
            )
            for algo in algos:
                algo.hub_split = hs
        if calibrate and algos:
            # one measurement (same device and graph) for both
            constants = algos[0].calibrate()
            for algo in algos[1:]:
                calibrate_mod.apply(algo, constants)

    @classmethod
    def from_dataset(cls, dataset: Dataset, **kwargs) -> "PPRService":
        return cls(dataset, **kwargs)

    def top_k(self, sources, k: int | None = None,
              eps: float | None = None) -> list[list[TopKHit]]:
        """Batched top-k PPR; per source a descending list of hits (ties
        beyond k included, reference semantics)."""
        k = k or self.k
        sources = np.asarray(sources)
        eps = eps or self.eps
        algo = self._topk_algo
        with timer.span("service.top_k", rows=len(sources)):
            if hasattr(algo, "compute_topk_ids_batch"):
                vals, ids = algo.compute_topk_ids_batch(sources, k, eps)
                return self._hits_from_ids(vals, ids, k, sources, eps)
            scores = algo.compute_topk_batch(sources, k, eps)
            return [self._hits_dense(row, k) for row in np.asarray(scores)]

    def _hits_dense(self, row: np.ndarray, k: int) -> list[TopKHit]:
        return [TopKHit(int(v), float(row[v]), self.dataset.names[int(v)])
                for v in topk_ids_with_ties(row, k)]

    def _hits_from_ids(self, vals, ids, k: int, sources: np.ndarray,
                       eps: float) -> list[list[TopKHit]]:
        """Device-selected (vals, ids) windows ``[B, K]``, each row
        descending -> per-row hit lists with reference tie semantics; rows
        whose tie set may overflow the selection window are recomputed
        densely.

        One pass over the whole window: a row keeps its positive entries
        and, where ``K > k``, those at or above its k-th (the positives are
        a prefix of a descending row, so ``vals[:, k - 1]`` is the k-th
        positive wherever more than k are positive); a row that keeps its
        whole window may have ties beyond it. Only the kept entries leave
        numpy. While profiled, the counters ``service.hits_built`` (hits
        built from the window) and ``service.tie_rows`` (rows whose list
        runs past k on ties) add up what the call did."""
        b_rows, width = vals.shape
        names = self.dataset.names
        with timer.span("service.hits"):
            keep = vals > 0.0
            if width > k:
                keep &= vals >= vals[:, k - 1:k]
            dense = keep.all(1) if width else np.zeros(b_rows, bool)
            dense_rows = np.flatnonzero(dense).tolist()
            if dense_rows:
                keep[dense_rows] = False
            node = ids[keep].tolist()
            hits = list(map(TopKHit, node, vals[keep].tolist(),
                            [names[n] for n in node]))
            cnt = keep.sum(1)
            ends = np.cumsum(cnt).tolist()
            out = [hits[a:b] for a, b in zip([0] + ends[:-1], ends)]
        if timer.recording():
            timer.count("service.hits_built", len(hits))
            timer.count("service.tie_rows", int((cnt > k).sum()))
        if dense_rows:
            with timer.span("service.recompute", rows=len(dense_rows)):
                scores = self._topk_algo.compute_topk_batch(
                    sources[dense_rows], k, eps)
                for b, row in zip(dense_rows, np.asarray(scores)):
                    out[b] = self._hits_dense(row, k)
        return out

    @property
    def n_nodes(self) -> int:
        """Graph node count: the serving layer spreads its prewarm sources
        over real nodes instead of sending W copies of one source."""
        return int(self.dataset.graph.n)

    @property
    def supports_stream(self) -> bool:
        """True when :meth:`top_k_stream` is usable (``cohort=True`` and an
        engine with the cohort path)."""
        return self._cohort and hasattr(
            self._topk_algo, "compute_topk_ids_cohorts"
        )

    def top_k_stream(self, sources, k: int | None = None,
                     eps: float | None = None, *, emit) -> None:
        """Streaming top-k: calls ``emit(orig_indices, hits_rows)`` as row
        cohorts retire, so a fast row's answer does not wait for the
        slowest row of the batch (``ForaTopk.compute_topk_ids_cohorts``).
        Requires ``cohort=True``."""
        if not self.supports_stream:
            raise RuntimeError(
                "top_k_stream requires PPRService(cohort=True) with the "
                "single-device FORA top-k engine"
            )
        k = k or self.k
        eps_v = eps or self.eps
        sources = np.asarray(sources)
        for idxs, vals, ids in self._topk_algo.compute_topk_ids_cohorts(
                sources, k, eps_v):
            emit(idxs, self._hits_from_ids(vals, ids, k, sources[idxs],
                                           eps_v))

    def whole_graph(self, sources, eps: float | None = None) -> np.ndarray:
        """Dense PPR rows ``[B, n]`` (padding trimmed)."""
        sources = np.asarray(sources)
        scores = self._wg_algo.compute_whole_graph_batch(
            sources, eps or self.eps
        )
        return np.asarray(scores)[:, : self.dataset.n]
