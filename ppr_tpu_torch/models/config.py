"""Algorithm configuration / factory — port of ``ppr_tpu/models/config.py``
(Algo_Conf.java and the newAlgoObj switch of Gen_Util.java:66-97) for the
algorithms ported so far: FORA top-k, the power method, the Neo4j method,
Forward Push and BASE. Monte-Carlo and FORA whole-graph raise until their
slice lands (ROADMAP.md, queue 1)."""

from __future__ import annotations

import dataclasses
import enum

from ..graph.io import Dataset
from .base_allpair import BaseAllPair
from .fora import ForaTopk
from .forward_push import ForwardPush
from .neo4j_method import Neo4jMethod
from .power_method import PowerMethod


class AlgoType(enum.Enum):
    """Gen_Util.AlgoType (Gen_Util.java:46-54)."""

    MC = "MC"
    FWDPUSH = "FWDPUSH"
    FORA_WHOLE_GRAPH = "FORA_WHOLE_GRAPH"
    FORA_TOPK = "FORA_TOPK"
    POWER_METHOD = "POWER_METHOD"
    BASE_WHOLE_GRAPH = "BASE_WHOLE_GRAPH"
    NEO4J_METHOD = "NEO4J_METHOD"


@dataclasses.dataclass
class AlgoConf:
    alpha: float
    seed: int = 0

    def set_conf_power_method(self, dataset: Dataset) -> PowerMethod:
        return PowerMethod(dataset, self.alpha, seed=self.seed)

    def set_conf_fwdpush(self, dataset: Dataset) -> ForwardPush:
        return ForwardPush(dataset, self.alpha, seed=self.seed)

    def set_conf_fora_topk(self, dataset: Dataset, k: int) -> ForaTopk:
        return ForaTopk(dataset, self.alpha, k=k, seed=self.seed)

    def set_conf_base_whole_graph(self, dataset: Dataset) -> BaseAllPair:
        return BaseAllPair(dataset, self.alpha, seed=self.seed)

    def set_conf_neo4j_method(self, dataset: Dataset) -> Neo4jMethod:
        return Neo4jMethod(dataset, self.alpha, seed=self.seed)

    def new_algo_obj(self, algo: AlgoType, dataset: Dataset, k: int = -1):
        """The newAlgoObj factory switch (Gen_Util.java:66-97)."""
        match algo:
            case AlgoType.POWER_METHOD:
                return self.set_conf_power_method(dataset)
            case AlgoType.BASE_WHOLE_GRAPH:
                return self.set_conf_base_whole_graph(dataset)
            case AlgoType.FWDPUSH:
                return self.set_conf_fwdpush(dataset)
            case AlgoType.NEO4J_METHOD:
                return self.set_conf_neo4j_method(dataset)
            case AlgoType.FORA_TOPK:
                return self.set_conf_fora_topk(dataset, k)
            case AlgoType.MC | AlgoType.FORA_WHOLE_GRAPH:
                raise NotImplementedError(
                    f"{algo.value} is not ported yet (ROADMAP.md, queue 1)"
                )
        raise ValueError(f"unknown algo type {algo}")
