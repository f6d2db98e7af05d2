"""Algorithm configuration / factory — port of ``ppr_tpu/models/config.py``
(Algo_Conf.java and the newAlgoObj switch of Gen_Util.java:66-97) for the
algorithms ported so far: FORA top-k, the power method and the Neo4j
method. The other types raise until their slice lands (ROADMAP.md,
queue 1)."""

from __future__ import annotations

import dataclasses
import enum

from ..graph.io import Dataset
from .fora import ForaTopk
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

    def set_conf_fora_topk(self, dataset: Dataset, k: int) -> ForaTopk:
        return ForaTopk(dataset, self.alpha, k=k, seed=self.seed)

    def set_conf_neo4j_method(self, dataset: Dataset) -> Neo4jMethod:
        return Neo4jMethod(dataset, self.alpha, seed=self.seed)

    def new_algo_obj(self, algo: AlgoType, dataset: Dataset, k: int = -1):
        """The newAlgoObj factory switch (Gen_Util.java:66-97)."""
        if algo == AlgoType.POWER_METHOD:
            return self.set_conf_power_method(dataset)
        if algo == AlgoType.FORA_TOPK:
            return self.set_conf_fora_topk(dataset, k)
        if algo == AlgoType.NEO4J_METHOD:
            return self.set_conf_neo4j_method(dataset)
        if isinstance(algo, AlgoType):
            raise NotImplementedError(
                f"{algo.value} is not ported yet (ROADMAP.md, queue 1)"
            )
        raise ValueError(f"unknown algo type {algo}")
