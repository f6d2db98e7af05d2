"""Personalized PageRank retrieval engine in PyTorch, for one NVIDIA H100.

The port of :mod:`ppr_tpu` (JAX on a TPU): the same graph store, operators,
algorithms and serving API, module for module, with the TPU's Pallas kernels
rewritten by hand for Hopper (``csrc/``). The package never imports JAX; the
JAX package is the reference its tests hold it against.

Every tensor lives on the device chosen once, when the graph is placed
(:mod:`ppr_tpu_torch.device`): the card unless the caller asks for the
CPU, and an error when no card is visible. Nothing moves work back to the
CPU for a CUDA tensor.
"""

__version__ = "0.1.0"

from .device import default_device  # noqa: F401
from .graph.csr import Graph, build_graph, graph_from_numpy  # noqa: F401
from .graph.io import (  # noqa: F401
    Dataset,
    load_default,
    load_edge_list,
    load_got,
    load_neo4j_csv,
    synthetic_powerlaw,
)
from .models.config import AlgoConf, AlgoType  # noqa: F401
from .service import PPRService, TopKHit  # noqa: F401
