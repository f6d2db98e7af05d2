"""Mesh engines on a ``(data, graph)`` grid of devices, driven by one
process or by one process a card — port of ``ppr_tpu/parallel/``: FORA
top-k and whole-graph serving (``sharded_fora``, ``node_sharded_fora``),
the protocol's mesh drop-ins for every algorithm (``mesh_algos``), the
edge- and node-sharded BASE all-pair engines (``sharded_allpair``,
``node_sharded_allpair``), the scaling sweep (``scaling``), the
communication model (``comm_model``), the dry run (``dryrun``) and the
mesh across processes (``distributed``: ``initialize_from_env``,
``global_mesh``).
"""

from .distributed import global_mesh, initialize_from_env  # noqa: F401
from .dryrun import dryrun_multichip, dryrun_sharded_base  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .mesh_algos import (  # noqa: F401
    MeshForaWholeGraph,
    MeshForwardPush,
    MeshMonteCarlo,
    MeshNeo4jMethod,
    mesh_algo_obj,
)
from .node_sharded import (  # noqa: F401
    make_node_sharded_propagate,
    make_node_sharded_propagate_ring,
    make_node_sharded_walk_counts,
)
from .node_sharded_allpair import (  # noqa: F401
    NodeShardedBackwardSearch,
    node_sharded_base_allpair,
)
from .node_sharded_fora import (  # noqa: F401
    NodeShardedForaTopk,
    NodeShardedForaWholeGraph,
)
from .sharded import (  # noqa: F401
    make_sharded_push_sweeps,
    make_sharded_walk_counts,
    shard_graph,
    sharded_fora_step,
)
from .sharded_allpair import (  # noqa: F401
    ShardedBackwardSearch,
    sharded_base_allpair,
)
from .sharded_fora import ShardedForaTopk  # noqa: F401
