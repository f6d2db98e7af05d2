"""Mesh engines: FORA top-k and FORA whole-graph on a ``(data, graph)``
grid of devices driven by one process — port of the serving half of
``ppr_tpu/parallel/``.

Not ported yet (ROADMAP.md, queue 1, item 18, the protocol engines): the
protocol's mesh drop-ins (``mesh_algos.py``), the all-pair engines
(``sharded_allpair.py``, ``node_sharded_allpair.py``), ``scaling.py``,
``comm_model.py`` and multi-host ``distributed.py``.
"""

from .dryrun import dryrun_multichip  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .node_sharded import (  # noqa: F401
    make_node_sharded_propagate,
    make_node_sharded_propagate_ring,
    make_node_sharded_walk_counts,
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
from .sharded_fora import ShardedForaTopk  # noqa: F401
