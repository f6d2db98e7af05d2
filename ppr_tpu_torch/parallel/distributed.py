"""Meshes across hosts — the port of ``ppr_tpu/parallel/distributed.py``
is not made yet.

The JAX package spans hosts with ``jax.distributed.initialize``: every
process sees the global device set and the same single-controller
programs run over it. The port's mesh is one process driving the devices
it sees (:mod:`.mesh`); a mesh across hosts needs one process a card and
a collective backend between them, a design of its own (ROADMAP.md,
queue 1, item 18, multi-host). Both entry points raise until then.
"""

from __future__ import annotations

NOT_PORTED = ("a mesh across hosts is not ported: the port's mesh is one "
              "process over the devices it sees (ROADMAP.md, queue 1, "
              "item 18, multi-host)")


def initialize_from_env() -> bool:
    """``ppr_tpu/parallel/distributed.py:24``: raises
    ``NotImplementedError``."""
    raise NotImplementedError(NOT_PORTED)


def global_mesh(graph_axis: int | None = None):
    """``ppr_tpu/parallel/distributed.py:48``: raises
    ``NotImplementedError``."""
    raise NotImplementedError(NOT_PORTED)
