"""A mesh across processes, one process a card — port of
``ppr_tpu/parallel/distributed.py``.

The JAX package spans hosts with ``jax.distributed.initialize``: every
process then sees the global device set, and the same single-controller
programs run over it. In PyTorch the way to span cards and hosts is one
process a card over ``torch.distributed``: every rank runs the same
program over the whole ``(data, graph)`` grid, holds the shards of the
positions it owns, and the collectives of :mod:`.mesh` cross processes
(``psum`` by ``all_gather`` in shard order, ``pmax`` / ``pmin`` by
``all_reduce``, the ring by ``batch_isend_irecv``, a message a part).

    torchrun --standalone --nproc-per-node 4 my_script.py
    # in my_script.py, on every rank:
    initialize_from_env()                  # False in a single process
    svc = PPRService(ds, mesh=global_mesh(), mesh_engine="node")

NCCL takes one rank a card. More ranks than cards run on gloo
(``initialize_from_env(backend="gloo")``, ``global_mesh(devices=
["cuda:0"])`` on every rank): the arithmetic and the kernels stay on the
card, and the wire between ranks goes through host memory.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import time

import torch

from .mesh import Mesh, grid_shape, make_mesh

#: seconds a collective may wait for a lost rank before it raises
TIMEOUT_S = 600


def initialize_from_env(backend: str | None = None, *,
                        timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group that torchrun's environment describes
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``; they take the place of ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``). Returns ``False`` when
    there is no multi-process environment (no ``WORLD_SIZE`` above 1), as
    the JAX package's does, and ``True`` once the group is up.

    ``backend=None`` is NCCL on a card and gloo without one; on a card the
    rank's card ``cuda:LOCAL_RANK`` is pinned first (``LOCAL_RANK`` modulo
    the cards where ranks outnumber them). A collective that
    waits ``timeout_s`` for a lost rank raises rather than hangs. The JAX
    package's TPU-pod auto-detection (its lines 39-44) has no counterpart:
    nothing tells a process of a cluster but this environment."""
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        # more ranks than cards share them in turn (gloo only: NCCL takes
        # one rank a card)
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="env://", world_size=world,
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(graph_axis: int | None = None, devices=None) -> Mesh:
    """The ``(data, graph)`` mesh over every device of every process
    (``ppr_tpu/parallel/distributed.py:48``: ``make_mesh(len(devices),
    graph=graph_axis)``), the devices in rank order. ``devices`` lists
    this rank's devices (default: its pinned card); every rank lists as
    many. Without a process group it is :func:`~.mesh.make_mesh` over
    ``devices`` (default: the visible cards)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(None if devices is None else len(devices),
                         graph=graph_axis, devices=devices)
    if devices is None:
        devices = [torch.device("cuda", torch.cuda.current_device())]
    mine = [str(torch.device(d)) for d in devices]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if len({len(x) for x in every}) != 1:
        raise ValueError(f"every rank lists as many devices; got "
                         f"{[len(x) for x in every]}")
    flat = [(rank, dev) for rank, devs in enumerate(every) for dev in devs]
    data, graph = grid_shape(len(flat), graph=graph_axis)
    rows = [flat[d * graph:(d + 1) * graph] for d in range(data)]
    return Mesh([[dev for _, dev in row] for row in rows],
                owner=[[rank for rank, _ in row] for row in rows],
                rank=dist.get_rank(), group=dist.group.WORLD)


def spawn_local(nprocs: int, argv: list[str], *, timeout_s: float,
                log_dir: str) -> None:
    """Run ``argv`` as ``nprocs`` ranks of one process group on this host,
    each with the environment torchrun gives a rank (``MASTER_ADDR``
    localhost, a free ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) and its output in ``log_dir/rank<r>.log``. Raises
    ``RuntimeError`` with the logs' tails when a rank fails or the ranks
    are not done within ``timeout_s``; every rank still running is then
    killed, so a lost rank costs one deadline, not a hang."""
    os.makedirs(log_dir, exist_ok=True)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs, logs = [], []
    for rank in range(nprocs):
        path = os.path.join(log_dir, f"rank{rank}.log")
        logs.append(path)
        with open(path, "w") as log:
            procs.append(subprocess.Popen(argv, stdout=log,
                                          stderr=subprocess.STDOUT, env={
                **os.environ, "MASTER_ADDR": "localhost",
                "MASTER_PORT": str(port), "WORLD_SIZE": str(nprocs),
                "RANK": str(rank), "LOCAL_RANK": str(rank)}))
    deadline = time.monotonic() + timeout_s
    failed = None
    while failed is None and any(p.poll() is None for p in procs):
        if time.monotonic() > deadline:
            failed = f"the ranks passed their deadline of {timeout_s} s"
        elif any(p.poll() for p in procs):
            failed = "a rank failed"
        else:
            time.sleep(0.05)
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    if failed:
        tails = []
        for rank, (p, path) in enumerate(zip(procs, logs)):
            with open(path) as f:
                tail = f.read()[-2000:]
            tails.append(f"--- rank {rank}, exit {p.returncode}:\n{tail}")
        raise RuntimeError(f"{failed}: {argv}\n" + "\n".join(tails))
