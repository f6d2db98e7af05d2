"""A ``(data, graph)`` grid of devices driven by one process.

The JAX package's mesh engines are single-controller SPMD programs: one
Python process drives every device of a ``jax.sharding.Mesh``, and the
collectives live inside the jitted program. The port keeps the single
controller. A :class:`Mesh` is a ``[data][graph]`` grid of
``torch.device``s; each shard's tensors live on its own device as tensors
of their own, held in nested lists ``parts[d][s]``, and every collective of
the JAX programs is one small function here:

* :func:`psum` adds the parts in ascending shard order, so two runs give
  the same bits, and hands each part's device the sum;
* :func:`pmax` and :func:`pmin` reduce scalars (the loop flags) the same
  way;
* :func:`ppermute` moves each part one step along a ring,
  ``.to(next_device, non_blocking=True)``, optionally as bf16 on the wire;
* :func:`all_gather` concatenates the parts in shard order.

A device may repeat in the grid: ``make_mesh(4, data=2, graph=2,
devices=["cuda:0"] * 4)`` runs a 2x2 mesh on one card, and ``["cpu"] * 8``
is how the tests run one. The partitioned arithmetic, the ring and the
kernels on every shard all run for real; only the copies between shards
on one device cost nothing. Its times are not a scaling result.

The port does not use ``torch.distributed`` here: NCCL takes one rank a
card, and gloo's sends take no CUDA tensors. The results of a collective
may share storage between shards on one device: callers never write into
them in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import NO_CARD

AXES = ("data", "graph")


def _canonical(device) -> torch.device:
    """``device`` with its index: a tensor's ``.device`` always has one, and
    the engines key per-device values by it."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        index = torch.cuda.current_device() if torch.cuda.is_available() \
            else 0
        device = torch.device("cuda", index)
    return device


class Mesh:
    """A ``[data][graph]`` grid of devices with the axis names
    ``("data", "graph")``."""

    axis_names = AXES

    def __init__(self, devices):
        rows = [[_canonical(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.devices = rows

    @property
    def data(self) -> int:
        return len(self.devices)

    @property
    def graph(self) -> int:
        return len(self.devices[0])

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "graph": self.graph}

    @property
    def size(self) -> int:
        return self.data * self.graph

    @property
    def controller(self) -> torch.device:
        """The first device: where the loop flags are combined."""
        return self.devices[0][0]

    def synchronize(self) -> None:
        """Wait for the queued work of every card of the mesh (a no-op on
        the CPU), so that a host clock read next covers it."""
        for dev in self.unique_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def unique_devices(self) -> list[torch.device]:
        seen = []
        for row in self.devices:
            for dev in row:
                if dev not in seen:
                    seen.append(dev)
        return seen


def make_mesh(n_devices: int | None = None, *, data: int | None = None,
              graph: int | None = None, devices=None) -> Mesh:
    """A ``(data, graph)`` mesh over the first ``n_devices`` devices
    (``ppr_tpu/parallel/sharded.py:40-55``): ``graph`` defaults to 2 when
    ``n_devices`` is even, else 1, and ``data`` to ``n_devices // graph``.

    ``devices=None`` takes the visible cards and raises ``RuntimeError``
    when fewer are visible than the mesh needs; nothing falls back to the
    CPU. An explicit ``devices`` list may repeat a device."""
    if n_devices is None and data and graph:
        n_devices = data * graph
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
        want = n_devices if n_devices is not None else max(count, 1)
        if count < want:
            raise RuntimeError(
                f"a {want}-device mesh needs {want} cards; {count} visible"
                + (f" ({NO_CARD})" if count == 0 else ""))
    devices = [torch.device(d) for d in devices]
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"{n_devices} devices asked for; {len(devices)} "
                         "given")
    devices = devices[:n_devices]
    if graph is None:
        graph = 2 if n_devices % 2 == 0 else 1
    if data is None:
        data = n_devices // graph
    if data * graph != n_devices:
        raise ValueError(f"mesh {data}x{graph} != {n_devices} devices")
    return Mesh([devices[d * graph:(d + 1) * graph] for d in range(data)])


def parse_mesh(spec: str) -> tuple[int, int]:
    """``"DxG"`` as ``(D, G)``: the daemon's and the CLI's ``--mesh``."""
    try:
        d, g = (int(x) for x in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh takes DATAxGRAPH, e.g. 2x2; got "
                         f"{spec!r}") from None
    if d < 1 or g < 1:
        raise ValueError(f"--mesh {spec}: both axes must be >= 1")
    return d, g


def _move(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    return x if x.device == device else x.to(device, non_blocking=True)


def psum(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The sum of ``parts``, added in ascending shard order on the first
    part's device, handed to every part's device."""
    total = parts[0]
    for x in parts[1:]:
        total = total + _move(x, total.device)
    return [_move(total, x.device) for x in parts]


def _reduce(parts: list[torch.Tensor], op) -> list[torch.Tensor]:
    dev = parts[0].device
    value = op(torch.stack([_move(x, dev) for x in parts]))
    return [_move(value, x.device) for x in parts]


def pmax(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The largest of the scalar ``parts``, on every part's device."""
    return _reduce(parts, torch.amax)


def pmin(parts: list[torch.Tensor]) -> list[torch.Tensor]:
    """The smallest of the scalar ``parts``, on every part's device."""
    return _reduce(parts, torch.amin)


def ppermute(parts: list[torch.Tensor], devices: list[torch.device],
             wire_dtype: torch.dtype | None = None) -> list[torch.Tensor]:
    """One step along the ring: part ``i`` moves to ``devices[(i + 1) %
    S]``. With ``wire_dtype`` the part travels in that type and is widened
    back to its own on arrival (the bf16 ring)."""
    n = len(parts)
    out = [None] * n
    for i, x in enumerate(parts):
        j = (i + 1) % n
        if wire_dtype is not None and x.dtype != wire_dtype:
            out[j] = _move(x.to(wire_dtype), devices[j]).to(x.dtype)
        else:
            out[j] = _move(x, devices[j])
    return out


def all_gather(parts: list[torch.Tensor], dim: int = 0,
               device: torch.device | None = None) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` in shard order, on ``device``
    (the first part's by default)."""
    dev = parts[0].device if device is None else device
    return torch.cat([_move(x, dev) for x in parts], dim=dim)


def broadcast(x: torch.Tensor, mesh: Mesh) -> dict:
    """``x`` on every device of ``mesh``, keyed by device."""
    return {dev: _move(x, dev) for dev in mesh.unique_devices()}


def shard_generators(mesh: Mesh, seed: int) -> list[list[torch.Generator]]:
    """One ``torch.Generator`` a shard, on the shard's device, seeded from
    ``seed`` and the shard's index ``d * graph + s``."""
    out = []
    for d, row in enumerate(mesh.devices):
        gens = []
        for s, dev in enumerate(row):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(np.random.SeedSequence(
                [int(seed), d * mesh.graph + s]).generate_state(1)[0]))
            gens.append(gen)
        out.append(gens)
    return out


def split(b: int, parts: int) -> list[slice]:
    """The ``parts`` equal consecutive slices of ``range(b)``; ``b`` must
    be a multiple of ``parts``."""
    if b % parts:
        raise ValueError(f"{b} rows do not split into {parts} equal shards")
    step = b // parts
    return [slice(i * step, (i + 1) * step) for i in range(parts)]
