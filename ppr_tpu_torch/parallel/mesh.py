"""A ``(data, graph)`` grid of devices, driven by one process or by one
process a card.

The JAX package's mesh engines are single-controller SPMD programs: one
Python process drives every device of a ``jax.sharding.Mesh``, and the
collectives live inside the jitted program. The port keeps that program
text. A :class:`Mesh` is a ``[data][graph]`` grid of ``torch.device``s;
each shard's tensors live on its own device as tensors of their own, held
in nested lists ``parts[d][s]``, and every collective of the JAX programs
is one small function here:

* :func:`psum` adds the parts in ascending shard order, so two runs give
  the same bits, and hands each part's device the sum;
* :func:`pmax` and :func:`pmin` reduce scalars (the loop flags);
* :func:`ppermute` moves each part one step along a ring, optionally as
  bf16 on the wire;
* :func:`all_gather` concatenates the parts in shard order;
* :func:`fetch` hands every process the parts of a result.

A device may repeat in the grid: ``make_mesh(4, data=2, graph=2,
devices=["cuda:0"] * 4)`` runs a 2x2 mesh on one card, and ``["cpu"] * 8``
is how the tests run one. The partitioned arithmetic, the ring and the
kernels on every shard all run for real; only the copies between shards
on one device cost nothing. Its times are not a scaling result.

**A mesh across processes** (``parallel/distributed.py::global_mesh``):
every position ``(d, s)`` has an owner rank (``Mesh.owner``), and every
rank runs the same program over the whole grid. ``parts[d][s]`` holds a
tensor only at this rank's positions; elsewhere it holds a :class:`Remote`
marker (never ``None``, which the ring uses for an edge-less block). The
collectives then cross processes over ``torch.distributed``:

* :func:`psum` gathers the row's parts (``all_gather`` in the row's
  process group) and adds them in ascending shard order: the bits of the
  single-process mesh. An ``all_reduce(SUM)`` would add in the backend's
  order, not shard order;
* :func:`pmax` / :func:`pmin` are ``all_reduce`` MAX / MIN, exact; under
  NCCL the flags stay on the card, and the host reads them only where the
  engine does in one process;
* :func:`ppermute` is one ``batch_isend_irecv`` to the ring neighbour, a
  message a part (all its fields), sized from the receiver's own part:
  every ring of the engines carries one shape, as under ``shard_map``;
* :func:`all_gather` gathers in shard order; :func:`broadcast` reaches
  this rank's devices only.

Transport follows the process group's backend: NCCL moves the tensors on
the card; gloo moves host tensors, so a CUDA part crossing a gloo group is
staged through pinned host memory, explicitly (the host then waits on the
card at every collective). The ring and the gathers move bytes
(``uint8``), so no backend has to support the dtype. ``Mesh.wire_bytes``
counts the bytes this rank sent, and ``Mesh.wire_s`` the seconds its
collectives took where the wire is the host. Every rank must issue the
same collectives in the same order: the engines branch only on values
that came out of :func:`pmax` / :func:`pmin`, which every rank holds
alike.

The results of a collective may share storage between shards on one
device: callers never write into them in place.
"""

from __future__ import annotations

import contextlib
import time

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


class Remote:
    """The marker at a mesh position that another process owns: it holds no
    tensor, and names its position so that a collective knows the owner."""

    __slots__ = ("mesh", "d", "s")

    def __init__(self, mesh: "Mesh", d: int, s: int):
        self.mesh, self.d, self.s = mesh, d, s

    @property
    def owner(self) -> int:
        return self.mesh.owner[self.d][self.s]

    def __repr__(self) -> str:
        return f"Remote(({self.d}, {self.s}) on rank {self.owner})"


def is_remote(x) -> bool:
    return isinstance(x, Remote)


class Mesh:
    """A ``[data][graph]`` grid of devices with the axis names
    ``("data", "graph")``. ``owner[d][s]`` is the rank that drives
    position ``(d, s)``; ``group`` is the process group of a mesh across
    processes, ``None`` in one process."""

    axis_names = AXES

    def __init__(self, devices, *, owner=None, rank: int = 0, group=None):
        rows = [[_canonical(d) for d in row] for row in devices]
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid of "
                             "devices")
        self.devices = rows
        self.owner = owner if owner is not None else \
            [[rank] * len(rows[0]) for _ in rows]
        self.rank = rank
        self.group = group
        #: bytes this rank has sent to other ranks, and the seconds its
        #: collectives took where the wire is the host (gloo)
        self.wire_bytes = 0
        self.wire_s = 0.0
        if not any(self.is_local(d, s) for d in range(self.data)
                   for s in range(self.graph)):
            raise ValueError(f"rank {rank} owns no position of the mesh")
        self._rows: dict[int, tuple] = {}
        if group is not None:
            import torch.distributed as dist

            self.wire = (torch.device("cpu")
                         if dist.get_backend(group) == "gloo"
                         else self.controller)
            # every rank creates every row's group, in row order
            made: dict[tuple, object] = {}
            for d in range(self.data):
                ranks = tuple(sorted(set(self.owner[d])))
                if len(ranks) > 1 and ranks not in made:
                    made[ranks] = dist.new_group(list(ranks))
                self._rows[d] = (ranks, made.get(ranks))

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
    def spans(self) -> bool:
        """True for a mesh across processes."""
        return self.group is not None

    @property
    def is_writer(self) -> bool:
        """True on the rank that writes reports and stores: rank 0, or the
        one process of a single-process mesh."""
        return self.rank == 0

    def is_local(self, d: int, s: int) -> bool:
        return self.owner[d][s] == self.rank

    def remote(self, d: int, s: int) -> Remote:
        return Remote(self, d, s)

    def grid(self, fn) -> list[list]:
        """``[data][graph]``: ``fn(d, s, device)`` at this rank's positions,
        :class:`Remote` elsewhere."""
        return [[fn(d, s, dev) if self.is_local(d, s) else self.remote(d, s)
                 for s, dev in enumerate(row)]
                for d, row in enumerate(self.devices)]

    def speaker(self, d: int) -> int | None:
        """This rank's first position in data row ``d`` (``None`` when it
        owns none): where it reads a row whose graph replicas agree."""
        return next((s for s in range(self.graph) if self.is_local(d, s)),
                    None)

    @property
    def controller(self) -> torch.device:
        """This rank's first device: where the loop flags are combined."""
        for d, row in enumerate(self.devices):
            for s, dev in enumerate(row):
                if self.is_local(d, s):
                    return dev
        raise AssertionError("unreachable: every rank owns a position")

    def synchronize(self) -> None:
        """Wait for the queued work of every card of this rank (a no-op on
        the CPU), so that a host clock read next covers it."""
        for dev in self.unique_devices():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

    def unique_devices(self) -> list[torch.device]:
        """This rank's devices, each once, in grid order."""
        seen = []
        for d, row in enumerate(self.devices):
            for s, dev in enumerate(row):
                if self.is_local(d, s) and dev not in seen:
                    seen.append(dev)
        return seen

    def barrier(self) -> None:
        """Wait for every rank of a mesh across processes (a no-op in one
        process)."""
        if self.spans:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    def agree_max(self, value: float) -> float:
        """The largest of every rank's ``value``: a host decision (a clock
        reading, a budget) that every rank then takes alike."""
        if not self.spans:
            return float(value)
        return float(_all_reduce(self, torch.tensor([float(value)],
                                                    dtype=torch.float64),
                                 "max")[0])


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
    data, graph = grid_shape(n_devices, data, graph)
    return Mesh([devices[d * graph:(d + 1) * graph] for d in range(data)])


def grid_shape(n_devices: int, data: int | None = None,
               graph: int | None = None) -> tuple[int, int]:
    """``(data, graph)`` of :func:`make_mesh`'s split of ``n_devices``."""
    if graph is None:
        graph = 2 if n_devices % 2 == 0 else 1
    if data is None:
        data = n_devices // graph
    if data * graph != n_devices:
        raise ValueError(f"mesh {data}x{graph} != {n_devices} devices")
    return data, graph


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


# -- the wire between processes -------------------------------------------

#: bytes each field of a ring message is padded to, so that every field
#: starts where its dtype may be viewed
_ALIGN = 16


@contextlib.contextmanager
def _on_wire(mesh: Mesh):
    """Count the time of a collective into ``mesh.wire_s`` where the wire
    is the host (gloo). The host waits on the card there anyway, to stage
    the parts, so the card is synchronized first and the clock holds the
    staging, the transfer, the wait for the peers and the copies back (a
    copy from host memory returns when it is done). On NCCL's wire the
    clock would cost a synchronization a collective: ``wire_s`` stays 0."""
    if mesh.wire.type != "cpu":
        yield
        return
    mesh.synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        mesh.wire_s += time.perf_counter() - t0


def _to_wire(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes as a flat ``uint8`` tensor on the wire's device: a
    view on the card for NCCL; for gloo a host copy, through pinned memory
    when ``x`` is on a card."""
    flat = x.contiguous().reshape(-1).view(torch.uint8)
    if mesh.wire.type == "cpu" and flat.device.type == "cuda":
        host = torch.empty(flat.numel(), dtype=torch.uint8, pin_memory=True)
        host.copy_(flat)
        return host
    return flat.to(mesh.wire)


def _wire_empty(mesh: Mesh, nbytes: int, device) -> torch.Tensor:
    """A receive buffer of ``nbytes`` on the wire's device, for a tensor
    bound for ``device``: pinned host memory when gloo's wire lands on a
    card."""
    pin = mesh.wire.type == "cpu" and torch.device(device).type == "cuda"
    return torch.empty(nbytes, dtype=torch.uint8, device=mesh.wire,
                       pin_memory=pin)


def _from_wire(buf: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    return buf.view(dtype).reshape(shape).to(device)


def _row_parts(parts: list, d: int, device) -> list[torch.Tensor]:
    """Every part of data row ``d`` on ``device``, in shard order: this
    rank's own, the others' gathered in the row's process group. The parts
    have one shape and dtype."""
    import torch.distributed as dist

    mesh = next(x for x in parts if is_remote(x)).mesh
    ranks, group = mesh._rows[d]
    held = {r: [s for s in range(len(parts)) if mesh.owner[d][s] == r]
            for r in ranks}
    width = max(len(v) for v in held.values())
    mine = [parts[s] for s in held[mesh.rank]]
    mine += [torch.zeros_like(mine[0])] * (width - len(mine))
    out = list(parts)
    shape, dtype = (width,) + tuple(mine[0].shape), mine[0].dtype
    with _on_wire(mesh):
        send = _to_wire(mesh, torch.stack(mine) if width > 1 else mine[0])
        bufs = [torch.empty_like(send) if r == mesh.rank
                else _wire_empty(mesh, send.numel(), device) for r in ranks]
        dist.all_gather(bufs, send, group=group)
        mesh.wire_bytes += send.numel() * (len(ranks) - 1)
        for r, buf in zip(ranks, bufs):
            if r == mesh.rank:
                continue
            got = _from_wire(buf, dtype, shape, device)
            for j, s in enumerate(held[r]):
                out[s] = got[j]
    return [_move(x, device) for x in out]


def _all_reduce(mesh: Mesh, x: torch.Tensor, op: str) -> torch.Tensor:
    """``x`` reduced elementwise by ``op`` over every rank of ``mesh``, on
    ``x``'s device: NCCL reduces on the card, gloo a host copy."""
    import torch.distributed as dist

    with _on_wire(mesh):
        wire = x.to(torch.uint8) if x.dtype == torch.bool else x
        wire = wire.to(mesh.wire, copy=True)
        dist.all_reduce(wire, op={"max": dist.ReduceOp.MAX,
                                  "min": dist.ReduceOp.MIN}[op],
                        group=mesh.group)
        mesh.wire_bytes += wire.numel() * wire.element_size()
        return wire.to(x.device, x.dtype)


# -- the collectives ------------------------------------------------------

def psum(parts: list) -> list:
    """The sum of a data row's ``parts``, added in ascending shard order on
    the first part's device (this rank's first, across processes), handed
    to every part's device; :class:`Remote` stays where it was."""
    remote = [x for x in parts if is_remote(x)]
    if not remote:
        total = parts[0]
        for x in parts[1:]:
            total = total + _move(x, total.device)
        return [_move(total, x.device) for x in parts]
    if len(remote) == len(parts):
        return list(parts)
    first = next(x for x in parts if not is_remote(x))
    full = _row_parts(parts, remote[0].d, first.device)
    total = full[0]
    for x in full[1:]:
        total = total + x
    return [x if is_remote(x) else _move(total, x.device) for x in parts]


def _reduce(parts: list, op: str, mesh: Mesh | None) -> list:
    local = [x for x in parts if not is_remote(x)]
    if not local:
        raise ValueError("a rank reduces at least one local part")
    dev = local[0].device
    fn = torch.amax if op == "max" else torch.amin
    if mesh is not None and mesh.spans:
        value = local[0] if len(local) == 1 else \
            fn(torch.stack([_move(x, dev) for x in local]), dim=0)
        value = _all_reduce(mesh, value, op)
        dev = mesh.controller
    else:
        value = fn(torch.stack([_move(x, dev) for x in local]), dim=0)
    return [_move(value, dev if is_remote(x) else x.device) for x in parts]


def pmax(parts: list, mesh: Mesh | None = None) -> list:
    """The elementwise largest of ``parts`` (tensors of one shape: the loop
    flags), on every part's device. Across processes (``mesh`` spans them)
    every rank of ``mesh`` calls it, each with at least one local part; the
    value stays on the card under NCCL, and :class:`Remote` positions get
    it on ``mesh.controller``."""
    return _reduce(parts, "max", mesh)


def pmin(parts: list, mesh: Mesh | None = None) -> list:
    """The elementwise smallest of ``parts``, as :func:`pmax`."""
    return _reduce(parts, "min", mesh)


def _fields(x) -> tuple:
    return x if isinstance(x, tuple) else (x,)


def _wire_dtype(t: torch.Tensor, wire_dtype) -> torch.dtype:
    return wire_dtype if (wire_dtype is not None and t.is_floating_point()
                          and t.dtype != wire_dtype) else t.dtype


def ppermute(parts: list, devices: list, wire_dtype=None) -> list:
    """One step along the ring: part ``i`` moves to ``devices[(i + 1) %
    S]``. A part is a tensor or a tuple of tensors whose ``None`` fields
    stay ``None``; with ``wire_dtype`` a float field travels in that type
    and is widened back to its own on arrival (the bf16 ring).

    Across processes a part whose next position is another rank's goes
    there in one message of its fields' bytes. As under JAX's
    ``shard_map``, every part of the ring then has the shapes and dtypes of
    this rank's own (the CSR slices are padded to the largest): a receiver
    sizes its message from its own part, and no header crosses."""
    n = len(parts)
    out = [None] * n
    sends, recvs = [], []
    for i, x in enumerate(parts):
        j = (i + 1) % n
        if is_remote(parts[j]):
            out[j] = parts[j]
            if not is_remote(x):
                sends.append((j, parts[j].owner, x))
        elif is_remote(x):
            recvs.append((j, x.owner))
        else:
            moved = tuple(None if t is None else
                          _move(t.to(_wire_dtype(t, wire_dtype)),
                                devices[j]).to(t.dtype)
                          for t in _fields(x))
            out[j] = moved if isinstance(x, tuple) else moved[0]
    if sends or recvs:
        mesh = next(x for x in parts if is_remote(x)).mesh
        _ring_exchange(mesh, parts, devices, wire_dtype, sends, recvs, out)
    return out


def _ring_exchange(mesh, parts, devices, wire_dtype, sends, recvs,
                   out) -> None:
    """The crossing steps of :func:`ppermute` in one ``batch_isend_irecv``
    ordered by the destination position (NCCL matches a pair's messages in
    issue order): each part's fields in the wire's dtypes, each padded to
    ``_ALIGN`` bytes, as one ``uint8`` message."""
    import torch.distributed as dist

    def specs(x):
        return [None if t is None else
                (tuple(t.shape), t.dtype, _wire_dtype(t, wire_dtype))
                for t in _fields(x)]

    def padded(shape, wire) -> int:
        return -(-int(np.prod(shape, dtype=np.int64)) * wire.itemsize
                 // _ALIGN) * _ALIGN

    with _on_wire(mesh):
        ops = []
        for j, peer, x in sends:
            chunks = []
            for t in _fields(x):
                if t is None:
                    continue
                b = t.to(_wire_dtype(t, wire_dtype)).contiguous() \
                    .reshape(-1).view(torch.uint8)
                chunks.append(b)
                if b.numel() % _ALIGN:
                    chunks.append(b.new_zeros(_ALIGN - b.numel() % _ALIGN))
            msg = _to_wire(mesh, torch.cat(chunks))
            mesh.wire_bytes += msg.numel()
            ops.append((j, dist.P2POp(dist.isend, msg, peer, tag=j)))
        got = []
        for j, peer in recvs:
            spec = specs(parts[j])
            buf = _wire_empty(mesh, sum(padded(sh, w) for sh, _, w in
                                        filter(None, spec)), devices[j])
            got.append((j, spec, buf))
            ops.append((j, dist.P2POp(dist.irecv, buf, peer, tag=j)))
        ops.sort(key=lambda t: t[0])
        for req in dist.batch_isend_irecv([op for _, op in ops]):
            req.wait()
        for j, spec, buf in got:
            buf, at, fields = buf.to(devices[j]), 0, []
            for f in spec:
                if f is None:
                    fields.append(None)
                    continue
                shape, dtype, wire = f
                n = int(np.prod(shape, dtype=np.int64)) * wire.itemsize
                fields.append(buf[at:at + n].view(wire).reshape(shape)
                              .to(dtype))
                at += padded(shape, wire)
            out[j] = tuple(fields) if isinstance(parts[j], tuple) \
                else fields[0]


def all_gather(parts: list, dim: int = 0,
               device: torch.device | None = None):
    """``parts`` concatenated along ``dim`` in shard order, on ``device``
    (the first part's by default, this rank's first across processes). A
    rank that holds no part of the row gets its first :class:`Remote`."""
    remote = [x for x in parts if is_remote(x)]
    if remote:
        if len(remote) == len(parts):
            return remote[0]
        first = next(x for x in parts if not is_remote(x))
        dev = first.device if device is None else device
        return torch.cat(_row_parts(parts, remote[0].d, dev), dim=dim)
    dev = parts[0].device if device is None else device
    return torch.cat([_move(x, dev) for x in parts], dim=dim)


def broadcast(x: torch.Tensor, mesh: Mesh) -> dict:
    """``x`` on every device of this rank, keyed by device."""
    return {dev: _move(x, dev) for dev in mesh.unique_devices()}


def fetch(mesh: Mesh, parts):
    """``parts`` (nested lists of tensors and :class:`Remote`) with every
    :class:`Remote` replaced by its owner's tensor, on the host: a result
    that every rank returns alike. Every rank of a mesh across processes
    calls it with the same nesting; in one process it returns ``parts``."""
    if not mesh.spans:
        return parts
    import torch.distributed as dist

    flat: list = []

    def walk(x):
        if isinstance(x, (list, tuple)):
            return [walk(y) for y in x]
        flat.append(x)
        return len(flat) - 1

    shape = walk(parts)
    every = [None] * dist.get_world_size(mesh.group)
    with _on_wire(mesh):
        mine = {i: x.detach().cpu() for i, x in enumerate(flat)
                if not is_remote(x)}
        dist.all_gather_object(every, mine, group=mesh.group)
    mesh.wire_bytes += sum(x.numel() * x.element_size()
                           for x in mine.values()) * (len(every) - 1)
    for theirs in every:
        for i, x in theirs.items():
            if is_remote(flat[i]):
                flat[i] = x

    def build(x):
        return [build(y) for y in x] if isinstance(x, list) else flat[x]

    return build(shape)


def shard_generators(mesh: Mesh, seed: int) -> list[list]:
    """One ``torch.Generator`` a shard of this rank, on the shard's device,
    seeded from ``seed`` and the shard's index ``d * graph + s``
    (:class:`Remote` at the other ranks' shards)."""

    def make(d, s, dev):
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence(
            [int(seed), d * mesh.graph + s]).generate_state(1)[0]))
        return gen

    return mesh.grid(make)


def split(b: int, parts: int) -> list[slice]:
    """The ``parts`` equal consecutive slices of ``range(b)``; ``b`` must
    be a multiple of ``parts``."""
    if b % parts:
        raise ValueError(f"{b} rows do not split into {parts} equal shards")
    step = b // parts
    return [slice(i * step, (i + 1) * step) for i in range(parts)]
