"""The annealed top-k loop's passes over its node-major state, fused into two
kernels around the push, and its scalar bookkeeping in one more
(``csrc/sweep_pass.cu``).

A sweep of :func:`~..models.fora.annealed_topk_propagate` is

1. :func:`sweep_pre`: ``p += r * (alpha while live)``; the push's operand
   ``scaled = (r * keep) / d_out`` (``r * keep`` where the push scales
   nothing: a weighted graph, the dense operator), and its bf16 copy for a
   bf16 hub product; the stopping rule's count ``#{v: p_v >= (1 + eps') *
   delta}`` a column, on the updated ``p``;
2. the push of ``scaled`` (the hub product, K3, the hub rows added);
3. :func:`sweep_post`: each column's dangling mass added at its source
   row; the new residue, or the old one on a frozen sweep; its column sums;
4. :func:`sweep_finalize`: ``settled``, ``done``, ``finished``, the anneal
   of ``delta`` and the sweep count ``it``, on the device (:class:`LoopState`).

Replaces no Pallas kernel: XLA fused these passes on the TPU. Bytes bound
them (the source's note has the design): the pre pass reads ``p`` and
``r`` and writes ``p``, ``scaled`` and the bf16 copy, 4.5 passes over the
state; the post pass reads the push's output once, 1 pass. The plain
sequence moved about 17.

``*_ref`` are the plain PyTorch versions, the loop's operators as they were
before the fusion; a wrapper runs its plain version for a tensor on the CPU
and, for a CUDA tensor, its kernel (after the toolchain probe K0) or
raises. On the card the kernels write ``p``, ``scaled``, its bf16 copy and
the new residue with the plain sequence's bits (``p`` by one fma, as
``torch.addcmul`` computes it there; each other product and sum rounded
on its own, as the separate operators round them); the column sums
are added in another, fixed order (per block, then per column over the
blocks), so two launches give the same bits; the counts are exact. The
passes launch on the current stream, do not synchronise and allocate
through ``torch.empty`` only.
"""

from __future__ import annotations

import dataclasses

import torch

from . import cuda_build, probe

#: launches in this process of each kernel (reset them to count a run's)
pre_launches = 0
post_launches = 0
finalize_launches = 0

#: threads a pass block, and the grid in blocks an SM (4 and 16 measured
#: within 3% of 8 at the flickr state, the source's note)
THREADS = 256
BLOCKS_PER_SM = 8
#: SMs of each card index, read once
_SMS: dict[int, int] = {}


@dataclasses.dataclass(frozen=True)
class Plan:
    """The layout of a pass over ``[n_rows, cols]``: ``vec`` columns a
    thread, ``tx`` threads a row (``THREADS // tx`` rows a block), a grid
    of ``gx`` column tiles by ``gy`` row strides; ``gy`` is also the rows
    of the partial counts and sums."""
    vec: int
    tx: int
    gx: int
    gy: int


def make_plan(n_rows: int, cols: int, aligned: bool, sms: int) -> Plan:
    """16-byte loads where ``cols % 4 == 0`` and every base is aligned;
    ``tx`` the pow2 at or above the loads a row, at most ``THREADS``; as
    many blocks as ``sms`` SMs hold at once, cut to the rows there are."""
    vec = 4 if aligned and cols % 4 == 0 else 1
    loads = cols // vec
    tx = 1
    while tx < loads and tx < THREADS:
        tx *= 2
    gx = -(-loads // tx)
    ty = THREADS // tx
    gy = max(1, min(-(-n_rows // ty), -(-sms * BLOCKS_PER_SM // gx)))
    return Plan(vec, tx, gx, gy)


@dataclasses.dataclass
class LoopState:
    """The annealed loop's device scalars: ``delta`` (f32), ``finished``
    (bool), ``it`` (int32, the live sweeps) and, on a card, the finalize's
    ``scratch`` (int32 ``[3]``, zero between launches)."""
    delta: torch.Tensor
    finished: torch.Tensor
    it: torch.Tensor
    scratch: torch.Tensor | None

    @classmethod
    def start(cls, delta0: float, device) -> "LoopState":
        dev = torch.device(device)
        return cls(
            delta=torch.tensor(delta0, dtype=torch.float32, device=dev),
            finished=torch.zeros((), dtype=torch.bool, device=dev),
            it=torch.zeros((), dtype=torch.int32, device=dev),
            scratch=(torch.zeros(3, dtype=torch.int32, device=dev)
                     if dev.type == "cuda" else None))


def sweep_pre_ref(p, r, state: LoopState, inv_deg, *, alpha: float,
                  keep: float, thresh_scale: float, bf16: bool):
    """Plain pre pass: ``(p, scaled, scaled_bf16 or None, counts [B])``."""
    live = ~state.finished
    # a frozen sweep adds r * 0: p is unchanged bit for bit
    p = torch.addcmul(p, r, live * alpha)
    rem = r * keep
    scaled = rem if inv_deg is None else rem * inv_deg[:, None]
    rhs = scaled.to(torch.bfloat16) if bf16 else None
    counts = (p >= thresh_scale * state.delta).sum(dim=0)
    return p, scaled, rhs, counts


def sweep_post_ref(pushed, r, src, dang, state: LoopState):
    """Plain post pass: ``(r, column sums [B])``; ``pushed`` gets each
    column's dangling mass at its source row."""
    if dang is not None:
        cols = torch.arange(src.shape[0], device=src.device)
        pushed[src.long(), cols] += dang
    r = torch.where(~state.finished, pushed, r)
    return r, r.sum(dim=0)


def sweep_finalize_ref(state: LoopState, counts, sums, *, k: int,
                       eps: float, min_delta: float, stable=None) -> None:
    """Plain finalize: the stopping rule and the anneal, ``state``'s
    tensors replaced."""
    live = ~state.finished
    delta = state.delta
    settled = live & (sums.max() <= eps * delta)
    done = settled & (counts >= k).all()
    if stable is not None:
        done = done | stable
    finished = state.finished | done | (settled & (delta <= min_delta))
    state.delta = torch.where(settled & ~finished,
                              torch.clamp_min(delta / 4.0, min_delta), delta)
    state.finished = finished
    state.it = state.it + live.to(torch.int32)


def _plan(t: torch.Tensor, *others) -> Plan:
    card = t.get_device()
    if card not in probe.probed:
        probe.ensure(t.device)
    sms = _SMS.get(card)
    if sms is None:
        sms = _SMS[card] = torch.cuda.get_device_properties(
            card).multi_processor_count
    aligned = all(x.data_ptr() % 16 == 0 for x in (t, *others)
                  if x is not None)
    n_rows, cols = t.shape
    return make_plan(n_rows, cols, aligned, sms)


def _check_state(what: str, shape, state: LoopState, *tensors,
                 others=()) -> None:
    """The state's ``tensors`` contiguous f32 ``shape``; they, ``others``
    (None allowed) and the loop's scalars on one card."""
    for x in tensors:
        if x.dtype != torch.float32 or x.shape != shape \
                or not x.is_contiguous():
            raise ValueError(f"{what}: the state must be contiguous f32 "
                             f"{list(shape)}")
    if len(shape) != 2 or shape[0] >= 2**31 or shape[1] >= 2**31:
        raise ValueError(f"{what}: a [n_rows, cols] state with fewer than "
                         f"2^31 of each, got {list(shape)}")
    card = tensors[0].get_device()
    if any(x.get_device() != card for x in (
            *tensors, *others, state.finished, state.delta)
            if x is not None):
        raise ValueError(f"{what}: every operand must lie on "
                         f"{tensors[0].device}")


def _ptr(x: torch.Tensor | None) -> int | None:
    return None if x is None else x.data_ptr()


def sweep_pre(p, r, state: LoopState, inv_deg, *, alpha: float, keep: float,
              thresh_scale: float, bf16: bool):
    """The pre pass: ``(p, scaled, scaled_bf16 or None, counts)``; on a
    card ``p`` is updated in place and ``counts`` are the partial counts
    ``[gy, B]`` that :func:`sweep_finalize` adds up."""
    global pre_launches
    if p.device.type == "cpu":
        return sweep_pre_ref(p, r, state, inv_deg, alpha=alpha, keep=keep,
                             thresh_scale=thresh_scale, bf16=bf16)
    if not p.is_cuda:
        raise ValueError(f"unsupported device {p.device}")
    _check_state("sweep_pre", p.shape, state, p, r, others=(inv_deg,))
    n_rows, cols = p.shape
    if inv_deg is not None and (inv_deg.dtype != torch.float32
                                or inv_deg.shape != (n_rows,)
                                or not inv_deg.is_contiguous()):
        raise ValueError(f"sweep_pre: inv_deg must be contiguous f32 "
                         f"[{n_rows}]")
    scaled = torch.empty_like(p)
    rhs = torch.empty_like(p, dtype=torch.bfloat16) if bf16 else None
    plan = _plan(p, r, scaled, rhs)
    counts = torch.empty((plan.gy, cols), dtype=torch.int32, device=p.device)
    fn = cuda_build.function("ppr_sweep_pre")
    rc = cuda_build.call(
        fn, p.get_device(), p.data_ptr(), r.data_ptr(),
        state.finished.data_ptr(), state.delta.data_ptr(), _ptr(inv_deg),
        scaled.data_ptr(), _ptr(rhs), counts.data_ptr(), n_rows, cols,
        plan.vec, plan.tx, plan.gx, plan.gy, alpha, keep, thresh_scale)
    if rc:
        cuda_build.check("ppr_sweep_pre", rc, "sweep_pre")
    pre_launches += 1
    return p, scaled, rhs, counts


def sweep_post(pushed, r, src, dang, state: LoopState):
    """The post pass: ``(r, sums)``, the new residue (``pushed``, updated
    in place on a card) and its column sums (partial ``[gy, B]`` on a
    card). ``src`` int32 ``[B]``: each column's source row; ``dang`` f32
    ``[B]``: each column's dangling mass, or None without dangling nodes."""
    global post_launches
    if pushed.device.type == "cpu":
        return sweep_post_ref(pushed, r, src, dang, state)
    if not pushed.is_cuda:
        raise ValueError(f"unsupported device {pushed.device}")
    _check_state("sweep_post", pushed.shape, state, pushed, r,
                 others=(src, dang))
    n_rows, cols = pushed.shape
    if src.dtype != torch.int32 or src.shape != (cols,) \
            or not src.is_contiguous():
        raise ValueError(f"sweep_post: src must be contiguous int32 [{cols}]")
    if dang is not None and (dang.dtype != torch.float32
                             or dang.shape != (cols,)
                             or not dang.is_contiguous()):
        raise ValueError(f"sweep_post: dang must be contiguous f32 [{cols}]")
    plan = _plan(pushed, r)
    sums = torch.empty((plan.gy, cols), dtype=torch.float32,
                       device=pushed.device)
    fn = cuda_build.function("ppr_sweep_post")
    rc = cuda_build.call(
        fn, pushed.get_device(), pushed.data_ptr(), r.data_ptr(),
        src.data_ptr(), _ptr(dang), state.finished.data_ptr(),
        sums.data_ptr(), n_rows, cols, plan.vec, plan.tx, plan.gx, plan.gy)
    if rc:
        cuda_build.check("ppr_sweep_post", rc, "sweep_post")
    post_launches += 1
    return pushed, sums


def sweep_finalize(state: LoopState, counts, sums, *, k: int, eps: float,
                   min_delta: float, stable=None) -> None:
    """The loop's bookkeeping after a sweep, on ``state``: settled when the
    largest column sum is ``<= eps * delta``; done when settled and every
    column counts ``>= k`` (or ``stable``, the early-exit certificate,
    holds); finished once done or settled at ``min_delta``; delta /4 (at
    least ``min_delta``) on a settled sweep that does not finish; ``it``
    one more on a live sweep. ``eps`` and ``min_delta`` are f32 values."""
    global finalize_launches
    if counts.device.type == "cpu":
        sweep_finalize_ref(state, counts, sums, k=k, eps=eps,
                           min_delta=min_delta, stable=stable)
        return
    cols = counts.shape[1]
    if counts.dtype != torch.int32 or sums.dtype != torch.float32 \
            or sums.shape[1] != cols:
        raise ValueError("sweep_finalize: counts int32 and sums f32, "
                         "[rows, B] each, from the passes")
    if stable is not None and (stable.dtype != torch.bool
                               or stable.numel() != 1):
        raise ValueError("sweep_finalize: stable must be one bool")
    card = counts.get_device()
    if any(x.get_device() != card for x in (
            sums, stable, state.finished, state.delta, state.it,
            state.scratch) if x is not None):
        raise ValueError(f"sweep_finalize: every operand must lie on "
                         f"{counts.device}")
    fn = cuda_build.function("ppr_sweep_finalize")
    rc = cuda_build.call(
        fn, counts.get_device(), counts.data_ptr(), counts.shape[0],
        sums.data_ptr(), sums.shape[0], cols, k, _ptr(stable),
        state.finished.data_ptr(), state.delta.data_ptr(),
        state.it.data_ptr(), state.scratch.data_ptr(), eps, min_delta)
    if rc:
        cuda_build.check("ppr_sweep_finalize", rc, "sweep_finalize")
    finalize_launches += 1
