"""K0: the CUDA toolchain probe — port of the canary of
``ppr_tpu/ops/pallas_dense.py`` (``_CANARY_CODE``, run by
``_mosaic_canary``).

The JAX package compiles and runs a trivial Pallas kernel, ``y = 2x`` on an
f32 ``[8, 128]`` array, before it trusts its fused dense kernels. The port
keeps the probe and none of its TPU machinery (the subprocess, the timeout,
the disk cache, the ``PPR_TPU_PALLAS`` switch): :func:`ensure` builds
``csrc/probe.cu``, launches it once per process and card on a tensor of
ones, and checks that the result is exactly 2. ``ops/dense_power.py`` calls
it before its first K1 or K2 launch, ``ops/row_gather.py`` before its
first launch. The probe never turns a kernel off: any failure raises, with
nvcc's output or the CUDA error.

A wrapper's test for "this card is probed" is one set lookup (``index in
probed``); only a card that is not yet probed reaches :func:`ensure`, which
waits for the card. Once a card is probed, :func:`double` and every other
wrapper of the port launch on the current stream without synchronising and
allocate only through ``torch.empty``, so they can be captured in a CUDA
graph.
"""

from __future__ import annotations

import torch

from . import cuda_build

SHAPE = (8, 128)

#: kernel launches in this process (reset() zeroes it)
launches = 0
#: indices of the cards probed since the last reset()
probed: set[int] = set()


def double_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch K0."""
    return x * 2.0


def double(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for f32 ``x``: the plain version for a CPU tensor, the
    kernel for a CUDA tensor."""
    global launches
    if x.device.type == "cpu":
        return double_ref(x)
    if not x.is_cuda:
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("x must be contiguous f32")
    n = x.numel()
    if n >= 2**31:
        raise ValueError(f"x has {n} elements; the kernel takes fewer than "
                         "2^31")
    out = torch.empty_like(x)
    if n == 0:
        return out
    rc = cuda_build.call(cuda_build.function("ppr_probe_double"),
                         x.get_device(), x.data_ptr(), out.data_ptr(), n)
    if rc:
        cuda_build.check("ppr_probe_double", rc, "probe")
    launches += 1
    return out


def ensure(device: torch.device) -> None:
    """Probe the CUDA card ``device`` once: build K0, launch it on a
    ``[8, 128]`` tensor of ones, wait for it, and raise unless every
    output is exactly 2."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index in probed:
        return
    x = torch.ones(SHAPE, dtype=torch.float32, device=device)
    y = double(x)
    torch.cuda.synchronize(device)
    if not torch.equal(y, torch.full_like(x, 2.0)):
        raise RuntimeError(f"CUDA probe on {device}: 2 * 1 gave "
                           f"{y.unique().tolist()}")
    probed.add(index)


def reset() -> None:
    """Zero the launch count and forget the probed cards, so that the next
    hand-kernel launch probes again. It exists for launch accounting: a
    run that counts its own launches (``chip_smoke.py``, per path) sees the
    probe that path depends on. The runtime never needs a second probe."""
    global launches
    launches = 0
    probed.clear()
