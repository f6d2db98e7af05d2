"""K0: the CUDA toolchain probe — port of the canary of
``ppr_tpu/ops/pallas_dense.py`` (``_CANARY_CODE``, run by
``_mosaic_canary``).

The JAX package compiles and runs a trivial Pallas kernel, ``y = 2x`` on an
f32 ``[8, 128]`` array, before it trusts its fused dense kernels. The port
keeps the probe and none of its TPU machinery (the subprocess, the timeout,
the disk cache, the ``PPR_TPU_PALLAS`` switch): :func:`ensure` builds
``csrc/probe.cu``, launches it once per process and card on a tensor of
ones, and checks that the result is exactly 2. ``ops/dense_power.py`` calls
it before its first K1 or K2 launch. The probe never turns a kernel off:
any failure raises, with nvcc's output or the CUDA error.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

SHAPE = (8, 128)

#: kernel launches in this process (reset() zeroes it)
launches = 0
#: indices of the cards probed since the last reset()
_probed: set[int] = set()


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
    if x.numel() >= 2**31:
        raise ValueError(f"x has {x.numel()} elements; the kernel takes "
                         "fewer than 2^31")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = cuda_build.load_library("probe")
    fn = lib.ppr_probe_double
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(x.data_ptr(), out.data_ptr(), x.numel(), stream)
    cuda_build.check(lib, rc, "probe")
    launches += 1
    return out


def ensure(device: torch.device) -> None:
    """Probe the CUDA card ``device`` once: build K0, launch it on a
    ``[8, 128]`` tensor of ones, wait for it, and raise unless every
    output is exactly 2."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    if index in _probed:
        return
    x = torch.ones(SHAPE, dtype=torch.float32, device=device)
    y = double(x)
    torch.cuda.synchronize(device)
    if not torch.equal(y, torch.full_like(x, 2.0)):
        raise RuntimeError(f"CUDA probe on {device}: 2 * 1 gave "
                           f"{y.unique().tolist()}")
    _probed.add(index)


def reset() -> None:
    """Zero the launch count and forget the probed cards, so that the next
    hand-kernel launch probes again. It exists for launch accounting: a
    run that counts its own launches (``chip_smoke.py``, per path) sees the
    probe that path depends on. The runtime never needs a second probe."""
    global launches
    launches = 0
    _probed.clear()
