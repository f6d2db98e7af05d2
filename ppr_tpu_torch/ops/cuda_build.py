"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (its launch functions
return ``cudaGetLastError()``, and it exports ``ppr_cuda_error_string``)
and is compiled with ``nvcc`` for ``sm_90a`` into a shared library, loaded
with ``ctypes``. The
build runs at first use, into ``build/ppr_tpu_torch/`` beside the package
(the file name carries a hash of the source and flags, so an edited kernel
rebuilds). Nothing here runs at import time; a machine without ``nvcc``
fails only when a kernel is first launched.

The launch path every wrapper shares is kept short, because at the
protocol's small shapes a launch costs more on the host than on the card:
:func:`load_library` resolves each launch function and its argument types
once (``SIGNATURES``, into ``FUNCTIONS``), :func:`function` is then one
dictionary lookup, and :func:`call` passes the card's current stream (one
call into torch) and switches the current card only when the tensor lies
on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ppr_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: per library, the argument types of each function it exports besides
#: ``ppr_cuda_error_string``; each returns a CUDA error code, 0 on success
SIGNATURES = {
    "probe": {
        "ppr_probe_double": (_VP, _VP, _CI, _VP),
    },
    "dense_power": {
        "ppr_dense_power_iterations": (
            _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CF, _CF, _CI, _VP),
        "ppr_dense_pagerank_iterations": (
            _VP, _VP, _VP, _CI, _CI, _CI, _CF, _CF, _VP),
    },
    "row_gather": {
        "ppr_gather_segment_sum": (
            _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP),
        "ppr_gather_segment_sum_coef": (
            _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP),
        "ppr_row_gather": (_VP, _VP, _VP, _CI, _CI, _CI, _CI, _VP),
    },
    "sweep_pass": {
        "ppr_sweep_pre": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI,
                          _CI, _CI, _CI, _CI, _CF, _CF, _CF, _VP),
        "ppr_sweep_post": (_VP, _VP, _VP, _VP, _VP, _VP, _CI, _CI, _CI, _CI,
                           _CI, _CI, _VP),
        "ppr_sweep_finalize": (_VP, _CI, _VP, _CI, _CI, _CI, _VP, _VP, _VP,
                               _VP, _VP, _CF, _CF, _VP),
    },
}
_LIBRARY_OF = {symbol: name for name, symbols in SIGNATURES.items()
               for symbol in symbols}

_LIBS: dict[str, ctypes.CDLL] = {}
#: every function of ``SIGNATURES`` whose library is loaded, by symbol
FUNCTIONS: dict[str, "ctypes._CFuncPtr"] = {}
#: per kernel: (build seconds, compiler output) of this process's build;
#: (0.0, "") when a library built earlier was reused
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``csrc/<name>.cu`` library, built first if needed."""
    if name in _LIBS:
        return _LIBS[name]
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"{name}-{digest}.so"
    if so.exists():
        BUILD_INFO[name] = (0.0, "")
    else:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}"
                               f"\n{proc.stderr}")
        os.replace(tmp, so)
        BUILD_INFO[name] = (time.perf_counter() - t0,
                            proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(so))
    lib.ppr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.ppr_cuda_error_string.restype = ctypes.c_char_p
    bind(lib, name)
    _LIBS[name] = lib
    FUNCTIONS.update({symbol: getattr(lib, symbol)
                      for symbol in SIGNATURES[name]})
    return lib


def bind(lib: ctypes.CDLL, name: str) -> None:
    """Give the functions of ``SIGNATURES[name]`` in ``lib`` their types."""
    for symbol, argtypes in SIGNATURES[name].items():
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int


def function(symbol: str):
    """The launch function ``symbol``; its library is built and loaded at
    the first call."""
    fn = FUNCTIONS.get(symbol)
    if fn is None:
        load_library(_LIBRARY_OF[symbol])
        fn = FUNCTIONS[symbol]
    return fn


def call(fn, index: int, *args) -> int:
    """``fn(*args, stream)`` with card ``index``'s current stream as the
    last argument; returns the function's CUDA error code. It never
    synchronises, so a wrapper that allocates only through torch stays
    capturable in a CUDA graph."""
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def check(symbol: str, rc: int, what: str) -> None:
    """Raise when the launch function ``symbol`` returned a CUDA error
    code."""
    if rc != 0:
        msg = _LIBS[_LIBRARY_OF[symbol]].ppr_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
