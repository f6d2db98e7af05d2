"""ctypes binding for the native C++ graph builder — port of
``ppr_tpu/native/__init__.py``.

``graph_builder.cpp`` (a copy of the JAX package's) holds a counting-sort
CSR builder, an edge-list parser and a Walker alias-table builder. It is
compiled at first use with ``g++ -O3 -shared -fPIC`` into
``build/ppr_tpu_torch/`` beside the package; the file name carries a hash
of the source and the flags, so an edited source rebuilds. No
``-march=native``: the library is built on the machine that runs it, and
its arithmetic must not depend on that machine's instruction set.

Where no compiler is found, or the build fails, every function here
returns ``None`` and the callers (``graph/csr.py``, ``graph/io.py``) take
their numpy paths, which give the same arrays. :func:`available` says which
path a process takes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "graph_builder.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ppr_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lib_tried = False


def _compile_lib() -> Path | None:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"graph_builder-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded library, built first if needed; ``None`` without a
    compiler."""
    global _lib, _lib_tried
    if _lib is None and not _lib_tried:
        _lib_tried = True
        so = _compile_lib()
        if so is not None:
            lib = ctypes.CDLL(str(so))
            lib.ppr_build_csr.restype = ctypes.c_int
            lib.ppr_parse_edge_list.restype = ctypes.c_int64
            lib.ppr_build_alias.restype = ctypes.c_int
            _lib = lib
    return _lib


def available() -> bool:
    """Whether the native builder is in use in this process (else the
    graphs are built by the numpy paths)."""
    return get_lib() is not None


def _ptr(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def build_csr_native(src: np.ndarray, dst: np.ndarray, n: int, n_pad: int):
    """``(indptr, indices, sorted_src, out_deg, in_deg)``, int32, of the
    edges ``src -> dst`` sorted stably by source, or ``None`` without the
    library. Raises ``ValueError`` for an endpoint outside ``[0, n)``."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.ascontiguousarray(src, np.int64)
    dst = np.ascontiguousarray(dst, np.int64)
    m = src.shape[0]
    indptr = np.empty(n_pad + 1, np.int32)
    indices = np.empty(max(m, 1), np.int32)
    sorted_src = np.empty(max(m, 1), np.int32)
    out_deg = np.empty(n_pad, np.int32)
    in_deg = np.empty(n_pad, np.int32)
    rc = lib.ppr_build_csr(
        ctypes.c_int64(m), _ptr(src, ctypes.c_int64),
        _ptr(dst, ctypes.c_int64), ctypes.c_int64(n), ctypes.c_int64(n_pad),
        _ptr(indptr, ctypes.c_int32), _ptr(indices, ctypes.c_int32),
        _ptr(sorted_src, ctypes.c_int32),
        _ptr(out_deg, ctypes.c_int32), _ptr(in_deg, ctypes.c_int32),
    )
    if rc != 0:
        raise ValueError("edge endpoint out of range")
    return indptr, indices[:m], sorted_src[:m], out_deg, in_deg


def build_alias_native(indptr: np.ndarray, coef: np.ndarray, m_pad: int):
    """Walker alias tables over the CSR segments of ``indptr``, ``(prob
    f32[m_pad], other int32[m_pad])``, or ``None`` without the library.
    ``coef`` is read as float32, as the JAX package's binding does."""
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, np.int32)
    coef = np.ascontiguousarray(coef, np.float32)
    prob = np.ones(m_pad, np.float32)
    other = np.arange(m_pad, dtype=np.int32)
    rc = lib.ppr_build_alias(
        ctypes.c_int64(indptr.shape[0] - 1),
        _ptr(indptr, ctypes.c_int32), _ptr(coef, ctypes.c_float),
        _ptr(prob, ctypes.c_float), _ptr(other, ctypes.c_int32),
    )
    if rc != 0:
        return None
    return prob, other


def parse_edge_list_native(path: str, cap: int):
    """``(src, dst)`` int64 arrays of a ``src dst`` edge-list file, or
    ``None`` without the library or when the file holds more than ``cap``
    edges."""
    lib = get_lib()
    if lib is None:
        return None
    src = np.empty(cap, np.int64)
    dst = np.empty(cap, np.int64)
    m = lib.ppr_parse_edge_list(
        str(path).encode(), ctypes.c_int64(cap),
        _ptr(src, ctypes.c_int64), _ptr(dst, ctypes.c_int64),
    )
    if m < 0:
        return None
    return src[:m], dst[:m]
