"""Build, load and call the native host engines: the libsvm parser and
the batch localizer.

The port's copy of ``difacto_tpu/data/_native.py`` (reference: dmlc-core's
``libsvm_parser.h`` and difacto's ``src/data/localizer.h``, both native
C++ on the worker CPUs). The sources are the port's own,
``difacto_tpu_torch/csrc/host/{libsvm_parser,localizer}.cpp``. On first
use they are compiled by ``g++`` into one shared library under
``build/host_native/<hash>/`` beside the package (git-ignored), keyed by a
hash of the sources and the flags, as ops/cuda.py builds the CUDA kernels;
``ctypes`` loads it. Nothing is built at import.

Where the library cannot be built (no ``g++``), the callers keep the JAX
package's rule (its ``data/build_ext.py`` is optional): they run their
NumPy engines, which give the same arrays. :data:`RUNS` counts which
engine each call took and :func:`build_error` says why the native one
was not there, so that a run can show which engine it used.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

HOST_SRC = Path(__file__).resolve().parent.parent / "csrc" / "host"
SOURCES = ("libsvm_parser.cpp", "localizer.cpp")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "host_native"
# no -march=native: a library built on one host must run on another that
# loads the same build directory
CFLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]
LIB_NAME = "libdifacto_host.so"

# engine runs: the native parse and localize, and the NumPy engines that
# take their place (parse) or stand beside them past the lookup-table cap
# (the searchsorted localize, data/prep.py)
RUNS = {"parse_native": 0, "parse_numpy": 0, "localize_native": 0,
        "localize_searchsorted": 0}

log = logging.getLogger("difacto_tpu_torch")

_lock = threading.Lock()        # RUNS
_load_lock = threading.Lock()   # the first build and load
_lib: ctypes.CDLL | None = None
_error: str | None = None
_tried = False


def count(engine: str) -> None:
    """Add one run of ``engine`` to :data:`RUNS` (the prep workers call
    this from several threads)."""
    with _lock:
        RUNS[engine] += 1


def reset_runs() -> None:
    with _lock:
        for k in RUNS:
            RUNS[k] = 0


def _digest() -> str:
    h = hashlib.sha256(" ".join(CFLAGS + [platform.machine()]).encode())
    for name in SOURCES:
        h.update((HOST_SRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if none exists for these sources; returns its
    path. Raises RuntimeError when ``g++`` is missing or fails."""
    lib = BUILD_ROOT / _digest() / LIB_NAME
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native host engines are "
                           "built on first use")
    lib.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        tmp_lib = Path(tmp) / LIB_NAME
        r = subprocess.run(
            [cxx, *CFLAGS, *(str(HOST_SRC / s) for s in SOURCES),
             "-o", str(tmp_lib)],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on the native host engines:\n"
                               f"{r.stderr}")
        os.replace(tmp_lib, lib)  # atomic: concurrent builders agree
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _error, _tried
    with _load_lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            _error = str(e)
            log.info("native host engines unavailable, the NumPy engines "
                     "run instead: %s", _error)
            return None
        lib.dft_parse_libsvm.restype = ctypes.c_int
        lib.dft_parse_libsvm.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,          # data, len
            ctypes.POINTER(ctypes.c_int64),           # out: num_rows
            ctypes.POINTER(ctypes.c_int64),           # out: nnz
            ctypes.POINTER(ctypes.c_void_p),          # out: labels (f32)
            ctypes.POINTER(ctypes.c_void_p),          # out: indptr (i64)
            ctypes.POINTER(ctypes.c_void_p),          # out: indices (u64)
            ctypes.POINTER(ctypes.c_void_p),          # out: values (f32)
            ctypes.c_int,                             # nthreads
        ]
        lib.dft_free.restype = None
        lib.dft_free.argtypes = [ctypes.c_void_p]
        lib.dft_localize.restype = ctypes.c_int
        lib.dft_localize.argtypes = [
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # ids
            ctypes.c_int64,                                          # n
            ctypes.c_int32,                                    # num_rows
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # inv
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),  # uids
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),  # counts
            ctypes.POINTER(ctypes.c_int64),                   # n_unique
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """True when the library is built and loaded (built here on the first
    call)."""
    return _load() is not None


def build_error() -> str | None:
    """Why the library is not there, once :func:`available` said so."""
    return _error


def localize(keys: np.ndarray, num_rows: int):
    """Native radix dedup + inverse. ``keys`` i32 [n], negatives =
    padding. Returns (uids [nu] i32 sorted, the sentinel ``num_rows``
    last when pads exist, inv [n] i32, counts [nu] i64): the NumPy
    engine's arrays (data/prep.py::_localize_numpy)."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native localizer unavailable: {_error}")
    n = keys.shape[0]
    inv = np.empty(n, np.int32)
    uids = np.empty(n, np.int32)
    counts = np.empty(n, np.int64)
    nu = ctypes.c_int64()
    rc = lib.dft_localize(np.ascontiguousarray(keys, np.int32), n, num_rows,
                          inv, uids, counts, ctypes.byref(nu))
    if rc != 0:
        raise RuntimeError(f"dft_localize failed (code {rc})")
    u = nu.value
    return uids[:u], inv, counts[:u]


def parse_libsvm(data: bytes, nthreads: int = 0):
    """Native libsvm parse of one chunk into a RowBlock: the arrays of
    data/libsvm.py::parse_libsvm_numpy. ``nthreads`` 0 is one thread per
    core, at most 8."""
    from .libsvm import RowBlock

    lib = _load()
    if lib is None:
        raise RuntimeError(f"native parser unavailable: {_error}")
    nrows, nnz = ctypes.c_int64(), ctypes.c_int64()
    ptrs = [ctypes.c_void_p() for _ in range(4)]
    if nthreads <= 0:
        nthreads = min(os.cpu_count() or 1, 8)
    rc = lib.dft_parse_libsvm(data, len(data), ctypes.byref(nrows),
                              ctypes.byref(nnz),
                              *(ctypes.byref(p) for p in ptrs), nthreads)
    if rc != 0:
        raise ValueError(f"malformed libsvm input (native parser code {rc})")
    n, m = nrows.value, nnz.value

    def take(p, ctype, size):
        return np.ctypeslib.as_array(
            ctypes.cast(p, ctypes.POINTER(ctype)), (size,)).copy()

    try:
        return RowBlock(take(ptrs[0], ctypes.c_float, n),
                        take(ptrs[1], ctypes.c_int64, n + 1),
                        take(ptrs[2], ctypes.c_uint64, m),
                        take(ptrs[3], ctypes.c_float, m))
    finally:
        for p in ptrs:
            lib.dft_free(p)
