"""Build, load and count the hand-written CUDA kernels.

The sources under ``difacto_tpu_torch/csrc/`` have a plain C interface.
On first use they are compiled for Hopper (``sm_90a``) by ``nvcc``, one
process per source started together, and linked into one shared library
under ``build/torch_kernels/<hash>/`` beside the package (git-ignored),
keyed by a hash of the sources, their headers and the flags; ``ctypes``
loads it. Every pointer and the stream go through ``ctypes.c_void_p``;
each C entry returns ``cudaGetLastError()`` and :func:`check` raises if
it is not 0.

Nothing here runs at import: the CPU tests import every module, on hosts
that may have no ``nvcc``.

``LAUNCHES`` counts kernel launches per wrapper (ops/pair_sweep.py,
ops/segsum.py, ops/sweep_ms.py and the probes' wrappers under probes/):
each wrapper adds one where it launches its kernel and nowhere else, so
a run can show which kernels its path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("pull_pairs.cu", "apply_pairs.cu", "segsum.cu", "sweep_pull.cu",
           "sweep_apply.cu", "planar_apply.cu", "packed_pairs.cu",
           "bisect_apply.cu", "slot_accum.cu", "rowmajor_pairs.cu",
           "rowmajor_sweep.cu", "segsum_tiles.cu", "seg_merge.cu")
HEADERS = ("table_update.cuh", "sweep.cuh", "pair_runs.cuh", "rowmajor.cuh")
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
# --fmad=false: no fused multiply-adds, so each kernel rounds exactly as
# its plain PyTorch version (separate elementwise ops) does
CFLAGS = ["-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC"]
LIB_NAME = "libdifacto_torch_kernels.so"

LAUNCHES = {"pull_pairs": 0, "apply_pairs": 0, "segsum_sorted": 0,
            "sweep_pull": 0, "sweep_apply": 0, "apply_pairs2": 0,
            "pull_packed": 0, "apply_packed": 0, "bisect_w": 0,
            "bisect_ftrl4": 0, "slot_accum": 0, "bisect_rowscan": 0,
            "pull_rowmajor": 0, "apply_rowmajor": 0,
            "sweep_pull_rowmajor": 0, "sweep_apply_rowmajor": 0,
            "segsum_chunks": 0, "segsum_rows": 0, "apply_pairs_segs": 0,
            "apply_rowmajor_segs": 0, "merge_segments": 0,
            "apply_pairs_segs_search": 0, "apply_rowmajor_segs_search": 0}

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    # w, cnt, V, uids, out, n, k, u, v_threshold, stream
    "dft_pull_pairs": [_VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _F, _VP],
    # w, z, n, cnt, V, nV, uids, payload, N, K, U,
    # lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2, V_threshold,
    # tail_feature_filter, w_updater, V_updater, stream
    "dft_apply_pairs": [_VP] * 8 + [_LL, _I, _I] + [_F] * 8
    + [_I, _I, _I, _VP],
    # payT, lanes, out, head, tail, seg_lo, seg_hi, pp, blp, ub, stream
    "dft_segsum_sorted": [_VP] * 7 + [_I, _I, _I, _VP],
    # w, cnt, V, sid, offsets, out, N, K, nnz, S, nb, R, V_threshold, stream
    "dft_sweep_pull": [_VP] * 6 + [_LL] + [_I] * 5 + [_F, _VP],
    # w, z, n, cnt, V, nV, sid, payload, offsets, N, K, nnz, S, nb, R,
    # lr_eta, lr_beta, l1, l2, V_lr_eta, V_lr_beta, V_l2, V_threshold,
    # tail_feature_filter, w_updater, V_updater, stream
    "dft_sweep_apply": [_VP] * 9 + [_LL] + [_I] * 5 + [_F] * 8
    + [_I, _I, _I, _VP],
    # as dft_apply_pairs with the segment length C after U
    "dft_apply_pairs_segs": [_VP] * 8 + [_LL, _I, _I, _I] + [_F] * 8
    + [_I, _I, _I, _VP],
    # as dft_apply_pairs, then the stage flags before the stream
    "dft_apply_pairs2": [_VP] * 8 + [_LL, _I, _I] + [_F] * 8
    + [_I, _I, _I, _I, _VP],
    # A, uids, out, N, K, U, V_threshold, flags, stream
    "dft_pull_packed": [_VP] * 3 + [_LL, _I, _I, _F, _I, _VP],
    # A, B, uids, payload, N, K, U, then as dft_apply_pairs2 from lr_eta on
    "dft_apply_packed": [_VP] * 4 + [_LL, _I, _I] + [_F] * 8
    + [_I, _I, _I, _I, _VP],
    # sid, pay, w, w_out, N, nnz, block_rows, variant, stream
    "dft_bisect_w": [_VP] * 4 + [_LL, _I, _I, _I, _VP],
    # sid, pay, w, z, n, c, w_out, z_out, n_out, c_out, N, nnz, block_rows,
    # stream
    "dft_bisect_ftrl4": [_VP] * 10 + [_LL, _I, _I, _VP],
    # sid, pay, out, head, tail, nslots, num_rows, stream
    "dft_slot_accum": [_VP] * 5 + [_I, _I, _VP],
    # tbl, uids, out, N, K, U, V_threshold, vec, stream
    "dft_pull_rowmajor": [_VP] * 3 + [_LL, _I, _I, _F, _I, _VP],
    # tbl, uids, payload, N, K, U, then as dft_apply_pairs from lr_eta to
    # V_updater, vec, stream
    "dft_apply_rowmajor": [_VP] * 3 + [_LL, _I, _I] + [_F] * 8
    + [_I, _I, _I, _I, _VP],
    # as dft_apply_rowmajor with the segment length C after U
    "dft_apply_rowmajor_segs": [_VP] * 3 + [_LL, _I, _I, _I] + [_F] * 8
    + [_I, _I, _I, _I, _VP],
    # tbl, sid, offsets, out, N, K, nnz, S, nb, R, V_threshold, vec, stream
    "dft_sweep_pull_rowmajor": [_VP] * 4 + [_LL] + [_I] * 5 + [_F, _I, _VP],
    # tbl, sid, payload, offsets, N, K, nnz, S, nb, R, then as
    # dft_apply_pairs from lr_eta to V_updater, vec, stream
    "dft_sweep_apply_rowmajor": [_VP] * 4 + [_LL] + [_I] * 5 + [_F] * 8
    + [_I, _I, _I, _I, _VP],
    # payT (or pay), lanes, out, head, tail, pp, blp, ub, stream
    "dft_segsum_tiles": [_VP] * 5 + [_I] * 3 + [_VP],
    "dft_segsum_rows": [_VP] * 5 + [_I] * 3 + [_VP],
    # uids, payload, merged uids, merged payload, U, C, payload rows, stream
    "dft_merge_segments": [_VP] * 4 + [_I] * 3 + [_VP],
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "where the card is, on first use")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(ARCH + CFLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> tuple[Path, float, str]:
    """Compile the kernels if no library for these sources exists.
    Returns (library path, seconds spent building, compiler output);
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    lib = BUILD_ROOT / _digest() / LIB_NAME
    if lib.exists() and not verbose:
        return lib, 0.0, ""
    nvcc = _nvcc()
    t0 = time.perf_counter()
    lib.parent.mkdir(parents=True, exist_ok=True)
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (name + ".o")
            cmd = [nvcc, *ARCH, *CFLAGS, *extra, "-c", str(CSRC / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        for name, _, p in procs:
            out, _ = p.communicate()
            log.append(f"--- {name}\n{out}")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_lib),
             *(str(o) for _, o, _ in procs)],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stderr}")
        os.replace(tmp_lib, lib)  # atomic: concurrent builders agree
    return lib, time.perf_counter() - t0, "\n".join(log)


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        path, _, _ = build()
        lib = ctypes.CDLL(str(path))
        for fn, args in _SIGNATURES.items():
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
        lib.dft_error_string.argtypes = [ctypes.c_int]
        lib.dft_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = library().dft_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({rc})")


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raw_stream(device: torch.device) -> int:
    """:func:`stream` without building a ``torch.cuda.Stream`` object, for
    the wrappers of microsecond kernels, whose time by CUDA events is the
    host's time to enqueue them."""
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if get is None:
        return stream(device)
    index = device.index
    return get(torch.cuda.current_device() if index is None else index)


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            shape: tuple | None, device: torch.device) -> None:
    """Check what a kernel takes: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
