"""Bisection of the whole-table sweep apply's cost on the card.

Counterpart of ``scripts/bisect_apply.py``: the sweep apply stripped to
one leaf (``bisect_w``) or to FTRL on (w, z, n) plus a count
(``bisect_ftrl4``), over N = 2^20 table rows, U = 100,000 sorted unique
slot ids (padded with the sentinel N to a whole 1024-slot window plus one,
as the script pads) and 8 payload rows, in table blocks of ``block_rows``
rows (csrc/bisect_apply.cu).

    python -m difacto_tpu_torch.probes.bisect_apply <variant> [block_rows]

Variants: ``highest`` (the default) and ``default`` are the whole
``bisect_w`` — the script's two matmul precisions are one function here,
where no matmul runs and nothing rounds to bf16. It is a sparse kernel: a
block copies its rows and then visits only the slots of its slice of the
stream. ``scanonly`` (the slice searches and the copy, no stream read)
and ``loadonly`` (the copy and the stream read, no add) isolate the stages
of THIS kernel and return ``w`` unchanged, in place of the script's
``nodma``/``dmaonly``/``selonly``, which isolate Mosaic's stages;
``rowscan`` is the whole ``bisect_w`` by the first design, in which every
table row searches the slice (the stand-in for the sweep apply's scan);
``ftrl4`` and ``ftrl4_inplace`` run ``bisect_ftrl4`` out of place and in
place (the script's ``main4(alias)``). ``n_log2=`` and ``u=`` shrink the
shapes.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import FMParam
from ..ops import cuda
from ..updaters.updater import ftrl_w
from . import common

G = 1024                    # slot window of the script: the stream's pad
N_LOG2, U, PP = 20, 100000, 8
VARIANTS = {"highest": 0, "default": 0, "scanonly": 1, "loadonly": 2,
            "rowscan": 3}
WHOLE = (0, 3)              # the variants that compute bisect_w
FTRL4 = ("ftrl4", "ftrl4_inplace")


def ftrl4_param() -> FMParam:
    """The constants of ``scripts/bisect_apply.py::kernel4``."""
    p = FMParam()
    p.lr_eta, p.lr_beta, p.l1, p.l2 = 0.01, 1.0, 1.0, 0.1
    return p


def row_sums(sid: torch.Tensor, pay: torch.Tensor, n: int) -> torch.Tensor:
    """``[rows of pay, n]``: per table row, the sum of the payload over
    the slots that name it (ids outside [0, n) name none)."""
    real = (sid >= 0) & (sid < n)
    acc = torch.zeros((pay.shape[0], n), dtype=pay.dtype, device=pay.device)
    return acc.index_add_(1, sid[real].long(), pay[:, real])


def bisect_w_plain(sid, pay, w, variant: str = "highest") -> torch.Tensor:
    if VARIANTS[variant] not in WHOLE:
        return w.clone()  # the stage variants compute nothing
    return w + row_sums(sid, pay[:1], w.shape[0])[0]


def _check_stream(sid, pay, n, block_rows, dev):
    """``sid`` must be sorted: the kernels binary-search it. That is not
    checked (a check would cost more than these kernels); an unsorted
    stream gives wrong sums, never an access out of bounds."""
    if block_rows <= 0:
        raise ValueError(f"block_rows {block_rows} must be positive")
    cuda.require(sid, "sid", torch.int32, (sid.shape[0],), dev)
    cuda.require(pay, "pay", torch.float32, (pay.shape[0], sid.shape[0]), dev)


_bisect_w_entry = None      # the ctypes entry, resolved at the first launch


def bisect_w(sid: torch.Tensor, pay: torch.Tensor, w: torch.Tensor,
             variant: str = "highest", block_rows: int = 1024) -> torch.Tensor:
    """``w_o[r] = w[r] + sum of pay[0, j] over sid[j] == r`` for every
    table row, out of place; ``sid`` i32 sorted, ``pay`` f32 [PP, nnz].
    The stage variants return ``w`` (a finite payload assumed);
    ``rowscan`` computes the same function by the first kernel design.

    The kernel takes microseconds, so the argument checks are one
    expression that touches no device memory; only a failing call pays
    for the check that names the fault."""
    global _bisect_w_entry
    code = VARIANTS.get(variant)
    if code is None:
        raise ValueError(f"variant {variant!r} not in {sorted(VARIANTS)}")
    dev = w.device
    if dev.type == "cpu":
        return bisect_w_plain(sid, pay, w, variant)
    n, nnz = w.shape[0], sid.shape[0]
    if not (sid.device == dev and pay.device == dev and block_rows > 0
            and sid.dtype is torch.int32 and pay.dtype is torch.float32
            and w.dtype is torch.float32 and w.dim() == 1 and sid.dim() == 1
            and pay.dim() == 2 and pay.shape[1] == nnz and pay.shape[0] > 0
            and sid.is_contiguous() and pay.is_contiguous()
            and w.is_contiguous()):
        _check_stream(sid, pay, n, block_rows, dev)
        cuda.require(w, "w", torch.float32, (n,), dev)
        raise ValueError("bisect_w reads payload row 0: pay has no row")
    out = torch.empty_like(w)
    if _bisect_w_entry is None:
        _bisect_w_entry = cuda.library().dft_bisect_w
    rc = _bisect_w_entry(sid.data_ptr(), pay.data_ptr(), w.data_ptr(),
                         out.data_ptr(), n, nnz, block_rows, code,
                         cuda.raw_stream(dev))
    if rc:
        cuda.check(rc, "bisect_w")
    cuda.LAUNCHES["bisect_rowscan" if code == 3 else "bisect_w"] += 1
    return out


def bisect_ftrl4_plain(sid, pay, w, z, n, c, inplace: bool = False):
    acc = row_sums(sid, pay[:3], w.shape[0])
    w_new, z_new, n_new = ftrl_w(acc[0], w, z, n, ftrl4_param())
    touch = acc[1] != 0
    outs = (torch.where(touch, w_new, w), torch.where(touch, z_new, z),
            torch.where(touch, n_new, n), c + acc[2])
    if not inplace:
        return outs
    for dst, src in zip((w, z, n, c), outs):
        dst.copy_(src)
    return w, z, n, c


def bisect_ftrl4(sid: torch.Tensor, pay: torch.Tensor, w: torch.Tensor,
                 z: torch.Tensor, n: torch.Tensor, c: torch.Tensor,
                 inplace: bool = False, block_rows: int = 1024):
    """Per table row the sums g, t, a of payload rows 0, 1, 2 over its
    slots; FTRL (lr_eta 0.01, lr_beta 1, l1 1, l2 0.1) on (w, z, n) with
    gradient g where t != 0; ``c + a``. Returns the four new leaves: fresh
    tensors, or with ``inplace`` the inputs themselves, updated."""
    if w.device.type == "cpu":
        return bisect_ftrl4_plain(sid, pay, w, z, n, c, inplace)
    dev, rows = w.device, w.shape[0]
    _check_stream(sid, pay, rows, block_rows, dev)
    if pay.shape[0] < 3:
        raise ValueError("bisect_ftrl4 reads payload rows 0, 1 and 2")
    ins = (w, z, n, c)
    for name, t in zip("wznc", ins):
        cuda.require(t, name, torch.float32, (rows,), dev)
    outs = ins if inplace else tuple(torch.empty_like(t) for t in ins)
    rc = cuda.library().dft_bisect_ftrl4(
        sid.data_ptr(), pay.data_ptr(), *(t.data_ptr() for t in ins),
        *(t.data_ptr() for t in outs), rows, sid.shape[0], block_rows,
        cuda.stream(dev))
    cuda.check(rc, "bisect_ftrl4")
    cuda.LAUNCHES["bisect_ftrl4"] += 1
    return outs


def make_stream(rng, n: int, u: int, dev):
    """The script's inputs: ``u`` sorted unique ids of [0, n) padded with
    the sentinel ``n``, and a normal payload [PP, u + pad]."""
    sid = np.sort(rng.choice(n, size=u, replace=False)).astype(np.int32)
    pad = G + (-u) % G
    sid_p = np.concatenate([sid, np.full(pad, n, np.int32)])
    pay = rng.normal(size=(PP, u + pad)).astype(np.float32)
    return torch.from_numpy(sid_p).to(dev), torch.from_numpy(pay).to(dev)


def main4(alias: bool, block_rows: int = 1024, device=None,
          n_log2: int = N_LOG2, u: int = U) -> int:
    """``bisect_ftrl4`` with (``alias``) or without in-place state."""
    dev = common.start("bisect_apply", device)
    n = 1 << n_log2
    sid, pay = make_stream(np.random.default_rng(0), n, u, dev)
    st = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(4)]
    print(f"4state alias={alias} br={block_rows}: N 2^{n_log2}, {u} ids: "
          + _both_times(lambda: bisect_ftrl4(sid, pay, *st, inplace=alias,
                                             block_rows=block_rows), dev),
          flush=True)
    return 0


def _both_times(fn, dev) -> str:
    """These kernels take microseconds: the time by CUDA events is the
    host's enqueue rate, so the kernel's own time stands beside it."""
    return (f"{common.fmt_ms(common.time_ms(fn, dev))} by events, "
            f"{common.fmt_ms(common.time_ms(fn, dev, timer=common.kernel_ms))}"
            " of kernel time")


def main(argv=None, device=None) -> int:
    words, o = common.parse_args(argv, dict(n_log2=N_LOG2, u=U))
    variant = words[0] if words else "highest"
    br = int(words[1]) if len(words) > 1 else 1024
    if variant in FTRL4:
        return main4(variant == "ftrl4_inplace", br, device, o["n_log2"],
                     o["u"])
    if variant not in VARIANTS:
        raise SystemExit(
            f"unknown variant {variant!r}: one of {sorted(VARIANTS)} or "
            f"{FTRL4} (nodma, dmaonly and selonly isolate stages of the TPU "
            "kernel; scanonly and loadonly isolate this one's, rowscan is "
            "its first design)")
    dev = common.start("bisect_apply", device)
    n = 1 << o["n_log2"]
    sid, pay = make_stream(np.random.default_rng(0), n, o["u"], dev)
    w = torch.zeros(n, dtype=torch.float32, device=dev)
    times = _both_times(lambda: bisect_w(sid, pay, w, variant, br), dev)
    note = (" (highest and default are one function: no matmul, no bf16 "
            "passes)" if VARIANTS[variant] == 0 else "")
    if dev.type == "cuda" and VARIANTS[variant] in WHOLE:
        real = int((sid < n).sum())
        idx, pay0 = sid[:real].long(), pay[0, :real].contiguous()
        times += ("; w.index_add on the same inputs: "
                  + _both_times(lambda: w.index_add(0, idx, pay0), dev))
    print(f"{variant} br={br}: N 2^{o['n_log2']}, {o['u']} ids: "
          f"{times}{note}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
