"""The rows a cell trains on: made from ``--seed`` on the device, written in
the configuration's data format to ``memory://``.

One general generator reads a traffic file (``fmbench/traffic/<name>.json``)
of parameters:

* ``batch_size`` rows a step, ``nnz`` slots a row, ``batches`` in the replay
  set (one part file a batch, so that batch ``i`` is rows
  ``[i * batch_size, (i + 1) * batch_size)`` in file order);
* ``ids``: how the raw feature ids are drawn:
  ``hashed_zipf`` (Zipf(``zipf_a``) values times the golden-ratio
  constant modulo ``2**hash_bits``, the repository's flagship draw), ``uniform`` (uniform
  over ``[0, 2**uniform_bits)``), or ``ctr_fields`` (one value a field,
  Zipf(``zipf_a``)-popular within ``vocab_per_field``, the repository's
  synthetic Criteo rows, optionally with the slots shuffled so that the
  field is not the slot position);
* ``labels``: ``coin`` (a fair coin a row) or ``fm_truth`` (drawn from a
  ground-truth FM of ``k_true`` factors over ``2**truth_bits`` rows made
  from ``truth_seed``).

Every value is 1 (one-hot categorical rows). The program receives only the
files; the reference (fmbench/reference.py) receives the same rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

GOLDEN = 0x9E3779B97F4A7C15


@dataclass
class Rows:
    """The replay set, on the device: raw ids i64 [R, L] (non-negative),
    labels f32 [R] in {0, 1}, fields i32 [R, L] or None."""

    ids: torch.Tensor
    labels: torch.Tensor
    fields: torch.Tensor | None
    batch_size: int

    @property
    def num_batches(self) -> int:
        return self.ids.shape[0] // self.batch_size

    def batch(self, i: int) -> "Rows":
        s = slice(i * self.batch_size, (i + 1) * self.batch_size)
        return Rows(self.ids[s], self.labels[s],
                    None if self.fields is None else self.fields[s],
                    self.batch_size)


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed & ((1 << 63) - 1))
    return g


def zipf(g: torch.Generator, a: float, n: int, device) -> torch.Tensor:
    """``n`` draws of Zipf(a) (i64, >= 1) by the rejection method numpy's
    ``Generator.zipf`` uses, vectorised: candidates are drawn in rounds
    until ``n`` are accepted; candidates past 2**63 are rejected, as numpy
    rejects those past its integer range."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    filled = 0
    while filled < n:
        m = (n - filled) * 9 // 8 + 1024
        u = 1.0 - torch.rand(m, generator=g, device=device,
                             dtype=torch.float64)
        v = torch.rand(m, generator=g, device=device, dtype=torch.float64)
        x = torch.floor(u.pow(-1.0 / am1))
        t = (1.0 + 1.0 / x).pow(am1)
        ok = (x >= 1.0) & (x < 2.0 ** 63) & (
            v * x * (t - 1.0) / (b - 1.0) <= t / b)
        got = x[ok][: n - filled].to(torch.int64)
        out[filled:filled + got.numel()] = got
        filled += got.numel()
    return out


def _raw_ids(t: dict, g, rows: int, device):
    """(raw ids i64 [rows, L], fields i32 [rows, L] or None)."""
    L = t["nnz"]
    kind = t["ids"]
    if kind == "hashed_zipf":
        mask = (1 << t["hash_bits"]) - 1
        z = zipf(g, t["zipf_a"], rows * L, device)
        # the low bits of z * multiplier (mod 2**64) depend only on the low
        # bits of both factors, so the product stays within int64 here
        ids = ((z & mask) * (GOLDEN & mask)) & mask
        return ids.reshape(rows, L), None
    if kind == "uniform":
        ids = torch.randint(0, 1 << t["uniform_bits"], (rows, L),
                            generator=g, device=device, dtype=torch.int64)
        return ids, None
    if kind == "ctr_fields":
        vocab = t["vocab_per_field"]
        raw = zipf(g, t["zipf_a"], rows * L, device).reshape(rows, L)
        fv = torch.clamp(raw - 1, max=vocab - 1)
        ids = torch.arange(L, device=device, dtype=torch.int64) * vocab + fv
        fields = torch.arange(L, device=device,
                              dtype=torch.int32).expand(rows, L)
        return ids, fields
    raise ValueError(f"unknown id draw {kind!r}")


def _fm_truth_labels(t: dict, g, ids: torch.Tensor) -> torch.Tensor:
    """Labels drawn from a ground-truth FM over hashed truth rows, centred
    on the set's median margin (so about half the rows click)."""
    truth_n = 1 << t["truth_bits"]
    rng = np.random.default_rng(t["truth_seed"])
    dev = ids.device
    w_true = torch.as_tensor(
        rng.normal(0, t["w_scale"], truth_n).astype(np.float32), device=dev)
    v_true = torch.as_tensor(
        rng.normal(0, t["v_scale"], (truth_n, t["k_true"])).astype(
            np.float32), device=dev)
    h = ids % truth_n
    lin = w_true[h].sum(dim=1)
    vh = v_true[h]
    s = vh.sum(dim=1)
    fm = 0.5 * ((s * s).sum(dim=1) - (vh * vh).sum(dim=(1, 2)))
    m = lin + fm
    srt = torch.sort(m).values
    n = srt.numel()
    med = srt[n // 2] if n % 2 else 0.5 * (srt[n // 2 - 1] + srt[n // 2])
    p = torch.sigmoid(m - med)
    return (torch.rand(n, generator=g, device=dev) < p).to(torch.float32)


def make_rows(t: dict, seed: int, device) -> Rows:
    """The replay set of traffic ``t`` for ``seed``: the same seed gives
    the same rows on the same kind of device."""
    rows = t["batch_size"] * t["batches"]
    g = generator(seed, device)
    ids, fields = _raw_ids(t, g, rows, device)
    lab = t["labels"]
    if lab == "coin":
        labels = (torch.rand(rows, generator=g, device=device) > 0.5).to(
            torch.float32)
    elif lab == "fm_truth":
        labels = _fm_truth_labels(t, g, ids)
    else:
        raise ValueError(f"unknown labels {lab!r}")
    if t.get("shuffle_slots") and fields is not None:
        perm = torch.rand(ids.shape, generator=g, device=device).argsort(dim=1)
        ids = torch.gather(ids, 1, perm)
        fields = torch.gather(fields, 1, perm)
    return Rows(ids, labels, fields, t["batch_size"])


# -- writers: one part file a batch, in the configuration's data format ------


def _digits(x: torch.Tensor, width: int) -> torch.Tensor:
    """u8 [..., width] ASCII decimal digits of non-negative ``x``, zero
    padded (the parsers read leading zeros as the same number)."""
    out = torch.empty((*x.shape, width), dtype=torch.uint8, device=x.device)
    v = x.clone()
    for p in range(width - 1, -1, -1):
        out[..., p] = (v % 10 + 48).to(torch.uint8)
        v = torch.div(v, 10, rounding_mode="floor")
    return out


def _libffm(b: Rows) -> bytes:
    """libffm text (``label field:id:1 ...``) of one batch."""
    ids = b.ids
    n, L = ids.shape
    idw = max(1, len(str(int(ids.max()))))
    fw = max(1, len(str(int(b.fields.max()))))

    def const(*codes):
        return torch.tensor(codes, dtype=torch.uint8,
                            device=ids.device).expand(n, L, len(codes))

    tok = torch.cat([const(32), _digits(b.fields.to(torch.int64), fw),
                     const(58), _digits(ids, idw), const(58, 49)],
                    dim=2).reshape(n, -1)
    label = (b.labels.to(torch.uint8) + 48)[:, None]
    nl = torch.full((n, 1), 10, dtype=torch.uint8, device=ids.device)
    return torch.cat([label, tok, nl], dim=1).cpu().numpy().tobytes()


def write_parts(rows: Rows, data_format: str, prefix: str) -> str:
    """Write the replay set as one part a batch under ``prefix`` (a
    ``memory://`` URI) in ``data_format`` (``csr`` or ``libffm``) and
    return the glob the config's ``data_in`` takes."""
    import fsspec

    fs, root = fsspec.core.url_to_fs(prefix)
    ext = {"csr": "npz", "libffm": "ffm"}[data_format]
    for i in range(rows.num_batches):
        b = rows.batch(i)
        with fs.open(f"{root}/train.part{i:05d}.{ext}", "wb") as f:
            if data_format == "csr":
                n, L = b.ids.shape
                np.savez(f, labels=b.labels.cpu().numpy(),
                         indptr=np.arange(n + 1, dtype=np.int64) * L,
                         indices=b.ids.cpu().numpy().astype(np.uint64),
                         values=np.ones(n * L, np.float32))
            else:
                f.write(_libffm(b))
    return f"{prefix}/train.part*.{ext}"


def remove_parts(prefix: str) -> None:
    import fsspec

    fs, root = fsspec.core.url_to_fs(prefix)
    if fs.exists(root):
        fs.rm(root, recursive=True)


def distinct_rows(rows: Rows, num_bits: int) -> list[int]:
    """Distinct table rows of each batch under the program's hashing (for
    the byte counts; the reference hashes the same way, fmbench/reference.py
    :func:`hash_rows`), counted where the rows lie."""
    from .reference import hash_rows

    return [int(torch.unique(torch.as_tensor(
        hash_rows(rows.batch(i).ids.cpu().numpy(), num_bits),
        device=rows.ids.device)).numel())
            for i in range(rows.num_batches)]
