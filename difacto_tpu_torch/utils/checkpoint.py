"""Model checkpoint save/load, in the JAX package's interchange format.

Port of ``difacto_tpu/utils/checkpoint.py`` (reference:
``Updater::Save/Load(dmlc::Stream)``). A one-process checkpoint is
``prefix.npz`` with the planar leaves ``w, z, n, V [K, N], nV [K, N],
cnt`` plus ``prefix.meta.json`` with ``format_version`` 1, the leaf
``shapes`` and the ``epoch``/``step`` cursor for resume. Either package
loads the other's checkpoints.

A multi-process run (parallel/multihost.py) writes one file a process,
``prefix.proc{p}.npz``, holding only that process's rows of each leaf
under keys that name their global range (``w@lo:hi``, ``V@0:K,lo:hi``),
as the reference's servers each saved their key range; process 0 writes
the meta with ``sharded``, ``process_count`` and the global ``shapes``.
No process holds the whole table. The loads are topology-agnostic:
:func:`load_full` reassembles the whole table (the tools), and
:func:`load_for_store` gives a LocalStore the whole table and a
ShardedStore rank only the pieces that overlap its rows, so a file set
from P processes restores onto any other count, or one process. The table's layout is a property of a run,
not of a checkpoint: every layout is saved as the planar leaves, fetched
one ``[N]`` plane at a time (a planar copy of a 2^26-row table beside it
would be another 9.7 GB on the card), and a hot/cold state un-permuted
into canonical hash rows by the run's remap lut, so a model trained in
one layout loads into any other, and into the JAX package. A prefix may
be a remote URI (``gs://``, ``s3://``, ``memory://``, ...; data/io.py),
as in the JAX package. A sharded store's one-process run saves its
gathered table (padding rows included), as the JAX package's
one-process branch does.

:func:`state_from_numpy` and :func:`state_to_numpy` carry a state between
the two packages as NumPy arrays.

A ``loss=autoint`` state (models/autoint.py) adds its dense part to the
one-process file: the flat weights and Adam's moments under the keys
``dense_theta``, ``dense_m``, ``dense_v``, and Adam's step ``dense_step``
in the meta (:func:`read_dense`); the six leaves stay as they are.
"""

from __future__ import annotations

import contextlib
import glob as _glob
import json
import os

import numpy as np
import torch

from ..data.io import expand_uri, is_remote, open_uri
from ..parallel.multihost import process_count, process_index
from ..updaters.updater import (LEAVES, FMState, HotColdFMState,
                                PackedFMState, StackedFMState, leaf_planes)

FORMAT_VERSION = 1
# a loss=autoint state's dense part: the flat buffers saved beside the leaves
DENSE_KEYS = ("theta", "m", "v")


def state_from_numpy(arrays, device="cpu", layout: str = "planar",
                     remap: tuple | None = None):
    """A state on ``device`` from NumPy arrays, which are copied.
    ``layout="planar"``: the six planar leaves (a dict, or any object
    with the leaf attributes — a JAX FMState after ``jax.device_get``)
    give an FMState. ``layout="packed"``: the row-major table ``tbl
    [N, 4+2K]``, ``layout="stacked"``: the stacked table ``tbl
    [4+2K, N]`` (a dict, an object with ``tbl`` — a JAX PackedFMState or
    StackedFMState — or the array itself) give a PackedFMState or a
    StackedFMState. ``remap=(lut, hot_rows)``: the planar leaves, in
    canonical hash rows, give the HotColdFMState of a run with that remap
    (data/remap.py): canonical row h goes to remapped row ``lut[h]``."""
    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    get = arrays.__getitem__ if isinstance(arrays, dict) else (
        lambda k: getattr(arrays, k))
    if remap is not None:
        lut, H = remap
        leaves = {k: np.asarray(get(k), np.float32) for k in LEAVES}
        tbl = np.concatenate([leaves["w"][None], leaves["z"][None],
                              leaves["n"][None], leaves["cnt"][None],
                              leaves["V"], leaves["nV"]])
        out = np.empty_like(tbl)
        out[:, lut] = tbl
        return HotColdFMState(hot=tensor(out[:, :H]), cold=tensor(out[:, H:]))
    if layout in ("packed", "stacked"):
        tbl = arrays if isinstance(arrays, np.ndarray) else get("tbl")
        cls = PackedFMState if layout == "packed" else StackedFMState
        return cls(tbl=tensor(tbl))
    if layout != "planar":
        raise ValueError(f"layout must be planar|packed|stacked, got "
                         f"{layout!r}")
    return FMState(**{k: tensor(get(k)) for k in LEAVES})


def state_to_numpy(state, remap_lut: np.ndarray | None = None
                   ) -> dict[str, np.ndarray]:
    """The planar leaves of ``state`` (any layout) as contiguous host
    NumPy arrays: the interchange form. Fetched one ``[N]`` plane at a
    time; a HotColdFMState is reassembled and un-permuted into canonical
    hash rows by ``remap_lut`` (the run's data/remap.py lut), without
    which it raises."""
    split = isinstance(state, HotColdFMState)
    if split and remap_lut is None:
        raise ValueError("saving a hot/cold split state needs the run's "
                         "remap lut (pass remap_lut=store.hot_lut)")
    if split:
        # canonical row h lives at remapped row lut[h]
        lut = torch.as_tensor(remap_lut, device=state.device).long()
        parts = (StackedFMState(tbl=state.hot), StackedFMState(tbl=state.cold))

    def plane(name, j):
        if split:
            return torch.cat([leaf_planes(getattr(p, name))[j]
                              for p in parts]).index_select(0, lut)
        return leaf_planes(getattr(state, name))[j]

    out = {}
    for name in LEAVES:
        factors = name in ("V", "nV")
        arr = np.empty((state.k if factors else 1, state.num_rows),
                       np.float32)
        for j in range(arr.shape[0]):
            arr[j] = plane(name, j).detach().cpu().numpy()
        out[name] = arr if factors else arr[0]
    return out


# model_out/model_in accept remote URIs like data URIs (the reference wrote
# models through the same dmlc::Stream layer it read data with): every
# read and write goes through open_uri, local paths and file:// included


def _write_npz(path: str, payload: dict) -> None:
    with open_uri(path, "wb") as f:
        np.savez(f, **payload)


@contextlib.contextmanager
def _open_npz(path: str):
    with open_uri(path, "rb") as f, np.load(f) as zf:
        yield zf


def _write_text(path: str, text: str) -> None:
    with open_uri(path, "wb") as f:
        f.write(text.encode())


def _index_key(name: str, lo: int, hi: int, k: int | None) -> str:
    """'V@0:16,1024:2048': the piece's global range in each dimension
    (JAX ``_index_key``); ``k`` is the factor dimension of V and nV."""
    return name + "@" + ("" if k is None else f"0:{k},") + f"{lo}:{hi}"


def _parse_index_key(key: str) -> tuple[str, tuple[slice, ...]]:
    """Inverse of :func:`_index_key`."""
    name, idx = key.split("@")
    return name, tuple(slice(int(a), int(b)) for a, b in
                       (part.split(":") for part in idx.split(",")))


def save(path_prefix: str, state, meta: dict | None = None,
         remap_lut: np.ndarray | None = None,
         shard: tuple[int, int] | None = None) -> str:
    """Write ``state`` (any layout) as planar leaves in canonical hash
    rows (``remap_lut``: a hot/cold state's lut, which it needs).

    ``shard=(lo, num_rows)``: ``state`` holds rows ``[lo, lo + its rows)``
    of a ``num_rows``-row table, and this process writes them alone as
    ``prefix.proc{p}.npz``; process 0 writes the meta (the per-process
    layout of a multi-process run). Returns the file written."""
    if not is_remote(path_prefix):
        local = path_prefix.removeprefix("file://")
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
    host = state_to_numpy(state, remap_lut)
    full_meta = {"format_version": FORMAT_VERSION, **(meta or {})}
    dense = getattr(state, "dense", None)
    if dense is not None and shard is not None:
        raise ValueError("a loss=autoint state saves as one file (it runs "
                         "on store=local)")
    if shard is None:
        full_meta["shapes"] = {k: list(v.shape) for k, v in host.items()}
        if dense is not None:
            full_meta["dense_step"] = dense.step
            host.update({f"dense_{k}": getattr(dense, k).detach().cpu()
                         .numpy() for k in DENSE_KEYS})
        npz = path_prefix + ".npz"
        _write_npz(npz, host)
        _write_text(path_prefix + ".meta.json",
                    json.dumps(full_meta, indent=1))
        return npz
    lo, num_rows = shard
    hi = lo + host["w"].shape[0]
    if hi > num_rows:
        raise ValueError(f"rows [{lo}, {hi}) past a {num_rows}-row table")
    payload, shapes = {}, {}
    for name, arr in host.items():
        k = arr.shape[0] if arr.ndim == 2 else None
        payload[_index_key(name, lo, hi, k)] = arr
        shapes[name] = [num_rows] if k is None else [k, num_rows]
    full_meta["shapes"] = shapes
    pid = process_index()
    npz = f"{path_prefix}.proc{pid}.npz"
    _write_npz(npz, payload)
    if pid == 0:
        full_meta["sharded"] = True
        full_meta["process_count"] = process_count()
        _write_text(path_prefix + ".meta.json",
                    json.dumps(full_meta, indent=1))
    return npz


def _read_meta(path_prefix: str) -> dict:
    try:
        with open_uri(path_prefix + ".meta.json", "rb") as f:
            return json.loads(f.read().decode())
    except FileNotFoundError:
        return {}


def load(path_prefix: str) -> tuple[FMState, dict]:
    """Host (CPU) state and metadata of a single-file checkpoint (a
    per-process file set: :func:`load_full`)."""
    meta = _read_meta(path_prefix)
    if meta.get("sharded"):
        raise ValueError(f"{path_prefix} is a per-process checkpoint of "
                         f"{meta.get('process_count')} files: read it with "
                         "load_full or load_for_store")
    with _open_npz(path_prefix + ".npz") as zf:
        state = state_from_numpy({k: zf[k] for k in LEAVES})
    return state, meta


def read_dense(path_prefix: str) -> dict | None:
    """The dense part of a one-process ``loss=autoint`` checkpoint
    (``theta``, ``m``, ``v`` as NumPy arrays, ``step``), None without
    one."""
    meta = _read_meta(path_prefix)
    if "dense_step" not in meta:
        return None
    with _open_npz(path_prefix + ".npz") as zf:
        out = {k: zf[f"dense_{k}"] for k in DENSE_KEYS}
    out["step"] = int(meta["dense_step"])
    return out


def _extract_range(pieces, index: tuple[slice, ...], what: str,
                   bound: tuple[int, ...] | None = None) -> np.ndarray:
    """One target range assembled from saved (range, array) pieces however
    they were cut (JAX ``_extract_range``). Coverage is counted; where
    pieces overlap (a replicated leaf, which every process saves whole)
    it is counted over a mask, so an overlap never stands in for a gap,
    and a gap raises. ``bound`` (the saved global shape) marks the cells
    past it as zero padding, not missing."""
    tgt = tuple(sl.stop - sl.start for sl in index)
    out = np.zeros(tgt, np.float32)
    if bound is None:
        want = int(np.prod(tgt))
    else:
        want = int(np.prod([max(0, min(sl.stop, b) - min(sl.start, b))
                            for sl, b in zip(index, bound)]))
    filled, hits = 0, []
    for src, arr in pieces:
        inter = tuple(slice(max(a.start, b.start), min(a.stop, b.stop))
                      for a, b in zip(index, src))
        if any(s.start >= s.stop for s in inter):
            continue
        dst = tuple(slice(s.start - t.start, s.stop - t.start)
                    for s, t in zip(inter, index))
        out[dst] = arr[tuple(slice(s.start - c.start, s.stop - c.start)
                             for s, c in zip(inter, src))]
        hits.append(dst)
        filled += int(np.prod([s.stop - s.start for s in inter]))
    if filled > want:  # overlapping pieces: count the union
        mask = np.zeros(tgt, bool)
        for dst in hits:
            mask[dst] = True
        filled = int(mask.sum())
    if filled < want:
        raise ValueError(
            f"checkpoint shard files do not cover {what}"
            f"{[(s.start, s.stop) for s in index]}: {filled}/{want} elements "
            "found (a restore on another process count needs every proc "
            "file where this process can read it)")
    return out


def _proc_of(path: str) -> int:
    try:
        return int(path.rsplit(".proc", 1)[1].split(".")[0])
    except (IndexError, ValueError):
        return -1


def _sharded_pieces(path_prefix: str, meta: dict) -> dict[str, list]:
    """(range, array) pieces of each leaf from this save's proc files,
    those below ``meta["process_count"]`` only (a stale higher-rank file
    of an earlier save to the prefix is not read)."""
    pattern = path_prefix + ".proc*.npz"
    files = (expand_uri(pattern) if is_remote(pattern)
             else sorted(_glob.glob(pattern.removeprefix("file://"))))
    npc = meta.get("process_count")
    if npc:
        files = [f for f in files if 0 <= _proc_of(f) < npc]
    if not files:
        raise FileNotFoundError(f"no shard files match {pattern}")
    pieces: dict[str, list] = {name: [] for name in LEAVES}
    for fp in files:
        with _open_npz(fp) as zf:
            for key in zf.files:
                name, sls = _parse_index_key(key)
                pieces[name].append((sls, zf[key]))
    return pieces


def load_full(path_prefix: str) -> tuple[FMState, dict]:
    """Host FMState of either layout (one file or a per-process set), for
    the tools, which have no store to take shapes from: a set is
    reassembled at the saved global shapes, so a missing top-range proc
    file fails the coverage check instead of truncating the model."""
    meta = _read_meta(path_prefix)
    if not meta.get("sharded"):
        return load(path_prefix)
    pieces = _sharded_pieces(path_prefix, meta)
    saved = meta.get("shapes", {})
    full = {}
    for name in LEAVES:
        if not pieces[name]:
            raise ValueError(f"checkpoint {path_prefix} lacks leaf {name}")
        if name in saved:
            shape = tuple(saved[name])
        else:  # no recorded shapes: the ranges' extent
            ndim = len(pieces[name][0][0])
            shape = tuple(max(sl[d].stop for sl, _ in pieces[name])
                          for d in range(ndim))
        full[name] = _extract_range(pieces[name],
                                    tuple(slice(0, d) for d in shape),
                                    name + "@")
    return state_from_numpy(full), meta


def load_for_store(path_prefix: str, store):
    """Load a checkpoint and place it on ``store``'s device in
    ``store``'s layout (a hot/cold store permutes it by its remap).
    Returns (state, meta).

    A per-process file set loads onto any topology: a LocalStore gets the
    whole table at its own shapes; a ShardedStore rank reads only the
    pieces that overlap its rows and zero-fills only the padding rows past
    the saved shape, down to its hash space. A save with a smaller hash
    space or another ``V_dim`` raises."""
    meta = _read_meta(path_prefix)
    if not meta.get("sharded"):
        host_state, meta = load(path_prefix)
        if getattr(store, "attn", None) is not None:
            return store.place_state(host_state, read_dense(path_prefix)), meta
        return store.place_state(host_state), meta
    pieces = _sharded_pieces(path_prefix, meta)
    saved = meta.get("shapes", {})
    k = store.param.V_dim
    sharded = hasattr(store, "place_rows")
    lo, rows = ((store.lo, store.rows_per_shard) if sharded
                else (0, store.num_rows))
    hash_rows = store.hash_rows if sharded else store.num_rows
    leaves = {}
    for name in LEAVES:
        two_d = name in ("V", "nV")
        index = ((slice(0, k),) if two_d else ()) + (slice(lo, lo + rows),)
        bound = None
        if name in saved:
            bound = tuple(saved[name])
            if two_d and bound[0] != k:
                raise ValueError(f"checkpoint leaf {name} has V_dim "
                                 f"{bound[0]} but this store expects {k} "
                                 "(F*k for loss=ffm)")
            if bound[-1] < hash_rows:
                raise ValueError(
                    f"checkpoint leaf {name} has {bound[-1]} rows but this "
                    f"store's hash space is {hash_rows} (num_bits mismatch?)")
        leaves[name] = _extract_range(pieces[name], index, name + "@",
                                      bound if sharded else None)
    if sharded:
        return store.place_rows(leaves), meta
    return store.place_state(state_from_numpy(leaves)), meta
