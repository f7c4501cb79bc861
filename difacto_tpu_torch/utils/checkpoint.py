"""Model checkpoint save/load, in the JAX package's interchange format.

Port of the single-process half of ``difacto_tpu/utils/checkpoint.py``
(reference: ``Updater::Save/Load(dmlc::Stream)``). A checkpoint is
``prefix.npz`` with the planar leaves ``w, z, n, V [K, N], nV [K, N],
cnt`` plus ``prefix.meta.json`` with ``format_version`` 1, the leaf
``shapes`` and the ``epoch``/``step`` cursor for resume. Either package
loads the other's checkpoints. The table's layout is a property of a run,
not of a checkpoint: every layout is saved as the planar leaves, fetched
one ``[N]`` plane at a time (a planar copy of a 2^26-row table beside it
would be another 9.7 GB on the card), and a hot/cold state un-permuted
into canonical hash rows by the run's remap lut, so a model trained in
one layout loads into any other, and into the JAX package. A prefix may
be a remote URI (``gs://``, ``s3://``, ``memory://``, ...; data/io.py),
as in the JAX package. A sharded store's run saves its gathered table
(padding rows included), as the JAX package's one-process branch does;
the per-process sharded layout is ROADMAP A9b.

:func:`state_from_numpy` and :func:`state_to_numpy` carry a state between
the two packages as NumPy arrays.
"""

from __future__ import annotations

import contextlib
import json
import os

import numpy as np
import torch

from ..data.io import is_remote, open_uri
from ..updaters.updater import (LEAVES, FMState, HotColdFMState,
                                PackedFMState, StackedFMState, leaf_planes)

FORMAT_VERSION = 1


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


def save(path_prefix: str, state, meta: dict | None = None,
         remap_lut: np.ndarray | None = None) -> str:
    """Write ``state`` (any layout) as planar leaves in canonical hash
    rows (``remap_lut``: a hot/cold state's lut, which it needs)."""
    if not is_remote(path_prefix):
        local = path_prefix.removeprefix("file://")
        os.makedirs(os.path.dirname(local) or ".", exist_ok=True)
    host = state_to_numpy(state, remap_lut)
    full_meta = {"format_version": FORMAT_VERSION, **(meta or {})}
    full_meta["shapes"] = {k: list(v.shape) for k, v in host.items()}
    npz = path_prefix + ".npz"
    _write_npz(npz, host)
    _write_text(path_prefix + ".meta.json", json.dumps(full_meta, indent=1))
    return npz


def _read_meta(path_prefix: str) -> dict:
    try:
        with open_uri(path_prefix + ".meta.json", "rb") as f:
            return json.loads(f.read().decode())
    except FileNotFoundError:
        return {}


def load(path_prefix: str) -> tuple[FMState, dict]:
    """Host (CPU) state and metadata of a single-file checkpoint."""
    meta = _read_meta(path_prefix)
    if meta.get("sharded"):
        raise NotImplementedError(
            f"{path_prefix} is a per-process sharded checkpoint: not in the "
            "PyTorch port yet (ROADMAP A9b)"
        )
    with _open_npz(path_prefix + ".npz") as zf:
        state = state_from_numpy({k: zf[k] for k in LEAVES})
    return state, meta


def load_for_store(path_prefix: str, store):
    """Load a checkpoint and place it on ``store``'s device in
    ``store``'s layout (a hot/cold store permutes it by its remap).
    Returns (state, meta)."""
    host_state, meta = load(path_prefix)
    return store.place_state(host_state), meta
