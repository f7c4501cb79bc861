"""Model checkpoint save/load, in the JAX package's interchange format.

Port of the single-process half of ``difacto_tpu/utils/checkpoint.py``
(reference: ``Updater::Save/Load(dmlc::Stream)``). A checkpoint is
``prefix.npz`` with the planar leaves ``w, z, n, V [K, N], nV [K, N],
cnt`` plus ``prefix.meta.json`` with ``format_version`` 1, the leaf
``shapes`` and the ``epoch``/``step`` cursor for resume. Either package
loads the other's checkpoints. The table's layout is a property of a run,
not of a checkpoint: a row-major ``PackedFMState`` is unpacked to the
planar leaves on save, and a store packs what it loads when its layout is
packed, so a model trained in one layout loads into the other. The
per-process sharded layout waits for the sharded store (ROADMAP A9).

:func:`state_from_numpy` and :func:`state_to_numpy` carry a state between
the two packages as NumPy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..updaters.updater import LEAVES, FMState, PackedFMState

FORMAT_VERSION = 1


def state_from_numpy(arrays, device="cpu", layout: str = "planar"):
    """A state on ``device`` from NumPy arrays, which are copied.
    ``layout="planar"``: the six planar leaves (a dict, or any object
    with the leaf attributes — a JAX FMState after ``jax.device_get``)
    give an FMState. ``layout="packed"``: the row-major table ``tbl
    [N, 4+2K]`` (a dict, an object with ``tbl`` — a JAX PackedFMState —
    or the array itself) gives a PackedFMState."""
    def tensor(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=device)

    get = arrays.__getitem__ if isinstance(arrays, dict) else (
        lambda k: getattr(arrays, k))
    if layout == "packed":
        tbl = arrays if isinstance(arrays, np.ndarray) else get("tbl")
        return PackedFMState(tbl=tensor(tbl))
    if layout != "planar":
        raise ValueError(f"layout must be planar|packed, got {layout!r}")
    return FMState(**{k: tensor(get(k)) for k in LEAVES})


def state_to_numpy(state) -> dict[str, np.ndarray]:
    """The planar leaves of ``state`` (either layout) as contiguous host
    NumPy arrays: the interchange form."""
    return {k: np.ascontiguousarray(getattr(state, k).detach().cpu().numpy())
            for k in LEAVES}


def save(path_prefix: str, state, meta: dict | None = None) -> str:
    """Write ``state`` (either layout) as planar leaves."""
    os.makedirs(os.path.dirname(path_prefix) or ".", exist_ok=True)
    host = state_to_numpy(state)
    full_meta = {"format_version": FORMAT_VERSION, **(meta or {})}
    full_meta["shapes"] = {k: list(v.shape) for k, v in host.items()}
    npz = path_prefix + ".npz"
    np.savez(npz, **host)
    with open(path_prefix + ".meta.json", "w") as f:
        f.write(json.dumps(full_meta, indent=1))
    return npz


def _read_meta(path_prefix: str) -> dict:
    meta_path = path_prefix + ".meta.json"
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            return json.load(f)
    return {}


def load(path_prefix: str) -> tuple[FMState, dict]:
    """Host (CPU) state and metadata of a single-file checkpoint."""
    meta = _read_meta(path_prefix)
    if meta.get("sharded"):
        raise NotImplementedError(
            f"{path_prefix} is a per-process sharded checkpoint: not in the "
            "PyTorch port yet (ROADMAP A9, sharded store)"
        )
    with np.load(path_prefix + ".npz") as zf:
        state = state_from_numpy({k: zf[k] for k in LEAVES})
    return state, meta


def load_for_store(path_prefix: str, store):
    """Load a checkpoint and place it on ``store``'s device in
    ``store``'s layout. Returns (state, meta)."""
    host_state, meta = load(path_prefix)
    return store.place_state(host_state), meta
