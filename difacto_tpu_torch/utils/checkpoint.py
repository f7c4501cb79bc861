"""Model checkpoint save/load, in the JAX package's interchange format.

Port of the single-process half of ``difacto_tpu/utils/checkpoint.py``
(reference: ``Updater::Save/Load(dmlc::Stream)``). A checkpoint is
``prefix.npz`` with the planar leaves ``w, z, n, V [K, N], nV [K, N],
cnt`` plus ``prefix.meta.json`` with ``format_version`` 1, the leaf
``shapes`` and the ``epoch``/``step`` cursor for resume. Either package
loads the other's checkpoints. The per-process sharded layout waits for
the sharded store (ROADMAP A9).

:func:`state_from_numpy` and :func:`state_to_numpy` carry a state between
the two packages as NumPy arrays.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..updaters.updater import LEAVES, FMState

FORMAT_VERSION = 1


def state_from_numpy(arrays, device="cpu") -> FMState:
    """FMState on ``device`` from the planar leaves as NumPy arrays (a
    dict, or any object with the six leaf attributes — a JAX FMState
    after ``jax.device_get``). The arrays are copied."""
    get = arrays.__getitem__ if isinstance(arrays, dict) else (
        lambda k: getattr(arrays, k))
    return FMState(**{
        k: torch.tensor(np.asarray(get(k), dtype=np.float32), device=device)
        for k in LEAVES
    })


def state_to_numpy(state: FMState) -> dict[str, np.ndarray]:
    """The planar leaves of ``state`` as host NumPy arrays."""
    return {k: getattr(state, k).detach().cpu().numpy() for k in LEAVES}


def save(path_prefix: str, state: FMState, meta: dict | None = None) -> str:
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


def load_for_store(path_prefix: str, store) -> tuple[FMState, dict]:
    """Load a checkpoint and place it on ``store``'s device."""
    host_state, meta = load(path_prefix)
    return store.place_state(host_state), meta
