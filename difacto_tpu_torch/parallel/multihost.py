"""The multi-process launch contract, read from the environment.

The port's copy of the env-contract read in
``difacto_tpu/parallel/multihost.py::maybe_initialize_distributed``
(reference: the dmlc tracker's ``DMLC_ROLE`` / ``DMLC_PS_ROOT_URI``
bootstrap). A launcher starts one process per host and sets

  DIFACTO_COORDINATOR   host:port of process 0
  DIFACTO_NUM_PROCESSES total process count
  DIFACTO_PROCESS_ID    this process's rank

The JAX package joins a process group whenever the coordinator is set
and the count is above 1; each process then reads its own input part and
they save one sharded checkpoint. The port's multi-process learner is
ROADMAP A9b: until it lands, the entry points refuse the contract
(:func:`refuse_multiprocess`) before they read data or write a model,
instead of letting every process train the whole model on all the data.
"""

from __future__ import annotations

import os
from typing import NamedTuple


class EnvContract(NamedTuple):
    coordinator: str | None
    num_processes: int
    process_id: int


def env_contract() -> EnvContract:
    """The three variables, as the JAX package parses them."""
    return EnvContract(
        os.environ.get("DIFACTO_COORDINATOR") or None,
        int(os.environ.get("DIFACTO_NUM_PROCESSES", "0") or 0),
        int(os.environ.get("DIFACTO_PROCESS_ID", "0") or 0),
    )


def multiprocess_requested() -> bool:
    """True where the JAX package would join a process group: the
    coordinator set and more than one process."""
    env = env_contract()
    return bool(env.coordinator) and env.num_processes > 1


def refuse_multiprocess(what: str) -> None:
    """Raise NotImplementedError naming ROADMAP A9b when the launch asks
    for several processes."""
    if multiprocess_requested():
        env = env_contract()
        raise NotImplementedError(
            f"{what}: a multi-process launch (DIFACTO_COORDINATOR="
            f"{env.coordinator}, DIFACTO_NUM_PROCESSES={env.num_processes}) "
            "is not in the PyTorch port yet (ROADMAP A9b: the multi-process "
            "learner, CLI, checkpoints and BCD); run one process")
