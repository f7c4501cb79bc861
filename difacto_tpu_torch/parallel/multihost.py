"""The multi-process launch contract: join a process group, split the input.

Port of ``difacto_tpu/parallel/multihost.py`` (reference: the dmlc
tracker's ``DMLC_ROLE`` / ``DMLC_PS_ROOT_URI`` bootstrap and dmlc
InputSplit). A launcher starts one process per rank and sets

  DIFACTO_COORDINATOR   host:port of process 0
  DIFACTO_NUM_PROCESSES total process count
  DIFACTO_PROCESS_ID    this process's rank

When the coordinator is set and the count is above 1,
:func:`maybe_initialize_distributed` joins the default
``torch.distributed`` group (gloo, ``tcp://<coordinator>``) where the JAX
package calls ``jax.distributed.initialize``. Every process then reads its
own byte-range parts of the input (:func:`input_part`), the processes step
in lockstep, and each saves its own shard of the checkpoint. Each process
takes the card ``cuda:(process id mod device count)``: on a one-card host
every process shares ``cuda:0``. The transport is gloo on either tensor
kind; NCCL, one rank a card, is ROADMAP A9c.

The join has a finite timeout, ``DIFACTO_GROUP_TIMEOUT`` seconds (600 by
default; it also bounds every collective): a process whose peers never
come raises instead of hanging its caller.

A group that some other code initialized (``parallel/launch.py::run_ranks``
starts the sharded store's ranks so, each stepping the same global batch)
is not a multi-process launch: :func:`process_count` counts only the
processes of a join made here.
"""

from __future__ import annotations

import logging
import os
from datetime import timedelta
from typing import NamedTuple

log = logging.getLogger("difacto_tpu_torch")

DEFAULT_GROUP_TIMEOUT_S = 600.0

# (process index, process count) once the env contract's group is joined
_JOINED: tuple[int, int] | None = None


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
    """True where the JAX package joins a process group: the coordinator
    set and more than one process."""
    env = env_contract()
    return bool(env.coordinator) and env.num_processes > 1


def maybe_initialize_distributed() -> tuple[int, int]:
    """Join the process group if the env contract asks for one; a second
    call returns the first join's answer. Returns (process_index,
    process_count), (0, 1) for one process."""
    global _JOINED
    if _JOINED is not None:
        return _JOINED
    if not multiprocess_requested():
        return 0, 1
    import torch
    import torch.distributed as dist

    env = env_contract()
    if not 0 <= env.process_id < env.num_processes:
        raise ValueError(f"DIFACTO_PROCESS_ID {env.process_id} is not in "
                         f"[0, {env.num_processes})")
    timeout = float(os.environ.get("DIFACTO_GROUP_TIMEOUT")
                    or DEFAULT_GROUP_TIMEOUT_S)
    if torch.cuda.is_available():
        torch.cuda.set_device(env.process_id % torch.cuda.device_count())
    dist.init_process_group(
        "gloo", init_method=f"tcp://{env.coordinator}",
        world_size=env.num_processes, rank=env.process_id,
        timeout=timedelta(seconds=timeout))
    _JOINED = (dist.get_rank(), dist.get_world_size())
    log.info("distributed: process %d/%d (gloo, coordinator %s)",
             *_JOINED, env.coordinator)
    return _JOINED


def leave() -> None:
    """Leave the joined group in step with the others (a barrier, then
    ``destroy_process_group``), so that no process tears its connections
    down while a peer still reads them. The CLI calls it after a run that
    succeeded; a failed process exits without it, and its peers' next
    collective fails within the group timeout."""
    global _JOINED
    if _JOINED is None:
        return
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    _JOINED = None


def process_index() -> int:
    return _JOINED[0] if _JOINED else 0


def process_count() -> int:
    return _JOINED[1] if _JOINED else 1


def input_part(parts_per_file: int = 1) -> tuple[range, int]:
    """(part indices, num_parts) of this process's BatchIter: the InputSplit
    contract, every file split into ``process_count * parts_per_file``
    record-aligned byte ranges, of which process p reads the p-th run of
    ``parts_per_file``."""
    nppf = max(parts_per_file, 1)
    pid = process_index()
    return range(pid * nppf, (pid + 1) * nppf), process_count() * nppf
