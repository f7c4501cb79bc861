"""Run a function on the S ranks of a gloo group, or a program under the
multi-process env contract, one process a rank, on this host.

The sharded store (parallel/store.py::ShardedStore) holds one shard a
rank of a ``torch.distributed`` group. Its tests (on the CPU) and
``chip_smoke.py`` (S ranks sharing one card) start such a group with
:func:`run_ranks`:

    run_ranks("pkg.module:function", S, ["arg", ...], timeout=120.0)

starts ``python -m difacto_tpu_torch.parallel.launch`` S times; each
child joins the group (gloo, ``tcp://localhost:<a free port>``, world
size S, its rank, the group's own timeout), calls ``function(*args)``
and leaves the group. The parent waits for all of them within
``timeout`` seconds, kills every child still running past it, and raises
if one failed or timed out, with each rank's output: a deadlock fails
the caller instead of holding it. Output goes to files, so a talkative
rank cannot block on a full pipe.

:func:`run_processes` starts one program P times under the env contract
(parallel/multihost.py: ``DIFACTO_COORDINATOR=localhost:<a free port>``,
``DIFACTO_NUM_PROCESSES``, ``DIFACTO_PROCESS_ID``, and
``DIFACTO_GROUP_TIMEOUT``), as a launcher starts the multi-process
learner, with the same timeout and kill:

    run_processes(["-m", "difacto_tpu_torch", "conf"], 2, timeout=300.0)
"""

from __future__ import annotations

import importlib
import os
import socket
import subprocess
import sys
import tempfile
import time
from datetime import timedelta
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target: str, size: int, args: list[str], timeout: float,
              path: str | None = None, group_timeout: float = 60.0
              ) -> list[str]:
    """Run ``target`` ("module:function") on ranks 0..size-1 with string
    ``args``; ``path``: a directory the children import ``module`` from
    (the repo's root is always there). Returns each rank's output."""
    port = free_port()
    return _run([[sys.executable, "-m", "difacto_tpu_torch.parallel.launch",
                  target, str(r), str(size), str(port), str(group_timeout),
                  *args] for r in range(size)],
                [_env(path) for _ in range(size)], timeout, target)


def run_processes(argv: list[str], size: int, timeout: float,
                  path: str | None = None, env: dict | None = None,
                  group_timeout: float = 60.0) -> list[str]:
    """Run ``python *argv`` as processes 0..size-1 of a multi-process
    launch (the env contract), ``env`` added to each one's environment.
    Returns each process's output."""
    port = free_port()
    envs = [{**_env(path), **(env or {}),
             "DIFACTO_COORDINATOR": f"localhost:{port}",
             "DIFACTO_NUM_PROCESSES": str(size),
             "DIFACTO_PROCESS_ID": str(r),
             "DIFACTO_GROUP_TIMEOUT": str(group_timeout)}
            for r in range(size)]
    return _run([[sys.executable, *argv]] * size, envs, timeout,
                " ".join(argv))


def _env(path: str | None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(REPO), path, env.get("PYTHONPATH")) if p)
    return env


def _run(cmds: list[list[str]], envs: list[dict], timeout: float,
         what: str) -> list[str]:
    """Start one process a command, wait for all within ``timeout``
    seconds, kill every one still running past it, and raise if one
    failed or timed out, with each one's output. Returns the outputs."""
    size = len(cmds)
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(size)]
        procs = [subprocess.Popen(cmd, stdout=logs[r],
                                  stderr=subprocess.STDOUT, env=envs[r],
                                  cwd=str(REPO))
                 for r, cmd in enumerate(cmds)]
        deadline = time.monotonic() + timeout
        timed_out = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
    failed = [r for r, p in enumerate(procs) if p.returncode != 0]
    if timed_out or failed:
        why = (f"timed out after {timeout:.0f} s" if timed_out
               else f"ranks {failed} failed")
        raise RuntimeError(f"{what} on {size} ranks {why}:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode})\n{out[-4000:]}"
            for r, (p, out) in enumerate(zip(procs, outs))))
    return outs


def main(argv: list[str]) -> int:
    import torch.distributed as dist

    target, rank, size, port, group_timeout, *args = argv
    module, fn = target.split(":")
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=int(size),
        rank=int(rank), timeout=timedelta(seconds=float(group_timeout)))
    try:
        getattr(importlib.import_module(module), fn)(*args)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
