"""Process groups, port of ``camouflage_multimodal_tpu/parallel/distributed.py``.

The JAX package is single-controller: one process drives every chip of a
host and ``jax.distributed`` joins the hosts. PyTorch's idiom is one
process per card, started by ``torchrun`` (or any launcher that sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``); :func:`initialize` joins those processes into the default
process group, and :mod:`parallel.sharding` lays a ``(data, model)`` mesh
over it.
"""

from __future__ import annotations

import datetime
import os
import subprocess
from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from camouflage_multimodal_tpu_torch.core.device import resolve_device


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout_s: Optional[float] = None,
               device: Optional[str] = None) -> None:
    """``init_process_group`` with torchrun's variables as fallbacks
    (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). A no-op for a
    single process without an address, as the JAX function is, and when a
    group is already up.

    ``coordinator_address`` is ``host:port``. ``device`` (``"cuda"`` or
    ``"cpu"``) is where the ranks compute: the card by default, which
    raises where there is none (:func:`core.device.resolve_device`; CPU
    ranks pass ``"cpu"``). ``backend`` defaults to ``nccl`` on cards and
    ``gloo`` on the CPU (two ranks that share one card need ``gloo`` with
    ``device="cuda"``: NCCL refuses a duplicate GPU). Ranks that compute on
    cards are pinned to ``cuda:LOCAL_RANK`` (the process id when the
    launcher sets no ``LOCAL_RANK``). ``timeout_s`` bounds every collective
    and the rendezvous."""
    if dist.is_initialized():
        return
    device = resolve_device("cuda" if device is None else device).type
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env and "MASTER_PORT" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None:
        if num_processes in (None, 1):
            return  # single process
        raise ValueError(f"{num_processes} processes need a coordinator address "
                         "(or MASTER_ADDR and MASTER_PORT)")
    num_processes = 1 if num_processes is None else num_processes
    process_id = 0 if process_id is None else process_id
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", process_id)))
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id, **kwargs)


def run_ranks(commands: Sequence[Sequence[str]], envs: Sequence[Mapping[str, str]],
              timeout: float, cwd: Optional[str] = None) -> List[str]:
    """Start one process a rank (``commands[r]`` with ``envs[r]``), wait for
    all of them and return each one's output (stdout and stderr). Raises
    ``RuntimeError`` with the tails of the logs when a rank exits non-zero
    or has not ended within ``timeout`` seconds; every rank is killed then."""
    procs = [subprocess.Popen(list(cmd), env=dict(env), cwd=cwd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(commands, envs)]
    logs: List[str] = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=timeout)[0])
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                logs.append(p.communicate()[0] + f"\n[killed after {timeout} s]")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{log[-3000:]}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return logs


def shutdown() -> None:
    """Tear the default process group down, if one is up."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank; 0 when no group is up."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of processes; 1 when no group is up."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_batch_indices(n: int, shuffle_seed: Optional[int] = None) -> np.ndarray:
    """Per-process strided shard of [0, n) for host-sharded data loading
    (the same numpy permutation as the JAX function under ``shuffle_seed``)."""
    idx = np.arange(n)
    if shuffle_seed is not None:
        idx = np.random.default_rng(shuffle_seed).permutation(n)
    return idx[process_index()::process_count()]
