"""Gloo ranks on the CPU for the PyTorch port's mesh tests
(``tests/test_torch_port_model_axis.py``, ``tests/test_torch_port_spatial.py``).

A test file names its tasks (functions ``task_<name>(mesh, work) -> dict``)
and runs them in ``world`` subprocesses of its own ``__main__`` block,
joined over localhost on a free port by :func:`spawn`. Each rank computes
single-threaded (oversubscribed ranks starve gloo), has a time limit of its
own on the rendezvous and the collectives (60 s), and writes
``w<world>m<model>/<task>_rank<r>.npz`` (or ``.err`` with the traceback);
:func:`wait` kills a group that has not finished within ``RANK_TIMEOUT``
seconds, so a failed rendezvous fails the tests instead of hanging them.
JAX references run in a subprocess of their own with ``devices`` forced CPU
devices (:func:`run_jax`), since the test process has one.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
RANK_TIMEOUT = 150


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script: str, world: int, model_axis: int, work: str, names):
    """Start ``world`` ranks of ``script`` running the tasks ``names`` on a
    (world / model_axis, model_axis) mesh."""
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(world), OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return [subprocess.Popen([sys.executable, script, work, str(model_axis), *names],
                             env={**env, "RANK": str(r)}, cwd=REPO,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def wait(procs, timeout: float = RANK_TIMEOUT):
    """The ranks' logs, once every rank has ended (or been killed)."""
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out = p.communicate()[0] + f"\n[killed after {timeout} s]"
        logs.append(out)
    return logs


def rank_main(tasks, argv) -> None:
    """One rank: join the group from the launcher's variables, lay the
    mesh, run the tasks in order, write each one's results, stop at the
    first failure (the other ranks would wait on a collective)."""
    import torch

    from camouflage_multimodal_tpu_torch.parallel import distributed, sharding

    work, model_axis, names = argv[0], int(argv[1]), argv[2:]
    torch.set_num_threads(1)
    distributed.initialize(backend="gloo", timeout_s=60, device="cpu")
    rank = distributed.process_index()
    out_dir = os.path.join(work, f"w{distributed.process_count()}m{model_axis}")
    os.makedirs(out_dir, exist_ok=True)
    try:
        mesh = sharding.make_mesh("cpu", model_axis=model_axis)
        for name in names:
            try:
                out = tasks[name](mesh, work)
            except Exception:
                with open(os.path.join(out_dir, f"{name}_rank{rank}.err"), "w") as f:
                    f.write(traceback.format_exc())
                raise
            np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"), **out)
    finally:
        distributed.shutdown()


def load(path: str):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def result(work: str, world: int, model_axis: int, task: str, rank: int, logs=()):
    """What rank ``rank`` of a group wrote for ``task``; fails the test with
    the rank's traceback and the group's logs when it wrote nothing."""
    import pytest

    path = os.path.join(work, f"w{world}m{model_axis}", f"{task}_rank{rank}")
    if not os.path.exists(path + ".npz"):
        err = open(path + ".err").read() if os.path.exists(path + ".err") else ""
        pytest.fail(f"{task} at world {world}, model axis {model_axis}, rank {rank} left no "
                    f"result:\n{err}\n" + "\n".join(logs))
    return load(path + ".npz")


def start_jax(code: str, devices: int, work: str):
    """Start ``code`` in a JAX subprocess on ``devices`` forced CPU devices,
    with the repo on its path and ``WORK`` set to ``work``."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + f" --xla_force_host_platform_device_count={devices}").strip()
    env["WORK"] = work
    env["PYTHONPATH"] = REPO
    prelude = ("import jax; jax.config.update('jax_platforms', 'cpu');"
               "jax.config.update('jax_default_matmul_precision', 'highest')\n")
    return subprocess.Popen([sys.executable, "-c", prelude + code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_jax(proc, timeout: float = 600) -> None:
    """Wait for a :func:`start_jax` subprocess; fail the test if it failed."""
    import pytest

    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out = proc.communicate()[0] + f"\n[killed after {timeout} s]"
    if proc.returncode != 0:
        pytest.fail(f"the JAX reference failed:\n{out[-4000:]}")
