"""Run a function on N ranks of one process group, spawned from this process.

``run_ranks(fn, world, workdir, *args)`` starts ``world`` processes (the
``spawn`` start method: each a fresh interpreter, so a parent that holds a
CUDA context or threads can use it). Each rank joins a process group through
a file under ``workdir`` (no TCP port), with a timeout on its collectives,
uses one CPU thread,
calls ``fn(rank, world, *args)`` and hands its return value back by a
pickle in ``workdir``. The parent waits for every rank; a rank that raises
fails the call with that rank's traceback, and a call that outlasts
``timeout`` seconds terminates every rank and raises. ``fn`` must be
importable by module and name (a function at the top level of a module).

The backend is gloo unless given: on the CPU, and for ranks that share one
card (NCCL refuses two ranks on one GPU); NCCL where each rank has its own.
"""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta


def _entry(rank: int, fn, world: int, workdir: str, backend: str, pg_timeout: float, args: tuple) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method="file://" + os.path.join(workdir, "pg_init"), rank=rank,
                            world_size=world, timeout=timedelta(seconds=pg_timeout))
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(workdir, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, workdir: str, *args, backend: str = "gloo", timeout: float = 120.0,
              pg_timeout: float = 120.0) -> list:
    """[fn(rank, world, *args) for each rank], each run in its own process
    of one ``world``-rank process group (see the module docstring):
    ``timeout`` bounds the whole call, ``pg_timeout`` each collective."""
    import torch.multiprocessing as mp

    os.makedirs(workdir, exist_ok=True)
    for name in ["pg_init"] + [f"rank_{r}.pkl" for r in range(world)]:
        if os.path.exists(os.path.join(workdir, name)):
            os.remove(os.path.join(workdir, name))
    ctx = mp.start_processes(_entry, args=(fn, world, workdir, backend, pg_timeout, args), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, min(5.0, deadline - time.monotonic()))):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {getattr(fn, '__name__', fn)} did not finish in {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"rank_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
