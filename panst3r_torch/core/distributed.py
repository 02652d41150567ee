"""Process groups over ``torch.distributed`` (counterpart of
panst3r_tpu/core/distributed.py).

The JAX package runs one controller per host and compiles its collectives
into the program; here every device is a process (a rank) and the
collectives are ``torch.distributed`` calls.  The env contract is the JAX
package's:

  COORDINATOR_ADDRESS  host:port of the rendezvous (rank 0 listens there)
  NUM_PROCESSES        the world size
  PROCESS_ID           this process's rank

The backend is always the caller's: NCCL on the card, gloo on the CPU
(and for rehearsing several ranks on one card); nothing switches backend
when one fails.

``launch`` runs a function on ``nprocs`` spawned ranks of one host (a
rendezvous on a free 127.0.0.1 port), each under a wall-clock limit.
Spawned ranks import the module of their target again, so a target must
live in an importable module (not in ``__main__`` of a script or in a
test file).
"""
from __future__ import annotations

import datetime
import os
import queue as _queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT = 120.0


def default_backend(device) -> str:
    """"gloo" for the CPU, "nccl" for the card."""
    return "gloo" if torch.device(device or "cuda").type == "cpu" else "nccl"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None,
               timeout: float = DEFAULT_TIMEOUT) -> None:
    """Join the process group (a no-op for one process with no
    coordinator, and when this process has joined already).  ``backend``
    defaults to ``default_backend(device)``; ``timeout`` bounds the
    rendezvous and every collective: a missing rank raises instead of
    waiting for ever."""
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES",
                                                        "1"))
    if num_processes <= 1 and coordinator is None:
        return
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a "
                         "COORDINATOR_ADDRESS (host:port)")
    rank = (process_id if process_id is not None
            else int(os.environ.get("PROCESS_ID", "0")))
    dist.init_process_group(
        backend or default_backend(device),
        init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=rank, timeout=datetime.timedelta(seconds=timeout))


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """The rank that writes checkpoints, logs and evaluations."""
    return process_index() == 0


def barrier() -> None:
    """Wait for every rank (no-op in one process)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(device, rank: int) -> torch.device:
    """This rank's device: the CPU, or card ``rank`` modulo the cards there
    are (two ranks share one card when there is only one)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def to_host(obj):
    """``obj`` with every tensor in it (in lists, tuples and dicts) as a
    numpy array: what a rank hands back to ``launch``."""
    if torch.is_tensor(obj):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank, nprocs, port, backend, device, timeout, fn, args,
               results, threads):
    os.environ.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                      NUM_PROCESSES=str(nprocs), PROCESS_ID=str(rank))
    if threads:
        torch.set_num_threads(threads)
    try:
        dev = rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        initialize(backend=backend, device=dev, timeout=timeout)
        try:
            out = to_host(fn(dev, *args))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def launch(fn, nprocs: int, backend: str, device, *args,
           timeout: float = DEFAULT_TIMEOUT, threads: int = 0) -> list:
    """Run ``fn(device, *args)`` on ``nprocs`` spawned ranks joined in one
    ``backend`` group; returns the ranks' results in rank order.  Each
    rank's ``device`` is ``rank_device(device, rank)``.  Every rank has
    ``timeout`` seconds of wall clock, rendezvous included: past it, or
    when a rank fails or dies, every rank is killed and this raises.
    ``threads`` > 0 caps each rank's intra-op threads.  A rank's result
    comes back through ``to_host`` (tensors as numpy arrays)."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, port, backend, str(device), timeout,
                               fn, args, results, threads))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    out: dict = {}
    try:
        while len(out) < nprocs:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{nprocs} ranks of {fn.__name__} did not "
                                   f"finish within {timeout:.0f} s")
            dead = [r for r, p in enumerate(procs)
                    if r not in out and p.exitcode is not None]
            try:
                # a rank that has exited has flushed its result, if any
                rank, ok, value = results.get(
                    timeout=2.0 if dead else min(left, 1.0))
            except _queue.Empty:
                if dead:
                    raise RuntimeError(f"rank(s) {dead} of {fn.__name__} "
                                       "exited without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} failed:\n"
                                   f"{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(10.0, deadline - time.monotonic())))
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(nprocs)]
