"""Process bring-up for the mesh (counterpart of
``lpformer_tpu/parallel/distributed.py``).

In the JAX package one process drives every device of its host and
``shard_map`` splits the work among them. Here each mesh position is a
process of its own, a rank with one device, the PyTorch idiom: so
``--num-processes`` counts RANKS, D*G for a D x G mesh (in the JAX package
it counts hosts). Connecting the ranks is the only step that differs
between one host and many: after :func:`initialize` every module
downstream speaks to a ``torch.distributed`` process group.

  * explicit: ``initialize(coordinator="host0:8476", num_processes=4,
    process_id=r)`` on every rank (``tcp://`` rendezvous at the
    coordinator, which rank 0 serves), or the same three values through
    LPFORMER_COORDINATOR / LPFORMER_NUM_PROCESSES / LPFORMER_PROCESS_ID;
  * ``auto=True``: torchrun's RANK / WORLD_SIZE / LOCAL_RANK /
    MASTER_ADDR / MASTER_PORT (``env://``), e.g.
    ``torchrun --nproc-per-node 4 -m lpformer_tpu_torch.cli.run --mesh 2,2
    --distributed auto ...``;
  * :func:`spawn_local`: n ranks on this host, each a spawned process
    (what ``--mesh D,G`` without the flags above runs).

The backend is NCCL for ranks on CUDA devices and gloo for ranks on the
CPU; a caller may ask for gloo on CUDA ranks (several ranks sharing one
card, which NCCL refuses). A failed NCCL bring-up raises. Host-side side
effects (prints, checkpoint writes) belong to :func:`is_coordinator`.
"""
from __future__ import annotations

import datetime
import os
import socket
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from lpformer_tpu_torch import resolve_device

# the rank's device, fixed by initialize(); process-global like the
# process group it belongs to
_RANK_DEVICE: List[torch.device] = []
# the process groups of each mesh shape made in this process group
# (parallel/mesh.py), destroyed with it
MESH_GROUPS: dict = {}
INIT_TIMEOUT_S = 300


def _rank_device(device, local_rank: int) -> torch.device:
    """``device`` for this rank: an indexed device as given; ``cuda`` (or
    None, the package's default) the local rank's card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    auto: bool = False,
    *,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = INIT_TIMEOUT_S,
) -> bool:
    """Connect this process to the other ranks. Returns True once this
    process belongs to a process group (also when it already did), False
    for a single-process run (no flags, no environment).

    ``device``: the rank's device; None or ``cuda`` means the local rank's
    card (LOCAL_RANK, else the process id modulo the visible cards),
    ``cpu`` a CPU rank. ``backend``: None picks NCCL for a CUDA rank and
    gloo for a CPU rank."""
    if dist.is_initialized():
        return True
    coordinator = coordinator or os.environ.get("LPFORMER_COORDINATOR")
    if num_processes is None and "LPFORMER_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LPFORMER_NUM_PROCESSES"])
    if process_id is None and "LPFORMER_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LPFORMER_PROCESS_ID"])
    timeout = datetime.timedelta(seconds=timeout_s)
    if auto:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                               "MASTER_PORT") if k not in os.environ]
        if missing:
            raise ValueError(
                "'--distributed auto' reads torchrun's environment; "
                f"missing {missing}")
        rank = int(os.environ["RANK"])
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_RANK", rank))
        init_method = "env://"
    else:
        if (coordinator is None and num_processes is None
                and process_id is None):
            return False
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError(
                "multi-process bring-up needs all three of --coordinator, "
                "--num-processes, --process-id (or '--distributed auto' "
                "under torchrun); got "
                f"coordinator={coordinator!r}, "
                f"num_processes={num_processes!r}, "
                f"process_id={process_id!r}")
        rank, world = process_id, num_processes
        local = int(os.environ.get("LOCAL_RANK", process_id))
        init_method = f"tcp://{coordinator}"
    dev = _rank_device(device, local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank, timeout=timeout)
    _RANK_DEVICE[:] = [dev]
    return True


def init_single(device) -> None:
    """A process group of this process alone (a 1 x 1 mesh without
    :func:`initialize`): an in-memory store, the backend of ``device``."""
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.HashStore(), world_size=1,
                            rank=0)
    _RANK_DEVICE[:] = [dev]


def rank_device(default=None) -> torch.device:
    """The device :func:`initialize` gave this rank, else ``default``
    (resolved as the package's entry points resolve a device)."""
    return _RANK_DEVICE[0] if _RANK_DEVICE else resolve_device(default)


def is_coordinator() -> bool:
    """True on rank 0, which owns the host-side side effects (checkpoint
    writes, log prints), and in a single-process run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def shutdown() -> None:
    """Leave the process group; every group made in it goes with it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RANK_DEVICE.clear()
    MESH_GROUPS.clear()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _resource_tracker_running() -> bool:
    from multiprocessing import resource_tracker

    return getattr(resource_tracker._resource_tracker, "_fd", None) is not None


def stop_resource_tracker() -> None:
    """Stop multiprocessing's resource tracker, a process that starting a
    spawned process starts and that otherwise outlives the ranks until
    this process exits. The next spawn starts it again."""
    import gc
    from multiprocessing import resource_tracker

    # the ranks' queue unregisters its semaphores before the tracker stops
    gc.collect()
    stop = getattr(resource_tracker._resource_tracker, "_stop", None)
    if stop is not None:
        stop()


def _rank_main(fn, rank, nprocs, port, device, backend, threads, args,
               queue):
    os.environ.update({"LPFORMER_COORDINATOR": f"127.0.0.1:{port}",
                       "LPFORMER_NUM_PROCESSES": str(nprocs),
                       "LPFORMER_PROCESS_ID": str(rank),
                       "LOCAL_RANK": str(rank)})
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize(device=device, backend=backend)
        queue.put((rank, True, fn(rank, *args)))
    except BaseException:
        queue.put((rank, False, traceback.format_exc()))
        raise
    finally:
        shutdown()


def spawn_local(
    fn: Callable, nprocs: int, args: Sequence = (), *, device=None,
    backend: Optional[str] = None, timeout_s: float = 1800,
    threads: int = 0,
) -> list:
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks of this host, each a
    spawned process joined to one process group (a free local port) with
    ``initialize(device=device, backend=backend)``; returns the ranks'
    results in rank order. ``fn``, ``args`` and the results are pickled,
    so ``fn`` is a module-level function. ``threads`` > 0 sets each rank's
    torch threads (0: CPU ranks share this host's cores). Leaves no
    process behind: every rank is joined, and multiprocessing's resource
    tracker stopped if this call started it. Raises, after stopping every
    rank, when a rank fails or the ranks take longer than ``timeout_s`` in
    all (None: no limit)."""
    import multiprocessing as mp
    import queue as queue_mod
    import time

    if not threads and device is not None and torch.device(device).type == "cpu":
        threads = max(1, (os.cpu_count() or 1) // nprocs)
    ctx = mp.get_context("spawn")
    # starting a spawned process starts multiprocessing's resource tracker
    tracker_was_running = _resource_tracker_running()
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=False, args=(
        fn, r, nprocs, port, device, backend, threads, tuple(args), results))
        for r in range(nprocs)]
    for p in procs:
        p.start()
    out, failed = {}, None
    deadline = time.monotonic() + (
        float("inf") if timeout_s is None else timeout_s)
    try:
        while len(out) < nprocs and failed is None:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_mod.Empty:
                if time.monotonic() > deadline:
                    failed = f"ranks timed out after {timeout_s} s"
                elif any(p.exitcode not in (None, 0) for p in procs):
                    failed = "a rank exited with " + str(
                        [p.exitcode for p in procs])
                continue
            if ok:
                out[rank] = val
            else:
                failed = f"rank {rank} failed:\n{val}"
        for p in procs:
            p.join(timeout=min(60.0, max(5.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        del results
        if not tracker_was_running:
            stop_resource_tracker()
    if failed is None and any(p.exitcode != 0 for p in procs):
        failed = "a rank exited with " + str([p.exitcode for p in procs])
    if failed is not None:
        raise RuntimeError(f"spawn_local({nprocs} ranks): {failed}")
    return [out[r] for r in range(nprocs)]
