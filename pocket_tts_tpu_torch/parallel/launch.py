"""Start a world of N ranks and collect what each returns.

`launch(fn, world_size, args, device_type)` spawns one process per rank
(torch.multiprocessing, "spawn"), joins them into one process group through
a FileStore in a temporary directory (no port is opened), runs `fn(*args)`
on every rank and returns the results in rank order. `fn` must be importable
by name (a module-level function) and its result picklable.

The backend follows from where the ranks sit (parallel/mesh.backend_for):
NCCL when each rank has a card of its own, gloo when they share one card or
run on the CPU. On CUDA, rank r takes card r % device_count, and every
kernel source is built in this process before the ranks start, so that the
ranks load the built libraries instead of racing to build them.

No failure is hidden: a rank that raises makes `launch` raise with that
rank's traceback, and ranks that have not answered within `timeout` seconds
(a hang, such as ranks whose collectives diverged) make it raise naming
them. Either way every rank still running is terminated.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

from pocket_tts_tpu_torch.parallel.mesh import backend_for

_POLL_S = 0.5
_GROUP_TIMEOUT_S = 300  # the shortest wait of the ranks' process group: a slow rank's start is no hang


def build_kernels() -> None:
    """Build every CUDA source of the port (one nvcc each, all at once)."""
    from concurrent.futures import ThreadPoolExecutor

    from pocket_tts_tpu_torch.ops import _cuda

    names = sorted(p.stem for p in _cuda.CSRC.glob("*.cu"))
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_cuda.library, names))


def _rank_main(rank, world_size, backend, device_type, store_path, group_s, fn, args, results) -> None:
    try:
        cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else (os.cpu_count() or 1)
        torch.set_num_threads(max(1, cores // world_size))
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size), rank=rank,
                                world_size=world_size, timeout=datetime.timedelta(seconds=group_s))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def launch(fn, world_size: int, args: tuple = (), device_type: str = "cuda", timeout: float = 600.0) -> list:
    """Run fn(*args) on `world_size` ranks -> their results in rank order.
    The ranks sit on the card(s) unless device_type="cpu". Raises
    RuntimeError when a rank fails, dies, or has given no result `timeout`
    seconds after the start (then every rank is terminated, whatever its
    process group would still wait for)."""
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device_type='cpu' to run the ranks on the CPU")
        build_kernels()
    backend = backend_for(device_type, world_size)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="ptt-world-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(rank, world_size, backend, device_type, store, max(timeout, _GROUP_TIMEOUT_S), fn,
                              args, results))
            for rank in range(world_size)
        ]
        for p in procs:
            p.start()
        done: dict[int, object] = {}
        failure = None
        exited: list[int] = []
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world_size and failure is None:
                try:
                    rank, ok, payload = results.get(timeout=_POLL_S)
                except queue_mod.Empty:
                    # A rank that exited is dead once a whole poll after it found its result unsent.
                    dead = [r for r in exited if r not in done]
                    exited = [r for r, p in enumerate(procs) if r not in done and p.exitcode is not None]
                    if dead:
                        failure = (f"rank(s) {dead} of {world_size} exited (codes "
                                   f"{[procs[r].exitcode for r in dead]}) without a result")
                    elif time.monotonic() > deadline:
                        waiting = [r for r in range(world_size) if r not in done]
                        failure = (f"rank(s) {waiting} of {world_size} gave no result within {timeout:.0f} s "
                                   "(hung, or waiting on a collective another rank never joined)")
                    continue
                if ok:
                    done[rank] = payload
                else:
                    failure = f"rank {rank} of {world_size} failed:\n{payload}"
        finally:
            for p in procs:
                if p.is_alive() and (failure is not None or len(done) < world_size):
                    p.terminate()
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"launch({getattr(fn, '__name__', fn)}, {world_size} ranks over {backend}): {failure}")
    return [done[r] for r in range(world_size)]
