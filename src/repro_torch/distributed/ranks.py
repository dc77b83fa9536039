"""Spawned ranks on one host: ``world`` processes joined in a gloo group.

    results = spawn_ranks(fn, 4, path, device="cuda")

runs ``fn(path)`` in 4 new processes (``torch.multiprocessing`` spawn),
each after ``torch.distributed`` has been initialised as rank r of a gloo
group of 4, and returns what each returned, in rank order.  The ranks
meet through a ``file://`` rendezvous in a fresh temporary directory, so
parallel callers never race for a TCP port.  ``device="cuda"`` sets each
rank's current device to ``rank % device_count`` before the group forms
(every rank on ``cuda:0`` on a one-card machine: gloo, unlike NCCL, lets
several ranks share a device); ``"cpu"`` leaves CUDA alone.

``fn`` is pickled by reference, so it is a module-level function, and it
returns a picklable host value.  A rank that raises, or that has not
ended ``JOIN_TIMEOUT_S`` seconds after the spawn, makes the call raise
once every rank has been stopped: it never returns a partial result.
"""
from __future__ import annotations

import datetime
import faulthandler
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List

#: Seconds the whole group may take, from the spawn to the last exit.
JOIN_TIMEOUT_S = 600.0
#: gloo's own limit on one collective, so a rank whose peer died raises
#: instead of waiting out the join.
COLLECTIVE_TIMEOUT_S = 300.0


def _result_path(workdir: str, rank: int) -> str:
    return os.path.join(workdir, f"result-{rank}.pkl")


def _rank_main(rank: int, fn: Callable, world: int, workdir: str,
               device: str, args, dump_after: float) -> None:
    # a rank still running near the join's end prints every thread's
    # stack to stderr before it is stopped
    faulthandler.dump_traceback_later(dump_after)
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.cuda.init()
    elif device != "cpu":
        raise ValueError(f"device must be 'cpu' or 'cuda', not {device!r}")
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "rendezvous"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        out = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        faulthandler.cancel_dump_traceback_later()
    tmp = _result_path(workdir, rank) + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(out, fh)
    os.replace(tmp, _result_path(workdir, rank))


def _rank_errors(error_files) -> List[str]:
    out = []
    for rank, path in enumerate(error_files):
        if os.path.exists(path) and os.path.getsize(path):
            with open(path, "rb") as fh:
                out.append(f"-- rank {rank}:\n{pickle.load(fh)}")
    return out


def spawn_ranks(fn: Callable, world: int, *args: Any,
                device: str) -> List[Any]:
    """``fn(*args)`` on ``world`` spawned gloo ranks; their results in
    rank order (see the module docstring)."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException
    with tempfile.TemporaryDirectory(prefix="repro-ranks-") as workdir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, workdir, device, args,
                              max(1.0, JOIN_TIMEOUT_S - 20)),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while not ctx.join(timeout=max(0.0,
                                           deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world} spawned ranks did not end within "
                        f"{JOIN_TIMEOUT_S:.0f} s")
        except ProcessException as e:
            # The first failure seen is often a peer's lost connection:
            # name every rank that raised, with its traceback.
            msgs = _rank_errors(ctx.error_files)
            raise RuntimeError("spawned ranks failed:\n"
                               + ("\n".join(msgs) or str(e))) from e
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for rank in range(world):
            with open(_result_path(workdir, rank), "rb") as fh:
                results.append(pickle.load(fh))
        return results
