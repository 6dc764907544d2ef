"""Host process worlds: the port's counterpart of ``repro/hostdevices.py``.

JAX fakes N host devices inside one process (XLA's forced host device
count) and drives a whole mesh from it.  PyTorch's idiom is one process
per rank, so the sharded round engine (``repro_torch.fl.sharded``) is
exercised on the CPU by spawning N ranks, each running the same host
pipeline from the same seed over a gloo process group.

    results = spawn_world(2, run_rank, cfg)   # run_rank(cfg) on ranks 0, 1

``fn`` must be a module-level function: ``torch.multiprocessing.spawn``
starts fresh interpreters that import ``fn``'s module to find it.  Each
rank joins the group through a ``torch.distributed.FileStore`` in a new
temporary directory, so no port is fixed and concurrent worlds (pytest
workers, say) never meet.  A rank that raises fails the call (the others
are terminated), and so does a world that outlives ``timeout``.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
from typing import Any, Callable, List

import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, n: int, backend: str, workdir: str, timeout: float,
               fn: Callable, args: tuple) -> None:
    store = dist.FileStore(os.path.join(workdir, "store"), n)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    path = os.path.join(workdir, f"rank{rank}.pkl")
    with open(path + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".tmp", path)


def spawn_world(n: int, fn: Callable, *args, backend: str = "gloo",
                timeout: float = 300.0) -> List[Any]:
    """Run ``fn(*args)`` on ranks 0..n-1 of a new ``backend`` process group
    and return each rank's (picklable) result, by rank.

    Raises ``torch.multiprocessing.ProcessRaisedException`` (or
    ``ProcessExitedException``) when a rank fails, and ``TimeoutError``
    when the world has not finished after ``timeout`` seconds; collectives
    time out after the same span."""
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as workdir:
        ctx = mp.spawn(_rank_main, args=(n, backend, workdir, timeout, fn, args),
                       nprocs=n, join=False)
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.terminate()
                for p in ctx.processes:
                    p.join()
                raise TimeoutError(f"spawn_world: {n} ranks did not finish "
                                   f"within {timeout} s")
        results = []
        for rank in range(n):
            with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
