"""The launcher of ``benchmark --mesh WxV``: W·V ranks in one
``torch.distributed`` world.

The JAX driver takes its mesh from the devices of one process; here every
rank of the mesh is a process of its own:

* the ranks are spawned with ``torch.multiprocessing`` (start method
  "spawn": a rank imports the module of its function afresh, and nothing of
  the parent's state);
* they meet at a ``FileStore`` in a temporary directory, so no TCP port is
  opened;
* the backend is gloo.  NCCL refuses two ranks on one device, and a mesh on
  one card puts several ranks on it; gloo runs anywhere, staging CUDA
  tensors through the host.  This program picks it: the library
  (``parallel.make_mesh``) never picks a backend;
* rank r runs on ``cuda:(r % device_count)``, or on the CPU with one thread
  a rank (a world of ranks that each take every core runs ten times
  slower);
* every collective has a time limit, and the world has one: a rank that
  raises, exits non-zero or outlasts it fails the run, with that rank's
  traceback, and the other ranks are stopped.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

COLLECTIVE_LIMIT = 600.0   # s: a collective that waits longer raises
WORLD_LIMIT = 3600.0       # s: the whole world, joined within it


def _rank(rank: int, world: int, tmp: str, device: str, fn, args) -> None:
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_LIMIT))
    try:
        try:
            result = fn(rank, dev, *args)
        except Exception:
            with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            raise
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run(fn, world: int, device: str, args: tuple = (),
        limit: float = WORLD_LIMIT) -> list:
    """Run fn(rank, device, *args) (a module-level function) on ``world``
    spawned ranks of one gloo group on ``device`` ("cuda" or "cpu"), and
    return each rank's result, in rank order.  Raises RuntimeError, with the
    failed rank's traceback, when a rank raises or exits non-zero, and when
    the world outlasts ``limit`` seconds; the other ranks are stopped."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the ranks; pass device 'cpu'")
    tmp = tempfile.mkdtemp(prefix="ectrans_world_")
    try:
        ctx = mp.start_processes(_rank, args=(world, tmp, device, fn, args),
                                 nprocs=world, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + limit
        try:
            while not ctx.join(timeout=1):
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the {world}-rank world outlasted "
                                       f"its {limit:.0f} s limit")
        except ProcessException as e:
            raise RuntimeError(_failure(tmp, ctx.processes, e)) from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _failure(tmp: str, procs: list, e: Exception) -> str:
    """What failed the world: the first rank whose function raised (its
    traceback), else the first that died without a result (its exit code),
    else the first to exit non-zero (a collective that lost its peers)."""
    world = len(procs)
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                return f"rank {r} of the {world}-rank world failed:\n{f.read()}"
    for r in range(world):
        if not os.path.exists(os.path.join(tmp, f"rank{r}.pkl")):
            return (f"rank {r} of the {world}-rank world failed: it exited "
                    f"with exit code {procs[r].exitcode} and no result")
    return f"rank {e.error_index} of the {world}-rank world failed: {e}"
