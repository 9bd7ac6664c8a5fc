"""The launcher of ``benchmark --mesh WxV``: W·V ranks in one
``torch.distributed`` world.

The JAX driver takes its mesh from the devices of one process; here every
rank of the mesh is a process of its own:

* the ranks are spawned with ``torch.multiprocessing`` (start method
  "spawn": a rank imports the module of its function afresh, and nothing of
  the parent's state);
* they meet at a ``FileStore`` in a temporary directory, so no TCP port is
  opened;
* the backend follows the cards (``backend``): NCCL when every rank has a
  card of its own, whose communicators are made when the ranks join;
  gloo where ranks share a card (NCCL refuses two ranks on one device; gloo
  stages CUDA tensors through the host) or run on the CPU.  This program
  picks it: the library (``parallel.make_mesh``) never picks a backend;
* rank r runs on ``cuda:(r % device_count)``, or on the CPU with one thread
  a rank (a world of ranks that each take every core runs ten times
  slower);
* every collective has a time limit, and the world has one, counted from
  when every rank has joined (so that the ranks' start, the import of
  torch, is not charged to it): a rank that raises, exits non-zero or
  outlasts it fails the run, with that rank's traceback, and the other
  ranks are stopped.

``run`` spawns every rank and waits for their results.  ``World`` makes
the calling process rank 0 (on ``cuda:0``, or the CPU) and spawns the
others, which run in the background while rank 0 drives them; a spawned
rank that fails ends the calling process too, after its traceback, and no
rank outlives the calling process.
"""

from __future__ import annotations

import atexit
import ctypes
import datetime
import faulthandler
import os
import pickle
import shutil
import signal
import sys
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

COLLECTIVE_LIMIT = 600.0   # s: a collective that waits longer raises
WORLD_LIMIT = 3600.0       # s: the whole world, joined within it
JOIN_LIMIT = 600.0         # s: every rank joins the store within it
LEAVE_LIMIT = 120.0        # s: a rank leaves the process group within it


def backend(world: int, device: str) -> str:
    """"nccl" when each of ``world`` ranks on ``device`` has a card of its
    own, else "gloo"."""
    if device == "cuda" and dist.is_nccl_available() and \
            torch.cuda.is_available() and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _die_with_parent() -> None:
    """This process gets SIGKILL when the process that spawned it dies."""
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)   # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def _join(rank: int, world: int, tmp: str, device: str, kind: str):
    """This rank's device, after it joins the world's process group."""
    if device == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(
        kind, store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_LIMIT),
        device_id=dev if kind == "nccl" else None)
    open(os.path.join(tmp, f"rank{rank}.joined"), "w").close()
    return dev


def _rank(i: int, first: int, world: int, tmp: str, device: str, kind: str,
          fn, args) -> None:
    rank = first + i
    _die_with_parent()
    if device != "cuda":
        torch.set_num_threads(1)
    dev = _join(rank, world, tmp, device, kind)
    try:
        try:
            result = fn(rank, dev, *args)
        except Exception:
            with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
                f.write(traceback.format_exc())
            raise
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        # a rank that cannot leave prints where it waits, and exits
        faulthandler.dump_traceback_later(LEAVE_LIMIT, exit=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _spawn(fn, world: int, first: int, tmp: str, device: str, kind: str,
           args: tuple, daemon: bool):
    return mp.start_processes(
        _rank, args=(first, world, tmp, device, kind, fn, args),
        nprocs=world - first, join=False, daemon=daemon,
        start_method="spawn")


def _joined(tmp: str, world: int, mark: str = "joined",
            first: int = 0) -> bool:
    """Whether ranks first..world-1 have left their mark (``joined``, or
    ``pkl``: a result)."""
    return all(os.path.exists(os.path.join(tmp, f"rank{r}.{mark}"))
               for r in range(first, world))


def _stop(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()


def run(fn, world: int, device: str, args: tuple = (),
        limit: float = WORLD_LIMIT) -> list:
    """Run fn(rank, device, *args) (a module-level function) on ``world``
    spawned ranks of one process group on ``device`` ("cuda" or "cpu"), and
    return each rank's result, in rank order.  Raises RuntimeError, with the
    failed rank's traceback, when a rank raises or exits non-zero, when the
    ranks do not all join within ``JOIN_LIMIT`` seconds, and when the world
    outlasts ``limit`` seconds from then; the other ranks are stopped."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the ranks; pass device 'cpu'")
    tmp = tempfile.mkdtemp(prefix="ectrans_world_")
    try:
        ctx = _spawn(fn, world, 0, tmp, device, backend(world, device), args,
                     daemon=False)
        deadline = time.monotonic() + JOIN_LIMIT
        joined = False
        try:
            while not ctx.join(timeout=1):
                if not joined and _joined(tmp, world):
                    joined = True
                    deadline = time.monotonic() + limit
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"the {world}-rank world outlasted its {limit:.0f} s "
                        "limit" if joined else f"the {world}-rank world did "
                        f"not join within {JOIN_LIMIT:.0f} s")
        except ProcessException as e:
            raise RuntimeError(_failure(tmp, ctx.processes, e, 0)) from None
        finally:
            _stop(ctx.processes)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


class World:
    """A world of ``world`` ranks in which this process is rank 0: ranks
    1..world-1 are spawned and run fn(rank, device, *args) (a module-level
    function) in the background, and this process joins as rank 0 on
    ``cuda:0`` (or the CPU; its threads are left as they are).  When
    ``__init__`` returns, every rank has joined the process group.

    A spawned rank that raises or exits non-zero ends this process with
    exit code 1, after that rank's traceback on standard error, since rank
    0 may be waiting on the device for a collective that will not come;
    the other ranks are stopped.  The spawned ranks die with this process.
    ``close`` (once the spawned ranks' functions return) meets them at
    their last barrier, waits within ``limit`` seconds for them to end and
    leaves the process group."""

    def __init__(self, fn, world: int, device: str, args: tuple = (),
                 limit: float = COLLECTIVE_LIMIT):
        if device == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the ranks; pass device "
                               "'cpu'")
        self.world, self.limit = world, limit
        self.kind = backend(world, device)
        self.tmp = tempfile.mkdtemp(prefix="ectrans_world_")
        self.ctx = _spawn(fn, world, 1, self.tmp, device, self.kind, args,
                          daemon=True)
        self._closing = False
        self._failed = None
        self._watch = threading.Thread(target=self._watch_ranks, daemon=True)
        self._watch.start()
        atexit.register(self._end)
        self.device = _join(0, world, self.tmp, device, self.kind)

    def _watch_ranks(self) -> None:
        try:
            while not self.ctx.join(timeout=1):
                pass
        except ProcessException as e:
            if self._closing:
                self._failed = _failure(self.tmp, [None] + self.ctx.processes,
                                        e, 1)
                return
            print(_failure(self.tmp, [None] + self.ctx.processes, e, 1),
                  file=sys.stderr, flush=True)
            _stop(self.ctx.processes)
            os._exit(1)

    def close(self) -> None:
        """Meets the spawned ranks, once their functions return (they end
        their own loops), at their last barrier, leaves the process group
        with them (NCCL's teardown waits for every rank) and waits for them
        to end; raises RuntimeError with the traceback of a rank that
        failed, or when they outlast the limit."""
        self._closing = True
        faulthandler.dump_traceback_later(LEAVE_LIMIT)
        try:
            dist.barrier()              # the spawned ranks' last barrier
            dist.destroy_process_group()
            self._watch.join(timeout=self.limit)
            if self._watch.is_alive():
                raise RuntimeError(f"the ranks of the {self.world}-rank world "
                                   f"did not end within {self.limit:.0f} s")
            if self._failed and not _joined(self.tmp, self.world, "pkl", 1):
                raise RuntimeError(self._failed)
            if self._failed:            # after every rank's result
                print(f"{self._failed} (after its result)", file=sys.stderr)
        finally:
            faulthandler.cancel_dump_traceback_later()
            self._end()

    def _end(self) -> None:
        self._closing = True
        _stop(self.ctx.processes)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.tmp, ignore_errors=True)
        atexit.unregister(self._end)


def _failure(tmp: str, procs: list, e: Exception, first: int) -> str:
    """What failed the world: the first rank whose function raised (its
    traceback), else the first that died without a result (its exit code),
    else the first to exit non-zero (a collective that lost its peers).
    ``procs[r]`` is rank r's process (None for this process)."""
    world = len(procs)
    for r in range(world):
        path = os.path.join(tmp, f"rank{r}.err")
        if os.path.exists(path):
            with open(path) as f:
                return f"rank {r} of the {world}-rank world failed:\n{f.read()}"
    for r in range(first, world):
        if not os.path.exists(os.path.join(tmp, f"rank{r}.pkl")):
            return (f"rank {r} of the {world}-rank world failed: it exited "
                    f"with exit code {procs[r].exitcode} and no result")
    return (f"rank {e.error_index + first} of the {world}-rank world failed: "
            f"{e}")
