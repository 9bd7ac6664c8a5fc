"""Process groups for the distributed tests of ``ectrans_tpu_torch`` on the
CPU: a world of one rank in this process, and worlds of several spawned
ranks over gloo.

A spawned rank imports the module that defines its function, and this one,
but never jax or ectrans_tpu: test modules that spawn ranks import those
inside their test functions.  Each world meets at a ``FileStore`` under the
test's temporary directory (no TCP port, so parallel test workers never
collide), and has a time limit of its own: a rank that raises, exits
non-zero or outlasts the limit fails the world.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_LIMIT = 60     # s: a collective that waits longer raises


@contextlib.contextmanager
def one_rank_world(tmp_path):
    """A gloo process group of this process alone, destroyed on exit."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store1"), 1), rank=0,
        world_size=1,
        timeout=datetime.timedelta(seconds=COLLECTIVE_LIMIT))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rank(rank: int, world: int, store: str, out: str, fn) -> None:
    torch.set_num_threads(1)     # ranks share the test worker's cores
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_LIMIT))
    try:
        try:
            result = fn(rank)
        except Exception:
            result = {"error": traceback.format_exc()}
            raise
        finally:
            with open(os.path.join(out, f"rank{rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


class World:
    """``world`` spawned ranks running fn(rank) (a module-level function)
    in the background; ``results()`` joins them within ``limit`` seconds
    and returns each rank's result, in rank order."""

    def __init__(self, fn, tmp_dir, world: int = 4, limit: float = 300.0):
        self.dir = str(tmp_dir)
        self.world = world
        self.deadline = time.monotonic() + limit
        self.limit = limit
        self._results = None
        self.ctx = mp.start_processes(
            _rank, args=(world, os.path.join(self.dir, "store"), self.dir,
                         fn),
            nprocs=world, join=False, start_method="spawn")

    def results(self) -> list:
        if self._results is None:
            try:
                while not self.ctx.join(timeout=1):
                    if time.monotonic() > self.deadline:
                        raise RuntimeError(
                            f"the {self.world}-rank world outlasted its "
                            f"{self.limit:.0f} s limit")
            finally:
                self.stop()
            out = []
            for r in range(self.world):
                with open(os.path.join(self.dir, f"rank{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            self._results = out
        return self._results

    def stop(self) -> None:
        for p in self.ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
