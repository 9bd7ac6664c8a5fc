"""Global transforms on a (w, v) mesh driven from one process.

``DrivenTransform`` is rank 0 of a ``world.World``: a caller that holds
whole-globe spectra and grids, as one process on one device does, calls
``inv`` and ``dir`` with them; the other ranks, spawned on their own cards,
run ``follow``.  Each call is the IFS's: the root scatters the call's
fields to the ranks (DIST_SPEC or DIST_GRID with the root as owner), every
rank runs its share of the distributed transform
(``SpectralTransform(mesh=make_mesh(w, v))``, the default KVSET), and the
root gathers the result (GATH_GRID or GATH_SPEC), all on the device.

The other ranks learn each call, its direction and field counts, from a
message that rank 0 writes to a pipe of each (host to host, outside
``torch.distributed``) before it enqueues its own part, so rank 0's host
never waits for them; on NCCL nothing in a call makes rank 0's host wait
for its device.
"""

from __future__ import annotations

import torch
import torch.multiprocessing as mp

from ..api import SpectralTransform
from ..parallel import make_mesh
from ..parallel.sharded import default_kvset
from ..transform import InvFlags
from . import world

INV, DIR, STOP = 1, 2, 0
ROOT = 0


def _kv(n: int, v: int) -> list:
    return default_kvset(n, v) if n else []


def _transform(grid, truncation, w, v, dtype, precision, dev):
    return SpectralTransform(grid, truncation,
                             mesh=make_mesh(w, v, device=dev), dtype=dtype,
                             precision=precision)


def dist_spec(st, x, kv: list):
    """DIST_SPEC from the root: this rank's fields of a family (None for
    an empty one); x, the global spectra, on the root only."""
    return st.dist_spec(x, kv, root=ROOT) if kv else None


def gath_grid(st, g):
    """GATH_GRID to the root: the global grid there, None elsewhere."""
    return st.gath_grid(g, root=ROOT)


def dist_grid(st, x, n: int):
    """DIST_GRID from the root: this rank's block of rows of a family of n
    fields (None for none); x, the global grid, on the root only."""
    return st.dist_grid(x, root=ROOT, nfld=n) if n else None


def gath_spec(st, x, kv: list):
    """GATH_SPEC to the root: the family's global spectra there."""
    return st.gath_spec(x, kv, root=ROOT) if kv else None


def _inv(st, flags, nuv: int, nsc: int, vor=None, div=None, sc=None):
    """One inverse call on this rank; the global grid on the root."""
    kvuv, kvsc = _kv(nuv, st.mesh.v), _kv(nsc, st.mesh.v)
    g = st.inv_trans(dist_spec(st, vor, kvuv), dist_spec(st, div, kvuv),
                     dist_spec(st, sc, kvsc), flags=flags, kvsetuv=kvuv,
                     kvsetsc=kvsc)
    return gath_grid(st, g)


def _dir(st, nuv: int, nsc: int, u=None, v=None, sc=None):
    """One direct call on this rank; the global spectra on the root."""
    kvuv, kvsc = _kv(nuv, st.mesh.v), _kv(nsc, st.mesh.v)
    out = st.dir_trans(dist_grid(st, u, nuv), dist_grid(st, v, nuv),
                       dist_grid(st, sc, nsc), kvsetuv=kvuv, kvsetsc=kvsc)
    return tuple(gath_spec(st, x, kv)
                 for x, kv in zip(out, (kvuv, kvuv, kvsc)))


def follow(rank: int, dev, calls_in: list, grid, truncation, w, v, dtype,
           precision, flags) -> int:
    """A rank other than the root: runs the root's calls, read from its
    pipe ``calls_in[rank - 1]``, on its share until the root says stop;
    returns the number of calls."""
    st = _transform(grid, truncation, w, v, dtype, precision, dev)
    pipe = calls_in[rank - 1]
    calls = 0
    while True:
        op, nuv, nsc = pipe.recv()
        if op == STOP:
            return calls
        if op == INV:
            _inv(st, flags, nuv, nsc)
        else:
            _dir(st, nuv, nsc)
        calls += 1


class DrivenTransform:
    """Rank 0 of a (w, v) mesh of w*v ranks, one a card on "cuda" (NCCL)
    or processes on the CPU (gloo), driving the others: ``inv`` takes
    global spectra (nfld, nspec2) and returns the global grid (nout, ndgl,
    ndlon); ``dir`` takes global grids (nfld, ndgl, ndlon) and returns the
    global spectra; both on this process's device.  ``close`` stops the
    other ranks and leaves the world."""

    def __init__(self, grid, truncation=None, w: int = 2, v: int = 2,
                 dtype=torch.float32, precision: str = "highest",
                 flags: InvFlags = InvFlags(), device: str = "cuda"):
        if device == "cuda":
            from .. import _build

            _build.build()          # once, before the ranks look for it
        self.flags = flags
        pipes = [mp.get_context("spawn").Pipe(duplex=False)
                 for _ in range(w * v - 1)]
        self.calls_out = [out for _, out in pipes]
        self.world = world.World(
            follow, w * v, device,
            ([inp for inp, _ in pipes], grid, truncation, w, v, dtype,
             precision, flags))
        for inp, _ in pipes:
            inp.close()
        self.st = _transform(grid, truncation, w, v, dtype, precision,
                             self.world.device)
        self.res = self.st.res

    @property
    def backend(self) -> str:
        return self.world.kind

    def _tell(self, op: int, nuv: int, nsc: int) -> None:
        """The call to the other ranks, without waiting for them."""
        for out in self.calls_out:
            out.send((op, nuv, nsc))

    def inv(self, vor=None, div=None, sc=None):
        nuv = 0 if vor is None else vor.shape[0]
        nsc = 0 if sc is None else sc.shape[0]
        self._tell(INV, nuv, nsc)
        return _inv(self.st, self.flags, nuv, nsc, vor, div, sc)

    def dir(self, u=None, v=None, sc=None):
        nuv = 0 if u is None else u.shape[0]
        nsc = 0 if sc is None else sc.shape[0]
        self._tell(DIR, nuv, nsc)
        return _dir(self.st, nuv, nsc, u, v, sc)

    def close(self) -> None:
        if self.world is None:
            return
        self._tell(STOP, 0, 0)
        self.st = None
        try:
            self.world.close()
        finally:
            self.world = None
            for out in self.calls_out:
                out.close()
