"""The (w, v) process mesh of the distributed transforms.

Counterpart of ``ectrans_tpu/parallel/mesh.py``.  The reference's process
grid (``sump_trans0_mod.F90``: NPRTRW wave sets x NPRTRV field sets) is a
2-D mesh of the ranks of a ``torch.distributed`` process group, with axes

* ``"w"`` — the wave/latitude axis (NPRTRW): zonal wavenumber blocks in
  spectral space, latitude blocks in Fourier space;
* ``"v"`` — the field/level axis (NPRTRV): fields in spectral and Fourier
  space, a further latitude split in grid space.

Rank r of the group sits at (iw, iv) = divmod(r, v), the row-major order of
JAX's ``Mesh(devices.reshape(w, v))``.  The transpositions of ``comm.py``
run over a w-line (the ranks that share an iv) or a v-line (the ranks that
share an iw); ``make_mesh`` makes one process group per line of more than
one rank that is not the whole mesh.

A line of one rank has no group (its collectives are the identity), a line
of the whole mesh is the mesh's group, and any other line is a group of its
own, made by ``dist.new_group``, which every rank of the default group must
enter: a mesh with w > 1 and v > 1 is therefore built on the default group,
by every rank, and each rank makes every line, w-lines first, in the same
order.  (With ``use_local_synchronization`` a group's name hashes the count
of groups each rank has made, so ranks that made different subgroups before
wait for each other under different names; that hangs.)

The caller initialises the process group and chooses its backend: NCCL with
a card per rank, gloo where ranks share a card or run on the CPU.  Nothing
here picks or changes a backend.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

# line groups made so far: ranks -> (default group, line group); every rank
# makes the same lines in the same order, so every rank finds the same ones
_LINES: dict = {}


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of a (w, v) mesh over a process group."""

    w: int
    v: int
    group: object           # the mesh's process group
    rank: int               # this rank's place in the mesh, iw * v + iv
    w_group: object         # this rank's w-line; None when w == 1
    v_group: object         # this rank's v-line; None when v == 1
    device: torch.device

    @property
    def iw(self) -> int:
        return self.rank // self.v

    @property
    def iv(self) -> int:
        return self.rank % self.v


def _line(ranks: tuple, mesh_group, n: int):
    """The process group of one mesh line: None for a single rank, the
    mesh's group for all of it, else a group of its own (every rank of the
    default group enters ``new_group`` for it)."""
    if len(ranks) == 1:
        return None
    if len(ranks) == n:
        return mesh_group
    world = dist.group.WORLD
    made = _LINES.get(ranks)
    if made is None or made[0] is not world:
        made = (world, dist.new_group(list(ranks)))
        _LINES[ranks] = made
    return made[1]


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass "
                           "device='cpu' for a mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(w: int | None = None, v: int | None = None, group=None,
              device=None) -> Mesh:
    """This rank's (w, v) mesh over ``group`` (the default process group
    when None); every rank of the group calls it with the same arguments.
    A mesh with w > 1 and v > 1 makes process groups for its lines and
    must be built on the default group.

    Defaults: all ranks on "w" (``make_mesh()`` is (n, 1)); with one of w,
    v given the other is n divided by it; w * v must be the group's size.
    ``device``: where this rank's tensors live, by default
    ``cuda:{LOCAL_RANK % device_count}`` (the global rank when LOCAL_RANK
    is not set).
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: "
                           "call torch.distributed.init_process_group first")
    group = dist.group.WORLD if group is None else group
    rank = dist.get_rank(group)
    if rank < 0:
        raise ValueError("make_mesh: this rank is not in the given group")
    n = dist.get_world_size(group)
    if w is None and v is None:
        w, v = n, 1
    elif w is None:
        w = n // v
    elif v is None:
        v = n // w
    if w < 1 or v < 1 or w * v != n:
        raise ValueError(f"a {w} x {v} mesh needs {w * v} ranks; the group "
                         f"has {n}")
    if w > 1 and v > 1 and n != dist.get_world_size():
        raise ValueError(f"a {w} x {v} mesh makes process groups of its "
                         "lines, which every rank of the default group must "
                         "make: build it on the default group")
    ranks = tuple(dist.get_process_group_ranks(group))
    iw, iv = divmod(rank, v)
    # every rank makes every line, in the same order: w-lines, then v-lines
    lines = [[_line(tuple(ranks[a * v + b] for a in range(w)), group, n)
              for b in range(v)],
             [_line(tuple(ranks[a * v + b] for b in range(v)), group, n)
              for a in range(w)]]
    w_group, v_group = lines[0][iv], lines[1][iw]
    device = _default_device() if device is None else torch.device(device)
    return Mesh(w=w, v=v, group=group, rank=rank, w_group=w_group,
                v_group=v_group, device=device)


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a ``Mesh``; anything else is refused."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a Mesh from make_mesh, got "
                        f"{type(mesh).__name__}")
    return mesh
