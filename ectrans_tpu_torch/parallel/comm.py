"""Collectives of the distributed transforms on ``torch.distributed``.

The PyTorch counterparts of the ``lax.all_to_all(..., tiled=True)`` and
``lax.psum`` calls of ``ectrans_tpu/parallel/sharded.py`` and
``ectrans_tpu/lam/sharded.py``, over one line of a ``Mesh`` (a process
group, or None for a line of one rank, where every collective is the
identity), plus the uneven exchange of latitude rows that stands in for the
JAX package's gathers at the grid boundary (``x[:, lat_pos]`` on a sharded
array, which XLA lowers to collectives of its own).

``TRAFFIC`` counts the bytes each rank sends, by the caller's tag
(TRMTOL, TRLTOG, ...).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

TRAFFIC: collections.Counter = collections.Counter()


def all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int,
               tag: str = "all_to_all") -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over ``group``: chunk k of ``split_axis`` goes to the k-th rank of the
    group, and the chunks received are concatenated along ``concat_axis``
    in source-rank order."""
    if group is None:
        return x
    n = dist.get_world_size(group)
    xs = x.movedim(split_axis, 0).contiguous()
    if xs.shape[0] % n:
        raise ValueError(f"split axis of {xs.shape[0]} does not divide "
                         f"into {n} ranks")
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=group)
    TRAFFIC[tag] += xs.numel() * xs.element_size() * (n - 1) // n
    # (n, c, rest...): chunk of source rank k, split axis first
    y = out.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    y = y.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(y.shape)
    shape[concat_axis: concat_axis + 2] = [n * shape[concat_axis + 1]]
    return y.reshape(shape)


def all_reduce_sum(x: torch.Tensor, group, tag: str = "all_reduce"):
    """``jax.lax.psum(x, axis)`` over ``group``; reduces a contiguous x in
    place (a copy of it otherwise) and returns it."""
    if group is None:
        return x
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    TRAFFIC[tag] += x.numel() * x.element_size()
    return x


def exchange(x: torch.Tensor, group, send: list, recv: list,
             tag: str = "exchange") -> torch.Tensor:
    """Uneven all-to-all along the leading axis: the first send[0] entries
    of x go to rank 0 of ``group``, the next send[1] to rank 1, ...;
    returns the recv[k] entries from each rank k, in rank order."""
    if group is None:
        return x
    x = x.contiguous()
    out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
    dist.all_to_all_single(out, x, output_split_sizes=list(recv),
                           input_split_sizes=list(send), group=group)
    me = dist.get_rank(group)
    row = x[0].numel() * x.element_size() if x.shape[0] else 0
    TRAFFIC[tag] += row * (sum(send) - send[me])
    return out
