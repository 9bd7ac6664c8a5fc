"""Collectives of the distributed transforms on ``torch.distributed``.

The PyTorch counterparts of the ``lax.all_to_all(..., tiled=True)`` and
``lax.psum`` calls of ``ectrans_tpu/parallel/sharded.py`` and
``ectrans_tpu/lam/sharded.py``, over one line of a ``Mesh`` (a process
group, or None for a line of one rank, where every collective is the
identity), plus the uneven exchange of latitude rows that stands in for the
JAX package's gathers at the grid boundary (``x[:, lat_pos]`` on a sharded
array, which XLA lowers to collectives of its own), and the rooted
scatter and gather of DIST_* and GATH_* (``scatter``, ``gather``: point to
point between the root and each rank, the reference's owner rank).

``TRAFFIC`` counts the bytes each rank sends, by the caller's tag
(TRMTOL, TRLTOG, ...); while the span recorder is on, the same bytes are
its counter ``sent.<tag>`` (``utils.timing.count``).
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from ..utils.timing import count

TRAFFIC: collections.Counter = collections.Counter()


def _sent(tag: str, nbytes: int) -> None:
    TRAFFIC[tag] += nbytes
    count("sent." + tag, nbytes)


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
    _sent(tag, xs.numel() * xs.element_size() * (n - 1) // n)
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
    _sent(tag, x.numel() * x.element_size())
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
    _sent(tag, row * (sum(send) - send[me]))
    return out


def _peer(group, r: int) -> int:
    """The global rank of rank r of ``group``."""
    if group is None or group is dist.group.WORLD:
        return r
    return dist.get_global_rank(group, r)


def _p2p(ops: list) -> None:
    """Runs the point-to-point operations as one batch; on NCCL the wait
    orders the current stream after them and leaves the host free."""
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def scatter(parts, shape, like: torch.Tensor, group, root: int,
            tag: str = "dist") -> torch.Tensor:
    """Rooted scatter of uneven parts, point to point: on the root
    ``parts`` holds each rank's tensor, in rank order, and its own is
    returned; every other rank passes None and receives a tensor of
    ``shape`` in the dtype and on the device of ``like``."""
    if group is None:
        return parts[0]
    me = dist.get_rank(group)
    if me == root:
        ops = []
        for r, x in enumerate(parts):
            if r != root:
                x = x.contiguous()
                ops.append(dist.P2POp(dist.isend, x, _peer(group, r), group))
                _sent(tag, x.numel() * x.element_size())
        _p2p(ops)
        return parts[root]
    out = like.new_empty(shape)
    _p2p([dist.P2POp(dist.irecv, out, _peer(group, root), group)])
    return out


def gather(x: torch.Tensor, senders, shapes, group, root: int,
           tag: str = "gath"):
    """Rooted gather, point to point: each rank of ``senders`` (group
    ranks, in order) sends x to the root, which returns the list of their
    tensors in that order (its own x in its place; ``shapes`` gives each
    one's shape); the other ranks return None."""
    if group is None:
        return [x]
    me = dist.get_rank(group)
    if me != root:
        if me in senders:
            x = x.contiguous()
            _p2p([dist.P2POp(dist.isend, x, _peer(group, root), group)])
            _sent(tag, x.numel() * x.element_size())
        return None
    out, ops = [], []
    for r, shape in zip(senders, shapes):
        if r == root:
            out.append(x)
            continue
        buf = x.new_empty(shape)
        ops.append(dist.P2POp(dist.irecv, buf, _peer(group, r), group))
        out.append(buf)
    _p2p(ops)
    return out
