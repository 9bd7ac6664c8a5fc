"""Distributed transforms over a (w, v) mesh of ``torch.distributed`` ranks
(counterpart of ``ectrans_tpu/parallel``)."""

from .distribution import Distribution, build_distribution  # noqa: F401
from .mesh import Mesh, make_mesh  # noqa: F401
from .sharded import ShardedTransform  # noqa: F401
