"""Field checksums for decomposition-invariance testing.

Counterpart of ``ectrans_tpu/utils/checksum.py``: the reference asserts
bit-identical CRC64 checksums of transform outputs across every MPI x
OpenMP decomposition (``tests/compare_checksums.py``,
``tests/CMakeLists.txt:232-241``).  The digest is that of the JAX package
for the same bytes, so outputs of both packages compare by digest.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def field_checksum(arr) -> str:
    """Deterministic digest of an array's exact bits (dtype + shape + data);
    a tensor on any device is read back to the host."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.ascontiguousarray(np.asarray(arr))
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(a.shape).encode())
    h.update(a.tobytes())
    return h.hexdigest()[:16]
