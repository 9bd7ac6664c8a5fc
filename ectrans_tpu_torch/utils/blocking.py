"""NPROMA grid-point blocking (reference PGP layout parity).

Counterpart of ``ectrans_tpu/utils/blocking.py``.  ecTrans callers exchange
grid-point data in NPROMA-blocked arrays ``PGP(NPROMA, NFLD, NGPBLKS)`` over
the locally-owned reduced-grid points (``inv_trans.F90:58-106``; INIGPTR
``inigptr_mod.F90``).  This package's native grid layout is the padded
(nfld, ndgl, ndlon) tensor; these converters serve callers porting
NPROMA-shaped code and bitwise output comparison with the reference.  They
run on the device of the given tensor (numpy arrays go to the CPU).
"""

from __future__ import annotations

import numpy as np
import torch


def _point_index(grid, device: torch.device):
    """(lat, lon) indices of each reduced-grid point in lat-major order."""
    nloen = np.asarray(grid.nloen, np.int64)
    lat = np.repeat(np.arange(grid.ndgl), nloen)
    lon = np.concatenate([np.arange(n) for n in nloen])
    return (torch.as_tensor(lat, device=device),
            torch.as_tensor(lon, device=device))


def fields_to_blocked(fields, grid, nproma: int) -> torch.Tensor:
    """(nfld, ndgl, ndlon) padded tensor -> (nproma, nfld, ngpblks) blocked.

    Points are ordered lat-major over the reduced grid (the serial-run
    ordering of the reference); the last block is zero-padded.
    """
    fields = torch.as_tensor(fields)
    lat, lon = _point_index(grid, fields.device)
    flat = fields[:, lat, lon]                     # (nfld, ngptot)
    nfld, ngptot = flat.shape
    ngpblks = -(-ngptot // nproma)
    padded = flat.new_zeros((nfld, ngpblks * nproma))
    padded[:, :ngptot] = flat
    return padded.reshape(nfld, ngpblks, nproma).permute(2, 0, 1).contiguous()


def blocked_to_fields(blocked, grid) -> torch.Tensor:
    """(nproma, nfld, ngpblks) -> (nfld, ndgl, ndlon) padded tensor."""
    blocked = torch.as_tensor(blocked)
    nproma, nfld, ngpblks = blocked.shape
    flat = blocked.permute(1, 2, 0).reshape(nfld, ngpblks * nproma)
    lat, lon = _point_index(grid, blocked.device)
    out = blocked.new_zeros((nfld, grid.ndgl, grid.ndlon))
    out[:, lat, lon] = flat[:, : lat.numel()]
    return out
