"""Spectral-layout conversions between packed NASM0 and dense (c, m, n).

Counterpart of ``ectrans_tpu/ops/layout.py`` (reference PRFI1B/UPDSP per-m
copies, ``prfi1b_mod.F90``, ``updsp_mod.F90``), as index gathers with the
maps of ``resolution.build_packed_maps``.  The direct transform does not use
``dense_to_packed``: it packs with the compaction kernel of ``ops.pack``
straight from the Legendre kernels' m-major rows.
"""

from __future__ import annotations

import torch


def packed_to_dense(spec: torch.Tensor, tables) -> torch.Tensor:
    """(nfld, nspec2) -> (nfld, 2, M, NP); exact zeros outside
    m <= n <= nsmax (those entries gather the appended zero slot)."""
    specp = torch.nn.functional.pad(spec, (0, 1))
    return specp[:, tables.dense_gather]


def dense_to_packed(dense: torch.Tensor, res) -> torch.Tensor:
    """(nfld, 2, M, NP) -> (nfld, nspec2): a per-element gather."""
    idx = res.cached(("packed_gather", str(dense.device)), lambda: tuple(
        torch.as_tensor(a, device=dense.device) for a in
        (res.packed_gather_c, res.packed_gather_m, res.packed_gather_n)))
    return dense[:, idx[0], idx[1], idx[2]]
