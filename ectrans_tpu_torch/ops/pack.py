"""Packed-layout compaction: m-major rows -> NASM0 packed, kernel K3.

Counterpart of ``ectrans_tpu/ops/pack_pallas.py``.  The direct transform
emits the ecTrans user spectral layout, per-m blocks of interleaved (re, im)
coefficients at offsets NASM0 (``suwavedi_mod.F90``; reference UPDSP,
``updsp_mod.F90``), straight from the direct Legendre kernel's rows: per
m-group (gm, 2*nfld, J), row c*nfld + f, column j = n - m.  The groups are
those of ``Resolution.legendre_groups`` (the tables' groups), so the dense
(nfld, 2, M, NP) tensor is never formed.

The "pallas" engine's direct transform has the dense tensor instead:
``dense_to_packed`` realigns it into the same per-group rows (the
counterpart of ``pack_pallas.dense_to_packed``/``packed_from_mmajor``).

CUDA tensors go through the kernel (``csrc/pack.cu``); CPU tensors through
the plain index gather.  Both copy values without arithmetic (bit-exact).
``pack_kernel()`` reads ``ECTRANS_TPU_PACK_KERNEL``: at "xla" the direct
transform of every engine goes to the dense layout and packs with the index
gather (``layout.dense_to_packed``) instead.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import _build
from .layout import diag_realign


def pack_kernel() -> str:
    """The direct transform's packing, as ``ECTRANS_TPU_PACK_KERNEL``
    selects: "xla" (the index gather from the dense layout) or "kernel"
    (K3; "auto", the default, and "force", which in the JAX package runs
    its kernel in interpret mode on the CPU)."""
    return ("xla" if os.environ.get("ECTRANS_TPU_PACK_KERNEL", "auto") == "xla"
            else "kernel")


def _segments(res) -> list:
    """Per group: (m0, m1, seg0, seg1), the packed range of its m-blocks."""
    nasm0 = res.nasm0
    out = []
    for m0, m1, _, _ in res.legendre_groups():
        seg1 = int(nasm0[m1]) if m1 < res.M else res.nspec2
        out.append((m0, m1, int(nasm0[m0]), seg1))
    return out


def _gather_index(res, device: torch.device) -> list:
    """Per group: (m - m0, c, j) of each packed position of its segment."""
    def build():
        out = []
        for m0, _, seg0, seg1 in _segments(res):
            sl = slice(seg0, seg1)
            m = res.packed_gather_m[sl]
            idx = (m - m0, res.packed_gather_c[sl], res.packed_gather_n[sl] - m)
            out.append(tuple(torch.as_tensor(np.ascontiguousarray(a),
                                             device=device) for a in idx))
        return out

    return res.cached(("pack_gather", str(device)), build)


def packed_from_group_rows_plain(rows_list: list, res) -> torch.Tensor:
    """Plain version of K3: an index gather per group."""
    nfld = rows_list[0].shape[1] // 2
    f = torch.arange(nfld, device=rows_list[0].device)[:, None]
    segs = []
    for rows, (ml, c, j) in zip(rows_list, _gather_index(res, rows_list[0].device)):
        segs.append(rows[ml[None, :], c[None, :] * nfld + f, j[None, :]])
    return torch.cat(segs, dim=1)


def packed_from_group_rows(rows_list: list, res) -> torch.Tensor:
    """Per-group c-major m-major realigned rows [(gm, 2*nfld, Jg), ...]
    (one entry per group of ``res.legendre_groups()``) -> packed
    (nfld, nspec2).  Replaces ``pack_pallas.packed_from_group_rows``
    (kernel ``_compact_group``); one kernel launch per group."""
    segs = _segments(res)
    if len(rows_list) != len(segs):
        raise ValueError(f"{len(rows_list)} row groups for {len(segs)} "
                         "Legendre groups")
    first = rows_list[0]
    if _build.on_cpu(first):
        return packed_from_group_rows_plain(rows_list, res)
    nfld = first.shape[1] // 2
    out = torch.empty((nfld, res.nspec2), dtype=first.dtype,
                      device=first.device)
    tables = res.device_tables(first.dtype, first.device)
    with torch.cuda.device(first.device):
        for rows, (m0, m1, seg0, seg1) in zip(rows_list, segs):
            jrow = rows.shape[2]
            _build.check_operand("rows", rows, first, (m1 - m0, 2 * nfld, jrow))
            if jrow < res.nsmax + 1 - m0:
                raise ValueError(f"rows of group m0={m0} hold {jrow} degrees, "
                                 f"need {res.nsmax + 1 - m0}")
            _build.launch("ect_compact", first.dtype, rows.data_ptr(),
                          tables.nasm0.data_ptr(), out.data_ptr(), nfld, jrow,
                          m0, m1, seg0, seg1 - seg0, res.nspec2)
            packed_from_group_rows.launches += 1
    return out


packed_from_group_rows.launches = 0


def dense_to_packed(dense: torch.Tensor, res) -> torch.Tensor:
    """(nfld, 2, M, NP) dense -> (nfld, nspec2) packed through K3: realign
    the diagonals (a pad + reshape), go m-major and c-major, then one launch
    per group.  Entries of the rows past each m's last degree are
    neighbouring rows' data, which the packing never reads."""
    nfld, _, M, NP = dense.shape
    mm = diag_realign(dense).permute(2, 1, 0, 3).reshape(M, 2 * nfld, NP + 1)
    return packed_from_group_rows(
        [mm[m0:m1, :, :min(J, NP + 1)].contiguous()
         for m0, m1, _, J in res.legendre_groups()], res)
