"""Packed-layout compaction: m-major rows -> NASM0 packed, kernel K3.

Counterpart of ``ectrans_tpu/ops/pack_pallas.py``.  The direct transform
emits the ecTrans user spectral layout, per-m blocks of interleaved (re, im)
coefficients at offsets NASM0 (``suwavedi_mod.F90``; reference UPDSP,
``updsp_mod.F90``), straight from the direct Legendre kernel's rows: per
m-group (gm, 2*nfld, J), row c*nfld + f, column j = n - m.  The groups are
those of ``Resolution.legendre_groups(ngroups)`` (the tables' groups; the
``ECTRANS_TPU_LEG_GROUPS`` count when ``ngroups`` is None), so the dense
(nfld, 2, M, NP) tensor is never formed.

The "pallas" engine's direct transform has the dense tensor instead:
``dense_to_packed`` realigns it into the same per-group rows (the
counterpart of ``pack_pallas.dense_to_packed``/``packed_from_mmajor``).

CUDA tensors go through the kernel (``csrc/pack.cu``, one launch for all
groups, however many: up to 16 the groups' descriptors travel in the
launch's parameters, past 16 in a device array the launch fills); CPU
tensors through the plain index gather.  Both copy values
without arithmetic (bit-exact).
``pack_kernel()`` reads ``ECTRANS_TPU_PACK_KERNEL``: at "xla" the direct
transform of every engine goes to the dense layout and packs with the index
gather (``layout.dense_to_packed``) instead.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .. import _build
from ..resolution import leg_groups
from .layout import diag_realign

K3_PARAM_GROUPS = 16   # groups whose descriptors fit K3's parameter block


def pack_kernel() -> str:
    """The direct transform's packing, as ``ECTRANS_TPU_PACK_KERNEL``
    selects: "xla" (the index gather from the dense layout) or "kernel"
    (K3; "auto", the default, and "force", which in the JAX package runs
    its kernel in interpret mode on the CPU)."""
    return ("xla" if os.environ.get("ECTRANS_TPU_PACK_KERNEL", "auto") == "xla"
            else "kernel")


def _ngroups(res, ngroups: int | None) -> int:
    return leg_groups(res.M) if ngroups is None else ngroups


def segments(res, ngroups: int | None = None) -> tuple:
    """Per group of ``res.legendre_groups(ngroups)``: (m0, m1, seg0, seg1),
    the packed range of its m-blocks (cached on the Resolution)."""
    ngroups = _ngroups(res, ngroups)

    def build():
        nasm0 = res.nasm0
        return tuple((m0, m1, int(nasm0[m0]),
                      int(nasm0[m1]) if m1 < res.M else res.nspec2)
                     for m0, m1, _, _ in res.legendre_groups(ngroups))

    return res.cached(("pack_segments", ngroups), build)


def _gather_index(res, device: torch.device,
                  ngroups: int | None = None) -> list:
    """Per group: (m - m0, c, j) of each packed position of its segment."""
    ngroups = _ngroups(res, ngroups)

    def build():
        out = []
        for m0, _, seg0, seg1 in segments(res, ngroups):
            sl = slice(seg0, seg1)
            m = res.packed_gather_m[sl]
            idx = (m - m0, res.packed_gather_c[sl], res.packed_gather_n[sl] - m)
            out.append(tuple(torch.as_tensor(np.ascontiguousarray(a),
                                             device=device) for a in idx))
        return out

    return res.cached(("pack_gather", str(device), ngroups), build)


def packed_from_group_rows_plain(rows_list: list, res,
                                 ngroups: int | None = None) -> torch.Tensor:
    """Plain version of K3: an index gather per group."""
    nfld = rows_list[0].shape[1] // 2
    f = torch.arange(nfld, device=rows_list[0].device)[:, None]
    segs = []
    index = _gather_index(res, rows_list[0].device, ngroups)
    if len(index) != len(rows_list):
        raise ValueError(f"{len(rows_list)} row groups for {len(index)} "
                         "Legendre groups")
    for rows, (ml, c, j) in zip(rows_list, index):
        segs.append(rows[ml[None, :], c[None, :] * nfld + f, j[None, :]])
    return torch.cat(segs, dim=1)


def _launch_groups(res, ngroups: int | None = None) -> tuple:
    """K3's per-resolution constants: each group's first m as a C int array
    (the launch's parameter block), (m0, m1 - m0, the fewest degrees its
    rows may hold) per group, nsmax and nspec2 (cached on the
    Resolution)."""
    ngroups = _ngroups(res, ngroups)

    def build():
        segs = segments(res, ngroups)
        m0s = (ctypes.c_int * len(segs))(*(m0 for m0, _, _, _ in segs))
        return (m0s, tuple((m0, m1 - m0, res.nsmax + 1 - m0)
                           for m0, m1, _, _ in segs), res.nsmax, res.nspec2)

    return res.cached(("pack_launch", ngroups), build)


def _check_rows(rows_list: list, shapes: tuple) -> None:
    """Raise on the first group whose rows the kernel does not take."""
    first = rows_list[0]
    nfld = first.shape[1] // 2
    for rows, (m0, gm, need) in zip(rows_list, shapes):
        _build.check_operand("rows", rows, first,
                             (gm, 2 * nfld, rows.shape[-1]))
        if rows.shape[2] < need:
            raise ValueError(f"rows of group m0={m0} hold {rows.shape[2]} "
                             f"degrees, need {need}")


def packed_from_group_rows(rows_list: list, res,
                           ngroups: int | None = None) -> torch.Tensor:
    """Per-group c-major m-major realigned rows [(gm, 2*nfld, Jg), ...]
    (one entry per group of ``res.legendre_groups(ngroups)``, Jg at least
    the group's nsmax + 1 - m0 degrees) -> packed (nfld, nspec2).  Replaces
    ``pack_pallas.packed_from_group_rows`` (kernel ``_compact_group``): one
    kernel launch for all groups, after one cheap shape check a group (the
    host's time a call shows beside the kernel's ~0.06 ms at TCO1279); past
    16 groups the launch also fills a small device array of the groups'
    descriptors (16 bytes a group)."""
    ngroups = _ngroups(res, ngroups)
    m0s, shapes, nsmax, nspec2 = _launch_groups(res, ngroups)
    if len(rows_list) != len(shapes):
        raise ValueError(f"{len(rows_list)} row groups for {len(shapes)} "
                         "Legendre groups")
    first = rows_list[0]
    if _build.on_cpu(first):
        return packed_from_group_rows_plain(rows_list, res, ngroups)
    nrow = first.shape[1]
    dtype, device = first.dtype, first.device
    ptrs, jrow = [], []
    for rows, (_, gm, need) in zip(rows_list, shapes):
        shape = rows.shape
        if not (len(shape) == 3 and shape[0] == gm and shape[1] == nrow
                and shape[2] >= need and rows.dtype == dtype
                and rows.device == device and rows.is_contiguous()):
            _check_rows(rows_list, shapes)
        ptrs.append(rows.data_ptr())
        jrow.append(shape[2])
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"rows have dtype {dtype}, expected float32 or "
                        "float64")
    if nrow % 2:
        raise ValueError(f"rows hold {nrow} field rows, expected 2 * nfld")
    out = torch.empty((nrow // 2, nspec2), dtype=dtype, device=device)
    n = len(ptrs)
    # past K3_PARAM_GROUPS the descriptors go through a device array
    desc = (None if n <= K3_PARAM_GROUPS else
            torch.empty(2 * n, dtype=torch.int64, device=device))
    with _build.on_device(first):
        _build.launch("ect_compact", dtype, (ctypes.c_void_p * n)(*ptrs),
                      m0s, (ctypes.c_int * n)(*jrow), n,
                      None if desc is None else desc.data_ptr(),
                      out.data_ptr(), nrow // 2, nsmax, nspec2)
    packed_from_group_rows.launches += 1
    return out


packed_from_group_rows.launches = 0


def packed_from_group_rows_shape(nfld: int, nsmax: int) -> dict:
    """K3's launch for nfld fields at truncation nsmax on the current CUDA
    device (``_build.launch_shape``)."""
    return _build.launch_shape("ect_compact_shape", None, nfld, nsmax)


def dense_to_packed(dense: torch.Tensor, res,
                    ngroups: int | None = None) -> torch.Tensor:
    """(nfld, 2, M, NP) dense -> (nfld, nspec2) packed through K3: realign
    the diagonals (a pad + reshape), go m-major and c-major, then K3's one
    launch.  Entries of the rows past each m's last degree are
    neighbouring rows' data, which the packing never reads."""
    nfld, _, M, NP = dense.shape
    mm = diag_realign(dense).permute(2, 1, 0, 3).reshape(M, 2 * nfld, NP + 1)
    ngroups = _ngroups(res, ngroups)
    return packed_from_group_rows(
        [mm[m0:m1, :, :min(J, NP + 1)].contiguous()
         for m0, m1, _, J in res.legendre_groups(ngroups)], res, ngroups)
