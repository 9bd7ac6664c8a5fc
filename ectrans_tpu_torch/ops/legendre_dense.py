"""Dense-row Legendre transforms (inverse and direct), kernels K1 and K2.

Counterpart of the dense-row half of ``ectrans_tpu/ops/legendre_pallas.py``:
the inverse contracts diagonal-realigned dense spectral rows
d2[f, c, m, j] = dense[f, c, m, m+j] against the full-n tables of
``Resolution.full_legendre`` (pn[m, j, i] = P̄_{m+j}^m(mu_i)); the direct
transform contracts quadrature-weighted Fourier rows against the same tables
and returns the kernels' native m-major rows.  The southern hemisphere comes
from the parity identity P̄_n^m(-mu) = (-1)^(n-m) P̄_n^m(mu) inside the
kernels.

Kernels (``csrc/legendre_dense.cu``) run for CUDA tensors; CPU tensors take
the plain PyTorch versions (``torch.bmm`` per group in the working dtype).
Realignment past a row's diagonal end reads neighbouring rows' data; it is
cancelled by the exact zeros of the tables (past n = nsmax+1, and where
m > nmen(lat)).  ``group_rows``, ``hemispheres_to_fourier`` and
``weighted_rows`` (one group's kernel operand rows, and the assembly of
its outputs) serve the "pallas" and "planes" engines too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .layout import diag_realign


def _jsgn(J: int, like: torch.Tensor) -> torch.Tensor:
    """(J,) parity sign: +1 for even j, -1 for odd j."""
    j = torch.arange(J, device=like.device)
    return (1 - 2 * (j & 1)).to(like.dtype)


def group_inv_dense_plain(d2: torch.Tensor, pn: torch.Tensor):
    """Plain version of K1: (gm, fc2, J) x (gm, J, ig) -> (north, south)."""
    north = torch.bmm(d2, pn)
    south = torch.bmm(d2 * _jsgn(d2.shape[-1], d2), pn)
    return north, south


def group_inv_dense(d2: torch.Tensor, pn: torch.Tensor):
    """One group's inverse LT (K1; replaces ``legendre_pallas.group_inv_dense``):
    rows d2 (gm, fc2, J) x table pn (gm, J, ig) -> (north, south), each
    (gm, fc2, ig); north = sum_j d2_j P_j, south = sum_j (-1)^j d2_j P_j
    (south NOT latitude-reversed)."""
    if _build.on_cpu(d2):
        return group_inv_dense_plain(d2, pn)
    gm, fc2, J = d2.shape
    ig = pn.shape[-1]
    _build.check_operand("d2", d2, d2, (gm, fc2, J))
    _build.check_operand("pn", pn, d2, (gm, J, ig))
    north = torch.empty((gm, fc2, ig), dtype=d2.dtype, device=d2.device)
    south = torch.empty_like(north)
    if north.numel() == 0:
        return north.zero_(), south.zero_()
    with torch.cuda.device(d2.device):
        _build.launch("ect_inv_dense", d2.dtype, d2.data_ptr(), pn.data_ptr(),
                      north.data_ptr(), south.data_ptr(), gm, fc2, J, ig)
    group_inv_dense.launches += 1
    return north, south


group_inv_dense.launches = 0


def group_dir_dense_plain(fn: torch.Tensor, fs: torch.Tensor,
                          pn: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: fn, fs (gm, fc2, ig) x pn (gm, J, ig) -> (gm, fc2, J)."""
    pt = pn.transpose(1, 2)
    a = torch.bmm(fn, pt)
    b = torch.bmm(fs, pt)
    return a + b * _jsgn(pn.shape[1], a)


def group_dir_dense(fn: torch.Tensor, fs: torch.Tensor,
                    pn: torch.Tensor) -> torch.Tensor:
    """One group's direct LT (K2; replaces ``legendre_pallas.group_dir_dense``):
    weighted north/south Fourier rows fn, fs (gm, fc2, ig) x table pn
    (gm, J, ig) -> realigned rows out_j = sum_i fn_i P_ji + (-1)^j sum_i fs_i P_ji."""
    if _build.on_cpu(fn):
        return group_dir_dense_plain(fn, fs, pn)
    gm, fc2, ig = fn.shape
    J = pn.shape[1]
    _build.check_operand("fn", fn, fn, (gm, fc2, ig))
    _build.check_operand("fs", fs, fn, (gm, fc2, ig))
    _build.check_operand("pn", pn, fn, (gm, J, ig))
    out = torch.empty((gm, fc2, J), dtype=fn.dtype, device=fn.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(fn.device):
        _build.launch("ect_dir_dense", fn.dtype, fn.data_ptr(), fs.data_ptr(),
                      pn.data_ptr(), out.data_ptr(), gm, fc2, J, ig)
    group_dir_dense.launches += 1
    return out


group_dir_dense.launches = 0


def group_rows(x: torch.Tensor, g) -> torch.Tensor:
    """(a, b, M, W) -> one m-group's contiguous (gm, a*b, W) rows, row
    index i*b + j (f*2 + c for the (nfld, 2, ...) layout, c*nfld + f for
    its c-major transpose)."""
    a, b, _, width = x.shape
    return x[:, :, g.m0:g.m1].reshape(a * b, g.m1 - g.m0, width) \
        .transpose(0, 1).contiguous()


def hemispheres_to_fourier(north: torch.Tensor, south: torch.Tensor,
                           g, nfld: int) -> torch.Tensor:
    """One group's kernel outputs (gm, 2*nfld, ig), rows f*2 + c, south not
    latitude-reversed -> (nfld, 2, gm, ndgl) Fourier coefficients north ->
    south, zero at the group's inactive latitudes."""
    gm = g.m1 - g.m0
    north = north.transpose(0, 1).reshape(nfld, 2, gm, -1)
    south = south.transpose(0, 1).reshape(nfld, 2, gm, -1).flip(-1)
    return torch.cat([F.pad(north, (g.i0, 0)), F.pad(south, (0, g.i0))],
                     dim=-1)


def weighted_rows(fourier: torch.Tensor, ndgnh: int, w: torch.Tensor):
    """c-major quadrature-weighted northern rows and NH-paired southern
    rows, each (2, nfld, M, ndgnh)."""
    fc = fourier.transpose(0, 1)
    return fc[..., :ndgnh] * w, fc[..., ndgnh:].flip(-1) * w


def legendre_inv_dense(dense: torch.Tensor, fl) -> torch.Tensor:
    """Inverse LT: (nfld, 2, M, NP) dense spectral -> (nfld, 2, M, ndgl)
    Fourier coefficients, latitudes north -> south (fl: FullLegendre)."""
    nfld = dense.shape[0]
    d2 = diag_realign(dense)
    return torch.cat([
        hemispheres_to_fourier(*group_inv_dense(
            group_rows(d2[..., :g.J], g), g.pn), g, nfld)
        for g in fl.groups], dim=2)


def legendre_dir_rows(fourier: torch.Tensor, fl, w: torch.Tensor) -> list:
    """Direct LT in the kernels' native m-major layout: (nfld, 2, M, ndgl)
    Fourier coefficients + NH quadrature weights w (ndgnh,) -> list of
    per-group (gm, 2*nfld, J) realigned rows, row index c*nfld + f."""
    fn_all, fs_all = weighted_rows(fourier, fl.ndgnh, w)
    return [group_dir_dense(group_rows(fn_all[..., g.i0:], g),
                            group_rows(fs_all[..., g.i0:], g), g.pn)
            for g in fl.groups]
