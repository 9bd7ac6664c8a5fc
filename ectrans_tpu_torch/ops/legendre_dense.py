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
m > nmen(lat)).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build


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


def _diag_realign(dense: torch.Tensor) -> torch.Tensor:
    """(nfld, 2, M, NP) -> (nfld, 2, M, NP+1) with d2[..., m, j] =
    dense[..., m, m+j]: a pad + reshape (m*(W+1) + j = m*W + (m+j)); entries
    past each row's diagonal end are neighbouring rows' data."""
    f, c, M, W = dense.shape
    flat = F.pad(dense.reshape(f, c, M * W), (0, M))
    return flat.reshape(f, c, M, W + 1)


def _diag_unalign(d2: torch.Tensor, NP: int) -> torch.Tensor:
    """Inverse of _diag_realign: dense[..., m, n] = d2[..., m, n-m] (entries
    at n < m are neighbouring rows' data)."""
    f, c, M, W1 = d2.shape
    return d2.reshape(f, c, M * W1)[..., : M * NP].reshape(f, c, M, NP)


def legendre_inv_dense(dense: torch.Tensor, fl) -> torch.Tensor:
    """Inverse LT: (nfld, 2, M, NP) dense spectral -> (nfld, 2, M, ndgl)
    Fourier coefficients, latitudes north -> south (fl: FullLegendre)."""
    nfld = dense.shape[0]
    fc2 = 2 * nfld
    d2 = _diag_realign(dense)
    parts = []
    for g in fl.groups:
        gm = g.m1 - g.m0
        dg = d2[:, :, g.m0:g.m1, :g.J].reshape(fc2, gm, g.J)
        north, south = group_inv_dense(dg.transpose(0, 1).contiguous(), g.pn)
        north = north.transpose(0, 1).reshape(nfld, 2, gm, -1)
        south = south.transpose(0, 1).reshape(nfld, 2, gm, -1).flip(-1)
        parts.append(torch.cat([F.pad(north, (g.i0, 0)),
                                F.pad(south, (0, g.i0))], dim=-1))
    return torch.cat(parts, dim=2)


def legendre_dir_rows(fourier: torch.Tensor, fl, w: torch.Tensor) -> list:
    """Direct LT in the kernels' native m-major layout: (nfld, 2, M, ndgl)
    Fourier coefficients + NH quadrature weights w (ndgnh,) -> list of
    per-group (gm, 2*nfld, J) realigned rows, row index c*nfld + f."""
    nfld = fourier.shape[0]
    fc2 = 2 * nfld
    ndgnh = fl.ndgnh
    fc = fourier.transpose(0, 1)                    # (2, nfld, M, ndgl)
    fn_all = fc[..., :ndgnh] * w
    fs_all = fc[..., ndgnh:].flip(-1) * w           # SH paired with NH index
    rows = []
    for g in fl.groups:
        gm = g.m1 - g.m0
        fn = fn_all[:, :, g.m0:g.m1, g.i0:].reshape(fc2, gm, -1)
        fs = fs_all[:, :, g.m0:g.m1, g.i0:].reshape(fc2, gm, -1)
        rows.append(group_dir_dense(fn.transpose(0, 1).contiguous(),
                                    fs.transpose(0, 1).contiguous(), g.pn))
    return rows
