"""Parity-split grouped Legendre transforms (the "pallas" engine), kernels K5
and K6.

Counterpart of the parity half of ``ectrans_tpu/ops/legendre_pallas.py``:
the inverse contracts the parity coefficients sym/asym of
``layout.dense_to_parity`` against the tables of
``Resolution.grouped_legendre`` (psym[m, i, k] = P̄_{m+2k}^m(mu_i),
pasym[m, i, k] = P̄_{m+2k+1}^m(mu_i)) and recombines north = fs + fa,
south = fs - fa; the direct transform contracts the quadrature-weighted
symmetric and antisymmetric Fourier combinations against the same tables.

Kernels (``csrc/legendre_grouped.cu``) run for CUDA tensors; CPU tensors
take the plain versions (``torch.bmm`` per group in the working dtype).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .legendre_dense import group_rows, hemispheres_to_fourier


def group_inv_plain(sym, asym, psym, pasym):
    """Plain version of K5: (gm, fc2, kg) x (gm, ig, kg) -> (north, south)."""
    fs = torch.bmm(sym, psym.transpose(1, 2))
    fa = torch.bmm(asym, pasym.transpose(1, 2))
    return fs + fa, fs - fa


def group_inv(sym: torch.Tensor, asym: torch.Tensor, psym: torch.Tensor,
              pasym: torch.Tensor):
    """One group's inverse LT (K5; replaces ``legendre_pallas.group_inv``):
    coefficients sym, asym (gm, fc2, kg) x tables psym, pasym (gm, ig, kg)
    -> (north, south), each (gm, fc2, ig), south NOT latitude-reversed."""
    if _build.on_cpu(sym):
        return group_inv_plain(sym, asym, psym, pasym)
    gm, fc2, kg = sym.shape
    ig = psym.shape[1]
    _build.check_operand("sym", sym, sym, (gm, fc2, kg))
    _build.check_operand("asym", asym, sym, (gm, fc2, kg))
    _build.check_operand("psym", psym, sym, (gm, ig, kg))
    _build.check_operand("pasym", pasym, sym, (gm, ig, kg))
    north = torch.empty((gm, fc2, ig), dtype=sym.dtype, device=sym.device)
    south = torch.empty_like(north)
    if north.numel() == 0:
        return north.zero_(), south.zero_()
    with torch.cuda.device(sym.device):
        _build.launch("ect_inv_grouped", sym.dtype, sym.data_ptr(),
                      asym.data_ptr(), psym.data_ptr(), pasym.data_ptr(),
                      north.data_ptr(), south.data_ptr(), gm, fc2, kg, ig)
    group_inv.launches += 1
    return north, south


group_inv.launches = 0


def group_dir_plain(fsym, fasym, psym, pasym):
    """Plain version of K6: (gm, fc2, ig) x (gm, ig, kg) -> (sym, asym)."""
    return torch.bmm(fsym, psym), torch.bmm(fasym, pasym)


def group_dir(fsym: torch.Tensor, fasym: torch.Tensor, psym: torch.Tensor,
              pasym: torch.Tensor):
    """One group's direct LT (K6; replaces ``legendre_pallas.group_dir``):
    weighted symmetric/antisymmetric Fourier rows fsym, fasym (gm, fc2, ig)
    x tables (gm, ig, kg) -> (sym, asym), each (gm, fc2, kg)."""
    if _build.on_cpu(fsym):
        return group_dir_plain(fsym, fasym, psym, pasym)
    gm, fc2, ig = fsym.shape
    kg = psym.shape[2]
    _build.check_operand("fsym", fsym, fsym, (gm, fc2, ig))
    _build.check_operand("fasym", fasym, fsym, (gm, fc2, ig))
    _build.check_operand("psym", psym, fsym, (gm, ig, kg))
    _build.check_operand("pasym", pasym, fsym, (gm, ig, kg))
    sym = torch.empty((gm, fc2, kg), dtype=fsym.dtype, device=fsym.device)
    asym = torch.empty_like(sym)
    if sym.numel() == 0:
        return sym, asym
    with torch.cuda.device(fsym.device):
        _build.launch("ect_dir_grouped", fsym.dtype, fsym.data_ptr(),
                      fasym.data_ptr(), psym.data_ptr(), pasym.data_ptr(),
                      sym.data_ptr(), asym.data_ptr(), gm, fc2, kg, ig)
    group_dir.launches += 1
    return sym, asym


group_dir.launches = 0


def legendre_inv_grouped(sym: torch.Tensor, asym: torch.Tensor,
                         gl) -> torch.Tensor:
    """Inverse LT: sym/asym (nfld, 2, M, kmax) -> (nfld, 2, M, ndgl)
    Fourier coefficients, latitudes north -> south (gl: GroupedLegendre)."""
    return torch.cat([
        hemispheres_to_fourier(*group_inv(
            group_rows(sym[..., :g.kg], g), group_rows(asym[..., :g.kg], g),
            g.psym, g.pasym), g, sym.shape[0])
        for g in gl.groups], dim=2)


def parity_fourier(fourier: torch.Tensor, ndgnh: int, w: torch.Tensor):
    """Quadrature-weighted symmetric and antisymmetric combinations of the
    northern and (NH-paired) southern rows, each (nfld, 2, M, ndgnh)."""
    north = fourier[..., :ndgnh]
    south = fourier[..., ndgnh:].flip(-1)
    return (north + south) * w, (north - south) * w


def legendre_dir_grouped(fourier: torch.Tensor, gl, w: torch.Tensor):
    """Direct LT: (nfld, 2, M, ndgl) Fourier coefficients + NH weights w
    (ndgnh,) -> (sym, asym), each (nfld, 2, M, kmax)."""
    nfld = fourier.shape[0]
    fsym_all, fasym_all = parity_fourier(fourier, gl.ndgnh, w)
    syms, asyms = [], []
    for g in gl.groups:
        s, a = group_dir(group_rows(fsym_all[..., g.i0:], g),
                         group_rows(fasym_all[..., g.i0:], g), g.psym,
                         g.pasym)
        for out, x in ((syms, s), (asyms, a)):
            out.append(F.pad(x.transpose(0, 1).reshape(nfld, 2, -1, g.kg),
                             (0, gl.kmax - g.kg)))
    return torch.cat(syms, dim=2), torch.cat(asyms, dim=2)
