"""Fourier layer: per-latitude real DFTs on ``torch.fft``.

Counterpart of ``synthesis_bucketed``/``analysis_bucketed`` in
``ectrans_tpu/ops/fourier.py`` (reference FTINV/FTDIR, ``ftinv_mod.F90``;
GPU per-NLOEN plan cache, ``hicfft.cuda.cu:136-160``).  Latitudes are
batched by identical NLOEN: one real FFT per distinct length.

Contract (``tpm_fftw.F90:251-377``):

* synthesis (nfld, 2, M, ndgl) -> (nfld, ndgl, ndlon) is unnormalized,
  f_j = F_0 + 2 sum_{m=1}^{nmen} Re(F_m e^{i m lambda_j}), modes above the
  row's nmen and the imaginary part of m = 0 are ignored;
* analysis (nfld, ndgl, ndlon) -> (nfld, 2, M, ndgl) divides by NLOEN and
  returns zero above the row's nmen;
* grid points past a row's NLOEN are exactly 0 on output and ignored on
  input.

``irfft`` reads the Nyquist bin differently from 2 Re(.), so rows with
2 nmen >= NLOEN (lat-lon output grids) are refused.

Both directions are linear, and each one's transpose is the other one
scaled row by row (``_Synthesis``, ``_Analysis``): autograd through them
(the adjoints of ``adjoint.py``) takes two FFT calls a row batch, as the
forward does, and the cotangents of the ignored inputs (m = 0 imaginary
parts, modes above nmen, points past NLOEN) are exactly 0, as
``jax.linear_transpose`` gives them.  The JAX package's
chirp-z / four-step / real-FFT machinery and its RMS pair normalization
exist because the TPU backend has no FFT op or complex dtype; they are not
ported.
"""

from __future__ import annotations

import numpy as np
import torch


def _plan(res, device: torch.device) -> dict:
    """Row batches by NLOEN and the (ndgl, M) mask m <= nmen(row)."""
    def build():
        nloen = np.asarray(res.grid.nloen, np.int64)
        nmen = np.minimum(np.asarray(res.nmen, np.int64), res.nsmax)
        bad = np.nonzero(2 * nmen >= nloen)[0]
        if bad.size:
            raise ValueError(
                f"rows {bad[:5].tolist()} have 2*nmen >= NLOEN: the Nyquist "
                "mode is not supported by this Fourier layer")
        batches = [(int(L), torch.as_tensor(np.nonzero(nloen == L)[0],
                                             device=device))
                   for L in np.unique(nloen)]
        mask = torch.as_tensor(np.arange(res.M)[None, :] <= nmen[:, None],
                               device=device)
        return dict(batches=batches, mask=mask)

    return res.cached(("fourier_plan", str(device)), build)


def _adjoint_scale(res, device: torch.device, dtype: torch.dtype):
    """(2, M, ndgl) c_m * NLOEN(row), c_0 = 1 and c_m = 2 above (0 on the
    m = 0 imaginary part): synthesis^T = this * analysis."""
    def build():
        nloen = np.asarray(res.grid.nloen, np.float64)
        c = np.where(np.arange(res.M) == 0, 1.0, 2.0)
        s = np.broadcast_to(c[:, None] * nloen[None, :], (2, res.M, res.ndgl))
        s = s.copy()
        s[1, 0] = 0.0
        return torch.tensor(s, dtype=dtype, device=device)

    return res.cached(("fourier_adjoint_scale", dtype, str(device)), build)


class _Synthesis(torch.autograd.Function):
    """synthesis with its transpose: the grid cotangent's analysis times
    c_m * NLOEN (``_adjoint_scale``)."""

    @staticmethod
    def forward(ctx, fourier, res):
        ctx.res = res
        return _synthesis(fourier, res)

    @staticmethod
    def backward(ctx, grad):
        res = ctx.res
        return (_analysis(grad, res)
                * _adjoint_scale(res, grad.device, grad.dtype), None)


class _Analysis(torch.autograd.Function):
    """analysis with its transpose: the synthesis of the Fourier cotangent
    divided by c_m * NLOEN (the m = 0 imaginary part, which analysis leaves
    at 0 whatever the grid, is ignored by synthesis)."""

    @staticmethod
    def forward(ctx, grid, res):
        ctx.res = res
        return _analysis(grid, res)

    @staticmethod
    def backward(ctx, grad):
        res = ctx.res
        scale = _adjoint_scale(res, grad.device, grad.dtype)
        return _synthesis(grad / scale[0], res), None


def synthesis(fourier: torch.Tensor, res) -> torch.Tensor:
    """(nfld, 2, M, ndgl) Fourier coefficients -> (nfld, ndgl, ndlon) grid."""
    return _Synthesis.apply(fourier, res)


def analysis(grid: torch.Tensor, res) -> torch.Tensor:
    """(nfld, ndgl, ndlon) grid -> (nfld, 2, M, ndgl) Fourier coefficients."""
    return _Analysis.apply(grid, res)


def _synthesis(fourier: torch.Tensor, res) -> torch.Tensor:
    nfld, _, M, ndgl = fourier.shape
    if M != res.M or ndgl != res.ndgl:
        raise ValueError(f"synthesis expects (nfld, 2, {res.M}, {res.ndgl}), "
                         f"got {tuple(fourier.shape)}")
    plan = _plan(res, fourier.device)
    # (ndgl, nfld, M) complex, rows leading so each batch is one gather
    spec = torch.view_as_complex(fourier.permute(3, 0, 2, 1).contiguous())
    spec = spec * plan["mask"][:, None, :]
    spec[..., 0] = spec[..., 0].real.to(spec.dtype)
    out = fourier.new_zeros((ndgl, nfld, res.grid.ndlon))
    for L, rows in plan["batches"]:
        nk = min(M, L // 2 + 1)
        x = spec.index_select(0, rows)[..., :nk]
        out[rows, :, :L] = torch.fft.irfft(x, n=L, dim=-1, norm="forward")
    return out.transpose(0, 1).contiguous()


def _analysis(grid: torch.Tensor, res) -> torch.Tensor:
    nfld, ndgl, ndlon = grid.shape
    if ndgl != res.ndgl or ndlon != res.grid.ndlon:
        raise ValueError(f"analysis expects (nfld, {res.ndgl}, "
                         f"{res.grid.ndlon}), got {tuple(grid.shape)}")
    M = res.M
    plan = _plan(res, grid.device)
    rows_first = grid.transpose(0, 1)              # (ndgl, nfld, ndlon)
    cdt = torch.complex128 if grid.dtype == torch.float64 else torch.complex64
    spec = torch.zeros((ndgl, nfld, M), dtype=cdt, device=grid.device)
    for L, rows in plan["batches"]:
        nk = min(M, L // 2 + 1)
        x = rows_first.index_select(0, rows)[..., :L]
        spec[rows, :, :nk] = torch.fft.rfft(x, dim=-1, norm="forward")[..., :nk]
    spec = spec * plan["mask"][:, None, :]
    # (ndgl, nfld, M, 2) -> (nfld, 2, M, ndgl)
    return torch.view_as_real(spec).permute(1, 3, 2, 0).contiguous()
