"""Fourier layer: per-latitude real DFTs on ``torch.fft``.

Counterpart of ``synthesis_bucketed``/``analysis_bucketed`` and of
``synthesis_uniform``/``analysis_uniform`` in ``ectrans_tpu/ops/fourier.py``
(reference FTINV/FTDIR, ``ftinv_mod.F90``; GPU per-NLOEN plan cache,
``hicfft.cuda.cu:136-160``).  Latitudes are batched by identical NLOEN: one
real FFT per distinct length.

Contract (``tpm_fftw.F90:251-377``), with the literal wavenumber of the JAX
package's chirp-z transforms:

* synthesis (nfld, 2, M, ndgl) -> (nfld, ndgl, ndlon) is unnormalized,
  f_j = Re F_0 + 2 sum_{m=1}^{nmen} Re(F_m e^{2 pi i j m / L}), modes above
  the row's nmen and the imaginary part of m = 0 are ignored;
* analysis (nfld, ndgl, ndlon) -> (nfld, 2, M, ndgl) is
  F_m = (1/L) sum_j f_j e^{-2 pi i j m / L} for m <= nmen, zero above;
* grid points past a row's NLOEN are exactly 0 on output and ignored on
  input.

A mode m at or above a row's Nyquist (2 m >= L) is evaluated as written,
not dropped: it folds onto bin m mod L, conjugated onto L - (m mod L) above
L/2, and a mode on bin 0 or on the Nyquist bin L/2 counts twice there
(2 Re(.)), where ``irfft`` reads a bin once.  Analysis returns the periodic,
conjugate-symmetric continuation of ``rfft`` above L/2.  ``fold`` and
``unfold`` write this out with slices, so autograd transposes them.  Rows
with 2 nmen < NLOEN (every Gaussian grid the package builds) take the
unfolded batches; rows with 2 nmen >= NLOEN (lat-lon output grids, ROADMAP
C1) the folded ones.

The distributed transforms run the same two directions on one rank's rows
(``rows``: the length-sorted slots of ``parallel.distribution.lat_perm``,
pad slots giving zeros), with the plan keyed on the row tuple; the JAX
package's sharded path runs its bucketed chirp-z transforms there instead.

``synthesis_uniform``/``analysis_uniform`` are the same transforms on rows
of one length with a free top mode kmax (the lat-lon output rows and the
two directions of the LAM bi-Fourier transform).

Both Gaussian-row directions are linear, and on unfolded rows each one's
transpose is the other one scaled row by row (``_Synthesis``,
``_Analysis``): autograd through them (the adjoints of ``adjoint.py``) takes
two FFT calls a row batch, as the forward does, and the cotangents of the
ignored inputs (m = 0 imaginary parts, modes above nmen, points past NLOEN)
are exactly 0, as ``jax.linear_transpose`` gives them.  Folded rows, where
that identity fails, go through ``fold``/``unfold`` and autograd.  The JAX
package's chirp-z / four-step / real-FFT machinery and its RMS pair
normalization exist because the TPU backend has no FFT op or complex dtype;
they are not ported.
"""

from __future__ import annotations

import numpy as np
import torch


def fold(re: torch.Tensor, im: torch.Tensor, L: int) -> torch.Tensor:
    """Modes k = 0 .. K-1 on the last axis of (re, im) -> the half spectrum
    H (..., L // 2 + 1) with ``irfft(H, n=L, norm="forward")`` equal to
    Re F_0 + 2 sum_{k>=1} Re(F_k e^{2 pi i j k / L}).  Without folding
    (2 (K-1) < L) H is F with a real bin 0; above it, mode k lands on bin
    k mod L, conjugated onto L - (k mod L) past L/2, with a weight of 2 on
    bin 0 (k > 0) and on the Nyquist bin."""
    K = re.shape[-1]
    half = L // 2
    if 2 * (K - 1) < L:
        im = torch.cat([torch.zeros_like(im[..., :1]), im[..., 1:]], -1)
        return torch.complex(re, im)
    w = np.ones(K)
    k = np.arange(K)
    w[(k > 0) & (k % L == 0)] = 2.0
    if L % 2 == 0:
        w[k % L == half] = 2.0
    w = torch.as_tensor(w, dtype=re.dtype, device=re.device)
    re, im = re * w, im * w
    hre = re.new_zeros(re.shape[:-1] + (half + 1,))
    him = im.new_zeros(im.shape[:-1] + (half + 1,))
    for p0 in range(0, K, L):
        # direct bins 0 .. half of period p0
        k1 = min(K, p0 + half + 1)
        hre = hre + _pad_to(re[..., p0:k1], half + 1)
        him = him + _pad_to(im[..., p0:k1], half + 1)
        # reflected: k in (p0 + half, p0 + L) lands on bin L - (k - p0),
        # conjugated
        k0, k1 = p0 + half + 1, min(K, p0 + L)
        if k0 < k1:
            lo = L - (k1 - 1 - p0)
            seg_re = re[..., k0:k1].flip(-1)
            seg_im = -im[..., k0:k1].flip(-1)
            hre = hre + _pad_to(seg_re, half + 1, lo)
            him = him + _pad_to(seg_im, half + 1, lo)
    # irfft reads only the real parts of bin 0 and of the Nyquist bin
    keep = torch.ones(half + 1, dtype=re.dtype, device=re.device)
    keep[0] = 0.0
    if L % 2 == 0:
        keep[half] = 0.0
    return torch.complex(hre, him * keep)


def _pad_to(x: torch.Tensor, n: int, lo: int = 0) -> torch.Tensor:
    """x placed at [lo, lo + len) of a zero last axis of length n."""
    return torch.nn.functional.pad(x, (lo, n - lo - x.shape[-1]))


def unfold(spec: torch.Tensor, L: int, K: int):
    """The (re, im) of modes k = 0 .. K-1 from ``rfft(x, n=L)`` (..., L//2+1):
    bin k mod L, or the conjugate of bin L - (k mod L) past L/2 (the
    periodic, conjugate-symmetric continuation)."""
    half = L // 2
    re, im = spec.real, spec.imag
    if K <= half + 1:
        return re[..., :K], im[..., :K]
    # one period of the continuation: bins 0 .. half, then L - half - 1 .. 1
    # conjugated, repeated to K modes
    nref = L - half - 1
    per_re = torch.cat([re, re[..., 1 : nref + 1].flip(-1)], -1)
    per_im = torch.cat([im, -im[..., 1 : nref + 1].flip(-1)], -1)
    reps = -(-K // L)
    if reps > 1:
        per_re = per_re.repeat(*([1] * (per_re.dim() - 1)), reps)
        per_im = per_im.repeat(*([1] * (per_im.dim() - 1)), reps)
    return per_re[..., :K], per_im[..., :K]


def synthesis_uniform(re: torch.Tensor, im: torch.Tensor,
                      L: int) -> torch.Tensor:
    """(..., kmax+1) half-complex coefficients (re, im) -> (..., L) real
    signal f_j = Re F_0 + 2 sum_{k=1}^{kmax} Re(F_k e^{2 pi i j k / L}),
    kmax free of L (``ectrans_tpu`` ``synthesis_uniform``)."""
    return torch.fft.irfft(fold(re, im, L), n=L, dim=-1, norm="forward")


def analysis_uniform(x: torch.Tensor, kmax: int):
    """(..., L) real signal -> (re, im), each (..., kmax+1), of
    F_k = (1/L) sum_j x_j e^{-2 pi i j k / L}, kmax free of L
    (``ectrans_tpu`` ``analysis_uniform``)."""
    L = x.shape[-1]
    return unfold(torch.fft.rfft(x, dim=-1, norm="forward"), L, kmax + 1)


def _plan(res, device: torch.device, rows: tuple | None = None) -> dict:
    """Row batches by NLOEN, the rows with 2*nmen >= NLOEN apart
    (``folded``), and the (nrows, M) mask m <= nmen(row), over all of the
    Resolution's rows or over ``rows`` (row indices; one >= ndgl is a pad
    row of no points, in no batch and masked out), keyed on that tuple."""
    def build():
        idx = (np.arange(res.ndgl) if rows is None
               else np.asarray(rows, np.int64))
        real = idx < res.ndgl
        r = np.minimum(idx, res.ndgl - 1)
        nloen = np.where(real, np.asarray(res.grid.nloen, np.int64)[r], 0)
        nmen = np.where(real, np.minimum(np.asarray(res.nmen, np.int64)[r],
                                         res.nsmax), -1)
        wide = real & (2 * nmen >= nloen)

        def by_length(sel):
            return [(int(L), torch.as_tensor(
                np.nonzero(sel & (nloen == L))[0], device=device))
                for L in np.unique(nloen[sel])]

        mask = torch.as_tensor(np.arange(res.M)[None, :] <= nmen[:, None],
                               device=device)
        return dict(batches=by_length(real & ~wide), folded=by_length(wide),
                    mask=mask, nloen=nloen)

    return res.cached(("fourier_plan", str(device), rows), build)


def _adjoint_scale(res, device: torch.device, dtype: torch.dtype,
                   rows: tuple | None = None):
    """(2, M, nrows) c_m * NLOEN(row), c_0 = 1 and c_m = 2 above (0 on the
    m = 0 imaginary part and on pad rows): synthesis^T = this * analysis
    on unfolded rows."""
    def build():
        nloen = _plan(res, device, rows)["nloen"].astype(np.float64)
        c = np.where(np.arange(res.M) == 0, 1.0, 2.0)
        s = np.broadcast_to(c[:, None] * nloen[None, :],
                            (2, res.M, nloen.size)).copy()
        s[1, 0] = 0.0
        return torch.tensor(s, dtype=dtype, device=device)

    return res.cached(("fourier_adjoint_scale", dtype, str(device), rows),
                      build)


class _Synthesis(torch.autograd.Function):
    """synthesis of the unfolded rows with its transpose: the grid
    cotangent's analysis times c_m * NLOEN (``_adjoint_scale``)."""

    @staticmethod
    def forward(ctx, fourier, res, rows):
        ctx.res, ctx.rows = res, rows
        return _synthesis(fourier, res, rows)

    @staticmethod
    def backward(ctx, grad):
        res, rows = ctx.res, ctx.rows
        return (_analysis(grad, res, rows)
                * _adjoint_scale(res, grad.device, grad.dtype, rows),
                None, None)


class _Analysis(torch.autograd.Function):
    """analysis of the unfolded rows with its transpose: the synthesis of
    the Fourier cotangent divided by c_m * NLOEN (the m = 0 imaginary part,
    which analysis leaves at 0 whatever the grid, is ignored by
    synthesis)."""

    @staticmethod
    def forward(ctx, grid, res, rows):
        ctx.res, ctx.rows = res, rows
        return _analysis(grid, res, rows)

    @staticmethod
    def backward(ctx, grad):
        res, rows = ctx.res, ctx.rows
        scale = _adjoint_scale(res, grad.device, grad.dtype, rows)
        return _synthesis(grad / scale[0], res, rows), None, None


def synthesis(fourier: torch.Tensor, res, rows: tuple | None = None):
    """(nfld, 2, M, nrows) Fourier coefficients -> (nfld, nrows, ndlon)
    grid, over all of the Resolution's rows north -> south, or over
    ``rows`` (``_plan``; a pad row's output is 0)."""
    out = _Synthesis.apply(fourier, res, rows)
    plan = _plan(res, fourier.device, rows)
    for L, idx in plan["folded"]:
        # (nfld, 2, M, rows) -> (nfld, rows, M), modes above nmen zeroed
        four = fourier.index_select(3, idx).transpose(2, 3)
        four = four * plan["mask"].index_select(0, idx)
        g = synthesis_uniform(four[:, 0], four[:, 1], L)
        out = out.index_copy(1, idx, _pad_to(g, res.grid.ndlon))
    return out


def analysis(grid: torch.Tensor, res, rows: tuple | None = None):
    """(nfld, nrows, ndlon) grid -> (nfld, 2, M, nrows) Fourier
    coefficients, over all rows or over ``rows`` as ``synthesis``."""
    spec = _Analysis.apply(grid, res, rows)
    plan = _plan(res, grid.device, rows)
    for L, idx in plan["folded"]:
        re, im = analysis_uniform(grid.index_select(1, idx)[..., :L],
                                  res.M - 1)
        mask = plan["mask"].index_select(0, idx)
        four = torch.stack([re, im], 1) * mask        # (nfld, 2, rows, M)
        spec = spec.index_copy(3, idx, four.transpose(2, 3))
    return spec


def _nrows(res, rows) -> int:
    return res.ndgl if rows is None else len(rows)


def _synthesis(fourier: torch.Tensor, res, rows=None) -> torch.Tensor:
    nfld, _, M, nrow = fourier.shape
    if M != res.M or nrow != _nrows(res, rows):
        raise ValueError(f"synthesis expects (nfld, 2, {res.M}, "
                         f"{_nrows(res, rows)}), got {tuple(fourier.shape)}")
    plan = _plan(res, fourier.device, rows)
    # (nrows, nfld, M) complex, rows leading so each batch is one gather
    spec = torch.view_as_complex(fourier.permute(3, 0, 2, 1).contiguous())
    spec = spec * plan["mask"][:, None, :]
    spec[..., 0] = spec[..., 0].real.to(spec.dtype)
    out = fourier.new_zeros((nrow, nfld, res.grid.ndlon))
    for L, idx in plan["batches"]:
        nk = min(M, L // 2 + 1)
        x = spec.index_select(0, idx)[..., :nk]
        out[idx, :, :L] = torch.fft.irfft(x, n=L, dim=-1, norm="forward")
    return out.transpose(0, 1).contiguous()


def _analysis(grid: torch.Tensor, res, rows=None) -> torch.Tensor:
    nfld, nrow, ndlon = grid.shape
    if nrow != _nrows(res, rows) or ndlon != res.grid.ndlon:
        raise ValueError(f"analysis expects (nfld, {_nrows(res, rows)}, "
                         f"{res.grid.ndlon}), got {tuple(grid.shape)}")
    M = res.M
    plan = _plan(res, grid.device, rows)
    rows_first = grid.transpose(0, 1)              # (nrows, nfld, ndlon)
    cdt = torch.complex128 if grid.dtype == torch.float64 else torch.complex64
    spec = torch.zeros((nrow, nfld, M), dtype=cdt, device=grid.device)
    for L, idx in plan["batches"]:
        nk = min(M, L // 2 + 1)
        x = rows_first.index_select(0, idx)[..., :L]
        spec[idx, :, :nk] = torch.fft.rfft(x, dim=-1, norm="forward")[..., :nk]
    spec = spec * plan["mask"][:, None, :]
    # (nrows, nfld, M, 2) -> (nfld, 2, M, nrows)
    return torch.view_as_real(spec).permute(1, 3, 2, 0).contiguous()
