"""Fourier layer: per-latitude real DFTs on ``torch.fft``.

Counterpart of ``ectrans_tpu/ops/fourier.py`` (reference FTINV/FTDIR,
``ftinv_mod.F90``; GPU per-NLOEN plan cache, ``hicfft.cuda.cu:136-160``).

Contract (``tpm_fftw.F90:251-377``), with the literal wavenumber of the JAX
package's chirp-z transforms:

* synthesis (nfld, 2, M, ndgl) -> (nfld, ndgl, ndlon) is unnormalized,
  f_j = Re F_0 + 2 sum_{m=1}^{nmen} Re(F_m e^{2 pi i j m / L}), modes above
  the row's nmen and the imaginary part of m = 0 are ignored;
* analysis (nfld, ndgl, ndlon) -> (nfld, 2, M, ndgl) is
  F_m = (1/L) sum_j f_j e^{-2 pi i j m / L} for m <= nmen, zero above;
* grid points past a row's NLOEN are exactly 0 on output and ignored on
  input.

Two layers keep this contract:

* **the bucketed chirp-z layer** (``synthesis_bucketed``,
  ``analysis_bucketed`` on ``bucketed_tables``), which every transform of
  the package runs: the JAX package's hemisphere-symmetric latitude
  buckets (``ECTRANS_TPU_FFT_BUCKETS``, default 12), each one Bluestein
  convolution length nfft for all of its rows, so a field count plans
  ``torch.fft`` for a dozen lengths, not one per NLOEN.  Two real fields
  go through one complex transform (the Hermitian pair pack), each field
  divided by its RMS over the inputs the transform reads first, so that a
  field paired with a much smaller one keeps its own relative accuracy.
  The chirp tables (exp(+-i pi k^2 / L), the phase reduced exactly mod 2L
  in integers) and the FFTs of the offset chirp kernels are made on the
  host in float64, the latitude axis first; nfft is the smallest
  2^a 3^b 5^c 7^d at or above the bucket's ndlon + 2 mb + 1.  The pack,
  the convolution passes and the unpack run in fp64 (complex128) for an
  fp32 transform too, rounded once into its output, so the output does
  not depend on how fields are paired, bucketed or cut into packets: with
  fp32 passes the TCO1279 round trip read 0.551 of the 100 eps gate and
  the same fields in NPROMATR packets 0.682, over the 0.65 that K1's and
  K2's summation order must keep (``PERF.md``).  The mesh runs the
  same layer on each rank's length-sorted slots
  (``parallel.distribution.rank_fourier``);
* **the per-NLOEN layer** (``synthesis``, ``analysis``): one real FFT per
  distinct NLOEN, the tests' exact reference, reached in a transform only
  through the private ``_fourier="rows"``.  A mode m at or above a row's
  Nyquist (2 m >= L) is evaluated as written, not dropped: it folds onto
  bin m mod L, conjugated onto L - (m mod L) above L/2, and a mode on bin
  0 or on the Nyquist bin L/2 counts twice there (2 Re(.)), where
  ``irfft`` reads a bin once.  Analysis returns the periodic,
  conjugate-symmetric continuation of ``rfft`` above L/2.  ``fold`` and
  ``unfold`` write this out with slices, so autograd transposes them.
  Rows with 2 nmen < NLOEN (every Gaussian grid the package builds) take
  the unfolded batches; rows with 2 nmen >= NLOEN (lat-lon output grids,
  ROADMAP C1) the folded ones.  On unfolded rows each direction's
  transpose is the other one scaled row by row (``_Synthesis``,
  ``_Analysis``).

``synthesis_uniform``/``analysis_uniform`` are the same transforms on rows
of one length with a free top mode kmax (the lat-lon output rows and the
two directions of the LAM bi-Fourier transform).

The chirp-z layer is linear when ``normalize=False`` (the adjoints,
``adjoint.py``): autograd runs through ``torch.fft``, complex products and
slices, and the cotangents of the ignored inputs are exactly 0, as
``jax.linear_transpose`` gives them.  With ``normalize=True`` the RMS
scaling cancels in exact arithmetic.  Not carried over from the JAX
package: the four-step matmul FFT and its ORD pre-permutation (the TPU has
no FFT op), and the ``optimization_barrier`` guards.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..utils.timing import hook


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


def _plan(res, device: torch.device) -> dict:
    """Row batches by NLOEN, the rows with 2*nmen >= NLOEN apart
    (``folded``), and the (ndgl, M) mask m <= nmen(row)."""
    def build():
        nloen = np.asarray(res.grid.nloen, np.int64)
        nmen = np.minimum(np.asarray(res.nmen, np.int64), res.nsmax)
        wide = 2 * nmen >= nloen

        def by_length(sel):
            return [(int(L), torch.as_tensor(
                np.nonzero(sel & (nloen == L))[0], device=device))
                for L in np.unique(nloen[sel])]

        mask = torch.as_tensor(np.arange(res.M)[None, :] <= nmen[:, None],
                               device=device)
        return dict(batches=by_length(~wide), folded=by_length(wide),
                    mask=mask, nloen=nloen)

    return res.cached(("fourier_plan", str(device)), build)


def _adjoint_scale(res, device: torch.device, dtype: torch.dtype):
    """(2, M, ndgl) c_m * NLOEN(row), c_0 = 1 and c_m = 2 above (0 on the
    m = 0 imaginary part): synthesis^T = this * analysis on unfolded
    rows."""
    def build():
        nloen = _plan(res, device)["nloen"].astype(np.float64)
        c = np.where(np.arange(res.M) == 0, 1.0, 2.0)
        s = np.broadcast_to(c[:, None] * nloen[None, :],
                            (2, res.M, nloen.size)).copy()
        s[1, 0] = 0.0
        return torch.tensor(s, dtype=dtype, device=device)

    return res.cached(("fourier_adjoint_scale", dtype, str(device)), build)


class _Synthesis(torch.autograd.Function):
    """synthesis of the unfolded rows with its transpose: the grid
    cotangent's analysis times c_m * NLOEN (``_adjoint_scale``)."""

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
    """analysis of the unfolded rows with its transpose: the synthesis of
    the Fourier cotangent divided by c_m * NLOEN (the m = 0 imaginary part,
    which analysis leaves at 0 whatever the grid, is ignored by
    synthesis)."""

    @staticmethod
    def forward(ctx, grid, res):
        ctx.res = res
        return _analysis(grid, res)

    @staticmethod
    def backward(ctx, grad):
        res = ctx.res
        scale = _adjoint_scale(res, grad.device, grad.dtype)
        return _synthesis(grad / scale[0], res), None


def synthesis(fourier: torch.Tensor, res):
    """(nfld, 2, M, ndgl) Fourier coefficients -> (nfld, ndgl, ndlon)
    grid, rows north -> south, one ``torch.fft`` batch per NLOEN."""
    out = _Synthesis.apply(fourier, res)
    plan = _plan(res, fourier.device)
    for L, idx in plan["folded"]:
        # (nfld, 2, M, rows) -> (nfld, rows, M), modes above nmen zeroed
        four = fourier.index_select(3, idx).transpose(2, 3)
        four = four * plan["mask"].index_select(0, idx)
        g = synthesis_uniform(four[:, 0], four[:, 1], L)
        out = out.index_copy(1, idx, _pad_to(g, res.grid.ndlon))
    return out


def analysis(grid: torch.Tensor, res):
    """(nfld, ndgl, ndlon) grid -> (nfld, 2, M, ndgl) Fourier
    coefficients, one ``torch.fft`` batch per NLOEN."""
    spec = _Analysis.apply(grid, res)
    plan = _plan(res, grid.device)
    for L, idx in plan["folded"]:
        re, im = analysis_uniform(grid.index_select(1, idx)[..., :L],
                                  res.M - 1)
        mask = plan["mask"].index_select(0, idx)
        four = torch.stack([re, im], 1) * mask        # (nfld, 2, rows, M)
        spec = spec.index_copy(3, idx, four.transpose(2, 3))
    return spec


def _synthesis(fourier: torch.Tensor, res) -> torch.Tensor:
    nfld, _, M, nrow = fourier.shape
    if M != res.M or nrow != res.ndgl:
        raise ValueError(f"synthesis expects (nfld, 2, {res.M}, "
                         f"{res.ndgl}), got {tuple(fourier.shape)}")
    plan = _plan(res, fourier.device)
    # (ndgl, nfld, M) complex, rows leading so each batch is one gather
    spec = torch.view_as_complex(fourier.permute(3, 0, 2, 1).contiguous())
    spec = spec * plan["mask"][:, None, :]
    spec[..., 0] = spec[..., 0].real.to(spec.dtype)
    out = fourier.new_zeros((nrow, nfld, res.grid.ndlon))
    for L, idx in plan["batches"]:
        nk = min(M, L // 2 + 1)
        x = spec.index_select(0, idx)[..., :nk]
        out[idx, :, :L] = torch.fft.irfft(x, n=L, dim=-1, norm="forward")
    return out.transpose(0, 1).contiguous()


def _analysis(grid: torch.Tensor, res) -> torch.Tensor:
    nfld, nrow, ndlon = grid.shape
    if nrow != res.ndgl or ndlon != res.grid.ndlon:
        raise ValueError(f"analysis expects (nfld, {res.ndgl}, "
                         f"{res.grid.ndlon}), got {tuple(grid.shape)}")
    M = res.M
    plan = _plan(res, grid.device)
    rows_first = grid.transpose(0, 1)              # (ndgl, nfld, ndlon)
    cdt = torch.complex128 if grid.dtype == torch.float64 else torch.complex64
    spec = torch.zeros((nrow, nfld, M), dtype=cdt, device=grid.device)
    for L, idx in plan["batches"]:
        nk = min(M, L // 2 + 1)
        x = rows_first.index_select(0, idx)[..., :L]
        spec[idx, :, :nk] = torch.fft.rfft(x, dim=-1, norm="forward")[..., :nk]
    spec = spec * plan["mask"][:, None, :]
    # (ndgl, nfld, M, 2) -> (nfld, 2, M, ndgl)
    return torch.view_as_real(spec).permute(1, 3, 2, 0).contiguous()


# ----------------------------------------------------------------------
# The bucketed chirp-z layer (``ectrans_tpu`` ``synthesis_bucketed``,
# ``analysis_bucketed``; ``ops/fourier.py:274-327``).
# ----------------------------------------------------------------------

FFT_BUCKETS = 12            # ECTRANS_TPU_FFT_BUCKETS when unset
# working set of one chirp-z convolution chunk (bytes): the forward FFT,
# its product with the kernel and the inverse, (pairs, rows, nfft) each
_CHUNK_BYTES = 8 << 30
PASS_DTYPE = torch.float64   # the chirp-z passes, whatever the working dtype


def fft_buckets() -> int:
    """The bucket count asked for (``ECTRANS_TPU_FFT_BUCKETS``)."""
    return int(os.environ.get("ECTRANS_TPU_FFT_BUCKETS", str(FFT_BUCKETS)))


def good_size(n: int) -> int:
    """The smallest 2^a 3^b 5^c 7^d >= n (a length cuFFT plans fast)."""
    best = None
    p7 = 1
    while p7 < 2 * n:
        p5 = p7
        while p5 < 2 * n:
            p3 = p5
            while p3 < 2 * n:
                p2 = p3
                while p2 < n:
                    p2 *= 2
                if best is None or p2 < best:
                    best = p2
                p3 *= 3
            p5 *= 5
        p7 *= 7
    return best


def _chirp(L, k, sign: float) -> np.ndarray:
    """exp(sign i pi k^2 / L) with the phase reduced mod 2L in integers
    (exact while k^2 fits int64); L and k broadcast."""
    L = np.asarray(L, np.int64)
    k2 = (np.asarray(k, np.int64) ** 2) % (2 * L)
    ph = np.pi * k2.astype(np.float64) / L
    return np.cos(ph) + 1j * sign * np.sin(ph)


def host_bluestein_tables(nloen, nmen, mmax: int, ndlon: int | None = None,
                          nfft: int | None = None) -> dict:
    """The chirp tables of rows of lengths ``nloen`` truncated at ``nmen``
    (each at most ``mmax``), complex128, the row axis first:

    * syn_in (rows, 2 mmax + 1): e^{+i pi k^2/L} at slot k + mmax, |k| <=
      nmen; syn_out (rows, ndlon): e^{+i pi j^2/L}, j < L;
    * ana_in (rows, ndlon): e^{-i pi j^2/L}, j < L; ana_out (rows, 2 mmax +
      1): e^{-i pi m^2/L} / L at slot m + mmax, |m| <= nmen;
    * syn_bh, ana_bh (rows, nfft): the FFTs (``np.fft.fft``, the convention
      of ``torch.fft.fft``) of the offset chirp kernels
      b[u mod nfft] = e^{-i pi (u + mmax)^2/L}, u = -2 mmax .. L - 1, and
      b2[u mod nfft] = e^{+i pi (u - mmax)^2/L}, u = -(L - 1) .. 2 mmax.

    A row of length 0 (a pad slot of a mesh) has zero tables.  ``ndlon``
    defaults to the longest row and ``nfft`` to ``good_size(ndlon + 2 mmax
    + 1)``; a given one must be at least that."""
    L = np.asarray(nloen, np.int64)[:, None]
    me = np.minimum(np.asarray(nmen, np.int64), mmax)[:, None]
    ndlon = int(L.max()) if ndlon is None else ndlon
    P = 2 * mmax + 1
    nfft = good_size(ndlon + P) if nfft is None else nfft
    if nfft < ndlon + P - 1 or ndlon < L.max():
        raise ValueError(f"nfft {nfft} is short of ndlon {ndlon} + 2 mmax "
                         f"{2 * mmax}")
    real = L > 0
    Ls = np.maximum(L, 1)
    ks = np.arange(-mmax, mmax + 1)[None, :]
    kept = real & (np.abs(ks) <= me)
    js = np.arange(ndlon)[None, :]
    inrow = js < L
    idx = np.arange(nfft)[None, :]
    # synthesis kernel at u = j - p (p = k + mmax): u >= 0 below L, and
    # the 2 mmax negative u at the top of the circle
    us = np.where(idx < nfft - 2 * mmax, idx, idx - nfft)
    b = np.where(real & (us < L), _chirp(Ls, us + mmax, -1.0), 0.0)
    # analysis kernel at u = t - j (t = m + mmax): 0 .. 2 mmax, and the
    # L - 1 negative u at the top
    us2 = np.where(idx <= 2 * mmax, idx, idx - nfft)
    b2 = np.where(real & (us2 > -L), _chirp(Ls, us2 - mmax, 1.0), 0.0)
    return dict(
        nfft=nfft, mmax=mmax, ndlon=ndlon,
        syn_in=np.where(kept, _chirp(Ls, ks, 1.0), 0.0),
        syn_bh=np.fft.fft(b, axis=-1),
        syn_out=np.where(inrow, _chirp(Ls, js, 1.0), 0.0),
        ana_in=np.where(inrow, _chirp(Ls, js, -1.0), 0.0),
        ana_bh=np.fft.fft(b2, axis=-1),
        ana_out=np.where(kept, _chirp(Ls, ks, -1.0) / Ls, 0.0))


@dataclasses.dataclass(frozen=True, eq=False)
class Bucket:
    """One latitude bucket: its rows (``spans``, (first, end) row ranges
    of the layer's row axis, taken in order), the largest mode ``mb`` and
    row length ``ndlon`` over them, the convolution length ``nfft`` and
    the chirp tables of ``host_bluestein_tables`` on the device
    (complex128: the passes run in fp64), with ``valid`` (rows, ndlon):
    the points j < NLOEN that analysis reads."""

    spans: tuple
    mb: int
    ndlon: int
    nfft: int
    syn_in: torch.Tensor
    syn_bh: torch.Tensor
    syn_out: torch.Tensor
    ana_in: torch.Tensor
    ana_bh: torch.Tensor
    ana_out: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class BucketedTables:
    """The buckets of ``nrows`` rows of at most ``ndlon`` points, with the
    mask (2, M, nrows) of the Fourier inputs synthesis reads: m <= the
    row's nmen, no m = 0 imaginary part, nothing on pad rows."""

    buckets: tuple
    nrows: int
    ndlon: int
    M: int
    keep: torch.Tensor


def bucket_tables(nloen, nmen, nsmax: int, spans_list, ndlon: int, device,
                  shapes=None) -> BucketedTables:
    """The tables of buckets ``spans_list`` (one tuple of row spans each)
    over rows of lengths ``nloen`` (0: a pad row) truncated at ``nmen``;
    ``shapes`` gives each bucket's (mb, ndlon, nfft) where they are shared
    with other rows (the w-ranks of a mesh), else they are the bucket's
    own."""
    nloen = np.asarray(nloen, np.int64)
    nmen = np.minimum(np.asarray(nmen, np.int64), nsmax)
    M = nsmax + 1
    buckets = []
    for bi, spans in enumerate(spans_list):
        rows = np.concatenate([np.arange(a, b) for a, b in spans])
        real = nloen[rows] > 0
        if shapes is None:
            mb = int(min(nsmax, nmen[rows][real].max(initial=0)))
            nd = int(nloen[rows].max(initial=1))
            nfft = good_size(nd + 2 * mb + 1)
        else:
            mb, nd, nfft = shapes[bi]
        h = host_bluestein_tables(nloen[rows], np.minimum(nmen[rows], mb),
                                  mb, nd, nfft)

        def dev(name):
            return torch.as_tensor(h[name], device=device)

        buckets.append(Bucket(
            spans=tuple(spans), mb=mb, ndlon=nd, nfft=nfft,
            **{k: dev(k) for k in ("syn_in", "syn_bh", "syn_out", "ana_in",
                                   "ana_bh", "ana_out")},
            valid=torch.as_tensor(np.arange(nd)[None, :]
                                  < nloen[rows][:, None], device=device)))
    keep = np.arange(M)[:, None] <= np.where(nloen > 0, nmen, -1)[None, :]
    keep = np.stack([keep, keep])
    keep[1, 0] = False
    return BucketedTables(buckets=tuple(buckets), nrows=len(nloen),
                          ndlon=ndlon, M=M,
                          keep=torch.as_tensor(keep, device=device))


def bucket_spans(ndgl: int, nbuckets: int) -> list:
    """The hemisphere-symmetric buckets of ``ectrans_tpu``
    ``bucketed_tables``: north rows [i0, i1) with their southern mirrors
    [ndgl - i1, ndgl - i0), nb equal latitude ranges from the pole, nb = 1
    when nh < 16 nb; an odd middle row joins the equatorial bucket."""
    nh = ndgl // 2
    nb = 1 if nh < 16 * nbuckets else nbuckets
    bounds = [round(nh * b / nb) for b in range(nb + 1)]
    out = []
    for b in range(nb):
        i0, i1 = bounds[b], bounds[b + 1]
        if i0 == i1:
            continue
        south = ndgl - i1 if b < nb - 1 else nh
        out.append(((i0, i1), (south, ndgl - i0)))
    return out


def bucketed_tables(res, device,
                    nbuckets: int | None = None) -> BucketedTables:
    """The single-device buckets of a Resolution (``bucket_spans``; the
    bucket count ``fft_buckets()`` unless given), cached on it, so
    ``trans_end`` frees them."""
    nb = fft_buckets() if nbuckets is None else nbuckets
    device = torch.device(device)

    def build():
        return bucket_tables(res.grid.nloen, res.nmen, res.nsmax,
                             bucket_spans(res.ndgl, nb), res.grid.ndlon,
                             device)

    return res.cached(("fourier_buckets", str(device), nb), build)


def _even(x: torch.Tensor) -> torch.Tensor:
    """x with a zero field appended when the field count is odd."""
    if x.shape[0] % 2:
        x = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    return x


def _rms(x: torch.Tensor, dims) -> torch.Tensor:
    """Each field's RMS over ``dims``, 1 for a zero field."""
    r = x.square().mean(dims, keepdim=True).sqrt()
    return torch.where(r > 0, r, torch.ones_like(r))


def _rows(x: torch.Tensor, spans, dim: int) -> torch.Tensor:
    """The bucket's rows of x along ``dim``, in span order."""
    parts = [x.narrow(dim, a, b - a) for a, b in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _conv(a: torch.Tensor, bh: torch.Tensor, n_out: int) -> torch.Tensor:
    """The circular convolution of a (pairs, rows, n) with the kernels
    whose FFTs are bh (rows, nfft), zero-padded to nfft, first ``n_out``
    points; chunked over pairs under ``_CHUNK_BYTES``."""
    nfft = bh.shape[-1]
    per_pair = 3 * a.shape[1] * nfft * a.element_size()
    chunk = max(1, _CHUNK_BYTES // max(1, per_pair))
    outs = [torch.fft.ifft(torch.fft.fft(c, n=nfft, dim=-1) * bh,
                           dim=-1)[..., :n_out]
            for c in a.split(chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _bucket_synthesis(x: torch.Tensor, bk: Bucket) -> torch.Tensor:
    """(F2, 2, M, nrows) masked fp64 Fourier rows, F2 even -> the bucket's
    grid rows (F2, rows, ndlon_b) in fp64: fields 2p and 2p + 1 as the real
    and the imaginary part of one chirp-z transform of the Hermitian pack
    w_m = F_a,m + i F_b,m, w_{-m} = conj(F_a,m) + i conj(F_b,m)."""
    f = _rows(x[:, :, : bk.mb + 1], bk.spans, 3).transpose(2, 3)
    a, b = f[0::2], f[1::2]                       # (P2, 2, rows, mb + 1)
    ar, ai, br, bi = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    w_pos = torch.complex(ar - bi, ai + br)       # slots mb .. 2 mb
    w_neg = torch.complex(ar + bi, br - ai)[..., 1:].flip(-1)
    w = torch.cat([w_neg, w_pos], -1) * bk.syn_in
    g = _conv(w, bk.syn_bh, bk.ndlon) * bk.syn_out
    # (P2, rows, ndlon_b) complex -> (2 P2, rows, ndlon_b): Re, Im
    return torch.view_as_real(g).permute(0, 3, 1, 2).reshape(
        -1, g.shape[1], g.shape[2])


def _bucket_analysis(g: torch.Tensor, bk: Bucket, K: int) -> torch.Tensor:
    """The bucket's fp64 grid rows (F2, rows, ndlon_b), F2 even and zero
    past each NLOEN -> (F2, 2, K, rows) in fp64, K <= mb + 1: z = f_a +
    i f_b through one chirp-z transform, F_a,m = (Z_m + conj Z_{-m}) / 2
    and F_b,m = (Z_m - conj Z_{-m}) / 2i."""
    mb = bk.mb
    z = torch.complex(g[0::2], g[1::2]) * bk.ana_in
    v = _conv(z, bk.ana_bh, 2 * mb + 1) * bk.ana_out    # slots m + mb
    zp = v[..., mb: mb + K]
    zn = v[..., : mb + 1].flip(-1)[..., :K]            # Z_{-m}
    zpr, zpi, znr, zni = zp.real, zp.imag, zn.real, zn.imag
    fa = torch.stack([(zpr + znr) * 0.5, (zpi - zni) * 0.5], 1)
    fb = torch.stack([(zpi + zni) * 0.5, (znr - zpr) * 0.5], 1)
    out = torch.stack([fa, fb], 1)                  # (P2, 2, 2, rows, K)
    return out.reshape(-1, 2, out.shape[3], K).transpose(2, 3)


def _place(out: torch.Tensor, piece: torch.Tensor, spans, dim: int,
           width=None) -> None:
    """Write the bucket's rows ``piece`` (along ``dim``, in span order)
    into ``out``, into its first ``width`` points of the last axis,
    rounded to ``out``'s dtype."""
    off = 0
    for a, b in spans:
        dst = out.narrow(dim, a, b - a)
        if width is not None:
            dst = dst[..., :width]
        dst.copy_(piece.narrow(dim, off, b - a))
        off += b - a


def synthesis_bucketed(fourier: torch.Tensor, bt: BucketedTables,
                       normalize: bool = True) -> torch.Tensor:
    """(nfld, 2, M, nrows) Fourier coefficients -> (nfld, nrows, ndlon)
    grid through the buckets' chirp-z transforms, in fp64, rounded once to
    the input's dtype.  ``normalize`` divides each field by its RMS over
    the inputs it reads (``bt.keep``) before the pair pack and multiplies
    the output back; ``normalize=False`` keeps the function linear (the
    adjoints)."""
    nfld, two, M, nrow = fourier.shape
    if two != 2 or M != bt.M or nrow != bt.nrows:
        raise ValueError(f"synthesis_bucketed expects (nfld, 2, {bt.M}, "
                         f"{bt.nrows}), got {tuple(fourier.shape)}")
    x = _even(torch.where(bt.keep, fourier, 0.0)).to(PASS_DTYPE)
    if normalize:
        scale = _rms(x, (1, 2, 3))
        x = x / scale
    out = fourier.new_zeros((x.shape[0], nrow, bt.ndlon))
    for bk in bt.buckets:
        with hook("fourier.bucket"):
            piece = _bucket_synthesis(x, bk)
            if normalize:
                piece = piece * scale[:, 0]
            _place(out, piece, bk.spans, 1, bk.ndlon)
    return out[:nfld]


def analysis_bucketed(grid: torch.Tensor, bt: BucketedTables, M: int,
                      normalize: bool = True) -> torch.Tensor:
    """(nfld, nrows, ndlon) grid -> (nfld, 2, M, nrows) Fourier
    coefficients through the buckets' chirp-z transforms, zero above each
    bucket's mb, in fp64, rounded once to the grid's dtype.  ``normalize``
    divides each field by its RMS over the bucket's points j < NLOEN,
    bucket by bucket, as ``ectrans_tpu`` does, and multiplies the
    coefficients back."""
    nfld, nrow, ndlon = grid.shape
    if nrow != bt.nrows or ndlon != bt.ndlon or M > bt.M:
        raise ValueError(f"analysis_bucketed expects (nfld, {bt.nrows}, "
                         f"{bt.ndlon}) and M <= {bt.M}, got "
                         f"{tuple(grid.shape)}, M {M}")
    x = _even(grid)
    out = x.new_zeros((x.shape[0], 2, M, nrow))
    for bk in bt.buckets:
        with hook("fourier.bucket"):
            g = torch.where(bk.valid, _rows(x[..., : bk.ndlon], bk.spans, 1),
                            0.0).to(PASS_DTYPE)
            if normalize:
                scale = _rms(g, (1, 2))
                g = g / scale
            K = min(M, bk.mb + 1)
            piece = _bucket_analysis(g, bk, K)
            if normalize:
                piece = piece * scale[..., None]
            _place(out[:, :, :K], piece, bk.spans, 3)
    return out[:nfld]
