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
  K2's summation order must keep (``PERF.md``).  A bucket's pass is
  five stages: F1 (mask, gather, widening, RMS division, pair pack, chirp,
  zero pad), the FFT, F2 (the kernel FFT's product), the inverse FFT and
  F3 (crop, chirp, unpack, RMS, one rounding into the output), with F4
  (the RMS sums) once a call.  On a card a bucket whose nfft points fit
  one block's shared memory (``fuses``: every bucket up to TCO1279) runs
  all five in one kernel, F5 (``csrc/fourier_fused.cu``), so that no
  (pairs, rows, nfft) array crosses device memory; any other bucket runs
  them staged, the kernels of ``csrc/fourier_chirp.cu`` around
  ``torch.fft``; on the CPU every bucket runs the plain stages.  Each call
  counts its buckets as ``fourier.fused`` and ``fourier.staged``
  (``utils.timing.count``).  The mesh runs the same layer on each rank's
  length-sorted slots (``parallel.distribution.rank_fourier``);
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
``adjoint.py``), and with ``normalize=True`` the RMS scaling cancels in
exact arithmetic: each direction is an ``autograd.Function`` whose backward
is the other direction's pass scaled row by row (``_adjoint_weights``), so
the cotangents of the ignored inputs are exactly 0, as
``jax.linear_transpose`` gives them.  Not carried over from the JAX
package: the four-step matmul FFT and its ORD pre-permutation (the TPU has
no FFT op), and the ``optimization_barrier`` guards.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from .. import _build
from ..utils.timing import count, hook


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


# F5's FFT of length nfft in one block's shared memory (``fourier_fused.cu``)
FINE = 64                    # fine twiddles of ``twiddle_table``
_SMEM_LIMIT = None           # F5's shared memory a block (bytes); None: the
                             # card's own (``smem_limit``)


RADICES = (12, 10, 9, 8, 7, 6, 5, 4, 3, 2)    # F5's butterflies
# the first pass's butterflies are contiguous rows: in the padded row (an
# element in 8) radices 8, 4 and 2 read them from every bank, 7 from one
FIRST = (8, 4, 2, 3, 5, 9, 6, 10, 12, 7)


def _factorings(n: int, top: int):
    """Every multiset of RADICES up to ``top`` whose product is n, as
    non-increasing tuples."""
    if n == 1:
        yield ()
    for r in RADICES:
        if r <= top and n % r == 0:
            for rest in _factorings(n // r, r):
                yield (r,) + rest


@functools.lru_cache(maxsize=None)
def fft_radices(nfft: int) -> tuple:
    """The radices of F5's FFT of length nfft (2^a 3^b 5^c 7^d), in the
    forward FFT's order: the fewest passes (each a round trip of the row
    through shared memory), the radix the first pass reads best (``FIRST``)
    first, then the largest radices, largest first."""
    plans = list(_factorings(nfft, max(RADICES)))
    if not plans:
        raise ValueError(f"nfft {nfft} is not a 2^a 3^b 5^c 7^d")
    fewest = min(map(len, plans))

    def order(plan):
        first = min(plan, key=FIRST.index)
        rest = list(plan)
        rest.remove(first)
        return (first, *rest)

    return min((order(p) for p in plans if len(p) == fewest),
               key=lambda p: (FIRST.index(p[0]), [-r for r in p[1:]]))


def fft_plan(radices) -> int:
    """The radices as F5 takes them: 4 bits each, the first lowest."""
    return sum(r << (4 * p) for p, r in enumerate(radices))


def digit_places(radices) -> np.ndarray:
    """(nfft,) int64: the position in F5's row of each slot s, where its
    forward FFT (decimation in time, ``radices`` in order) takes input s
    and its inverse FFT (decimation in frequency, the radices in reverse
    order) leaves output point s: the position whose digits (the lowest of
    radix ``radices[0]``), read in reverse order, make s."""
    rest = np.arange(int(np.prod(radices)))
    rev = np.zeros_like(rest)
    for r in radices:
        rev = rev * r + rest % r
        rest = rest // r
    return np.argsort(rev)


def twiddle_table(nfft: int) -> np.ndarray:
    """F5's twiddles, complex128 made in float64: W^l for l < FINE, then
    W^(FINE h) for h < ceil(nfft / FINE), W = e^(-2 pi i / nfft), so that
    W^e = table[FINE + e // FINE] * table[e % FINE] for e < nfft."""
    k = np.concatenate([np.arange(FINE), FINE * np.arange(-(-nfft // FINE))])
    ph = 2.0 * np.pi * k / nfft
    return np.cos(ph) - 1j * np.sin(ph)


def fused_smem_bytes(nfft: int) -> int:
    """The dynamic shared memory of an F5 block, as its launch takes it:
    the row padded by one element in 8, the twiddles and the pair's RMS,
    16 bytes each."""
    return 16 * (nfft + nfft // 8 + FINE + -(-nfft // FINE) + 1)


@functools.lru_cache(maxsize=None)
def _optin(index: int) -> int:
    props = torch.cuda.get_device_properties(index)
    return props.shared_memory_per_block_optin


def smem_limit(device) -> int:
    """The shared memory an F5 block may use on a card (bytes): the card's
    opt-in maximum a block (227 KB on an H100), read once a card;
    ``_SMEM_LIMIT`` where it is set."""
    if _SMEM_LIMIT is not None:
        return _SMEM_LIMIT
    index = torch.device(device).index
    return _optin(torch.cuda.current_device() if index is None else index)


def fuses(nfft: int, limit: int) -> bool:
    """Whether a bucket of convolution length nfft runs F5 on a card whose
    block may use ``limit`` bytes of shared memory (``smem_limit``)."""
    return fused_smem_bytes(nfft) <= limit


@dataclasses.dataclass(frozen=True, eq=False)
class Bucket:
    """One latitude bucket: its rows (``spans``, (first, end) row ranges
    of the layer's row axis, taken in order), the largest mode ``mb`` and
    row length ``ndlon`` over them, the convolution length ``nfft`` and
    the chirp tables of ``host_bluestein_tables`` on the device
    (complex128: the passes run in fp64), the kernel FFTs ``syn_bh`` and
    ``ana_bh`` divided by nfft (the inverse FFT runs unnormalized), with
    ``rows`` (2, rows) int32: each row's index in the layer and its NLOEN
    (analysis reads the points j < NLOEN), a view of the tables' ``rows``,
    and F5's FFT: its ``radices`` (``fft_radices``), and for nfft < 2^15
    (else None) ``twiddles`` (``twiddle_table``) and ``place`` (nfft,)
    int16, each slot's position in the row (``digit_places``)."""

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
    rows: torch.Tensor
    radices: tuple
    twiddles: torch.Tensor | None
    place: torch.Tensor | None


@dataclasses.dataclass(frozen=True, eq=False)
class BucketedTables:
    """The buckets of ``nrows`` rows of at most ``ndlon`` points, with
    ``mkeep`` (nrows,) int32, the largest m of the Fourier inputs synthesis
    reads on each row (-1 on a pad row), and ``rows`` (2 nrows,) int32,
    each bucket's (2, rows) table (``Bucket.rows``) in bucket order, bucket
    b's from 2 ``starts[b]`` on ((nbuckets + 1,) int32)."""

    buckets: tuple
    nrows: int
    ndlon: int
    M: int
    mkeep: torch.Tensor
    rows: torch.Tensor
    starts: torch.Tensor

    @property
    def keep(self) -> torch.Tensor:
        """(2, M, nrows): the Fourier inputs synthesis reads: m <= the
        row's nmen, no m = 0 imaginary part, nothing on pad rows."""
        m = torch.arange(self.M, device=self.mkeep.device)[:, None]
        keep = (m <= self.mkeep[None, :]).expand(2, -1, -1).clone()
        keep[1, 0] = False
        return keep

    @property
    def nloen(self) -> torch.Tensor:
        """(nrows,) int32: each row's length (0 on a pad row)."""
        out = torch.zeros(self.nrows, dtype=torch.int32,
                          device=self.rows.device)
        for bk in self.buckets:
            out[bk.rows[0].long()] = bk.rows[1]
        return out


def bucket_shape(nloen, nmen, nsmax: int) -> tuple:
    """(mb, ndlon, nfft) of a bucket of rows of lengths ``nloen`` (0: a pad
    row) truncated at ``nmen``: its highest kept wavenumber, its longest
    row and its convolution length ``good_size(ndlon + 2 mb + 1)``."""
    nloen = np.asarray(nloen, np.int64)
    real = nloen > 0
    mb = int(min(nsmax, np.asarray(nmen)[real].max(initial=0)))
    nd = int(nloen.max(initial=1))
    return mb, nd, good_size(nd + 2 * mb + 1)


def bucket_tables(nloen, nmen, nsmax: int, spans_list, ndlon: int, device,
                  shapes=None) -> BucketedTables:
    """The tables of buckets ``spans_list`` (one tuple of row spans each,
    every row in exactly one) over rows of lengths ``nloen`` (0: a pad
    row) truncated at ``nmen``; ``shapes`` gives each bucket's (mb, ndlon,
    nfft) where they are shared with other rows (the w-ranks of a mesh),
    else they are the bucket's own."""
    nloen = np.asarray(nloen, np.int64)
    nmen = np.minimum(np.asarray(nmen, np.int64), nsmax)
    M = nsmax + 1
    seen = np.zeros(len(nloen), np.int64)
    parts, starts, shape = [], [0], []
    for bi, spans in enumerate(spans_list):
        rows = np.concatenate([np.arange(a, b) for a, b in spans])
        seen[rows] += 1
        parts.append(np.stack([rows, nloen[rows]]))
        starts.append(starts[-1] + len(rows))
        if shapes is None:
            mb, nd, nfft = bucket_shape(nloen[rows], nmen[rows], nsmax)
        else:
            mb, nd, nfft = shapes[bi]
        shape.append((spans, rows, mb, nd, nfft))
    if not np.all(seen == 1):
        raise ValueError("the bucket spans must hold every row once")
    table = torch.as_tensor(np.concatenate([p.ravel() for p in parts])
                            .astype(np.int32), device=device)
    buckets = []
    for (spans, rows, mb, nd, nfft), s0, s1 in zip(shape, starts,
                                                   starts[1:]):
        h = host_bluestein_tables(nloen[rows], np.minimum(nmen[rows], mb),
                                  mb, nd, nfft)
        h["syn_bh"] /= nfft
        h["ana_bh"] /= nfft

        radices = fft_radices(nfft)
        if nfft < 2 ** 15:           # int16 positions; fuses() needs less
            h["place"] = digit_places(radices).astype(np.int16)
            h["twiddles"] = twiddle_table(nfft)

        def dev(name):
            return None if name not in h else torch.as_tensor(h[name],
                                                              device=device)

        buckets.append(Bucket(
            spans=tuple(spans), mb=mb, ndlon=nd, nfft=nfft,
            **{k: dev(k) for k in ("syn_in", "syn_bh", "syn_out", "ana_in",
                                   "ana_bh", "ana_out", "twiddles", "place")},
            rows=table[2 * s0: 2 * s1].view(2, s1 - s0), radices=radices))
    mkeep = np.where(nloen > 0, nmen, -1)
    return BucketedTables(
        buckets=tuple(buckets), nrows=len(nloen), ndlon=ndlon, M=M,
        mkeep=torch.as_tensor(mkeep.astype(np.int32), device=device),
        rows=table,
        starts=torch.as_tensor(np.asarray(starts, np.int32), device=device))


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


# ----------------------------------------------------------------------
# A bucket's pass, in five stages on both devices: F1 (pre), the FFT, F2
# (product), the inverse FFT, F3 (post); F4 (the RMS sums) once a call.
# A CPU tensor runs each stage's plain version (``*_plain``), a CUDA tensor
# its kernel (``csrc/fourier_chirp.cu``); the plain versions take CUDA
# tensors too (the card's tests and ``chip_smoke.py`` hold each kernel
# against them).  The passes run in fp64 on complex128 (pairs, rows, nfft)
# arrays; fields 2p and 2p + 1 make pair p, a field past nfld (odd counts)
# a zero partner.  The sums of squares ``ss`` are (nfld, P) fp64 in
# synthesis, (nfld, nbuckets, P) in analysis (P = NP partial sums from the
# kernels, 1 from the plain versions); None (normalize=False) scales by 1.
# On a card F5 (``pass_synthesis``, ``pass_analysis``, ``fourier_fused.cu``)
# runs a bucket's five stages in one kernel where ``fuses`` allows.
# ----------------------------------------------------------------------

NP = 32                      # F4's partial sums a field (a bucket)


def _pairs(x: torch.Tensor, p0: int, p1: int) -> torch.Tensor:
    """Fields 2 p0 .. 2 p1 - 1 of x, zero fields past x's."""
    f = x[2 * p0: 2 * p1]
    if f.shape[0] < 2 * (p1 - p0):
        f = torch.cat([f, f.new_zeros((2 * (p1 - p0) - f.shape[0],)
                                      + f.shape[1:])])
    return f


def _scales(ss, count: float, f0: int, f1: int):
    """The RMS of fields f0 .. f1 - 1 from their sums of squares ss over
    ``count`` values, 1 for a zero field and past ss's fields."""
    r = (ss[f0:f1].sum(-1) / count).sqrt()
    r = torch.where(r > 0, r, torch.ones_like(r))
    return torch.nn.functional.pad(r, (0, f1 - f0 - r.shape[0]), value=1.0)


def _rows(x: torch.Tensor, spans, dim: int) -> torch.Tensor:
    """The bucket's rows of x along ``dim``, in span order."""
    parts = [x.narrow(dim, a, b - a) for a, b in spans]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def _valid(bk: Bucket) -> torch.Tensor:
    """(rows, ndlon_b): the points j < NLOEN of the bucket's rows."""
    return (torch.arange(bk.ndlon, device=bk.rows.device)[None, :]
            < bk.rows[1][:, None])


def _place(out: torch.Tensor, piece: torch.Tensor, spans, dim: int) -> None:
    """Write the bucket's rows ``piece`` (along ``dim``, in span order)
    into ``out`` at the start of its other axes, zeros past piece's extent
    there, rounded to ``out``'s dtype."""
    off = 0
    for a, b in spans:
        dst = out.narrow(dim, a, b - a)
        src = piece.narrow(dim, off, b - a)
        dst.zero_()
        dst[tuple(slice(0, n) for n in src.shape)].copy_(src)
        off += b - a


def _syn_count(bt: BucketedTables) -> float:
    return 2.0 * bt.M * bt.nrows


def _ana_count(bk: Bucket) -> float:
    return float(bk.rows.shape[1] * bk.ndlon)


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _check_sums(ss, shape: tuple) -> None:
    if ss is not None and (tuple(ss.shape) != shape
                           or ss.dtype != PASS_DTYPE):
        raise ValueError(f"sums of squares must be {PASS_DTYPE} {shape}, got "
                         f"{ss.dtype} {tuple(ss.shape)}")


def _check_pass(a: torch.Tensor, bh: torch.Tensor) -> None:
    """a must be a contiguous complex128 (pairs, rows, nfft) on bh's card."""
    if not (a.is_contiguous() and a.dtype == torch.complex128
            and a.shape[1:] == bh.shape and a.device == bh.device):
        raise ValueError(f"the passes take a contiguous complex128 (pairs, "
                         f"{tuple(bh.shape)}) on {bh.device}, got {a.dtype} "
                         f"{tuple(a.shape)} on {a.device}")


def _check_out(out: torch.Tensor, bt: BucketedTables, shape: tuple) -> None:
    """out must be contiguous fp32 or fp64 on the tables' card, of
    ``shape`` (None: any length)."""
    if not (out.is_contiguous() and out.dtype in (torch.float32,
                                                  torch.float64)
            and out.device == bt.mkeep.device and out.dim() == len(shape)
            and all(n is None or n == k for n, k in zip(shape, out.shape))):
        raise ValueError(f"the output must be a contiguous float32 or "
                         f"float64 {shape} on {bt.mkeep.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")


def _pass_buffer(like: torch.Tensor, bk: Bucket, npairs: int):
    return torch.empty((npairs, bk.rows.shape[1], bk.nfft),
                       dtype=torch.complex128, device=like.device)


def sums_synthesis_plain(x: torch.Tensor, bt: BucketedTables):
    return (torch.where(bt.keep, x, 0.0).to(PASS_DTYPE).square()
            .sum((1, 2, 3))[:, None])


def sums_synthesis(x: torch.Tensor, bt: BucketedTables) -> torch.Tensor:
    """F4, synthesis: each field's sum of squares over the inputs it reads
    (``bt.keep``), (nfld, P) fp64."""
    if _build.on_cpu(x):
        return sums_synthesis_plain(x, bt)
    x = _operand(x, bt)
    nfld, _, M, nrows = x.shape
    ss = torch.empty((nfld, NP), dtype=PASS_DTYPE, device=x.device)
    with _build.on_device(x):
        _build.launch("ect_fourier_syn_ss", x.dtype, x.data_ptr(),
                      bt.mkeep.data_ptr(), ss.data_ptr(), nfld, M, nrows)
    sums_synthesis.launches += 1
    return ss


def sums_analysis_plain(g: torch.Tensor, bt: BucketedTables):
    return torch.stack([
        torch.where(_valid(bk), _rows(g[..., : bk.ndlon], bk.spans, 1), 0.0)
        .to(PASS_DTYPE).square().sum((1, 2)) for bk in bt.buckets],
        1)[..., None]


def sums_analysis(g: torch.Tensor, bt: BucketedTables) -> torch.Tensor:
    """F4, analysis: each field's sum of squares over each bucket's points
    j < NLOEN, (nfld, nbuckets, P) fp64."""
    if _build.on_cpu(g):
        return sums_analysis_plain(g, bt)
    g = _operand(g, bt)
    nfld, nrows, ndlon = g.shape
    nb = len(bt.buckets)
    ss = torch.empty((nfld, nb, NP), dtype=PASS_DTYPE, device=g.device)
    with _build.on_device(g):
        _build.launch("ect_fourier_ana_ss", g.dtype, g.data_ptr(),
                      bt.rows.data_ptr(), bt.starts.data_ptr(),
                      ss.data_ptr(), nfld, nb, nrows, ndlon)
    sums_analysis.launches += 1
    return ss


def pre_synthesis_plain(x, bt: BucketedTables, bk: Bucket, ss, p0: int,
                        p1: int) -> torch.Tensor:
    mb = bk.mb
    keep = _rows(bt.keep[:, : mb + 1], bk.spans, 2)
    f = _rows(_pairs(x, p0, p1)[:, :, : mb + 1], bk.spans, 3)
    f = torch.where(keep, f, 0.0).to(PASS_DTYPE)
    if ss is not None:
        f = f * _scales(ss, _syn_count(bt), 2 * p0,
                        2 * p1).reciprocal()[:, None, None, None]
    f = f.transpose(2, 3)                         # (2n, 2, rows, mb + 1)
    a, b = f[0::2], f[1::2]
    ar, ai, br, bi = a[:, 0], a[:, 1], b[:, 0], b[:, 1]
    w_pos = torch.complex(ar - bi, ai + br)       # slots mb .. 2 mb
    w_neg = torch.complex(ar + bi, br - ai)[..., 1:].flip(-1)
    w = torch.cat([w_neg, w_pos], -1) * bk.syn_in
    return torch.nn.functional.pad(w, (0, bk.nfft - w.shape[-1]))


def pre_synthesis(x: torch.Tensor, bt: BucketedTables, bk: Bucket, ss,
                  p0: int, p1: int) -> torch.Tensor:
    """F1, synthesis: pairs p0 .. p1 - 1 of the Fourier input x (nfld, 2,
    M, nrows), masked by ``bt.keep``, in fp64, times the reciprocals of
    their RMS, as the bucket's Hermitian pair packs w_m = F_a,m + i F_b,m
    at slot mb + m and w_{-m} = conj F_a,m + i conj F_b,m at slot mb - m,
    times syn_in, zero up to nfft: (p1 - p0, rows, nfft) complex128."""
    if _build.on_cpu(x):
        return pre_synthesis_plain(x, bt, bk, ss, p0, p1)
    x = _operand(x, bt)
    nfld, _, M, nrows = x.shape
    _check_sums(ss, (nfld, NP))
    a = _pass_buffer(x, bk, p1 - p0)
    with _build.on_device(x):
        _build.launch("ect_fourier_syn_pre", x.dtype, x.data_ptr(),
                      bt.mkeep.data_ptr(), bk.rows.data_ptr(),
                      bk.syn_in.data_ptr(), _ptr(ss), _syn_count(bt),
                      a.data_ptr(), nfld, M, nrows, a.shape[1], bk.mb,
                      bk.nfft, p0, p1 - p0)
    pre_synthesis.launches += 1
    return a


def pre_analysis_plain(g, bt: BucketedTables, bk: Bucket, ib: int, ss,
                       p0: int, p1: int) -> torch.Tensor:
    x = _rows(_pairs(g, p0, p1)[..., : bk.ndlon], bk.spans, 1)
    x = torch.where(_valid(bk), x, 0.0).to(PASS_DTYPE)
    if ss is not None:
        x = x * _scales(ss[:, ib], _ana_count(bk), 2 * p0,
                        2 * p1).reciprocal()[:, None, None]
    z = torch.complex(x[0::2], x[1::2]) * bk.ana_in
    return torch.nn.functional.pad(z, (0, bk.nfft - bk.ndlon))


def pre_analysis(g: torch.Tensor, bt: BucketedTables, bk: Bucket, ib: int,
                 ss, p0: int, p1: int) -> torch.Tensor:
    """F1, analysis: pairs p0 .. p1 - 1 of the grid g (nfld, nrows, ndlon)
    on bucket ``ib``'s rows, the points j < NLOEN in fp64 times the
    reciprocals of their RMS over the bucket, as z = f_a + i f_b times
    ana_in, zero up to nfft: (p1 - p0, rows, nfft) complex128."""
    if _build.on_cpu(g):
        return pre_analysis_plain(g, bt, bk, ib, ss, p0, p1)
    g = _operand(g, bt)
    nfld, nrows, ndlon = g.shape
    nb = len(bt.buckets)
    _check_sums(ss, (nfld, nb, NP))
    a = _pass_buffer(g, bk, p1 - p0)
    with _build.on_device(g):
        _build.launch("ect_fourier_ana_pre", g.dtype, g.data_ptr(),
                      bk.rows.data_ptr(), bk.ana_in.data_ptr(),
                      None if ss is None else ss[:, ib].data_ptr(), nb * NP,
                      _ana_count(bk), a.data_ptr(), nfld, nrows, ndlon,
                      a.shape[1], bk.ndlon, bk.nfft, p0, p1 - p0)
    pre_analysis.launches += 1
    return a


def chirp_fft(a: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The unnormalized FFT of a's rows (``inverse``: the unnormalized
    inverse FFT; its 1/nfft is in the kernel FFTs of ``bucket_tables``):
    one ``torch.fft`` call, counted in ``calls`` on a card (cuFFT may run
    it as several kernels)."""
    if inverse:
        out = torch.fft.ifft(a, norm="forward")
    else:
        out = torch.fft.fft(a)
    if not _build.on_cpu(a):
        chirp_fft.calls += 1
    return out


def chirp_product(a: torch.Tensor, bh: torch.Tensor) -> None:
    """F2: a (pairs, rows, nfft) times the kernel FFTs bh (rows, nfft), in
    place."""
    if _build.on_cpu(a):
        a.mul_(bh)
        return
    _check_pass(a, bh)
    with _build.on_device(a):
        _build.launch("ect_fourier_product", None, a.data_ptr(),
                      bh.data_ptr(), a.shape[1], a.shape[2], a.shape[0])
    chirp_product.launches += 1


def post_synthesis_plain(b, bt: BucketedTables, bk: Bucket, ss,
                         out: torch.Tensor, p0: int) -> None:
    n = b.shape[0]
    g = b[..., : bk.ndlon] * bk.syn_out
    # (n, rows, ndlon_b) complex -> (2 n, rows, ndlon_b): Re, Im
    piece = torch.view_as_real(g).permute(0, 3, 1, 2).reshape(
        2 * n, g.shape[1], g.shape[2])
    if ss is not None:
        piece = piece * _scales(ss, _syn_count(bt), 2 * p0,
                                2 * (p0 + n))[:, None, None]
    nf = min(2 * n, out.shape[0] - 2 * p0)
    _place(out[2 * p0: 2 * p0 + nf], piece[:nf], bk.spans, 1)


def post_synthesis(b: torch.Tensor, bt: BucketedTables, bk: Bucket, ss,
                   out: torch.Tensor, p0: int) -> None:
    """F3, synthesis: the first ndlon_b points of b (pairs, rows, nfft),
    the inverse FFT's output, times syn_out: the real parts to fields 2p,
    the imaginary parts to fields 2p + 1 (p from p0), times their RMS,
    rounded once into their rows of out (nfld, nrows, ndlon), zeros past
    ndlon_b."""
    if _build.on_cpu(b):
        post_synthesis_plain(b, bt, bk, ss, out, p0)
        return
    _check_pass(b, bk.syn_bh)
    _check_out(out, bt, (None, bt.nrows, bt.ndlon))
    nfld, nrows, ndlon = out.shape
    _check_sums(ss, (nfld, NP))
    with _build.on_device(b):
        _build.launch("ect_fourier_syn_post", out.dtype, b.data_ptr(),
                      bk.syn_out.data_ptr(), bk.rows.data_ptr(), _ptr(ss),
                      _syn_count(bt), out.data_ptr(), nfld, nrows, ndlon,
                      b.shape[1], bk.ndlon, bk.nfft, p0, b.shape[0])
    post_synthesis.launches += 1


def post_analysis_plain(b, bt: BucketedTables, bk: Bucket, ib: int, ss,
                        out: torch.Tensor, p0: int) -> None:
    mb, n = bk.mb, b.shape[0]
    K = min(out.shape[2], mb + 1)
    v = b[..., : 2 * mb + 1] * bk.ana_out            # slots m + mb
    zp = v[..., mb: mb + K]
    zn = v[..., : mb + 1].flip(-1)[..., :K]          # Z_{-m}
    zpr, zpi, znr, zni = zp.real, zp.imag, zn.real, zn.imag
    fa = torch.stack([(zpr + znr) * 0.5, (zpi - zni) * 0.5], 1)
    fb = torch.stack([(zpi + zni) * 0.5, (znr - zpr) * 0.5], 1)
    piece = torch.stack([fa, fb], 1)                 # (n, 2, 2, rows, K)
    piece = piece.reshape(2 * n, 2, piece.shape[3], K).transpose(2, 3)
    if ss is not None:
        piece = piece * _scales(ss[:, ib], _ana_count(bk), 2 * p0,
                                2 * (p0 + n))[:, None, None, None]
    nf = min(2 * n, out.shape[0] - 2 * p0)
    _place(out[2 * p0: 2 * p0 + nf], piece[:nf], bk.spans, 3)


def post_analysis(b: torch.Tensor, bt: BucketedTables, bk: Bucket, ib: int,
                  ss, out: torch.Tensor, p0: int) -> None:
    """F3, analysis: slots mb -+ m of b (pairs, rows, nfft), the inverse
    FFT's output, times ana_out, as F_a,m = (Z_m + conj Z_{-m}) / 2 and
    F_b,m = (Z_m - conj Z_{-m}) / 2i of fields 2p and 2p + 1 (p from p0),
    times their RMS over bucket ``ib``, rounded once into its rows of out
    (nfld, 2, M, nrows), zeros from m = min(M, mb + 1) up."""
    if _build.on_cpu(b):
        post_analysis_plain(b, bt, bk, ib, ss, out, p0)
        return
    _check_pass(b, bk.ana_bh)
    _check_out(out, bt, (None, 2, None, bt.nrows))
    nfld, _, M, nrows = out.shape
    nb = len(bt.buckets)
    _check_sums(ss, (nfld, nb, NP))
    with _build.on_device(b):
        _build.launch("ect_fourier_ana_post", out.dtype, b.data_ptr(),
                      bk.ana_out.data_ptr(), bk.rows.data_ptr(),
                      None if ss is None else ss[:, ib].data_ptr(), nb * NP,
                      _ana_count(bk), out.data_ptr(), nfld, M, nrows,
                      b.shape[1], bk.mb, min(M, bk.mb + 1), bk.nfft, p0,
                      b.shape[0])
    post_analysis.launches += 1


def _pair_chunks(npairs: int, bk: Bucket):
    """(p0, p1) ranges of pairs whose three (pairs, rows, nfft) complex128
    arrays fit in ``_CHUNK_BYTES``."""
    per_pair = 3 * bk.rows.shape[1] * bk.nfft * 16
    chunk = max(1, _CHUNK_BYTES // per_pair)
    return [(p, min(npairs, p + chunk)) for p in range(0, npairs, chunk)]


def staged_synthesis(x, bt: BucketedTables, bk: Bucket, ss,
                     out: torch.Tensor) -> None:
    """Bucket bk's synthesis pass for every pair of x as five stages a
    chunk of pairs: F1, the FFT, F2, the inverse FFT, F3."""
    for p0, p1 in _pair_chunks((x.shape[0] + 1) // 2, bk):
        a = chirp_fft(pre_synthesis(x, bt, bk, ss, p0, p1))
        chirp_product(a, bk.syn_bh)
        a = chirp_fft(a, inverse=True)
        post_synthesis(a, bt, bk, ss, out, p0)


def staged_analysis(g, bt: BucketedTables, bk: Bucket, ib: int, ss,
                    out: torch.Tensor) -> None:
    """Bucket ib's analysis pass for every pair of g as five stages a
    chunk of pairs."""
    for p0, p1 in _pair_chunks((g.shape[0] + 1) // 2, bk):
        a = chirp_fft(pre_analysis(g, bt, bk, ib, ss, p0, p1))
        chirp_product(a, bk.ana_bh)
        a = chirp_fft(a, inverse=True)
        post_analysis(a, bt, bk, ib, ss, out, p0)


def _check_fused(bk: Bucket, x: torch.Tensor, out: torch.Tensor) -> None:
    limit = smem_limit(x.device)
    if not fuses(bk.nfft, limit) or bk.place is None:
        raise ValueError(f"nfft {bk.nfft} does not fit one block "
                         f"({fused_smem_bytes(bk.nfft)} bytes of shared "
                         f"memory, {limit} allowed)")
    if out.dtype != x.dtype:
        raise TypeError(f"F5 writes its input's dtype {x.dtype}, got an "
                        f"output of {out.dtype}")


def pass_synthesis(x: torch.Tensor, bt: BucketedTables, bk: Bucket, ss,
                   out: torch.Tensor) -> None:
    """F5, synthesis: bucket bk's whole pass for every pair of the Fourier
    input x (nfld, 2, M, nrows), F1 to F3 of ``staged_synthesis`` in one
    launch, each (row, pair) in one block's shared memory, rounded once
    into its rows of out (nfld, nrows, ndlon); on the CPU the staged plain
    stages."""
    if _build.on_cpu(x):
        staged_synthesis(x, bt, bk, ss, out)
        return
    x = _operand(x, bt)
    nfld, _, M, nrows = x.shape
    _check_sums(ss, (nfld, NP))
    _check_out(out, bt, (nfld, bt.nrows, bt.ndlon))
    _check_fused(bk, x, out)
    with _build.on_device(x):
        _build.launch("ect_fourier_syn_fused", x.dtype, x.data_ptr(),
                      bt.mkeep.data_ptr(), bk.rows.data_ptr(),
                      bk.syn_in.data_ptr(), bk.syn_bh.data_ptr(),
                      bk.syn_out.data_ptr(), bk.twiddles.data_ptr(),
                      bk.place.data_ptr(), _ptr(ss), _syn_count(bt),
                      out.data_ptr(), nfld, M, nrows, bt.ndlon,
                      bk.rows.shape[1], bk.ndlon, bk.mb, bk.nfft,
                      fused_smem_bytes(bk.nfft), fft_plan(bk.radices),
                      len(bk.radices),
                      (nfld + 1) // 2)
    pass_synthesis.launches += 1


def pass_analysis(g: torch.Tensor, bt: BucketedTables, bk: Bucket, ib: int,
                  ss, out: torch.Tensor) -> None:
    """F5, analysis: bucket ib's whole pass for every pair of the grid g
    (nfld, nrows, ndlon), F1 to F3 of ``staged_analysis`` in one launch,
    rounded once into its rows of out (nfld, 2, M, nrows) for m < min(M,
    mb + 1); the rows' higher m are left as they are (zeros in a layer
    call, which fills its output with zeros first); on the CPU the staged
    plain stages, which write those zeros."""
    if _build.on_cpu(g):
        staged_analysis(g, bt, bk, ib, ss, out)
        return
    g = _operand(g, bt)
    nfld, nrows, ndlon = g.shape
    nb = len(bt.buckets)
    _check_sums(ss, (nfld, nb, NP))
    _check_out(out, bt, (nfld, 2, None, bt.nrows))
    _check_fused(bk, g, out)
    M = out.shape[2]
    with _build.on_device(g):
        _build.launch("ect_fourier_ana_fused", g.dtype, g.data_ptr(),
                      bk.rows.data_ptr(), bk.ana_in.data_ptr(),
                      bk.ana_bh.data_ptr(), bk.ana_out.data_ptr(),
                      bk.twiddles.data_ptr(), bk.place.data_ptr(),
                      None if ss is None else ss[:, ib].data_ptr(), nb * NP,
                      _ana_count(bk), out.data_ptr(), nfld, M, nrows, ndlon,
                      bk.rows.shape[1], bk.ndlon, bk.mb, min(M, bk.mb + 1),
                      bk.nfft, fused_smem_bytes(bk.nfft),
                      fft_plan(bk.radices), len(bk.radices), (nfld + 1) // 2)
    pass_analysis.launches += 1


for _stage in (sums_synthesis, sums_analysis, pre_synthesis, pre_analysis,
               chirp_product, post_synthesis, post_analysis, pass_synthesis,
               pass_analysis):
    _stage.launches = 0
chirp_fft.calls = 0


def _fused(x: torch.Tensor, bk: Bucket) -> bool:
    """Whether the layer runs bucket bk as F5: on a card, where it fits."""
    return not _build.on_cpu(x) and fuses(bk.nfft, smem_limit(x.device))


def _operand(x: torch.Tensor, bt: BucketedTables) -> torch.Tensor:
    """x as the stages take it: as it is on the CPU; contiguous, fp32 or
    fp64, on the tables' card on a card."""
    if _build.on_cpu(x):
        return x
    if x.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the Fourier layer takes float32 or float64, got "
                        f"{x.dtype}")
    if x.device != bt.mkeep.device:
        raise ValueError(f"input on {x.device}, tables on {bt.mkeep.device}")
    return x.contiguous()


def _synthesize(fourier: torch.Tensor, bt: BucketedTables,
                normalize: bool) -> torch.Tensor:
    x = _operand(fourier, bt)
    nfld = x.shape[0]
    ss = sums_synthesis(x, bt) if normalize else None
    out = x.new_empty((nfld, bt.nrows, bt.ndlon))
    fuse = [_fused(x, bk) for bk in bt.buckets]
    for bk, fused in zip(bt.buckets, fuse):
        with hook("fourier.bucket"):
            if fused:
                pass_synthesis(x, bt, bk, ss, out)
            else:
                staged_synthesis(x, bt, bk, ss, out)
    _count_buckets(fuse)
    return out


def _analyze(grid: torch.Tensor, bt: BucketedTables, M: int,
             normalize: bool) -> torch.Tensor:
    x = _operand(grid, bt)
    nfld = x.shape[0]
    ss = sums_analysis(x, bt) if normalize else None
    fuse = [_fused(x, bk) for bk in bt.buckets]
    # F5 leaves the zeros above each bucket's mb to this fill
    out = (x.new_zeros if any(fuse) else x.new_empty)((nfld, 2, M,
                                                        bt.nrows))
    for ib, (bk, fused) in enumerate(zip(bt.buckets, fuse)):
        with hook("fourier.bucket"):
            if fused:
                pass_analysis(x, bt, bk, ib, ss, out)
            else:
                staged_analysis(x, bt, bk, ib, ss, out)
    _count_buckets(fuse)
    return out


def _count_buckets(fuse: list) -> None:
    count("fourier.fused", sum(fuse))
    count("fourier.staged", len(fuse) - sum(fuse))


def _adjoint_weights(bt: BucketedTables, dtype: torch.dtype,
                     M: int) -> torch.Tensor:
    """(2, M, nrows) c_m * NLOEN(row) (c_0 = 1, c_m = 2 above) where
    synthesis reads its input (``bt.keep``), else 0: synthesis^T = this *
    analysis, and analysis^T = synthesis of the cotangent divided by it."""
    c = torch.where(torch.arange(M, device=bt.mkeep.device) == 0, 1.0, 2.0)
    w = c.to(dtype)[:, None] * bt.nloen.to(dtype)[None, :]
    return torch.where(bt.keep[:, :M], w, 0.0)


class _BucketSynthesis(torch.autograd.Function):
    """synthesis_bucketed with its transpose: the grid cotangent's
    analysis times c_m * NLOEN (``_adjoint_weights``)."""

    @staticmethod
    def forward(ctx, fourier, bt, normalize):
        ctx.bt, ctx.normalize = bt, normalize
        return _synthesize(fourier, bt, normalize)

    @staticmethod
    def backward(ctx, grad):
        bt = ctx.bt
        back = _analyze(grad, bt, bt.M, ctx.normalize)
        return back * _adjoint_weights(bt, back.dtype, bt.M), None, None


class _BucketAnalysis(torch.autograd.Function):
    """analysis_bucketed with its transpose: the synthesis of the Fourier
    cotangent divided by c_m * NLOEN where synthesis reads it (0 elsewhere:
    those outputs of analysis are 0 whatever the grid)."""

    @staticmethod
    def forward(ctx, grid, bt, M, normalize):
        ctx.bt, ctx.normalize = bt, normalize
        return _analyze(grid, bt, M, normalize)

    @staticmethod
    def backward(ctx, grad):
        bt = ctx.bt
        M = grad.shape[2]
        w = _adjoint_weights(bt, grad.dtype, M)
        h = torch.where(w > 0, grad / torch.where(w > 0, w, 1.0), 0.0)
        h = torch.nn.functional.pad(h, (0, 0, 0, bt.M - M))
        return _synthesize(h, bt, ctx.normalize), None, None, None


def synthesis_bucketed(fourier: torch.Tensor, bt: BucketedTables,
                       normalize: bool = True) -> torch.Tensor:
    """(nfld, 2, M, nrows) Fourier coefficients -> (nfld, nrows, ndlon)
    grid through the buckets' chirp-z transforms, in fp64, rounded once to
    the input's dtype.  ``normalize`` divides each field by its RMS over
    the inputs it reads (``bt.keep``) before the pair pack and multiplies
    the output back; ``normalize=False`` keeps the function linear (the
    adjoints).  Differentiable: its transpose is the scaled analysis."""
    nfld, two, M, nrow = fourier.shape
    if two != 2 or M != bt.M or nrow != bt.nrows:
        raise ValueError(f"synthesis_bucketed expects (nfld, 2, {bt.M}, "
                         f"{bt.nrows}), got {tuple(fourier.shape)}")
    return _BucketSynthesis.apply(fourier, bt, normalize)


def analysis_bucketed(grid: torch.Tensor, bt: BucketedTables, M: int,
                      normalize: bool = True) -> torch.Tensor:
    """(nfld, nrows, ndlon) grid -> (nfld, 2, M, nrows) Fourier
    coefficients through the buckets' chirp-z transforms, zero above each
    bucket's mb, in fp64, rounded once to the grid's dtype.  ``normalize``
    divides each field by its RMS over the bucket's points j < NLOEN,
    bucket by bucket, as ``ectrans_tpu`` does, and multiplies the
    coefficients back.  Differentiable: its transpose is the scaled
    synthesis."""
    nfld, nrow, ndlon = grid.shape
    if nrow != bt.nrows or ndlon != bt.ndlon or M > bt.M:
        raise ValueError(f"analysis_bucketed expects (nfld, {bt.nrows}, "
                         f"{bt.ndlon}) and M <= {bt.M}, got "
                         f"{tuple(grid.shape)}, M {M}")
    return _BucketAnalysis.apply(grid, bt, M, normalize)
