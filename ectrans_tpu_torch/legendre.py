"""Normalized associated Legendre functions: host precompute in float64.

Numpy copy of ``ectrans_tpu/legendre.py`` (reference ``suleg_mod.F90``,
``supolf_mod.F90``).  Normalization (ecTrans / IFS convention):

    P̄_n^m(mu) = sqrt((2n+1) (n-m)! / (n+m)!) * P_n^m(mu),   no Condon-Shortley

with the upward three-term recurrence in n

    eps(n+1,m) P̄_{n+1}^m = mu P̄_n^m - eps(n,m) P̄_{n-1}^m,
    eps(n,m) = sqrt((n^2-m^2)/(4n^2-1)).

``eps_table`` and ``sectoral_seeds`` feed the CUDA table generator
(``ops.legendre_tablegen``); ``build_parity_tables`` is the host table
source (tensors on the CPU, and the card under
``ECTRANS_TPU_TABLE_SOURCE=host``): the native C++ builder of ``native/``,
or, only when ``ECTRANS_TPU_DISABLE_NATIVE`` is set,
``compute_legendre_table`` and ``split_parity``, this module's numpy
recurrence.
"""

from __future__ import annotations

import numpy as np

_RESCALE_EVERY = 8
_SCALE_LIMIT = 2.0 ** 500
_SCALE_LIMIT_INV = 2.0 ** -500


def eps_table(nsmax: int, nextra: int = 3) -> np.ndarray:
    """eps[m, n] = sqrt((n^2-m^2)/(4n^2-1)) for 0<=m<=nsmax, 0<=n<=nsmax+nextra.

    Zero where n <= m-1 or n == 0 (matching REPSNM, pre_suleg_mod.F90:50-54).
    """
    mm = np.arange(nsmax + 1, dtype=np.float64)[:, None]
    nn = np.arange(nsmax + nextra + 1, dtype=np.float64)[None, :]
    num = nn * nn - mm * mm
    den = 4.0 * nn * nn - 1.0
    with np.errstate(divide="ignore", invalid="ignore"):
        e = np.sqrt(np.where(num > 0, num / np.where(den == 0, 1.0, den), 0.0))
    return e


def sectoral_seeds(nsmax: int, mu: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (mant, scale): P̄_m^m(mu) = mant[m, lat] * 2^scale[m, lat].

    P̄_m^m = sqrt(2m+1) * prod_{j=1..m} sqrt((2j-1)/(2j)) * cos(theta)^m,
    accumulated in (mantissa, exponent) form: cos^m underflows fp64 at polar
    latitudes for m ~ 1000.
    """
    nlat = mu.shape[0]
    c = np.sqrt(np.maximum(0.0, 1.0 - mu * mu))  # cos(theta) per lat
    mant = np.empty((nsmax + 1, nlat))
    scale = np.empty((nsmax + 1, nlat), dtype=np.int64)
    cur = np.ones(nlat)
    cur_s = np.zeros(nlat, dtype=np.int64)
    mant[0] = cur
    scale[0] = cur_s
    for m in range(1, nsmax + 1):
        cur = cur * c * np.sqrt((2 * m - 1) / (2.0 * m))
        small = (np.abs(cur) < _SCALE_LIMIT_INV) & (cur != 0.0)
        if small.any():
            cur = np.where(small, cur * _SCALE_LIMIT, cur)
            cur_s = np.where(small, cur_s - 500, cur_s)
        mant[m] = cur
        scale[m] = cur_s
    norm = np.sqrt(2.0 * np.arange(nsmax + 1) + 1.0)
    return mant * norm[:, None], scale


def compute_legendre_table(
    nsmax: int,
    mu: np.ndarray,
    ntmax_extra: int = 1,
    nmen_nh: np.ndarray | None = None,
) -> np.ndarray:
    """Dense table P̄[m, n, lat] for 0<=m<=nsmax, 0<=n<=nsmax+ntmax_extra.

    Entries with n < m are zero; with ``nmen_nh`` given, entries with
    m > nmen(lat) are zero (the reference's NDGLU latitude restriction,
    ``setup_geom_mod.F90:85-95``, baked into the operator).
    """
    mu = np.asarray(mu, dtype=np.float64)
    nlat = mu.shape[0]
    nmax = nsmax + ntmax_extra
    M = nsmax + 1
    eps = eps_table(nsmax, ntmax_extra + 1)

    seed_mant, seed_scale = sectoral_seeds(nsmax, mu)

    out = np.zeros((M, nmax + 1, nlat))
    pcur = np.zeros((M, nlat))    # value at current n (mantissa)
    pprev = np.zeros((M, nlat))   # value at n-1 (same scale)
    scale = np.zeros((M, nlat), dtype=np.int64)

    marange = np.arange(M)
    for n in range(0, nmax + 1):
        if n <= nsmax:
            pprev[n] = 0.0
            pcur[n] = seed_mant[n]
            scale[n] = seed_scale[n]
        active = marange < n
        if n > 0 and active.any():
            a = slice(0, min(n, M))
            en = eps[:, n][a, None]
            enm1 = eps[:, n - 1][a, None]
            pnew = (mu[None, :] * pcur[a] - enm1 * pprev[a]) / en
            pprev[a] = pcur[a]
            pcur[a] = pnew
        if n % _RESCALE_EVERY == 0:
            big = np.abs(pcur) > _SCALE_LIMIT
            if big.any():
                pcur = np.where(big, pcur * _SCALE_LIMIT_INV, pcur)
                pprev = np.where(big, pprev * _SCALE_LIMIT_INV, pprev)
                scale = np.where(big, scale + 500, scale)
        sl = slice(0, min(n, nsmax) + 1)
        with np.errstate(under="ignore"):
            vals = np.ldexp(pcur[sl], np.minimum(scale[sl], 0))
            vals = np.where(scale[sl] > 0,
                            pcur[sl] * np.exp2(scale[sl].astype(np.float64)),
                            vals)
        out[sl, n, :] = vals

    if nmen_nh is not None:
        m_ok = np.arange(M)[:, None] <= np.asarray(nmen_nh)[None, :]
        out *= m_ok[:, None, :]
    return out


def split_parity(
    ptable: np.ndarray, nsmax: int
) -> tuple[np.ndarray, np.ndarray, int]:
    """Split P̄[m, n, lat] into (psym, pasym, kmax):
    psym[m, lat, k] = P̄[m, m+2k, lat], pasym[m, lat, k] = P̄[m, m+1+2k, lat],
    zero-padded to a common k extent."""
    M, nrow, nlat = ptable.shape
    nmax = nrow - 1
    kmax = (nmax + 2) // 2
    psym = np.zeros((M, nlat, kmax))
    pasym = np.zeros((M, nlat, kmax))
    for m in range(M):
        ns_even = np.arange(m, nmax + 1, 2)
        ns_odd = np.arange(m + 1, nmax + 1, 2)
        psym[m, :, : ns_even.size] = ptable[m, ns_even, :].T
        pasym[m, :, : ns_odd.size] = ptable[m, ns_odd, :].T
    return psym, pasym, kmax


def build_parity_tables(
    nsmax: int,
    mu: np.ndarray,
    ntmax_extra: int = 1,
    nmen_nh: np.ndarray | None = None,
    dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Parity-split Legendre tables (psym, pasym, kmax) in ``dtype`` (float64
    or float32; the recurrence is fp64): O(nsmax^2 * nlat) host work.  The
    native builder (``native.build_legendre_parity``) writes them directly;
    with ``ECTRANS_TPU_DISABLE_NATIVE`` set, the numpy recurrence builds the
    dense fp64 table, splits it and casts (~4x the tables' memory)."""
    from . import native

    out = native.build_legendre_parity(nsmax, mu, ntmax_extra, nmen_nh, dtype)
    if out is not None:
        return out
    ptable = compute_legendre_table(nsmax, mu, ntmax_extra, nmen_nh)
    psym, pasym, kmax = split_parity(ptable, nsmax)
    return (psym.astype(dtype, copy=False), pasym.astype(dtype, copy=False),
            kmax)
