"""ectrans4py-compatible convenience API: one process, numpy fp64 in and out.

Counterpart of ``ectrans_tpu/compat4py.py``, with the function surface of
the reference's Python binding (``src/ectrans4py/__init__.py:77-432``) so
that epygram-style callers switch without code changes:

  ectrans_version, trans_inq4py, etrans_inq4py, get_legendre_assets,
  sp2gp_gauss4py, gp2sp_gauss4py, sp2gp_lam4py, gp2sp_lam4py,
  sp2gp_fft1d4py

The positional signatures are the JAX package's.  Every transforming
function also takes a keyword-only ``device``, a CUDA card by default
(``"cpu"`` runs the plain PyTorch versions); without a card a CUDA call
raises, it never falls back to the CPU.  The transforms run in float64 (on
the card the fp64 variants of the Legendre kernels).  LREORDER reproduces
the FA-file <-> model coefficient reordering of the reference shims
(``sp2gp_gauss4py.F90:82-107``, ``gp2sp_lam4py.F90:75-121``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import __version__, api
from .grids import GridSpec
from .resolution import ON_TRANS_END, setup
from .transform import InvFlags, dir_trans, inv_trans

F64 = torch.float64


def ectrans_version() -> str:
    return f"ectrans_tpu_torch {__version__}"


def _device(device) -> torch.device:
    return api._handle_device(device, "compat4py")


def _gauss_grid(ksizej: int, ktrunc: int, kloen) -> GridSpec:
    nloen = tuple(int(x) for x in np.asarray(kloen)[:ksizej])
    reduced = len(set(nloen)) > 1
    return GridSpec(f"G4PY{ksizej}", int(ktrunc), int(ksizej), nloen, reduced)


def trans_inq4py(KSIZEJ, KTRUNC, KSLOEN, KLOEN, KNUMMAXRESOL=10):
    """(KGPTOT, KSPEC, KNMENG) — reference trans_inq4py
    (``__init__.py:164-190``)."""
    grid = _gauss_grid(KSIZEJ, KTRUNC, KLOEN)
    res = setup(grid)
    knmeng = np.zeros(int(KSLOEN), dtype=np.int64)
    knmeng[: grid.ndgl] = res.nmen
    return int(grid.ngptot), int(grid.nspec), knmeng


def etrans_inq4py(KSIZEI, KSIZEJ, KPHYSICALSIZEI, KPHYSICALSIZEJ,
                  KTRUNCX, KTRUNCY, KNUMMAXRESOL=10,
                  PDELTAX=1.0, PDELTAY=1.0):
    """(KGPTOT, KSPEC) for a LAM resolution (``__init__.py:123-159``)."""
    from .lam import make_lam_grid

    grid = make_lam_grid(int(KSIZEI), int(KSIZEJ),
                         nxux=int(KPHYSICALSIZEI), nyux=int(KPHYSICALSIZEJ),
                         msmax=int(KTRUNCX), nsmax=int(KTRUNCY),
                         dx=float(PDELTAX), dy=float(PDELTAY))
    return int(grid.ngptot), int(grid.nspec2)


def get_legendre_assets(KSIZEJ, KTRUNC, KSLOEN, KSPOLEGL, KLOEN,
                        KNUMMAXRESOL=10):
    """(KNMENG, PGW, PRPNM) — cut-off wavenumbers, Gaussian weights and the
    NH Legendre polynomials (``__init__.py:89-118``), from the host parity
    tables (``Resolution.parity_tables``, through the legpol cache): fp64,
    or fp32 above ``ECTRANS_TPU_FP64_TABLE_LIMIT``, as the JAX package's
    setup tables.  PRPNM columns are m-major with n descending within m (the LT
    work ordering, NLTN), the first KSPOLEGL of them."""
    grid = _gauss_grid(KSIZEJ, KTRUNC, KLOEN)
    res = setup(grid)
    knmeng = np.zeros(int(KSLOEN), dtype=np.int64)
    knmeng[: grid.ndgl] = res.nmen
    _, w = grid.gauss()
    pgw = np.zeros(int(KSLOEN))
    pgw[: grid.ndgl] = w
    nh, ncol = grid.ndgnh, int(KSPOLEGL)
    prpnm = np.zeros((int(KSLOEN) // 2, ncol))
    psym, pasym = res.parity_tables()
    col = 0
    for m in range(grid.nsmax + 1):
        if col >= ncol:
            break
        n = np.arange(grid.nsmax + 1, m - 1, -1)[: ncol - col]  # descending
        k = (n - m) // 2
        odd = ((n - m) % 2 == 1)[None, :]
        prpnm[:nh, col: col + n.size] = np.where(odd, pasym[m][:, k],
                                                 psym[m][:, k])
        col += n.size
    return knmeng, pgw, prpnm


@functools.lru_cache(maxsize=4)
def _fa_index(ktrunc: int) -> tuple:
    """(m, FA index of re, FA index of im) of each model-order (m, n), m
    major, n ascending: the FA block of n is centred on n^2 + n (0-based;
    ``sp2gp_gauss4py.F90:85-107``), re(m, n) at the centre + m, im(m, n)
    at the centre - m (none for m = 0)."""
    m = np.repeat(np.arange(ktrunc + 1), ktrunc + 1 - np.arange(ktrunc + 1))
    n = np.concatenate([np.arange(jm, ktrunc + 1)
                        for jm in range(ktrunc + 1)])
    centre = n * n + n
    return m, centre + m, centre - m


def _reorder_fa_to_model(pspec: np.ndarray, ktrunc: int,
                         nspec2: int) -> np.ndarray:
    """FA file order -> model (NASM0 m-major) order
    (sp2gp_gauss4py.F90:93-107)."""
    m, re, im = _fa_index(ktrunc)
    pspec = np.asarray(pspec)
    out = np.zeros(nspec2)
    out[0: 2 * m.size: 2] = pspec[re]
    out[1: 2 * m.size: 2] = np.where(m == 0, 0.0, pspec[im])
    return out


def _reorder_model_to_fa(spec_model: np.ndarray, ktrunc: int,
                         ksize: int) -> np.ndarray:
    """Model order -> FA file order (gp2sp_gauss4py.F90:92-117 inverse)."""
    m, re, im = _fa_index(ktrunc)
    spec_model = np.asarray(spec_model)
    out = np.zeros(ksize)
    out[re] = spec_model[0: 2 * m.size: 2]
    out[im[m > 0]] = spec_model[1: 2 * m.size: 2][m > 0]
    return out


@functools.lru_cache(maxsize=8)
def _reduced_index(nloen: tuple, ndlon: int, device: str) -> torch.Tensor:
    """Flat index of each reduced-grid point, latitude-major, in padded
    (ndgl, ndlon) rows, on ``device``."""
    keep = np.arange(ndlon)[None, :] < np.asarray(nloen)[:, None]
    return torch.as_tensor(np.flatnonzero(keep), device=device)


def _index(nloen, ndlon: int, device) -> torch.Tensor:
    return _reduced_index(tuple(int(n) for n in nloen), int(ndlon),
                          str(device))


def _pack_reduced(field2d, nloen):
    """(..., ndgl, ndlon) padded rows -> (..., ngptot) flat reduced-grid
    vectors (latitude-major); a numpy array or a tensor, on its device."""
    x = torch.as_tensor(field2d)
    out = x.flatten(-2)[..., _index(nloen, x.shape[-1], x.device)]
    return out if isinstance(field2d, torch.Tensor) else out.numpy()


def _unpack_reduced(flat, nloen, ndlon: int):
    """(..., ngptot) flat reduced-grid vectors -> (..., ndgl, ndlon) padded
    rows, zero beyond each row's NLOEN; a numpy array or a tensor."""
    x = torch.as_tensor(flat)
    out = x.new_zeros(x.shape[:-1] + (len(nloen) * int(ndlon),))
    out[..., _index(nloen, ndlon, x.device)] = x
    out = out.unflatten(-1, (len(nloen), int(ndlon)))
    return out if isinstance(flat, torch.Tensor) else out.numpy()


def _tensor(x, device: torch.device) -> torch.Tensor:
    """A copy of the caller's array as fp64 on ``device``."""
    return torch.tensor(np.asarray(x, dtype=np.float64), device=device)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def sp2gp_gauss4py(KSIZEJ, KTRUNC, KNUMMAXRESOL, KGPTOT, KSLOEN, KLOEN,
                   KSIZE, LGRADIENT, LREORDER, PSPEC, *, device="cuda"):
    """Spectral -> grid (+ optional N-S/E-W derivatives), global Gaussian
    grid (``__init__.py:305-360``).  Returns (PGPT, PGPTM, PGPTL)."""
    dev = _device(device)
    grid = _gauss_grid(KSIZEJ, KTRUNC, KLOEN)
    res = setup(grid)
    spec = np.asarray(PSPEC, dtype=np.float64)
    if LREORDER:
        spec = _reorder_fa_to_model(spec, int(KTRUNC), res.nspec2)
    out = inv_trans(res, spscalar=_tensor(spec[None], dev),
                    flags=InvFlags(scders=bool(LGRADIENT)), dtype=F64)
    packed = _host(_pack_reduced(out, grid.nloen))
    pgpt = packed[0]
    if LGRADIENT:
        return pgpt, packed[1], packed[2]   # N-S, then E-W derivative
    return pgpt, np.zeros_like(pgpt), np.zeros_like(pgpt)


def gp2sp_gauss4py(KSPEC, KSIZEJ, KTRUNC, KNUMMAXRESOL, KSLOEN, KLOEN,
                   KSIZE, LREORDER, PGPT, *, device="cuda"):
    """Grid -> spectral, global Gaussian grid (``__init__.py:364-410``)."""
    dev = _device(device)
    grid = _gauss_grid(KSIZEJ, KTRUNC, KLOEN)
    res = setup(grid)
    field = _unpack_reduced(_tensor(PGPT, dev), grid.nloen, grid.ndlon)
    _, _, spec = dir_trans(res, scalars=field[None], dtype=F64)
    spec = _host(spec[0])
    if LREORDER:
        spec = _reorder_model_to_fa(spec, int(KTRUNC), int(KSPEC))
    return spec[: int(KSPEC)]


# ----------------------------------------------------------------------
# LAM


@functools.lru_cache(maxsize=16)
def _lam_res(nx, ny, nxux, nyux, mx, my, dx, dy):
    from .lam import make_lam_grid, setup_lam

    return setup_lam(make_lam_grid(nx, ny, nxux=nxux, nyux=nyux,
                                   msmax=mx, nsmax=my, dx=dx, dy=dy))


def _release() -> None:
    """Drop the LAM resolutions and the index maps kept here (``trans_end``,
    through ``resolution.ON_TRANS_END``)."""
    _lam_res.cache_clear()
    _reduced_index.cache_clear()
    _fa_index.cache_clear()


ON_TRANS_END.append(_release)


def _lam_fa_index(res) -> tuple:
    """(FA index, model index) of every packed LAM value: the FA order
    groups the coefficients by meridional n, m ascending, 4 reals per
    (m, n) (gp2sp_lam4py.F90:81-90); the model order is m-major (NESM0)."""
    def build():
        fa, model = [], []
        start = 0
        for jn in range(res.grid.nsmax + 1):
            ms = np.flatnonzero(res.kntmp >= jn)  # zonal m's reaching jn
            fa.append(start + 4 * np.arange(ms.size))
            model.append(np.asarray(res.nesm0)[ms] + 4 * jn)
            start += 4 * ms.size
        quad = np.arange(4)
        return tuple((np.concatenate(x)[:, None] + quad).ravel()
                     for x in (fa, model))

    return res.cached(("fa_index",), build)


def _lam_reorder_fa_to_model(pspec, res):
    fa, model = _lam_fa_index(res)
    out = np.zeros(res.nspec2)
    out[model] = np.asarray(pspec)[fa]
    return out


def _lam_reorder_model_to_fa(spec_model, res, ksize):
    fa, model = _lam_fa_index(res)
    out = np.zeros(ksize)
    out[fa] = np.asarray(spec_model)[model]
    return out


def sp2gp_lam4py(KSIZEI, KSIZEJ, KPHYSICALSIZEI, KPHYSICALSIZEJ,
                 KTRUNCX, KTRUNCY, KNUMMAXRESOL, KSIZE, LGRADIENT,
                 LREORDER, PDELTAX, PDELTAY, PSPEC, *, device="cuda"):
    """LAM spectral -> grid (``__init__.py:195-249``): returns
    (PGPT, PGPTM, PGPTL) flattened over the extended domain."""
    from .lam import LamInvFlags, inv_trans_lam

    dev = _device(device)
    res = _lam_res(int(KSIZEI), int(KSIZEJ), int(KPHYSICALSIZEI),
                   int(KPHYSICALSIZEJ), int(KTRUNCX), int(KTRUNCY),
                   float(PDELTAX), float(PDELTAY))
    spec = np.asarray(PSPEC, dtype=np.float64)
    if LREORDER:
        spec = _lam_reorder_fa_to_model(spec, res)
    out = _host(inv_trans_lam(
        res, spscalar=_tensor(spec[None], dev),
        flags=LamInvFlags(scders=bool(LGRADIENT)), dtype=F64))
    pgpt = out[0].ravel()
    if LGRADIENT:
        return pgpt, out[1].ravel(), out[2].ravel()
    return pgpt, np.zeros_like(pgpt), np.zeros_like(pgpt)


def gp2sp_lam4py(KSIZE, KSIZEI, KSIZEJ, KPHYSICALSIZEI, KPHYSICALSIZEJ,
                 KTRUNCX, KTRUNCY, KNUMMAXRESOL, PDELTAX, PDELTAY,
                 LREORDER, PGPT, *, device="cuda"):
    """LAM grid -> spectral (``__init__.py:254-300``)."""
    from .lam import dir_trans_lam

    dev = _device(device)
    res = _lam_res(int(KSIZEI), int(KSIZEJ), int(KPHYSICALSIZEI),
                   int(KPHYSICALSIZEJ), int(KTRUNCX), int(KTRUNCY),
                   float(PDELTAX), float(PDELTAY))
    field = _tensor(PGPT, dev).reshape(1, int(KSIZEJ), int(KSIZEI))
    _, _, spec, _, _ = dir_trans_lam(res, scalars=field, dtype=F64)
    spec = _host(spec[0])
    if LREORDER:
        spec = _lam_reorder_model_to_fa(spec, res, int(KSIZE))
    return spec[: int(KSIZE)]


def sp2gp_fft1d4py(KSIZES, KTRUNC, PSPEC, KSIZEG, *, device="cuda"):
    """1-D spectral -> grid synthesis (vertical-section academic model,
    ``__init__.py:413-432``): half-complex coefficients (re, im pairs up to
    KTRUNC) to KSIZEG points, by ``torch.fft`` (``ops.fourier``)."""
    from .ops.fourier import synthesis_uniform

    dev = _device(device)
    spec = _tensor(PSPEC, dev)
    n = 2 * (int(KTRUNC) + 1)
    return _host(synthesis_uniform(spec[0:n:2], spec[1:n:2], int(KSIZEG)))
