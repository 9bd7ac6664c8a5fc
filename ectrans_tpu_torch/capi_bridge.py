"""Bridge module for the C API of this package (``capi/``).

Counterpart of ``ectrans_tpu/capi_bridge.py``, called by the C shim
``capi/ectrans_tpu_torch_capi.c`` (the header is ``src/capi/ectrans_tpu.h``)
with the same entry points.  The C layer passes raw pointers as integers;
this module wraps them zero-copy as numpy arrays (ctypes), moves them to the
handle's device, runs the transforms there and writes the results back into
the caller's buffers in place.  Spectral layout: ecTrans packed (NASM0);
grid layout: flat reduced-grid points, latitude-major (the transi grid
convention, ``compat4py._pack_reduced``).

Each setup reads two environment variables:

* ``ECTRANS_TPU_CAPI_DEVICE``: a CUDA card unless it says ``cpu``; without
  a card the setup fails (the shim returns its setup error), it never runs
  on the CPU instead;
* ``ECTRANS_TPU_CAPI_DTYPE``: the working dtype of the double-precision
  entries, ``float64`` (default) or ``float32``.  The ``_f`` entries run in
  float32.

Global and LAM handles share one counter.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os

import numpy as np
import torch

from . import api
from .adjoint import dir_trans_adj, inv_trans_adj
from .compat4py import _pack_reduced, _unpack_reduced
from .latlon import LatLonGrid, inv_trans_latlon
from .norms import gpnorm as _gpnorm
from .norms import specnorm as _specnorm
from .resolution import setup as _setup
from .transform import InvFlags, dir_trans, inv_trans

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


@dataclasses.dataclass(frozen=True)
class _Handle:
    res: object             # Resolution, or LamResolution
    device: torch.device
    dtype: torch.dtype      # working dtype of the double-precision entries


_RESOLUTIONS: dict[int, _Handle] = {}
_LAM: dict[int, _Handle] = {}
_NEXT = [0]
_DEFAULT_RADIUS = [0.0]  # 0: the default (Earth); trans_set_radius


def _wrap(ptr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_double * n).from_address(int(ptr))
    return np.ctypeslib.as_array(buf)


def _wrap_f(ptr: int, n: int) -> np.ndarray:
    buf = (ctypes.c_float * n).from_address(int(ptr))
    return np.ctypeslib.as_array(buf)


def _get(h: _Handle, ptr: int, shape: tuple, wrap=_wrap) -> torch.Tensor:
    """The caller's buffer of ``shape`` as a tensor on the handle's device
    (the buffer itself on the CPU: the transforms only read it)."""
    n = int(np.prod(shape))
    return torch.from_numpy(wrap(ptr, n).reshape(shape)).to(h.device)


def _put(ptr: int, x: torch.Tensor, wrap=_wrap) -> None:
    """Write x, flattened, into the caller's buffer (one device-to-host
    copy, converting to the buffer's dtype)."""
    torch.from_numpy(wrap(ptr, x.numel())).copy_(x.reshape(-1))


def _get_grid(h: _Handle, ptr: int, nfld: int, wrap=_wrap) -> torch.Tensor:
    """nfld flat reduced-grid fields -> (nfld, ndgl, ndlon) padded rows."""
    g = h.res.grid
    return _unpack_reduced(_get(h, ptr, (nfld, g.ngptot), wrap), g.nloen,
                           g.ndlon)


def _put_grid(h: _Handle, ptr: int, grid: torch.Tensor, wrap=_wrap) -> None:
    _put(ptr, _pack_reduced(grid, h.res.grid.nloen), wrap)


def _open(res, table: dict) -> int:
    """Register res under a new handle on the device and in the dtype that
    the environment names."""
    name = os.environ.get("ECTRANS_TPU_CAPI_DTYPE", "float64")
    if name not in _DTYPES:
        raise ValueError(f"ECTRANS_TPU_CAPI_DTYPE={name!r}: float64 or "
                         "float32")
    want = os.environ.get("ECTRANS_TPU_CAPI_DEVICE", "cuda")
    device = api._handle_device("cpu" if want == "cpu" else "cuda",
                                "the C API")
    h = _NEXT[0]
    _NEXT[0] += 1
    table[h] = _Handle(res, device, _DTYPES[name])
    return h


def set_radius(radius: float):
    """Global planet-radius override applied to subsequent setups (the
    reference's ``trans_set_radius``, ``transi.h:131``)."""
    _DEFAULT_RADIUS[0] = float(radius)
    return 0


def setup(grid: str, nsmax: int) -> int:
    kw = {}
    if _DEFAULT_RADIUS[0] > 0.0:
        kw["radius"] = _DEFAULT_RADIUS[0]
    return _open(_setup(grid, None if nsmax < 0 else nsmax, **kw),
                 _RESOLUTIONS)


def setup_ex(grid: str, nsmax: int, radius: float, stretch: float) -> int:
    """Per-resolution setup with explicit radius and Schmidt stretching
    (reference SETUP_TRANS PRESOL radius + PSTRET, ``setup_trans.F90``).
    radius <= 0 / stretch <= 0 select the defaults."""
    kw = {}
    if radius > 0.0:
        kw["radius"] = radius
    elif _DEFAULT_RADIUS[0] > 0.0:
        kw["radius"] = _DEFAULT_RADIUS[0]
    if stretch > 0.0:
        kw["stretch"] = stretch
    return _open(_setup(grid, None if nsmax < 0 else nsmax, **kw),
                 _RESOLUTIONS)


def _res(handle: int) -> _Handle:
    return _RESOLUTIONS[handle]


def inquire(handle: int):
    res = _res(handle).res
    return (int(res.nspec2), int(res.grid.ngptot), int(res.ndgl),
            int(res.grid.ndlon), int(res.nsmax))


def fill_nloen(handle: int, ptr: int):
    res = _res(handle).res
    buf = (ctypes.c_int * res.ndgl).from_address(int(ptr))
    np.ctypeslib.as_array(buf)[:] = np.asarray(res.grid.nloen, np.int32)
    return 0


def invtrans_scalar(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    h = _res(handle)
    spec = _get(h, spec_ptr, (nfld, h.res.nspec2))
    _put_grid(h, gp_ptr, inv_trans(h.res, spscalar=spec, dtype=h.dtype))
    return 0


def dirtrans_scalar(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    h = _res(handle)
    _, _, spec = dir_trans(h.res, scalars=_get_grid(h, gp_ptr, nfld),
                           dtype=h.dtype)
    _put(spec_ptr, spec)
    return 0


def invtrans_vordiv(handle: int, nfld: int, vor_ptr: int, div_ptr: int,
                    u_ptr: int, v_ptr: int):
    h = _res(handle)
    shape = (nfld, h.res.nspec2)
    out = inv_trans(h.res, spvor=_get(h, vor_ptr, shape),
                    spdiv=_get(h, div_ptr, shape), dtype=h.dtype)
    _put_grid(h, u_ptr, out[:nfld])
    _put_grid(h, v_ptr, out[nfld: 2 * nfld])
    return 0


def dirtrans_vordiv(handle: int, nfld: int, u_ptr: int, v_ptr: int,
                    vor_ptr: int, div_ptr: int):
    h = _res(handle)
    spvor, spdiv, _ = dir_trans(h.res, u=_get_grid(h, u_ptr, nfld),
                                v=_get_grid(h, v_ptr, nfld), dtype=h.dtype)
    _put(vor_ptr, spvor)
    _put(div_ptr, spdiv)
    return 0


def invtrans_full(handle: int, nvordiv: int, nscalar: int, vor_ptr: int,
                  div_ptr: int, sc_ptr: int, lscalarders: int,
                  luvder_ew: int, lvordivgp: int, gp_ptr: int):
    """Full-option inverse transform: vor/div + scalars with the reference
    InvTrans_t derivative flags (``transi.h:1014-1016`` lscalarders /
    luvder_EW / lvordivgp).  Grid output follows the documented PGP field
    ordering (``inv_trans.F90:58-106``); returns nfld_out."""
    h = _res(handle)
    nspec2 = h.res.nspec2
    spvor = spdiv = spsc = None
    if nvordiv:
        spvor = _get(h, vor_ptr, (nvordiv, nspec2))
        spdiv = _get(h, div_ptr, (nvordiv, nspec2))
    if nscalar:
        spsc = _get(h, sc_ptr, (nscalar, nspec2))
    flags = InvFlags(scders=bool(lscalarders), uvders=bool(luvder_ew),
                     vorgp=bool(lvordivgp), divgp=bool(lvordivgp))
    out = inv_trans(h.res, spvor, spdiv, spsc, flags=flags, dtype=h.dtype)
    _put_grid(h, gp_ptr, out)
    return out.shape[0]


def dirtrans_full(handle: int, nvordiv: int, nscalar: int, gp_ptr: int,
                  vor_ptr: int, div_ptr: int, sc_ptr: int):
    """Combined direct transform: grid U, V, scalars (in that order, the
    reference DirTrans_t contract) -> spectral vor/div + scalars."""
    h = _res(handle)
    fields = _get_grid(h, gp_ptr, 2 * nvordiv + nscalar)
    u = v = sc = None
    if nvordiv:
        u, v = fields[:nvordiv], fields[nvordiv: 2 * nvordiv]
    if nscalar:
        sc = fields[2 * nvordiv:]
    spvor, spdiv, spsc = dir_trans(h.res, u, v, sc, dtype=h.dtype)
    if nvordiv:
        _put(vor_ptr, spvor)
        _put(div_ptr, spdiv)
    if nscalar:
        _put(sc_ptr, spsc)
    return 0


def invtrans_adj_scalar(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    """Adjoint of the scalar inverse transform (INV_TRANSAD)."""
    h = _res(handle)
    _, _, spsc_ad = inv_trans_adj(h.res, _get_grid(h, gp_ptr, nfld), 0,
                                  nfld, dtype=h.dtype)
    _put(spec_ptr, spsc_ad)
    return 0


def dirtrans_adj_scalar(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    """Adjoint of the scalar direct transform (DIR_TRANSAD)."""
    h = _res(handle)
    spec = _get(h, spec_ptr, (nfld, h.res.nspec2))
    _, _, sc_ad = dir_trans_adj(h.res, spscalar_ad=spec, nfld_sc=nfld,
                                dtype=h.dtype)
    _put_grid(h, gp_ptr, sc_ad)
    return 0


def specnorm(handle: int, nfld: int, spec_ptr: int, norm_ptr: int):
    h = _res(handle)
    _put(norm_ptr, _specnorm(h.res, _get(h, spec_ptr, (nfld, h.res.nspec2))))
    return 0


def release(handle: int):
    _RESOLUTIONS.pop(handle, None)
    return 0


def set_legpol_dir(path: str):
    """trans_set_cache/read/write equivalent (transi.h:192-194): directory
    of the on-disk legpol cache (``cache.py``; '' disables it)."""
    os.environ["ECTRANS_TPU_LEGPOL_DIR"] = path
    return 0


def vordiv_to_uv(handle: int, nfld: int, vor_ptr: int, div_ptr: int,
                 u_ptr: int, v_ptr: int):
    """Standalone spectral vor/div -> spectral U,V (trans_vordiv_to_UV,
    transi.h:648)."""
    h = _res(handle)
    shape = (nfld, h.res.nspec2)
    u, v = api.vordiv_to_uv(h.res, _get(h, vor_ptr, shape),
                            _get(h, div_ptr, shape), dtype=h.dtype)
    _put(u_ptr, u)
    _put(v_ptr, v)
    return 0


def gpnorm(handle: int, nfld: int, gp_ptr: int, out_ptr: int):
    """Grid-point norms (GPNORM_TRANS): out (nfld, 3) = [ave, min, max]
    with the reference's area weights."""
    h = _res(handle)
    ave, mn, mx = _gpnorm(h.res, _get_grid(h, gp_ptr, nfld))
    _put(out_ptr, torch.stack([ave, mn, mx], dim=1))
    return 0


def invtrans_lonlat(handle: int, nlat: int, nlon: int, nfld: int,
                    spec_ptr: int, gp_ptr: int):
    """Inverse transform onto a regular lat-lon grid (the LDLL /
    trans_set_resol_lonlat mode, transi.h:869): gp is (nfld, nlat, nlon)
    row-major."""
    h = _res(handle)
    spec = _get(h, spec_ptr, (nfld, h.res.nspec2))
    _put(gp_ptr, inv_trans_latlon(h.res, LatLonGrid(nlat=nlat, nlon=nlon),
                                  spscalar=spec, dtype=h.dtype))
    return 0


# --- distribution (one process: transi with TRANS_USE_MPI=0 performs plain
# copies; dist/gath here are the same owner-view copies, transi.h:520-616) ---

def distgrid(handle: int, nfld: int, glob_ptr: int, loc_ptr: int):
    n = nfld * _res(handle).res.grid.ngptot
    _wrap(loc_ptr, n)[:] = _wrap(glob_ptr, n)
    return 0


def gathgrid(handle: int, nfld: int, loc_ptr: int, glob_ptr: int):
    n = nfld * _res(handle).res.grid.ngptot
    _wrap(glob_ptr, n)[:] = _wrap(loc_ptr, n)
    return 0


def distspec(handle: int, nfld: int, glob_ptr: int, loc_ptr: int):
    n = nfld * _res(handle).res.nspec2
    _wrap(loc_ptr, n)[:] = _wrap(glob_ptr, n)
    return 0


def gathspec(handle: int, nfld: int, loc_ptr: int, glob_ptr: int):
    n = nfld * _res(handle).res.nspec2
    _wrap(glob_ptr, n)[:] = _wrap(loc_ptr, n)
    return 0


# --- single-precision entry points (the reference's trans_sp build /
# DIST_GRID_32 family) ---

def invtrans_scalar_f(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    h = _res(handle)
    spec = _get(h, spec_ptr, (nfld, h.res.nspec2), _wrap_f)
    _put_grid(h, gp_ptr, inv_trans(h.res, spscalar=spec,
                                   dtype=torch.float32), _wrap_f)
    return 0


def dirtrans_scalar_f(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    h = _res(handle)
    _, _, spec = dir_trans(h.res, scalars=_get_grid(h, gp_ptr, nfld, _wrap_f),
                           dtype=torch.float32)
    _put(spec_ptr, spec, _wrap_f)
    return 0


# --- LAM (etrans) surface: ectrans_tpu_setup_lam + transforms ---

def setup_lam(nx: int, ny: int, nxux: int, nyux: int, msmax: int, nsmax: int,
              dx: float, dy: float) -> int:
    from .lam import make_lam_grid, setup_lam as _setup_lam

    lres = _setup_lam(make_lam_grid(
        nx, ny, nxux=nxux, nyux=nyux,
        msmax=msmax if msmax >= 0 else None,
        nsmax=nsmax if nsmax >= 0 else None, dx=dx, dy=dy))
    return _open(lres, _LAM)


def inquire_lam(handle: int):
    lres = _LAM[handle].res
    g = lres.grid
    return (int(lres.nspec2), int(g.nx * g.ny), int(g.nx), int(g.ny))


def invtrans_lam_scalar(handle: int, nfld: int, spec_ptr: int, gp_ptr: int):
    from .lam import inv_trans_lam

    h = _LAM[handle]
    spec = _get(h, spec_ptr, (nfld, h.res.nspec2))
    _put(gp_ptr, inv_trans_lam(h.res, spscalar=spec, dtype=h.dtype))
    return 0


def dirtrans_lam_scalar(handle: int, nfld: int, gp_ptr: int, spec_ptr: int):
    from .lam import dir_trans_lam

    h = _LAM[handle]
    g = h.res.grid
    gp = _get(h, gp_ptr, (nfld, g.ny, g.nx))
    _put(spec_ptr, dir_trans_lam(h.res, scalars=gp, dtype=h.dtype)[2])
    return 0


def release_lam(handle: int):
    _LAM.pop(handle, None)
    return 0
