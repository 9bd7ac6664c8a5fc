"""LAM inverse/direct bi-Fourier transforms (EINV_TRANS / EDIR_TRANS).

Counterpart of ``ectrans_tpu/lam/transform.py`` (reference transform chain
``einv_trans_ctl_mod.F90:264-292``): the meridional DFT (the reference's
ELEINV/ELEDIR "Legendre" stage, ``eleinv_mod.F90:95-108``) and the zonal
DFT run as whole-tensor ``torch.fft`` transforms on uniform rows
(``ops.fourier.synthesis_uniform``/``analysis_uniform``), on the device of
the input tensors.

Spectral-space operators (all diagonal in bi-Fourier space):
  * winds from vor/div   — EVDTUV (``evdtuv_mod.F90:95-135``):
      U = rlepinm (i kx D - i ky Z),  V = rlepinm (i kx Z + i ky D),
      rlepinm = -1/(kx^2 + ky^2) (``suemp_trans_preleg_mod.F90:91``),
      mean wind (m=n=0) injected from meanu/meanv.
  * vor/div from winds   — EUVTVD (``euvtvd_mod.F90:95-127``):
      Z = i kx V - i ky U,  D = i kx U + i ky V; mean wind extracted
      (``eltdir_mod.F90:160-182``).
  * N-S derivative       — ESPNSDE: i ky F.
  * E-W derivative       — EFSC:    i kx F.

The FFT passes run in fp64 for fp32 transforms too and round once (as the
"xla" engine's fp32 Legendre sums do): in fp32 the row-column passes leave
the error of the large low-wavenumber winds on a few rows, where EUVTVD's
multiplication by the wavenumber lifts it to 3.7 times the 100 eps
round-trip gate at the 1.3 km domain (1536 x 1280) on an NVIDIA H100
80GB HBM3 at 700 W; the fp32 grid's own rounding takes 0.007 of it.  The spectral operators run in the
working dtype.

Grid arrays are (nfld, ny, nx) over the full extended (biperiodic) domain;
use ``lam.biper.biperiodicize`` to extend C+I data first.  Both transforms
are linear and differentiable (the adjoints of ``lam.adjoint``); the
packed -> dense gather carries its transpose as a scatter
(``ops.layout.gather_packed``).
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import layout
from ..ops.fourier import analysis_uniform, synthesis_uniform
from ..resolution import check_dtype
from ..transform import _check_spec, _device_of
from .resolution import LamResolution


@dataclasses.dataclass(frozen=True)
class LamInvFlags:
    vorgp: bool = False
    divgp: bool = False
    scders: bool = False
    uvders: bool = False


def _izon(x):
    """Multiply by i in the zonal direction: components (RR,RI,IR,II) ->
    (-IR, -II, RR, RI)."""
    return torch.stack([-x[:, 2], -x[:, 3], x[:, 0], x[:, 1]], dim=1)


def _imer(x):
    """Multiply by i in the meridional direction: (RR,RI,IR,II) ->
    (-RI, RR, -II, IR)."""
    return torch.stack([-x[:, 1], x[:, 0], -x[:, 3], x[:, 2]], dim=1)


def packed_to_dense(spec, t):
    """(nfld, nspec2) -> (nfld, 4, M, N), exact zeros outside the
    ellipse."""
    return layout.gather_packed(spec, t["dense_gather"])


def dense_to_packed(dense, t):
    return dense[:, t["packed_c"], t["packed_m"], t["packed_n"]]


def vordiv_to_uv_lam(dvor, ddiv, t, meanu=None, meanv=None):
    """EVDTUV: dense (nfld, 4, M, N) vor/div -> U, V."""
    kx, ky, rl = t["kx"], t["ky"], t["rlepinm"]
    u = rl * (kx * _izon(ddiv) - ky * _imer(dvor))
    v = rl * (kx * _izon(dvor) + ky * _imer(ddiv))
    if meanu is not None:
        u = u.clone()
        v = v.clone()
        u[:, 0, 0, 0] = meanu
        v[:, 0, 0, 0] = meanv
    return u, v


def uv_to_vordiv_lam(du, dv, t):
    """EUVTVD: dense U, V -> vor, div (+ mean wind extraction)."""
    kx, ky = t["kx"], t["ky"]
    vor = kx * _izon(dv) - ky * _imer(du)
    div = kx * _izon(du) + ky * _imer(dv)
    return vor * t["valid"], div * t["valid"], du[:, 0, 0, 0], dv[:, 0, 0, 0]


def inv_groups(dvor, ddiv, dsc, t: dict, flags: LamInvFlags, meanu=None,
               meanv=None) -> list:
    """EVDTUV, ESPNSDE and the EFSC E-W derivatives: dense vor/div (None
    without winds; the mean wind put at (m=0, n=0) when given) and scalars
    (None without) -> the groups [vor?, div?, u and v, scalars, N-S
    derivs?, E-W u/v derivs?, E-W scalar derivs?]."""
    groups = []
    uvd = None
    if dvor is not None:
        du, dv = vordiv_to_uv_lam(dvor, ddiv, t, meanu, meanv)
        groups += [x for x, on in ((dvor, flags.vorgp), (ddiv, flags.divgp))
                   if on]
        uvd = torch.cat([du, dv])
        groups.append(uvd)
    if dsc is not None:
        groups.append(dsc)
        if flags.scders:
            groups.append(t["ky"] * _imer(dsc))
    if uvd is not None and flags.uvders:
        groups.append(t["kx"] * _izon(uvd))
    if dsc is not None and flags.scders:
        groups.append(t["kx"] * _izon(dsc))
    return groups


def synth2d(dense, ny: int, nx: int):
    """dense (nfld, 4, M, N) -> grid (nfld, ny, nx); both passes in fp64,
    rounded once to dense's dtype."""
    work = dense.double()
    # meridional synthesis per zonal component: (f, M, N) -> (f, M, ny)
    gre = synthesis_uniform(work[:, 0], work[:, 1], ny)
    gim = synthesis_uniform(work[:, 2], work[:, 3], ny)
    # zonal synthesis: (f, ny, M) -> (f, ny, nx)
    out = synthesis_uniform(gre.transpose(1, 2), gim.transpose(1, 2), nx)
    return out.to(dense.dtype)


def anal2d(grid, msmax: int, nsmax: int):
    """grid (nfld, ny, nx) -> dense (nfld, 4, M, N); both passes in fp64,
    rounded once to grid's dtype."""
    zre, zim = analysis_uniform(grid.double(), msmax)            # (f, ny, M)
    rr, ri = analysis_uniform(zre.transpose(1, 2), nsmax)        # (f, M, N)
    ir, ii = analysis_uniform(zim.transpose(1, 2), nsmax)
    return torch.stack([rr, ri, ir, ii], dim=1).to(grid.dtype)


def _check_grid(name, arr, res):
    g = res.grid
    if arr is not None and (arr.ndim != 3 or tuple(arr.shape[1:])
                            != (g.ny, g.nx)):
        raise ValueError(f"{name} must have shape (nfld, ny={g.ny}, "
                         f"nx={g.nx}), got {tuple(arr.shape)}")


def inv_trans_lam(res: LamResolution, spvor=None, spdiv=None, spscalar=None,
                  meanu=None, meanv=None, *,
                  flags: LamInvFlags = LamInvFlags(), dtype=torch.float32):
    """LAM inverse transform: packed spectral -> grid (nfld_out, ny, nx), on
    the device of the spectral inputs.

    Output field ordering follows the global-transform PGP contract:
    vor?, div?, u, v, scalars, N-S scalar derivs?, E-W u/v derivs?,
    E-W scalar derivs?.  meanu/meanv (nfld_uv,): the mean wind, 0 when not
    given.
    """
    if (spvor is None) != (spdiv is None):
        raise ValueError("spvor and spdiv must be supplied together")
    if spvor is None and spscalar is None:
        raise ValueError("nothing to transform")
    for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                    ("spscalar", spscalar)):
        _check_spec(nm, arr, res)
    dtype = check_dtype(dtype)
    device = _device_of(spvor, spdiv, spscalar)
    t = res.device_tables(dtype, device)
    g = res.grid
    nuv = 0 if spvor is None else spvor.shape[0]
    dvor = ddiv = dsc = None
    if nuv:
        meanu, meanv = (torch.zeros(nuv, dtype=dtype, device=device)
                        if x is None else
                        torch.as_tensor(x, dtype=dtype, device=device)
                        for x in (meanu, meanv))
        dvor = packed_to_dense(spvor.to(dtype), t)
        ddiv = packed_to_dense(spdiv.to(dtype), t)
    if spscalar is not None:
        dsc = packed_to_dense(spscalar.to(dtype), t)
    groups = inv_groups(dvor, ddiv, dsc, t, flags, meanu, meanv)
    return synth2d(torch.cat(groups), g.ny, g.nx)


def dir_trans_lam(res: LamResolution, u=None, v=None, scalars=None, *,
                  dtype=torch.float32):
    """LAM direct transform: grid (extended domain) -> packed spectral, on
    the device of the grid inputs.

    Returns (spvor, spdiv, spscalar, meanu, meanv); the mean wind is the
    (m=0, n=0) coefficient of u, v (reference PSPMEANU/V,
    ``eltdir_mod.F90:160-182``).  Entries are None where there was no
    input.
    """
    if (u is None) != (v is None):
        raise ValueError("u and v must be supplied together")
    if u is None and scalars is None:
        raise ValueError("nothing to transform")
    for nm, arr in (("u", u), ("v", v), ("scalars", scalars)):
        _check_grid(nm, arr, res)
    dtype = check_dtype(dtype)
    device = _device_of(u, v, scalars)
    t = res.device_tables(dtype, device)
    g = res.grid
    nuv = 0 if u is None else u.shape[0]
    grid = torch.cat([x.to(dtype) for x in (u, v, scalars) if x is not None])
    dense = anal2d(grid, g.msmax, g.nsmax) * t["valid"]
    spvor = spdiv = spsc = meanu = meanv = None
    if nuv:
        dvor, ddiv, meanu, meanv = uv_to_vordiv_lam(dense[:nuv],
                                                    dense[nuv: 2 * nuv], t)
        spvor = dense_to_packed(dvor, t)
        spdiv = dense_to_packed(ddiv, t)
    if scalars is not None:
        spsc = dense_to_packed(dense[2 * nuv:], t)
    return spvor, spdiv, spsc, meanu, meanv
