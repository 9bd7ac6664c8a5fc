"""Biperiodicization: extend C+I-zone fields onto the periodic E zone.

Counterpart of ``ectrans_tpu/lam/biper.py``, the reference FPBIPERE chain
vectorized (``fpbipere.F90:117-165``): cubic-spline extension (ESPLINE,
``espline_mod.F90``, with alpha = 0 as FPBIPERE passes) followed by
iterative 9-point smoothing of the extension zone (ESMOOTHE,
``esmoothe_mod.F90``), plus an erf-bell Boyd windowing variant (EWINDOWE,
``ewindowe_mod.F90:78-103`` bell function).  Runs on the device of its
input tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import LamGrid


def _spline_extend_last(f, nux: int, ntot: int):
    """Cubic-spline extension along the last axis (ESPLINE, alpha = 0).

    f: (..., >=nux) with valid data in [0, nux); returns (..., ntot) where
    [nux, ntot) is the spline arc closing the period back to f[..., 0].
    """
    K = float(ntot - nux + 1)
    Kp1 = K + 1.0
    lam = K / Kp1
    fx = f[..., nux - 1]     # f(KDLUX)
    fx1 = f[..., nux - 2]    # f(KDLUX-1)
    f1 = f[..., 0]           # f(KDLUN)
    f2 = f[..., 1]           # f(KDLUN+1)
    eps_a = ((f1 - fx) / K - fx + fx1) * 6.0 / Kp1
    eps_b = (f2 - f1 - (f1 - fx) / K) * 6.0 / Kp1
    mm = 4.0 - lam * lam
    m1 = (2.0 * eps_a - lam * eps_b) / mm
    m2 = (2.0 * eps_b - lam * eps_a) / mm
    a = fx
    b = (f1 - fx) / K - (2.0 * m1 + m2) * K / 6.0
    c = 0.5 * m1
    d = (m2 - m1) / (6.0 * K)
    j = torch.arange(1, ntot - nux + 1, dtype=f.dtype, device=f.device)
    ext = (a[..., None] + j * (b[..., None] + j * (c[..., None]
                                                   + j * d[..., None])))
    return torch.cat([f[..., :nux], ext], dim=-1)


def _smooth(f):
    """The 9-point [1 2 1]^2/16 smoothing of every point, with periodic
    wrap neighbours."""
    up = torch.roll(f, 1, dims=1)      # lat-1 with wrap
    dn = torch.roll(f, -1, dims=1)
    lf = torch.roll(f, 1, dims=2)
    rt = torch.roll(f, -1, dims=2)
    ul = torch.roll(up, 1, dims=2)
    ur = torch.roll(up, -1, dims=2)
    dl = torch.roll(dn, 1, dims=2)
    dr = torch.roll(dn, -1, dims=2)
    return (4.0 * f + 2.0 * (lf + rt + up + dn) + ul + ur + dl + dr) / 16.0


def _smooth_pass_x(f, nxux: int, jll: int):
    """One ESMOOTHE x-direction pass: 9-point smoothing of longitude
    columns [nxux+jll-1, nx-jll] (0-based, inclusive) over all rows."""
    cols = torch.arange(f.shape[2], device=f.device)
    # 1-based [KDLUX+JLL, KDLON-JLL+1] -> 0-based [nxux+jll-1, nx-jll]
    m = (cols >= nxux + jll - 1) & (cols <= f.shape[2] - jll)
    return torch.where(m[None, None, :], _smooth(f), f)


def _smooth_pass_y(f, nyux: int, jll: int):
    rows = torch.arange(f.shape[1], device=f.device)
    m = (rows >= nyux + jll - 1) & (rows <= f.shape[1] - jll)
    return torch.where(m[None, :, None], _smooth(f), f)


def _boyd_bell(width: int, scal: float, like: torch.Tensor) -> torch.Tensor:
    """Erf bell window of EWINDOWE (``ewindowe_mod.F90:78-90``), computed in
    fp64 and cast to like's dtype and device."""
    j = torch.arange(1, width + 1, dtype=torch.float64)
    z = (-width - 1 + 2 * j) / (width + 1)
    zl = z / torch.sqrt(torch.clamp(1.0 - z * z, min=1e-300))
    bell = (1.0 + torch.special.erf(scal * zl)) / 2.0
    return bell.to(dtype=like.dtype, device=like.device)


def _wrap(f, ext: int, dim: int):
    """The first ``ext`` entries of f along ``dim``, f repeated if it is
    shorter."""
    n = f.shape[dim]
    if ext > n:
        reps = [1] * f.dim()
        reps[dim] = -(-ext // n)
        f = f.repeat(*reps)
    return f.narrow(dim, 0, ext)


def biperiodicize(field, grid: LamGrid, mode: str = "spline",
                  boyd_scale: float = 1.0):
    """Extend C+I-zone data onto the full biperiodic domain.

    field: (nfld, nyux, nxux) C+I data (or (nfld, ny, nx) with garbage in
    the E zone, of which only the C+I part is read), a tensor (on its
    device) or an array (on the CPU).  Returns (nfld, ny, nx).

    mode "spline": cubic-spline extension + 9-point smoothing (the
    FPBIPERE default path).  mode "boyd": erf-bell blend of the two
    periodic continuations across the E zone (the EWINDOWE bell, applied in
    the standard layout rather than the reference's guard-zone buffer).
    mode "zeros": zero-fill (for testing).
    """
    f = torch.as_tensor(field)[:, : grid.nyux, : grid.nxux]
    nx, ny, nxux, nyux = grid.nx, grid.ny, grid.nxux, grid.nyux
    if nxux == nx and nyux == ny:
        return f
    if mode == "zeros":
        return F.pad(f, (0, nx - nxux, 0, ny - nyux))
    if mode == "spline":
        if nxux < nx:
            f = _spline_extend_last(f, nxux, nx)
        if nyux < ny:
            f = _spline_extend_last(f.transpose(1, 2), nyux,
                                    ny).transpose(1, 2)
        # ESMOOTHE: (max extension + 1) // 2 passes in each direction
        npass = (max(nx - nxux, ny - nyux) + 1) // 2
        for jll in range(1, npass + 1):
            if nxux < nx:
                f = _smooth_pass_x(f, nxux, jll)
            if nyux < ny:
                f = _smooth_pass_y(f, nyux, jll)
        return f
    if mode == "boyd":
        if nxux < nx:
            ex = nx - nxux
            bell = _boyd_bell(ex, boyd_scale, f)
            # blend the continuation from the left edge with a linear
            # closure toward the right edge's periodic image
            jj = torch.arange(1, ex + 1, dtype=f.dtype,
                              device=f.device) / (ex + 1)
            left = f[..., -1:]
            right = f[..., :1]
            lin = left + (right - left) * jj
            ext = (1.0 - bell) * lin + bell * _wrap(f, ex, 2)
            f = torch.cat([f, ext], dim=-1)
        if nyux < ny:
            ey = ny - nyux
            bell = _boyd_bell(ey, boyd_scale, f)[:, None]
            jj = (torch.arange(1, ey + 1, dtype=f.dtype,
                               device=f.device) / (ey + 1))[:, None]
            top = f[:, -1:, :]
            bot = f[:, :1, :]
            lin = top + (bot - top) * jj
            ext = (1.0 - bell) * lin + bell * _wrap(f, ey, 1)
            f = torch.cat([f, ext], dim=1)
        return f
    raise ValueError(f"unknown biperiodicization mode {mode!r}")
