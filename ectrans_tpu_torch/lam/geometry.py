"""LAM grid geometry and elliptic spectral truncation.

Copy of ``ectrans_tpu/lam/geometry.py`` (numpy only): the geometry layer of
the reference etrans (ESETUP_TRANS arguments ``esetup_trans.F90:117-130``:
KMSMAX/KSMAX zonal and meridional truncations, KDGL extended-domain
latitudes, KDGUX unextended latitudes, KLOEN uniform longitudes; wavenumber
scale factors EXWN/EYWN = 2 pi / L as ectrans4py computes them,
``spec_setup4py.F90:146-147``) and the elliptic truncation of
``ellips.F90``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np


def ellips(nsmax: int, msmax: int) -> tuple[np.ndarray, np.ndarray]:
    """Elliptic truncation limits (reference ELLIPS, ``ellips.F90:68-100``).

    Returns (kntmp, kmtmp): kntmp[m] = max meridional wavenumber kept at
    zonal wavenumber m (0..msmax); kmtmp[n] = max zonal wavenumber at
    meridional n (0..nsmax).
    """
    eps = 1e-10
    kntmp = np.zeros(msmax + 1, dtype=np.int64)
    kmtmp = np.zeros(nsmax + 1, dtype=np.int64)
    for jm in range(1, msmax):
        zkn = nsmax / msmax * np.sqrt(max(0.0, float(msmax**2 - jm**2)))
        kntmp[jm] = int(zkn + eps)
    kntmp[0] = nsmax
    if msmax > 0:
        kntmp[msmax] = 0
    for jn in range(1, nsmax):
        zkm = msmax / nsmax * np.sqrt(max(0.0, float(nsmax**2 - jn**2)))
        kmtmp[jn] = int(zkm + eps)
    kmtmp[0] = msmax
    if nsmax > 0:
        kmtmp[nsmax] = 0
    return kntmp, kmtmp


@dataclasses.dataclass(frozen=True)
class LamGrid:
    """Biperiodic LAM grid: ``nx`` x ``ny`` extended domain (C+I+E zones),
    with the C+I (unextended) part ``nxux`` x ``nyux``."""

    nx: int        # KDLON: total longitudes (extended, periodic)
    ny: int        # KDGL: total latitudes (extended, periodic)
    nxux: int      # KDLUX: C+I zone longitudes
    nyux: int      # KDGUX: C+I zone latitudes
    msmax: int     # zonal truncation
    nsmax: int     # meridional truncation
    dx: float = 1.0   # grid spacing (metres) -> exwn = 2*pi/(nx*dx)
    dy: float = 1.0

    @property
    def exwn(self) -> float:
        return 2.0 * np.pi / (self.nx * self.dx)

    @property
    def eywn(self) -> float:
        return 2.0 * np.pi / (self.ny * self.dy)

    @functools.cached_property
    def kntmp(self) -> np.ndarray:
        return ellips(self.nsmax, self.msmax)[0]

    @property
    def nspec2(self) -> int:
        """Packed spectral length: 4 reals per elliptic (m, n) pair
        (reference R%NSPEC2_G, ``esetup_dims_mod.F90:39-43``)."""
        return int(4 * (self.kntmp + 1).sum())

    @property
    def ngptot(self) -> int:
        return self.nx * self.ny

    @property
    def ngptot_ci(self) -> int:
        return self.nxux * self.nyux


def make_lam_grid(
    nx: int,
    ny: int,
    nxux: int | None = None,
    nyux: int | None = None,
    msmax: int | None = None,
    nsmax: int | None = None,
    dx: float = 1.0,
    dy: float = 1.0,
) -> LamGrid:
    """Construct a LamGrid with reference-benchmark defaults: linear
    truncation msmax = (nx-1)//2, nsmax = (ny-1)//2 on the extended domain
    (cf. ``ectrans-lam-benchmark.F90`` default truncations), and no
    extension zone unless nxux/nyux given."""
    if nxux is None:
        nxux = nx
    if nyux is None:
        nyux = ny
    if msmax is None:
        msmax = (nx - 1) // 2
    if nsmax is None:
        nsmax = (ny - 1) // 2
    if not (0 < nxux <= nx and 0 < nyux <= ny):
        raise ValueError(f"C+I zone {nxux}x{nyux} exceeds domain {nx}x{ny}")
    if 2 * msmax + 1 > nx or 2 * nsmax + 1 > ny:
        raise ValueError(
            f"truncation ({msmax},{nsmax}) unresolvable on {nx}x{ny} grid"
        )
    return LamGrid(nx=nx, ny=ny, nxux=nxux, nyux=nyux,
                   msmax=msmax, nsmax=nsmax, dx=dx, dy=dy)
