"""Gaussian grid definitions: full, octahedral and custom reduced grids.

Numpy copy of ``ectrans_tpu/grids.py`` (reference geometry
``tpm_geometry.F90``; per-latitude truncation rules
``setup_geom_mod.F90:41-80``; benchmark grid constructors
``ectrans-benchmark.F90:1039-1049``):

  * ``F<N>``  full (regular) Gaussian grid:   NDGL = 2N lats, NLOEN = 4N.
  * ``O<N>``  octahedral reduced Gaussian:    NDGL = 2N lats,
              NLOEN(i) = 20 + 4*(i-1) from the pole, mirrored.
  * ``TCO<S>`` cubic octahedral truncation:   O(S+1) grid with NSMAX = S.
  * ``TL<S>`` / ``T<S>`` linear full grid:    NDGL = S+1 (rounded even).
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np

from .gauss import gauss_legendre


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Immutable description of a (possibly reduced) Gaussian grid."""

    name: str
    nsmax: int                 # triangular truncation
    ndgl: int                  # number of Gaussian latitudes (even)
    nloen: tuple[int, ...]     # longitudes per latitude, north -> south
    reduced: bool              # True if any nloen differs

    @property
    def ndgnh(self) -> int:
        return self.ndgl // 2

    @property
    def ndlon(self) -> int:
        return max(self.nloen)

    @property
    def ngptot(self) -> int:
        """Total number of grid points."""
        return int(sum(self.nloen))

    @property
    def nspec(self) -> int:
        """Number of complex spectral coefficients (m >= 0 half)."""
        n = self.nsmax
        return (n + 1) * (n + 2) // 2

    @property
    def nspec2(self) -> int:
        """Number of real spectral values (re/im interleaved), = 2*nspec."""
        return 2 * self.nspec

    def gauss(self) -> tuple[np.ndarray, np.ndarray]:
        """(mu, w) Gaussian sin-latitudes (north->south) and weights."""
        return gauss_legendre(self.ndgl)

    def nmen(self) -> np.ndarray:
        """Per-latitude zonal truncation (reference setup_geom_mod.F90:41-80)."""
        nloen = np.asarray(self.nloen, dtype=np.int64)
        nsmax, ndgl, ndgnh = self.nsmax, self.ndgl, self.ndgnh
        nsmaxlin = ndgl - 1
        if nsmax >= nsmaxlin or not self.reduced:
            # linear truncation, or full grid
            return np.minimum(nsmax, (nloen - 1) // 2).astype(np.int32)
        mu, _ = self.gauss()
        r1mu2 = 1.0 - mu * mu
        if nsmax >= ndgl * 2 // 3 - 1:
            # quadratic grid: the reference's scalar factor uses integer
            # division before multiplying by cos^2(lat)
            zsqm2 = (3 * (nsmaxlin - nsmax) // ndgl) * r1mu2
            raw = (nloen - 1) / (2.0 + zsqm2)
            sub = 0
        else:
            # cubic grid
            zsqm2 = r1mu2
            raw = (nloen - 1) / (2.0 + zsqm2)
            sub = 1
        vals = np.minimum(nsmax, raw.astype(np.int64) - sub)
        out = np.empty(ndgl, dtype=np.int64)
        # monotone non-decreasing pole -> equator on each hemisphere
        out[0] = vals[0]
        for j in range(1, ndgnh):
            out[j] = max(out[j - 1], vals[j])
        out[ndgl - 1] = vals[ndgl - 1]
        for j in range(ndgl - 2, ndgnh - 1, -1):
            out[j] = max(out[j + 1], vals[j])
        return np.minimum(out, nsmax).astype(np.int32)

    def ndglu(self) -> np.ndarray:
        """ndglu[m]: number of NH latitudes where wavenumber m is active."""
        nmen_nh = self.nmen()[: self.ndgnh]
        m = np.arange(self.nsmax + 1)
        return (nmen_nh[None, :] >= m[:, None]).sum(axis=1).astype(np.int32)

    def latitudes_deg(self) -> np.ndarray:
        """Gaussian latitudes in degrees, north -> south."""
        mu, _ = self.gauss()
        return np.degrees(np.arcsin(mu))


def full_gaussian_grid(nsmax: int, gauss_number: int) -> GridSpec:
    """F<N> regular Gaussian grid."""
    ndgl = 2 * gauss_number
    nloen = (4 * gauss_number,) * ndgl
    return GridSpec(f"F{gauss_number}", nsmax, ndgl, nloen, reduced=False)


def octahedral_grid(nsmax: int, gauss_number: int) -> GridSpec:
    """O<N> octahedral reduced Gaussian grid (20+4i points per lat)."""
    n = gauss_number
    half = [20 + 4 * i for i in range(n)]
    nloen = tuple(half + half[::-1])
    return GridSpec(f"O{n}", nsmax, 2 * n, nloen, reduced=True)


def make_grid(spec: str, nsmax: int | None = None) -> GridSpec:
    """Parse a grid string: ``make_grid("O48", 47)``, ``make_grid("F24", 47)``,
    ``make_grid("TCO1279")`` (cubic octahedral: O1280), ``make_grid("TL159")``
    / ``make_grid("T159")`` (linear full grid), ``make_grid("TQ159")``."""
    s = spec.strip().upper()
    m = re.fullmatch(r"([A-Z]+)(\d+)", s)
    if not m:
        raise ValueError(f"Unparsable grid spec: {spec!r}")
    kind, num = m.group(1), int(m.group(2))
    if kind == "F":
        if nsmax is None:
            nsmax = 2 * num - 1  # linear default
        return full_gaussian_grid(nsmax, num)
    if kind == "O":
        if nsmax is None:
            nsmax = num - 1  # cubic default (TCO convention)
        return octahedral_grid(nsmax, num)
    if kind == "TCO":
        return octahedral_grid(num, num + 1)
    if kind in ("TL", "T"):
        ndgl = num + 1
        if ndgl % 2:
            ndgl += 1
        return full_gaussian_grid(num, ndgl // 2)
    if kind == "TQ":
        ndgl = (3 * num + 3 + 1) // 2
        if ndgl % 2:
            ndgl += 1
        return full_gaussian_grid(num, ndgl // 2)
    raise ValueError(f"Unsupported grid kind {kind!r} in {spec!r}")
