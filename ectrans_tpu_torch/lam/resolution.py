"""Per-resolution LAM state: packed <-> dense spectral maps and coefficient
tables (counterpart of ``ectrans_tpu/lam/resolution.py``; reference
TPMALD_* modules ``tpmald_dim.F90``/``tpmald_distr.F90``/``tpmald_geo.F90``).

Spectral layouts
----------------
* **packed** (user-facing, etrans-compatible): real array ``(nfld, nspec2)``
  m-major, n ascending within m up to the elliptic limit kntmp(m), 4 reals
  per (m, n): (mer-re of zon-re, mer-im of zon-re, mer-re of zon-im,
  mer-im of zon-im) — the NESM0 addressing of ``eprfi1b_mod.F90:85-118``.
* **dense** (internal): ``(nfld, 4, M, N)`` with M = msmax+1, N = nsmax+1,
  zero outside the ellipse.  Component order matches packed.

Host maps are numpy; ``device_tables(dtype, device)`` makes the torch
tensors for one (dtype, device) pair and caches them on the resolution.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import numpy as np
import torch

from ..resolution import canonical_device, check_dtype
from .geometry import LamGrid


@dataclasses.dataclass(frozen=True, eq=False)
class LamResolution:
    grid: LamGrid

    kntmp: np.ndarray        # (M,) elliptic meridional limit per m
    nesm0: np.ndarray        # (M,) packed offset of (m, n=0)
    valid: np.ndarray        # (M, N) 1.0 inside ellipse
    # packed -> dense gather: index into packed (+1 zero slot)
    dense_gather: np.ndarray     # (4, M, N)
    # dense -> packed gather
    packed_c: np.ndarray     # (nspec2,) component 0..3
    packed_m: np.ndarray     # (nspec2,)
    packed_n: np.ndarray     # (nspec2,)
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    @property
    def M(self) -> int:
        return self.grid.msmax + 1

    @property
    def N(self) -> int:
        return self.grid.nsmax + 1

    @property
    def nspec2(self) -> int:
        return self.grid.nspec2

    def cached(self, key, build: Callable[[], Any]):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def drop_cached(self) -> None:
        """Free the device tables of every (dtype, device)."""
        self._cache.clear()

    def device_tables(self, dtype=torch.float32, device="cpu") -> dict:
        """valid, the index maps, the wavenumbers kx = m exwn and
        ky = n eywn, and rlepinm = -1/(kx^2 + ky^2) (0 at m = n = 0),
        as tensors of ``dtype`` (the maps int64) on ``device``."""
        dtype = check_dtype(dtype)
        device = canonical_device(device)

        def build():
            g = self.grid
            f = lambda x: torch.tensor(np.asarray(x, np.float64),
                                       dtype=dtype, device=device)
            i = lambda x: torch.tensor(np.asarray(x, np.int64),
                                       device=device)
            m = np.arange(self.M, dtype=np.float64)[:, None]
            n = np.arange(self.N, dtype=np.float64)[None, :]
            kx = m * g.exwn
            ky = n * g.eywn
            lap = -(kx * kx + ky * ky)
            rlepinm = np.where(lap != 0.0,
                               1.0 / np.where(lap == 0, 1.0, lap), 0.0)
            return dict(
                valid=f(self.valid),
                dense_gather=i(self.dense_gather),
                packed_c=i(self.packed_c),
                packed_m=i(self.packed_m),
                packed_n=i(self.packed_n),
                kx=f(np.broadcast_to(kx, (self.M, self.N))),
                ky=f(np.broadcast_to(ky, (self.M, self.N))),
                rlepinm=f(rlepinm),
            )

        return self.cached(("device_tables", dtype, str(device)), build)


def lam_maps(grid: LamGrid) -> dict:
    """The packed <-> dense maps of ``grid`` (numpy): kntmp, nesm0, valid,
    dense_gather (nspec2 = the zero slot outside the ellipse), packed_c,
    packed_m, packed_n."""
    M = grid.msmax + 1
    N = grid.nsmax + 1
    kntmp = grid.kntmp
    lens = 4 * (kntmp.astype(np.int64) + 1)
    nesm0 = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    nspec2 = int(lens.sum())
    assert nspec2 == grid.nspec2
    pm = np.repeat(np.arange(M, dtype=np.int64), lens)
    off = np.arange(nspec2, dtype=np.int64) - nesm0[pm]
    pc = off % 4
    pn = off // 4
    valid = (np.arange(N)[None, :] <= kntmp[:, None]).astype(np.float64)
    dense_gather = np.full((4, M, N), nspec2, dtype=np.int64)
    dense_gather[pc, pm, pn] = np.arange(nspec2, dtype=np.int64)
    return dict(kntmp=kntmp, nesm0=nesm0, valid=valid,
                dense_gather=dense_gather, packed_c=pc, packed_m=pm,
                packed_n=pn)


@functools.lru_cache(maxsize=16)
def setup_lam(grid: LamGrid) -> LamResolution:
    """Build a LamResolution (the ESETUP_TRANS equivalent,
    ``esetup_trans.F90:117-131``); cached on the grid."""
    return LamResolution(grid=grid, **lam_maps(grid))
