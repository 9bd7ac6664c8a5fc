"""High-level LAM handle: the ESETUP_TRANS / E*-routine face of the
package (counterpart of ``ectrans_tpu/lam/api.py``; reference
``src/etrans/cpu/external``).

A handle runs on one device, a CUDA card unless it is given
``device="cpu"``, and moves its array arguments there; without a card a
CUDA handle refuses to start (no fallback to the CPU).  With ``mesh=``
(``parallel.make_mesh``) it is one rank's view of the distributed LAM
transforms (``lam.sharded.ShardedLamTransform``) on the mesh's device:
this rank's v-block of spectral fields in, its block of grid rows out, and
the reverse; the adjoints and norms stay single-device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import _handle_device
from ..resolution import check_dtype
from . import adjoint, biper, norms, transform
from .geometry import LamGrid, make_lam_grid
from .resolution import LamResolution, setup_lam
from .transform import LamInvFlags


class LamTransform:
    """One LAM resolution handle (ESETUP_TRANS equivalent).

    ``LamTransform(nx, ny, nxux=..., nyux=..., msmax=..., nsmax=...,
    dx=..., dy=...)`` or ``LamTransform(grid=LamGrid(...))``.
    """

    def __init__(self, nx: int | None = None, ny: int | None = None, *,
                 grid: LamGrid | None = None, mesh=None,
                 dtype=torch.float32, device="cuda", **kw):
        if grid is None:
            grid = make_lam_grid(nx, ny, **kw)
        self.grid = grid
        self.res: LamResolution = setup_lam(grid)
        self.dtype = check_dtype(dtype)
        self.mesh = mesh
        self._sharded = None
        if mesh is not None:
            from ..parallel.mesh import check_mesh
            from .sharded import ShardedLamTransform

            self.device = _handle_device(check_mesh(mesh).device)
            self._sharded = ShardedLamTransform(self.res, mesh, self.dtype)
        else:
            self.device = _handle_device(device)

    def _put(self, x):
        """x (a tensor, an array or None) on the handle's device."""
        if x is None:
            return None
        return torch.as_tensor(x, device=self.device)

    # -- transforms -------------------------------------------------------
    def inv_trans(self, spvor=None, spdiv=None, spscalar=None,
                  meanu=None, meanv=None, flags: LamInvFlags = LamInvFlags(),
                  **kw):
        flags = LamInvFlags(**kw) if kw else flags
        if self._sharded is not None:
            return self._sharded.inv_trans(spvor, spdiv, spscalar, meanu,
                                           meanv, flags=flags)
        return transform.inv_trans_lam(
            self.res, self._put(spvor), self._put(spdiv),
            self._put(spscalar), self._put(meanu), self._put(meanv),
            flags=flags, dtype=self.dtype)

    def dir_trans(self, u=None, v=None, scalars=None):
        if self._sharded is not None:
            return self._sharded.dir_trans(u, v, scalars)
        return transform.dir_trans_lam(self.res, self._put(u), self._put(v),
                                       self._put(scalars), dtype=self.dtype)

    def inv_trans_adj(self, grid_ad, nfld_uv=0, nfld_sc=0,
                      flags: LamInvFlags = LamInvFlags()):
        return adjoint.inv_trans_lam_adj(self.res, self._put(grid_ad),
                                         nfld_uv, nfld_sc, flags=flags,
                                         dtype=self.dtype)

    def dir_trans_adj(self, spvor_ad=None, spdiv_ad=None, spscalar_ad=None,
                      meanu_ad=None, meanv_ad=None, *, nfld_uv=0, nfld_sc=0):
        return adjoint.dir_trans_lam_adj(
            self.res, self._put(spvor_ad), self._put(spdiv_ad),
            self._put(spscalar_ad), self._put(meanu_ad), self._put(meanv_ad),
            nfld_uv=nfld_uv, nfld_sc=nfld_sc, dtype=self.dtype)

    # -- utilities --------------------------------------------------------
    def biperiodicize(self, field, mode: str = "spline", **kw):
        """Extend C+I data onto the E zone (FPBIPERE equivalent)."""
        return biper.biperiodicize(self._put(field), self.grid, mode=mode,
                                   **kw)

    def specnorm(self, spec, met=None):
        return norms.especnorm(self.res, self._put(spec), met)

    def gpnorm(self, grid, ave_only: bool = False, full_domain: bool = True):
        """Grid-point norms; full_domain=True covers the whole extended
        domain (the reference EGPNORM_TRANS convention), False restricts
        to the C+I zone."""
        return norms.egpnorm(self.res, self._put(grid), ave_only,
                             full_domain)

    def dist_grid(self, grid_global):
        """Place a global (nfld, ny, nx) grid on the handle's device
        (EDIST_GRID equivalent; without a mesh the global array is the
        owner view, on a mesh this rank's block of rows)."""
        if self._sharded is not None:
            return self._sharded.dist_grid(grid_global)
        return self._put(grid_global)

    def gath_grid(self, grid):
        """A host numpy copy of a grid (EGATH_GRID; on a mesh the global
        grid, gathered from every rank's block: a collective)."""
        if self._sharded is not None:
            return self._sharded.gath_grid(grid)
        return torch.as_tensor(grid).detach().cpu().numpy()

    def dist_spec(self, spec_global):
        """This rank's v-block of a global (nfld, nspec2) array or (nfld,)
        mean wind; without a mesh the array on the handle's device."""
        if self._sharded is not None:
            return self._sharded.dist_spec(spec_global)
        return self._put(spec_global)

    def gath_spec(self, spec):
        """The global fields as a host numpy array (on a mesh gathered
        from every v-rank's block: a collective)."""
        if self._sharded is not None:
            return self._sharded.gath_spec(spec)
        return torch.as_tensor(spec).detach().cpu().numpy()

    def inquire(self) -> dict:
        """ETRANS_INQ equivalent."""
        g = self.grid
        return {
            "nx": g.nx, "ny": g.ny, "nxux": g.nxux, "nyux": g.nyux,
            "msmax": g.msmax, "nsmax": g.nsmax,
            "exwn": g.exwn, "eywn": g.eywn,
            "ngptot": g.ngptot, "nspec2": g.nspec2,
            "kntmp": np.asarray(self.res.kntmp),
            "nesm0": np.asarray(self.res.nesm0),
        }
