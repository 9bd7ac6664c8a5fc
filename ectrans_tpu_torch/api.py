"""High-level API: SpectralTransform handle + inquiry + utility transforms.

Counterpart of ``ectrans_tpu/api.py``, the object-oriented face of the
package, covering the reference's public API surface (SURVEY.md §2.1):

  SETUP_TRANS0/SETUP_TRANS  -> SpectralTransform(grid, nsmax, device=...)
  INV_TRANS / DIR_TRANS     -> .inv_trans() / .dir_trans()
  INV_TRANSAD / DIR_TRANSAD -> .inv_trans_adj() / .dir_trans_adj()
  TRANS_INQ                 -> .inquire()
  SPECNORM / GPNORM_TRANS   -> .specnorm() / .gpnorm()
  VORDIV_TO_UV              -> .vordiv_to_uv()  (also module-level)
  TRANS_PNM                 -> .legendre_polynomials(m)
  DIST_GRID/GATH_GRID/...   -> .dist_grid()/.gath_grid()/.dist_spec()/.gath_spec()
  TRANS_RELEASE             -> .release() (drops the cached tables)

A handle runs on one device, a CUDA card unless it is given
``device="cpu"``; it moves its array arguments there.  Without a card a
CUDA handle refuses to start: it never falls back to the CPU.  Not ported
yet: the distributed transforms (``mesh=``, ROADMAP.md queue A item 8) and
the lat-lon output (``*_latlon``, item 6).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from . import adjoint, norms, transform
from .ops import layout, spectral
from .resolution import (EARTH_RADIUS, Resolution, canonical_device,
                         check_dtype, setup)
from .transform import InvFlags

_FLAG_NAMES = frozenset(InvFlags.__dataclass_fields__)


def _handle_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "SpectralTransform: no CUDA device is available for device="
            f"{str(device)!r}; pass device='cpu' to run on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return canonical_device(device)


class SpectralTransform:
    """One resolution handle on one device."""

    def __init__(
        self,
        grid: str | Any,
        nsmax: int | None = None,
        *,
        mesh=None,
        radius: float = EARTH_RADIUS,
        stretch: float = 1.0,
        dtype=torch.float32,
        precision: str = "highest",
        device="cuda",
    ):
        """precision: Legendre-contraction tier — "highest" and "high" (fp32
        arithmetic, inside the reference's 100*eps benchmark gate) or
        "bf16" (bf16 tables; the reference FLT gate precedent 1e6*eps).
        device: where the tables live and the transforms run ("cuda", the
        default, or "cpu")."""
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: the distributed transforms are not ported yet "
                "(ROADMAP.md, queue A item 8)")
        transform._check_precision(precision)
        self.device = _handle_device(device)
        self.res: Resolution = setup(grid, nsmax, radius, stretch)
        self.dtype = check_dtype(dtype)
        self.precision = precision
        self.mesh = None

    def _put(self, x):
        """x (a tensor, an array or None) on the handle's device."""
        if x is None:
            return None
        return torch.as_tensor(x, device=self.device)

    # -- transforms -----------------------------------------------------
    def inv_trans(self, spvor=None, spdiv=None, spscalar=None,
                  flags: InvFlags = InvFlags(), npromatr=None,
                  kvsetuv=None, kvsetsc=None, fspgl_proc=None, **kw):
        flags = InvFlags(**kw) if kw else flags
        if kvsetuv is not None or kvsetsc is not None:
            raise ValueError("kvsetuv/kvsetsc require a mesh-attached "
                             "SpectralTransform (distributed field ownership)")
        return transform.inv_trans(
            self.res, self._put(spvor), self._put(spdiv),
            self._put(spscalar), flags=flags, dtype=self.dtype,
            npromatr=npromatr, fspgl_proc=fspgl_proc,
            precision=self.precision)

    def dir_trans(self, u=None, v=None, scalars=None, npromatr=None,
                  kvsetuv=None, kvsetsc=None):
        if kvsetuv is not None or kvsetsc is not None:
            raise ValueError("kvsetuv/kvsetsc require a mesh-attached "
                             "SpectralTransform (distributed field ownership)")
        return transform.dir_trans(
            self.res, self._put(u), self._put(v), self._put(scalars),
            dtype=self.dtype, npromatr=npromatr, precision=self.precision)

    # -- callmode-2 (split-array) adapters --------------------------------
    # The reference supports two calling conventions (dir_trans.F90:69-92,
    # ectrans-benchmark.F90:1175-1179): callmode 1 = combined PGP/PSPSCALAR
    # arrays (the native surface here), callmode 2 = split families
    # PGPUV/PGP3A/PGP3B/PGP2 <-> PSPSC3A/PSPSC3B/PSPSC2.  The composite
    # scalar ordering is pinned by ltinv_mod.F90:173-196: SC2 fields first,
    # then SC3A variable-major (levels contiguous per variable), then SC3B.

    def inv_trans_split(self, spvor=None, spdiv=None, spsc3a=None,
                        spsc3b=None, spsc2=None,
                        flags: InvFlags = InvFlags(), **kw):
        """Split-array inverse transform (callmode 2).

        spvor/spdiv: (nlev_uv, nspec2); spsc3a/spsc3b: (nfld, nlev, nspec2);
        spsc2: (nfld2, nspec2).  Returns a dict with grid families
        ``u, v`` (nlev_uv, ndgl, ndlon), ``sc2`` (nfld2, ndgl, ndlon),
        ``sc3a/sc3b`` (nfld, nlev, ndgl, ndlon) and, per flags, ``vor, div,
        nsd2/nsd3a/nsd3b, ewu, ewv, ewsc2/ewsc3a/ewsc3b``.
        """
        fkw = {k: kw.pop(k) for k in list(kw) if k in _FLAG_NAMES}
        flags = InvFlags(**fkw) if fkw else flags
        parts, splits = [], []
        for name, arr in (("sc2", spsc2), ("sc3a", spsc3a), ("sc3b", spsc3b)):
            if arr is None:
                continue
            arr = self._put(arr)
            flat = arr.reshape(-1, self.res.nspec2)
            parts.append(flat)
            splits.append((name, tuple(arr.shape), flat.shape[0]))
        spscalar = torch.cat(parts) if parts else None
        grid = self.inv_trans(spvor, spdiv, spscalar, flags=flags, **kw)
        nuv = 0 if spvor is None else spvor.shape[0]
        nsc = 0 if spscalar is None else spscalar.shape[0]
        out = {}
        off = 0

        def take(n):
            nonlocal off
            blk = grid[off : off + n]
            off += n
            return blk

        def split_sc(blk, suffix=""):
            o = 0
            for name, shape, n in splits:
                fam = blk[o : o + n]
                o += n
                out[suffix + name] = (
                    fam if len(shape) == 2
                    else fam.reshape(shape[:2] + tuple(fam.shape[1:])))

        if nuv:
            if flags.vorgp:
                out["vor"] = take(nuv)
            if flags.divgp:
                out["div"] = take(nuv)
            out["u"] = take(nuv)
            out["v"] = take(nuv)
        if nsc:
            split_sc(take(nsc))
            if flags.scders:
                split_sc(take(nsc), "nsd")
        if nuv and flags.uvders:
            out["ewu"] = take(nuv)
            out["ewv"] = take(nuv)
        if nsc and flags.scders:
            split_sc(take(nsc), "ew")
        return out

    def dir_trans_split(self, u=None, v=None, gp3a=None, gp3b=None,
                        gp2=None, **kw):
        """Split-array direct transform (callmode 2).

        u/v: (nlev_uv, ndgl, ndlon); gp3a/gp3b: (nfld, nlev, ndgl, ndlon);
        gp2: (nfld2, ndgl, ndlon).  Returns (spvor, spdiv, dict with
        ``sc2`` (nfld2, nspec2) / ``sc3a``/``sc3b`` (nfld, nlev, nspec2)).
        """
        parts, splits = [], []
        for name, arr in (("sc2", gp2), ("sc3a", gp3a), ("sc3b", gp3b)):
            if arr is None:
                continue
            arr = self._put(arr)
            flat = arr.reshape((-1,) + tuple(arr.shape[-2:]))
            parts.append(flat)
            splits.append((name, tuple(arr.shape), flat.shape[0]))
        scalars = torch.cat(parts) if parts else None
        spvor, spdiv, spsc = self.dir_trans(u, v, scalars, **kw)
        out = {}
        o = 0
        for name, shape, n in splits:
            fam = spsc[o : o + n]
            o += n
            out[name] = (fam if len(shape) == 3
                         else fam.reshape(shape[:2] + tuple(fam.shape[1:])))
        return spvor, spdiv, out

    def inv_trans_adj(self, grid_ad, nfld_uv=0, nfld_sc=0,
                      flags: InvFlags = InvFlags()):
        return adjoint.inv_trans_adj(
            self.res, self._put(grid_ad), nfld_uv, nfld_sc, flags=flags,
            dtype=self.dtype)

    def dir_trans_adj(self, spvor_ad=None, spdiv_ad=None, spscalar_ad=None,
                      nfld_uv=0, nfld_sc=0):
        return adjoint.dir_trans_adj(
            self.res, self._put(spvor_ad), self._put(spdiv_ad),
            self._put(spscalar_ad), nfld_uv=nfld_uv, nfld_sc=nfld_sc,
            dtype=self.dtype)

    def inv_trans_latlon(self, ll, spvor=None, spdiv=None, spscalar=None,
                         flags: InvFlags = InvFlags()):
        raise NotImplementedError(
            "inverse transform onto a lat-lon grid: latlon.py is not ported "
            "yet (ROADMAP.md, queue A item 6)")

    def dir_trans_latlon(self, ll, u=None, v=None, scalars=None):
        raise NotImplementedError(
            "direct transform from a lat-lon grid: latlon.py is not ported "
            "yet (ROADMAP.md, queue A item 6)")

    # -- norms / utilities ----------------------------------------------
    def specnorm(self, spec, met=None):
        return norms.specnorm(self.res, self._put(spec), met)

    def gpnorm(self, grid, ave_only=False):
        return norms.gpnorm(self.res, self._put(grid), ave_only)

    def vordiv_to_uv(self, spvor, spdiv):
        return vordiv_to_uv(self.res, self._put(spvor), self._put(spdiv),
                            dtype=self.dtype)

    def legendre_polynomials(self, m: int) -> np.ndarray:
        """P̄_n^m at all Gaussian latitudes for one m (TRANS_PNM,
        ``trans_pnm.F90``): shape (nsmax+2-m, ndgl) -> (n index, lat).
        Builds the host fp64 parity tables of every m (``parity_tables``)."""
        res = self.res
        tables = res.parity_tables()
        tab = np.zeros((res.NP - m, res.ndgl))
        nh = res.grid.ndgnh
        for k, n in enumerate(range(m, res.NP)):
            col = _pnm_value(tables, m, n)
            tab[k, :nh] = col
            tab[k, nh:] = col[::-1] * ((-1) ** ((n + m) % 2))
        return tab

    # -- distribution helpers (DIST_GRID/GATH_GRID/DIST_SPEC/GATH_SPEC) --
    # Without a mesh the global array is the owner view: dist_* place it on
    # the handle's device, gath_* bring it back to a host numpy array.
    def dist_grid(self, grid_global):
        return self._put(grid_global)

    def gath_grid(self, grid):
        return torch.as_tensor(grid).detach().cpu().numpy()

    def dist_spec(self, spec_global):
        return self._put(spec_global)

    def gath_spec(self, spec):
        return torch.as_tensor(spec).detach().cpu().numpy()

    # -- inquiry ----------------------------------------------------------
    def inquire(self) -> dict:
        """TRANS_INQ equivalent: every size/address/geometry array a caller
        needs (reference ``trans_inq.F90:11-529``), without the keys of a
        distributed layout."""
        res = self.res
        g = res.grid
        _, w = g.gauss()
        return {
            "nsmax": res.nsmax,
            "nspec": g.nspec,
            "nspec2": g.nspec2,
            "nspec2g": g.nspec2,
            "ndgl": g.ndgl,
            "ndlon": g.ndlon,
            "ngptot": g.ngptot,
            "ngptotg": g.ngptot,
            "nloen": np.asarray(g.nloen),
            "nmen": res.nmen.copy(),
            "ndglu": res.ndglu.copy(),
            "nasm0": res.nasm0.copy(),
            "rmu": res.mu.copy(),   # stretched latitudes when stretch != 1
            "rgw": w,
            "rlapin": res.rlapin.copy(),
            "latitudes_deg": g.latitudes_deg(),
            "nump": res.M,
            "myms": np.arange(res.M),
        }

    def _inquire_distributed(self) -> dict:
        raise NotImplementedError(
            "the distributed-layout keys of TRANS_INQ need a mesh: the "
            "distributed transforms are not ported yet (ROADMAP.md, queue A "
            "item 8)")

    def release(self):
        """Free the tables, plans and index maps that this handle's
        Resolution caches on every device (TRANS_RELEASE equivalent); they
        are made again on next use.  The Resolution stays in the setup
        cache, so every handle of the same configuration shares it."""
        self.res.drop_cached()


def _pnm_value(tables, m: int, n: int) -> np.ndarray:
    """P̄_n^m at NH latitudes from the parity-split tables (psym, pasym)."""
    psym, pasym = tables
    k = (n - m) // 2
    if (n - m) % 2 == 0:
        return np.asarray(psym[m, :, k])
    return np.asarray(pasym[m, :, k])


def vordiv_to_uv(res: Resolution, spvor: torch.Tensor, spdiv: torch.Tensor,
                 dtype=torch.float32):
    """Standalone spectral vor/div -> spectral U = a*u*cos(theta)-type winds
    (reference VORDIV_TO_UV, ``vordiv_to_uv.F90``): packed in, packed out,
    on spvor's device.

    Note the returned packed arrays truncate the n = nsmax+1 row (packed
    layout holds n <= nsmax), matching the reference's KSMAX-truncated
    output.
    """
    dtype = check_dtype(dtype)
    tables = res.device_tables(dtype, spvor.device)
    dvor = layout.packed_to_dense(spvor.to(dtype), tables)
    ddiv = layout.packed_to_dense(spdiv.to(dtype), tables)
    du, dv = spectral.vordiv_to_uv(dvor, ddiv, tables.vd)
    return layout.dense_to_packed(du, res), layout.dense_to_packed(dv, res)
