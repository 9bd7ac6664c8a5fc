"""Spectral and grid-point norms (SPECNORM / GPNORM_TRANS equivalents).

Counterpart of ``ectrans_tpu/norms.py``, on the device of the given tensor:

* ``specnorm``: per-field spectral norm with optional per-n metric weights —
  norm_f = sqrt( sum_m (2 - delta_m0) sum_n met(n) (re^2 + im^2) )
  (reference ``spnormd_mod.F90:36-54``; m=0 counts only the real part).
* ``gpnorm``: per-field (average, min, max) over the grid, the average
  area-weighted with the Gaussian weights
  (reference ``gpnorm_trans_ctl_mod.F90:193-218``: ave = sum_lat w(lat)
  * mean_lon f).
* ``gpnorm_tl`` / ``gpnorm_ad``: the tangent-linear and the adjoint of the
  average (GPNORM_TRANSTL / GPNORM_TRANSAD), the adjoint from autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from .resolution import Resolution


def _packed_weights(res: Resolution, device: torch.device) -> torch.Tensor:
    """(nspec2,) fp64 weights of the packed values: 1 for the m = 0 real
    parts, 0 for the m = 0 imaginary parts, 2 above."""
    def build():
        w = np.where(res.packed_gather_m == 0,
                     np.where(res.packed_gather_c == 0, 1.0, 0.0), 2.0)
        return torch.as_tensor(w, device=device)

    return res.cached(("specnorm_weights", str(device)), build)


def specnorm(res: Resolution, spec: torch.Tensor, met=None) -> torch.Tensor:
    """Spectral norms per field.  spec: (nfld, nspec2); met: (nsmax+1,) or
    None."""
    w = _packed_weights(res, spec.device)
    if met is not None:
        pn = torch.as_tensor(res.packed_gather_n, device=spec.device)
        w = w * torch.as_tensor(met, dtype=torch.float64,
                                device=spec.device)[pn]
    return torch.sqrt(torch.sum(spec * spec * w.to(spec.dtype), dim=1))


def _grid_weights(res: Resolution, device: torch.device):
    """(mask (ndgl, ndlon) of the points below NLOEN, fp64 w(lat)/nloen)."""
    def build():
        nloen = np.asarray(res.grid.nloen)
        mask = np.arange(res.grid.ndlon)[None, :] < nloen[:, None]
        return (torch.as_tensor(mask, device=device),
                torch.as_tensor(res.w / nloen, device=device))

    return res.cached(("gpnorm_weights", str(device)), build)


def gpnorm(res: Resolution, grid: torch.Tensor, ave_only: bool = False):
    """Grid-point norms per field: (ave, min, max).

    grid: (nfld, ndgl, ndlon) — ragged longitude rows beyond nloen(lat) are
    ignored via masking.
    """
    mask, latw = _grid_weights(res, grid.device)
    ave = torch.einsum("fij,ij,i->f", grid, mask.to(grid.dtype),
                       latw.to(grid.dtype))
    if ave_only:
        return ave, None, None
    big = torch.finfo(grid.dtype).max
    gmin = torch.where(mask, grid, big).amin(dim=(1, 2))
    gmax = torch.where(mask, grid, -big).amax(dim=(1, 2))
    return ave, gmin, gmax


def gpnorm_tl(res: Resolution, grid_pert: torch.Tensor) -> torch.Tensor:
    """Tangent-linear of the gpnorm average (GPNORM_TRANSTL): the average is
    linear, so the TL of ave is the average of the perturbation."""
    ave, _, _ = gpnorm(res, grid_pert, ave_only=True)
    return ave


def gpnorm_ad(res: Resolution, ave_ad: torch.Tensor) -> torch.Tensor:
    """Adjoint of the gpnorm average (GPNORM_TRANSAD): distribute the
    cotangent of each field average back over the grid with the area
    weights (the vector-Jacobian product of the average)."""
    g = torch.zeros((ave_ad.shape[0], res.ndgl, res.grid.ndlon),
                    dtype=ave_ad.dtype, device=ave_ad.device,
                    requires_grad=True)
    with torch.enable_grad():
        ave = gpnorm_tl(res, g)
    (out,) = torch.autograd.grad(ave, g, ave_ad)
    return out
