"""LAM adjoint transforms (EINV_TRANSAD / EDIR_TRANSAD equivalents).

Counterpart of ``ectrans_tpu/lam/adjoint.py``.  The LAM transforms are
linear PyTorch functions of their field arguments, so the exact adjoints
(the reference's hand-written ``eltinvad_mod.F90``/``eltdirad_mod.F90``
family) are their vector-Jacobian products (``torch.autograd.grad`` at zero
fields), which satisfy <F x, y> = <x, F^T y> to rounding.  The packed ->
dense gather's transpose is a scatter written out
(``ops.layout.gather_packed``): autograd's own transpose of its zero slot
would add the slot's duplicates one after another on a GPU.
"""

from __future__ import annotations

import torch

from ..resolution import check_dtype
from ..transform import num_inv_output_fields
from .resolution import LamResolution
from .transform import LamInvFlags, dir_trans_lam, inv_trans_lam


def _zeros(shape, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device,
                       requires_grad=True)


def inv_trans_lam_adj(res: LamResolution, grid_ad: torch.Tensor,
                      nfld_uv: int = 0, nfld_sc: int = 0, *,
                      flags: LamInvFlags = LamInvFlags(),
                      dtype=torch.float32):
    """Adjoint of inv_trans_lam: grid cotangent (nfld_out, ny, nx) ->
    spectral cotangents (spvor_ad, spdiv_ad, spscalar_ad, meanu_ad,
    meanv_ad), None for absent field groups, on grid_ad's device."""
    dtype = check_dtype(dtype)
    g = res.grid
    want = (num_inv_output_fields(nfld_uv, nfld_sc, flags), g.ny, g.nx)
    if tuple(grid_ad.shape) != want:
        raise ValueError(f"grid_ad must have shape {want}, got "
                         f"{tuple(grid_ad.shape)}")
    spec = [_zeros((n, res.nspec2), grid_ad, dtype) if n else None
            for n in (nfld_uv, nfld_uv, nfld_sc)]
    mean = [_zeros((nfld_uv,), grid_ad, dtype) if nfld_uv else None
            for _ in range(2)]
    args = spec + mean
    with torch.enable_grad():
        out = inv_trans_lam(res, *args, flags=flags, dtype=dtype)
    live = [a for a in args if a is not None]
    grads = iter(torch.autograd.grad(out, live, grid_ad.to(dtype)))
    return tuple(None if a is None else next(grads) for a in args)


def dir_trans_lam_adj(res: LamResolution, spvor_ad=None, spdiv_ad=None,
                      spscalar_ad=None, meanu_ad=None, meanv_ad=None, *,
                      nfld_uv: int = 0, nfld_sc: int = 0,
                      dtype=torch.float32):
    """Adjoint of dir_trans_lam: spectral cotangents -> grid cotangents
    (u_ad, v_ad, scalars_ad), None for absent field groups, on the
    cotangents' device.  meanu_ad/meanv_ad default to 0."""
    dtype = check_dtype(dtype)
    cots = (spvor_ad, spdiv_ad, spscalar_ad)
    counts = (nfld_uv, nfld_uv, nfld_sc)
    if not any(counts):
        raise ValueError("nothing to transform: pass nfld_uv and/or nfld_sc")
    for name, c, n in zip(("spvor_ad", "spdiv_ad", "spscalar_ad"), cots,
                          counts):
        if (c is None) != (n == 0) or (c is not None and tuple(c.shape)
                                       != (n, res.nspec2)):
            raise ValueError(f"{name} must be None for no fields or of "
                             f"shape ({n}, {res.nspec2}), got "
                             f"{None if c is None else tuple(c.shape)}")
    like = next(c for c in cots if c is not None)
    g = res.grid
    grids = [_zeros((n, g.ny, g.nx), like, dtype) if n else None
             for n in counts]
    if nfld_uv:
        meanu_ad, meanv_ad = (
            torch.zeros(nfld_uv, dtype=dtype, device=like.device)
            if x is None else torch.as_tensor(x, device=like.device)
            for x in (meanu_ad, meanv_ad))
    with torch.enable_grad():
        outs = dir_trans_lam(res, *grids, dtype=dtype)
    pairs = [(o, c.to(dtype)) for o, c in
             zip(outs, cots + (meanu_ad, meanv_ad)) if o is not None]
    inputs = [x for x in grids if x is not None]
    grads = iter(torch.autograd.grad([o for o, _ in pairs], inputs,
                                     [c for _, c in pairs]))
    return tuple(None if x is None else next(grads) for x in grids)
