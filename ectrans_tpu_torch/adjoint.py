"""Adjoint transforms (INV_TRANSAD / DIR_TRANSAD equivalents).

Counterpart of ``ectrans_tpu/adjoint.py``.  The reference maintains ~3.5k
lines of hand-written transpose code (``ltinvad_mod.F90``,
``ledirad_mod.F90``, ...) for 4D-Var.  Here the transforms are linear
PyTorch functions of their field arguments, so the exact adjoints are their
vector-Jacobian products (``torch.autograd.grad`` at zero fields), which
satisfy the inner-product identity <F x, y> = <x, F^T y> to rounding error
(the property the reference tests to 2000*eps in
``tests/trans/test_adjoint.F90``).

Both run the forward on the "xla" engine, as the JAX package does: the
kernels are ctypes launches with no autograd rule, so a graph through them
would be cut.  That engine sums fp32 contractions in fp64
(``legendre_matmul.group_einsum``), and so do their transposes.  The Fourier
layer's transposes are its other direction, scaled (``ops.fourier``).
"""

from __future__ import annotations

import torch

from .resolution import Resolution, check_dtype
from .transform import InvFlags, dir_trans, inv_trans, num_inv_output_fields


def _zeros(shape, like: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return torch.zeros(shape, dtype=dtype, device=like.device,
                       requires_grad=True)


def inv_trans_adj(res: Resolution, grid_ad: torch.Tensor, nfld_uv: int = 0,
                  nfld_sc: int = 0, *, flags: InvFlags = InvFlags(),
                  dtype=torch.float32):
    """Adjoint of inv_trans: grid-space cotangent -> spectral cotangents.

    grid_ad: (nfld_out, ndgl, ndlon) with the PGP field ordering of
    ``inv_trans``.  Returns (spvor_ad, spdiv_ad, spscalar_ad) — entries are
    None for absent field groups — on grid_ad's device.
    """
    dtype = check_dtype(dtype)
    nout = num_inv_output_fields(nfld_uv, nfld_sc, flags)
    want = (nout, res.ndgl, res.grid.ndlon)
    if tuple(grid_ad.shape) != want:
        raise ValueError(f"grid_ad must have shape {want} for {nfld_uv} "
                         f"vor/div pairs and {nfld_sc} scalars under "
                         f"{flags}, got {tuple(grid_ad.shape)}")
    specs = [_zeros((n, res.nspec2), grid_ad, dtype)
             for n in (nfld_uv, nfld_uv, nfld_sc)]
    args = [s if s.shape[0] else None for s in specs]
    with torch.enable_grad():
        out = inv_trans(res, *args, flags=flags, dtype=dtype, _engine="xla")
    live = [s for s in args if s is not None]
    grads = iter(torch.autograd.grad(out, live, grid_ad.to(dtype)))
    return tuple(None if s is None else next(grads) for s in args)


def dir_trans_adj(res: Resolution, spvor_ad=None, spdiv_ad=None,
                  spscalar_ad=None, *, nfld_uv: int = 0, nfld_sc: int = 0,
                  dtype=torch.float32):
    """Adjoint of dir_trans: spectral cotangents -> grid-space cotangents.

    Returns (u_ad, v_ad, scalars_ad) with grid shapes (nfld, ndgl, ndlon),
    None for absent field groups, on the cotangents' device.
    """
    dtype = check_dtype(dtype)
    cots = (spvor_ad, spdiv_ad, spscalar_ad)
    counts = (nfld_uv, nfld_uv, nfld_sc)
    if not any(counts):
        raise ValueError("nothing to transform: pass spvor_ad/spdiv_ad "
                         "and/or spscalar_ad")
    for name, c, n in zip(("spvor_ad", "spdiv_ad", "spscalar_ad"), cots,
                          counts):
        if (c is None) != (n == 0) or (c is not None and tuple(c.shape)
                                       != (n, res.nspec2)):
            raise ValueError(f"{name} must be None for no fields or of "
                             f"shape ({n}, {res.nspec2}), got "
                             f"{None if c is None else tuple(c.shape)}")
    like = next(c for c in cots if c is not None)
    grids = [_zeros((n, res.ndgl, res.grid.ndlon), like, dtype)
             if n else None for n in counts]
    with torch.enable_grad():
        outs = dir_trans(res, *grids, dtype=dtype, _engine="xla")
    live = [(o, c.to(dtype)) for o, c in zip(outs, cots) if c is not None]
    inputs = [g for g in grids if g is not None]
    grads = iter(torch.autograd.grad([o for o, _ in live], inputs,
                                     [c for _, c in live]))
    return tuple(None if g is None else next(grads) for g in grids)
