"""ectrans_tpu_torch: the spectral transforms of ``ectrans_tpu`` on PyTorch.

A port of the JAX package to PyTorch with hand-written CUDA kernels for
Hopper (sm_90a): global inverse and direct spherical-harmonic transforms on
full and reduced Gaussian grids, with vorticity/divergence to wind and the
horizontal derivatives.  A transform runs on the device of its input
tensors: CUDA tensors go through the kernels in ``csrc/``, CPU tensors
through their plain PyTorch versions.

    import torch, ectrans_tpu_torch as ett
    res = ett.setup("O48", 47)
    grid = ett.inv_trans(res, spscalar=torch.randn(4, res.nspec2))

The handle runs on a CUDA card unless it is given ``device="cpu"``:

    st = ett.SpectralTransform("TCO1279")
    grid = st.inv_trans(spscalar=sc)
    _, _, sc_ad = st.inv_trans_adj(grid, 0, sc.shape[0])

This package imports neither ``jax`` nor ``ectrans_tpu``.
"""

from .adjoint import dir_trans_adj, inv_trans_adj
from .api import SpectralTransform, vordiv_to_uv
from .grids import GridSpec, make_grid
from .norms import gpnorm, gpnorm_ad, gpnorm_tl, specnorm
from .resolution import Resolution, get_current, setup, trans_end
from .transform import InvFlags, dir_trans, inv_trans, num_inv_output_fields

__version__ = "0.1.0"

__all__ = [
    "GridSpec",
    "InvFlags",
    "Resolution",
    "SpectralTransform",
    "dir_trans",
    "dir_trans_adj",
    "get_current",
    "gpnorm",
    "gpnorm_ad",
    "gpnorm_tl",
    "inv_trans",
    "inv_trans_adj",
    "make_grid",
    "num_inv_output_fields",
    "setup",
    "specnorm",
    "trans_end",
    "vordiv_to_uv",
]
