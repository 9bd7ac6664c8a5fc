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

This package imports neither ``jax`` nor ``ectrans_tpu``.
"""

from .grids import GridSpec, make_grid
from .resolution import Resolution, setup
from .transform import InvFlags, dir_trans, inv_trans, num_inv_output_fields

__all__ = [
    "GridSpec",
    "InvFlags",
    "Resolution",
    "dir_trans",
    "inv_trans",
    "make_grid",
    "num_inv_output_fields",
    "setup",
]
