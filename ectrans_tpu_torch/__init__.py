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
    ll = st.inv_trans_latlon(ett.LatLonGrid(721, 1440), spscalar=sc)

and so does the limited-area handle (``ectrans_tpu_torch.lam``):

    lam = ett.LamTransform(1536, 1280, nxux=1440, nyux=1200)
    grid = lam.inv_trans(spscalar=lam_sc)

Both take ``mesh=`` (``ectrans_tpu_torch.parallel.make_mesh``, over the
caller's ``torch.distributed`` process group) for the distributed
transforms, each rank holding its shards.

``ectrans_tpu_torch.entry`` holds the counterparts of the JAX package's
entry points (``entry``, ``dryrun_multichip``).  This package
imports neither ``jax`` nor ``ectrans_tpu``.
"""

from .adjoint import dir_trans_adj, inv_trans_adj
from .api import SpectralTransform, vordiv_to_uv
from .grids import GridSpec, full_gaussian_grid, make_grid, octahedral_grid
from .lam import LamTransform
from .latlon import LatLonGrid, dir_trans_latlon, inv_trans_latlon
from .norms import gpnorm, gpnorm_ad, gpnorm_tl, specnorm
from .resolution import Resolution, get_current, setup, trans_end
from .transform import InvFlags, dir_trans, inv_trans, num_inv_output_fields

__version__ = "0.1.0"

__all__ = [
    "GridSpec",
    "InvFlags",
    "LamTransform",
    "LatLonGrid",
    "Resolution",
    "SpectralTransform",
    "dir_trans",
    "dir_trans_adj",
    "dir_trans_latlon",
    "full_gaussian_grid",
    "get_current",
    "gpnorm",
    "gpnorm_ad",
    "gpnorm_tl",
    "inv_trans",
    "inv_trans_adj",
    "inv_trans_latlon",
    "make_grid",
    "num_inv_output_fields",
    "octahedral_grid",
    "setup",
    "specnorm",
    "trans_end",
    "vordiv_to_uv",
]
