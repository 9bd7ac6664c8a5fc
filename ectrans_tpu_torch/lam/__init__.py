"""Limited-area model (LAM) bi-Fourier transforms — the etrans variant.

Counterpart of ``ectrans_tpu/lam`` on one device (reference ``src/etrans``,
SURVEY.md §2.8): on a biperiodic plane both transform directions are
Fourier transforms, so the spherical-harmonic Legendre stage is replaced by
a meridional DFT (reference ELEINV/ELEDIR, ``eledir_mod.F90:72-101``) and
the elliptic-truncation spectral space of ELLIPS (``ellips.F90``).  The
distributed LAM transforms over a (w, v) mesh are ``lam.sharded``
(``LamTransform(..., mesh=)``).
"""

from .adjoint import dir_trans_lam_adj, inv_trans_lam_adj
from .api import LamTransform
from .biper import biperiodicize
from .geometry import LamGrid, ellips, make_lam_grid
from .norms import egpnorm, especnorm
from .resolution import LamResolution, setup_lam
from .sharded import ShardedLamTransform
from .transform import LamInvFlags, dir_trans_lam, inv_trans_lam

__all__ = [
    "LamGrid",
    "LamInvFlags",
    "LamTransform",
    "LamResolution",
    "ShardedLamTransform",
    "biperiodicize",
    "dir_trans_lam",
    "dir_trans_lam_adj",
    "egpnorm",
    "ellips",
    "especnorm",
    "inv_trans_lam",
    "inv_trans_lam_adj",
    "make_lam_grid",
    "setup_lam",
]
