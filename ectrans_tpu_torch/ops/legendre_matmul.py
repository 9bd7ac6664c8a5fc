"""Legendre engine choice, the "xla" engine, and the engine dispatchers.

Counterpart of ``ectrans_tpu/ops/legendre_matmul.py``.  Four engines compute
the same Legendre sums:

* "dense"  — dense-row kernels K1/K2 (``legendre_dense``) on the full-n
  tables; the default on every device;
* "pallas" — parity-split grouped kernels K5/K6 (``legendre_grouped``);
* "planes" — bf16 limb-plane kernels K9/K10 (``legendre_planes``), the only
  engine with the tiers "high" (an alias of "highest") and "bf16";
* "xla"    — the grouped parity contraction as per-group ``torch.einsum``
  (this module): the plain matrix product the JAX package leaves to XLA.
  It is the fp64 engine of "planes" and runs in the working dtype (TF32
  stays off unless the caller turns it on).

``engine()`` reads ``ECTRANS_TPU_LEG_KERNEL`` as the JAX package does; its
"auto" is "dense" on the CPU too (the JAX package picks "xla" there only
because Pallas cannot run on the CPU; here every kernel has a plain
version).  The dispatchers take the engine or tier as an argument and never
read the environment.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import legendre_grouped
from . import legendre_planes as lp

ENGINES = ("dense", "xla", "pallas", "planes")
# precision tiers each engine serves (the JAX package's tier -> mode and
# tier -> plane-count maps; this port's "dense", "xla" and "pallas"
# engines sum in the working dtype, which is the "highest" tier)
TIERS = {"dense": ("highest",), "xla": ("highest",), "pallas": ("highest",),
         "planes": ("highest", "high", "bf16")}


def engine() -> str:
    """The Legendre engine ``ECTRANS_TPU_LEG_KERNEL`` selects ("xla",
    "pallas", "dense" or "planes"); anything else means "dense"."""
    kern = os.environ.get("ECTRANS_TPU_LEG_KERNEL", "auto")
    return kern if kern in ENGINES else "dense"


def legendre_inv_grouped(sym: torch.Tensor, asym: torch.Tensor,
                         gl) -> torch.Tensor:
    """Grouped inverse LT as einsums: sym/asym (nfld, 2, M, kmax) ->
    (nfld, 2, M, ndgl) Fourier coefficients, latitudes north -> south."""
    parts = []
    for g in gl.groups:
        s = sym[:, :, g.m0:g.m1, :g.kg]
        a = asym[:, :, g.m0:g.m1, :g.kg]
        fs = torch.einsum("mik,fcmk->fcmi", g.psym, s)
        fa = torch.einsum("mik,fcmk->fcmi", g.pasym, a)
        parts.append(torch.cat([F.pad(fs + fa, (g.i0, 0)),
                                F.pad((fs - fa).flip(-1), (0, g.i0))], dim=-1))
    return torch.cat(parts, dim=2)


def legendre_dir_grouped(fourier: torch.Tensor, gl, w: torch.Tensor):
    """Grouped direct LT as einsums: (nfld, 2, M, ndgl) Fourier
    coefficients + NH weights w -> (sym, asym), each (nfld, 2, M, kmax)."""
    fsym_all, fasym_all = legendre_grouped.parity_fourier(fourier, gl.ndgnh,
                                                          w)
    syms, asyms = [], []
    for g in gl.groups:
        pad = (0, gl.kmax - g.kg)
        syms.append(F.pad(torch.einsum(
            "mik,fcmi->fcmk", g.psym, fsym_all[:, :, g.m0:g.m1, g.i0:]), pad))
        asyms.append(F.pad(torch.einsum(
            "mik,fcmi->fcmk", g.pasym, fasym_all[:, :, g.m0:g.m1, g.i0:]), pad))
    return torch.cat(syms, dim=2), torch.cat(asyms, dim=2)


def inv_grouped(sym, asym, gl, eng: str) -> torch.Tensor:
    """Grouped inverse LT through engine ``eng`` ("xla" or "pallas")."""
    if eng == "pallas":
        return legendre_grouped.legendre_inv_grouped(sym, asym, gl)
    if eng == "xla":
        return legendre_inv_grouped(sym, asym, gl)
    raise ValueError(f"engine {eng!r} has no grouped inverse")


def dir_grouped(fourier, gl, w, eng: str):
    """Grouped direct LT through engine ``eng`` ("xla" or "pallas")."""
    if eng == "pallas":
        return legendre_grouped.legendre_dir_grouped(fourier, gl, w)
    if eng == "xla":
        return legendre_dir_grouped(fourier, gl, w)
    raise ValueError(f"engine {eng!r} has no grouped direct transform")


def inv_planes(dense, ppl, precision: str = "highest") -> torch.Tensor:
    """"planes" engine inverse LT at a tier: (nfld, 2, M, NP) ->
    (nfld, 2, M, ndgl)."""
    return lp.legendre_inv_planes(dense, ppl, lp.planes_for_tier(precision))


def dir_rows_planes(fourier, ppl, w, precision: str = "highest") -> list:
    """"planes" engine direct LT in the m-major layout (per-group
    (gm, 2*nfld, J) realigned rows)."""
    return lp.legendre_dir_rows_planes(fourier, ppl, w,
                                       lp.planes_for_tier(precision))


def dir_planes(fourier, ppl, w, NP: int, precision: str = "highest"):
    """"planes" engine direct LT to the dense layout (nfld, 2, M, NP)."""
    return lp.legendre_dir_planes(fourier, ppl, w, NP,
                                  lp.planes_for_tier(precision))
