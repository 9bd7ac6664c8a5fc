"""Legendre engine choice, the precision tiers, the "xla" engine, and the
engine dispatchers.

Counterpart of ``ectrans_tpu/ops/legendre_matmul.py``.  Four engines compute
the same Legendre sums:

* "dense"  — dense-row kernels K1/K2 (``legendre_dense``) on the full-n
  tables; the default on every device.  With ``dense_pack()``
  (``ECTRANS_TPU_LEG_DENSE_PACK``) it runs the hemisphere-packed K7/K8;
* "pallas" — parity-split grouped kernels K5/K6 (``legendre_grouped``);
* "planes" — bf16 limb-plane kernels K9/K10 (``legendre_planes``);
* "xla"    — the grouped parity contraction as per-group ``torch.einsum``
  (this module): the plain matrix product the JAX package leaves to XLA.
  It is the fp64 engine of "planes" and runs in the working dtype (TF32
  stays off unless the caller turns it on).  In fp32 it multiplies and adds
  in fp64 and rounds once (``group_einsum``): one running fp32 sum over the
  640-1,280 terms of a TCO1279 group puts the round trip at 4.3x its
  100*eps gate on an H100, the fp64 sums at 0.35.

Every engine serves the three tiers of the JAX package (its
``_PALLAS_MODE``/``_XLA_PREC`` maps):

* "highest" — fp32 (or fp64) FMA with compensated chunk sums in the
  kernels; 3 limb planes on "planes";
* "high"    — the same arithmetic as "highest" on every engine ("planes"
  aliases it to 3 planes).  The TPU served it with three bf16 passes
  (bf16x3); on CUDA cores that costs three FMAs per term where one fp32 FMA
  is cheaper and more accurate, and the tier's contract is an error bound,
  which fp32 meets.  3xTF32 on tensor cores (the reference GPU's CUTLASS
  path) is queued as a redesign in ROADMAP.md;
* "bf16"    — tables stored in bfloat16 (``transform._table_dtype``; half
  the table bytes).  "dense" and "pallas" round the fp32 operand to bf16 and
  sum the exact products (the TPU's single-pass mode); "xla" upcasts each
  group's bf16 tables for its einsums (``group_einsum``), as the JAX "xla"
  engine computes on the CPU; "planes" takes 1 plane.  In fp64 the tables
  stay fp64, so the tier is "highest" there (as in the JAX package, bf16
  tables need fp32).

``engine()`` reads ``ECTRANS_TPU_LEG_KERNEL`` as the JAX package does; its
"auto" is "dense" on the CPU too (the JAX package picks "xla" there only
because Pallas cannot run on the CPU; here every kernel has a plain
version).  ``engine()`` and ``dense_pack()`` are read once per transform by
``transform.py``; the dispatchers take the engine, tier or packing as an
argument and never read the environment.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import legendre_grouped
from . import legendre_planes as lp

ENGINES = ("dense", "xla", "pallas", "planes")
TIERS = ("highest", "high", "bf16")


def engine() -> str:
    """The Legendre engine ``ECTRANS_TPU_LEG_KERNEL`` selects ("xla",
    "pallas", "dense" or "planes"); anything else means "dense"."""
    kern = os.environ.get("ECTRANS_TPU_LEG_KERNEL", "auto")
    return kern if kern in ENGINES else "dense"


def dense_pack() -> bool:
    """The hemisphere-packed kernels K7/K8 on the "dense" engine, as
    ``ECTRANS_TPU_LEG_DENSE_PACK`` selects (anything but "0"; default
    off, as in the JAX package)."""
    return os.environ.get("ECTRANS_TPU_LEG_DENSE_PACK", "0") != "0"


def group_einsum(spec: str, table: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(spec, table, x)`` in x's dtype, the table (bf16 on
    that tier) upcast.  In fp32 both operands go to fp64, where each
    product is exact and the sum all but so, and the result is rounded
    once."""
    if x.dtype == torch.float32:
        return torch.einsum(spec, table.double(), x.double()).float()
    return torch.einsum(spec, table.to(x.dtype), x)


def legendre_inv_grouped(sym: torch.Tensor, asym: torch.Tensor,
                         gl) -> torch.Tensor:
    """Grouped inverse LT as einsums (``group_einsum``): sym/asym (nfld,
    2, M, kmax) -> (nfld, 2, M, ndgl) Fourier coefficients, latitudes north
    -> south, one group at a time."""
    parts = []
    for g in gl.groups:
        s = sym[:, :, g.m0:g.m1, :g.kg]
        a = asym[:, :, g.m0:g.m1, :g.kg]
        fs = group_einsum("mik,fcmk->fcmi", g.psym, s)
        fa = group_einsum("mik,fcmk->fcmi", g.pasym, a)
        parts.append(torch.cat([F.pad(fs + fa, (g.i0, 0)),
                                F.pad((fs - fa).flip(-1), (0, g.i0))], dim=-1))
    return torch.cat(parts, dim=2)


def legendre_dir_grouped(fourier: torch.Tensor, gl, w: torch.Tensor):
    """Grouped direct LT as einsums (``group_einsum``, over the
    latitudes): (nfld, 2, M, ndgl) Fourier coefficients + NH weights w ->
    (sym, asym), each (nfld, 2, M, kmax)."""
    fsym_all, fasym_all = legendre_grouped.parity_fourier(fourier, gl.ndgnh,
                                                          w)
    syms, asyms = [], []
    for g in gl.groups:
        pad = (0, gl.kmax - g.kg)
        syms.append(F.pad(group_einsum(
            "mik,fcmi->fcmk", g.psym, fsym_all[:, :, g.m0:g.m1, g.i0:]),
            pad))
        asyms.append(F.pad(group_einsum(
            "mik,fcmi->fcmk", g.pasym, fasym_all[:, :, g.m0:g.m1, g.i0:]),
            pad))
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
