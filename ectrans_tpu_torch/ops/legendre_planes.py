"""bf16 limb-plane Legendre transforms (the "planes" engine), kernels K9 and
K10.

Counterpart of ``ectrans_tpu/ops/legendre_planes.py``.  The fp32 tables are
split into ``nplanes`` bf16 limb planes (``Resolution.planes_legendre``,
one transposed (gm, ig, J) layout for both directions), and so is the
small operand.  3 planes are an exact split of an fp32 value ("highest"
and its alias "high"); 1 plane is the value rounded to bf16 (the "bf16"
tier).

Operand packing, as in the JAX package:

* inverse: realigned coefficient rows x (gm, fc2, J) -> (gm, 2 P fc2, J)
  bf16 rows [x_0; x_0 sgn; x_1; x_1 sgn; ...], sgn_j = (-1)^j, giving north
  from the x rows and south from the sign rows (P̄_n^m(-mu) =
  (-1)^(n-m) P̄_n^m(mu));
* direct: weighted north/south Fourier rows fn, fs (gm, fc2, ig) ->
  (gm, 2 P fc2, ig) bf16 rows [gn_0; gs_0; gn_1; gs_1; ...], and
  out_j = aa_j + (-1)^j bb_j with aa from the gn rows and bb from the gs
  rows.

Arithmetic: the kernels (``csrc/legendre_planes.cu``) and their plain
versions sum each value's limbs in fp32 (exact) and then take the products,
so at 3 planes every limb product is kept.  The JAX kernels keep only the
products of limb l and plane k with l + k < nplanes (one bf16 MXU pass
each); the terms they drop are 2^-24 of a product, which is enough to put
the TCO1279 round trip over its 100·eps gate.  At 1 plane both compute the
same bf16 products.  CUDA tensors launch the kernels (bf16 in, fp32 out);
CPU tensors take the plain versions (``torch.bmm`` in fp32).  The kernels
take planes in rows padded past J to a multiple of 8 entries (as
``Resolution.planes_legendre`` stores them) and never read past J; the
wrappers copy planes laid out otherwise into such rows first
(``aligned_planes``).  Not carried over: the ``optimization_barrier``
around the packing (a TPU-compiler guard).
"""

from __future__ import annotations

import torch

from .. import _build
from .layout import diag_realign
from .legendre_dense import (_jsgn, group_rows, hemispheres_to_fourier,
                             rows_to_dense, weighted_rows)
from .legendre_grouped import pad_rows

_TIER_PLANES = {"highest": 3, "high": 3, "bf16": 1}


def planes_for_tier(precision: str) -> int:
    """Plane count of a precision tier: "high" is an alias of "highest"
    (3 planes); "bf16" is one plane."""
    return _TIER_PLANES.get(precision, 3)


def split_planes(x: torch.Tensor, nplanes: int) -> list:
    """fp32 -> ``nplanes`` bf16 limb planes summing to x (exactly at 3).

    Each limb but the last is cut by masking the low 16 bits of the fp32
    pattern (a value exactly representable in bf16, so the remainder is
    exact); the last is rounded to bf16.  After two cuts the remainder has
    at most 8 significant bits, so at 3 planes the rounding is exact.  The mask is applied to an int32
    view, since torch has no uint32 ``&`` on every build."""
    rem = x.to(torch.float32)
    outs = []
    for _ in range(nplanes - 1):
        hi = (rem.view(torch.int32) & -65536).view(torch.float32)
        outs.append(hi.to(torch.bfloat16))
        rem = rem - hi
    outs.append(rem.to(torch.bfloat16))
    return outs


def _pack_inv_rows(dg: torch.Tensor, nplanes: int) -> torch.Tensor:
    """(gm, fc2, J) fp32 realigned coefficients -> (gm, 2 P fc2, J) bf16
    rows [x_0; x_0 sgn; x_1; x_1 sgn; ...]."""
    sgn = _jsgn(dg.shape[-1], dg)
    parts = []
    for p in split_planes(dg, nplanes):
        parts.append(p)
        parts.append((p.to(dg.dtype) * sgn).to(torch.bfloat16))
    return torch.cat(parts, dim=1)


def _pack_dir_rows(fn: torch.Tensor, fs: torch.Tensor,
                   nplanes: int) -> torch.Tensor:
    """(gm, fc2, ig) fp32 weighted north/south -> (gm, 2 P fc2, ig) bf16
    rows [gn_0; gs_0; gn_1; gs_1; ...]."""
    parts = []
    for a, b in zip(split_planes(fn, nplanes), split_planes(fs, nplanes)):
        parts += [a, b]
    return torch.cat(parts, dim=1)


def _limb_sum(rows: torch.Tensor, nplanes: int, fc2: int, first: int):
    """fp32 sum over limbs l of the fc2-row blocks at 2 l + first of packed
    bf16 rows (gm, 2 P fc2, n)."""
    return sum(rows[:, (2 * l + first) * fc2: (2 * l + first + 1) * fc2]
               .to(torch.float32) for l in range(nplanes))


def _plane_sum(tplanes, nplanes: int) -> torch.Tensor:
    """The fp32 table sum_k plane_k (gm, ig, J)."""
    return sum(p.to(torch.float32) for p in tplanes[:nplanes])


def group_inv_planes_plain(a: torch.Tensor, tplanes, nplanes: int, fc2: int):
    """Plain version of K9: (gm, 2 P fc2, J) bf16 rows x P planes
    (gm, ig, J) bf16 -> (north, south), each (gm, fc2, ig) fp32."""
    pt = _plane_sum(tplanes, nplanes).transpose(1, 2)
    return (torch.bmm(_limb_sum(a, nplanes, fc2, 0), pt),
            torch.bmm(_limb_sum(a, nplanes, fc2, 1), pt))


def plane_rows(tplanes, nplanes: int, like: torch.Tensor, gm: int,
               shape: tuple) -> int:
    """The common row length of the planes K9 and K10 read (gm, ig, J): J,
    or the padded rows of ``Resolution.planes_legendre``."""
    if nplanes not in (1, 3) or len(tplanes) < nplanes:
        raise ValueError(f"the kernels take 1 or 3 planes, got nplanes="
                         f"{nplanes} with {len(tplanes)} planes")
    p0 = tplanes[0]
    ld = _build.check_rows("plane 0", p0, like, (gm,) + shape,
                           dtype=torch.bfloat16)
    # the other planes must be laid out as the first (one comparison each,
    # on the host's time a call); one that is not gets the full check, which
    # names what is wrong with it
    layout = (p0.shape, p0.stride(), p0.dtype, p0.device)
    for k in range(1, nplanes):
        p = tplanes[k]
        if (p.shape, p.stride(), p.dtype, p.device) != layout:
            _build.check_rows(f"plane {k}", p, like, (gm,) + shape,
                              dtype=torch.bfloat16)
            raise ValueError(f"the planes' rows differ: strides "
                             f"{p0.stride()} and {p.stride()}")
    return ld


def aligned_planes(tplanes, nplanes: int, ld: int) -> tuple:
    """The first ``nplanes`` planes as K9 and K10 take them, each starting
    16-byte aligned in rows of a multiple of 8 entries, as
    ``Resolution.planes_legendre`` stores them; planes laid out otherwise
    are copied into such rows on their device first (``pad_rows``).
    Returns (planes, row length)."""
    planes = tuple(tplanes[:nplanes])
    if ld % 8 == 0 and all(p.data_ptr() % 16 == 0 for p in planes):
        return planes, ld
    planes = tuple(pad_rows(p, 8) for p in planes)
    return planes, planes[0].stride(1)


def group_inv_planes(a: torch.Tensor, tplanes, nplanes: int, fc2: int):
    """One group's inverse LT (K9; replaces
    ``legendre_planes.group_inv_planes``): packed bf16 rows a
    (gm, 2 P fc2, J) x bf16 planes (gm, ig, J; rows may be padded,
    ``plane_rows``) -> (north, south), each (gm, fc2, ig) fp32, south NOT
    latitude-reversed.  The kernel reads the x_l rows and takes south from
    the parity of j: the sign rows must be the x_l (-1)^j rows
    ``_pack_inv_rows`` makes (the plain version reads them)."""
    if _build.on_cpu(a):
        return group_inv_planes_plain(a, tplanes, nplanes, fc2)
    gm, _, J = a.shape
    ig = tplanes[0].shape[1]
    _build.check_operand("a", a, a, (gm, 2 * nplanes * fc2, J),
                         dtype=torch.bfloat16)
    tplanes, ld = aligned_planes(
        tplanes, nplanes, plane_rows(tplanes, nplanes, a, gm, (ig, J)))
    north = torch.empty((gm, fc2, ig), dtype=torch.float32, device=a.device)
    south = torch.empty_like(north)
    if north.numel() == 0:
        return north.zero_(), south.zero_()
    ptrs = [tplanes[min(k, nplanes - 1)].data_ptr() for k in range(3)]
    with _build.on_device(a):
        _build.launch("ect_inv_planes", None, a.data_ptr(), *ptrs,
                      north.data_ptr(), south.data_ptr(), nplanes, gm, fc2,
                      J, ig, ld)
    group_inv_planes.launches += 1
    return north, south


group_inv_planes.launches = 0


def group_inv_planes_shape(gm: int, fc2: int, J: int, ig: int,
                           nplanes: int) -> dict:
    """K9's launch for one group (``_build.launch_shape``)."""
    return _build.launch_shape("ect_inv_planes_shape", None, nplanes, gm,
                               fc2, J, ig)


def group_dir_planes_plain(w: torch.Tensor, tplanes, nplanes: int,
                           fc2: int) -> torch.Tensor:
    """Plain version of K10: (gm, 2 P fc2, ig) bf16 rows x P planes
    (gm, ig, J) bf16 -> (gm, fc2, J) fp32."""
    p = _plane_sum(tplanes, nplanes)
    aa = torch.bmm(_limb_sum(w, nplanes, fc2, 0), p)
    bb = torch.bmm(_limb_sum(w, nplanes, fc2, 1), p)
    return aa + bb * _jsgn(p.shape[2], aa)


def group_dir_planes(w: torch.Tensor, tplanes, nplanes: int,
                     fc2: int) -> torch.Tensor:
    """One group's direct LT (K10; replaces
    ``legendre_planes.group_dir_planes``): packed bf16 weighted Fourier
    rows w (gm, 2 P fc2, ig) x bf16 planes (gm, ig, J; rows may be padded)
    -> realigned rows (gm, fc2, J) fp32."""
    if _build.on_cpu(w):
        return group_dir_planes_plain(w, tplanes, nplanes, fc2)
    gm, _, ig = w.shape
    J = tplanes[0].shape[2]
    _build.check_operand("w", w, w, (gm, 2 * nplanes * fc2, ig),
                         dtype=torch.bfloat16)
    tplanes, ld = aligned_planes(
        tplanes, nplanes, plane_rows(tplanes, nplanes, w, gm, (ig, J)))
    out = torch.empty((gm, fc2, J), dtype=torch.float32, device=w.device)
    if out.numel() == 0:
        return out
    ptrs = [tplanes[min(k, nplanes - 1)].data_ptr() for k in range(3)]
    with _build.on_device(w):
        _build.launch("ect_dir_planes", None, w.data_ptr(), *ptrs,
                      out.data_ptr(), nplanes, gm, fc2, J, ig, ld)
    group_dir_planes.launches += 1
    return out


group_dir_planes.launches = 0


def group_dir_planes_shape(gm: int, fc2: int, J: int, ig: int,
                           nplanes: int) -> dict:
    """K10's launch for one group (``_build.launch_shape``): its blocks
    count each latitude split's parts, clusters of 1 to 8 blocks."""
    return _build.launch_shape("ect_dir_planes_shape", None, nplanes, gm,
                               fc2, J, ig)


def legendre_inv_planes(dense: torch.Tensor, ppl, nplanes: int = 3):
    """Inverse LT: (nfld, 2, M, NP) dense spectral -> (nfld, 2, M, ndgl)
    Fourier coefficients, latitudes north -> south (ppl: PlanesLegendre)."""
    nfld = dense.shape[0]
    d2 = diag_realign(dense)
    parts = []
    for g in ppl.groups:
        north, south = group_inv_planes(
            _pack_inv_rows(group_rows(d2[..., :g.J], g), nplanes),
            g.pt[:nplanes], nplanes, 2 * nfld)
        parts.append(hemispheres_to_fourier(north.to(dense.dtype),
                                            south.to(dense.dtype), g, nfld))
    return torch.cat(parts, dim=2)


def legendre_dir_rows_planes(fourier: torch.Tensor, ppl, w: torch.Tensor,
                             nplanes: int = 3) -> list:
    """Direct LT in the m-major layout: (nfld, 2, M, ndgl) Fourier
    coefficients + NH weights w (ndgnh,) -> list of per-group
    (gm, 2*nfld, J) realigned rows, row index c*nfld + f (the input of the
    packing kernel K3)."""
    fc2 = 2 * fourier.shape[0]
    fn_all, fs_all = weighted_rows(fourier, ppl.ndgnh, w)
    return [group_dir_planes(
        _pack_dir_rows(group_rows(fn_all[..., g.i0:], g),
                       group_rows(fs_all[..., g.i0:], g), nplanes),
        g.pt[:nplanes], nplanes, fc2).to(fourier.dtype) for g in ppl.groups]


def legendre_dir_planes(fourier: torch.Tensor, ppl, w: torch.Tensor, NP: int,
                        nplanes: int = 3) -> torch.Tensor:
    """Direct LT to the dense layout: (nfld, 2, M, ndgl) -> (nfld, 2, M, NP)
    (entries at n < m are neighbouring rows' data)."""
    return rows_to_dense(legendre_dir_rows_planes(fourier, ppl, w, nplanes),
                         ppl.groups, fourier.shape[0], NP)
