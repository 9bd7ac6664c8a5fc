"""Regular lat-lon output grids (the reference's LDLL mode).

Counterpart of ``ectrans_tpu/latlon.py``: *exact spectral evaluation* at the
equidistant latitudes instead of the reference's FMM interpolation between
Gaussian and equidistant latitudes (``cdmap_mod.F90``, ``seefmm_mix.F90``).
A second set of parity-split Legendre tables is made at the lat-lon NH
latitudes, grouped as the Gaussian ones, and the inverse runs the "xla"
engine's grouped contraction (``legendre_matmul.legendre_inv_grouped``: one
einsum a group, fp32 summed in fp64) and the uniform-row synthesis
(``ops.fourier.synthesis_uniform``).  The rows are ``nlon`` long with modes
up to nsmax, so a grid coarser than the truncation (2 nsmax >= nlon, e.g.
TCO1279 onto 0.25 degrees) folds modes at or above each row's Nyquist, as
the JAX package's literal-wavenumber chirp-z does.

On a CUDA device the tables come from the table kernel K4
(``ops.legendre_tablegen``, one launch for all groups) at the lat-lon
nodes; on the CPU from the host fp64 recurrence (``build_parity_tables``).
They are cached on the Resolution (dropped by ``trans_end``/``release``).

``dir_trans_latlon`` is the direct LDLL mode: zonal analysis on the
uniform rows, Lagrange interpolation of the Fourier coefficients onto the
Gaussian latitudes, then the Gaussian direct Legendre transform; it is
interpolation-limited, ``dir_trans`` on the Gaussian grid stays the exact
path.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .legendre import build_parity_tables
from .ops import fourier, layout, legendre_matmul, spectral
from .resolution import (GroupedLegendre, LegendreGroup, Resolution,
                         canonical_device, check_dtype, default_leg_groups)
from .transform import (InvFlags, _check_spec, _device_of, fsc,
                        legendre_inputs)


@dataclasses.dataclass(frozen=True)
class LatLonGrid:
    """Equidistant lat-lon output grid.

    nlat latitudes: poles included if ``include_poles`` (lat = 90..-90),
    otherwise shifted half a step off the poles (the reference's LDLL
    "shifted" flavour, LSHIFTLL); nlon equidistant longitudes from 0.
    """

    nlat: int
    nlon: int
    include_poles: bool = True

    @property
    def latitudes_deg(self) -> np.ndarray:
        if self.include_poles:
            return np.linspace(90.0, -90.0, self.nlat)
        step = 180.0 / self.nlat
        return 90.0 - step / 2.0 - step * np.arange(self.nlat)

    @property
    def mu(self) -> np.ndarray:
        return np.sin(np.radians(self.latitudes_deg))


def latlon_groups(res: Resolution) -> tuple:
    """The m-groups (m0, m1, i0, J) of the lat-lon tables (``ectrans_tpu``
    ``_latlon_tables``): the fixed group count (``ECTRANS_TPU_LEG_GROUPS``
    does not reach them, as in the JAX package), every latitude active
    (i0 = 0), J = 2 kg degrees from m0."""
    M = res.M
    bs = -(-M // default_leg_groups(M))
    return tuple((m0, min(M, m0 + bs), 0, 2 * ((res.nsmax + 1 - m0) // 2 + 1))
                 for m0 in range(0, M, bs))


def latlon_nodes(ll: LatLonGrid) -> np.ndarray:
    """The NH nodes mu of the tables: the equator row included when nlat
    is odd."""
    return ll.mu[: (ll.nlat + 1) // 2]


def _build_tables(res: Resolution, ll: LatLonGrid, dtype: torch.dtype,
                  device: torch.device):
    mu_nh = latlon_nodes(ll)
    nh = mu_nh.size
    groups = latlon_groups(res)
    if device.type == "cuda":
        from .ops import legendre_tablegen as tg

        inp = {k: torch.as_tensor(v, device=device).contiguous()
               for k, v in tg.recurrence_inputs(
                   res.nsmax, mu_nh, np.full(nh, res.nsmax)).items()}
        pns = tg.gen_groups(inp, groups, dtype)
        parts = [(pn[:, 0::2].transpose(1, 2), pn[:, 1::2].transpose(1, 2))
                 for pn in pns]
    elif device.type == "cpu":
        # pole rows: the sectoral seeds of m > 0 are 0 there, P_n^0(+-1) =
        # sqrt(2n+1)
        psym, pasym, _ = build_parity_tables(res.nsmax, mu_nh, 1)
        parts = [(torch.as_tensor(psym[m0:m1, :, : J // 2], dtype=dtype),
                  torch.as_tensor(pasym[m0:m1, :, : J // 2], dtype=dtype))
                 for m0, m1, _, J in groups]
    else:
        raise ValueError(f"unsupported device {device}")
    gl = GroupedLegendre(
        groups=tuple(LegendreGroup(m0=m0, m1=m1, i0=i0, kg=J // 2, psym=ps,
                                   pasym=pa)
                     for (m0, m1, i0, J), (ps, pa) in zip(groups, parts)),
        ndgnh=nh, kmax=res.kmax)
    racthe = 1.0 / np.maximum(np.sqrt(1.0 - ll.mu ** 2), 1e-12) / res.radius
    # at exact poles 1/cos is singular; derivatives there are zeroed
    if ll.include_poles:
        racthe[0] = 0.0
        racthe[-1] = 0.0
    return gl, torch.tensor(racthe, dtype=dtype, device=device)


def latlon_tables(res: Resolution, ll: LatLonGrid, dtype=torch.float32,
                  device="cpu"):
    """(grouped parity tables at the lat-lon NH nodes, 1/(a cos) at every
    lat-lon row) on ``device``, cached on the Resolution."""
    dtype = check_dtype(dtype)
    device = canonical_device(device)
    return res.cached(("latlon_tables", ll, dtype, str(device)),
                      lambda: _build_tables(res, ll, dtype, device))


def inv_trans_latlon(res: Resolution, ll: LatLonGrid, spvor=None, spdiv=None,
                     spscalar=None, *, flags: InvFlags = InvFlags(),
                     dtype=torch.float32) -> torch.Tensor:
    """Inverse transform onto a regular lat-lon grid (LDLL equivalent), on
    the device of the inputs.

    Same field contract as ``inv_trans``; output (nfld_out, nlat, nlon).
    """
    if (spvor is None) != (spdiv is None):
        raise ValueError("spvor and spdiv must be supplied together")
    if spvor is None and spscalar is None:
        raise ValueError("nothing to transform")
    for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                    ("spscalar", spscalar)):
        _check_spec(nm, arr, res)
    dtype = check_dtype(dtype)
    device = _device_of(spvor, spdiv, spscalar)
    tables = res.device_tables(dtype, device)
    gl, racthe = latlon_tables(res, ll, dtype, device)
    nuv = 0 if spvor is None else spvor.shape[0]
    nsc = 0 if spscalar is None else spscalar.shape[0]

    def dense(x):
        return (None if x is None
                else layout.packed_to_dense(x.to(dtype), tables))

    lt_inputs = legendre_inputs(dense(spvor), dense(spdiv), dense(spscalar),
                                flags, tables.vd, tables.nsd)
    sym, asym = layout.dense_to_parity(torch.cat(lt_inputs), res.kmax)
    four_all = legendre_matmul.legendre_inv_grouped(sym, asym, gl)
    if ll.nlat % 2:
        # the NH half holds the equator row: drop its southern duplicate
        nh = gl.ndgnh
        four_all = torch.cat([four_all[..., :nh], four_all[..., nh + 1:]], -1)

    # the output groups in the order of ectrans_tpu's _inv_ll_impl
    four = fsc(four_all, nuv, nsc, flags, racthe).transpose(2, 3)
    return fourier.synthesis_uniform(four[:, 0], four[:, 1], ll.nlon)


def latlon_interp_matrix(res: Resolution, ll: LatLonGrid,
                         order: int = 12) -> np.ndarray:
    """(ndgl, nlat) Lagrange interpolation matrix taking per-latitude
    Fourier coefficients from the lat-lon latitudes to the Gaussian ones
    (the role of the reference's SEEFMM interpolation, ``seefmm_mix.F90``,
    in the direct lat-lon mode): a barycentric Lagrange stencil of the
    ``order`` nearest nodes (``ectrans_tpu`` ``_latlon_interp_matrix``)."""
    th_ll = np.radians(ll.latitudes_deg)           # descending
    th_g = np.radians(np.degrees(np.arcsin(res.mu)))
    nll = th_ll.size
    j = np.searchsorted(-th_ll, -th_g)
    lo = np.clip(j - order // 2, 0, nll - order)
    nodes = th_ll[lo[:, None] + np.arange(order)[None, :]]   # (ndgl, order)
    W = np.zeros((res.ndgl, nll))
    rows = np.arange(res.ndgl)
    for a in range(order):
        num = np.ones(res.ndgl)
        den = np.ones(res.ndgl)
        for b in range(order):
            if a != b:
                num *= th_g - nodes[:, b]
                den *= nodes[:, a] - nodes[:, b]
        W[rows, lo + a] = num / den
    return W


def dir_trans_latlon(res: Resolution, ll: LatLonGrid, u=None, v=None,
                     scalars=None, *, dtype=torch.float32,
                     interp_order: int = 12):
    """Direct transform from a regular lat-lon grid (the reference's
    direct LDLL mode, CDMAP before LEDIR): zonal analysis on the uniform
    rows, Lagrange interpolation onto the Gaussian latitudes, then the
    quadrature-weighted grouped Legendre analysis (one einsum a group, as
    the "xla" engine), on the device of the inputs.

    Accuracy is interpolation-limited (choose nlat >~ 1.5x ndgl for
    near-spectral accuracy).  Returns (spvor, spdiv, spscalar) packed
    tensors, None where there was no input.
    """
    if (u is None) != (v is None):
        raise ValueError("u and v must be supplied together")
    if u is None and scalars is None:
        raise ValueError("nothing to transform")
    for nm, arr in (("u", u), ("v", v), ("scalars", scalars)):
        if arr is not None and tuple(arr.shape[1:]) != (ll.nlat, ll.nlon):
            raise ValueError(f"{nm} must have shape (nfld, nlat={ll.nlat}, "
                             f"nlon={ll.nlon}), got {tuple(arr.shape)}")
    dtype = check_dtype(dtype)
    device = _device_of(u, v, scalars)
    tables = res.device_tables(dtype, device)
    gl = res.grouped_legendre(dtype, device)
    W = res.cached(("latlon_interp", ll, interp_order, dtype, str(device)),
                   lambda: torch.tensor(
                       latlon_interp_matrix(res, ll, interp_order),
                       dtype=dtype, device=device))

    nuv = 0 if u is None else u.shape[0]
    grid = torch.cat([x.to(dtype) for x in (u, v, scalars) if x is not None])
    re, im = fourier.analysis_uniform(grid, res.nsmax)      # (F, nlat, M)
    four_ll = torch.stack([re, im], 1).transpose(2, 3)      # (F, 2, M, nlat)
    four = legendre_matmul.group_einsum("gj,fcmj->fcmg", W, four_ll)
    if nuv:
        four = torch.cat([four[: 2 * nuv] * tables.racthe, four[2 * nuv:]])
    sym, asym = legendre_matmul.legendre_dir_grouped(four, gl,
                                                     tables.w[: res.ndgnh])
    dense = layout.parity_to_dense(sym, asym, res.NP)
    spvor = spdiv = spsc = None
    if nuv:
        dvor, ddiv = spectral.uv_to_vordiv(dense[:nuv], dense[nuv: 2 * nuv],
                                           tables.uvtvd)
        spvor = layout.dense_to_packed(dvor, res)
        spdiv = layout.dense_to_packed(ddiv, res)
    if scalars is not None:
        spsc = layout.dense_to_packed(dense[2 * nuv:], res)
    return spvor, spdiv, spsc
