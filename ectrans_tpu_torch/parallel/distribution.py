"""Distributed-transform bookkeeping: the wave and latitude distributions
(SUWAVEDI/SUMPLAT) and each rank's tables.

Counterpart of ``ectrans_tpu/parallel/distribution.py``.  On the host, for
one (Resolution, w, v):

* **wave distribution** (reference ``suwavedi_mod.F90:115-131``): the
  contiguous m-groups of ``Resolution.legendre_groups`` at the fixed count
  (``default_leg_groups``; ``ECTRANS_TPU_LEG_GROUPS`` does not reach a
  mesh, as in the JAX package) dealt round-robin
  to the w ranks, so each w-rank owns ``Lg`` m's of every group and every
  rank's tables have the same shapes; ``perm`` lists the m's in w-rank
  order (``M`` marks padding);
* **latitude distribution** (reference ``sumplatf_mod.F90``): rows sorted
  by length and dealt round-robin, so each w-rank owns an equal mix of
  short and long rows (``lat_perm``: the row at each slot, ``ndgl`` padded
  to a multiple of w*v; pad slots hold rows >= ndgl);
* **Fourier buckets** (``lat_buckets``, ``LatBucketMeta``): ranges
  [lb0, lb1) of every w-rank's local latitude slots, nb = min(nbuckets,
  LLW // 16) equal ones; the length-sorted deal gives every w-rank the same
  length mix in a range, so each bucket's mb, ndlon and nfft are shared by
  all w-ranks (``ops.fourier.good_size``, not the JAX package's
  lane-aligned four-step length);
* ``host_tables``: the index maps and spectral-operator coefficient tables
  in that permuted, padded layout, bit for bit the JAX package's;
* ``rank_fourier``: one w-rank's chirp-z tables of its own slots (pad
  slots give zeros), on its device, for ``ops.fourier.synthesis_bucketed``
  and ``analysis_bucketed`` (the JAX package's ``fb{k}_*_w`` host tables).

The Legendre tables are not host tables here: ``rank_legendre`` has K4
(``ops.legendre_tablegen``) build only the rows of one w-rank on the card,
from the recurrence inputs of its m's, in the realigned row layout of the
JAX package's ``fl{gi}_pn_w`` (the parity pairs ``lg{gi}_psym_w`` /
``_pasym_w`` are strided views of it).  K4 computes each (m, latitude)
column on its own, so a rank's rows are bit for bit those of the whole
table, and no rank ever holds another's rows.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import spectral as spectral_ops
from ..ops.fourier import BucketedTables, bucket_tables, good_size
from ..resolution import (ON_TRANS_END, FullGroup, FullLegendre, Resolution,
                          default_leg_groups)


def pingpong_blocks(M: int, w: int) -> list[list[int]]:
    """Boustrophedon assignment of m=0..M-1 to w blocks (suwavedi ping-pong)."""
    blocks: list[list[int]] = [[] for _ in range(w)]
    for i in range(M):
        cycle, pos = divmod(i, w)
        blocks[pos if cycle % 2 == 0 else w - 1 - pos].append(i)
    return blocks


@dataclasses.dataclass(frozen=True)
class LatBucketMeta:
    """One Fourier latitude bucket of the mesh: local slots [lb0, lb1) on
    every w-rank, the largest mode ``mb`` and row length ``ndlon`` over
    those slots of every w-rank, and their convolution length ``nfft``."""

    lb0: int
    lb1: int
    mb: int
    ndlon: int
    nfft: int


@dataclasses.dataclass(frozen=True)
class GroupMeta:
    """One m-group of the distributed grouped-Legendre layout: every w-rank
    owns ``Lg`` m's of it (round-robin within [m0, m1), the group padded to
    Lg * w), at local rows [off, off + Lg)."""

    m0: int
    m1: int
    Lg: int     # local m count per w-rank
    i0: int     # first active NH latitude (ndgnh - ndglu(m0))
    kg: int     # parity coefficient extent
    off: int    # local-axis offset of this group within a rank's m-block


@dataclasses.dataclass(frozen=True, eq=False)
class Distribution:
    """Host-side distributed layout for one (Resolution, w, v)."""

    res: Resolution
    w: int
    v: int
    M_pad: int              # padded wavenumber count (multiple of w)
    ndgl_pad: int           # padded latitude count (multiple of w*v)
    perm: np.ndarray        # (M_pad,) permuted m values; res.M marks padding
    pos_of_m: np.ndarray    # (M,) position of natural m in the permuted axis
    pm_perm_pos: np.ndarray  # (nspec2,) permuted-axis position per packed idx
    groups: tuple           # tuple[GroupMeta]
    lat_perm: np.ndarray    # (ndgl_pad,) original row at permuted slot
    lat_pos: np.ndarray     # (ndgl,) permuted slot of natural row
    lat_buckets: tuple      # tuple[LatBucketMeta]

    @property
    def ML(self) -> int:
        return self.M_pad // self.w

    @property
    def LL(self) -> int:
        return self.ndgl_pad // self.w

    @property
    def LLg(self) -> int:
        """Latitude rows of one rank in grid space."""
        return self.ndgl_pad // (self.w * self.v)

    def grid_block(self, r: int) -> tuple:
        """(first, end) pole-to-pole rows of rank r's grid block (the
        reference's NFRSTLAT..NLSTLAT): the rows [r*LLg, (r+1)*LLg) that
        exist."""
        ndgl = self.res.ndgl
        return min(r * self.LLg, ndgl), min((r + 1) * self.LLg, ndgl)


@functools.lru_cache(maxsize=8)
def build_distribution(res: Resolution, w: int, v: int,
                       nbuckets: int = 12) -> Distribution:
    """Grouped round-robin wave distribution, the length-sorted latitude
    distribution and its Fourier buckets (``ectrans_tpu``
    ``build_distribution``; nfft by ``ops.fourier.good_size``)."""
    M = res.M
    groups = []
    off = 0
    # the fixed group count: the mesh does not follow ECTRANS_TPU_LEG_GROUPS
    # (``ectrans_tpu`` ``build_distribution``)
    for m0, m1, i0, J in res.legendre_groups(default_leg_groups(res.M)):
        Lg = -(-(m1 - m0) // w)
        groups.append(GroupMeta(m0=m0, m1=m1, Lg=Lg, i0=i0, kg=J // 2,
                                off=off))
        off += Lg
    ML = off
    M_pad = ML * w

    # permuted m-axis: [rank 0: g0 slice, g1 slice, ... | rank 1: ...]
    perm = np.full(M_pad, M, dtype=np.int64)  # M = padding sentinel
    for s in range(w):
        for g in groups:
            for j in range(g.Lg):
                m = g.m0 + j * w + s
                if m < g.m1:
                    perm[s * ML + g.off + j] = m
    pos_of_m = np.zeros(M, dtype=np.int64)
    for pos, m in enumerate(perm):
        if m < M:
            pos_of_m[m] = pos
    pm_perm_pos = pos_of_m[res.packed_gather_m]

    wv = w * v
    ndgl = res.ndgl
    ndgl_pad = -(-ndgl // wv) * wv
    nloen = list(res.grid.nloen)
    # rows sorted by length (pad rows first), dealt round-robin to w
    order = sorted(range(ndgl_pad),
                   key=lambda r: (nloen[r] if r < ndgl else -1, r))
    LLW = ndgl_pad // w
    lat_perm = np.empty(ndgl_pad, dtype=np.int64)
    for p in range(ndgl_pad):
        s, j = divmod(p, LLW)
        lat_perm[p] = order[j * w + s]
    lat_pos = np.empty(ndgl, dtype=np.int64)
    for p, r in enumerate(lat_perm):
        if r < ndgl:
            lat_pos[r] = p

    nmen = [int(x) for x in res.nmen]
    nb = max(1, min(nbuckets, LLW // 16))
    bounds = [round(LLW * k / nb) for k in range(nb + 1)]
    lat_buckets = []
    for k in range(nb):
        lb0, lb1 = bounds[k], bounds[k + 1]
        if lb0 == lb1:
            continue
        rows = [r for r in order[lb0 * w: lb1 * w] if r < ndgl]
        mb = min(res.nsmax, max((nmen[r] for r in rows), default=0))
        ndlon_b = max((nloen[r] for r in rows), default=1)
        lat_buckets.append(LatBucketMeta(
            lb0=lb0, lb1=lb1, mb=mb, ndlon=ndlon_b,
            nfft=good_size(ndlon_b + 2 * mb + 1)))

    return Distribution(
        res=res, w=w, v=v, M_pad=M_pad, ndgl_pad=ndgl_pad, perm=perm,
        pos_of_m=pos_of_m, pm_perm_pos=pm_perm_pos, groups=tuple(groups),
        lat_perm=lat_perm, lat_pos=lat_pos, lat_buckets=tuple(lat_buckets))


def clear_caches():
    """Release host-side distribution state (``trans_end`` calls it)."""
    build_distribution.cache_clear()


ON_TRANS_END.append(clear_caches)


def _permute_m_rows(table: np.ndarray, perm: np.ndarray, pad_value=0.0):
    """table (M, ...) -> (M_pad, ...) with rows reordered by perm; padding
    rows (perm == M) filled with pad_value."""
    M = table.shape[0]
    padded = np.concatenate(
        [table, np.full((1,) + table.shape[1:], pad_value, table.dtype)], axis=0)
    return padded[np.minimum(perm, M)]


def _realign_rows(table: np.ndarray, perm: np.ndarray, M: int,
                  fill=0.0) -> np.ndarray:
    """(M, NP) table -> (M_pad, NP+1) permuted and diagonal-realigned:
    out[p, j] = table[perm[p], perm[p] + j] (``fill`` beyond each row's
    diagonal end and on padding rows)."""
    NPl = table.shape[1]
    out = np.full((len(perm),) + (NPl + 1,) + table.shape[2:], fill,
                  table.dtype)
    for p, m in enumerate(perm):
        if m < M:
            out[p, : NPl - m] = table[m, m:]
    return out


def parity_maps(res: Resolution) -> tuple:
    """(idx_sym, idx_asym), each (M, kmax): the absolute n = m + 2k and
    m + 1 + 2k of the parity coefficients, NP (a zero column) past nsmax+1
    (``ectrans_tpu`` ``resolution._build_parity_maps``)."""
    M, NP, kmax = res.M, res.NP, res.kmax
    nmax = NP - 1
    idx_sym = np.full((M, kmax), NP, dtype=np.int64)
    idx_asym = np.full((M, kmax), NP, dtype=np.int64)
    for m in range(M):
        ks = np.arange((nmax - m) // 2 + 1)
        idx_sym[m, : ks.size] = m + 2 * ks
        ka = np.arange((nmax - m - 1) // 2 + 1) if m + 1 <= nmax else ks[:0]
        idx_asym[m, : ka.size] = m + 1 + 2 * ka
    return idx_sym, idx_asym


def host_tables(dist: Distribution, engine: str = "xla") -> dict:
    """The numpy tables of the sharded pipeline in the permuted, padded
    layout (``ectrans_tpu`` ``host_tables`` without the Legendre and
    Bluestein tables).  Keys ending in ``_w`` are split over the w-ranks on
    their first axis (``rank_tables``); the others are the same on every
    rank.  ``engine`` "dense" adds the realigned coefficient tables and the
    maps of the row gather and of the compaction kernel's rows."""
    res = dist.res
    M, NP = res.M, res.NP
    perm = dist.perm
    idx_sym, idx_asym = parity_maps(res)
    ct_vd = spectral_ops.vordiv_coeff_tables(res)
    ct_tv = spectral_ops.uvtvd_coeff_tables(res)
    ct_ns = spectral_ops.nsder_coeff_tables(res)
    out = {
        "dense_gather_w": _permute_m_rows(
            res.dense_gather.transpose(1, 0, 2), perm, pad_value=res.nspec2),
        "idx_sym_w": _permute_m_rows(idx_sym, perm, pad_value=NP),
        "idx_asym_w": _permute_m_rows(idx_asym, perm, pad_value=NP),
        **{f"vd_{k}_w": _permute_m_rows(val, perm) for k, val in ct_vd.items()},
        **{f"tv_{k}_w": _permute_m_rows(val, perm) for k, val in ct_tv.items()},
        **{f"ns_{k}_w": _permute_m_rows(val, perm) for k, val in ct_ns.items()},
        "wq": res.w[: res.ndgnh],
        "pos_of_m": dist.pos_of_m,
        "perm": perm,
        "packed_c": res.packed_gather_c,
        "packed_n": res.packed_gather_n,
        "pm_perm_pos": dist.pm_perm_pos,
        "lat_perm": dist.lat_perm,
        "lat_pos": dist.lat_pos,
    }
    racthe_pad = np.concatenate([res.racthe,
                                 np.zeros(dist.ndgl_pad - res.ndgl)])
    out["racthe_lat_w"] = racthe_pad[dist.lat_perm]
    if engine == "dense":
        for pre, ct in (("vdr", ct_vd), ("tvr", ct_tv), ("nsr", ct_ns)):
            for k, val in ct.items():
                out[f"{pre}_{k}_w"] = _realign_rows(val, perm, M)
        out["packed_j"] = res.packed_gather_n - res.packed_gather_m
        nasm0 = np.asarray(res.nasm0, np.int64)
        mrow = np.minimum(perm, M - 1)
        out["nasm0_perm_w"] = np.where(perm < M, nasm0[mrow], res.nspec2)
        jj = np.arange(NP + 1)
        lrow = np.where(perm < M, res.nsmax - mrow + 1, 0)
        out["rvalid_w"] = (jj[None, :] < lrow[:, None]).astype(np.float64)
        # natural m -> local row on each w-rank (ML: a zero row where
        # another rank owns m)
        rom = np.full((dist.w, M), dist.ML, np.int64)
        for s in range(dist.w):
            for p in range(dist.ML):
                m = perm[s * dist.ML + p]
                if m < M:
                    rom[s, m] = p
        out["rom_w"] = rom
    return out


def rank_tables(dist: Distribution, iw: int, engine: str,
                dtype: torch.dtype, device) -> dict:
    """w-rank iw's share of ``host_tables`` as tensors on ``device``:
    integer maps as int64, the others in ``dtype``; a ``_w`` table keeps
    its w-rank's block of rows (its row of ``rom_w``)."""
    out = {}
    for k, val in host_tables(dist, engine).items():
        if k.endswith("_w"):
            n = val.shape[0] // dist.w
            val = val[iw * n: (iw + 1) * n]
            if k == "rom_w":
                val = val[0]
        val = np.array(val)
        out[k] = torch.as_tensor(
            val, dtype=torch.int64 if val.dtype.kind in "iu" else dtype,
            device=device)
    return out


def rank_fourier(dist: Distribution, iw: int, device) -> BucketedTables:
    """w-rank iw's chirp-z buckets over its latitude slots
    ``lat_perm[iw*LL:(iw+1)*LL]``, one span [lb0, lb1) each at the shared
    (mb, ndlon, nfft) of ``lat_buckets``; pad slots have zero tables."""
    res = dist.res
    slots = dist.lat_perm[iw * dist.LL: (iw + 1) * dist.LL]
    real = slots < res.ndgl
    r = np.minimum(slots, res.ndgl - 1)
    nloen = np.where(real, np.asarray(res.grid.nloen, np.int64)[r], 0)
    nmen = np.where(real, np.asarray(res.nmen, np.int64)[r], 0)
    bms = dist.lat_buckets
    return bucket_tables(nloen, nmen, res.nsmax,
                         [((b.lb0, b.lb1),) for b in bms], res.grid.ndlon,
                         device,
                         shapes=[(b.mb, b.ndlon, b.nfft) for b in bms])


def rank_inputs(host: dict, ms: np.ndarray, M: int, device) -> dict:
    """K4's recurrence inputs ``host`` (``legendre_tablegen.
    recurrence_inputs``) for the m's ``ms`` in that order, on ``device``;
    an m >= M is a pad row (zero seeds, so its table rows are zero)."""
    pad = ms >= M
    rows = np.minimum(ms, M - 1)
    take = {
        "A": host["A"][rows],
        "B": host["B"][rows],
        "mant": np.where(pad[:, None], 0.0, host["mant"][rows]),
        "exp": np.where(pad[:, None], 0, host["exp"][rows]).astype(np.int32),
        "mu": host["mu"],
    }
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
            for k, v in take.items()}


def rank_groups(dist: Distribution, inp: dict, dtype: torch.dtype,
                i0=None) -> FullLegendre:
    """One w-rank's full-n Legendre rows from its recurrence inputs
    (``rank_inputs``): per group, pn (Lg, J, ig) at local rows [off, off +
    Lg), every group in one K4 launch on a card, the plain recurrence
    (``gen_group_plain``) on the CPU; ``i0`` (when given) is every group's
    first latitude."""
    from ..ops import legendre_tablegen as tg

    spans = [(g.off, g.off + g.Lg, g.i0 if i0 is None else i0, 2 * g.kg)
             for g in dist.groups]
    pns = tg.gen_groups(inp, spans, dtype)
    return FullLegendre(
        groups=tuple(FullGroup(m0=a, m1=b, i0=first, J=J, pn=pn)
                     for (a, b, first, J), pn in zip(spans, pns)),
        ndgnh=inp["mu"].shape[0], kmax=dist.res.kmax)


def rank_legendre(dist: Distribution, iw: int, dtype: torch.dtype,
                  device) -> FullLegendre:
    """w-rank iw's full-n Legendre rows at the Gaussian latitudes: per
    group gi, pn (Lg, J, ig) with pn[j] the table row of m = perm[iw*ML +
    off + j] (zero for a pad row), as a ``FullLegendre`` whose groups sit
    at local rows [off, off + Lg)."""
    from ..ops import legendre_tablegen as tg

    res = dist.res
    ms = dist.perm[iw * dist.ML: (iw + 1) * dist.ML]
    return rank_groups(dist, rank_inputs(tg.host_inputs(res), ms, res.M,
                                         device), dtype)
