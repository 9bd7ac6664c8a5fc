"""Per-resolution state: the counterpart of ``ectrans_tpu/resolution.py`` (the
reference's TPM modules and SETUP_TRANS, ``setup_trans.F90``).

Host precompute is numpy float64.  Device state is torch tensors made on
request for one (dtype, device) pair and cached on the Resolution itself:

* ``device_tables(dtype, device)``: the small per-resolution tables
  (index maps, weights, 1/(a cos), spectral-operator coefficients);
* ``full_legendre(dtype, device)``: the per-m-group full-n Legendre tables
  pn[m, j, i] = P̄_{m+j}^m(mu_i) streamed by the dense-row kernels, in a
  table dtype (float32, float64, or bfloat16 for the "bf16" tier).  On a
  CUDA device they are generated on the card by the table-generator kernel
  (``ops.legendre_tablegen``, one launch for all groups, from a few MB of
  seeds instead of GiBs of host tables); on the CPU they come from the
  host fp64 recurrence, built only when asked for;
* ``grouped_legendre(dtype, device)`` and ``planes_legendre(nplanes,
  device)``: the parity pairs of the "xla"/"pallas" engines and the bf16
  limb planes of the "planes" engine, both derived from those pn tables on
  the device (the cached ones, or else each group made anew and dropped),
  so every engine runs on the same tables.

Spectral layouts (as in the JAX package): **packed** (nfld, nspec2), m-major,
n ascending, (re, im) interleaved at offsets NASM0 (``suwavedi_mod.F90``);
**dense** (nfld, 2, M, NP), absolute n = 0..nsmax+1 (zero where n < m).
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
import weakref
from typing import Any, Callable

import numpy as np
import torch

from .grids import GridSpec, make_grid
from .legendre import build_parity_tables, eps_table

EARTH_RADIUS = 6371229.0  # metres; reference default RA (setup_trans0.F90)

_FLOATS = (torch.float32, torch.float64)
_TABLE_DTYPES = _FLOATS + (torch.bfloat16,)


def check_dtype(dtype) -> torch.dtype:
    """The working dtypes of this package: float32 and float64."""
    if dtype not in _FLOATS:
        raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    return dtype


def check_table_dtype(dtype) -> torch.dtype:
    """The Legendre table dtypes: the working dtypes, and bfloat16 (the
    "bf16" tier's tables, which take fp32 operands)."""
    if dtype not in _TABLE_DTYPES:
        raise TypeError("table dtype must be torch.float32, torch.float64 or "
                        f"torch.bfloat16, got {dtype}")
    return dtype


def canonical_device(device) -> torch.device:
    """torch.device with an explicit index for CUDA (cache keys)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class FullGroup:
    """One contiguous m-group of the full-n table: pn (m1-m0, J, ndgnh-i0),
    pn[m-m0, j, i-i0] = P̄_{m+j}^m(mu_i), exactly 0 for m+j > nsmax+1 and
    where m > nmen(lat)."""

    m0: int
    m1: int
    i0: int     # first active NH latitude (= ndgnh - ndglu(m0))
    J: int      # 2 * kg rows: degrees n = m .. m+J-1
    pn: torch.Tensor


@dataclasses.dataclass(frozen=True)
class FullLegendre:
    groups: tuple
    ndgnh: int
    kmax: int


@dataclasses.dataclass(frozen=True)
class LegendreGroup:
    """One contiguous m-group of the parity tables ("xla"/"pallas"
    engines): psym, pasym (m1-m0, ndgnh-i0, kg) with psym[m, i, k] =
    P̄_{m+2k}^m(mu_i) and pasym[m, i, k] = P̄_{m+2k+1}^m(mu_i)."""

    m0: int
    m1: int
    i0: int     # first active NH latitude (= ndgnh - ndglu(m0))
    kg: int     # parity extent of the group (J / 2)
    psym: torch.Tensor
    pasym: torch.Tensor


@dataclasses.dataclass(frozen=True)
class GroupedLegendre:
    groups: tuple
    ndgnh: int
    kmax: int


@dataclasses.dataclass(frozen=True)
class PlanesGroup:
    """One contiguous m-group of bf16 limb planes ("planes" engine): pt[k]
    (m1-m0, ndgnh-i0, J), the transposed layout shared by both directions,
    in rows padded to a multiple of 8 entries; sum_k pt[k] is the fp32
    table exactly at 3 planes."""

    m0: int
    m1: int
    i0: int
    J: int
    pt: tuple


@dataclasses.dataclass(frozen=True)
class PlanesLegendre:
    groups: tuple
    ndgnh: int
    kmax: int


@dataclasses.dataclass(frozen=True)
class DeviceTables:
    """Small per-resolution tensors on one device (the FG state of the
    reference GPU backend, ``tpm_fields_gpu.F90``)."""

    nasm0: torch.Tensor         # (M,) int64 packed offset of (m, n=m, re)
    dense_gather: torch.Tensor  # (2, M, NP) int64 index into [packed | 0]
    w: torch.Tensor             # (ndgl,) Gaussian weights
    racthe: torch.Tensor        # (ndgl,) 1 / (a cos(theta))
    vd: dict                    # VDTUV coefficients (ops.spectral)
    nsd: dict                   # SPNSDE coefficients
    uvtvd: dict                 # UVTVD coefficients, dense (M, NP)
    uvtvd_mm: dict              # UVTVD coefficients, m-major realigned


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: ndarray fields
class Resolution:
    """Everything needed to transform at one (grid, truncation) resolution."""

    grid: GridSpec
    radius: float
    mu: np.ndarray          # (ndgl,) sin(lat), north -> south
    w: np.ndarray           # (ndgl,) Gaussian weights, sum = 1
    nmen: np.ndarray        # (ndgl,) per-lat zonal truncation
    ndglu: np.ndarray       # (M,) NH lats active per m
    eps: np.ndarray         # (M, NP+2) eps(n, m)
    rlapin: np.ndarray      # (NP+1,) -a^2/(n(n+1)), 0 at n=0
    racthe: np.ndarray      # (ndgl,) 1/(a cos(theta))
    nasm0: np.ndarray       # (M,) offset of (m, n=m, re) in packed layout
    dense_gather: np.ndarray     # (2, M, NP) index into packed, nspec2 = zero slot
    packed_gather_c: np.ndarray  # (nspec2,) re (0) / im (1) of each packed value
    packed_gather_m: np.ndarray  # (nspec2,) m of each packed value
    packed_gather_n: np.ndarray  # (nspec2,) n of each packed value
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    @property
    def nsmax(self) -> int:
        return self.grid.nsmax

    @property
    def M(self) -> int:
        return self.grid.nsmax + 1

    @property
    def NP(self) -> int:
        """Dense n-rows: n = 0 .. nsmax+1 (u/v spectra extend to nsmax+1)."""
        return self.grid.nsmax + 2

    @property
    def ndgl(self) -> int:
        return self.grid.ndgl

    @property
    def ndgnh(self) -> int:
        return self.grid.ndgnh

    @property
    def nspec2(self) -> int:
        return self.grid.nspec2

    @property
    def kmax(self) -> int:
        """Parity extent K of the (nsmax+1)-degree tables."""
        return (self.nsmax + 3) // 2

    def cached(self, key, build: Callable[[], Any]):
        """Per-resolution cache of derived state (device tensors, plans)."""
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def legendre_groups(self) -> tuple:
        """Contiguous m-groups (m0, m1, i0, J) shared by the Legendre tables
        and the packing kernel: each group is padded only to its own active
        latitude count ndglu(m0) and degree count J = 2*kg (the reference
        GPU backend's per-m GEMM offsets, ``sump_trans_mod.F90:273-298``)."""
        M, ndgnh, nmax = self.M, self.ndgnh, self.nsmax + 1
        ngroups = max(1, min(16, M // 8))
        bs = -(-M // ngroups)
        out = []
        for gi in range(ngroups):
            m0 = gi * bs
            if m0 >= M:
                break
            m1 = min(M, m0 + bs)
            ig = int(self.ndglu[m0])       # ndglu is non-increasing in m
            kg = (nmax - m0) // 2 + 1
            out.append((m0, m1, ndgnh - ig, 2 * kg))
        return tuple(out)

    def parity_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """Host fp64 (psym, pasym), each (M, ndgnh, kmax).  Built on every
        call and not kept: at TCO1279 they take ~17 GB."""
        nh = self.ndgnh
        psym, pasym, kmax = build_parity_tables(
            self.nsmax, self.mu[:nh], 1, self.nmen[:nh])
        assert kmax == self.kmax
        return psym, pasym

    def host_full_legendre(self) -> list:
        """Per-group fp64 numpy tables pn (gm, J, ig): the host table source."""
        return self.cached(("host_pn",), self._build_host_pn)

    def _build_host_pn(self) -> list:
        psym, pasym = self.parity_tables()
        pns = []
        for m0, m1, i0, J in self.legendre_groups():
            kg = J // 2
            pn = np.empty((m1 - m0, J, self.ndgnh - i0))
            pn[:, 0::2, :] = np.swapaxes(psym[m0:m1, i0:, :kg], 1, 2)
            pn[:, 1::2, :] = np.swapaxes(pasym[m0:m1, i0:, :kg], 1, 2)
            pns.append(pn)
        return pns

    def use_host_tables(self, pns) -> None:
        """Install given per-group tables as the host table source (used to
        run this package on exactly the tables of another implementation)."""
        groups = self.legendre_groups()
        if len(pns) != len(groups):
            raise ValueError(f"{len(pns)} tables for {len(groups)} groups")
        for pn, (m0, m1, i0, J) in zip(pns, groups):
            want = (m1 - m0, J, self.ndgnh - i0)
            if tuple(pn.shape) != want:
                raise ValueError(f"group m0={m0}: table shape {pn.shape} != {want}")
        self._cache[("host_pn",)] = [np.array(p, np.float64) for p in pns]

    def _new_full_groups(self, dtype: torch.dtype, device: torch.device):
        """Each group's full-n table made anew on ``device``, one at a time:
        by the table kernel (K4, one launch a group, bf16 written directly)
        on a GPU, from the host fp64 build on the CPU (the fp64 values
        rounded as the JAX package's host tables are)."""
        groups = self.legendre_groups()
        if device.type == "cuda":
            from .ops import legendre_tablegen as tg

            inp = tg._device_inputs(self, device)
            pns = (tg.gen_group(inp, m0, m1, J, i0, dtype)
                   for m0, m1, i0, J in groups)
        elif device.type == "cpu":
            pns = (torch.from_numpy(pn).to(dtype)
                   for pn in self.host_full_legendre())
        else:
            raise ValueError(f"unsupported device {device}")
        for (m0, m1, i0, J), pn in zip(groups, pns):
            yield FullGroup(m0=m0, m1=m1, i0=i0, J=J, pn=pn)

    def _source_groups(self, dtype: torch.dtype, device: torch.device):
        """The groups of ``full_legendre(dtype, device)`` if it is cached,
        else each group made anew and dropped after use: a derived table
        keeps no second copy of pn."""
        fl = self._cache.get(("full_legendre", dtype, str(device)))
        if fl is not None:
            return iter(fl.groups)
        return self._new_full_groups(dtype, device)

    def _build_full_legendre(self, dtype: torch.dtype,
                             device: torch.device) -> FullLegendre:
        groups = self.legendre_groups()
        if device.type == "cuda":
            from .ops import legendre_tablegen as tg

            pns = tg.gen_groups(tg._device_inputs(self, device), groups,
                                dtype)
            full = tuple(FullGroup(m0=m0, m1=m1, i0=i0, J=J, pn=pn)
                         for (m0, m1, i0, J), pn in zip(groups, pns))
        else:
            full = tuple(self._new_full_groups(dtype, device))
        return FullLegendre(groups=full, ndgnh=self.ndgnh, kmax=self.kmax)

    def full_legendre(self, dtype=torch.float32, device="cpu") -> FullLegendre:
        """Per-m-group full-n tables of table dtype ``dtype`` (float32,
        float64 or bfloat16) on ``device``: generated by the CUDA table
        kernel on a GPU (one launch for all groups), copied from the host
        fp64 build on the CPU."""
        dtype = check_table_dtype(dtype)
        device = canonical_device(device)
        return self.cached(("full_legendre", dtype, str(device)),
                           lambda: self._build_full_legendre(dtype, device))

    def grouped_legendre(self, dtype=torch.float32,
                         device="cpu") -> GroupedLegendre:
        """Per-m-group parity tables for the "xla" and "pallas" engines, of
        table dtype ``dtype`` (as ``full_legendre``): psym[m, i, k] =
        pn[m, 2k, i], pasym[m, i, k] = pn[m, 2k+1, i] (counterpart of
        ``ectrans_tpu`` ``Resolution.grouped_legendre``, which builds them on
        the host).  Each is a view of rows zero-padded to a multiple of 4
        entries (``legendre_grouped.pad_rows``), which K5 and K6 copy 16
        bytes at a time."""
        from .ops.legendre_grouped import pad_rows

        dtype = check_table_dtype(dtype)
        device = canonical_device(device)

        def build():
            groups = tuple(
                LegendreGroup(m0=g.m0, m1=g.m1, i0=g.i0, kg=g.J // 2,
                              psym=pad_rows(g.pn[:, 0::2].transpose(1, 2)),
                              pasym=pad_rows(g.pn[:, 1::2].transpose(1, 2)))
                for g in self._source_groups(dtype, device))
            return GroupedLegendre(groups=groups, ndgnh=self.ndgnh,
                                   kmax=self.kmax)

        return self.cached(("grouped_legendre", dtype, str(device)), build)

    def planes_legendre(self, nplanes: int = 3,
                        device="cpu") -> PlanesLegendre:
        """Per-m-group bf16 limb planes of the fp32 tables for the "planes"
        engine: ``split_planes(pn)`` transposed to (gm, ig, J).  3 planes
        carry fp32 accuracy (6 bytes per entry); 1 plane is the "bf16" tier
        (2 bytes per entry).  Each plane is a view of rows zero-padded to a
        multiple of 8 entries (``legendre_grouped.pad_rows``), which K9 and
        K10 copy 16 bytes at a time."""
        from .ops.legendre_grouped import pad_rows

        device = canonical_device(device)

        def build():
            from .ops.legendre_planes import split_planes

            groups = tuple(
                PlanesGroup(m0=g.m0, m1=g.m1, i0=g.i0, J=g.J,
                            pt=tuple(pad_rows(p.transpose(1, 2), 8)
                                     for p in split_planes(g.pn, nplanes)))
                for g in self._source_groups(torch.float32, device))
            return PlanesLegendre(groups=groups, ndgnh=self.ndgnh,
                                  kmax=self.kmax)

        return self.cached(("planes_legendre", nplanes, str(device)), build)

    def drop_cached(self, name: str | None = None) -> None:
        """Free the cached state called ``name`` ("full_legendre",
        "grouped_legendre", "planes_legendre", ...) on every device; all
        of it (tables, plans, index maps) when ``name`` is None."""
        for key in [k for k in self._cache if name is None or k[0] == name]:
            del self._cache[key]

    def device_tables(self, dtype=torch.float32, device="cpu") -> DeviceTables:
        dtype = check_dtype(dtype)
        device = canonical_device(device)

        def build():
            from .ops import spectral

            f = lambda x: torch.tensor(np.asarray(x, np.float64),
                                       dtype=dtype, device=device)
            i = lambda x: torch.tensor(np.asarray(x, np.int64), device=device)
            fd = lambda d: {k: f(v) for k, v in d.items()}
            return DeviceTables(
                nasm0=i(self.nasm0),
                dense_gather=i(self.dense_gather),
                w=f(self.w),
                racthe=f(self.racthe),
                vd=fd(spectral.vordiv_coeff_tables(self)),
                nsd=fd(spectral.nsder_coeff_tables(self)),
                uvtvd=fd(spectral.uvtvd_coeff_tables(self)),
                uvtvd_mm=fd(spectral.uvtvd_coeff_tables_mmajor(self)),
            )

        return self.cached(("device_tables", dtype, str(device)), build)


def build_packed_maps(nsmax: int):
    """Index maps between the packed (NASM0) and dense (c, m, n) layouts:
    (nasm0, dense_gather, c, m, n) with dense_gather pointing at the extra
    zero slot nspec2 outside m <= n <= nsmax."""
    M = nsmax + 1
    NP = nsmax + 2
    lens = 2 * (nsmax + 1 - np.arange(M, dtype=np.int64))
    nasm0 = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    nspec2 = int(lens.sum())
    pm = np.repeat(np.arange(M, dtype=np.int64), lens)
    off = np.arange(nspec2, dtype=np.int64) - nasm0[pm]
    pc = off & 1
    pn = pm + (off >> 1)
    dense_gather = np.full((2, M, NP), nspec2, dtype=np.int64)
    dense_gather[pc, pm, pn] = np.arange(nspec2, dtype=np.int64)
    return nasm0, dense_gather, pc, pm, pn


def resolution_from_arrays(grid: GridSpec, radius: float, mu, w, nmen,
                           ndglu, eps, racthe=None) -> Resolution:
    """Resolution from its host arrays; the derived maps are rebuilt, and
    racthe from mu when it is not given."""
    nsmax = grid.nsmax
    NP = nsmax + 2
    mu = np.asarray(mu, np.float64)
    n_arr = np.arange(NP + 1, dtype=np.float64)
    with np.errstate(divide="ignore"):
        rlapin = np.where(n_arr > 0,
                          -(radius * radius) / (n_arr * (n_arr + 1.0)), 0.0)
    if racthe is None:
        costh = np.sqrt(np.maximum(1e-300, 1.0 - mu * mu))
        racthe = 1.0 / costh / radius
    nasm0, dense_gather, pc, pm, pn = build_packed_maps(nsmax)
    return Resolution(
        grid=grid, radius=float(radius), mu=mu,
        w=np.asarray(w, np.float64), nmen=np.asarray(nmen, np.int32),
        ndglu=np.asarray(ndglu, np.int32), eps=np.asarray(eps, np.float64),
        rlapin=rlapin, racthe=np.asarray(racthe, np.float64), nasm0=nasm0,
        dense_gather=dense_gather, packed_gather_c=pc, packed_gather_m=pm,
        packed_gather_n=pn)


def printlev() -> int:
    """Verbosity level (the reference NPRINTLEV, ``tpm_gen.F90``): 0 silent
    (default), 1 setup banners, 2 detailed tables.  Set via
    ECTRANS_TPU_PRINTLEV."""
    try:
        return int(os.environ.get("ECTRANS_TPU_PRINTLEV", "0"))
    except ValueError:
        return 0


def _setup_banner(res: Resolution) -> None:
    """Setup banner at NPRINTLEV >= 1 (reference setup_trans0.F90:115-153).
    The tables are made on first use for a device, so level 2 gives their
    size on one device in fp32 (the full-n tables of ``full_legendre``)."""
    from . import __version__

    g = res.grid
    print(f"ectrans_tpu_torch {__version__}: setup T{res.nsmax} "
          f"ndgl={res.ndgl} ndlon={g.ndlon} ngptot={g.ngptot} "
          f"nspec2={res.nspec2}", file=sys.stderr)
    if printlev() >= 2:
        entries = sum((m1 - m0) * J * (res.ndgnh - i0)
                      for m0, m1, i0, J in res.legendre_groups())
        print(f"  legendre tables: {4 * entries / 1e9:.2f} GB in fp32 "
              f"(kmax={res.kmax}, ndgnh={res.ndgnh}); radius={res.radius}",
              file=sys.stderr)
        print(f"  nloen: {g.nloen[0]}..{max(g.nloen)}; "
              f"nmen: {int(res.nmen[0])}..{int(res.nmen.max())}",
              file=sys.stderr)


_CURRENT: list = []  # most recently set up Resolutions (GET_CURRENT parity)
# every Resolution the setup cache made, to drop their state in trans_end
_MADE: weakref.WeakSet = weakref.WeakSet()


def get_current() -> Resolution | None:
    """Most recently set-up Resolution (reference GET_CURRENT,
    ``get_current.F90``); None before any setup."""
    return _CURRENT[-1] if _CURRENT else None


def trans_end() -> None:
    """Release every cached resolution and the tables, plans and index maps
    it caches on any device (reference TRANS_END, ``trans_end.F90``).
    Resolutions held by a caller keep working: their state is made again
    on first use."""
    _CURRENT.clear()
    _setup_cached.cache_clear()
    for res in list(_MADE):
        res.drop_cached()
    _MADE.clear()


def setup(grid_or_name: Any, nsmax: int | None = None,
          radius: float = EARTH_RADIUS, stretch: float = 1.0) -> Resolution:
    """Build a Resolution (the SETUP_TRANS equivalent):
    ``setup("O48", 47)``, ``setup("TCO1279")`` or ``setup(GridSpec(...))``.

    Only O(ndgl + nspec2) host work happens here; the Legendre tables are
    made on first use by ``full_legendre`` for the device that needs them.
    The Resolution is cached on (grid, radius, stretch), so every caller of
    the same configuration shares it and its tables until ``trans_end``.

    ``stretch`` is the Schmidt stretching factor c (reference PSTRET,
    ``setup_trans.F90:49``): when != 1 the Legendre polynomials are
    evaluated at the stretched latitudes mu' = (t + mu)/(1 + t*mu),
    t = (1 - c^2)/(1 + c^2) (``suleg_mod.F90:272-287``), and 1/(a cos)
    follows them, while the Gaussian weights stay those of the
    computational sphere.
    """
    if isinstance(grid_or_name, GridSpec):
        grid = grid_or_name
    else:
        grid = make_grid(grid_or_name, nsmax)
    res = _setup_cached(grid, float(radius), float(stretch))
    if not _CURRENT or _CURRENT[-1] is not res:
        _CURRENT.append(res)
        del _CURRENT[:-4]  # keep a short history only
        if printlev() >= 1:
            _setup_banner(res)
    return res


@functools.lru_cache(maxsize=16)
def _setup_cached(grid: GridSpec, radius: float, stretch: float) -> Resolution:
    mu, w = grid.gauss()
    if abs(stretch - 1.0) > 1e-13:
        t = (1.0 - stretch**2) / (1.0 + stretch**2)
        north = mu[: grid.ndgnh]
        mu = np.concatenate([(t + north) / (1.0 + t * north),
                             ((t - north) / (1.0 - t * north))[::-1]])
    res = resolution_from_arrays(grid, radius, mu, w, grid.nmen(),
                                 grid.ndglu(), eps_table(grid.nsmax, 3))
    _MADE.add(res)
    return res
