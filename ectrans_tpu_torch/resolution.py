"""Per-resolution state: the counterpart of ``ectrans_tpu/resolution.py`` (the
reference's TPM modules and SETUP_TRANS, ``setup_trans.F90``).

Host precompute is numpy float64.  Device state is torch tensors made on
request for one (dtype, device) pair and cached on the Resolution itself:

* ``device_tables(dtype, device)``: the small per-resolution tables
  (index maps, weights, 1/(a cos), spectral-operator coefficients);
* ``full_legendre(dtype, device)``: the per-m-group full-n Legendre tables
  pn[m, j, i] = P̄_{m+j}^m(mu_i) streamed by the dense-row kernels, in a
  table dtype (float32, float64, or bfloat16 for the "bf16" tier).  Their
  source (``ECTRANS_TPU_TABLE_SOURCE``, ``table_source``): "device", the
  table-generator kernel K4 on a card (``ops.legendre_tablegen``, one
  launch for all groups, from a few MB of seeds instead of GiBs of host
  tables) and its plain version on the CPU; "host", the host tables
  (``parity_tables``: the native builder, or the on-disk legpol cache,
  ``cache.py``) rounded to the table dtype and copied one group at a time;
  "auto" (the default) is "device" on a card and "host" on the CPU;
* ``grouped_legendre(dtype, device)`` and ``planes_legendre(nplanes,
  device)``: the parity pairs of the "xla"/"pallas" engines and the bf16
  limb planes of the "planes" engine, both derived from those pn tables on
  the device (the cached ones, or else each group made anew and dropped),
  so every engine runs on the same tables.

Three knobs, read as the JAX package reads them: ``ECTRANS_TPU_LEG_GROUPS``
(the m-group count of the tables and of K3, ``leg_groups``; finer groups
tighten the staircase padding, which is what fits TCO2047 on one card;
meshes and the lat-lon tables keep ``default_leg_groups``),
``ECTRANS_TPU_TABLE_SOURCE`` and ``ECTRANS_TPU_FP64_TABLE_LIMIT`` (read at
setup: above it the host tables are fp32, unless fp64 is asked for).  The
table caches are keyed by the group count and the source.

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
from .legendre import eps_table
from .utils.timing import hook

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


def default_leg_groups(M: int) -> int:
    """The m-group count when ``ECTRANS_TPU_LEG_GROUPS`` is unset, and the
    fixed count of the mesh and the lat-lon tables: up to 16 groups of at
    least 8 m."""
    return max(1, min(16, M // 8))


def leg_groups(M: int) -> int:
    """The m-group count of the tables and of K3: ``ECTRANS_TPU_LEG_GROUPS``
    (a count of at least 1; ceil(M / count) m a group, so the groups number
    ceil(M / that)), else ``default_leg_groups``."""
    env = os.environ.get("ECTRANS_TPU_LEG_GROUPS")
    if not env:
        return default_leg_groups(M)
    n = int(env)
    if n < 1:
        raise ValueError(f"ECTRANS_TPU_LEG_GROUPS must be at least 1, got {n}")
    return n


TABLE_SOURCES = ("auto", "host", "device")


def table_source(device, source: str | None = None) -> str:
    """"host" or "device": ``source``, else ``ECTRANS_TPU_TABLE_SOURCE``
    ("auto" by default), with "auto" resolved by the device: K4 on a card,
    the host tables on the CPU."""
    src = source or os.environ.get("ECTRANS_TPU_TABLE_SOURCE") or "auto"
    if src not in TABLE_SOURCES:
        raise ValueError(f"table source must be one of {TABLE_SOURCES}, "
                         f"got {src!r}")
    if src == "auto":
        return "device" if torch.device(device).type == "cuda" else "host"
    return src


def fp64_table_limit() -> int:
    """``ECTRANS_TPU_FP64_TABLE_LIMIT`` (default 800): the largest nsmax
    whose host tables are built in fp64 at setup; above it they are fp32."""
    return int(os.environ.get("ECTRANS_TPU_FP64_TABLE_LIMIT", "800"))


def _dtype_name(dtype) -> str | None:
    if dtype is None or isinstance(dtype, str):
        return dtype
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


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
    # the host tables' dtype below fp64 requests (``fp64_table_limit``)
    host_table_dtype: Any = np.float64
    _cache: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    @property
    def nsmax(self) -> int:
        return self.grid.nsmax

    @property
    def ntmax(self) -> int:
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
        """Per-resolution cache of derived state (device tensors, plans);
        a miss is the span ``build.<the key's first item>``."""
        if key not in self._cache:
            name = key[0] if isinstance(key, tuple) else key
            with hook(f"build.{name}"):
                self._cache[key] = build()
        return self._cache[key]

    def legendre_groups(self, ngroups: int | None = None) -> tuple:
        """Contiguous m-groups (m0, m1, i0, J) shared by the Legendre tables
        and the packing kernel, ``ngroups`` of them (``leg_groups`` when
        None): each group is padded only to its own active latitude count
        ndglu(m0) and degree count J = 2*kg (the reference GPU backend's
        per-m GEMM offsets, ``sump_trans_mod.F90:273-298``)."""
        if ngroups is None:
            ngroups = leg_groups(self.M)
        return self.cached(("legendre_groups", ngroups),
                           lambda: self._groups(ngroups))

    def _groups(self, ngroups: int) -> tuple:
        M, ndgnh, nmax = self.M, self.ndgnh, self.nsmax + 1
        bs = -(-M // ngroups)
        out = []
        for m0 in range(0, M, bs):
            m1 = min(M, m0 + bs)
            ig = int(self.ndglu[m0])       # ndglu is non-increasing in m
            kg = (nmax - m0) // 2 + 1
            out.append((m0, m1, ndgnh - ig, 2 * kg))
        return tuple(out)

    def parity_tables(self, dtype=None) -> tuple[np.ndarray, np.ndarray]:
        """Host (psym, pasym), each (M, ndgnh, kmax): fp64 when ``dtype`` is
        float64, else in ``host_table_dtype`` (fp32 above
        ``ECTRANS_TPU_FP64_TABLE_LIMIT``, the JAX package's setup tables),
        from the on-disk legpol cache (``cache.load_parity_cached``:
        read-only memmaps) or built there.  Not kept: at TCO1279 they take
        8.4 GB in fp32."""
        from .cache import load_parity_cached

        want = (np.float64 if _dtype_name(dtype) == "float64"
                else self.host_table_dtype)
        nh = self.ndgnh
        psym, pasym, kmax = load_parity_cached(self.grid, self.mu[:nh],
                                               self.nmen[:nh], dtype=want)
        assert kmax == self.kmax
        return psym, pasym

    def host_full_legendre(self) -> list:
        """Per-group fp64 numpy tables pn (gm, J, ig) of the host table
        source (all of them at once; the table builds stream them)."""
        return [np.asarray(pn, np.float64) for pn in
                self._host_groups(torch.float64, leg_groups(self.M))]

    def _host_groups(self, dtype, ngroups: int):
        """Each group's host table pn (gm, J, ig), one at a time: the
        installed tables (``use_host_tables``), else interleaved from the
        host parity tables of ``parity_tables(dtype)``, in their dtype."""
        installed = [k for k in self._cache if k[0] == "host_pn"]
        if installed:
            if installed[0] != ("host_pn", ngroups):
                raise ValueError(f"host tables were installed for "
                                 f"{installed[0][1]} groups, not {ngroups}")
            yield from self._cache[installed[0]]
            return
        from .native import alloc_array

        psym, pasym = self.parity_tables(dtype)
        for m0, m1, i0, J in self.legendre_groups(ngroups):
            kg = J // 2
            pn = alloc_array((m1 - m0, J, self.ndgnh - i0), psym.dtype)
            pn[:, 0::2, :] = np.swapaxes(psym[m0:m1, i0:, :kg], 1, 2)
            pn[:, 1::2, :] = np.swapaxes(pasym[m0:m1, i0:, :kg], 1, 2)
            yield pn
            del pn

    def use_host_tables(self, pns) -> None:
        """Install given per-group tables as the host table source of the
        ``ECTRANS_TPU_LEG_GROUPS`` groups (used to run this package on
        exactly the tables of another implementation)."""
        ngroups = leg_groups(self.M)
        groups = self.legendre_groups(ngroups)
        if len(pns) != len(groups):
            raise ValueError(f"{len(pns)} tables for {len(groups)} groups")
        for pn, (m0, m1, i0, J) in zip(pns, groups):
            want = (m1 - m0, J, self.ndgnh - i0)
            if tuple(pn.shape) != want:
                raise ValueError(f"group m0={m0}: table shape {pn.shape} != {want}")
        self.drop_cached("host_pn")
        self._cache[("host_pn", ngroups)] = [np.array(p, np.float64)
                                             for p in pns]

    def _table_key(self, name: str, dtype, device, ngroups, source) -> tuple:
        """(name, dtype, device, group count, source) with the knobs
        resolved: the cache key of a table build."""
        device = canonical_device(device)
        return (name, dtype, str(device),
                leg_groups(self.M) if ngroups is None else ngroups,
                table_source(device, source))

    def _new_full_groups(self, dtype: torch.dtype, device: torch.device,
                         ngroups: int, source: str):
        """Each group's full-n table made anew on ``device``, one at a time:
        by K4 (one launch a group, bf16 written directly; its plain version
        on the CPU) from the "device" source, or from the host tables
        rounded to ``dtype`` and copied up (the JAX package's upload)."""
        groups = self.legendre_groups(ngroups)
        if source == "device":
            from .ops import legendre_tablegen as tg

            inp = tg._device_inputs(self, device)
            pns = (tg.gen_group(inp, m0, m1, J, i0, dtype)
                   for m0, m1, i0, J in groups)
        else:
            pns = (torch.from_numpy(pn).to(dtype).to(device)
                   for pn in self._host_groups(dtype, ngroups))
        for (m0, m1, i0, J), pn in zip(groups, pns):
            yield FullGroup(m0=m0, m1=m1, i0=i0, J=J, pn=pn)

    def _source_groups(self, dtype: torch.dtype, key: tuple):
        """The groups of the ``full_legendre`` of ``key`` (``_table_key``)
        if it is cached, else each group made anew and dropped after use: a
        derived table keeps no second copy of pn."""
        fl = self._cache.get(("full_legendre",) + key[1:])
        if fl is not None:
            return iter(fl.groups)
        return self._new_full_groups(dtype, torch.device(key[2]), *key[3:])

    def _build_full_legendre(self, dtype: torch.dtype, device: torch.device,
                             ngroups: int, source: str) -> FullLegendre:
        if source == "device":
            from .ops import legendre_tablegen as tg

            groups = self.legendre_groups(ngroups)
            pns = tg.gen_groups(tg._device_inputs(self, device), groups,
                                dtype)
            full = tuple(FullGroup(m0=m0, m1=m1, i0=i0, J=J, pn=pn)
                         for (m0, m1, i0, J), pn in zip(groups, pns))
        else:
            full = tuple(self._new_full_groups(dtype, device, ngroups,
                                               source))
        return FullLegendre(groups=full, ndgnh=self.ndgnh, kmax=self.kmax)

    def full_legendre(self, dtype=torch.float32, device="cpu",
                      ngroups: int | None = None,
                      source: str | None = None) -> FullLegendre:
        """Per-m-group full-n tables of table dtype ``dtype`` (float32,
        float64 or bfloat16) on ``device``, ``ngroups`` groups
        (``leg_groups`` when None), from ``source`` ("auto", "host",
        "device"; ``ECTRANS_TPU_TABLE_SOURCE`` when None): K4 in one launch
        for all groups, or the host tables copied up one group at a time."""
        dtype = check_table_dtype(dtype)
        key = self._table_key("full_legendre", dtype, device, ngroups, source)
        return self.cached(key, lambda: self._build_full_legendre(
            dtype, torch.device(key[2]), *key[3:]))

    def grouped_legendre(self, dtype=torch.float32, device="cpu",
                         ngroups: int | None = None,
                         source: str | None = None) -> GroupedLegendre:
        """Per-m-group parity tables for the "xla" and "pallas" engines, of
        table dtype ``dtype`` (as ``full_legendre``): psym[m, i, k] =
        pn[m, 2k, i], pasym[m, i, k] = pn[m, 2k+1, i] (counterpart of
        ``ectrans_tpu`` ``Resolution.grouped_legendre``, which builds them on
        the host).  Each is a view of rows zero-padded to a multiple of 4
        entries (``legendre_grouped.pad_rows``), which K5 and K6 copy 16
        bytes at a time."""
        from .ops.legendre_grouped import pad_rows

        dtype = check_table_dtype(dtype)
        key = self._table_key("grouped_legendre", dtype, device, ngroups,
                              source)

        def build():
            groups = tuple(
                LegendreGroup(m0=g.m0, m1=g.m1, i0=g.i0, kg=g.J // 2,
                              psym=pad_rows(g.pn[:, 0::2].transpose(1, 2)),
                              pasym=pad_rows(g.pn[:, 1::2].transpose(1, 2)))
                for g in self._source_groups(dtype, key))
            return GroupedLegendre(groups=groups, ndgnh=self.ndgnh,
                                   kmax=self.kmax)

        return self.cached(key, build)

    def planes_legendre(self, nplanes: int = 3, device="cpu",
                        ngroups: int | None = None,
                        source: str | None = None) -> PlanesLegendre:
        """Per-m-group bf16 limb planes of the fp32 tables for the "planes"
        engine: ``split_planes(pn)`` transposed to (gm, ig, J).  3 planes
        carry fp32 accuracy (6 bytes per entry); 1 plane is the "bf16" tier
        (2 bytes per entry).  Each plane is a view of rows zero-padded to a
        multiple of 8 entries (``legendre_grouped.pad_rows``), which K9 and
        K10 copy 16 bytes at a time."""
        from .ops.legendre_grouped import pad_rows

        key = self._table_key("planes_legendre", torch.float32, device,
                              ngroups, source)

        def build():
            from .ops.legendre_planes import split_planes

            groups = tuple(
                PlanesGroup(m0=g.m0, m1=g.m1, i0=g.i0, J=g.J,
                            pt=tuple(pad_rows(p.transpose(1, 2), 8)
                                     for p in split_planes(g.pn, nplanes)))
                for g in self._source_groups(torch.float32, key))
            return PlanesLegendre(groups=groups, ndgnh=self.ndgnh,
                                  kmax=self.kmax)

        return self.cached(key + (nplanes,), build)

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
                           ndglu, eps, racthe=None,
                           host_table_dtype=np.float64) -> Resolution:
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
        packed_gather_n=pn, host_table_dtype=np.dtype(host_table_dtype).type)


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
              f"(kmax={res.kmax}, ndgnh={res.ndgnh}, "
              f"{len(res.legendre_groups())} groups; host tables "
              f"{np.dtype(res.host_table_dtype).name}); radius={res.radius}",
              file=sys.stderr)
        print(f"  nloen: {g.nloen[0]}..{max(g.nloen)}; "
              f"nmen: {int(res.nmen[0])}..{int(res.nmen.max())}",
              file=sys.stderr)


_CURRENT: list = []  # most recently set up Resolutions (GET_CURRENT parity)
# every Resolution the setup cache made, to drop their state in trans_end
_MADE: weakref.WeakSet = weakref.WeakSet()
# callables that free state a higher layer caches outside the Resolutions
ON_TRANS_END: list = []


def get_current() -> Resolution | None:
    """Most recently set-up Resolution (reference GET_CURRENT,
    ``get_current.F90``); None before any setup."""
    return _CURRENT[-1] if _CURRENT else None


def trans_end() -> None:
    """Release every cached resolution and the tables, plans and index maps
    it caches on any device, and what the modules that registered in
    ``ON_TRANS_END`` keep beside them (reference TRANS_END,
    ``trans_end.F90``).  Resolutions held by a caller keep working: their
    state is made again on first use."""
    _CURRENT.clear()
    _setup_cached.cache_clear()
    for release in ON_TRANS_END:
        release()
    for res in list(_MADE):
        res.drop_cached()
    _MADE.clear()


def ini_spec_dist(nsmax: int, nprtrw: int) -> dict:
    """Spectral wave distribution without a full setup (reference
    INI_SPEC_DIST, ``ini_spec_dist.F90`` -> SUWAVEDI): boustrophedon
    assignment of zonal wavenumbers to nprtrw wave sets
    (``parallel.distribution.pingpong_blocks``).

    Returns a dict with ``myms`` (tuple of m-lists per set), ``numpp``
    (wavenumber count per set), ``nspec2`` (real-coefficient count per
    set), ``nasm0`` (global packed offsets) and ``nspec2_g``."""
    from .parallel.distribution import pingpong_blocks

    blocks = pingpong_blocks(nsmax + 1, nprtrw)
    nasm0 = build_packed_maps(nsmax)[0]
    return {
        "myms": tuple(tuple(b) for b in blocks),
        "numpp": tuple(len(b) for b in blocks),
        "nspec2": tuple(int(sum(2 * (nsmax - m + 1) for m in b))
                        for b in blocks),
        "nasm0": nasm0,
        "nspec2_g": (nsmax + 1) * (nsmax + 2),
    }


def setup(grid_or_name: Any, nsmax: int | None = None,
          radius: float = EARTH_RADIUS, stretch: float = 1.0) -> Resolution:
    """Build a Resolution (the SETUP_TRANS equivalent):
    ``setup("O48", 47)``, ``setup("TCO1279")`` or ``setup(GridSpec(...))``.

    Only O(ndgl + nspec2) host work happens here; the Legendre tables are
    made on first use by ``full_legendre`` for the device that needs them.
    ``ECTRANS_TPU_FP64_TABLE_LIMIT`` is read here: the host tables of a
    truncation above it are fp32 (``host_table_dtype``), unless a transform
    asks for fp64.
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
    res = resolution_from_arrays(
        grid, radius, mu, w, grid.nmen(), grid.ndglu(),
        eps_table(grid.nsmax, 3), host_table_dtype=(
            np.float64 if grid.nsmax <= fp64_table_limit() else np.float32))
    _MADE.add(res)
    return res
