"""Per-resolution state: the counterpart of ``ectrans_tpu/resolution.py`` (the
reference's TPM modules and SETUP_TRANS, ``setup_trans.F90``).

Host precompute is numpy float64.  Device state is torch tensors made on
request for one (dtype, device) pair and cached on the Resolution itself:

* ``device_tables(dtype, device)``: the small per-resolution tables
  (index maps, weights, 1/(a cos), spectral-operator coefficients);
* ``full_legendre(dtype, device)``: the per-m-group full-n Legendre tables
  pn[m, j, i] = P̄_{m+j}^m(mu_i) streamed by the dense-row kernels.  On a
  CUDA device they are generated on the card by the table-generator kernel
  (``ops.legendre_tablegen``, a few MB of seeds instead of GiBs of host
  tables); on the CPU they come from the host fp64 recurrence, built only
  when asked for;
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
from typing import Any, Callable

import numpy as np
import torch

from .grids import GridSpec, make_grid
from .legendre import build_parity_tables, eps_table

EARTH_RADIUS = 6371229.0  # metres; reference default RA (setup_trans0.F90)

_FLOATS = (torch.float32, torch.float64)


def check_dtype(dtype) -> torch.dtype:
    """The working dtypes of this package: float32 and float64."""
    if dtype not in _FLOATS:
        raise TypeError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
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
    (m1-m0, ndgnh-i0, J), the transposed layout shared by both directions;
    sum_k pt[k] is the fp32 table exactly at 3 planes."""

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
        by the table kernel (K4) on a GPU, from the host fp64 build on the
        CPU."""
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

    def full_legendre(self, dtype=torch.float32, device="cpu") -> FullLegendre:
        """Per-m-group full-n tables on ``device``: generated by the CUDA
        table kernel on a GPU, copied from the host fp64 build on the CPU."""
        dtype = check_dtype(dtype)
        device = canonical_device(device)
        return self.cached(
            ("full_legendre", dtype, str(device)),
            lambda: FullLegendre(
                groups=tuple(self._new_full_groups(dtype, device)),
                ndgnh=self.ndgnh, kmax=self.kmax))

    def grouped_legendre(self, dtype=torch.float32,
                         device="cpu") -> GroupedLegendre:
        """Per-m-group parity tables for the "xla" and "pallas" engines:
        psym[m, i, k] = pn[m, 2k, i], pasym[m, i, k] = pn[m, 2k+1, i]
        (counterpart of ``ectrans_tpu`` ``Resolution.grouped_legendre``,
        which builds them on the host)."""
        dtype = check_dtype(dtype)
        device = canonical_device(device)

        def build():
            groups = tuple(
                LegendreGroup(m0=g.m0, m1=g.m1, i0=g.i0, kg=g.J // 2,
                              psym=g.pn[:, 0::2].transpose(1, 2).contiguous(),
                              pasym=g.pn[:, 1::2].transpose(1, 2).contiguous())
                for g in self._source_groups(dtype, device))
            return GroupedLegendre(groups=groups, ndgnh=self.ndgnh,
                                   kmax=self.kmax)

        return self.cached(("grouped_legendre", dtype, str(device)), build)

    def planes_legendre(self, nplanes: int = 3,
                        device="cpu") -> PlanesLegendre:
        """Per-m-group bf16 limb planes of the fp32 tables for the "planes"
        engine: ``split_planes(pn)`` transposed to (gm, ig, J).  3 planes
        carry fp32 accuracy (6 bytes per entry); 1 plane is the "bf16" tier
        (2 bytes per entry)."""
        device = canonical_device(device)

        def build():
            from .ops.legendre_planes import split_planes

            groups = tuple(
                PlanesGroup(m0=g.m0, m1=g.m1, i0=g.i0, J=g.J,
                            pt=tuple(p.transpose(1, 2).contiguous()
                                     for p in split_planes(g.pn, nplanes)))
                for g in self._source_groups(torch.float32, device))
            return PlanesLegendre(groups=groups, ndgnh=self.ndgnh,
                                  kmax=self.kmax)

        return self.cached(("planes_legendre", nplanes, str(device)), build)

    def drop_cached(self, name: str) -> None:
        """Free the cached state called ``name`` ("full_legendre",
        "grouped_legendre", "planes_legendre", ...) on every device."""
        for key in [k for k in self._cache if k[0] == name]:
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
    """Resolution from its host arrays; the derived maps are rebuilt."""
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


def setup(grid_or_name: Any, nsmax: int | None = None,
          radius: float = EARTH_RADIUS) -> Resolution:
    """Build a Resolution (the SETUP_TRANS equivalent):
    ``setup("O48", 47)``, ``setup("TCO1279")`` or ``setup(GridSpec(...))``.

    Only O(ndgl + nspec2) host work happens here; the Legendre tables are
    made on first use by ``full_legendre`` for the device that needs them.
    """
    if isinstance(grid_or_name, GridSpec):
        grid = grid_or_name
    else:
        grid = make_grid(grid_or_name, nsmax)
    mu, w = grid.gauss()
    return resolution_from_arrays(grid, radius, mu, w, grid.nmen(),
                                  grid.ndglu(), eps_table(grid.nsmax, 3))
