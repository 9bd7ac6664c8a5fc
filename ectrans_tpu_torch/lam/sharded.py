"""Distributed LAM bi-Fourier transforms over a (w, v) mesh of ranks.

Counterpart of ``ectrans_tpu/lam/sharded.py`` on ``torch.distributed``
(reference ``einv_trans_ctl_mod.F90``: ELTINV per local m -> TRMTOL ->
EFTINV per local latitude, with fields over the V-set):

  spectral (4-real packed)      this rank's v-block of fields, all columns
  -> meridional DFT on the w-rank's m-block
  -> all_to_all over "w"        (TRMTOL: m-distributed -> row-distributed)
  -> zonal DFT on the w-rank's rows
  -> all_to_all over "v"        (TRLTOG: gather fields, split rows further)
  grid (nfld, rows, nx)         this rank's block of R = ny_pad / (w*v) rows

The direct transform is the mirror, with the spectral gather as a masked
gather and an all_reduce over "w", and the mean wind from the w-rank that
owns m = 0.  Zonal wavenumbers are split in contiguous blocks, rows in
contiguous blocks.  Both FFT passes run in fp64 and round once, as in the
single-device ``lam.transform`` (in fp32 the passes miss the 100 eps round
trip gate at the 1.3 km domain), so the meridional result crosses TRMTOL
and TRLTOM in fp64.  No kernel runs here, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..field_layout import FieldLayout
from ..ops.fourier import analysis_uniform, synthesis_uniform
from ..ops.layout import gather_packed
from ..parallel import comm
from ..parallel.mesh import check_mesh
from ..parallel.sharded import (default_kvset, field_sets, group_perms,
                                kvset_slots, output_index, place,
                                slot_fields)
from ..resolution import check_dtype
from ..transform import _check_spec
from .resolution import LamResolution
from .transform import LamInvFlags, inv_groups, uv_to_vordiv_lam


class ShardedLamTransform:
    """Distributed LAM transforms on a (w, v) mesh: each rank's results are
    the JAX package's ``ShardedLamTransform``'s on its shards (and the
    single-device transform's, to rounding)."""

    def __init__(self, res: LamResolution, mesh, dtype=torch.float32):
        self.mesh = check_mesh(mesh)
        self.res = res
        self.dtype = check_dtype(dtype)
        self.device = mesh.device
        self.w, self.v = mesh.w, mesh.v
        g = res.grid
        self.M_pad = -(-res.M // self.w) * self.w
        self.ML = self.M_pad // self.w
        wv = self.w * self.v
        self.ny_pad = -(-g.ny // wv) * wv
        self.R = self.ny_pad // wv
        t = res.device_tables(self.dtype, self.device)
        m = slice(mesh.iw * self.ML, (mesh.iw + 1) * self.ML)

        def local(x, fill=0):   # (.., M, N) -> the w-rank's (.., ML, N)
            pad = [0, 0, 0, self.M_pad - res.M]
            return F.pad(x, pad, value=fill)[..., m, :]

        self.tables = {k: local(t[k]) for k in ("kx", "ky", "rlepinm",
                                                "valid")}
        self.tables["dense_gather"] = local(t["dense_gather"], res.nspec2)
        self.tables.update({k: t[k] for k in ("packed_c", "packed_m",
                                              "packed_n")})
        first = min(mesh.rank * self.R, g.ny)
        self.rows = (first, min(first + self.R, g.ny))
        self._spec0 = torch.zeros((0, res.nspec2), dtype=self.dtype,
                                  device=self.device)

    def _put(self, x):
        if x is None:
            return None
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    # -- inverse ------------------------------------------------------------
    def inv_trans(self, spvor=None, spdiv=None, spscalar=None, meanu=None,
                  meanv=None, flags: LamInvFlags = LamInvFlags()):
        """This rank's spectral fields (and the mean wind of its uv fields)
        -> its block of grid rows (nfld_out, nrows, nx), every field in the
        PGP order."""
        if (spvor is None) != (spdiv is None):
            raise ValueError("spvor and spdiv must be supplied together")
        for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                        ("spscalar", spscalar)):
            _check_spec(nm, arr, self.res)
        spvor, spdiv, spsc, meanu, meanv = map(
            self._put, (spvor, spdiv, spscalar, meanu, meanv))
        nloc = tuple(0 if x is None else x.shape[0] for x in (spvor, spsc))
        kvuv, kvsc = field_sets(self.mesh, nloc, (None, None),
                                ("spvor", "spscalar"))
        if not kvuv and not kvsc:
            raise ValueError("nothing to transform")
        sel, Fuv, Fsc = output_index(kvuv, kvsc, flags, self.v)
        t = self.tables

        def dense(x, n):
            return (gather_packed(place(x, n, self._spec0), t["dense_gather"])
                    if n else None)

        mean = (None, None)
        if self.mesh.iw == 0:   # the mean wind lives at (m=0, n=0)
            mean0 = torch.zeros((1,), dtype=self.dtype, device=self.device)
            mean = (place(meanu, Fuv, mean0), place(meanv, Fuv, mean0))
        groups = inv_groups(dense(spvor, Fuv), dense(spdiv, Fuv),
                            dense(spsc, Fsc), t, flags, *mean)
        work = torch.cat(groups).double()                 # (F, 4, ML, N)
        g = self.res.grid
        # meridional synthesis on the local m-block, in fp64
        z = torch.stack([synthesis_uniform(work[:, 0], work[:, 1], g.ny),
                         synthesis_uniform(work[:, 2], work[:, 3], g.ny)], 1)
        z = F.pad(z, (0, self.ny_pad - g.ny))             # (F, 2, ML, ny)
        z = comm.all_to_all(z, self.mesh.w_group, 3, 2, "TRMTOL")
        # zonal synthesis on the local rows: (F, rows, M) -> (F, rows, nx)
        M = self.res.M
        grid = synthesis_uniform(z[:, 0].transpose(1, 2)[..., :M],
                                 z[:, 1].transpose(1, 2)[..., :M],
                                 g.nx).to(self.dtype)
        grid = comm.all_to_all(grid, self.mesh.v_group, 1, 0, "TRLTOG")
        gsz = FieldLayout.inv(Fuv, Fsc, flags).sizes_padded
        _, inv_perm = group_perms([n * self.v for n in gsz], self.v)
        nrows = self.rows[1] - self.rows[0]
        idx = torch.as_tensor(inv_perm[sel], device=self.device)
        return grid[idx, :nrows].contiguous()

    # -- direct -------------------------------------------------------------
    def dir_trans(self, u=None, v=None, scalars=None):
        """This rank's block of grid rows of every field -> (spvor, spdiv,
        spscalar, meanu, meanv), this rank's v-block of each family; None
        where there was no input."""
        if (u is None) != (v is None):
            raise ValueError("u and v must be supplied together")
        if u is None and scalars is None:
            raise ValueError("nothing to transform")
        g = self.res.grid
        want = (self.rows[1] - self.rows[0], g.nx)
        for nm, arr in (("u", u), ("v", v), ("scalars", scalars)):
            if arr is not None and (arr.ndim != 3 or
                                    tuple(arr.shape[1:]) != want):
                raise ValueError(f"{nm} must have shape (nfld, {want[0]}, "
                                 f"{want[1]}) on this rank, got "
                                 f"{tuple(arr.shape)}")
        u, v, sc = map(self._put, (u, v, scalars))
        kvuv, kvsc = (default_kvset(0 if x is None else x.shape[0], self.v)
                      for x in (u, sc))
        slots_uv, Fuv = kvset_slots(kvuv, self.v)
        slots_sc, Fsc = kvset_slots(kvsc, self.v)
        grid = torch.cat([slot_fields(x, slots) for x, slots in
                          ((u, slots_uv), (v, slots_uv), (sc, slots_sc))
                          if len(slots)])
        grid = F.pad(grid, (0, 0, 0, self.R - grid.shape[1]))
        gsz = [n for n in (len(slots_uv), len(slots_uv), len(slots_sc)) if n]
        om, _ = group_perms(gsz, self.v)
        x = comm.all_to_all(grid[torch.as_tensor(om, device=self.device)],
                            self.mesh.v_group, 0, 1, "TRGTOL")
        # zonal analysis on the local rows, in fp64: (F, rows, M)
        zre, zim = analysis_uniform(x.double(), g.msmax)
        pad = (0, self.M_pad - self.res.M)
        z = torch.stack([F.pad(zre, pad).transpose(1, 2),
                         F.pad(zim, pad).transpose(1, 2)], 1)
        z = comm.all_to_all(z, self.mesh.w_group, 2, 3, "TRLTOM")
        z = z[..., : g.ny]                                # (F, 2, ML, ny)
        rr, ri = analysis_uniform(z[:, 0], g.nsmax)
        ir, ii = analysis_uniform(z[:, 1], g.nsmax)
        t = self.tables
        dense = torch.stack([rr, ri, ir, ii], 1).to(self.dtype) * t["valid"]
        out = []
        if Fuv:
            vor, div, mu, mv = uv_to_vordiv_lam(dense[:Fuv],
                                                dense[Fuv: 2 * Fuv], t)
            out += [vor, div]
        if Fsc:
            out.append(dense[2 * Fuv:])
        packed = self._gather_psum(torch.cat(out))
        nu, ns = kvuv.count(self.mesh.iv), kvsc.count(self.mesh.iv)
        spvor = spdiv = spsc = meanu = meanv = None
        if Fuv:
            own0 = float(self.mesh.iw == 0)
            mean = torch.stack([mu, mv]) * own0
            mean = comm.all_reduce_sum(mean, self.mesh.w_group, "mean")
            spvor, spdiv = packed[:nu], packed[Fuv: Fuv + nu]
            meanu, meanv = mean[0, :nu], mean[1, :nu]
        if Fsc:
            spsc = packed[2 * Fuv: 2 * Fuv + ns]
        return spvor, spdiv, spsc, meanu, meanv

    def _gather_psum(self, d: torch.Tensor) -> torch.Tensor:
        """The packed values of the m's this w-rank owns (zero elsewhere),
        summed over "w": the spectral gather."""
        t = self.tables
        mloc = t["packed_m"] - self.mesh.iw * self.ML
        owned = (mloc >= 0) & (mloc < self.ML)
        vals = d[:, t["packed_c"], mloc.clamp(0, self.ML - 1), t["packed_n"]]
        vals = torch.where(owned, vals, torch.zeros((), dtype=vals.dtype,
                                                    device=vals.device))
        return comm.all_reduce_sum(vals, self.mesh.w_group, "psum")

    # -- EDIST_GRID / EGATH_GRID and the spectral fields ---------------------
    def dist_grid(self, grid_global) -> torch.Tensor:
        """This rank's block of rows of a global (nfld, ny, nx) grid."""
        return self._put(torch.as_tensor(grid_global)[
            :, self.rows[0]: self.rows[1]])

    def gath_grid(self, grid) -> np.ndarray:
        """The global grid on every rank (a collective over the mesh)."""
        grid = self._put(grid)
        g = self.res.grid
        out = grid.new_zeros((grid.shape[0], g.ny, g.nx))
        out[:, self.rows[0]: self.rows[1]] = grid
        group = self.mesh.group if self.w * self.v > 1 else None
        return comm.all_reduce_sum(out, group, "gath").cpu().numpy()

    def dist_spec(self, spec_global) -> torch.Tensor:
        """This rank's v-block of the fields of a global (nfld, nspec2)
        array (or of a (nfld,) mean wind)."""
        x = torch.as_tensor(spec_global)
        kv = default_kvset(x.shape[0], self.v)
        own = [i for i, s in enumerate(kv) if s == self.mesh.iv]
        return self._put(x[own])

    def gath_spec(self, spec) -> np.ndarray:
        """The global fields from each v-rank's block (a collective over
        the v-line)."""
        spec = self._put(spec)
        (kv,) = field_sets(self.mesh, (spec.shape[0],), (None,), ("spec",))
        out = spec.new_zeros((len(kv),) + tuple(spec.shape[1:]))
        own = [i for i, s in enumerate(kv) if s == self.mesh.iv]
        out[torch.as_tensor(own, dtype=torch.int64, device=self.device)] = spec
        return comm.all_reduce_sum(out, self.mesh.v_group,
                                   "gath").cpu().numpy()

