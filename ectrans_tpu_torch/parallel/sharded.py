"""Distributed spectral transforms over a (w, v) mesh of ranks.

Counterpart of ``ectrans_tpu/parallel/sharded.py``, on ``torch.distributed``:
the JAX package runs one ``shard_map`` program over a device mesh from one
controller; here every rank of the mesh runs this class on its own shards,
and the four transpositions of the reference are the collectives of
``comm.py``:

  reference                          here
  ---------------------------------- -----------------------------------------
  TRMTOL  (m-distributed -> lat)     all_to_all over "w": split lat, concat m
  TRLTOM  (lat -> m-distributed)     all_to_all over "w": split m, concat lat
  TRLTOG  (lat -> grid columns)      all_to_all over "v": split lat, concat fld
  TRGTOL  (grid columns -> lat)      all_to_all over "v": split fld, concat lat
  UPDSP + spectral gather            K3 on zero-filled rows + all_reduce over "w"

(reference ``trmtol_mod.F90:101-127``, ``trltog_mod.F90``).

Data on the rank at (iw, iv), as the JAX package places it on device (iw, iv):

* spectral: the rank's v-block of fields (``kvsetuv``/``kvsetsc``, the
  reference's KVSET: which v-rank owns each field; by default contiguous
  blocks of ceil(n / v) fields), all nspec2 columns, the same on every
  w-rank;
* wave space: (fields, 2, ML, ...) — the w-rank's m's, permuted and padded
  (``distribution.build_distribution``);
* Fourier space: (fields, 2, M, LL) — the w-rank's latitude slots of
  ``lat_perm`` (length-sorted, dealt round-robin);
* grid space: all fields and the rank's block of pole-to-pole latitude
  rows, ``nfrstlat..nlstlat`` of ``SpectralTransform.inquire()``.  Inside
  the pipeline the rank holds latitude slots r*LLg .. (r+1)*LLg - 1 of
  ``lat_perm``; one uneven exchange over the mesh (``comm.exchange``) moves
  rows between the two at the boundary, where the JAX package gathers with
  ``lat_pos`` on the sharded array.

The Legendre engine: "dense" (K1/K2 on the rank's rows of every group, K3
before the all_reduce) for fp32 and bf16 tables when ``engine()`` is
"dense"; every other engine and fp64 run the grouped einsums of the "xla"
engine (each fp32 contraction as one fp64 einsum).  "pallas" and "planes"
have no sharded form, as in the JAX package.  ``ECTRANS_TPU_PACK_KERNEL=xla``
sends the "dense" engine's packing through the masked gather.  The Fourier
layer is the bucketed chirp-z one of ``ops.fourier`` on the rank's latitude
slots (``distribution.rank_fourier``: ``ECTRANS_TPU_FFT_BUCKETS`` ranges of
local slots, each one convolution length shared by every w-rank), as in
the JAX package.

Every public method is collective: each rank of the mesh calls it with its
own shards and the same field counts, flags and KVSET vectors.  Given the
KVSET vectors, a call makes no host synchronisation: its index tensors
are made once and kept (``_idx``), and the collectives are enqueued on the
device (NCCL) without the host waiting for them.

Spans (``utils.timing.hook``, while the recorder is on): ``api.inv_trans``,
``api.dir_trans``, ``spectral``, ``legendre`` and ``fourier`` as on one
device, the transpositions ``trmtol``, ``trltom``, ``trltog``, ``trgtol``,
``updsp`` (the all_reduce over "w" after the packing), ``boundary`` (the
uneven latitude exchange), and ``dist_grid``, ``gath_grid``, ``dist_spec``,
``gath_spec`` for their rooted forms; the bytes a rank sends are the
recorder's ``sent.<tag>`` counters (``comm``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..field_layout import FieldLayout
from ..ops import fourier, layout, legendre_dense, legendre_matmul, pack
from ..ops import spectral
from ..resolution import (GroupedLegendre, LegendreGroup, Resolution,
                          check_dtype, default_leg_groups)
from ..transform import (InvFlags, _check_precision, _check_spec,
                         _table_dtype, fsc, legendre_inputs)
from ..utils.timing import hook
from . import comm
from .distribution import (build_distribution, rank_fourier, rank_groups,
                           rank_inputs, rank_legendre, rank_tables)
from .mesh import check_mesh


def default_kvset(n: int, v: int) -> list:
    """The default field ownership: contiguous blocks of ceil(n / v)
    fields (the JAX package's P("v") split of the fields padded to a
    multiple of v)."""
    c = max(1, -(-n // v))
    return [min(i // c, v - 1) for i in range(n)]


def kvset_slots(kvset, v: int):
    """KVSETUV/KVSETSC (``inv_trans.F90:43-55``): per-field v-rank ->
    (slots, maxc), slots[j] = field at padded slot j, -1 for padding;
    v-rank s owns slots [s*maxc, (s+1)*maxc), its fields in order."""
    kvset = [int(x) for x in kvset]
    if any(x < 0 or x >= v for x in kvset):
        raise ValueError(f"kvset entries must be in [0, {v})")
    maxc = max((kvset.count(s) for s in range(v)), default=0)
    slots = []
    for s in range(v):
        idx = [i for i, x in enumerate(kvset) if x == s]
        slots.extend(idx + [-1] * (maxc - len(idx)))
    return np.asarray(slots, dtype=np.int64), maxc


def group_perms(group_sizes, v: int):
    """Owner-major <-> group-major field permutations for TRLTOG/TRGTOL."""
    om = []
    offs = np.cumsum([0] + list(group_sizes))
    for d in range(v):
        for i, g in enumerate(group_sizes):
            lo = offs[i] + d * (g // v)
            om.extend(range(lo, lo + g // v))
    om = np.asarray(om, dtype=np.int64)
    return om, np.argsort(om)


def field_sets(mesh, nloc: tuple, kvsets: tuple, names: tuple) -> list:
    """The KVSET vector of each family of spectral fields, from this rank's
    field counts ``nloc``: as given (this rank must hold the fields it
    gives its v-rank), else the default blocks of the family's total, which
    the ranks of the v-line sum from their counts (a collective when a
    vector is not given and v > 1)."""
    v, iv = mesh.v, mesh.iv
    counts = None
    if v > 1 and any(k is None for k in kvsets):
        c = torch.zeros(len(nloc), v, dtype=torch.float64, device=mesh.device)
        c[:, iv] = torch.tensor(nloc, dtype=torch.float64)
        c = comm.all_reduce_sum(c, mesh.v_group, "counts")
        counts = c.cpu().long().tolist()
    out = []
    for i, (n, kv, name) in enumerate(zip(nloc, kvsets, names)):
        if kv is None:
            total = n if counts is None else sum(counts[i])
            kv = default_kvset(total, v)
            if counts is not None and \
                    [kv.count(s) for s in range(v)] != counts[i]:
                raise ValueError(
                    f"the v-ranks hold {counts[i]} {name} fields, not the "
                    f"default blocks of ceil(n / {v}); pass {name}")
        else:
            kv = [int(x) for x in kv]
            kvset_slots(kv, v)            # validates the entries
            if kv.count(iv) != n:
                raise ValueError(f"{name} gives v-rank {iv} {kv.count(iv)} "
                                 f"fields; this rank holds {n}")
        out.append(kv)
    return out


def output_index(kvuv: list, kvsc: list, flags, v: int) -> tuple:
    """(sel, Fuv, Fsc): the leading-axis index taking the inverse output's
    group-major slot fields (each family padded to the v-ranks' largest
    count, Fuv and Fsc) to the caller's fields in PGP order."""
    slots_uv, Fuv = kvset_slots(kvuv, v)
    slots_sc, Fsc = kvset_slots(kvsc, v)
    sel = FieldLayout.inv(len(kvuv), len(kvsc), flags).kvset_index(
        {int(f): j for j, f in enumerate(slots_uv) if f >= 0},
        {int(f): j for j, f in enumerate(slots_sc) if f >= 0},
        len(slots_uv), len(slots_sc))
    return sel, Fuv, Fsc


def slot_fields(x: torch.Tensor, slots: np.ndarray, idx=None) -> torch.Tensor:
    """Fields x (n, ...) at the padded slots of ``kvset_slots`` (a zero
    field where the slot is -1); ``idx`` makes the index tensor on x's
    device."""
    idx = idx or (lambda a: torch.as_tensor(a, device=x.device))
    xz = torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])
    return xz[idx(np.where(slots < 0, x.shape[0], slots))]


def place(x, maxc: int, like: torch.Tensor) -> torch.Tensor:
    """This rank's fields x (or None) padded with zero fields to maxc, in
    the dtype and on the device of ``like``."""
    out = like.new_zeros((maxc,) + tuple(like.shape[1:]))
    if x is not None and x.shape[0]:
        out[: x.shape[0]] = x
    return out


def _lat_cols(ndgl: int, eng: str) -> np.ndarray:
    """The column of each latitude (and of the pad row, ndgl) in the output
    of ``ShardedTransform._lt_inv``: natural order, but for the "dense"
    engine's southern latitudes, which ``_inv_rows_in_place`` mirrors."""
    cols = np.arange(ndgl + 1)
    if eng == "dense":
        h = ndgl // 2
        cols[h: ndgl] = ndgl - 1 - cols[h: ndgl] + h
    return cols


def _inv_rows_in_place(d2: torch.Tensor, fl) -> torch.Tensor:
    """``legendre_dense.legendre_inv_rows`` of a w-rank's realigned rows d2
    (nfld, 2, ML, W) with K1's outputs copied straight into one zero-filled
    (nfld, 2, ML, ndgl + 1) array, one copy a hemisphere a group: the
    northern latitudes in natural order, the southern ones as K1 gives them
    (column ndgnh + i is latitude ndgl - 1 - i: ``_lat_cols``), zero at a
    group's inactive latitudes and in the last column."""
    nfld, ndgnh = d2.shape[0], fl.ndgnh
    out = d2.new_zeros((nfld, 2, d2.shape[2], 2 * ndgnh + 1))
    for g in fl.groups:
        north, south = legendre_dense.group_inv_dense(
            legendre_dense.group_rows(d2[..., :g.J], g), g.pn)
        shape = (nfld, 2, g.m1 - g.m0, ndgnh - g.i0)
        out[:, :, g.m0:g.m1, g.i0:ndgnh] = \
            north.transpose(0, 1).reshape(shape)
        out[:, :, g.m0:g.m1, ndgnh + g.i0: 2 * ndgnh] = \
            south.transpose(0, 1).reshape(shape)
    return out


def _rows_vordiv(rows_list: list, groups, ML: int, W1: int, nuv: int,
                 t: dict) -> torch.Tensor:
    """Every group's c-major realigned rows (gm, 2F, J) of a w-rank in one
    zero-filled (ML + 1, 2F, W1) array (the last row zero), with UVTVD
    applied once to all of them when ``nuv`` (``spectral.vordiv_rows`` and
    the groups' padding and concatenation, in one pass: past a group's
    width its rows and the valid mask of ``t`` are zero)."""
    nfld = rows_list[0].shape[1] // 2
    loc = rows_list[0].new_zeros((ML + 1, 2 * nfld, W1))
    for g, r in zip(groups, rows_list, strict=True):
        loc[g.m0:g.m1, :, :r.shape[-1]] = r
    if nuv:
        vd = spectral.uv_to_vordiv_rows(loc[:ML], 0, nuv, nfld, t)
        loc[:ML, :2 * nuv] = vd[:, :2 * nuv]
        loc[:ML, nfld: nfld + 2 * nuv] = vd[:, 2 * nuv:]
    return loc


class ShardedTransform:
    """Distributed inverse/direct spectral transforms on a (w, v) mesh:
    each rank's results are the JAX package's ``ShardedTransform``'s on
    that rank's shards (decomposition invariance: the single-device
    transform's, to rounding)."""

    def __init__(self, res: Resolution, mesh, dtype=torch.float32,
                 precision: str = "highest"):
        self.mesh = check_mesh(mesh)
        _check_precision(precision)
        self.res = res
        self.dtype = check_dtype(dtype)
        self.precision = precision
        self.device = mesh.device
        self.w, self.v = mesh.w, mesh.v
        eng = legendre_matmul.engine()
        self.eng = ("dense" if eng == "dense" and self.dtype != torch.float64
                    else "xla")
        self.dist = d = build_distribution(res, self.w, self.v,
                                           fourier.fft_buckets())
        iw = mesh.iw
        self.tables = rank_tables(d, iw, self.eng, self.dtype, self.device)
        self.legendre = rank_legendre(d, iw, _table_dtype(self.dtype,
                                                          precision),
                                      self.device)
        # the chirp-z buckets of the w-rank's latitude slots of lat_perm
        self.fourier = rank_fourier(d, iw, self.device)
        self._grid_group = mesh.group if self.w * self.v > 1 else None
        self._idx_cache = {}
        self._boundary = self._boundary_maps()
        # TRMTOL's latitude slots (pad slots read the zero last column) in
        # the columns of ``_lt_inv``'s output
        self._trmtol_cols = self._idx(_lat_cols(res.ndgl, self.eng)[
            np.minimum(d.lat_perm, res.ndgl)])
        self._ll_cache = {}
        self._spec0 = torch.zeros((0, res.nspec2), dtype=self.dtype,
                                  device=self.device)

    # -- layout helpers -------------------------------------------------
    def _idx(self, x) -> torch.Tensor:
        """The int64 index tensor of x on the device, made once for each
        content (a copy from the host waits for the device)."""
        a = np.ascontiguousarray(x, np.int64)
        key = (a.shape, a.tobytes())
        t = self._idx_cache.get(key)
        if t is None:
            t = self._idx_cache[key] = torch.as_tensor(a, device=self.device)
        return t

    def _boundary_maps(self) -> dict:
        """The rows the grid-boundary exchange moves: this rank's slots
        whose row lies in rank d's block, to d (``send_idx``, by d then
        row), and the rows of its own block from each rank s
        (``recv_pos``, by s then row); the direct transform runs them
        backwards."""
        d, res = self.dist, self.res
        n, r, LLg = self.w * self.v, self.mesh.rank, d.LLg
        nat = d.lat_perm[r * LLg: (r + 1) * LLg]
        real = np.nonzero(nat < res.ndgl)[0]
        dest = nat[real] // LLg
        send_idx = real[np.lexsort((nat[real], dest))]
        first, end = d.grid_block(r)
        p = np.arange(first, end)
        src = d.lat_pos[p] // LLg
        recv_pos = (p - first)[np.lexsort((p, src))]
        return dict(send_idx=self._idx(send_idx), recv_pos=self._idx(recv_pos),
                    send=np.bincount(dest, minlength=n).tolist(),
                    recv=np.bincount(src, minlength=n).tolist(),
                    nrows=end - first)

    def _to_grid_block(self, x: torch.Tensor) -> torch.Tensor:
        """(F, LLg, ndlon) on this rank's latitude slots -> (F, nrows,
        ndlon) on its pole-to-pole block."""
        b = self._boundary
        with hook("boundary"):
            got = comm.exchange(x.transpose(0, 1)[b["send_idx"]],
                                self._grid_group, b["send"], b["recv"],
                                "grid")
            out = x.new_zeros((b["nrows"],) + (x.shape[0], x.shape[2]))
            out[b["recv_pos"]] = got
            return out.transpose(0, 1).contiguous()

    def _from_grid_block(self, x: torch.Tensor) -> torch.Tensor:
        """The inverse of ``_to_grid_block``; pad slots are zero."""
        b = self._boundary
        with hook("boundary"):
            got = comm.exchange(x.transpose(0, 1)[b["recv_pos"]],
                                self._grid_group, b["recv"], b["send"],
                                "grid")
            out = x.new_zeros((self.dist.LLg,) + (x.shape[0], x.shape[2]))
            out[b["send_idx"]] = got
            return out.transpose(0, 1).contiguous()

    def _put(self, x):
        if x is None:
            return None
        return torch.as_tensor(x, device=self.device).to(self.dtype)

    # -- spectral space ---------------------------------------------------
    def _ct(self, prefix: str, keys, eng=None) -> dict:
        """Spectral-operator coefficient tables: realigned ({prefix}r_*)
        for the "dense" engine's realigned rows."""
        if (eng or self.eng) == "dense":
            prefix += "r"
        return {k: self.tables[f"{prefix}_{k}_w"] for k in keys}

    def _packed_to_dense_local(self, spec: torch.Tensor, eng=None):
        """Packed (F, nspec2) -> this w-rank's m rows: realigned (F, 2, ML,
        NP+1) rows (one row slice per m at its NASM0 offset, masked past
        the diagonal's end) for "dense", else the dense (F, 2, ML, NP)
        layout."""
        t = self.tables
        if (eng or self.eng) == "dense":
            nfld = spec.shape[0]
            W1 = self.res.NP + 1
            specp = F.pad(spec, (0, 2 * W1))
            cols = t["nasm0_perm_w"][:, None] + torch.arange(
                2 * W1, device=spec.device)
            rows = specp[:, cols]                         # (F, ML, 2*W1)
            d2 = rows.reshape(nfld, -1, W1, 2).permute(0, 3, 1, 2)
            return d2 * t["rvalid_w"]
        return layout.gather_packed(spec, t["dense_gather_w"].transpose(0, 1))

    def _parity(self, dense: torch.Tensor):
        """Dense (F, 2, ML, NP) -> sym, asym (F, 2, ML, kmax) by the
        permuted parity maps (NP: the appended zero column)."""
        pad = F.pad(dense, (0, 1))
        shape = dense.shape[:3] + (self.res.kmax,)
        return tuple(pad.gather(3, self.tables[k][None, None].expand(shape))
                     for k in ("idx_sym_w", "idx_asym_w"))

    def _grouped(self, fl) -> GroupedLegendre:
        """The parity tables of full-n rows ``fl``: strided views,
        psym[m, i, k] = pn[m, 2k, i], pasym[m, i, k] = pn[m, 2k+1, i]."""
        return GroupedLegendre(
            groups=tuple(LegendreGroup(
                m0=g.m0, m1=g.m1, i0=g.i0, kg=g.J // 2,
                psym=g.pn[:, 0::2].transpose(1, 2),
                pasym=g.pn[:, 1::2].transpose(1, 2))
                for g in fl.groups),
            ndgnh=fl.ndgnh, kmax=fl.kmax)

    def _lt_inputs(self, pv, pd, psc, flags, eng=None) -> torch.Tensor:
        """The inverse LT's input rows (F1, 2, ML, W) of this rank's slot
        fields: [vor?, div?, u, v, scalars, N-S derivatives?] (VDTUV,
        SPNSDE) in the engine's layout."""
        def dense(x):
            return self._packed_to_dense_local(x, eng) if x.shape[0] else None

        with hook("spectral"):
            return torch.cat(legendre_inputs(
                dense(pv), dense(pd), dense(psc), flags,
                self._ct("vd", ("a", "b", "c", "valid"), eng),
                self._ct("ns", ("a", "b", "valid"), eng)))

    # -- Legendre ---------------------------------------------------------
    def _lt_inv(self, dense: torch.Tensor) -> torch.Tensor:
        """Inverse LT on this w-rank's m rows -> (F, 2, ML, ndgl + 1), the
        latitudes in the columns ``_lat_cols`` gives them and a zero last
        column: K1 on the realigned rows of each group, written in place
        ("dense", ``_inv_rows_in_place``), else the grouped einsums."""
        with hook("legendre"):
            if self.eng == "dense":
                return _inv_rows_in_place(dense, self.legendre)
            sym, asym = self._parity(dense)
            return F.pad(legendre_matmul.legendre_inv_grouped(
                sym, asym, self._grouped(self.legendre)), (0, 1))

    def _pack_psum(self, vals: torch.Tensor) -> torch.Tensor:
        """The masked gather of the packed values whose m this w-rank owns
        from (F, 2, ML, W) rows, then the all_reduce over "w"."""
        t = self.tables
        ML = self.dist.ML
        lp = t["pm_perm_pos"] - self.mesh.iw * ML
        owned = (lp >= 0) & (lp < ML)
        ncol = t["packed_j"] if self.eng == "dense" else t["packed_n"]
        out = vals[:, t["packed_c"], lp.clamp(0, ML - 1), ncol]
        out = torch.where(owned, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))
        with hook("updsp"):
            return comm.all_reduce_sum(out, self.mesh.w_group, "psum")

    def _dir_packed(self, four: torch.Tensor, Fuv: int) -> torch.Tensor:
        """Direct LT of (F, 2, ML, ndgl), UVTVD and packing -> this rank's
        packed [vor, div, scalars] (F, nspec2), summed over "w"."""
        res = self.res
        w = self.tables["wq"]
        nfld = four.shape[0]
        if self.eng == "dense":
            with hook("legendre"):
                rows_list = legendre_dense.legendre_dir_rows(
                    four, self.legendre, w)
            with hook("spectral"):
                W1 = res.NP + 1
                loc = _rows_vordiv(rows_list, self.legendre.groups,
                                   self.dist.ML, W1, Fuv,
                                   self._ct("tv", ("p", "q", "r", "valid")))
            if pack.pack_kernel() == "xla":
                # (ML, 2F, W1) c-major rows -> (F, 2, ML, W1)
                return self._pack_psum(loc[:-1].reshape(
                    -1, 2, nfld, W1).permute(2, 1, 0, 3))
            with hook("spectral"):
                # full-M m-major rows (zero rows where another w-rank owns
                # m) for the compaction kernel K3, one launch, before the sum
                mm = loc[self.tables["rom_w"]]
                # the mesh keeps the fixed group count, as the JAX package's
                ngroups = default_leg_groups(res.M)
                packed = pack.packed_from_group_rows(
                    [mm[m0:m1] for m0, m1, _, _ in
                     res.legendre_groups(ngroups)], res, ngroups)
            with hook("updsp"):
                return comm.all_reduce_sum(packed, self.mesh.w_group, "psum")
        with hook("legendre"):
            sym, asym = legendre_matmul.legendre_dir_grouped(
                four, self._grouped(self.legendre), w)
        with hook("spectral"):
            t = self.tables
            dense = four.new_zeros(four.shape[:3] + (res.NP + 1,))
            shape = sym.shape
            for k, x in (("idx_sym_w", sym), ("idx_asym_w", asym)):
                dense.scatter_add_(3, t[k][None, None].expand(shape), x)
            dense = dense[..., : res.NP]
            if Fuv:
                dvor, ddiv = spectral.uv_to_vordiv(
                    dense[:Fuv], dense[Fuv: 2 * Fuv],
                    self._ct("tv", ("p", "q", "r", "valid")))
                dense = torch.cat([dvor, ddiv, dense[2 * Fuv:]])
        return self._pack_psum(dense)

    # -- the pipeline on this rank's slots ----------------------------------
    def _inv_slots(self, pv, pd, psc, flags: InvFlags, fspgl_proc=None):
        """This rank's slot fields (Fuv, Fsc each padded to the v-ranks'
        largest count) -> (F2 * v, LLg, ndlon): every v-rank's slot fields
        in group-major order on this rank's latitude slots."""
        res, d, t = self.res, self.dist, self.tables
        Fuv, Fsc = pv.shape[0], psc.shape[0]
        four = self._lt_inv(self._lt_inputs(pv, pd, psc, flags))
        # four: (F1, 2, ML, ndgl + 1)
        # TRMTOL: latitudes to the length-sorted slots (pad slots read the
        # zero last column), split over "w", the m's gathered
        with hook("trmtol"):
            fT = four.movedim(3, 0)[self._trmtol_cols]
            fT = comm.all_to_all(fT, self.mesh.w_group, 0, 3, "TRMTOL")
            four = fT.movedim(3, 0)[t["pos_of_m"]].permute(2, 3, 0, 1)

        # FSC on the local latitude slots (m in natural order)
        with hook("spectral"):
            four2 = fsc(four, Fuv, Fsc, flags, t["racthe_lat_w"])
        if fspgl_proc is not None:
            # FSPGL (fspgl_int_mod.F90): this rank's latitude slots, all
            # m's; the rows are in the length-sorted order of lat_perm
            four2 = fspgl_proc(four2)
        # (F2, LL, ndlon)
        with hook("fourier"):
            grid = fourier.synthesis_bucketed(four2, self.fourier)
        # TRLTOG: the fields gathered over "v", the slots split further;
        # owner-major -> group-major
        with hook("trltog"):
            grid = comm.all_to_all(grid, self.mesh.v_group, 1, 0, "TRLTOG")
            gsz = FieldLayout.inv(Fuv, Fsc, flags).sizes_padded
            _, inv_perm = group_perms([g * self.v for g in gsz], self.v)
            return grid[self._idx(inv_perm)]

    def _dir_slots(self, grid: torch.Tensor, Fuv_g: int, Fsc_g: int):
        """(Fin, LLg, ndlon) group-major slot fields [u, v, scalars] on this
        rank's latitude slots -> this rank's packed [vor, div, scalars]
        slot fields (F, nspec2), F = Fin / v."""
        res, d, t = self.res, self.dist, self.tables
        gsz = ([Fuv_g, Fuv_g] if Fuv_g else []) + ([Fsc_g] if Fsc_g else [])
        om, _ = group_perms(gsz, self.v)
        # TRGTOL: the fields scattered over "v", the slots gathered
        with hook("trgtol"):
            x = comm.all_to_all(grid[self._idx(om)], self.mesh.v_group, 0, 1,
                                "TRGTOL")
        with hook("fourier"):
            four = fourier.analysis_bucketed(x, self.fourier, res.M)
        # four: (F, 2, M, LL)
        Fuv = Fuv_g // self.v
        if Fuv:
            with hook("spectral"):
                four[: 2 * Fuv] *= t["racthe_lat_w"]
        # TRLTOM: m to the permuted order (pad rows read the appended
        # zero row), split over "w", the latitude slots gathered
        with hook("trltom"):
            fM = four.movedim(2, 0)
            fM = torch.cat([fM, fM.new_zeros((1,) + fM.shape[1:])])
            fM = fM[self._idx(np.minimum(d.perm, res.M))]
            fT = comm.all_to_all(fM, self.mesh.w_group, 0, 3, "TRLTOM")
            four = fT.movedim(3, 0)[t["lat_pos"]].permute(2, 3, 1, 0)
            four = four.contiguous()
        return self._dir_packed(four, Fuv)

    # -- inverse ------------------------------------------------------------
    def inv_trans(self, spvor=None, spdiv=None, spscalar=None,
                  flags: InvFlags = InvFlags(), npromatr: int | None = None,
                  kvsetuv=None, kvsetsc=None, fspgl_proc=None):
        """Distributed inverse transform: this rank's spectral fields
        (nfld_local, nspec2) -> its grid block (nfld_out, nrows, ndlon),
        every field in the reference PGP order (the v-padding stripped)."""
        with hook("api.inv_trans"):
            return self._inv_trans(spvor, spdiv, spscalar, flags, npromatr,
                                   kvsetuv, kvsetsc, fspgl_proc)

    def _inv_trans(self, spvor, spdiv, spscalar, flags, npromatr, kvsetuv,
                   kvsetsc, fspgl_proc):
        if (spvor is None) != (spdiv is None):
            raise ValueError("spvor and spdiv must be supplied together")
        if spvor is not None and spvor.shape != spdiv.shape:
            raise ValueError(f"spvor/spdiv shape mismatch: "
                             f"{tuple(spvor.shape)} vs {tuple(spdiv.shape)}")
        for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                        ("spscalar", spscalar)):
            _check_spec(nm, arr, self.res)
        spvor, spdiv, spsc = map(self._put, (spvor, spdiv, spscalar))
        nloc = tuple(0 if x is None else x.shape[0] for x in (spvor, spsc))
        kvuv, kvsc = field_sets(self.mesh, nloc, (kvsetuv, kvsetsc),
                                ("kvsetuv", "kvsetsc"))
        if not kvuv and not kvsc:
            raise ValueError(
                "nothing to transform: pass spvor/spdiv and/or spscalar")
        if npromatr and 2 * len(kvuv) + len(kvsc) > npromatr:
            return self._inv_packets(spvor, spdiv, spsc, flags, npromatr,
                                     kvuv, kvsc, fspgl_proc)
        return self._inv_kvset(spvor, spdiv, spsc, flags, kvuv, kvsc,
                               fspgl_proc)

    def _inv_kvset(self, spvor, spdiv, spsc, flags, kvuv, kvsc,
                   fspgl_proc=None):
        """inv_trans of this rank's fields under the ownership vectors."""
        key = ("output_index", tuple(kvuv), tuple(kvsc), flags)
        if key not in self._idx_cache:
            self._idx_cache[key] = output_index(kvuv, kvsc, flags, self.v)
        sel, cu, cs = self._idx_cache[key]
        grid = self._inv_slots(place(spvor, cu, self._spec0),
                               place(spdiv, cu, self._spec0),
                               place(spsc, cs, self._spec0), flags,
                               fspgl_proc)
        return self._to_grid_block(grid[self._idx(sel)])

    def _block_of(self, x, kv: list, j: int, size: int):
        """This rank's fields of the packet [j, j + size) of a family."""
        iv = self.mesh.iv
        a = kv[:j].count(iv)
        return None if x is None else x[a: a + kv[j: j + size].count(iv)]

    def _inv_packets(self, spvor, spdiv, spsc, flags, npromatr, kvuv, kvsc,
                     fspgl_proc):
        """NPROMATR packets: uv pairs (npromatr // 2 a packet) then scalars
        (npromatr), each under its slice of the ownership vector, the
        outputs reassembled in the single call's PGP order."""
        parts = {}
        size = max(1, npromatr // 2)
        for j in range(0, len(kvuv), size):
            kv = kvuv[j: j + size]
            out = self._inv_kvset(self._block_of(spvor, kvuv, j, size),
                                  self._block_of(spdiv, kvuv, j, size),
                                  None, flags, kv, [], fspgl_proc)
            for k, blk in FieldLayout.inv(len(kv), 0, flags).split(out).items():
                parts.setdefault(k, []).append(blk)
        size = max(1, npromatr)
        for j in range(0, len(kvsc), size):
            kv = kvsc[j: j + size]
            out = self._inv_kvset(None, None,
                                  self._block_of(spsc, kvsc, j, size), flags,
                                  [], kv, fspgl_proc)
            for k, blk in FieldLayout.inv(0, len(kv), flags).split(out).items():
                parts.setdefault(k, []).append(blk)
        order = FieldLayout.inv(len(kvuv), len(kvsc), flags).names
        return torch.cat([blk for k in order for blk in parts[k]])

    # -- direct -------------------------------------------------------------
    def dir_trans(self, u=None, v=None, scalars=None, kvsetuv=None,
                  kvsetsc=None, npromatr: int | None = None):
        """Distributed direct transform: this rank's grid block of every
        field (nfld, nrows, ndlon) -> (spvor, spdiv, spscalar), this rank's
        fields of each family (as ``kvsetuv``/``kvsetsc`` assign them, by
        default the v-rank's block); None for a family with no input."""
        with hook("api.dir_trans"):
            return self._dir_trans(u, v, scalars, kvsetuv, kvsetsc, npromatr)

    def _dir_trans(self, u, v, scalars, kvsetuv, kvsetsc, npromatr):
        if (u is None) != (v is None):
            raise ValueError("u and v must be supplied together")
        if u is not None and u.shape != v.shape:
            raise ValueError(f"u/v shape mismatch: {tuple(u.shape)} vs "
                             f"{tuple(v.shape)}")
        if u is None and scalars is None:
            raise ValueError("nothing to transform: pass u/v and/or scalars")
        want = (self._boundary["nrows"], self.res.grid.ndlon)
        for nm, arr in (("u", u), ("v", v), ("scalars", scalars)):
            if arr is not None and (arr.ndim != 3 or
                                    tuple(arr.shape[1:]) != want):
                raise ValueError(f"{nm} must have shape (nfld, {want[0]}, "
                                 f"{want[1]}) on this rank, got "
                                 f"{tuple(arr.shape)}")
        u, v, sc = map(self._put, (u, v, scalars))
        kvuv = self._kv_global(0 if u is None else u.shape[0], kvsetuv,
                               "kvsetuv")
        kvsc = self._kv_global(0 if sc is None else sc.shape[0], kvsetsc,
                               "kvsetsc")
        if npromatr and 2 * len(kvuv) + len(kvsc) > npromatr:
            return self._dir_packets(u, v, sc, npromatr, kvuv, kvsc)
        return self._dir_kvset(u, v, sc, kvuv, kvsc)

    def _kv_global(self, n: int, kv, name: str) -> list:
        """The ownership vector of a family of n fields, every one of which
        this rank holds (grid space) or a root holds: as given, or the
        default blocks."""
        if kv is None:
            return default_kvset(n, self.v)
        kv = [int(k) for k in kv]
        if len(kv) != n:
            raise ValueError(f"{name} must have {n} entries")
        kvset_slots(kv, self.v)
        return kv

    def _dir_kvset(self, u, v, sc, kvuv, kvsc):
        """dir_trans of the grid block under the ownership vectors."""
        iv = self.mesh.iv
        slots_uv, cu = kvset_slots(kvuv, self.v)
        slots_sc, cs = kvset_slots(kvsc, self.v)
        grid = self._from_grid_block(torch.cat([
            slot_fields(x, slots, self._idx) for x, slots in
            ((u, slots_uv), (v, slots_uv), (sc, slots_sc)) if len(slots)]))
        packed = self._dir_slots(grid, len(slots_uv), len(slots_sc))
        nu, ns = kvuv.count(iv), kvsc.count(iv)
        return (packed[:nu] if kvuv else None,
                packed[cu: cu + nu] if kvuv else None,
                packed[2 * cu: 2 * cu + ns] if kvsc else None)

    def _dir_packets(self, u, v, sc, npromatr, kvuv, kvsc):
        """NPROMATR packets of the direct transform: uv pairs then
        scalars; this rank's fields of each packet, in order."""
        sv_p, sd_p, ss_p = [], [], []
        size = max(1, npromatr // 2)
        for j in range(0, len(kvuv), size):
            sv, sd, _ = self._dir_kvset(u[j: j + size], v[j: j + size], None,
                                        kvuv[j: j + size], [])
            sv_p.append(sv)
            sd_p.append(sd)
        size = max(1, npromatr)
        for j in range(0, len(kvsc), size):
            ss_p.append(self._dir_kvset(None, None, sc[j: j + size], [],
                                        kvsc[j: j + size])[2])
        return tuple(torch.cat(p) if p else None for p in (sv_p, sd_p, ss_p))

    # -- lat-lon output ---------------------------------------------------
    def _latlon_tables(self, ll):
        """This w-rank's parity tables at the lat-lon NH nodes (K4 on its
        m rows, every latitude active), 1/(a cos) of its lat-lon rows (zero
        at exact poles and on pad rows) and the padded row count."""
        from ..latlon import latlon_nodes
        from ..ops import legendre_tablegen as tg

        key = (ll.nlat, ll.nlon, ll.include_poles)
        if key in self._ll_cache:
            return self._ll_cache[key]
        res, d, iw = self.res, self.dist, self.mesh.iw
        mu = latlon_nodes(ll)
        host = tg.recurrence_inputs(res.nsmax, mu, np.full(mu.size,
                                                           res.nsmax))
        inp = rank_inputs(host, d.perm[iw * d.ML: (iw + 1) * d.ML], res.M,
                          self.device)
        gl = self._grouped(rank_groups(d, inp, self.dtype, i0=0))
        wv = self.w * self.v
        nlat_pad = -(-ll.nlat // wv) * wv
        racthe = 1.0 / np.maximum(np.sqrt(1.0 - ll.mu ** 2), 1e-12) \
            / res.radius
        if ll.include_poles:
            racthe[0] = racthe[-1] = 0.0
        LLl = nlat_pad // self.w
        rl = np.pad(racthe, (0, nlat_pad - ll.nlat))[iw * LLl:
                                                      (iw + 1) * LLl]
        out = (gl, torch.tensor(rl, dtype=self.dtype, device=self.device),
               nlat_pad)
        self._ll_cache[key] = out
        return out

    def inv_trans_latlon(self, ll, spvor=None, spdiv=None, spscalar=None,
                         flags: InvFlags = InvFlags()):
        """Distributed inverse transform onto a regular lat-lon grid (LDLL,
        exact spectral evaluation; ``latlon.inv_trans_latlon``): this
        rank's spectral fields -> its block of lat-lon rows, r*R ..
        (r+1)*R - 1 with R = ceil(nlat / (w*v)), (nfld_out, nrows, nlon)."""
        if (spvor is None) != (spdiv is None):
            raise ValueError("spvor and spdiv must be supplied together")
        for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                        ("spscalar", spscalar)):
            _check_spec(nm, arr, self.res)
        spvor, spdiv, spsc = map(self._put, (spvor, spdiv, spscalar))
        nloc = tuple(0 if x is None else x.shape[0] for x in (spvor, spsc))
        kvuv, kvsc = field_sets(self.mesh, nloc, (None, None),
                                ("kvsetuv", "kvsetsc"))
        if not kvuv and not kvsc:
            raise ValueError("nothing to transform")
        gl, racthe, nlat_pad = self._latlon_tables(ll)
        sel, Fuv, Fsc = output_index(kvuv, kvsc, flags, self.v)
        # the grouped einsums at the lat-lon latitudes, on the dense
        # layout whatever the engine -> (F1, 2, ML, nlat_pad)
        sym, asym = self._parity(self._lt_inputs(
            place(spvor, Fuv, self._spec0), place(spdiv, Fuv, self._spec0),
            place(spsc, Fsc, self._spec0), flags, "xla"))
        four = legendre_matmul.legendre_inv_grouped(sym, asym, gl)
        if ll.nlat % 2:    # the equator row's southern duplicate
            four = torch.cat([four[..., :gl.ndgnh],
                              four[..., gl.ndgnh + 1:]], -1)
        four = F.pad(four, (0, nlat_pad - four.shape[-1]))
        four = comm.all_to_all(four, self.mesh.w_group, 3, 2, "TRMTOL")
        four = four[:, :, self.tables["pos_of_m"]]       # (F1, 2, M, LLl)
        four2 = fsc(four, Fuv, Fsc, flags, racthe).transpose(2, 3)
        grid = fourier.synthesis_uniform(four2[:, 0], four2[:, 1], ll.nlon)
        grid = comm.all_to_all(grid, self.mesh.v_group, 1, 0, "TRLTOG")
        gsz = FieldLayout.inv(Fuv, Fsc, flags).sizes_padded
        _, inv_perm = group_perms([g * self.v for g in gsz], self.v)
        R = nlat_pad // (self.w * self.v)
        nrows = max(0, min(R, ll.nlat - self.mesh.rank * R))
        return grid[self._idx(inv_perm[sel]), :nrows].contiguous()

    # -- DIST_GRID / GATH_GRID / DIST_SPEC / GATH_SPEC ----------------------
    # Without ``root`` every rank holds the global array: dist_* take this
    # rank's shard of it, and gath_* assemble it on every rank (a sum of
    # zero-filled copies, copied to the host).  With ``root`` (a rank of the
    # mesh, the reference's owner rank) only the root holds the global
    # array, on the device: dist_* scatter each rank's shard to it and
    # gath_* gather the shards to the root, point to point (``comm.scatter``,
    # ``comm.gather``); the other ranks pass None to dist_* with ``nfld``,
    # the global field count, and get None from gath_*.
    def _blocks(self) -> list:
        return [self.dist.grid_block(r) for r in range(self.w * self.v)]

    def _nfld(self, x, nfld, kvset, root: int, name: str) -> int:
        if self.mesh.rank == root:
            if x is None:
                raise ValueError(f"{name}: the root rank {root} passes the "
                                 "global array")
            return torch.as_tensor(x).shape[0]
        if nfld is None:
            if kvset is None:
                raise ValueError(f"{name}: a rank other than the root "
                                 "passes nfld (or kvset)")
            nfld = len(kvset)
        return int(nfld)

    def dist_grid(self, grid_global=None, root: int | None = None,
                  nfld: int | None = None) -> torch.Tensor:
        """This rank's block of rows of a global (nfld, ndgl, ndlon) grid."""
        first, end = self.dist.grid_block(self.mesh.rank)
        if root is None:
            return self._put(torch.as_tensor(grid_global)[:, first:end])
        with hook("dist_grid"):
            n = self._nfld(grid_global, nfld, None, root, "dist_grid")
            parts = None
            if self.mesh.rank == root:
                g = self._put(grid_global)
                parts = [g[:, a:b] for a, b in self._blocks()]
            return comm.scatter(parts, (n, end - first, self.res.grid.ndlon),
                                self._spec0, self._grid_group, root)

    def gath_grid(self, grid, root: int | None = None):
        """The global grid from each rank's block: without ``root`` a numpy
        array on every rank (a collective: a sum of zero-filled copies over
        the mesh), with it a tensor on the root's device, None elsewhere."""
        grid = self._put(grid)
        if root is None:
            first, end = self.dist.grid_block(self.mesh.rank)
            out = grid.new_zeros((grid.shape[0], self.res.ndgl,
                                  grid.shape[2]))
            out[:, first:end] = grid
            return comm.all_reduce_sum(out, self._grid_group,
                                       "gath").cpu().numpy()
        with hook("gath_grid"):
            blocks = self._blocks()
            nf, nl = grid.shape[0], grid.shape[2]
            parts = comm.gather(grid, range(len(blocks)),
                                [(nf, b - a, nl) for a, b in blocks],
                                self._grid_group, root)
            if parts is None:
                return None
            out = grid.new_empty((nf, self.res.ndgl, nl))
            for (a, b), x in zip(blocks, parts):
                out[:, a:b] = x
            return out

    def dist_spec(self, spec_global=None, kvset=None, root: int | None = None,
                  nfld: int | None = None) -> torch.Tensor:
        """This rank's fields of a global (nfld, nspec2) array: those
        ``kvset`` gives its v-rank, by default its block."""
        if root is None:
            spec = torch.as_tensor(spec_global)
            kv = self._kv_global(spec.shape[0], kvset, "kvset")
            own = [i for i, s in enumerate(kv) if s == self.mesh.iv]
            return self._put(spec[self._idx(own).cpu()])
        with hook("dist_spec"):
            n = self._nfld(spec_global, nfld, kvset, root, "dist_spec")
            kv = self._kv_global(n, kvset, "kvset")
            parts = None
            if self.mesh.rank == root:
                spec = self._put(spec_global)
                own = [spec[self._idx([i for i, s in enumerate(kv)
                                       if s == iv])] for iv in range(self.v)]
                parts = [own[r % self.v] for r in range(self.w * self.v)]
            return comm.scatter(parts, (kv.count(self.mesh.iv),
                                        self.res.nspec2),
                                self._spec0, self._grid_group, root)

    def gath_spec(self, spec, kvset=None, root: int | None = None,
                  nfld: int | None = None):
        """The global (nfld, nspec2) array from each v-rank's fields:
        without ``root`` a numpy array on every rank (a collective over the
        v-line), with it a tensor on the root's device, gathered from the
        ranks of the root's v-line, and None elsewhere; with ``root`` every
        rank passes ``kvset`` or ``nfld``."""
        spec = self._put(spec)
        if root is None:
            (kv,) = field_sets(self.mesh, (spec.shape[0],), (kvset,),
                               ("kvset",))
            out = spec.new_zeros((len(kv), self.res.nspec2))
            out[self._idx([i for i, s in enumerate(kv)
                           if s == self.mesh.iv])] = spec
            return comm.all_reduce_sum(out, self.mesh.v_group,
                                       "gath").cpu().numpy()
        if kvset is None and nfld is None:
            raise ValueError("gath_spec: with a root every rank passes kvset "
                             "or nfld")
        with hook("gath_spec"):
            kv = self._kv_global(len(kvset) if nfld is None else nfld, kvset,
                                 "kvset")
            line = (root // self.v) * self.v
            parts = comm.gather(spec, range(line, line + self.v),
                                [(kv.count(iv), self.res.nspec2)
                                 for iv in range(self.v)],
                                self._grid_group, root)
            if parts is None:
                return None
            out = spec.new_empty((len(kv), self.res.nspec2))
            for iv, x in enumerate(parts):
                out[self._idx([i for i, s in enumerate(kv) if s == iv])] = x
            return out
