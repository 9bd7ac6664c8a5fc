"""Inverse and direct spectral transforms on one device.

Counterpart of ``ectrans_tpu/transform.py`` (reference
``inv_trans_ctl_mod.F90`` / ``dir_trans_ctl_mod.F90`` and the batched GPU
variant ``gpu/internal/inv_trans_ctl_mod.F90:160-236``), running eagerly on
the device of its input tensors.

Inverse (spectral -> grid):
    packed -> dense -> VDTUV winds, SPNSDE N-S derivatives -> one inverse
    Legendre call over all fields -> FSC (1/(a cos) scaling, E-W
    derivatives) -> optional ``fspgl_proc`` hook -> Fourier synthesis.
Direct (grid -> spectral):
    Fourier analysis -> LDFOU2 (u, v times 1/(a cos)) -> direct Legendre ->
    UVTVD -> the NASM0 packed layout.

The Legendre engine (``ops.legendre_matmul``; the private ``_engine``
keyword, else ``ECTRANS_TPU_LEG_KERNEL``, else "dense"):

* "dense": dense-row kernels K1/K2 on ``Resolution.full_legendre`` (K7/K8
  with ``ECTRANS_TPU_LEG_DENSE_PACK``); the direct transform runs UVTVD per
  group on the kernel's m-major rows and packs them with K3, never forming
  the (nfld, 2, M, NP) dense tensor;
* "planes": bf16 limb-plane kernels K9/K10 on ``planes_legendre``, the same
  m-major direct path; fp64 transforms resolve to "xla";
* "pallas" and "xla": parity split (``layout.dense_to_parity``) and the
  grouped kernels K5/K6 or per-group einsums on ``grouped_legendre``; the
  direct transform goes back to the dense layout (``parity_to_dense``),
  runs the dense UVTVD and packs with K3 ("pallas") or the index gather
  ("xla").

With ``ECTRANS_TPU_PACK_KERNEL=xla`` every engine's direct transform takes
the dense-layout path and the index gather (the JAX package's path on the
CPU): "dense" through ``legendre_dense.legendre_dir_dense``, "planes"
through ``legendre_matmul.dir_planes``.  Every engine serves the tiers
"highest", "high" (the same arithmetic) and "bf16" (bf16 tables,
``_table_dtype``); see ``ops.legendre_matmul``.  The environment is read
once per call, here, and passed down.

The tables of every engine derive from the full-n tables (kernel K4 on a
GPU).  Field order of the inverse output (``inv_trans.F90:58-106``): vor?,
div?, u, v, scalars, N-S derivatives of scalars?, E-W derivatives of u and
v?, E-W derivatives of scalars?.

NPROMATR packets (``npromatr``): a call with 2 nuv + nsc > npromatr runs
as packets, uv pairs (npromatr // 2 a packet) then scalars (npromatr a
packet), each zero-padded to its kind's uniform size, so that every packet
launches the same kernel shapes and sums in the same order; the inverse
output is reassembled in the single call's PGP order (``FieldLayout``), the
direct output drops the padded fields.

Both transforms are linear in their fields and differentiable through
every layer on the "xla" engine (the adjoints of ``adjoint.py``); the
kernels of the other engines have no autograd rule.

Not carried over from the JAX package: the dispatch splits and
``optimization_barrier`` guards against TPU-compiler faults, and the
analysis of u/v and scalars in separate calls.
"""

from __future__ import annotations

import dataclasses

import torch

from .field_layout import FieldLayout
from .ops import (fourier, layout, legendre_dense, legendre_matmul, pack,
                  spectral)
from .ops.legendre_planes import planes_for_tier
from .resolution import Resolution, check_dtype


@dataclasses.dataclass(frozen=True)
class InvFlags:
    vorgp: bool = False     # output grid-point vorticity (LDVORGP)
    divgp: bool = False     # output grid-point divergence (LDDIVGP)
    scders: bool = False    # output N-S and E-W derivatives of scalars
    uvders: bool = False    # output E-W derivatives of u, v (LDUVDER)


def num_inv_output_fields(nfld_uv: int, nfld_sc: int, flags: InvFlags) -> int:
    n = 0
    if nfld_uv:
        n += nfld_uv * (2 + int(flags.vorgp) + int(flags.divgp))
        if flags.uvders:
            n += 2 * nfld_uv
    if nfld_sc:
        n += nfld_sc * (3 if flags.scders else 1)
    return n


def _resolve_engine(eng: str | None, dtype: torch.dtype) -> str:
    """The engine of a transform: ``eng`` or ``legendre_matmul.engine()``;
    bf16 limb planes cannot carry fp64, so "planes" in fp64 is "xla"."""
    eng = eng or legendre_matmul.engine()
    if eng not in legendre_matmul.ENGINES:
        raise ValueError(f"unknown Legendre engine {eng!r}; expected one of "
                         f"{legendre_matmul.ENGINES}")
    if eng == "planes" and dtype == torch.float64:
        return "xla"
    return eng


def _check_precision(precision: str) -> None:
    if precision not in legendre_matmul.TIERS:
        raise ValueError(f"unknown precision tier {precision!r}; expected "
                         f"one of {legendre_matmul.TIERS}")


def _table_dtype(dtype: torch.dtype, precision: str) -> torch.dtype:
    """Legendre table dtype of a tier: bfloat16 for "bf16" in fp32 (half
    the table bytes; the operands are rounded to bf16 anyway), else the
    working dtype (``ectrans_tpu`` ``transform._table_dtype``)."""
    if precision == "bf16" and dtype == torch.float32:
        return torch.bfloat16
    return dtype


def _leg_tables(res: Resolution, eng: str, dtype: torch.dtype,
                precision: str, device: torch.device):
    """The Legendre tables an engine streams: limb planes ("planes"),
    full-n tables ("dense") or parity pairs ("xla", "pallas")."""
    if eng == "planes":
        return res.planes_legendre(planes_for_tier(precision), device)
    if eng == "dense":
        return res.full_legendre(_table_dtype(dtype, precision), device)
    return res.grouped_legendre(_table_dtype(dtype, precision), device)


def _device_of(*arrays) -> torch.device:
    devs = {a.device for a in arrays if a is not None}
    if len(devs) != 1:
        raise ValueError(f"inputs must share one device, got {devs}")
    return devs.pop()


def _check_spec(name, arr, res):
    if arr is not None and (arr.ndim != 2 or arr.shape[1] != res.nspec2):
        raise ValueError(
            f"{name} must have shape (nfld, nspec2={res.nspec2}), "
            f"got {tuple(arr.shape)}")


def _check_grid_arg(name, arr, res):
    if arr is not None and (arr.ndim != 3 or arr.shape[1] != res.ndgl
                            or arr.shape[2] != res.grid.ndlon):
        raise ValueError(
            f"{name} must have shape (nfld, ndgl={res.ndgl}, "
            f"ndlon={res.grid.ndlon}), got {tuple(arr.shape)}")


def _ew_derivative(four: torch.Tensor, racthe: torch.Tensor) -> torch.Tensor:
    """i*m*F scaled by 1/(a cos): Fourier-space E-W derivative (FSC)."""
    M = four.shape[2]
    mvec = torch.arange(M, dtype=four.dtype, device=four.device)[None, :, None]
    re, im = four[:, 0], four[:, 1]
    return torch.stack([-im * mvec, re * mvec], dim=1) * racthe


def inv_trans(res: Resolution, spvor=None, spdiv=None, spscalar=None, *,
              flags: InvFlags = InvFlags(), dtype=torch.float32,
              fspgl_proc=None, npromatr: int | None = None,
              precision: str = "highest",
              _engine: str | None = None) -> torch.Tensor:
    """Inverse transform: packed spectral tensors -> grid fields.

    spvor/spdiv: (nfld_uv, nspec2); spscalar: (nfld_sc, nspec2).  Returns
    (nfld_out, ndgl, ndlon) in the reference PGP field order, on the inputs'
    device.  ``fspgl_proc``: optional callable applied to the Fourier-space
    tensor (nfld_out, 2, M, ndgl) before synthesis (reference FSPGL_PROC,
    ``fspgl_int_mod.F90:13-110``).
    """
    if (spvor is None) != (spdiv is None):
        raise ValueError("spvor and spdiv must be supplied together")
    if spvor is not None and spvor.shape != spdiv.shape:
        raise ValueError(f"spvor/spdiv shape mismatch: {tuple(spvor.shape)} "
                         f"vs {tuple(spdiv.shape)}")
    if spvor is None and spscalar is None:
        raise ValueError("nothing to transform: pass spvor/spdiv and/or spscalar")
    for nm, arr in (("spvor", spvor), ("spdiv", spdiv), ("spscalar", spscalar)):
        _check_spec(nm, arr, res)
    nfld_uv = 0 if spvor is None else spvor.shape[0]
    nfld_sc = 0 if spscalar is None else spscalar.shape[0]
    if npromatr and 2 * nfld_uv + nfld_sc > npromatr:
        return _inv_packets(res, spvor, spdiv, spscalar, flags, dtype,
                            fspgl_proc, npromatr, precision, _engine)
    dtype = check_dtype(dtype)
    eng = _resolve_engine(_engine, dtype)
    pack2 = legendre_matmul.dense_pack()
    _check_precision(precision)
    device = _device_of(spvor, spdiv, spscalar)
    tables = res.device_tables(dtype, device)
    gl = _leg_tables(res, eng, dtype, precision, device)
    racthe = tables.racthe

    # all fields go through ONE Legendre call: the tables are streamed once
    lt_inputs = []
    if nfld_uv:
        dvor = layout.packed_to_dense(spvor.to(dtype), tables)
        ddiv = layout.packed_to_dense(spdiv.to(dtype), tables)
        du, dv = spectral.vordiv_to_uv(dvor, ddiv, tables.vd)
        if flags.vorgp:
            lt_inputs.append(dvor)
        if flags.divgp:
            lt_inputs.append(ddiv)
        lt_inputs += [du, dv]
    if nfld_sc:
        dsc = layout.packed_to_dense(spscalar.to(dtype), tables)
        lt_inputs.append(dsc)
        if flags.scders:
            lt_inputs.append(spectral.ns_derivative(dsc, tables.nsd))
    dense_all = torch.cat(lt_inputs)
    if eng == "dense":
        four_all = legendre_dense.legendre_inv_dense(dense_all, gl, pack2)
    elif eng == "planes":
        four_all = legendre_matmul.inv_planes(dense_all, gl, precision)
    else:
        sym, asym = layout.dense_to_parity(dense_all, res.kmax)
        four_all = legendre_matmul.inv_grouped(sym, asym, gl, eng)

    parts = list(torch.split(four_all, [x.shape[0] for x in lt_inputs]))
    out_groups = []
    uv_four = sc_four = None
    if nfld_uv:
        out_groups += parts[: int(flags.vorgp) + int(flags.divgp)]
        uv_four = torch.cat(parts[len(out_groups): len(out_groups) + 2]) * racthe
        out_groups.append(uv_four)
    if nfld_sc:
        k = len(parts) - (2 if flags.scders else 1)
        sc_four = parts[k]
        out_groups.append(sc_four)
        if flags.scders:
            out_groups.append(parts[k + 1] * racthe)
    if nfld_uv and flags.uvders:
        out_groups.append(_ew_derivative(uv_four, racthe))
    if nfld_sc and flags.scders:
        out_groups.append(_ew_derivative(sc_four, racthe))

    four = torch.cat(out_groups)
    if fspgl_proc is not None:
        four = fspgl_proc(four)
    return fourier.synthesis(four, res)


def dir_trans(res: Resolution, u=None, v=None, scalars=None, *,
              dtype=torch.float32, npromatr: int | None = None,
              precision: str = "highest", _engine: str | None = None):
    """Direct transform: grid fields -> packed spectral tensors.

    u/v: (nfld_uv, ndgl, ndlon) grid winds; scalars: (nfld_sc, ndgl, ndlon).
    Returns (spvor, spdiv, spscalar), each (nfld, nspec2) or None where
    there was no input.
    """
    if (u is None) != (v is None):
        raise ValueError("u and v must be supplied together")
    if u is not None and u.shape != v.shape:
        raise ValueError(f"u/v shape mismatch: {tuple(u.shape)} vs "
                         f"{tuple(v.shape)}")
    if u is None and scalars is None:
        raise ValueError("nothing to transform: pass u/v and/or scalars")
    for nm, arr in (("u", u), ("v", v), ("scalars", scalars)):
        _check_grid_arg(nm, arr, res)
    nfld_uv = 0 if u is None else u.shape[0]
    nfld_sc = 0 if scalars is None else scalars.shape[0]
    if npromatr and 2 * nfld_uv + nfld_sc > npromatr:
        return _dir_packets(res, u, v, scalars, dtype, npromatr, precision,
                            _engine)
    dtype = check_dtype(dtype)
    eng = _resolve_engine(_engine, dtype)
    pack2 = legendre_matmul.dense_pack()
    packing = pack.pack_kernel()
    _check_precision(precision)
    device = _device_of(u, v, scalars)
    tables = res.device_tables(dtype, device)
    gl = _leg_tables(res, eng, dtype, precision, device)
    grids = [x.to(dtype) for x in (u, v, scalars) if x is not None]

    four = fourier.analysis(torch.cat(grids), res)
    if nfld_uv:
        # LDFOU2: u, v Fourier coefficients times 1/(a cos(theta)); four is
        # this function's own tensor, so it is scaled in place
        four[: 2 * nfld_uv] *= tables.racthe
    w = tables.w[: res.ndgnh]
    if eng in ("dense", "planes") and packing == "kernel":
        packed = _dir_rows_packed(res, tables, gl, four, w, nfld_uv, eng,
                                  precision, pack2)
    else:
        packed = _dir_dense_packed(res, tables, gl, four, w, nfld_uv, eng,
                                   precision, pack2, packing)
    spvor = packed[:nfld_uv] if nfld_uv else None
    spdiv = packed[nfld_uv: 2 * nfld_uv] if nfld_uv else None
    spsc = packed[2 * nfld_uv:] if nfld_sc else None
    return spvor, spdiv, spsc


def _chunk_pad(x: torch.Tensor, size: int):
    """Yield equal-``size`` leading-axis chunks of x (the last padded with
    zeros), with the count of real fields in each."""
    for i in range(0, x.shape[0], size):
        c = x[i : i + size]
        real = c.shape[0]
        if real < size:
            c = torch.cat([c, c.new_zeros((size - real,) + c.shape[1:])])
        yield c, real


def _inv_packets(res, spvor, spdiv, spscalar, flags, dtype, fspgl_proc,
                 npromatr, precision, engine):
    """NPROMATR packet loop: uv pairs then scalars, group-wise reassembly
    into the single call's PGP order."""
    nuv = 0 if spvor is None else spvor.shape[0]
    nsc = 0 if spscalar is None else spscalar.shape[0]
    kw = dict(flags=flags, dtype=dtype, fspgl_proc=fspgl_proc,
              precision=precision, _engine=engine)
    parts = {}
    if nuv:
        size = max(1, npromatr // 2)
        for (cv, real), (cd, _) in zip(_chunk_pad(spvor, size),
                                       _chunk_pad(spdiv, size)):
            out = inv_trans(res, cv, cd, None, **kw)
            fl = FieldLayout.inv(real, 0, flags, pad_uv=size)
            for k, blk in fl.split(out).items():
                parts.setdefault(k, []).append(blk)
    if nsc:
        size = max(1, npromatr)
        for csc, real in _chunk_pad(spscalar, size):
            out = inv_trans(res, None, None, csc, **kw)
            fl = FieldLayout.inv(0, real, flags, pad_sc=size)
            for k, blk in fl.split(out).items():
                parts.setdefault(k, []).append(blk)
    order = FieldLayout.inv(nuv, nsc, flags).names
    return torch.cat([blk for k in order for blk in parts[k]])


def _dir_packets(res, u, v, scalars, dtype, npromatr, precision, engine):
    """NPROMATR packet loop of the direct transform: uv pairs then scalars,
    the padded fields of each packet's output dropped."""
    kw = dict(dtype=dtype, precision=precision, _engine=engine)
    sv_p, sd_p, ss_p = [], [], []
    if u is not None:
        size = max(1, npromatr // 2)
        for (cu, real), (cv, _) in zip(_chunk_pad(u, size),
                                       _chunk_pad(v, size)):
            sv, sd, _ = dir_trans(res, cu, cv, None, **kw)
            sv_p.append(sv[:real])
            sd_p.append(sd[:real])
    if scalars is not None:
        for csc, real in _chunk_pad(scalars, max(1, npromatr)):
            ss_p.append(dir_trans(res, None, None, csc, **kw)[2][:real])
    return tuple(torch.cat(p) if p else None for p in (sv_p, sd_p, ss_p))


def _dir_rows_packed(res, tables, gl, four, w, nfld_uv, eng, precision,
                     pack2):
    """"dense"/"planes" direct LT in the kernels' m-major rows -> per-group
    UVTVD -> K3.  Returns packed [vor, div, scalars] (nfld, nspec2)."""
    if eng == "dense":
        rows_list = legendre_dense.legendre_dir_rows(four, gl, w, pack2)
    else:
        rows_list = legendre_matmul.dir_rows_planes(four, gl, w, precision)
    nfld = four.shape[0]
    if nfld_uv:
        # UVTVD per group on the kernel's rows; reorder the channels to
        # c-major [vor, div, scalars]
        out_rows = []
        for rows, g in zip(rows_list, gl.groups):
            vd = spectral.uv_to_vordiv_rows(rows, g.m0, nfld_uv, nfld,
                                            tables.uvtvd_mm)
            out_rows.append(torch.cat([
                vd[:, : 2 * nfld_uv], rows[:, 2 * nfld_uv: nfld],
                vd[:, 2 * nfld_uv:], rows[:, nfld + 2 * nfld_uv:]], dim=1))
        rows_list = out_rows
    return pack.packed_from_group_rows(rows_list, res)


def _dir_dense_packed(res, tables, gl, four, w, nfld_uv, eng, precision,
                      pack2, packing):
    """Direct LT to the dense layout -> dense UVTVD -> K3 ("pallas") or the
    index gather ("xla", and every engine when ``packing`` is "xla")."""
    if eng == "dense":
        dense = legendre_dense.legendre_dir_dense(four, gl, w, res.NP, pack2)
    elif eng == "planes":
        dense = legendre_matmul.dir_planes(four, gl, w, res.NP, precision)
    else:
        sym, asym = legendre_matmul.dir_grouped(four, gl, w, eng)
        dense = layout.parity_to_dense(sym, asym, res.NP)
    if nfld_uv:
        dvor, ddiv = spectral.uv_to_vordiv(dense[:nfld_uv],
                                           dense[nfld_uv: 2 * nfld_uv],
                                           tables.uvtvd)
        dense = torch.cat([dvor, ddiv, dense[2 * nfld_uv:]])
    if eng == "xla" or packing == "xla":
        return layout.dense_to_packed(dense, res)
    return pack.dense_to_packed(dense, res)
