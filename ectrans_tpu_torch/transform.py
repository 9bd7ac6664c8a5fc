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

* "dense": dense-row kernels K1/K2 on ``Resolution.full_legendre``; the
  direct transform runs UVTVD per group on the kernel's m-major rows and
  packs them with K3, never forming the (nfld, 2, M, NP) dense tensor;
* "planes": bf16 limb-plane kernels K9/K10 on ``planes_legendre``, the same
  m-major direct path; the only engine with the tiers "high" and "bf16";
  fp64 transforms resolve to "xla";
* "pallas" and "xla": parity split (``layout.dense_to_parity``) and the
  grouped kernels K5/K6 or per-group einsums on ``grouped_legendre``; the
  direct transform goes back to the dense layout (``parity_to_dense``),
  runs the dense UVTVD and packs with K3 ("pallas") or the index gather
  ("xla").

The tables of every engine derive from the full-n tables (kernel K4 on a
GPU).  Field order of the inverse output (``inv_trans.F90:58-106``): vor?,
div?, u, v, scalars, N-S derivatives of scalars?, E-W derivatives of u and
v?, E-W derivatives of scalars?.

Not carried over from the JAX package: the dispatch splits and
``optimization_barrier`` guards against TPU-compiler faults, and the
analysis of u/v and scalars in separate calls.  NPROMATR packets are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

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


def _check_options(precision: str, npromatr, eng: str) -> None:
    if precision not in legendre_matmul.TIERS[eng]:
        raise NotImplementedError(
            f"precision {precision!r} on the {eng!r} Legendre engine: only "
            f"{legendre_matmul.TIERS[eng]} are ported (the 'high' and 'bf16' "
            "tiers of the other engines are queued in ROADMAP.md, queue A "
            "item 3)")
    if npromatr:
        raise NotImplementedError(
            "npromatr field packets are not ported (ROADMAP.md, queue A "
            "item 2: transform.py and field_layout.py)")


def _leg_tables(res: Resolution, eng: str, dtype: torch.dtype,
                precision: str, device: torch.device):
    """The Legendre tables an engine streams: limb planes ("planes"),
    full-n tables ("dense") or parity pairs ("xla", "pallas")."""
    if eng == "planes":
        return res.planes_legendre(planes_for_tier(precision), device)
    if eng == "dense":
        return res.full_legendre(dtype, device)
    return res.grouped_legendre(dtype, device)


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
    dtype = check_dtype(dtype)
    eng = _resolve_engine(_engine, dtype)
    _check_options(precision, npromatr, eng)
    device = _device_of(spvor, spdiv, spscalar)
    tables = res.device_tables(dtype, device)
    gl = _leg_tables(res, eng, dtype, precision, device)
    racthe = tables.racthe
    nfld_uv = 0 if spvor is None else spvor.shape[0]
    nfld_sc = 0 if spscalar is None else spscalar.shape[0]

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
        four_all = legendre_dense.legendre_inv_dense(dense_all, gl)
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
    dtype = check_dtype(dtype)
    eng = _resolve_engine(_engine, dtype)
    _check_options(precision, npromatr, eng)
    device = _device_of(u, v, scalars)
    tables = res.device_tables(dtype, device)
    gl = _leg_tables(res, eng, dtype, precision, device)
    nfld_uv = 0 if u is None else u.shape[0]
    grids = [x.to(dtype) for x in (u, v, scalars) if x is not None]

    four = fourier.analysis(torch.cat(grids), res)
    if nfld_uv:
        # LDFOU2: u, v Fourier coefficients times 1/(a cos(theta)); four is
        # this function's own tensor, so it is scaled in place
        four[: 2 * nfld_uv] *= tables.racthe
    w = tables.w[: res.ndgnh]
    if eng in ("dense", "planes"):
        packed = _dir_rows_packed(res, tables, gl, four, w, nfld_uv, eng,
                                  precision)
    else:
        packed = _dir_dense_packed(res, tables, gl, four, w, nfld_uv, eng)
    nsc = four.shape[0] - 2 * nfld_uv
    spvor = packed[:nfld_uv] if nfld_uv else None
    spdiv = packed[nfld_uv: 2 * nfld_uv] if nfld_uv else None
    spsc = packed[2 * nfld_uv:] if nsc else None
    return spvor, spdiv, spsc


def _dir_rows_packed(res, tables, gl, four, w, nfld_uv, eng, precision):
    """"dense"/"planes" direct LT in the kernels' m-major rows -> per-group
    UVTVD -> K3.  Returns packed [vor, div, scalars] (nfld, nspec2)."""
    if eng == "dense":
        rows_list = legendre_dense.legendre_dir_rows(four, gl, w)
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


def _dir_dense_packed(res, tables, gl, four, w, nfld_uv, eng):
    """"xla"/"pallas" grouped direct LT -> dense layout -> dense UVTVD ->
    K3 ("pallas") or the index gather ("xla")."""
    sym, asym = legendre_matmul.dir_grouped(four, gl, w, eng)
    dense = layout.parity_to_dense(sym, asym, res.NP)
    if nfld_uv:
        dvor, ddiv = spectral.uv_to_vordiv(dense[:nfld_uv],
                                           dense[nfld_uv: 2 * nfld_uv],
                                           tables.uvtvd)
        dense = torch.cat([dvor, ddiv, dense[2 * nfld_uv:]])
    if eng == "pallas":
        return pack.dense_to_packed(dense, res)
    return layout.dense_to_packed(dense, res)
