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
once per call, here, and passed down: the engine knobs and the table knobs
``ECTRANS_TPU_LEG_GROUPS`` (the tables' m-groups, which K3 packs) and
``ECTRANS_TPU_TABLE_SOURCE`` (``resolution.leg_groups``, ``table_source``).

The tables of every engine derive from the full-n tables (kernel K4 on a
GPU, unless the table source is "host").  Field order of the inverse output (``inv_trans.F90:58-106``): vor?,
div?, u, v, scalars, N-S derivatives of scalars?, E-W derivatives of u and
v?, E-W derivatives of scalars?.

NPROMATR packets (``npromatr``): a call with 2 nuv + nsc > npromatr runs
as packets, uv pairs (npromatr // 2 a packet) then scalars (npromatr a
packet), each zero-padded to its kind's uniform size, so that every packet
launches the same kernel shapes and sums in the same order; the inverse
output is reassembled in the single call's PGP order (``FieldLayout``), the
direct output drops the padded fields.

The Fourier layer is the bucketed chirp-z one (``fourier.
synthesis_bucketed``/``analysis_bucketed`` on ``fourier.bucketed_tables``,
``ECTRANS_TPU_FFT_BUCKETS`` buckets, read once per call), with each field
scaled by its RMS around the pair pack unless ``_normalize=False``; the
private ``_fourier="rows"`` runs the per-NLOEN layer instead (the tests'
reference and ``chip_smoke.py``'s A/B).

Both transforms are linear in their fields and differentiable through
every layer on the "xla" engine with ``_normalize=False`` (the adjoints of
``adjoint.py``; the Fourier layer's kernels through its
``autograd.Function``s); the kernels of the other engines have no autograd
rule.

The layers are spans of ``utils.timing`` (nothing while its recorder is
off): ``api.inv_trans``/``api.dir_trans`` around each call (and each
packet), ``spectral``, ``legendre`` and ``fourier`` inside them.

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
from .resolution import Resolution, check_dtype, leg_groups, table_source
from .utils.timing import hook


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
                precision: str, device: torch.device, ngroups: int,
                source: str):
    """The Legendre tables an engine streams, in ``ngroups`` m-groups from
    ``source``: limb planes ("planes"), full-n tables ("dense") or parity
    pairs ("xla", "pallas")."""
    if eng == "planes":
        return res.planes_legendre(planes_for_tier(precision), device,
                                   ngroups, source)
    if eng == "dense":
        return res.full_legendre(_table_dtype(dtype, precision), device,
                                 ngroups, source)
    return res.grouped_legendre(_table_dtype(dtype, precision), device,
                                ngroups, source)


FOURIER_LAYERS = ("buckets", "rows")


def _check_fourier(layer: str) -> None:
    if layer not in FOURIER_LAYERS:
        raise ValueError(f"unknown Fourier layer {layer!r}; expected one of "
                         f"{FOURIER_LAYERS}")


def synthesis(four, res, normalize=True, layer="buckets"):
    """The inverse transform's Fourier synthesis on ``layer``."""
    with hook("fourier"):
        if layer == "rows":
            return fourier.synthesis(four, res)
        return fourier.synthesis_bucketed(
            four, fourier.bucketed_tables(res, four.device), normalize)


def analysis(grid, res, normalize=True, layer="buckets"):
    """The direct transform's Fourier analysis on ``layer``."""
    with hook("fourier"):
        if layer == "rows":
            return fourier.analysis(grid, res)
        return fourier.analysis_bucketed(
            grid, fourier.bucketed_tables(res, grid.device), res.M, normalize)


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


def legendre_inputs(dvor, ddiv, dsc, flags: InvFlags, vd: dict,
                    nsd: dict) -> list:
    """The inverse LT's input groups from dense vor/div (None without
    winds) and scalars (None without), in the engine's row layout:
    [vor?, div?, u, v, scalars, N-S derivatives?] (VDTUV, SPNSDE)."""
    out = []
    if dvor is not None:
        du, dv = spectral.vordiv_to_uv(dvor, ddiv, vd)
        out += [x for x, on in ((dvor, flags.vorgp), (ddiv, flags.divgp))
                if on] + [du, dv]
    if dsc is not None:
        out.append(dsc)
        if flags.scders:
            out.append(spectral.ns_derivative(dsc, nsd))
    return out


def fsc(four: torch.Tensor, nuv: int, nsc: int, flags: InvFlags,
        racthe: torch.Tensor) -> torch.Tensor:
    """FSC on Fourier rows (F1, 2, M, rows), m in natural order: the
    inverse LT's groups (``legendre_inputs``) -> the PGP groups, u, v and
    the N-S derivatives times 1/(a cos) of each row (``racthe``), the E-W
    derivatives i*m*F/(a cos) appended."""
    mval = torch.arange(four.shape[2], dtype=four.dtype,
                        device=four.device)[None, :, None]

    def ew(x):
        return torch.stack([-x[:, 1] * mval, x[:, 0] * mval], 1) * racthe

    i, out = 0, []
    for on in (nuv and flags.vorgp, nuv and flags.divgp):
        if on:
            out.append(four[i: i + nuv])
            i += nuv
    uvf = scf = None
    if nuv:
        uvf = four[i: i + 2 * nuv] * racthe
        out.append(uvf)
        i += 2 * nuv
    if nsc:
        scf = four[i: i + nsc]
        out.append(scf)
        if flags.scders:
            out.append(four[i + nsc: i + 2 * nsc] * racthe)
    if nuv and flags.uvders:
        out.append(ew(uvf))
    if nsc and flags.scders:
        out.append(ew(scf))
    return torch.cat(out)


def inv_trans(res: Resolution, spvor=None, spdiv=None, spscalar=None, *,
              flags: InvFlags = InvFlags(), dtype=torch.float32,
              fspgl_proc=None, npromatr: int | None = None,
              precision: str = "highest", _normalize: bool = True,
              _engine: str | None = None,
              _fourier: str = "buckets") -> torch.Tensor:
    """Inverse transform: packed spectral tensors -> grid fields.

    spvor/spdiv: (nfld_uv, nspec2); spscalar: (nfld_sc, nspec2).  Returns
    (nfld_out, ndgl, ndlon) in the reference PGP field order, on the inputs'
    device.  ``fspgl_proc``: optional callable applied to the Fourier-space
    tensor (nfld_out, 2, M, ndgl) before synthesis (reference FSPGL_PROC,
    ``fspgl_int_mod.F90:13-110``).
    """
    with hook("api.inv_trans"):
        if (spvor is None) != (spdiv is None):
            raise ValueError("spvor and spdiv must be supplied together")
        if spvor is not None and spvor.shape != spdiv.shape:
            raise ValueError(f"spvor/spdiv shape mismatch: "
                             f"{tuple(spvor.shape)} vs {tuple(spdiv.shape)}")
        if spvor is None and spscalar is None:
            raise ValueError("nothing to transform: pass spvor/spdiv "
                             "and/or spscalar")
        for nm, arr in (("spvor", spvor), ("spdiv", spdiv),
                        ("spscalar", spscalar)):
            _check_spec(nm, arr, res)
        nfld_uv = 0 if spvor is None else spvor.shape[0]
        nfld_sc = 0 if spscalar is None else spscalar.shape[0]
        if npromatr and 2 * nfld_uv + nfld_sc > npromatr:
            return _inv_packets(res, spvor, spdiv, spscalar, flags, dtype,
                                fspgl_proc, npromatr, precision,
                                dict(_normalize=_normalize, _engine=_engine,
                                     _fourier=_fourier))
        dtype = check_dtype(dtype)
        _check_fourier(_fourier)
        eng = _resolve_engine(_engine, dtype)
        pack2 = legendre_matmul.dense_pack()
        _check_precision(precision)
        device = _device_of(spvor, spdiv, spscalar)
        tables = res.device_tables(dtype, device)
        gl = _leg_tables(res, eng, dtype, precision, device,
                         leg_groups(res.M), table_source(device))

        def dense(x):
            return (None if x is None
                    else layout.packed_to_dense(x.to(dtype), tables))

        # all fields go through ONE Legendre call: the tables are streamed
        # once
        with hook("spectral"):
            dense_all = torch.cat(legendre_inputs(
                dense(spvor), dense(spdiv), dense(spscalar), flags, tables.vd,
                tables.nsd))
            if eng not in ("dense", "planes"):
                sym, asym = layout.dense_to_parity(dense_all, res.kmax)
        with hook("legendre"):
            if eng == "dense":
                four_all = legendre_dense.legendre_inv_dense(dense_all, gl,
                                                             pack2)
            elif eng == "planes":
                four_all = legendre_matmul.inv_planes(dense_all, gl,
                                                      precision)
            else:
                four_all = legendre_matmul.inv_grouped(sym, asym, gl, eng)

        with hook("spectral"):
            four = fsc(four_all, nfld_uv, nfld_sc, flags, tables.racthe)
        if fspgl_proc is not None:
            four = fspgl_proc(four)
        return synthesis(four, res, _normalize, _fourier)


def dir_trans(res: Resolution, u=None, v=None, scalars=None, *,
              dtype=torch.float32, npromatr: int | None = None,
              precision: str = "highest", _normalize: bool = True,
              _engine: str | None = None, _fourier: str = "buckets"):
    """Direct transform: grid fields -> packed spectral tensors.

    u/v: (nfld_uv, ndgl, ndlon) grid winds; scalars: (nfld_sc, ndgl, ndlon).
    Returns (spvor, spdiv, spscalar), each (nfld, nspec2) or None where
    there was no input.
    """
    with hook("api.dir_trans"):
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
            return _dir_packets(res, u, v, scalars, dtype, npromatr,
                                precision,
                                dict(_normalize=_normalize, _engine=_engine,
                                     _fourier=_fourier))
        dtype = check_dtype(dtype)
        _check_fourier(_fourier)
        eng = _resolve_engine(_engine, dtype)
        pack2 = legendre_matmul.dense_pack()
        packing = pack.pack_kernel()
        _check_precision(precision)
        device = _device_of(u, v, scalars)
        tables = res.device_tables(dtype, device)
        ngroups = leg_groups(res.M)
        gl = _leg_tables(res, eng, dtype, precision, device, ngroups,
                         table_source(device))
        grids = [x.to(dtype) for x in (u, v, scalars) if x is not None]

        four = analysis(torch.cat(grids), res, _normalize, _fourier)
        if nfld_uv:
            # LDFOU2: u, v Fourier coefficients times 1/(a cos(theta)); four
            # is this function's own tensor, so it is scaled in place
            with hook("spectral"):
                four[: 2 * nfld_uv] *= tables.racthe
        w = tables.w[: res.ndgnh]
        if eng in ("dense", "planes") and packing == "kernel":
            packed = _dir_rows_packed(res, tables, gl, four, w, nfld_uv,
                                      eng, precision, pack2, ngroups)
        else:
            packed = _dir_dense_packed(res, tables, gl, four, w, nfld_uv,
                                       eng, precision, pack2, packing,
                                       ngroups)
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
                 npromatr, precision, private):
    """NPROMATR packet loop: uv pairs then scalars, group-wise reassembly
    into the single call's PGP order; ``private``: the private keywords
    of each packet's call."""
    nuv = 0 if spvor is None else spvor.shape[0]
    nsc = 0 if spscalar is None else spscalar.shape[0]
    kw = dict(flags=flags, dtype=dtype, fspgl_proc=fspgl_proc,
              precision=precision, **private)
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


def _dir_packets(res, u, v, scalars, dtype, npromatr, precision, private):
    """NPROMATR packet loop of the direct transform: uv pairs then scalars,
    the padded fields of each packet's output dropped."""
    kw = dict(dtype=dtype, precision=precision, **private)
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
                     pack2, ngroups):
    """"dense"/"planes" direct LT in the kernels' m-major rows -> per-group
    UVTVD -> K3.  Returns packed [vor, div, scalars] (nfld, nspec2)."""
    with hook("legendre"):
        if eng == "dense":
            rows_list = legendre_dense.legendre_dir_rows(four, gl, w, pack2)
        else:
            rows_list = legendre_matmul.dir_rows_planes(four, gl, w,
                                                        precision)
    with hook("spectral"):
        if nfld_uv:
            # UVTVD per group on the kernel's rows, channels to c-major
            # [vor, div, scalars]
            rows_list = spectral.vordiv_rows(rows_list, gl.groups, nfld_uv,
                                             four.shape[0], tables.uvtvd_mm)
        return pack.packed_from_group_rows(rows_list, res, ngroups)


def _dir_dense_packed(res, tables, gl, four, w, nfld_uv, eng, precision,
                      pack2, packing, ngroups):
    """Direct LT to the dense layout -> dense UVTVD -> K3 ("pallas") or the
    index gather ("xla", and every engine when ``packing`` is "xla")."""
    with hook("legendre"):
        if eng == "dense":
            dense = legendre_dense.legendre_dir_dense(four, gl, w, res.NP,
                                                      pack2)
        elif eng == "planes":
            dense = legendre_matmul.dir_planes(four, gl, w, res.NP, precision)
        else:
            sym, asym = legendre_matmul.dir_grouped(four, gl, w, eng)
    with hook("spectral"):
        if eng not in ("dense", "planes"):
            dense = layout.parity_to_dense(sym, asym, res.NP)
        if nfld_uv:
            dvor, ddiv = spectral.uv_to_vordiv(dense[:nfld_uv],
                                               dense[nfld_uv: 2 * nfld_uv],
                                               tables.uvtvd)
            dense = torch.cat([dvor, ddiv, dense[2 * nfld_uv:]])
        if eng == "xla" or packing == "xla":
            return layout.dense_to_packed(dense, res)
        return pack.dense_to_packed(dense, res, ngroups)
