"""Dense-row Legendre transforms (inverse and direct), kernels K1, K2, K7, K8.

Counterpart of the dense-row half of ``ectrans_tpu/ops/legendre_pallas.py``:
the inverse contracts diagonal-realigned dense spectral rows
d2[f, c, m, j] = dense[f, c, m, m+j] against the full-n tables of
``Resolution.full_legendre`` (pn[m, j, i] = P̄_{m+j}^m(mu_i)); the direct
transform contracts quadrature-weighted Fourier rows against the same tables
and returns the kernels' native m-major rows, or the dense layout
(``legendre_dir_dense``).  The southern hemisphere comes from the parity
identity P̄_n^m(-mu) = (-1)^(n-m) P̄_n^m(mu) inside K1/K2; with ``pack2``
(``ECTRANS_TPU_LEG_DENSE_PACK``, read by ``transform.py``) the caller stacks
both hemispheres on the row axis instead, [d2 ; d2 sgn] and [fn ; fs], for
the hemisphere-packed K7/K8, and combines their raw dots.

Kernels run for CUDA tensors: the fp32 and bf16-table variants of K1 and
K7 in ``csrc/legendre_dense2.cu`` and of K2 and K8 in
``csrc/legendre_dense2_dir.cu`` (one pipelined kernel body each, K1 and K2
its parity mode), the fp64 variants of all four in
``csrc/legendre_dense.cu``; CPU tensors take
the plain PyTorch versions (``torch.bmm`` per group in the working dtype).
A bf16 table (the "bf16" tier) takes fp32 operands rounded to bf16, so
every product is exact in fp32, as the TPU kernels' mode "bf16" computes:
the bf16-table kernel variants round while staging, the plain versions
through ``plain_operands``.  Realignment past a row's diagonal end reads
neighbouring rows' data; it is cancelled by the exact zeros of the tables
(past n = nsmax+1, and where m > nmen(lat)).  ``group_rows``,
``hemispheres_to_fourier``, ``weighted_rows`` and ``rows_to_dense`` (one
group's kernel operand rows, and the assembly of its outputs) serve the
"pallas" and "planes" engines too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .layout import diag_realign, diag_unalign


def _jsgn(J: int, like: torch.Tensor) -> torch.Tensor:
    """(J,) parity sign: +1 for even j, -1 for odd j."""
    j = torch.arange(J, device=like.device)
    return (1 - 2 * (j & 1)).to(like.dtype)


def plain_operands(table: torch.Tensor, *xs: torch.Tensor):
    """The table and operands a plain version multiplies: a bf16 table in
    fp32 and the fp32 operands rounded to bf16 (exact products); else all
    as given."""
    if table.dtype != torch.bfloat16:
        return (table, *xs)
    for x in xs:
        if x.dtype != torch.float32:
            raise TypeError(f"a bf16 table takes float32 operands, got "
                            f"{x.dtype}")
    return (table.float(), *(x.to(torch.bfloat16).float() for x in xs))


def group_inv_dense_plain(d2: torch.Tensor, pn: torch.Tensor):
    """Plain version of K1: (gm, fc2, J) x (gm, J, ig) -> (north, south)."""
    pn, d2 = plain_operands(pn, d2)
    north = torch.bmm(d2, pn)
    south = torch.bmm(d2 * _jsgn(d2.shape[-1], d2), pn)
    return north, south


def group_inv_dense(d2: torch.Tensor, pn: torch.Tensor):
    """One group's inverse LT (K1; replaces ``legendre_pallas.group_inv_dense``):
    rows d2 (gm, fc2, J) x table pn (gm, J, ig) -> (north, south), each
    (gm, fc2, ig); north = sum_j d2_j P_j, south = sum_j (-1)^j d2_j P_j
    (south NOT latitude-reversed)."""
    if _build.on_cpu(d2):
        return group_inv_dense_plain(d2, pn)
    gm, fc2, J = d2.shape
    ig = pn.shape[-1]
    tdt = _build.table_dtype(d2, pn)
    _build.check_operand("d2", d2, d2, (gm, fc2, J))
    _build.check_operand("pn", pn, d2, (gm, J, ig), dtype=tdt)
    north = torch.empty((gm, fc2, ig), dtype=d2.dtype, device=d2.device)
    south = torch.empty_like(north)
    if north.numel() == 0:
        return north.zero_(), south.zero_()
    with _build.on_device(d2):
        _build.launch("ect_inv_dense", tdt, d2.data_ptr(), pn.data_ptr(),
                      north.data_ptr(), south.data_ptr(), gm, fc2, J, ig)
    group_inv_dense.launches += 1
    return north, south


group_inv_dense.launches = 0


def group_inv_dense_shape(gm: int, fc2: int, ig: int,
                          table_dtype: torch.dtype = torch.float32) -> dict:
    """K1's launch for one group (``_build.launch_shape``)."""
    return _build.launch_shape("ect_inv_dense_shape", table_dtype, gm, fc2,
                               ig)


def group_dir_dense_plain(fn: torch.Tensor, fs: torch.Tensor,
                          pn: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: fn, fs (gm, fc2, ig) x pn (gm, J, ig) -> (gm, fc2, J)."""
    pn, fn, fs = plain_operands(pn, fn, fs)
    pt = pn.transpose(1, 2)
    a = torch.bmm(fn, pt)
    b = torch.bmm(fs, pt)
    return a + b * _jsgn(pn.shape[1], a)


def group_dir_dense(fn: torch.Tensor, fs: torch.Tensor,
                    pn: torch.Tensor) -> torch.Tensor:
    """One group's direct LT (K2; replaces ``legendre_pallas.group_dir_dense``):
    weighted north/south Fourier rows fn, fs (gm, fc2, ig) x table pn
    (gm, J, ig) -> realigned rows out_j = sum_i fn_i P_ji + (-1)^j sum_i fs_i P_ji."""
    if _build.on_cpu(fn):
        return group_dir_dense_plain(fn, fs, pn)
    gm, fc2, ig = fn.shape
    J = pn.shape[1]
    tdt = _build.table_dtype(fn, pn)
    _build.check_operand("fn", fn, fn, (gm, fc2, ig))
    _build.check_operand("fs", fs, fn, (gm, fc2, ig))
    _build.check_operand("pn", pn, fn, (gm, J, ig), dtype=tdt)
    out = torch.empty((gm, fc2, J), dtype=fn.dtype, device=fn.device)
    if out.numel() == 0:
        return out
    with _build.on_device(fn):
        _build.launch("ect_dir_dense", tdt, fn.data_ptr(), fs.data_ptr(),
                      pn.data_ptr(), out.data_ptr(), gm, fc2, J, ig)
    group_dir_dense.launches += 1
    return out


group_dir_dense.launches = 0


def group_dir_dense_shape(gm: int, fc2: int, J: int,
                          table_dtype: torch.dtype = torch.float32) -> dict:
    """K2's launch for one group (``_build.launch_shape``)."""
    return _build.launch_shape("ect_dir_dense_shape", table_dtype, gm, fc2,
                               J)


def group_inv_dense2_plain(d4: torch.Tensor, pn: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: (gm, 2 fc2, J) x (gm, J, ig) -> (gm, 2 fc2, ig)."""
    pn, d4 = plain_operands(pn, d4)
    return torch.bmm(d4, pn)


def group_inv_dense2(d4: torch.Tensor, pn: torch.Tensor) -> torch.Tensor:
    """One group's hemisphere-packed inverse LT (K7; replaces
    ``legendre_pallas.group_inv_dense2``): stacked rows d4 = [d2 ; d2 sgn]
    (gm, 2 fc2, J) x table pn (gm, J, ig) -> (gm, 2 fc2, ig), north in rows
    [:fc2] and south (NOT latitude-reversed) in rows [fc2:]."""
    if _build.on_cpu(d4):
        return group_inv_dense2_plain(d4, pn)
    gm, fc4, J = d4.shape
    ig = pn.shape[-1]
    tdt = _build.table_dtype(d4, pn)
    _build.check_operand("d4", d4, d4, (gm, fc4, J))
    _build.check_operand("pn", pn, d4, (gm, J, ig), dtype=tdt)
    out = torch.empty((gm, fc4, ig), dtype=d4.dtype, device=d4.device)
    if out.numel() == 0:
        return out.zero_()
    with _build.on_device(d4):
        _build.launch("ect_inv_dense2", tdt, d4.data_ptr(), pn.data_ptr(),
                      out.data_ptr(), gm, fc4, J, ig)
    group_inv_dense2.launches += 1
    return out


group_inv_dense2.launches = 0


def group_inv_dense2_shape(gm: int, fc4: int, ig: int,
                           table_dtype: torch.dtype = torch.float32) -> dict:
    """K7's launch for one group (``_build.launch_shape``)."""
    return _build.launch_shape("ect_inv_dense2_shape", table_dtype, gm, fc4,
                               ig)


def group_dir_dense2_plain(f4: torch.Tensor, pn: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: (gm, 2 fc2, ig) x (gm, J, ig) -> (gm, 2 fc2, J)."""
    pn, f4 = plain_operands(pn, f4)
    return torch.bmm(f4, pn.transpose(1, 2))


def group_dir_dense2(f4: torch.Tensor, pn: torch.Tensor) -> torch.Tensor:
    """One group's hemisphere-packed direct LT (K8; replaces
    ``legendre_pallas.group_dir_dense2``): stacked weighted Fourier rows
    f4 = [fn ; fs] (gm, 2 fc2, ig) x table pn (gm, J, ig) -> the raw dots
    (gm, 2 fc2, J); the caller combines rows a + b sgn(j)."""
    if _build.on_cpu(f4):
        return group_dir_dense2_plain(f4, pn)
    gm, fc4, ig = f4.shape
    J = pn.shape[1]
    tdt = _build.table_dtype(f4, pn)
    _build.check_operand("f4", f4, f4, (gm, fc4, ig))
    _build.check_operand("pn", pn, f4, (gm, J, ig), dtype=tdt)
    out = torch.empty((gm, fc4, J), dtype=f4.dtype, device=f4.device)
    if out.numel() == 0:
        return out
    with _build.on_device(f4):
        _build.launch("ect_dir_dense2", tdt, f4.data_ptr(), pn.data_ptr(),
                      out.data_ptr(), gm, fc4, J, ig)
    group_dir_dense2.launches += 1
    return out


group_dir_dense2.launches = 0


def group_dir_dense2_shape(gm: int, fc4: int, J: int,
                           table_dtype: torch.dtype = torch.float32) -> dict:
    """K8's launch for one group (``_build.launch_shape``)."""
    return _build.launch_shape("ect_dir_dense2_shape", table_dtype, gm, fc4,
                               J)


def group_rows(x: torch.Tensor, g) -> torch.Tensor:
    """(a, b, M, W) -> one m-group's contiguous (gm, a*b, W) rows, row
    index i*b + j (f*2 + c for the (nfld, 2, ...) layout, c*nfld + f for
    its c-major transpose)."""
    a, b, _, width = x.shape
    return x[:, :, g.m0:g.m1].reshape(a * b, g.m1 - g.m0, width) \
        .transpose(0, 1).contiguous()


def hemispheres_to_fourier(north: torch.Tensor, south: torch.Tensor,
                           g, nfld: int) -> torch.Tensor:
    """One group's kernel outputs (gm, 2*nfld, ig), rows f*2 + c, south not
    latitude-reversed -> (nfld, 2, gm, ndgl) Fourier coefficients north ->
    south, zero at the group's inactive latitudes."""
    gm = g.m1 - g.m0
    north = north.transpose(0, 1).reshape(nfld, 2, gm, -1)
    south = south.transpose(0, 1).reshape(nfld, 2, gm, -1).flip(-1)
    return torch.cat([F.pad(north, (g.i0, 0)), F.pad(south, (0, g.i0))],
                     dim=-1)


def weighted_rows(fourier: torch.Tensor, ndgnh: int, w: torch.Tensor):
    """c-major quadrature-weighted northern rows and NH-paired southern
    rows, each (2, nfld, M, ndgnh)."""
    fc = fourier.transpose(0, 1)
    return fc[..., :ndgnh] * w, fc[..., ndgnh:].flip(-1) * w


def rows_to_dense(rows_list: list, groups, nfld: int, NP: int) -> torch.Tensor:
    """Per-group c-major realigned rows (gm, 2*nfld, J) -> the dense layout
    (nfld, 2, M, NP); entries at n < m are neighbouring rows' data."""
    parts = []
    for g, rows in zip(groups, rows_list, strict=True):
        d2g = rows.reshape(g.m1 - g.m0, 2, nfld, g.J).permute(2, 1, 0, 3)
        parts.append(F.pad(d2g, (0, NP + 1 - g.J)))
    return diag_unalign(torch.cat(parts, dim=2), NP)


def legendre_inv_dense(dense: torch.Tensor, fl,
                       pack2: bool = False) -> torch.Tensor:
    """Inverse LT: (nfld, 2, M, NP) dense spectral -> (nfld, 2, M, ndgl)
    Fourier coefficients, latitudes north -> south (fl: FullLegendre);
    K7 on stacked hemispheres with ``pack2``, else K1."""
    return legendre_inv_rows(diag_realign(dense), fl, pack2)


def legendre_inv_rows(d2: torch.Tensor, fl,
                      pack2: bool = False) -> torch.Tensor:
    """``legendre_inv_dense`` on realigned rows d2 (nfld, 2, M', W) with
    W >= every group's J, each group at rows [g.m0, g.m1) (the distributed
    transforms' local m-blocks, in which row index is not m)."""
    nfld = d2.shape[0]
    parts = []
    for g in fl.groups:
        dg = group_rows(d2[..., :g.J], g)
        if pack2:
            o = group_inv_dense2(torch.cat([dg, dg * _jsgn(g.J, dg)], dim=1),
                                 g.pn)
            north, south = o[:, :2 * nfld], o[:, 2 * nfld:]
        else:
            north, south = group_inv_dense(dg, g.pn)
        parts.append(hemispheres_to_fourier(north, south, g, nfld))
    return torch.cat(parts, dim=2)


def legendre_dir_rows(fourier: torch.Tensor, fl, w: torch.Tensor,
                      pack2: bool = False) -> list:
    """Direct LT in the kernels' native m-major layout: (nfld, 2, M, ndgl)
    Fourier coefficients + NH quadrature weights w (ndgnh,) -> list of
    per-group (gm, 2*nfld, J) realigned rows, row index c*nfld + f; K8 on
    stacked hemispheres with ``pack2``, else K2."""
    fc2 = 2 * fourier.shape[0]
    fn_all, fs_all = weighted_rows(fourier, fl.ndgnh, w)
    rows = []
    for g in fl.groups:
        fn = group_rows(fn_all[..., g.i0:], g)
        fs = group_rows(fs_all[..., g.i0:], g)
        if pack2:
            raw = group_dir_dense2(torch.cat([fn, fs], dim=1), g.pn)
            rows.append(raw[:, :fc2] + raw[:, fc2:] * _jsgn(g.J, raw))
        else:
            rows.append(group_dir_dense(fn, fs, g.pn))
    return rows


def legendre_dir_dense(fourier: torch.Tensor, fl, w: torch.Tensor, NP: int,
                       pack2: bool = False) -> torch.Tensor:
    """Direct LT to the dense layout: (nfld, 2, M, ndgl) Fourier
    coefficients + NH weights -> (nfld, 2, M, NP) dense spectral rows
    (entries at n < m are neighbouring rows' data)."""
    return rows_to_dense(legendre_dir_rows(fourier, fl, w, pack2), fl.groups,
                         fourier.shape[0], NP)
