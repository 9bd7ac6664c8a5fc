"""Legendre table generation on the card, kernel K4.

Counterpart of ``ectrans_tpu/ops/legendre_tablegen.py``: builds the full-n
tables of ``Resolution.full_legendre`` (pn[m, j, i] = P̄_{m+j}^m(mu_i), per
m-group) on a CUDA device from a few MB of seeds and recurrence coefficients,
so that setup never builds or uploads the multi-GiB host tables.

The recurrence (``suleg_mod.F90`` / SUPOLF convention)

    P̄_n = A(m, n-m) mu P̄_{n-1} - B(m, n-m) P̄_{n-2},
    A = 1 / eps(n, m),  B = eps(n-1, m) / eps(n, m),

runs in fp64 per (m, latitude) from the sectoral seed P̄_m^m = mant * 2^E,
with power-of-two rescaling of the running pair.  ``gen_group_plain`` is the
same sequence of fp64 operations in PyTorch, vectorized over (m, latitude),
rescaling at every step: it is the CPU path and the kernel's reference on the
card.  The kernel tests for rescaling every 4 steps, which gives the same
values (a power-of-two scaling is exact while values stay normal).

``gen_groups`` makes the tables of several groups in one launch (a
``full_legendre`` build); ``gen_group`` makes one (the one-group-at-a-time
derivations of ``Resolution._source_groups``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..legendre import eps_table, sectoral_seeds

_RS_HI = 2.0 ** 256
_RS_LO = 2.0 ** -256
_RS_SHIFT = 256
_E_FLUSH = -1400   # |mantissa| <= 2^257: 2^-1400 * 2^257 < fp64 tiny
THREADS = 128      # K4's block (csrc/tablegen.cu)
K4_PARAM_GROUPS = 16   # groups whose descriptors fit K4's parameter block
_OUT_DTYPES = (torch.float32, torch.float64, torch.bfloat16)


def host_inputs(res) -> dict:
    """fp64 recurrence inputs of a Resolution's NH Gaussian latitudes
    (``recurrence_inputs``)."""
    return recurrence_inputs(res.nsmax, res.mu[: res.ndgnh],
                             res.nmen[: res.ndgnh])


def recurrence_inputs(nsmax: int, mu, nmen) -> dict:
    """fp64 recurrence inputs at the nodes mu (nlat,): coefficients A, B
    (M, nsmax+4), seed mantissas (M, nlat) in [0.5, 1) (0 where
    m > nmen(lat), and where the seed is 0: the sectoral seeds of m > 0 at
    a pole), int32 seed exponents, and the nodes mu."""
    M = nsmax + 1
    nmax = nsmax + 1
    mu = np.array(mu, np.float64)
    nmen = np.asarray(nmen)

    smant64, sexp64 = sectoral_seeds(nsmax, mu)
    mant, e2 = np.frexp(smant64)
    sexp = (sexp64 + e2).astype(np.int32)
    mask = np.arange(M)[:, None] <= nmen[None, :]
    mant = np.where(mask, mant, 0.0)

    eps = eps_table(nsmax, 3)
    T = nmax + 3
    ts = np.arange(T)
    ms = np.arange(M)
    nmat = ms[:, None] + ts[None, :]
    nclip = np.minimum(nmat, nsmax + 3)
    en = eps[ms[:, None], nclip]
    enm1 = eps[ms[:, None], np.maximum(nclip - 1, 0)]
    valid = (ts[None, :] >= 1) & (nmat <= nmax) & (en > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        A = np.where(valid, 1.0 / np.where(en == 0, 1.0, en), 0.0)
        B = np.where(valid, enm1 / np.where(en == 0, 1.0, en), 0.0)
    return dict(A=A, B=B, mant=mant, exp=sexp, mu=mu)


def _device_inputs(res, device: torch.device) -> dict:
    return res.cached(("tablegen_inputs", str(device)), lambda: {
        k: torch.as_tensor(v, device=device).contiguous()
        for k, v in host_inputs(res).items()})


def _pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e in fp64 for integer |e| <= 1022, from the exponent bits."""
    return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)


def _emit(p: torch.Tensor, E: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    e1 = torch.div(E, 2, rounding_mode="trunc")
    v = p * _pow2(e1.clamp(min=-700)) * _pow2((E - e1).clamp(min=-700))
    keep = (E >= _E_FLUSH) & (v.abs() >= torch.finfo(dtype).tiny)
    v = torch.where(keep, v, torch.zeros_like(v))
    if dtype == torch.bfloat16:     # rounded as the fp32 table would be
        v = v.to(torch.float32)
    return v.to(dtype)


def gen_group_plain(inp: dict, m0: int, m1: int, J: int, i0: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K4: one group's table (m1-m0, J, ndgnh-i0); a bf16
    table is the fp32 table rounded to nearest even."""
    x = inp["mu"][i0:]
    p = inp["mant"][m0:m1, i0:].clone()
    E = inp["exp"][m0:m1, i0:].to(torch.int64)
    q = torch.zeros_like(p)
    out = torch.empty((m1 - m0, J, x.shape[0]), dtype=dtype, device=x.device)
    for t in range(J):
        out[:, t, :] = _emit(p, E, dtype)
        a = inp["A"][m0:m1, t + 1, None]
        b = inp["B"][m0:m1, t + 1, None]
        r = a * (x * p) - b * q
        mag = r.abs()
        big = mag > _RS_HI
        small = (mag < _RS_LO) & (mag > 0)
        fac = torch.where(big, r.new_tensor(_RS_LO),
                          torch.where(small, r.new_tensor(_RS_HI),
                                      r.new_tensor(1.0)))
        E = E + torch.where(big, _RS_SHIFT, torch.where(small, -_RS_SHIFT, 0))
        q = p * fac
        p = r * fac
    return out


def launch_plan(groups, ndgnh: int) -> tuple:
    """K4's work order for ``groups`` [(m0, m1, i0, J), ...] (one or more,
    any count): the launch's group descriptors (index into ``groups``, m0,
    gm, J, i0, ig, first block), longest chains (J) first, each group's
    gm * ig columns on consecutive blocks of ``THREADS``; and the launch's
    block count."""
    if not groups:
        raise ValueError("a K4 launch takes at least one group")
    order = sorted(range(len(groups)), key=lambda k: -groups[k][3])
    desc, block = [], 0
    for k in order:
        m0, m1, i0, J = groups[k]
        gm, ig = m1 - m0, ndgnh - i0
        desc.append((k, m0, gm, J, i0, ig, block))
        block += -(-gm * ig // THREADS)
    return tuple(desc), block


def gen_groups(inp: dict, groups, dtype: torch.dtype) -> list:
    """The tables of ``groups`` [(m0, m1, i0, J), ...] (K4; replaces
    ``legendre_tablegen._gen_group``), one (m1-m0, J, ndgnh-i0) tensor each,
    in float32, float64 or bfloat16, on the device of ``inp``: one kernel
    launch for all of them (past 16 groups it also fills a device array of
    their descriptors, 32 bytes a group); CPU inputs take
    ``gen_group_plain`` per group."""
    mu = inp["mu"]
    if _build.on_cpu(mu):
        return [gen_group_plain(inp, m0, m1, J, i0, dtype)
                for m0, m1, i0, J in groups]
    ndgnh = mu.shape[0]
    M, tc = inp["A"].shape
    for m0, m1, i0, J in groups:
        if not (0 <= m0 < m1 <= M and 0 <= i0 < ndgnh and J < tc):
            raise ValueError(f"group m0={m0} m1={m1} J={J} i0={i0} out of "
                             f"range (M={M}, ndgnh={ndgnh}, coefficient "
                             f"width {tc})")
    _build.check_operand("A", inp["A"], mu, (M, tc))
    _build.check_operand("B", inp["B"], mu, (M, tc))
    _build.check_operand("mant", inp["mant"], mu, (M, ndgnh))
    sexp = inp["exp"]
    if sexp.dtype != torch.int32 or sexp.shape != (M, ndgnh) \
            or sexp.device != mu.device or not sexp.is_contiguous():
        raise ValueError("exp must be a contiguous int32 (M, ndgnh) tensor "
                         "on the device of mu")
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"unsupported table dtype {dtype}")
    outs = [torch.empty((m1 - m0, J, ndgnh - i0), dtype=dtype,
                        device=mu.device) for m0, m1, i0, J in groups]
    desc, nblocks = launch_plan(groups, ndgnh)
    n = len(desc)
    ptrs = (ctypes.c_void_p * n)(*(outs[d[0]].data_ptr() for d in desc))
    ints = (ctypes.c_int * (6 * n))(*(v for d in desc for v in d[1:]))
    dev_desc = (None if n <= K4_PARAM_GROUPS else
                torch.empty(4 * n, dtype=torch.int64, device=mu.device))
    with _build.on_device(mu):
        _build.launch("ect_tablegen", dtype, inp["A"].data_ptr(),
                      inp["B"].data_ptr(), tc, inp["mant"].data_ptr(),
                      sexp.data_ptr(), ndgnh, mu.data_ptr(), ptrs, ints, n,
                      None if dev_desc is None else dev_desc.data_ptr(),
                      nblocks)
    gen_groups.launches += 1
    return outs


gen_groups.launches = 0


def gen_group(inp: dict, m0: int, m1: int, J: int, i0: int,
              dtype: torch.dtype) -> torch.Tensor:
    """One group's table: ``gen_groups`` with one group (one K4 launch on a
    CUDA device, ``gen_group_plain`` on the CPU)."""
    return gen_groups(inp, [(m0, m1, i0, J)], dtype)[0]


def gen_groups_shape(nblocks: int, dtype: torch.dtype = torch.float32) -> dict:
    """K4's launch of ``nblocks`` blocks on the current CUDA device
    (``_build.launch_shape``)."""
    return _build.launch_shape("ect_tablegen_shape", dtype, nblocks)
