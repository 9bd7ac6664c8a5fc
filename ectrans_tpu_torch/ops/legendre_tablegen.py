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
same sequence of fp64 operations in PyTorch, vectorized over (m, latitude):
it is the CPU path and the kernel's reference on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..legendre import eps_table, sectoral_seeds

_RS_HI = 2.0 ** 256
_RS_LO = 2.0 ** -256
_RS_SHIFT = 256
_E_FLUSH = -1400   # |mantissa| <= 2^257: 2^-1400 * 2^257 < fp64 tiny


def host_inputs(res) -> dict:
    """fp64 recurrence inputs: coefficients A, B (M, nsmax+4), seed mantissas
    (M, ndgnh) in [0.5, 1) (0 where m > nmen(lat)), int32 seed exponents,
    and the NH nodes mu (ndgnh,)."""
    nsmax, ndgnh = res.nsmax, res.ndgnh
    M = nsmax + 1
    nmax = nsmax + 1
    mu = np.array(res.mu[:ndgnh], np.float64)
    nmen = np.asarray(res.nmen[:ndgnh])

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
    return torch.where(keep, v, torch.zeros_like(v)).to(dtype)


def gen_group_plain(inp: dict, m0: int, m1: int, J: int, i0: int,
                    dtype: torch.dtype) -> torch.Tensor:
    """Plain version of K4: one group's table (m1-m0, J, ndgnh-i0)."""
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


def gen_group(inp: dict, m0: int, m1: int, J: int, i0: int,
              dtype: torch.dtype) -> torch.Tensor:
    """One group's table (K4; replaces ``legendre_tablegen._gen_group``) on
    the device of ``inp``; CPU inputs take ``gen_group_plain``."""
    if _build.on_cpu(inp["mu"]):
        return gen_group_plain(inp, m0, m1, J, i0, dtype)
    ndgnh = inp["mu"].shape[0]
    M, tc = inp["A"].shape
    if not (0 <= m0 < m1 <= M and 0 <= i0 < ndgnh and J < tc):
        raise ValueError(f"group m0={m0} m1={m1} J={J} i0={i0} out of range "
                         f"(M={M}, ndgnh={ndgnh}, coefficient width {tc})")
    mu = inp["mu"]
    _build.check_operand("A", inp["A"], mu, (M, tc))
    _build.check_operand("B", inp["B"], mu, (M, tc))
    _build.check_operand("mant", inp["mant"], mu, (M, ndgnh))
    sexp = inp["exp"]
    if sexp.dtype != torch.int32 or sexp.shape != (M, ndgnh) \
            or sexp.device != mu.device or not sexp.is_contiguous():
        raise ValueError("exp must be a contiguous int32 (M, ndgnh) tensor "
                         "on the device of mu")
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"unsupported table dtype {dtype}")
    gm, ig = m1 - m0, ndgnh - i0
    out = torch.empty((gm, J, ig), dtype=dtype, device=mu.device)
    with torch.cuda.device(mu.device):
        _build.launch("ect_tablegen", dtype, inp["A"].data_ptr(),
                      inp["B"].data_ptr(), tc, inp["mant"].data_ptr(),
                      sexp.data_ptr(), ndgnh, mu.data_ptr(), out.data_ptr(),
                      m0, gm, J, i0, ig)
    gen_group.launches += 1
    return out


gen_group.launches = 0
