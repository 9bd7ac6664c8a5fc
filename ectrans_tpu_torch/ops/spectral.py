"""Spectral-space operators on the dense (nfld, 2, M, NP) layout.

Counterpart of ``ectrans_tpu/ops/spectral.py``; batched over all m of the
reference's per-m loops:

* ``vordiv_to_uv``  — VDTUV (``vdtuv_mod.F90:110-145``);
* ``ns_derivative`` — SPNSDE (``spnsde_mod.F90``);
* ``uv_to_vordiv`` — UVTVD (``uvtvd_mod.F90:103-139``) on the dense layout
  (the "xla" and "pallas" engines' direct transform);
* ``uv_to_vordiv_rows`` — UVTVD on one m-group of the direct Legendre
  kernel's m-major realigned rows (the "dense" and "planes" engines), and
  ``vordiv_rows`` on every group's, reordered for the packing.

Coefficient tables are functions of (m, n) only, built in float64 numpy by
the ``*_coeff_tables`` functions; ``Resolution.device_tables`` casts them.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _shift_down(x: torch.Tensor) -> torch.Tensor:
    """y[..., n] = x[..., n-1] (zero at n=0)."""
    return F.pad(x[..., :-1], (1, 0))


def _shift_up(x: torch.Tensor) -> torch.Tensor:
    """y[..., n] = x[..., n+1] (zero at last)."""
    return F.pad(x[..., 1:], (0, 1))


def _times_i(x: torch.Tensor) -> torch.Tensor:
    """i * X on (nfld, 2, ...) (re, im) pairs: (re, im) -> (-im, re)."""
    return torch.stack([-x[:, 1], x[:, 0]], dim=1)


def vordiv_coeff_tables(res) -> dict:
    """(M, NP) float64 tables for vordiv_to_uv:
      a[m,n] = (n-1) * eps(n,m) * rlapin(n-1)    (coupling to n-1)
      b[m,n] = (n+2) * eps(n+1,m) * rlapin(n+1)  (coupling to n+1)
      c[m,n] = m * rlapin(n)                     (i*m inverse-Laplacian term)
      valid[m,n] = 1 where m <= n <= nsmax+1
    """
    M, NP = res.M, res.NP
    n = np.arange(NP, dtype=np.float64)[None, :]
    m = np.arange(M, dtype=np.float64)[:, None]
    eps = res.eps
    rl = res.rlapin
    rl_m1 = np.concatenate([[0.0], rl[:-1]])  # rlapin(n-1)
    a = (n - 1.0) * eps[:, :NP] * rl_m1[None, :NP]
    b = (n + 2.0) * eps[:, 1 : NP + 1] * rl[None, 1 : NP + 1]
    c = m * rl[None, :NP]
    valid = (n >= m) & (n <= res.nsmax + 1)
    return dict(a=a, b=b, c=c, valid=valid.astype(np.float64))


def vordiv_to_uv(vor: torch.Tensor, div: torch.Tensor, t: dict):
    """U, V spectra from vor/div (VDTUV), each (nfld, 2, M, NP):
      U(n) = i m lapin(n) D(n) + (n-1) eps(n) lapin(n-1) Z(n-1)
                                 - (n+2) eps(n+1) lapin(n+1) Z(n+1)
      V(n) = i m lapin(n) Z(n) - (n-1) eps(n) lapin(n-1) D(n-1)
                                 + (n+2) eps(n+1) lapin(n+1) D(n+1)
    """
    a, b, c, valid = t["a"], t["b"], t["c"], t["valid"]
    u = c * _times_i(div) + a * _shift_down(vor) - b * _shift_up(vor)
    v = c * _times_i(vor) - a * _shift_down(div) + b * _shift_up(div)
    return u * valid, v * valid


def nsder_coeff_tables(res) -> dict:
    """Tables for ns_derivative (SPNSDE):
      a[m,n] = (n-1) eps(n,m),  b[m,n] = (n+2) eps(n+1,m),
      valid as in vordiv (extends to nsmax+1)
    """
    M, NP = res.M, res.NP
    n = np.arange(NP, dtype=np.float64)[None, :]
    m = np.arange(M, dtype=np.float64)[:, None]
    eps = res.eps
    a = (n - 1.0) * eps[:, :NP]
    b = (n + 2.0) * eps[:, 1 : NP + 1]
    valid = (n >= m) & (n <= res.nsmax + 1)
    return dict(a=a, b=b, valid=valid.astype(np.float64))


def ns_derivative(f: torch.Tensor, t: dict) -> torch.Tensor:
    """Spectral coefficients of cos^2(theta) * df/dmu (SPNSDE):
      NSD(n) = -(n-1) eps(n) F(n-1) + (n+2) eps(n+1) F(n+1)
    """
    return (-t["a"] * _shift_down(f) + t["b"] * _shift_up(f)) * t["valid"]


def uvtvd_coeff_tables(res) -> dict:
    """(M, NP) tables for UVTVD:
      p[m,n] = n * eps(n+1,m),  q[m,n] = (n+1) * eps(n,m),  r[m,n] = m,
      valid[m,n] = 1 where m <= n <= nsmax (vor/div truncated at nsmax)
    """
    M, NP = res.M, res.NP
    n = np.arange(NP, dtype=np.float64)[None, :]
    m = np.arange(M, dtype=np.float64)[:, None]
    eps = res.eps
    p = n * eps[:, 1 : NP + 1]
    q = (n + 1.0) * eps[:, :NP]
    r = m * np.ones((1, NP))
    valid = (n >= m) & (n <= res.nsmax)
    return dict(p=p, q=q, r=r, valid=valid.astype(np.float64))


def uv_to_vordiv(u: torch.Tensor, v: torch.Tensor, t: dict):
    """Vor/div spectra from U, V spectra (UVTVD), each (nfld, 2, M, NP):
      Z(n) = i m V(n) - n eps(n+1) U(n+1) + (n+1) eps(n) U(n-1)
      D(n) = i m U(n) + n eps(n+1) V(n+1) - (n+1) eps(n) V(n-1)
    """
    p, q, r, valid = t["p"], t["q"], t["r"], t["valid"]
    vor = r * _times_i(v) - p * _shift_up(u) + q * _shift_down(u)
    div = r * _times_i(u) + p * _shift_up(v) - q * _shift_down(v)
    return vor * valid, div * valid


def _realign(t: np.ndarray) -> np.ndarray:
    """(M, NP) table -> (M, NP+1) diagonal-realigned: out[m, j] = t[m, m+j]
    (zero beyond the diagonal's end)."""
    M, NP = t.shape
    out = np.zeros((M, NP + 1), t.dtype)
    for m in range(M):
        out[m, : NP - m] = t[m, m:]
    return out


def uvtvd_coeff_tables_mmajor(res) -> dict:
    """Realigned (M, NP+1) UVTVD tables for uv_to_vordiv_rows: degree is
    indexed j = n - m, so the n+-1 couplings stay shifts along the last
    axis while m leads."""
    return {k: _realign(v) for k, v in uvtvd_coeff_tables(res).items()}


def uv_to_vordiv_rows(rows: torch.Tensor, m0: int, nuv: int, nfld: int,
                      t: dict) -> torch.Tensor:
    """UVTVD on one m-group of c-major realigned rows:
      Z(n) = i m V(n) - n eps(n+1) U(n+1) + (n+1) eps(n) U(n-1)
      D(n) = i m U(n) + n eps(n+1) V(n+1) - (n+1) eps(n) V(n-1)

    rows: (gm, 2*nfld, J), row c*nfld + f (c = re/im); u is f in [0, nuv),
    v is f in [nuv, 2*nuv).  Returns (gm, 4*nuv, J) c-major rows
    [vor_re, div_re, vor_im, div_im], each nuv wide.
    """
    gm, _, J = rows.shape
    u_re = rows[:, 0:nuv]
    v_re = rows[:, nuv : 2 * nuv]
    u_im = rows[:, nfld : nfld + nuv]
    v_im = rows[:, nfld + nuv : nfld + 2 * nuv]
    p = t["p"][m0 : m0 + gm, None, :J]
    q = t["q"][m0 : m0 + gm, None, :J]
    valid = t["valid"][m0 : m0 + gm, None, :J]
    mvec = t["r"][m0 : m0 + gm, None, 0:1]   # r[m, j] = m for all valid j
    vor_re = (-mvec * v_im - p * _shift_up(u_re) + q * _shift_down(u_re)) * valid
    vor_im = (mvec * v_re - p * _shift_up(u_im) + q * _shift_down(u_im)) * valid
    div_re = (-mvec * u_im + p * _shift_up(v_re) - q * _shift_down(v_re)) * valid
    div_im = (mvec * u_re + p * _shift_up(v_im) - q * _shift_down(v_im)) * valid
    return torch.cat([vor_re, div_re, vor_im, div_im], dim=1)


def vordiv_rows(rows_list: list, groups, nuv: int, nfld: int,
                t: dict) -> list:
    """UVTVD on every group's c-major realigned rows (``uv_to_vordiv_rows``,
    the group's first row at ``g.m0`` of the tables ``t``), the channels
    reordered to [vor, div, scalars] c-major, nfld rows a component."""
    out = []
    for rows, g in zip(rows_list, groups):
        vd = uv_to_vordiv_rows(rows, g.m0, nuv, nfld, t)
        out.append(torch.cat([vd[:, : 2 * nuv], rows[:, 2 * nuv: nfld],
                              vd[:, 2 * nuv:], rows[:, nfld + 2 * nuv:]],
                             dim=1))
    return out
