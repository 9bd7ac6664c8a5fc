"""Gauss-Legendre nodes and weights (host precompute, float64).

Numpy copy of ``ectrans_tpu/gauss.py`` (reference: ``sugaw_mod.F90`` initial
guesses + Newton iteration; weight formula ``cpledn_mod.F90:128``), kept in
this package so that it imports without JAX.

Conventions:
  * ``mu`` (sin of latitude) is sorted **north to south** (descending).
  * Weights are the ecTrans-normalized Gaussian weights (standard weights / 2,
    ``sum(w) == 1``), so ``sum_i w_i P̄_n(mu_i) P̄_l(mu_i) == delta_nl``.
"""

from __future__ import annotations

import functools

import numpy as np


def _legendre_and_deriv(n: int, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Evaluate P_n(x) and P_n'(x) by upward recurrence (float64)."""
    p0 = np.ones_like(x)
    p1 = x.copy()
    if n == 0:
        return p0, np.zeros_like(x)
    for k in range(2, n + 1):
        p0, p1 = p1, ((2 * k - 1) * x * p1 - (k - 1) * p0) / k
    # derivative: (1-x^2) P_n' = n (P_{n-1} - x P_n)
    dp = n * (p0 - x * p1) / (1.0 - x * x)
    return p1, dp


@functools.lru_cache(maxsize=8)
def gauss_legendre(ndgl: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (mu, w): Gaussian sin-latitudes (descending) and ecTrans weights.

    The cached arrays are shared by every caller: treat them as read-only.
    """
    if ndgl < 1:
        raise ValueError(f"ndgl must be >= 1, got {ndgl}")
    n = ndgl
    k = np.arange(1, n + 1, dtype=np.float64)
    # Tricomi initial guess for the k-th root of P_n (descending in x)
    theta = np.pi * (k - 0.25) / (n + 0.5)
    x = (1.0 - (n - 1.0) / (8.0 * n**3)) * np.cos(theta)
    for _ in range(100):
        p, dp = _legendre_and_deriv(n, x)
        dx = p / dp
        x = x - dx
        if np.max(np.abs(dx)) < 1e-15:
            break
    _, dp = _legendre_and_deriv(n, x)
    # standard GL weight: 2 / ((1-x^2) dp^2); ecTrans weight = half of that
    w = 1.0 / ((1.0 - x * x) * dp * dp)
    # enforce exact symmetry between hemispheres
    x = 0.5 * (x - x[::-1])
    w = 0.5 * (w + w[::-1])
    x.flags.writeable = False
    w.flags.writeable = False
    return x, w
