"""Operators of the transform pipeline; the kernel wrappers live in
``legendre_dense`` (K1, K2), ``pack`` (K3), ``legendre_tablegen`` (K4),
``legendre_grouped`` (K5, K6) and ``legendre_planes`` (K9, K10)."""
