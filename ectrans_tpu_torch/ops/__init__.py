"""Operators of the transform pipeline; the kernel wrappers live in
``legendre_dense`` (K1, K2), ``pack`` (K3) and ``legendre_tablegen`` (K4)."""
