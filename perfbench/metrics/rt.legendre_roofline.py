"""rt.legendre_roofline: legendre_roofline in the one-field round-trip
cells, where it moves p95_rt_ms."""

from perfbench import spec

_base = spec.reader("legendre_roofline")
SPANS = getattr(_base, "SPANS", {})
read = _base.read
