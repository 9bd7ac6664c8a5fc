"""rt.fourier_roofline: fourier_roofline in the one-field round-trip
cells, where it moves p95_rt_ms."""

from perfbench import spec

_base = spec.reader("fourier_roofline")
SPANS = getattr(_base, "SPANS", {})
read = _base.read
