"""rt.fourier.device_ms: fourier.device_ms in the one-field round-trip
cells, where it moves p95_rt_ms."""

from perfbench import spec

_base = spec.reader("fourier.device_ms")
SPANS = getattr(_base, "SPANS", {})
read = _base.read
