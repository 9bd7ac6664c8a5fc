"""rt.rest.device_ms: rest.device_ms in the one-field round-trip
cells, where it moves p95_rt_ms."""

from perfbench import spec

_base = spec.reader("rest.device_ms")
SPANS = getattr(_base, "SPANS", {})
read = _base.read
