"""rt.api.host_ms: api.host_ms in the one-field round-trip
cells, where it moves p95_rt_ms."""

from perfbench import spec

_base = spec.reader("api.host_ms")
SPANS = getattr(_base, "SPANS", {})
read = _base.read
