"""rt.device.idle_share: device.idle_share in the one-field round-trip
cells, where it moves p95_rt_ms."""

from perfbench import spec

_base = spec.reader("device.idle_share")
SPANS = getattr(_base, "SPANS", {})
read = _base.read
