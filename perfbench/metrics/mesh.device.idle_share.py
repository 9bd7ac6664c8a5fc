"""mesh.device.idle_share: device.idle_share on rank 0's card in the mesh
cells: the share of the traced window in which no operation ran on it."""

from perfbench import spec

_base = spec.reader("device.idle_share")
SPANS = getattr(_base, "SPANS", {})
read = _base.read
