"""mesh.legendre_roofline: the least time rank 0's card needs for its
share of the Legendre layer's work of a step (``meshwork.legendre_work``:
the larger of its bytes over the memory bandwidth and its FLOP over the
float32 peak, on its w-rank's m's and its v-rank's fields) over
``mesh.legendre.device_ms``, in percent."""

from perfbench import meshwork, spec, work

_base = spec.reader("mesh.legendre.device_ms")
SPANS = getattr(_base, "SPANS", {})


def read(s):
    ms = _base.read(s)
    c = s.context
    mesh = getattr(c.get("geo"), "mesh", None)
    if ms is None or mesh is None or c.get("peak") is None:
        return None
    nbytes, flop = meshwork.legendre_work(c["geo"], c["calls"], c["scders"],
                                          c["itemsize"], c["itemsize"], mesh)
    return work.least_seconds(nbytes, flop, c["peak"]) / (ms * 1e-3) * 100.0
