"""mesh.fourier_roofline: the least time rank 0's card needs for its
share of the Fourier layer's work of a step (``meshwork.fourier_bytes``:
each kept coefficient and grid value of its w-rank's rows, in its
v-rank's fields, moved once against the memory bandwidth) over
``mesh.fourier.device_ms``, in percent."""

from perfbench import meshwork, spec, work

_base = spec.reader("mesh.fourier.device_ms")
SPANS = getattr(_base, "SPANS", {})


def read(s):
    ms = _base.read(s)
    c = s.context
    mesh = getattr(c.get("geo"), "mesh", None)
    if ms is None or mesh is None or c.get("peak") is None:
        return None
    nbytes = meshwork.fourier_bytes(c["geo"], c["calls"], c["scders"],
                                    c["uvders"], c["itemsize"], mesh)
    return work.least_seconds(nbytes, 0, c["peak"]) / (ms * 1e-3) * 100.0
