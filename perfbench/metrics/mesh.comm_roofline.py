"""mesh.comm_roofline: the least time rank 0's card needs to send the
bytes it sent a step in the transpositions and the all_reduce (the port's
``parallel.comm.TRAFFIC``, by tag, over the traced window) at its link
peak in one direction (``links.json``), over ``mesh.comm.device_ms``, in
percent.

The bytes are counted from when this reader is loaded, just before the
traced window, to when it reads; the harness runs nothing of the program
in between but the window."""

import torch

from perfbench import meshwork, spec

TAGS = ("TRMTOL", "TRLTOM", "TRLTOG", "TRGTOL", "psum")

_base = spec.reader("mesh.comm.device_ms")
SPANS = getattr(_base, "SPANS", {})


def _sent() -> int | None:
    try:
        from ectrans_tpu_torch.parallel import comm
    except ImportError:
        return None
    return sum(comm.TRAFFIC.get(t, 0) for t in TAGS)


_START = _sent()


def read(s):
    ms = _base.read(s)
    now = _sent()
    if ms is None or now is None or _START is None or \
            not torch.cuda.is_available():
        return None
    peak = meshwork.link_peak(torch.cuda.get_device_name(0))
    nbytes = (now - _START) / s.steps
    if peak is None or nbytes <= 0:
        return None
    return nbytes / peak / (ms * 1e-3) * 100.0
