"""legendre_roofline: the least time the chip needs for the Legendre
layer's work of a step (the larger of its bytes over the memory bandwidth
and its FLOP over the float32 peak, counted from the resolution's sizes)
over the layer's device time, in percent."""

from perfbench import work

SPANS = {"legendre": [
    "ectrans_tpu_torch.ops.legendre_dense:legendre_inv_dense",
    "ectrans_tpu_torch.ops.legendre_dense:legendre_dir_rows"]}


def read(s):
    t = s.device_s.get("legendre", 0.0)
    c = s.context
    if t <= 0 or c.get("peak") is None:
        return None
    nbytes, flop = work.legendre_work(c["geo"], c["calls"], c["scders"],
                                      c["itemsize"], c["itemsize"])
    least = work.least_seconds(nbytes, flop, c["peak"]) * s.steps
    return least / t * 100.0
