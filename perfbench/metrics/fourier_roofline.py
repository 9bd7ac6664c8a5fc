"""fourier_roofline: the least time the chip needs for the Fourier
layer's work of a step (each kept coefficient and each grid value moved
once, at the working dtype, against the memory bandwidth) over the
layer's device time, in percent."""

from perfbench import work

SPANS = {"fourier": ["ectrans_tpu_torch.transform:synthesis",
                     "ectrans_tpu_torch.transform:analysis"]}


def read(s):
    t = s.device_s.get("fourier", 0.0)
    c = s.context
    if t <= 0 or c.get("peak") is None:
        return None
    nbytes = work.fourier_bytes(c["geo"], c["calls"], c["scders"],
                                c["uvders"], c["itemsize"])
    least = work.least_seconds(nbytes, 0, c["peak"]) * s.steps
    return least / t * 100.0
