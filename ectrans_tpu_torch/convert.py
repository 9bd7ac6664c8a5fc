"""Carry a resolution's host state across from another implementation.

``resolution_from_numpy`` builds a port :class:`~.resolution.Resolution` from
the numpy state of a JAX ``ectrans_tpu`` Resolution (or anything that holds
the same arrays), so that both packages transform with identical tables:

    d = {"grid": "O48", "nsmax": 47, "mu": ..., "w": ..., "nmen": ...,
         "ndglu": ..., "eps": ..., "racthe": ..., "nasm0": ...,
         "pn": [group tables ...]}          # "radius" and "pn" optional

``pn``, when given, is the list of per-group full-n tables of
``full_legendre`` (one (gm, J, ig) array per m-group) and becomes the host
table source.  The derived index maps are rebuilt, and ``nasm0`` is checked
against them.
"""

from __future__ import annotations

import numpy as np

from .grids import make_grid
from .resolution import EARTH_RADIUS, Resolution, resolution_from_arrays


def resolution_from_numpy(d: dict) -> Resolution:
    grid = make_grid(d["grid"], int(d["nsmax"]))
    arrays = {k: np.asarray(d[k]) for k in
              ("mu", "w", "nmen", "ndglu", "eps", "racthe", "nasm0")}
    want = {"mu": (grid.ndgl,), "w": (grid.ndgl,), "nmen": (grid.ndgl,),
            "racthe": (grid.ndgl,), "ndglu": (grid.nsmax + 1,),
            "nasm0": (grid.nsmax + 1,)}
    for k, shape in want.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{k}: shape {arrays[k].shape} != {shape}")
    res = resolution_from_arrays(
        grid, float(d.get("radius", EARTH_RADIUS)), arrays["mu"], arrays["w"],
        arrays["nmen"], arrays["ndglu"], arrays["eps"], arrays["racthe"])
    if not np.array_equal(arrays["nasm0"], res.nasm0):
        raise ValueError("nasm0 does not match the packed layout of "
                         f"T{grid.nsmax}")
    if d.get("pn") is not None:
        res.use_host_tables(d["pn"])
    return res
