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

``lam_resolution_from_numpy`` does the same for a LAM resolution: the
fields of a ``LamGrid`` (nx, ny, nxux, nyux, msmax, nsmax, dx, dy) and,
when given, the packed maps of the other implementation (``packed_c``,
``packed_m``, ``packed_n``, ``dense_gather``, ``nesm0``), which must equal
the ones rebuilt here.  A lat-lon output grid crosses as its three fields:
``LatLonGrid(nlat, nlon, include_poles)``.
"""

from __future__ import annotations

import numpy as np

from .grids import make_grid
from .lam.geometry import LamGrid
from .lam.resolution import LamResolution, setup_lam
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


LAM_GRID_FIELDS = ("nx", "ny", "nxux", "nyux", "msmax", "nsmax", "dx", "dy")
LAM_MAPS = ("packed_c", "packed_m", "packed_n", "dense_gather", "nesm0")


def lam_resolution_from_numpy(d: dict) -> LamResolution:
    """A port LamResolution from a LAM grid's fields; the packed maps in
    ``d`` (any of ``LAM_MAPS``) are checked against the rebuilt ones."""
    grid = LamGrid(**{k: (float(d[k]) if k in ("dx", "dy") else int(d[k]))
                      for k in LAM_GRID_FIELDS if k in d})
    res = setup_lam(grid)
    for k in LAM_MAPS:
        if k in d and not np.array_equal(np.asarray(d[k]), getattr(res, k)):
            raise ValueError(f"{k} does not match the packed layout of "
                             f"{grid}")
    return res
