"""On-disk cache of the host Legendre parity tables.

Counterpart of ``ectrans_tpu/cache.py`` (the reference's legpol checkpoint,
``CDIO_LEGPOL='READF'/'WRITEF'``, ``setup_trans.F90:360-384``): the host
table source, ``Resolution.parity_tables``, reads (psym, pasym) from a pair
of ``.npy`` files when it finds one and writes the pair after building it.
The key and the file format are the JAX package's, so a pair written by
either package is read by the other.  On a CUDA card the tables are made by
the table kernel (K4) and pass through here only under
``ECTRANS_TPU_TABLE_SOURCE=host``.

``ECTRANS_TPU_LEGPOL_DIR`` moves the cache (default
``~/.cache/ectrans_tpu_torch/legpol``); the empty string disables it.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import zipfile

import numpy as np

from .grids import GridSpec
from .legendre import build_parity_tables


def _cache_dir() -> pathlib.Path | None:
    env = os.environ.get("ECTRANS_TPU_LEGPOL_DIR")
    if env == "":
        return None
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "ectrans_tpu_torch" / "legpol"


def _cache_key(grid: GridSpec, dtype, mu_nh: np.ndarray) -> str:
    h = hashlib.sha1()
    h.update(repr((grid.name, grid.nsmax, grid.ndgl, grid.nloen,
                   np.dtype(dtype).name)).encode())
    # the latitudes are part of the key: stretched setups share a grid
    h.update(np.ascontiguousarray(mu_nh).tobytes())
    return f"legpol_{grid.name}_T{grid.nsmax}_{h.hexdigest()[:12]}.npz"


def load_parity_cached(grid: GridSpec, mu_nh: np.ndarray,
                       nmen_nh: np.ndarray, dtype=np.float64
                       ) -> tuple[np.ndarray, np.ndarray, int]:
    """(psym, pasym, kmax) parity tables at the latitudes ``mu_nh``: a
    cached pair loaded with ``mmap_mode="r"`` (read-only; pages are read
    as they are touched), else built in ``dtype`` by the host builder
    (``build_parity_tables``) and written.
    A legacy ``.npz`` entry is converted into the pair on first touch; a
    failed write is not an error."""
    d = _cache_dir()
    base = None if d is None else d / _cache_key(grid, dtype, mu_nh)
    if base is not None:
        got = _read_npy_pair(base)
        if got is None and base.exists():
            got = _convert_npz(base)
        if got is not None:
            return got
    psym, pasym, kmax = build_parity_tables(grid.nsmax, mu_nh, 1, nmen_nh,
                                            dtype)
    if base is not None:
        try:
            d.mkdir(parents=True, exist_ok=True)
            for name, arr in (("psym", psym), ("pasym", pasym)):
                tmp = d / f".tmp{os.getpid()}_{name}.npy"
                np.save(tmp, arr)
                os.replace(tmp, _npy_path(base, name))
        except OSError:
            pass
    return psym, pasym, kmax


def _npy_path(base: pathlib.Path, name: str) -> pathlib.Path:
    return base.with_suffix(f".{name}.npy")


def _read_npy_pair(base: pathlib.Path):
    ps_p, pa_p = _npy_path(base, "psym"), _npy_path(base, "pasym")
    if not (ps_p.exists() and pa_p.exists()):
        return None
    try:
        psym = np.load(ps_p, mmap_mode="r")
        pasym = np.load(pa_p, mmap_mode="r")
    except (OSError, ValueError):
        return None
    return psym, pasym, int(psym.shape[2])


def _convert_npz(path: pathlib.Path):
    """Extract a legacy ``.npz`` entry into the ``.npy`` pair (the members
    of an uncompressed npz are npy files: a streaming copy) and remove it;
    None if it cannot be read."""
    try:
        with zipfile.ZipFile(path) as z:
            for name in ("psym", "pasym"):
                tmp = path.parent / f".tmp{os.getpid()}_{name}.npy"
                with z.open(name + ".npy") as src, open(tmp, "wb") as dst:
                    while buf := src.read(1 << 24):
                        dst.write(buf)
                os.replace(tmp, _npy_path(path, name))
        path.unlink(missing_ok=True)
    except (OSError, KeyError, zipfile.BadZipFile):
        return None
    return _read_npy_pair(path)


def clear_cache() -> None:
    """Remove every entry of the cache directory."""
    d = _cache_dir()
    if d is not None and d.exists():
        for p in d.glob("legpol_*"):
            p.unlink(missing_ok=True)
