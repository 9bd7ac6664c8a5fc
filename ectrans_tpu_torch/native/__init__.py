"""Native (C++) host Legendre builder, loaded with ctypes.

Counterpart of ``ectrans_tpu/native``: ``build_legendre_parity`` writes the
parity-split tables (psym, pasym) of the host table source directly in fp64
or fp32 (the recurrence itself is always fp64), from this package's own
copy of the C++ source, ``legendre_builder.cpp``.  The shared library is
built with g++ at first use, with the JAX package's flags, into
``ectrans_tpu_torch/_build/`` (or ``ECTRANS_TPU_NATIVE_DIR``); its name
carries a hash of the source and flags, so an edited source is rebuilt.

There is no silent fallback: a failed build raises with g++'s stderr.  The
numpy recurrence of ``legendre.py`` takes the builder's place only when
``ECTRANS_TPU_DISABLE_NATIVE`` is set (``available()`` is then False).

``alloc_array`` allocates a large array on memory advised for transparent
huge pages: on hosts whose memory is backed lazily, first-touch page faults
dominate the writes of GB-sized tables.
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import pathlib
import subprocess
import threading

import numpy as np

from ..utils.timing import hook

_MADV_HUGEPAGE = 14
_SRC = pathlib.Path(__file__).parent / "legendre_builder.cpp"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-funroll-loops"]
_ENTRIES = (("et_build_legendre_parity", ctypes.c_double, np.float64),
            ("et_build_legendre_parity_f32", ctypes.c_float, np.float32))

_lock = threading.Lock()
_lib = None


def alloc_array(shape, dtype) -> np.ndarray:
    """An uninitialised array of ``shape`` and ``dtype``; one of 16 MiB or
    more lies on anonymous memory advised for transparent huge pages (512x
    fewer first-touch faults), which is freed with the array."""
    nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
    if nbytes < (1 << 24):
        return np.empty(shape, dtype=dtype)
    buf = mmap.mmap(-1, nbytes)
    addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
    libc = ctypes.CDLL(None, use_errno=True)
    # advice only: a kernel without THP leaves ordinary pages
    libc.madvise(ctypes.c_void_p(addr), ctypes.c_size_t(nbytes),
                 _MADV_HUGEPAGE)
    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def disabled() -> bool:
    """True when ``ECTRANS_TPU_DISABLE_NATIVE`` is set (numpy builds the
    host tables instead)."""
    return bool(os.environ.get("ECTRANS_TPU_DISABLE_NATIVE"))


def build_dir() -> pathlib.Path:
    env = os.environ.get("ECTRANS_TPU_NATIVE_DIR")
    return pathlib.Path(env) if env else (
        pathlib.Path(__file__).parent.parent / "_build")


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(_SRC.read_bytes())
    return build_dir() / f"libectrans_native_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the builder if its library is missing; returns its path.
    Raises RuntimeError with g++'s stderr when the compile fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(_SRC)]
    try:
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except OSError as e:
        raise RuntimeError(f"g++ could not run ({e}): the native Legendre "
                           "builder cannot be built; set "
                           "ECTRANS_TPU_DISABLE_NATIVE=1 for the numpy "
                           "recurrence") from e
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({run.returncode}): {' '.join(cmd)}"
                           f"\n{run.stderr}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            with hook("build.native"):
                lib = ctypes.CDLL(str(build()))
            for name, ctype, _ in _ENTRIES:
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [
                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.POINTER(ctypes.c_double),
                    ctypes.c_void_p,                    # nmen or NULL
                    ctypes.c_int, ctypes.POINTER(ctype),
                    ctypes.POINTER(ctype),
                ]
            _lib = lib
        return _lib


def available() -> bool:
    """Whether the host tables come from the native builder: False when
    ``ECTRANS_TPU_DISABLE_NATIVE`` is set, else True once the library is
    built and loaded (building it if needed; a failed build raises)."""
    if disabled():
        return False
    _load()
    return True


def build_legendre_parity(
    nsmax: int,
    mu: np.ndarray,
    ntmax_extra: int = 1,
    nmen_nh: np.ndarray | None = None,
    dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray, int] | None:
    """Parity-split Legendre tables (psym, pasym, kmax), each (nsmax+1,
    nlat, kmax), psym[m, lat, k] = P̄ at n = m+2k and pasym at n = m+1+2k,
    written directly in ``dtype`` (float64 or float32; the recurrence is
    fp64); rows with m > nmen_nh[lat] are zero.  None when the builder is
    disabled (``ECTRANS_TPU_DISABLE_NATIVE``)."""
    if disabled():
        return None
    dt = np.dtype(dtype)
    entry = next((e for e in _ENTRIES if np.dtype(e[2]) == dt), None)
    if entry is None:
        raise TypeError(f"the native builder writes float64 or float32 "
                        f"tables, not {dt}")
    fn = getattr(_load(), entry[0])
    mu = np.ascontiguousarray(mu, dtype=np.float64)
    nlat = mu.shape[0]
    nmax = nsmax + ntmax_extra
    kmax = (nmax + 2) // 2
    M = nsmax + 1
    psym = alloc_array((M, nlat, kmax), dt)
    pasym = alloc_array((M, nlat, kmax), dt)
    nmen_arr = None if nmen_nh is None else np.ascontiguousarray(
        nmen_nh, dtype=np.int32)
    ptr = ctypes.POINTER(entry[1])
    rc = fn(nsmax, nmax, nlat,
            mu.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            None if nmen_arr is None else nmen_arr.ctypes.data_as(
                ctypes.c_void_p), kmax,
            psym.ctypes.data_as(ptr), pasym.ctypes.data_as(ptr))
    if rc != 0:
        raise ValueError(f"{entry[0]} refused nsmax={nsmax}, nmax={nmax}, "
                         f"nlat={nlat} (code {rc})")
    return psym, pasym, kmax


def state() -> str:
    """The builder's state in words, without building it."""
    if disabled():
        return "disabled (ECTRANS_TPU_DISABLE_NATIVE: numpy recurrence)"
    path = library_path()
    if path.exists():
        return f"built, {path}"
    return f"not built (g++ builds it at first use into {path.parent})"
