"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into one
shared library with a plain C interface, under ``_build/`` next to this file,
at first use; the library's name carries a hash of the sources and flags, so
an edited source is rebuilt.  It is loaded with ctypes.  Every C entry
launches on the stream it is given and returns ``cudaGetLastError()``; the
wrappers in ``ops/`` raise on a non-zero code.

Nothing here runs at import: the CPU tests import every module on machines
with no CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64"}
_FLOAT = tuple(_SUFFIX.values())   # an _f32 and an _f64 variant
_SINGLE = ("",)                    # one variant, no suffix (bf16 in, fp32 out)
# C entry points: name stem -> (argtypes, variant suffixes)
_ENTRIES = {
    "ect_inv_dense": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _FLOAT),
    "ect_dir_dense": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _FLOAT),
    "ect_inv_grouped": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _FLOAT),
    "ect_dir_grouped": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _FLOAT),
    "ect_inv_planes": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                       _SINGLE),
    "ect_dir_planes": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _SINGLE),
    "ect_compact": ([_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _P], _FLOAT),
    "ect_tablegen": ([_P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _P],
                     _FLOAT),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def sources() -> list[pathlib.Path]:
    return sorted(_SRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libectrans_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels if the library for the current sources is
    missing; returns its path.  The compiler's report (registers, shared
    memory, spills per kernel) is kept beside it as ``build.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            cdll = ctypes.CDLL(str(build()))
            for stem, (argtypes, suffixes) in _ENTRIES.items():
                for suffix in suffixes:
                    fn = getattr(cdll, stem + suffix)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def launch(stem: str, dtype: torch.dtype | None, *args) -> None:
    """Call C entry ``stem`` for ``dtype`` (None for a single-variant entry)
    on the current CUDA stream and raise if the launch failed.  ``args``
    exclude the trailing stream."""
    name = stem + ("" if dtype is None else _SUFFIX[dtype])
    fn = getattr(lib(), name)
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def check_operand(name: str, t: torch.Tensor, like: torch.Tensor,
                  shape: tuple, dtype: torch.dtype | None = None) -> None:
    """Validate a kernel operand against the first one (device; dtype, or
    the given ``dtype``) and its expected shape; kernels take contiguous
    tensors only."""
    if t.device != like.device:
        raise ValueError(f"{name} is on device {t.device}, expected "
                         f"{like.device}")
    if dtype is not None:
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    elif t.dtype != like.dtype or t.dtype not in _SUFFIX:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype} "
                        "(float32 or float64)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain PyTorch path), False for a CUDA tensor
    (kernel path); other devices are refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")
