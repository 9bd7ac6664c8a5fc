"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one process
per source, all started together, and linked into one shared library with a
plain C interface, under ``_build/`` next to this file, at first use; the
library's name carries a hash of the sources and flags, so an edited source
is rebuilt.  It is loaded with ctypes.  Every C entry
launches on the stream it is given and returns ``cudaGetLastError()``; the
wrappers in ``ops/`` raise on a non-zero code.

Nothing here runs at import: the CPU tests import every module on machines
with no CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from .utils.timing import hook

_HERE = pathlib.Path(__file__).parent
_SRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_WORKING = (torch.float32, torch.float64)
# variant suffix by dtype: the working dtype, or bfloat16 for the kernels
# that take fp32 operands on a bf16 table
_SUFFIX = {torch.float32: "_f32", torch.float64: "_f64",
           torch.bfloat16: "_bf16"}
_FLOAT = ("_f32", "_f64")          # an _f32 and an _f64 variant
_TABLES = _FLOAT + ("_bf16",)      # and a bf16-table variant
_SINGLE = ("",)                    # one variant, no suffix (bf16 in, fp32 out)
_FP32_OPS = ("_f32", "_bf16")      # fp32 operands, fp32 or bf16 table
# C entry points: name stem -> (argtypes, variant suffixes)
_ENTRIES = {
    "ect_inv_dense": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _TABLES),
    "ect_dir_dense": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _TABLES),
    "ect_inv_dense2": ([_P, _P, _P, _I, _I, _I, _I, _P], _TABLES),
    "ect_dir_dense2": ([_P, _P, _P, _I, _I, _I, _I, _P], _TABLES),
    "ect_inv_dense_shape": ([_I, _I, _I, _P], _FP32_OPS),
    "ect_inv_dense2_shape": ([_I, _I, _I, _P], _FP32_OPS),
    "ect_dir_dense_shape": ([_I, _I, _I, _P], _FP32_OPS),
    "ect_dir_dense2_shape": ([_I, _I, _I, _P], _FP32_OPS),
    "ect_inv_grouped": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                        _TABLES),
    "ect_dir_grouped": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
                        _TABLES),
    "ect_inv_grouped_shape": ([_I, _I, _I, _I, _P], _FP32_OPS),
    "ect_dir_grouped_shape": ([_I, _I, _I, _I, _P], _FP32_OPS),
    "ect_inv_planes": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                       _SINGLE),
    "ect_dir_planes": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
                       _SINGLE),
    "ect_inv_planes_shape": ([_I, _I, _I, _I, _I, _P], _SINGLE),
    "ect_dir_planes_shape": ([_I, _I, _I, _I, _I, _P], _SINGLE),
    "ect_compact": ([_P, _P, _P, _I, _P, _P, _I, _I, _L, _P], _FLOAT),
    "ect_compact_shape": ([_I, _I, _P], _SINGLE),
    "ect_tablegen": ([_P, _P, _I, _P, _P, _I, _P, _P, _P, _I, _P, _I, _P],
                     _TABLES),
    "ect_tablegen_shape": ([_I, _P], _TABLES),
    "ect_copy": ([_P, _P, _L, _I, _P], ("_f32",)),
    "ect_reduce8": ([_P, _P, _P, _L, _I, _L, _I, _I, _P], ("_f32",)),
    "ect_copy_shape": ([_I, _P], _SINGLE),
    "ect_reduce8_shape": ([_I, _P], _SINGLE),
    "ect_fourier_syn_ss": ([_P, _P, _P, _I, _I, _I, _P], _FLOAT),
    "ect_fourier_ana_ss": ([_P, _P, _P, _P, _I, _I, _I, _I, _P], _FLOAT),
    "ect_fourier_syn_pre": ([_P, _P, _P, _P, _P, _D, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P], _FLOAT),
    "ect_fourier_ana_pre": ([_P, _P, _P, _P, _L, _D, _P, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P], _FLOAT),
    "ect_fourier_product": ([_P, _P, _I, _I, _I, _P], _SINGLE),
    "ect_fourier_syn_post": ([_P, _P, _P, _P, _D, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P], _FLOAT),
    "ect_fourier_ana_post": ([_P, _P, _P, _P, _L, _D, _P, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P], _FLOAT),
    "ect_fourier_syn_fused": ([_P] * 9 + [_D, _P] + [_I] * 8
                              + [_L, _L, _I, _I, _P], _FLOAT),
    "ect_fourier_ana_fused": ([_P] * 8 + [_L, _D, _P] + [_I] * 9
                              + [_L, _L, _I, _I, _P], _FLOAT),
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
    for s in sorted(_SRC.glob("*.cu*")):     # the sources and their headers
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
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(sources(), objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    cmds.append([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                 *map(str, objs)])
    runs = [p.communicate() + (p.returncode,) for p in procs]
    if all(rc == 0 for _, _, rc in runs):
        link = subprocess.run(cmds[-1], capture_output=True, text=True)
        runs.append((link.stdout, link.stderr, link.returncode))
    (BUILD_DIR / "build.log").write_text("".join(
        " ".join(c) + "\n" + o + e for c, (o, e, _) in zip(cmds, runs)))
    for o in objs:
        o.unlink(missing_ok=True)
    failed = [(c, e, rc) for c, (_, e, rc) in zip(cmds, runs) if rc != 0]
    if failed:
        c, e, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(c)}\n{e}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            with hook("build.kernels"):
                cdll = ctypes.CDLL(str(build()))
                for stem, (argtypes, suffixes) in _ENTRIES.items():
                    for suffix in suffixes:
                        fn = getattr(cdll, stem + suffix)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
            _lib = cdll
        return _lib


def launch(stem: str, dtype: torch.dtype | None, *args) -> None:
    """Call C entry ``stem`` for ``dtype`` (the working dtype, bfloat16 for
    a bf16-table variant, None for a single-variant entry) on the current
    CUDA stream and raise if the launch failed.  ``args`` exclude the
    trailing stream."""
    name = stem + ("" if dtype is None else _SUFFIX[dtype])
    fn = getattr(lib(), name)
    # the raw handle of torch.cuda.current_stream(), without building a
    # Stream object (a few us a launch)
    stream = torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({torch.cuda.get_device_name()})")


def on_device(t: torch.Tensor):
    """A context in which ``t``'s CUDA device is the current one (nothing to
    switch, and no cost, when it already is)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def launch_shape(stem: str, dtype: torch.dtype | None, *dims: int) -> dict:
    """A kernel's launch as C entry ``stem`` (for ``dtype``, as ``launch``)
    reports it for ``dims`` on the current CUDA device: blocks per launch,
    threads per block, dynamic shared bytes, resident blocks per SM
    (occupancy API), the device's SMs, and the waves these make."""
    info = (ctypes.c_int * 5)()
    name = stem + ("" if dtype is None else _SUFFIX[dtype])
    rc = getattr(lib(), name)(*dims, info)
    if rc != 0:
        raise RuntimeError(f"{name} failed: CUDA error {rc}")
    blocks, threads, smem, per_sm, sms = info
    return dict(blocks=blocks, threads=threads, smem_bytes=smem,
                blocks_per_sm=per_sm, sms=sms,
                waves=blocks / max(1, per_sm * sms))


def check_operand(name: str, t: torch.Tensor, like: torch.Tensor,
                  shape: tuple, dtype: torch.dtype | None = None) -> None:
    """Validate a kernel operand against the first one (device; dtype, or
    the given ``dtype``) and its expected shape; kernels take contiguous
    tensors only."""
    _check_kind(name, t, like, shape, dtype)
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_rows(name: str, t: torch.Tensor, like: torch.Tensor, shape: tuple,
               dtype: torch.dtype | None = None) -> int:
    """As ``check_operand`` for a 3-d operand whose rows may be padded: its
    last axis contiguous, rows ``ld >= shape[2]`` elements apart and the
    leading axis ``shape[1] * ld`` apart (a view of the first ``shape[2]``
    columns of a contiguous tensor).  Returns ``ld``."""
    _check_kind(name, t, like, shape, dtype)
    ld = t.stride(1) if t.numel() else shape[2]
    if t.numel() and (t.stride(2) != 1 or ld < shape[2]
                      or (shape[0] > 1 and t.stride(0) != shape[1] * ld)):
        raise ValueError(f"{name} must be contiguous but for padded rows, "
                         f"got strides {t.stride()}")
    return ld


def _check_kind(name: str, t: torch.Tensor, like: torch.Tensor,
                shape: tuple, dtype: torch.dtype | None) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on device {t.device}, expected "
                         f"{like.device}")
    if dtype is not None:
        if t.dtype != dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    elif t.dtype != like.dtype or t.dtype not in _WORKING:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype} "
                        "(float32 or float64)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def table_dtype(x: torch.Tensor, table: torch.Tensor) -> torch.dtype:
    """The table dtype of the Legendre kernel variant for operand ``x`` and
    ``table``: bfloat16 for an fp32 operand on a bf16 table (the "bf16"
    tier), else the operand's working dtype (which the table must match)."""
    if x.dtype == torch.float32 and table.dtype == torch.bfloat16:
        return torch.bfloat16
    return x.dtype


def on_cpu(t: torch.Tensor) -> bool:
    """True for a CPU tensor (plain PyTorch path), False for a CUDA tensor
    (kernel path); other devices are refused."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {t.device}")
