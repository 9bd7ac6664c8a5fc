"""The C API of this package: ``ectrans_tpu_torch_capi.c``, a copy of
``src/capi/ectrans_tpu_capi.c`` that embeds CPython and forwards every call
of ``src/capi/ectrans_tpu.h`` to ``ectrans_tpu_torch.capi_bridge``.

    from ectrans_tpu_torch import capi
    path = capi.build()         # compiles the shim once (cc, no nvcc)
    # cc prog.c $(capi.link_flags()) -lm -o prog
    lib = capi.load()           # or into this process, through ctypes

``build()`` compiles the shim with the C compiler against the running
Python (its include path and ``-lpython3.X``) into ``_build/`` beside the
package, under a name that carries a hash of the shim, the header and the
flags, so an edited source is rebuilt; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import sys
import sysconfig

_HERE = pathlib.Path(__file__).parent
SHIM = _HERE / "ectrans_tpu_torch_capi.c"
HEADER_DIR = _HERE.parents[1] / "src" / "capi"   # ectrans_tpu.h, unchanged
BUILD_DIR = _HERE.parent / "_build"


def cc() -> str:
    """The C compiler (``cc``, else ``gcc``)."""
    path = shutil.which("cc") or shutil.which("gcc")
    if path is None:
        raise RuntimeError("no C compiler (cc, gcc) on PATH: the C API "
                           "shim cannot be built")
    return path


def python_link_flags() -> list[str]:
    """Flags that link against the running Python's shared library."""
    libdir = sysconfig.get_config_var("LIBDIR") or ""
    ver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    return [f"-L{libdir}", f"-l{ver}", f"-Wl,-rpath,{libdir}"]


def _flags() -> list[str]:
    return (["-O2", "-shared", "-fPIC", f"-I{sysconfig.get_path('include')}",
             f"-I{HEADER_DIR}"] + python_link_flags())


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in (SHIM, HEADER_DIR / "ectrans_tpu.h"):
        h.update(src.read_bytes())
    return BUILD_DIR / f"libectrans_tpu_torch_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the shim if the library for the current sources is missing;
    returns its path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cc(), str(SHIM), "-o", str(tmp)] + _flags(),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the C API shim failed:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def link_flags() -> list[str]:
    """Flags that link a C program against the shim (built if need be),
    with ``-I`` for ``ectrans_tpu.h``."""
    lib = build()
    return ([f"-I{HEADER_DIR}", str(lib), f"-Wl,-rpath,{lib.parent}"]
            + python_link_flags())


def bridge_env(device: str | None = None) -> dict:
    """The environment of a C program that embeds the bridge: this one,
    with the repository root and the running Python's site-packages ahead
    on ``PYTHONPATH`` (the embedded interpreter finds this package and
    torch there) and, if given, ``ECTRANS_TPU_CAPI_DEVICE``."""
    paths = [str(_HERE.parents[1]), sysconfig.get_path("purelib"),
             sysconfig.get_path("platlib"), os.environ.get("PYTHONPATH", "")]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in paths if p))
    if device is not None:
        env["ECTRANS_TPU_CAPI_DEVICE"] = device
    return env


def _ctype(param: str):
    if "char" in param:
        return ctypes.c_char_p
    if "*" in param:
        return ctypes.c_void_p
    return ctypes.c_double if param.split()[0] == "double" else ctypes.c_int


def load() -> ctypes.CDLL:
    """The shim (built if need be) loaded into this process, each entry of
    ``ectrans_tpu.h`` with its argument and result types.  ctypes releases
    the GIL around a call and the shim takes it; ``ectrans_tpu_finalize``
    is for C hosts, not for a running Python."""
    lib = ctypes.CDLL(str(build()))
    header = (HEADER_DIR / "ectrans_tpu.h").read_text()
    for name, params in re.findall(r"int (ectrans_tpu_\w+)\(([^)]*)\);",
                                   header):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_ctype(p) for p in params.split(",")
                       if p.strip() != "void"]
    return lib
