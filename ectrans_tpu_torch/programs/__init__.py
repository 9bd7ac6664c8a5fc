"""Benchmark and information programs (the ``src/programs`` analogue).

Counterpart of ``ectrans_tpu/programs``: ``benchmark`` (the global
ectrans-benchmark), ``lam_benchmark`` (the LAM one) and ``info``, each run
as ``python -m ectrans_tpu_torch.programs.<name>``, plus ``world``, the
launcher that ``benchmark --mesh WxV`` starts its ranks with.  The drivers
run on the CUDA card unless they are given ``--device cpu``; without a card
``--device cuda`` stops with a message, it never carries on on the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

DEVICES = ("cuda", "cpu")


def device(name: str) -> torch.device:
    """The driver's device for ``--device name``; exits with a message when
    the card is asked for and there is none."""
    if name == "cuda" and not torch.cuda.is_available():
        sys.exit("no CUDA device is available for --device cuda; pass "
                 "--device cpu to run on the CPU")
    if name == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(name)


def working_dtype(name: str) -> torch.dtype:
    """The torch dtype of ``--dtype name``; the port's working dtypes are
    float32 and float64 (bf16 is the ``--precision bf16`` table tier)."""
    if name == "bfloat16":
        sys.exit("--dtype bfloat16: the working dtypes are float32 and "
                 "float64; bf16 tables are --precision bf16")
    return getattr(torch, name)


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work (the JAX drivers' block_until_ready);
    nothing to wait for on the CPU."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_line(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"device {dev} ({torch.cuda.get_device_name(dev)})"
    return "device cpu"


def drift(norm1, norm0) -> float:
    """The largest relative change of a field's spectral norm."""
    n1 = np.asarray(norm1, np.float64)
    n0 = np.asarray(norm0, np.float64)
    return float(np.max(np.abs(n1 - n0) / np.maximum(n0, 1e-30)))


def check_line(err: float, mult: float, dtype: torch.dtype,
               niter: int) -> bool:
    """Print the --check verdict: the drift against mult * eps * niter."""
    gate = mult * torch.finfo(dtype).eps * niter
    ok = err < gate
    print(f"check: relative norm drift {err:.3e} "
          f"{'<' if ok else '>='} {gate:.3e} -> {'OK' if ok else 'FAIL'}")
    return ok
