"""Tracing and phase timing: the DR_HOOK / GSTATS analogue.

Counterpart of ``ectrans_tpu/utils/timing.py``.  The reference wraps every
routine in DR_HOOK('NAME', 0/1) markers and every transform phase in
numbered GSTATS counters (``ltinv_ctl_mod.F90:84,113``; NVTX ranges on GPU,
``tpm_stats.F90``).  Here:

* ``hook("NAME")`` — context manager combining
  ``torch.profiler.record_function`` (the name shows up in ``torch.profiler``
  traces), an NVTX range when a CUDA card is present (the reference GPU's
  own marker, seen by Nsight), and wall-clock accounting;
* ``gstats("name")`` — pure wall-clock phase counters with a GSTATS-style
  report (count / total / avg / min / max).

CUDA work is asynchronous, so wall-clock numbers for code that merely
*enqueues* work measure dispatch unless you block; ``timed(block=True)``
synchronises the devices of the wrapped callable's output tensors so the
measurement covers their work.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch

_lock = threading.Lock()
_stats: dict[str, list[float]] = defaultdict(list)


@contextlib.contextmanager
def gstats(name: str):
    """Wall-clock phase counter (GSTATS equivalent)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _stats[name].append(dt)


@contextlib.contextmanager
def hook(name: str):
    """Profiler range + NVTX range + wall-clock region marker (DR_HOOK
    equivalent)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_available():
            stack.enter_context(torch.cuda.nvtx.range(name))
        stack.enter_context(gstats(name))
        yield


def _devices(out, found: set) -> set:
    """The CUDA devices of the tensors in ``out`` (nested in tuples, lists
    and dict values)."""
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, (tuple, list)):
        for x in out:
            _devices(x, found)
    elif isinstance(out, dict):
        for x in out.values():
            _devices(x, found)
    return found


def timed(name: str, fn, *args, block: bool = True, **kw):
    """Run fn under gstats(name), optionally synchronising the CUDA devices
    of its output tensors so the measurement covers their work."""
    with gstats(name):
        out = fn(*args, **kw)
        if block:
            for dev in _devices(out, set()):
                torch.cuda.synchronize(dev)
    return out


def reset_gstats() -> None:
    with _lock:
        _stats.clear()


def gstats_report(out=None) -> str:
    """GSTATS-style report: name, count, total, avg, min, max (seconds)."""
    lines = [f"{'region':32s} {'count':>6s} {'total':>10s} {'avg':>10s} "
             f"{'min':>10s} {'max':>10s}"]
    with _lock:
        for name in sorted(_stats):
            ts = _stats[name]
            lines.append(
                f"{name:32s} {len(ts):6d} {sum(ts):10.4f} "
                f"{sum(ts)/len(ts):10.4f} {min(ts):10.4f} {max(ts):10.4f}"
            )
    rep = "\n".join(lines)
    if out is not None:
        print(rep, file=out)
    return rep
