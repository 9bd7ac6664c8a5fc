"""The port's span recorder: the DR_HOOK / GSTATS analogue.

Counterpart of ``ectrans_tpu/utils/timing.py``.  The reference wraps every
routine in DR_HOOK('NAME', 0/1) markers and every transform phase in
numbered GSTATS counters (``ltinv_ctl_mod.F90:84,113``; NVTX ranges on GPU,
``tpm_stats.F90``).  Here one recorder, off until ``enable()``:

* ``hook("NAME")`` — a span.  While the recorder is on it enters
  ``torch.profiler.record_function("ectrans:NAME")`` (inside a
  ``torch.profiler`` window the span then sits on the host clock to which
  the profiler aligns the device's kernels, copies and sets), an NVTX range
  named NAME on a CUDA card (the reference GPU's marker, which Nsight
  reads), and keeps ``(NAME, parent index, t0_ns, t1_ns)`` on
  ``time.perf_counter_ns`` in an in-memory list (``spans()``), so that the
  spans outside a profiler window, such as set-up, are known too.  While
  it is off, a span checks one module-level flag and does nothing else.
* ``gstats("NAME")`` — the same record without the profiler and NVTX
  ranges.
* While the recorder is on, each collection of Python's garbage collector
  is a ``gc`` span (with no parent).
* ``count("NAME", n)`` — a counter: while the recorder is on, adds n to
  NAME's total (``counters()``) and keeps ``(NAME, n, span)`` with the
  innermost open span (``counts()``), so that a reader takes, say, the
  bytes a rank sent inside each transposition; off, it does nothing.
* ``gstats_report()`` — the GSTATS-style report of the list by name:
  count, total, self time (the total less that of the spans nested in
  them), average, min, max; ``reset_gstats()`` empties the list and the
  counters.

The list grows by one record a span while the recorder is on: switch it on
for the window to be read, and empty it between windows.  CUDA work is
asynchronous, so a span around code that merely enqueues work measures the
enqueue, unless the code waits for the device inside it.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import threading
import time

import torch

PREFIX = "ectrans:"

_on = False
_nvtx = False
_clock = time.perf_counter_ns
# [name, parent record or None, t0_ns, t1_ns (0 while open)]; appended
# whole, so that no lock is needed, and parents held as records, so that
# an index is only assigned when the list is read
_records: list = []
# [name, n, span record or None], appended whole as the span records are
_counts: list = []
_local = threading.local()
_gc_open = None                 # (record, profiler range) of a collection
_OFF = contextlib.nullcontext()  # a span while the recorder is off


def _stack() -> list:
    """This thread's open spans, innermost last."""
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


class _Span:
    __slots__ = ("name", "marks", "rec", "rf")

    def __init__(self, name: str, marks: bool):
        self.name = name
        self.marks = marks

    def __enter__(self):
        if self.marks:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
            if _nvtx:
                torch.cuda.nvtx.range_push(self.name)
        stack = _stack()
        self.rec = [self.name, stack[-1] if stack else None, 0, 0]
        _records.append(self.rec)
        stack.append(self.rec)
        self.rec[2] = _clock()
        return self

    def __exit__(self, *exc):
        self.rec[3] = _clock()
        stack = _stack()
        if stack and stack[-1] is self.rec:
            stack.pop()
        if self.marks:
            if _nvtx:
                torch.cuda.nvtx.range_pop()
            self.rf.__exit__(*exc)
        return False


def hook(name: str):
    """The span ``name`` (DR_HOOK equivalent); see the module's text."""
    return _Span(name, True) if _on else _OFF


def gstats(name: str):
    """The span ``name`` without profiler or NVTX range (GSTATS
    equivalent)."""
    return _Span(name, False) if _on else _OFF


def count(name: str, n: int) -> None:
    """Adds n to the counter ``name`` while the recorder is on."""
    if _on:
        stack = _stack()
        _counts.append([name, n, stack[-1] if stack else None])


def counters() -> dict:
    """name -> total of each counter since the list was last emptied."""
    out = collections.Counter()
    for name, n, _ in list(_counts):
        out[name] += n
    return dict(out)


def counts() -> list:
    """The counter records, in order: (name, n, index in ``spans()`` of
    the innermost span open when it was counted, or -1)."""
    recs = list(_records)
    pos = {id(r): i for i, r in enumerate(recs)}
    return [(name, n, -1 if r is None else pos.get(id(r), -1))
            for name, n, r in list(_counts)]


def _on_gc(phase: str, info: dict) -> None:
    global _gc_open
    if phase == "start":
        rf = torch.profiler.record_function(PREFIX + "gc")
        rf.__enter__()
        rec = ["gc", None, _clock(), 0]
        _records.append(rec)
        _gc_open = (rec, rf)
    elif _gc_open is not None:
        rec, rf = _gc_open
        _gc_open = None
        rec[3] = _clock()
        rf.__exit__(None, None, None)


def enable() -> None:
    """Switch the recorder on."""
    global _on, _nvtx
    if not _on:
        _nvtx = torch.cuda.is_available()
        gc.callbacks.append(_on_gc)
        _on = True


def disable() -> None:
    """Switch the recorder off; the list is kept."""
    global _on
    if _on:
        _on = False
        gc.callbacks.remove(_on_gc)


def enabled() -> bool:
    return _on


def spans() -> list:
    """The records, in the order the spans were entered: (name, index of
    the parent in this list or -1, t0_ns, t1_ns), t1_ns 0 while open."""
    recs = list(_records)
    pos = {id(r): i for i, r in enumerate(recs)}
    return [(r[0], -1 if r[1] is None else pos.get(id(r[1]), -1), r[2], r[3])
            for r in recs]


def reset_gstats() -> None:
    """Empty the list and the counters."""
    _records.clear()
    _counts.clear()
    _stack().clear()


def gstats_report(out=None) -> str:
    """GSTATS-style report of the closed spans by name: count, total, self
    (total less the spans nested in them), avg, min, max (seconds)."""
    recs = spans()
    nested = [0] * len(recs)
    for name, parent, t0, t1 in recs:
        if parent >= 0 and t1:
            nested[parent] += t1 - t0
    by = collections.defaultdict(list)
    for i, (name, _, t0, t1) in enumerate(recs):
        if t1:
            by[name].append((t1 - t0, t1 - t0 - nested[i]))
    lines = [f"{'region':32s} {'count':>6s} {'total':>10s} {'self':>10s} "
             f"{'avg':>10s} {'min':>10s} {'max':>10s}"]
    for name in sorted(by):
        d = [x * 1e-9 for x, _ in by[name]]
        own = sum(s for _, s in by[name]) * 1e-9
        lines.append(f"{name:32s} {len(d):6d} {sum(d):10.6f} {own:10.6f} "
                     f"{sum(d) / len(d):10.6f} {min(d):10.6f} {max(d):10.6f}")
    rep = "\n".join(lines)
    if out is not None:
        print(rep, file=out)
    return rep
