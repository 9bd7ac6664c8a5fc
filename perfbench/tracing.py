"""Spans around the program's layers, and the reduction of a
``torch.profiler`` trace to what the per-layer readers read.

A span is named by a metric reader (``SPANS``: span name -> the
``module:attribute`` functions through which the program calls that
layer).  In a traced run only, each such attribute is replaced by a
wrapper that runs the original inside ``record_function("perfbench:<span>")``;
an attribute that is not there any more is named on standard error and its
span is marked broken, so that the readers of that span report nothing and
the others still stand.

The reduction reads the profiler's Chrome trace: the spans (user
annotations), each device activity (kernel, copy, set) with the host time
of the runtime call that launched it (matched by the correlation id), and
attributes each activity to the innermost span that held its launch.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import functools
import importlib
import json
import os
import sys
import tempfile

PREFIX = "perfbench:"
WINDOW = "window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def merge_spans(readers) -> dict:
    """span name -> sorted attribute paths, over the readers' ``SPANS``."""
    out = collections.defaultdict(set)
    for r in readers:
        for name, paths in getattr(r, "SPANS", {}).items():
            out[name].update(paths)
    return {k: sorted(v) for k, v in out.items()}


@contextlib.contextmanager
def wrapped(spans: dict, say=None):
    """Wrap each ``module:attribute`` of ``spans``; yields the set of span
    names whose attributes could not all be found."""
    import torch

    say = say or (lambda s: print(s, file=sys.stderr))
    undo, broken = [], set()
    for span, paths in spans.items():
        for path in paths:
            mod_name, attr = path.split(":")
            try:
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, attr)
            except (ImportError, AttributeError):
                say(f"perfbench: span {span!r}: {path} not found; the "
                    f"metrics that read {span!r} are left out")
                broken.add(span)
                continue

            def wrap(fn, label=PREFIX + span):
                @functools.wraps(fn)
                def inner(*a, **k):
                    with torch.profiler.record_function(label):
                        return fn(*a, **k)
                return inner

            setattr(mod, attr, wrap(orig))
            undo.append((mod, attr, orig))
    try:
        yield broken
    finally:
        for mod, attr, orig in reversed(undo):
            setattr(mod, attr, orig)


def union(intervals) -> list:
    """The union of (start, end) intervals, merged and sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


@dataclasses.dataclass
class Summary:
    """A traced window, per step where a reader wants it."""

    steps: int
    window_s: float
    busy_s: float
    device_s: dict           # span name (None: outside every span) -> s
    host_s: dict             # span name -> s inside it on the host
    broken: set
    launches: int
    unmatched: int           # device activities with no launch found
    device_ops: list         # [name, s], most time first
    idle_gaps: list          # [host span at the gap, s], longest first
    context: dict            # what the readers count work from

    def per_step_ms(self, seconds: float) -> float:
        return seconds / self.steps * 1e3


def _innermost(spans_by_name: dict, t: float):
    """The name of the shortest span that holds host time t, or None."""
    best, best_len = None, None
    for name, (starts, ivals) in spans_by_name.items():
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0:
            a, b = ivals[i]
            if a <= t <= b and (best_len is None or b - a < best_len):
                best, best_len = name, b - a
    return best


def reduce_events(events: list, steps: int, broken: set,
                  context: dict) -> Summary:
    """Reduce Chrome-trace events (dicts with ``cat``, ``name``, ``ts``
    and ``dur`` in microseconds, ``args``) of one traced window."""
    spans = collections.defaultdict(list)
    launch_t = {}
    device = []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") not in (None, "X"):
            continue
        if cat == "user_annotation" and e["name"].startswith(PREFIX):
            a = float(e["ts"])
            spans[e["name"][len(PREFIX):]].append((a, a + float(e["dur"])))
        elif cat in LAUNCH_CATS:
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch_t[c] = float(e["ts"])
        elif cat in DEVICE_CATS:
            device.append(e)
    window = spans.pop(WINDOW, None)
    if window:
        w0, w1 = window[0]
    else:
        w0 = min([float(e["ts"]) for e in device] or [0.0])
        w1 = max([float(e["ts"]) + float(e["dur"]) for e in device] or [0.0])
    by_name = {}
    for name, iv in spans.items():
        iv.sort()
        by_name[name] = ([a for a, _ in iv], iv)
    dev_s = collections.defaultdict(float)
    ops = collections.defaultdict(float)
    unmatched = 0
    ivals = []
    for e in device:
        a, d = float(e["ts"]), float(e["dur"])
        ivals.append((a, a + d))
        ops[e["name"]] += d * 1e-6
        t = launch_t.get(e.get("args", {}).get("correlation"))
        if t is None:
            unmatched += 1
            dev_s[None] += d * 1e-6
            continue
        dev_s[_innermost(by_name, t)] += d * 1e-6
    busy = union(ivals)
    gaps = []
    edges = [(w0, w0)] + busy + [(w1, w1)]
    for (_, b), (a, _) in zip(edges, edges[1:]):
        if a > b:
            gaps.append([_innermost(by_name, b) or "harness", (a - b) * 1e-6])
    gaps.sort(key=lambda g: -g[1])
    host = {n: sum(b - a for a, b in iv) * 1e-6 for n, iv in spans.items()}
    return Summary(
        steps=steps, window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6, device_s=dict(dev_s),
        host_s=host, broken=set(broken), launches=len(launch_t),
        unmatched=unmatched,
        device_ops=sorted(([k, v] for k, v in ops.items()),
                          key=lambda x: -x[1])[:10],
        idle_gaps=gaps[:10], context=context)


def profile(run_steps, spans: dict, steps: int, context: dict,
            say=None) -> Summary:
    """Run ``run_steps()`` under the profiler with the spans in place and
    reduce its trace (written to, read from and removed from TMPDIR)."""
    import torch
    from torch.profiler import ProfilerActivity, supported_activities

    acts = [ProfilerActivity.CPU]
    if ProfilerActivity.CUDA in supported_activities() and \
            torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with wrapped(spans, say) as broken:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(PREFIX + WINDOW):
                run_steps()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
    return reduce_events(events, steps, broken, context)
