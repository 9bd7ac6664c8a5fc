"""The port's own spans in a traced window, and a probe that reads them.

``ectrans_tpu_torch.utils.timing`` marks the port's layer boundaries with
``ectrans:<name>`` profiler ranges while its recorder is on (``api.*``,
``spectral``, ``legendre``, ``fourier``, ``fourier.bucket``, ``build.*``,
``gc``).  ``reduce_port`` reduces those annotations of a Chrome trace as a
family of its own, beside the ``perfbench:`` spans of ``tracing.py``, whose
reduction never sees them: each device activity belongs, by its launch's
host time, to the innermost ``ectrans:`` span; host time inside the
outermost ``api.*`` spans is split into the port's own and that inside
CUDA runtime and driver calls.  ``READERS`` turns the result into the
per-layer numbers, each from the spans it declares; ``build_seconds``
reads the recorder's list for the seconds of the outermost ``build.*``
spans.

The probe runs one cell's program as ``harness.py`` does, with the
recorder on from before the program is built, and then traces windows
of the cell's steps in turns with the recorder off and on (off, on, on,
off, ...), each reduced in both families, and times untraced closed
loops the same way.  On a CUDA card, from the root of a checkout:

    python3 -m perfbench.portspans --workload <cell> --seed <n> \
        [--windows 2] [--loop-steps 40]

It prints one JSON object, the last line of standard output.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import os
import statistics
import sys
import tempfile
import time

from . import tracing

PREFIX = "ectrans:"
API = "api."


@dataclasses.dataclass
class PortSummary:
    """The ``ectrans:`` family of a traced window of ``steps`` steps."""

    steps: int
    present: set            # the span names in the window
    device_s: dict          # innermost span at launch (None: none) -> s
    host_s: dict            # span name -> s inside the union of its spans
    api_s: float            # s inside the outermost api.* spans
    runtime_s: float        # of it, s inside CUDA runtime and driver calls
    launches: int           # device activities launched inside api.* spans


def _holding(union: list, t: float):
    """The interval of a sorted union that holds t, or None."""
    i = bisect.bisect_right(union, (t, float("inf"))) - 1
    return union[i] if i >= 0 and union[i][0] <= t <= union[i][1] else None


def _overlap(a: list, b: list) -> float:
    """The length of the intersection of two unions of intervals."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot


def _length(union: list) -> float:
    return sum(b - a for a, b in union)


def port_spans(events: list) -> dict:
    """span name -> [(start, end)] in microseconds, of the ``ectrans:``
    ranges on the host."""
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("ph") in (None, "X") and e.get("cat") == "user_annotation" \
                and e["name"].startswith(PREFIX):
            a = float(e["ts"])
            spans[e["name"][len(PREFIX):]].append((a, a + float(e["dur"])))
    return dict(spans)


def reduce_port(events: list, steps: int) -> PortSummary:
    """Reduce the ``ectrans:`` annotations of Chrome-trace events (as
    ``tracing.reduce_events`` takes them) of one window of ``steps``
    steps."""
    spans = port_spans(events)
    unions = {n: tracing.union(iv) for n, iv in spans.items()}
    api = tracing.union([x for n, iv in spans.items() if n.startswith(API)
                         for x in iv])
    launch_t, runtime, device = {}, [], []
    for e in events:
        cat = e.get("cat", "")
        if e.get("ph") not in (None, "X"):
            continue
        if cat in tracing.LAUNCH_CATS:
            a = float(e["ts"])
            runtime.append((a, a + float(e["dur"])))
            c = e.get("args", {}).get("correlation")
            if c is not None:
                launch_t[c] = a
        elif cat in tracing.DEVICE_CATS:
            device.append(e)
    dev_s = collections.defaultdict(float)
    launches = 0
    for e in device:
        t = launch_t.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        best, best_len = None, None
        for name, un in unions.items():
            iv = _holding(un, t)
            if iv and (best_len is None or iv[1] - iv[0] < best_len):
                best, best_len = name, iv[1] - iv[0]
        dev_s[best] += float(e["dur"]) * 1e-6
        launches += _holding(api, t) is not None
    return PortSummary(
        steps=steps, present=set(spans), device_s=dict(dev_s),
        host_s={n: _length(u) * 1e-6 for n, u in unions.items()},
        api_s=_length(api) * 1e-6,
        runtime_s=_overlap(api, tracing.union(runtime)) * 1e-6,
        launches=launches)


def _ms(p: PortSummary, seconds: float):
    return seconds / p.steps * 1e3 if seconds > 0 else None


def _enqueue_ms(p):
    return _ms(p, p.api_s - p.runtime_s)


def _launches(p):
    return p.launches / p.steps if p.launches else None


APIS = ("api.inv_trans", "api.dir_trans")

#: metric -> (the port spans it reads, its reading of a PortSummary)
READERS = {
    "api.enqueue_ms": (APIS, _enqueue_ms),
    "spectral.device_ms": (
        ("spectral",), lambda p: _ms(p, p.device_s.get("spectral", 0.0))),
    "launches": (APIS, _launches),
    "rt.api.enqueue_ms": (APIS, _enqueue_ms),
    "rt.launches": (APIS, _launches),
    "rt.fourier.host_ms": (
        ("fourier",), lambda p: _ms(p, p.host_s.get("fourier", 0.0))),
    "rt.legendre.host_ms": (
        ("legendre",), lambda p: _ms(p, p.host_s.get("legendre", 0.0))),
}


def read(p: PortSummary, names, say) -> dict:
    """name -> reading of each of ``names`` that has one.  Nothing where
    the window holds no ``api.*`` span (the recorder was off); a metric
    whose declared span is missing from a window that holds them is left
    out and named through ``say``."""
    if not any(n.startswith(API) for n in p.present):
        return {}
    out = {}
    for name in names:
        declared, fn = READERS[name]
        missing = [s for s in declared if s not in p.present]
        if missing:
            say(f"perfbench: port span(s) {', '.join(missing)} not in the "
                f"trace; {name} is left out")
            continue
        v = fn(p)
        if v is not None:
            out[name] = v
    return out


def build_seconds(records: list):
    """Seconds inside the outermost closed ``build.*`` spans of the
    recorder's records (``timing.spans()``); None where there are none."""
    total = 0
    for name, parent, a, b in records:
        if not name.startswith("build.") or not b:
            continue
        while parent >= 0 and not records[parent][0].startswith("build."):
            parent = records[parent][1]
        if parent < 0:
            total += b - a
    return total * 1e-9 if total > 0 else None


def label_gaps(events: list, top: int = 10) -> list:
    """The ``top`` longest idle gaps of the device in the window, longest
    first, each ``[label, s]``: the innermost ``ectrans:`` span (``gc``
    included) that covers more than half of the gap's host interval, else
    the innermost ``perfbench:`` span at the gap's start, else
    "harness"."""
    ours = port_spans(events)
    theirs = collections.defaultdict(list)
    busy = []
    for e in events:
        if e.get("ph") not in (None, "X"):
            continue
        cat = e.get("cat", "")
        a = float(e.get("ts", 0))
        if cat == "user_annotation" and e["name"].startswith(tracing.PREFIX):
            theirs[e["name"][len(tracing.PREFIX):]].append(
                (a, a + float(e["dur"])))
        elif cat in tracing.DEVICE_CATS:
            busy.append((a, a + float(e["dur"])))
    window = theirs.pop(tracing.WINDOW, None)
    busy = tracing.union(busy)
    if window:
        w0, w1 = window[0]
    elif busy:
        w0, w1 = busy[0][0], busy[-1][1]
    else:
        return []
    edges = [(w0, w0)] + busy + [(w1, w1)]
    gaps = [(b, a) for (_, b), (a, _) in zip(edges, edges[1:]) if a > b]
    gaps.sort(key=lambda g: g[0] - g[1])
    by_name = {}
    for name, iv in theirs.items():
        iv.sort()
        by_name[name] = ([a for a, _ in iv], iv)
    out = []
    for b, a in gaps[:top]:
        best, best_len = None, None
        for name, iv in ours.items():
            for s, e in iv:
                cover = min(a, e) - max(b, s)
                if cover > (a - b) / 2 and (best_len is None
                                            or e - s < best_len):
                    best, best_len = name, e - s
        out.append([best or tracing._innermost(by_name, b) or "harness",
                    (a - b) * 1e-6])
    return out


def trace(run, spans: dict, say=None) -> tuple:
    """Run ``run()`` under the profiler with the harness's ``perfbench:``
    spans in place, as ``tracing.profile`` does; returns (its Chrome-trace
    events, the broken span names)."""
    import torch
    from torch.profiler import ProfilerActivity, supported_activities

    acts = [ProfilerActivity.CPU]
    if ProfilerActivity.CUDA in supported_activities() and \
            torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with tracing.wrapped(spans, say) as broken:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(tracing.PREFIX +
                                                tracing.WINDOW):
                run()
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
    return events, broken


def _plan_cache_size(device) -> int:
    import torch

    if device.type != "cuda":
        return 0
    return torch.backends.cuda.cufft_plan_cache[device.index].size


def probe(cell, seed: int, device, t0: float, windows: int = 2,
          loop_steps: int = 40, say=None) -> dict:
    """Set-up with the recorder on, then ``2 * windows`` traced windows
    and as many untraced loops of ``loop_steps`` steps, the recorder off
    and on in turns; returns what they read."""
    import torch

    from ectrans_tpu_torch.utils import timing

    from . import harness, spec, work

    say = say or (lambda s: print(s, file=sys.stderr))
    timing.reset_gstats()
    timing.enable()
    try:
        config, traffic = cell.config, cell.traffic
        mod = spec.program(config["program"])
        geo = mod.geometry(config)
        dtype = getattr(torch, config["dtype"])
        runner = harness.Runner(traffic, geo, mod.Program(config, traffic),
                                device, dtype)
        sync = harness._sync(device)
        state = runner.inputs(seed)
        for i in range(traffic.warmup_steps):
            runner.step(state, i, (0, i % len(runner.packets)))
        sync()
        setup_s = time.perf_counter() - t0
        records = timing.spans()
        out = dict(setup_s=setup_s, build_s=build_seconds(records),
                   builds={}, windows=[], loops=[])
        for name, parent, a, b in records:
            if name.startswith("build.") and b:
                k = out["builds"].setdefault(name, [0, 0.0])
                k[0] += 1
                k[1] += (b - a) * 1e-9
        say("perfbench: set-up, the port's spans\n" + timing.gstats_report())
        timing.disable()
        readers = {m["name"]: spec.reader(m["name"]) for m in cell.per_layer}
        spans = tracing.merge_spans(readers.values())
        try:
            peak = work.peaks(torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu")
        except KeyError:
            peak = None
        ctx = dict(geo=geo, calls=traffic.calls(), scders=traffic.scders,
                   uvders=traffic.uvders, itemsize=dtype.itemsize, peak=peak)
        sampler = harness.Sampler(seed, 0, len(runner.packets))
        steps = traffic.trace_steps
        box = dict(state=state)

        def go(n):
            box["state"] = runner.loop(box["state"], sampler, steps=n,
                                       sync=sync)[0]

        for k in range(2 * windows):
            on = k % 4 in (1, 2)
            timing.reset_gstats()
            if on:
                timing.enable()
            plans = _plan_cache_size(device)
            events, broken = trace(lambda: go(steps), spans, say)
            recs = timing.spans()
            timing.disable()
            s = tracing.reduce_events(events, steps, broken, ctx)
            old = {n: r.read(s) for n, r in readers.items()
                   if not broken & set(getattr(r, "SPANS", {}))}
            p = reduce_port(events, steps)
            new = read(p, READERS, say)
            new["setup.build_s"] = build_seconds(recs)
            out["windows"].append(dict(
                recorder=on,
                old={n: v for n, v in old.items() if v is not None},
                new={n: v for n, v in new.items() if v is not None},
                port_device_ms={str(n): v / steps * 1e3
                                for n, v in p.device_s.items()},
                port_host_ms={n: v / steps * 1e3
                              for n, v in p.host_s.items()},
                launches_in_window=s.launches, idle_gaps=s.idle_gaps,
                named_gaps=label_gaps(events),
                window_builds=sorted({r[0] for r in recs
                                      if r[0].startswith("build.")}),
                plan_cache_growth=_plan_cache_size(device) - plans))
            del events
        for k in range(2 * windows):
            on = k % 4 in (1, 2)
            timing.reset_gstats()
            if on:
                timing.enable()
            _, times, wall = runner.loop(box["state"], sampler,
                                         steps=loop_steps, sync=sync)
            timing.disable()
            out["loops"].append(dict(recorder=on,
                                     median_ms=statistics.median(times) * 1e3,
                                     window_ms=wall / len(times) * 1e3))
    finally:
        timing.disable()
        timing.reset_gstats()
    runner.prog.close()
    return out


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--windows", type=int, default=2)
    p.add_argument("--loop-steps", type=int, default=40)
    args = p.parse_args(argv)
    from . import spec

    cell = spec.load(args.workload)
    spec.set_environment(cell.config)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: the probe needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = probe(cell, args.seed, device, t0, args.windows, args.loop_steps)
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(device))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
