"""The metric arithmetic: the window rate, the 95th percentile over all
steps, the union of intervals and the trace's attribution to spans."""

import statistics

import pytest
import torch

from perfbench import harness, spec, tracing


def _rec(times, window):
    return harness.Record(times=times, window_s=window, steps=len(times),
                          peak_bytes=3 * 2 ** 30, setup_s=1.5)


def test_window_rate_is_all_the_time_over_all_the_steps():
    r = _rec([0.01] * 9 + [0.11], 0.25)
    assert spec.reader("step_ms").read(r) == pytest.approx(25.0)
    assert spec.reader("peak_gib").read(r) == 3.0
    assert spec.reader("setup_s").read(r) == 1.5


def test_p95_is_taken_over_every_step():
    times = [i / 1000 for i in range(1, 101)]          # 1 .. 100 ms
    r = _rec(times, sum(times))
    assert spec.reader("p95_rt_ms").read(r) == pytest.approx(95.05)
    assert statistics.quantiles(times, n=20, method="inclusive")[18] \
        == pytest.approx(0.09505)
    assert spec.reader("p95_rt_ms").read(_rec(times[:10], 1.0)) is None


def test_union_of_intervals():
    iv = [(5, 7), (0, 2), (1, 3), (6, 6.5), (10, 11)]
    assert tracing.union(iv) == [(0, 3), (5, 7), (10, 11)]
    assert sum(b - a for a, b in tracing.union(iv)) == 6


def _ev(cat, name, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args)


def _trace():
    """A window of 1000 us: an API span holding a Fourier span, launches
    in each and one outside every span."""
    return [
        _ev("user_annotation", "perfbench:window", 0, 1000),
        _ev("user_annotation", "perfbench:api", 10, 300),
        _ev("user_annotation", "perfbench:fourier", 50, 100),
        _ev("cuda_runtime", "cudaLaunchKernel", 20, 5, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 60, 5, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 400, 5, correlation=3),
        _ev("kernel", "k_api", 100, 50, correlation=1),
        _ev("kernel", "k_fourier", 150, 200, correlation=2),
        _ev("gpu_memcpy", "copy", 600, 100, correlation=3),
        _ev("kernel", "lost", 800, 10, correlation=9),
    ]


def test_trace_attributes_device_time_to_the_innermost_span():
    s = tracing.reduce_events(_trace(), steps=2, broken=set(), context={})
    assert s.device_s["fourier"] == pytest.approx(200e-6)
    assert s.device_s["api"] == pytest.approx(50e-6)
    assert s.device_s[None] == pytest.approx(110e-6)
    assert s.unmatched == 1 and s.launches == 3
    assert s.busy_s == pytest.approx(360e-6)
    assert s.window_s == pytest.approx(1000e-6)
    assert s.host_s["api"] == pytest.approx(300e-6)
    assert s.device_ops[0] == ["k_fourier", pytest.approx(200e-6)]
    # gaps: 0-100 (api span at 0? no: harness), 350-600, 700-800, 810-1000
    assert s.idle_gaps[0] == ["harness", pytest.approx(250e-6)]
    assert sorted(g[1] for g in s.idle_gaps) == pytest.approx(
        [100e-6, 100e-6, 190e-6, 250e-6])
    assert spec.reader("fourier.device_ms").read(s) == pytest.approx(0.1)
    assert spec.reader("api.host_ms").read(s) == pytest.approx(0.15)
    assert spec.reader("rest.device_ms").read(s) == pytest.approx(0.08)
    assert spec.reader("device.idle_share").read(s) == pytest.approx(64.0)
    assert spec.reader("legendre.device_ms").read(s) is None
    # the round-trip cells' names read the same
    assert spec.reader("rt.fourier.device_ms").read(s) == pytest.approx(0.1)
    assert spec.reader("rt.fourier.device_ms").SPANS == \
        spec.reader("fourier.device_ms").SPANS


def test_held_bytes_are_the_harness_buffers_and_the_update():
    from .small import STEP, cell

    c = cell(STEP, "tco1279-l137-step")
    mod = spec.program("octahedral")
    geo = mod.geometry(c.config)
    r = harness.Runner(c.traffic, geo, None, "cpu", torch.float32)
    r.inputs(11)
    n, s2, g = 1 + c.traffic.kept_steps, geo.nspec2, geo.ngptot
    # vor, div, sc, their outputs (2 + 2 + 5 fields each), 23 grid fields
    bufs = n * 4 * (18 * s2 + 23 * g)
    # the scalar and wind updates, 9 signs; the valid points, the order
    grids = 2 * 4 * geo.ndgl * geo.ndlon + 4 * 9
    idx = 8 * g + 8 * 11
    assert r.held_bytes() == bufs + grids + idx
