"""The port's ``ectrans:`` spans in a trace: they change nothing that the
harness's readers read, and ``portspans`` reduces them to hand-computed
values; a missing span leaves its metric out and names it; the idle gaps
are named by the port's spans; the probe runs a small cell on the CPU."""

import json
import pathlib
import time

import pytest
import torch

from perfbench import portspans, spec, tracing

from .small import F1, cell

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


def _ev(cat, name, ts, dur, **args):
    return dict(ph="X", cat=cat, name=name, ts=ts, dur=dur, args=args)


def _harness_family():
    """A window of 1000 us with the harness's spans, launches (one of them
    a wait with no device activity) and device activities."""
    rt = "cuda_runtime"
    return [
        _ev("user_annotation", "perfbench:window", 0, 1000),
        _ev("user_annotation", "perfbench:api", 10, 300),
        _ev("user_annotation", "perfbench:fourier", 50, 100),
        _ev("user_annotation", "perfbench:legendre", 160, 90),
        _ev(rt, "cudaLaunchKernel", 20, 5, correlation=1),
        _ev(rt, "cudaLaunchKernel", 60, 5, correlation=2),
        _ev(rt, "cudaLaunchKernel", 170, 10, correlation=4),
        _ev(rt, "cudaStreamSynchronize", 260, 30, correlation=10),
        _ev(rt, "cudaMemcpyAsync", 410, 5, correlation=3),
        _ev("kernel", "k_sp", 100, 50, correlation=1),
        _ev("kernel", "k_four", 150, 200, correlation=2),
        _ev("kernel", "k_leg", 360, 40, correlation=4),
        _ev("gpu_memcpy", "copy", 600, 100, correlation=3),
        _ev("kernel", "lost", 800, 10, correlation=9),
    ]


def _port_family(without=()):
    ua = "user_annotation"
    evs = [
        _ev(ua, "ectrans:api.inv_trans", 10, 290),
        _ev(ua, "ectrans:spectral", 12, 28),
        _ev(ua, "ectrans:fourier", 50, 100),
        _ev(ua, "ectrans:fourier.bucket", 60, 40),
        _ev(ua, "ectrans:fourier.bucket", 100, 40),
        _ev(ua, "ectrans:legendre", 160, 90),
        _ev(ua, "ectrans:api.dir_trans", 320, 200),
        _ev(ua, "ectrans:legendre", 330, 70),
        _ev(ua, "ectrans:gc", 700, 90),
        # the profiler's projection of a range onto the device's stream
        _ev("gpu_user_annotation", "ectrans:spectral", 100, 50),
    ]
    return [e for e in evs if e["name"][len("ectrans:"):] not in without]


def _per_layer_readers():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return {m["name"]: spec.reader(m["name"]) for m in bench["per_layer"]}


def test_port_spans_change_nothing_the_harness_reads():
    base = _harness_family()
    both = base + _port_family()
    ctx = {}
    a = tracing.reduce_events(base, 2, set(), ctx)
    b = tracing.reduce_events(both, 2, set(), ctx)
    assert a == b
    readers = _per_layer_readers()
    assert len(readers) >= 14
    for name, r in readers.items():
        assert r.read(a) == r.read(b), name


def test_port_family_reads_its_hand_computed_values():
    p = portspans.reduce_port(_harness_family() + _port_family(), steps=2)
    assert p.present == {"api.inv_trans", "api.dir_trans", "spectral",
                         "fourier", "fourier.bucket", "legendre", "gc"}
    # api: [10, 300] and [320, 520]; runtime inside them 5+5+10+30+5 us
    assert p.api_s == pytest.approx(490e-6)
    assert p.runtime_s == pytest.approx(55e-6)
    # launched at 20 in spectral, at 60 in a bucket (the buckets' union
    # [60, 140] is inside fourier), at 170 in legendre, at 410 in the
    # direct api span only; the lost one is nobody's
    assert p.device_s == pytest.approx({
        "spectral": 50e-6, "fourier.bucket": 200e-6, "legendre": 40e-6,
        "api.dir_trans": 100e-6})
    assert p.launches == 4
    assert p.host_s["legendre"] == pytest.approx(160e-6)
    got = portspans.read(p, portspans.READERS, say=pytest.fail)
    assert got == pytest.approx({
        "api.enqueue_ms": 0.2175, "rt.api.enqueue_ms": 0.2175,
        "spectral.device_ms": 0.025, "launches": 2.0, "rt.launches": 2.0,
        "rt.fourier.host_ms": 0.05, "rt.legendre.host_ms": 0.08})


def test_a_missing_port_span_leaves_its_metric_out():
    said = []
    p = portspans.reduce_port(
        _harness_family() + _port_family(without=("legendre",)), steps=2)
    got = portspans.read(p, portspans.READERS, said.append)
    assert "rt.legendre.host_ms" not in got and "rt.launches" in got
    assert len(said) == 1 and "legendre" in said[0]
    # no api span at all (the recorder was off): nothing, and no word
    p = portspans.reduce_port(
        _harness_family() + _port_family(without=("api.inv_trans",
                                                  "api.dir_trans")), 2)
    said.clear()
    assert portspans.read(p, portspans.READERS, said.append) == {}
    assert not said


def test_build_seconds_count_the_outermost_builds():
    recs = [("build.full_legendre", -1, 0, 2_000_000_000),
            ("build.legendre_groups", 0, 100, 200_000_000),
            ("api.inv_trans", -1, 3_000_000_000, 4_000_000_000),
            ("build.fourier_buckets", 2, 3_100_000_000, 3_600_000_000),
            ("build.open", -1, 5_000_000_000, 0)]
    assert portspans.build_seconds(recs) == pytest.approx(2.5)
    assert portspans.build_seconds(recs[2:3]) is None


def test_idle_gaps_are_named_by_the_port_spans():
    events = _harness_family() + _port_family()
    assert portspans.label_gaps(events) == [
        ["api.dir_trans", pytest.approx(200e-6)],
        ["harness", pytest.approx(190e-6)],
        ["api.inv_trans", pytest.approx(100e-6)],
        ["gc", pytest.approx(100e-6)],
        ["legendre", pytest.approx(10e-6)]]
    # without the port's spans, the harness's names, as tracing gives them
    base = _harness_family()
    want = tracing.reduce_events(base, 2, set(), {}).idle_gaps
    assert portspans.label_gaps(base) == [
        [n, pytest.approx(s)] for n, s in want]


def test_probe_runs_a_small_cell_on_the_cpu():
    from ectrans_tpu_torch.utils import timing

    said = []
    c = cell(F1, "tco639-f1-rt")
    c.per_layer = [m for m in c.per_layer if m["name"] == "rt.api.host_ms"]
    out = portspans.probe(c, 2 ** 33 + 7, torch.device("cpu"),
                          time.perf_counter(), windows=1, loop_steps=3,
                          say=said.append)
    assert not timing.enabled() and timing.spans() == []
    assert out["build_s"] > 0 and "build.full_legendre" in out["builds"]
    off, on = out["windows"]
    assert not off["recorder"] and on["recorder"]
    assert off["new"] == {} and set(off["old"]) == set(on["old"]) == {
        "rt.api.host_ms"}
    # no device on the CPU: the host readings only
    assert set(on["new"]) == {"api.enqueue_ms", "rt.api.enqueue_ms",
                              "rt.fourier.host_ms", "rt.legendre.host_ms"}
    assert on["window_builds"] == [] and on["plan_cache_growth"] == 0
    assert [lp["recorder"] for lp in out["loops"]] == [False, True]
