"""The mesh cell's readers: their arithmetic on a made-up trace, rank 0's
share of the work, and a traced run of the mesh program on the CPU (4
gloo ranks at O48) in which every span they name is found."""

import json
import time

import pytest
import torch

from perfbench import harness, meshwork, spec, tracing, traffic, work

from .small import STEP

MESH = ["mesh.comm.device_ms", "mesh.comm_roofline",
        "mesh.boundary.device_ms", "mesh.fourier.device_ms",
        "mesh.fourier_roofline", "mesh.legendre.device_ms",
        "mesh.legendre_roofline", "mesh.device.idle_share"]
PEAK = {"hbm_bytes_per_s": 3.35e12, "fp32_flop_per_s": 67e12}
KIND = "NVIDIA H100 80GB HBM3"


def _summary(geo, calls):
    """Two steps in a 1 s window: 0.2 s in the transpositions, 0.1 s at
    the boundary, 0.3 s of Fourier, 0.1 s of Legendre, 0.8 s busy."""
    return tracing.Summary(
        steps=2, window_s=1.0, busy_s=0.8,
        device_s={"mesh.comm": 0.2, "mesh.boundary": 0.1, "fourier": 0.3,
                  "legendre": 0.1, None: 0.1},
        host_s={}, broken=set(), launches=0, unmatched=0, device_ops=[],
        idle_gaps=[], context=dict(geo=geo, calls=calls, scders=True,
                                   uvders=True, itemsize=4, peak=PEAK))


def test_mesh_readers_arithmetic(monkeypatch):
    from ectrans_tpu_torch.parallel import comm

    geo = spec.program("mesh").MeshGeometry(48, 47, mesh=(2, 2))
    calls = [("inv", 3, 7), ("dir", 3, 7)]
    s = _summary(geo, calls)
    read = {m: spec.reader(m) for m in MESH}
    assert read["mesh.comm.device_ms"].read(s) == pytest.approx(100.0)
    assert read["mesh.boundary.device_ms"].read(s) == pytest.approx(50.0)
    assert read["mesh.fourier.device_ms"].read(s) == pytest.approx(150.0)
    assert read["mesh.legendre.device_ms"].read(s) == pytest.approx(50.0)
    assert read["mesh.device.idle_share"].read(s) == pytest.approx(20.0)
    # rank 0's share: 2 of the 3 uv and 4 of the 7 scalar fields, half
    # the rows and half the m's
    nb = meshwork.fourier_bytes(geo, calls, True, True, 4, (2, 2))
    per = (2 * (geo.nmen[meshwork.rank_rows(geo, 2, 2, 0)] + 1).sum()
           + geo.nloen[meshwork.rank_rows(geo, 2, 2, 0)].sum()) * 4
    assert nb == per * ((2 * 2 * 2 + 4 * 3) + (2 * 2 + 4))
    assert read["mesh.fourier_roofline"].read(s) == pytest.approx(
        nb / 3.35e12 / 0.15 * 100)
    nb, fl = meshwork.legendre_work(geo, calls, True, 4, 4, (2, 2))
    whole_b, whole_f = work.legendre_work(geo, [("inv", 2, 4),
                                                ("dir", 2, 4)], True)
    assert 0.4 * whole_f < fl < 0.6 * whole_f
    assert read["mesh.legendre_roofline"].read(s) == pytest.approx(
        max(nb / 3.35e12, fl / 67e12) / 0.05 * 100)
    # the bytes counted since the reader was loaded, at the link peak
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: KIND)
    monkeypatch.setitem(comm.TRAFFIC, "TRMTOL", comm.TRAFFIC["TRMTOL"]
                        + 9 * 10 ** 9)
    monkeypatch.setitem(comm.TRAFFIC, "grid", comm.TRAFFIC["grid"] + 10 ** 9)
    assert read["mesh.comm_roofline"].read(s) == pytest.approx(
        4.5e9 / 450e9 / 0.1 * 100)
    # a single-device trace has no mesh to count a share for
    s.context["geo"] = spec.program("octahedral").geometry(
        dict(gauss_number=48, truncation=47))
    assert read["mesh.fourier_roofline"].read(s) is None
    assert read["mesh.legendre_roofline"].read(s) is None


def test_link_peak_is_known_for_the_card():
    peaks = json.loads(meshwork.LINKS.read_text())
    assert meshwork.link_peak(KIND) == 450e9
    assert set(peaks) <= set(json.loads(work.PEAKS.read_text()))
    assert meshwork.link_peak("another card") is None


def test_traced_mesh_run_finds_every_span(monkeypatch):
    """The mesh program at O48 on 4 CPU ranks, traced: correct, and every
    span the mesh readers name is found and entered: each function that
    they wrap runs in rank 0's process (the CPU has no device activities
    for them to read)."""
    import functools
    import importlib

    called = {}
    for name in MESH:
        for paths in getattr(spec.reader(name), "SPANS", {}).values():
            for path in paths:
                mod, attr = path.split(":")
                mod = importlib.import_module(mod)
                called[path] = 0

                def count(*a, _fn=getattr(mod, attr), _path=path, **k):
                    called[_path] += 1
                    return _fn(*a, **k)

                monkeypatch.setattr(mod, attr, functools.wraps(
                    getattr(mod, attr))(count))
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    conf = dict(program="mesh", mesh="2x2", grid="O48", gauss_number=48,
                truncation=47, dtype="float32", precision="highest", env={})
    lim = json.loads((spec.HERE / "limits" /
                      "tco1279-l137-mesh2x2.json").read_text())
    shape = dict(STEP, levels=16, packet_levels=8, trace_steps=1)
    cell = spec.Cell("mesh-small", 4, conf, traffic.from_dict("s", shape),
                     lim, [], [m for m in bench["per_layer"]
                               if m["name"] in MESH])
    mod = spec.program("mesh")
    said = []
    r = harness.run(cell, 2 ** 40 + 3, 0.0, True, time.perf_counter(),
                    torch.device("cpu"),
                    program=lambda g, t, d: mod.Program(conf, t, "cpu"),
                    say=said.append)
    assert r["correct"], r["checks"]
    assert not [s for s in said if "not found" in s]
    assert called and not [p for p, n in called.items() if not n]
    assert set(r["metrics"]) <= set(MESH)
