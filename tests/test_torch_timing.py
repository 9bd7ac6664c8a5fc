"""The port's span recorder (``ectrans_tpu_torch.utils.timing``) at its
layer boundaries: nothing at all while it is off, the span tree of a
round trip while it is on, one ``build.*`` span a cache miss, and the
collector's spans."""

import gc

import pytest
import torch

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.ops import fourier
from ectrans_tpu_torch.utils import timing


@pytest.fixture
def recorder():
    timing.reset_gstats()
    timing.enable()
    try:
        yield timing
    finally:
        timing.disable()
        timing.reset_gstats()


@pytest.fixture(scope="module")
def res():
    return ett.setup("O48", 47)


def _inputs(res, nuv=1, nsc=2, seed=5):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(n, res.nspec2, generator=g, dtype=torch.float64)
            for n in (nuv, nuv, nsc)]


def _round_trip(res, engine="dense", **kw):
    vor, div, sc = _inputs(res)
    g = ett.inv_trans(res, vor, div, sc, dtype=torch.float64,
                      _engine=engine, **kw)
    return ett.dir_trans(res, g[:1], g[1:2], g[2:4], dtype=torch.float64,
                         _engine=engine, **kw)


def test_off_records_nothing_and_marks_nothing(res, monkeypatch):
    """With the recorder off a round trip enters no profiler range, no
    NVTX range and reads no clock; a profiler trace holds no ``ectrans:``
    event."""
    _round_trip(res)                                # builds what it needs
    assert not timing.enabled()

    def refuse(*a, **k):
        raise AssertionError("the recorder is off")

    monkeypatch.setattr(timing, "_clock", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    timing.reset_gstats()
    _round_trip(res)
    monkeypatch.undo()
    with torch.profiler.profile() as prof:
        _round_trip(res)
    assert not [e.name for e in prof.events()
                if e.name.startswith(timing.PREFIX)]
    assert timing.spans() == []


def _children(recs, i):
    return [r[0] for r in recs if r[1] == i]


@pytest.mark.parametrize("engine", ["dense", "xla"])
def test_round_trip_span_tree(res, recorder, engine, monkeypatch):
    """inv_trans: api > spectral, legendre, spectral, fourier > one span
    a bucket; dir_trans: api > fourier > buckets, spectral (LDFOU2),
    legendre, spectral; every span closed inside its parent."""
    monkeypatch.setenv("ECTRANS_TPU_FFT_BUCKETS", "3")
    _round_trip(res, engine)                        # builds what it needs
    recorder.reset_gstats()
    _round_trip(res, engine)
    recs = [r for r in recorder.spans() if r[0] != "gc"]
    nb = len(fourier.bucketed_tables(res, "cpu").buckets)
    assert nb == 3
    tops = [i for i, r in enumerate(recs) if r[1] == -1]
    assert [recs[i][0] for i in tops] == ["api.inv_trans", "api.dir_trans"]
    inv, dir_ = tops
    assert _children(recs, inv) == ["spectral", "legendre", "spectral",
                                    "fourier"]
    assert _children(recs, dir_) == ["fourier", "spectral", "legendre",
                                     "spectral"]
    for i, r in enumerate(recs):
        if r[0] == "fourier":
            assert _children(recs, i) == ["fourier.bucket"] * nb
        if r[1] >= 0:
            p = recs[r[1]]
            assert p[2] <= r[2] <= r[3] <= p[3]
    assert not [r for r in recs if r[0].startswith("build.")]


def test_packets_nest_one_api_span_each(res, recorder):
    vor, div, sc = _inputs(res, nuv=2, nsc=3)
    ett.inv_trans(res, vor, div, sc, npromatr=2, dtype=torch.float64)
    recorder.reset_gstats()
    g = ett.inv_trans(res, vor, div, sc, npromatr=2, dtype=torch.float64)
    ett.dir_trans(res, g[:2], g[2:4], g[4:7], npromatr=2,
                  dtype=torch.float64)
    recs = recorder.spans()
    tops = [i for i, r in enumerate(recs) if r[1] == -1 and r[0] != "gc"]
    assert [recs[i][0] for i in tops] == ["api.inv_trans", "api.dir_trans"]
    # two uv packets of one pair, then two scalar packets of two fields
    for i, name in zip(tops, ("api.inv_trans", "api.dir_trans")):
        assert _children(recs, i) == [name] * 4


def test_a_cache_miss_is_one_build_span(recorder):
    res = ett.setup("O16", 15)
    calls = []
    assert res.cached(("probe_table", 1), lambda: calls.append(1) or 7) == 7
    assert res.cached(("probe_table", 1), lambda: calls.append(1) or 8) == 7
    builds = [r for r in recorder.spans() if r[0].startswith("build.")]
    assert [r[0] for r in builds] == ["build.probe_table"] and calls == [1]
    assert builds[0][3] >= builds[0][2] > 0


def test_a_collection_is_a_gc_span(recorder):
    with timing.gstats("outer"):
        gc.collect()
    recs = recorder.spans()
    mine = [r for r in recs if r[0] == "gc"]
    assert mine and all(r[1] == -1 and r[3] >= r[2] for r in mine)
    timing.disable()
    n = len(recorder.spans())
    gc.collect()
    assert len(recorder.spans()) == n
    assert timing._on_gc not in gc.callbacks


def test_gstats_has_no_profiler_range(recorder):
    with torch.profiler.profile() as prof:
        with timing.gstats("quiet"):
            with timing.hook("loud"):
                torch.ones(2).sum()
    names = {e.name for e in prof.events()}
    assert "ectrans:loud" in names and "ectrans:quiet" not in names
    recs = [r for r in recorder.spans() if r[0] != "gc"]
    assert [(r[0], r[1]) for r in recs] == [("quiet", -1), ("loud", 0)]
