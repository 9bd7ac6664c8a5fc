"""Fourier layers of ectrans_tpu_torch against ectrans_tpu's bucketed
chirp-z transforms and against a direct DFT: the unnormalized synthesis,
analysis divided by NLOEN, truncation at each row's nmen, and exact zeros
past each row's NLOEN.  First the per-NLOEN layer (torch.fft batched by
NLOEN, the reference of ``_fourier="rows"``), then the bucketed chirp-z
layer every transform runs: at O48 and F24 T47 (one bucket) and at O48 with
ECTRANS_TPU_FFT_BUCKETS=3 (three), in fp64 (1e-10 of the JAX output, 1e-12
of the DFT) and fp32 (2e-5 + 1e-5 of the DFT's max), with an odd field
count, a zero field and a pair 1e7 apart each within its own scale, the
ignored inputs ignored bit for bit, and the chirp tables against the JAX
package's host tables."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.ops import fourier as jfourier

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.grids import GridSpec
from ectrans_tpu_torch.ops import fourier
from ectrans_tpu_torch.resolution import resolution_from_arrays


def _random_fourier(res, nfld, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nfld, 2, res.M, res.ndgl))


def _dft_synthesis(four, res):
    """f_j = F_0 + 2 sum_{1<=m<=nmen} Re(F_m e^{i m 2 pi j / L}) per row."""
    nfld = four.shape[0]
    out = np.zeros((nfld, res.ndgl, res.grid.ndlon))
    for lat, L in enumerate(res.grid.nloen):
        me = min(int(res.nmen[lat]), res.nsmax)
        m = np.arange(1, me + 1)[:, None]
        ph = 2 * np.pi * m * np.arange(L)[None, :] / L
        re, im = four[:, 0, 1 : me + 1, lat], four[:, 1, 1 : me + 1, lat]
        out[:, lat, :L] = four[:, 0, 0, lat][:, None] + 2 * (
            re @ np.cos(ph) - im @ np.sin(ph))
    return out


def _dft_analysis(grid, res):
    """F_m = (1/L) sum_j f_j e^{-i m 2 pi j / L} for m <= nmen, else 0."""
    nfld = grid.shape[0]
    out = np.zeros((nfld, 2, res.M, res.ndgl))
    for lat, L in enumerate(res.grid.nloen):
        me = min(int(res.nmen[lat]), res.nsmax)
        m = np.arange(me + 1)[:, None]
        ph = 2 * np.pi * m * np.arange(L)[None, :] / L
        f = grid[:, lat, :L]
        out[:, 0, : me + 1, lat] = f @ np.cos(ph).T / L
        out[:, 1, : me + 1, lat] = -(f @ np.sin(ph).T) / L
    return out


@pytest.mark.parametrize("name,nsmax", [("O48", 47), ("F24", 47)])
def test_synthesis_matches_dft_and_jax(name, nsmax):
    res = ett.setup(name, nsmax)
    four = _random_fourier(res, 3, seed=0)
    got = fourier.synthesis(torch.from_numpy(four), res).numpy()
    want = _dft_synthesis(four, res)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    jres = et.setup(name, nsmax)
    jgot = np.asarray(jfourier.synthesis_bucketed(
        jnp.asarray(four), jfourier.bucketed_tables_for(jres, jnp.float64)))
    assert np.abs(got - jgot).max() <= 1e-10 * scale
    # single precision: same contract within fp32 rounding
    got32 = fourier.synthesis(torch.from_numpy(four).float(), res).numpy()
    assert got32.dtype == np.float32
    assert np.abs(got32 - want).max() <= 2e-5 + 1e-5 * scale


@pytest.mark.parametrize("name,nsmax", [("O48", 47), ("F24", 47)])
def test_analysis_matches_dft_and_jax(name, nsmax):
    res = ett.setup(name, nsmax)
    rng = np.random.default_rng(1)
    grid = rng.standard_normal((4, res.ndgl, res.grid.ndlon))
    got = fourier.analysis(torch.from_numpy(grid), res).numpy()
    want = _dft_analysis(grid, res)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    jres = et.setup(name, nsmax)
    jgot = np.asarray(jfourier.analysis_bucketed(
        jnp.asarray(grid), jfourier.bucketed_tables_for(jres, jnp.float64),
        res.M))
    assert np.abs(got - jgot).max() <= 1e-10 * scale


def test_ragged_rows_and_truncation():
    """Synthesis writes exact zeros past NLOEN and ignores modes above nmen
    and the m = 0 imaginary part; analysis ignores points past NLOEN."""
    res = ett.setup("O48", 47)
    four = torch.from_numpy(_random_fourier(res, 2, seed=2))
    grid = fourier.synthesis(four, res)
    nloen = np.asarray(res.grid.nloen)
    cols = np.arange(res.grid.ndlon)[None, :]
    assert torch.all(grid[:, torch.from_numpy(cols >= nloen[:, None])] == 0)
    m = torch.arange(res.M)[:, None]
    dead = m > torch.from_numpy(res.nmen.astype(np.int64))[None, :]
    noisy = four.clone()
    noisy[:, :, dead] = 1e3
    noisy[:, 1, 0, :] = 1e3
    torch.testing.assert_close(fourier.synthesis(noisy, res), grid,
                               rtol=0, atol=0)
    padded = grid.clone()
    padded[:, torch.from_numpy(cols >= nloen[:, None])] = 7.0
    torch.testing.assert_close(fourier.analysis(padded, res),
                               fourier.analysis(grid, res), rtol=0, atol=0)
    back = fourier.analysis(grid, res)
    assert torch.all(back[:, :, dead] == 0)


def test_nyquist_rows_refused():
    """Rows with 2 nmen >= NLOEN (never made by the grid rules; lat-lon
    output grids have them) are no longer refused: the Nyquist mode counts
    twice (2 Re(.)), as in the direct DFT and ectrans_tpu's chirp-z, where
    irfft would read it once.  (More cases, folding past the Nyquist bin,
    in test_torch_latlon.py.)"""
    ref = ett.setup("F24", 47)
    grid = GridSpec("custom", 47, 48, (94,) * 48, reduced=False)
    res = resolution_from_arrays(grid, ref.radius, ref.mu, ref.w,
                                 np.full(48, 47), ref.ndglu, ref.eps)
    four = _random_fourier(res, 2, seed=4)
    got = fourier.synthesis(torch.from_numpy(four), res).numpy()
    want = _dft_synthesis(four, res)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    nyq = np.zeros_like(four)
    nyq[:, 0, 47] = 1.0
    out = fourier.synthesis(torch.from_numpy(nyq), res).numpy()
    assert np.abs(out[0, 0, :94] - 2 * np.cos(np.pi * np.arange(94))).max() \
        < 1e-13


# ---------------------------------------------------------------------------
# The bucketed chirp-z layer (``synthesis_bucketed``/``analysis_bucketed``),
# the one every transform runs, against ectrans_tpu's on the same inputs
# (ECTRANS_TPU_FFT_BUCKETS set for both packages) and against the DFT.

BUCKET_CASES = [("O48", 47, "12"), ("F24", 47, "12"), ("O48", 47, "3")]


def _tables(res):
    return fourier.bucketed_tables(res, "cpu")


def _scaled_fields(x):
    """Fields 0..4 of x with field 1 zero and fields 2, 3 1e7 apart (a
    pair of the pack), field 4 paired with the pad field."""
    x = x.copy()
    x[1] = 0.0
    x[2] *= 1e3
    x[3] *= 1e-4
    return x


def _per_field_ok(got, want, rtol, atol):
    """Each field within rtol of its own largest |value| (atol for a zero
    field)."""
    for f in range(want.shape[0]):
        s = np.abs(want[f]).max()
        err = np.abs(got[f] - want[f]).max()
        assert err <= (rtol * s if s > 0 else atol), (f, err, s)


@pytest.mark.parametrize("name,nsmax,nb", BUCKET_CASES)
def test_bucketed_synthesis_matches_jax_and_dft(name, nsmax, nb, monkeypatch):
    monkeypatch.setenv("ECTRANS_TPU_FFT_BUCKETS", nb)
    res = ett.setup(name, nsmax)
    assert len(_tables(res).buckets) == (
        3 if nb == "3" else 1)
    four = _random_fourier(res, 3, seed=10)
    got = fourier.synthesis_bucketed(torch.from_numpy(four),
                                     _tables(res)).numpy()
    want = _dft_synthesis(four, res)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    jres = et.setup(name, nsmax)
    jgot = np.asarray(jfourier.synthesis_bucketed(
        jnp.asarray(four), jfourier.bucketed_tables_for(jres, jnp.float64)))
    assert np.abs(got - jgot).max() <= 1e-10 * np.abs(jgot).max()
    got32 = fourier.synthesis_bucketed(torch.from_numpy(four).float(),
                                       _tables(res)).numpy()
    assert got32.dtype == np.float32
    assert np.abs(got32 - want).max() <= 2e-5 + 1e-5 * scale
    # odd field count, a zero field, and a pair 1e7 apart: each field
    # within its own scale (the RMS pair scaling)
    four5 = _scaled_fields(_random_fourier(res, 5, seed=11))
    want5 = _dft_synthesis(four5, res)
    for dtype, rtol, atol in ((torch.float64, 1e-12, 1e-13),
                              (torch.float32, 1e-5, 2e-5)):
        got5 = fourier.synthesis_bucketed(
            torch.from_numpy(four5).to(dtype), _tables(res))
        _per_field_ok(got5.double().numpy(), want5, rtol, atol)


@pytest.mark.parametrize("name,nsmax,nb", BUCKET_CASES)
def test_bucketed_analysis_matches_jax_and_dft(name, nsmax, nb, monkeypatch):
    monkeypatch.setenv("ECTRANS_TPU_FFT_BUCKETS", nb)
    res = ett.setup(name, nsmax)
    rng = np.random.default_rng(12)
    grid = rng.standard_normal((4, res.ndgl, res.grid.ndlon))
    got = fourier.analysis_bucketed(torch.from_numpy(grid),
                                    _tables(res),
                                    res.M).numpy()
    want = _dft_analysis(grid, res)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    jres = et.setup(name, nsmax)
    jgot = np.asarray(jfourier.analysis_bucketed(
        jnp.asarray(grid), jfourier.bucketed_tables_for(jres, jnp.float64),
        res.M))
    assert np.abs(got - jgot).max() <= 1e-10 * np.abs(jgot).max()
    got32 = fourier.analysis_bucketed(torch.from_numpy(grid).float(),
                                      _tables(res),
                                      res.M).numpy()
    assert np.abs(got32 - want).max() <= 2e-5 + 1e-5 * scale
    grid5 = _scaled_fields(rng.standard_normal((5, res.ndgl,
                                                res.grid.ndlon)))
    want5 = _dft_analysis(grid5, res)
    for dtype, rtol, atol in ((torch.float64, 1e-12, 1e-13),
                              (torch.float32, 1e-5, 2e-5)):
        got5 = fourier.analysis_bucketed(
            torch.from_numpy(grid5).to(dtype), _tables(res), res.M)
        _per_field_ok(got5.double().numpy(), want5, rtol, atol)


@pytest.mark.parametrize("name,nsmax,nb", BUCKET_CASES)
def test_bucketed_ragged_rows_and_truncation(name, nsmax, nb, monkeypatch):
    """Modes above nmen, m = 0 imaginary parts and points past NLOEN are
    ignored bit for bit (the RMS scaling reads only what the transform
    reads); exact zeros past NLOEN and above nmen."""
    monkeypatch.setenv("ECTRANS_TPU_FFT_BUCKETS", nb)
    res = ett.setup(name, nsmax)
    for dtype in (torch.float64, torch.float32):
        bt = _tables(res)
        four = torch.from_numpy(_random_fourier(res, 3, seed=13)).to(dtype)
        grid = fourier.synthesis_bucketed(four, bt)
        nloen = np.asarray(res.grid.nloen)
        past = torch.from_numpy(np.arange(res.grid.ndlon)[None, :]
                                >= nloen[:, None])
        assert torch.all(grid[:, past] == 0)
        m = torch.arange(res.M)[:, None]
        dead = m > torch.from_numpy(res.nmen.astype(np.int64))[None, :]
        noisy = four.clone()
        noisy[:, :, dead] = 1e3
        noisy[:, 1, 0, :] = -1e3
        assert torch.equal(fourier.synthesis_bucketed(noisy, bt), grid)
        padded = grid.clone()
        padded[:, past] = 7.0
        back = fourier.analysis_bucketed(grid, bt, res.M)
        assert torch.equal(fourier.analysis_bucketed(padded, bt, res.M),
                           back)
        assert torch.all(back[:, :, dead] == 0)
        assert torch.all(back[:, 1, 0] == 0)


def test_bucketed_chirp_tables_match_jax_host_tables():
    """The chirp tables that do not depend on nfft against ectrans_tpu's
    ``host_bluestein_tables`` on one bucket's rows, 1e-15."""
    res = ett.setup("O48", 47)
    for spans in fourier.bucket_spans(res.ndgl, 3):
        rows = np.concatenate([np.arange(a, b) for a, b in spans])
        nloen = tuple(int(res.grid.nloen[r]) for r in rows)
        mb = int(min(res.nsmax, res.nmen[rows].max()))
        nmen = tuple(min(int(res.nmen[r]), mb) for r in rows)
        got = fourier.host_bluestein_tables(nloen, nmen, mb)
        want = jfourier.host_bluestein_tables(nloen, nmen, mb)
        assert got["ndlon"] == want["ndlon"] == max(nloen)
        for k in ("syn_in", "syn_out", "ana_in", "ana_out"):
            w = want[f"{k}_r"] + 1j * want[f"{k}_i"]
            assert got[k].shape == w.shape, k
            assert np.abs(got[k] - w).max() <= 1e-15 * np.abs(w).max(), k
        # the kernels: the FFT of the offset chirp over the circle
        for k in ("syn_bh", "ana_bh"):
            assert got[k].shape == (len(rows), got["nfft"])


def test_bucket_spans_and_lengths():
    """The buckets cover every row once (an odd middle row in the
    equatorial bucket); at TCO1279 the 12 lengths run 882 .. 7776 and
    rows x nfft sums to 12.13 M points (1.84x the grid)."""
    for ndgl, nb in ((96, 3), (97, 3), (2560, 12), (48, 12)):
        spans = fourier.bucket_spans(ndgl, nb)
        rows = np.concatenate([np.arange(a, b) for s in spans
                               for a, b in s])
        assert np.array_equal(np.sort(rows), np.arange(ndgl))
    assert len(fourier.bucket_spans(96, 3)) == 3
    assert len(fourier.bucket_spans(96, 12)) == 1
    assert [fourier.good_size(n) for n in (1, 11, 13, 17, 97, 883)] == [
        1, 12, 14, 18, 98, 896]
    res = ett.setup("TCO1279")
    nloen = np.asarray(res.grid.nloen)
    lengths, points = [], 0
    for spans in fourier.bucket_spans(res.ndgl, 12):
        rows = np.concatenate([np.arange(a, b) for a, b in spans])
        mb = min(res.nsmax, int(res.nmen[rows].max()))
        n = fourier.good_size(int(nloen[rows].max()) + 2 * mb + 1)
        lengths.append(n)
        points += len(rows) * n
    assert lengths[0] == 882 and lengths[-1] == 7776 and len(lengths) == 12
    assert abs(points / 1e6 - 12.13) < 0.01
    assert 1.83 < points / res.grid.ngptot < 1.85


def test_transforms_run_the_buckets_and_rows_on_request(monkeypatch):
    """inv_trans/dir_trans (single calls and packets) run the bucketed
    layer; the private _fourier="rows" runs the per-NLOEN one, within
    1e-12 of it in fp64; an unknown layer is refused."""
    res = ett.setup("O48", 47)
    rng = np.random.default_rng(14)
    sc = torch.from_numpy(rng.standard_normal((3, res.nspec2)))
    sc[:, 1: 2 * (res.nsmax + 1): 2] = 0.0
    calls = []
    for name in ("synthesis_bucketed", "analysis_bucketed"):
        inner = getattr(fourier, name)

        def spy(*a, _inner=inner, _name=name, **k):
            calls.append(_name)
            return _inner(*a, **k)

        monkeypatch.setattr(fourier, name, spy)
    kw = dict(dtype=torch.float64)
    g = ett.inv_trans(res, spscalar=sc, npromatr=2, **kw)
    back = ett.dir_trans(res, scalars=g, npromatr=2, **kw)[2]
    assert calls == ["synthesis_bucketed"] * 2 + ["analysis_bucketed"] * 2
    g_rows = ett.inv_trans(res, spscalar=sc, npromatr=2, _fourier="rows", **kw)
    back_rows = ett.dir_trans(res, scalars=g_rows, npromatr=2,
                              _fourier="rows", **kw)[2]
    assert len(calls) == 4
    assert (g - g_rows).abs().max() <= 1e-12 * g.abs().max()
    assert (back - back_rows).abs().max() <= 1e-12 * back.abs().max()
    with pytest.raises(ValueError, match="Fourier layer"):
        ett.inv_trans(res, spscalar=sc, _fourier="chirp")
