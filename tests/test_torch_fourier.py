"""Fourier layer of ectrans_tpu_torch (torch.fft, batched by NLOEN) against
ectrans_tpu's bucketed chirp-z transforms and against a direct DFT: the
unnormalized synthesis, analysis divided by NLOEN, truncation at each row's
nmen, and exact zeros past each row's NLOEN."""

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
