"""ectrans_tpu_torch.compat4py (the ectrans4py surface) against
ectrans_tpu.compat4py on the same numpy inputs made from a seed, on the
CPU: every function at 1e-12 of each output's largest |value| (fp64), on a
reduced O32 and a full F16 KLOEN at T31 with LGRADIENT and LREORDER in all
four combinations, the LAM pair on a 48 x 40 domain, get_legendre_assets
with KSPOLEGL cutting a column block, the reorderings exactly, the device
check and trans_end."""

import numpy as np
import pytest
import torch

from ectrans_tpu import compat4py as jc

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import compat4py as pc
from ectrans_tpu_torch.lam import make_lam_grid, setup_lam

TOL = 1e-12
KTRUNC = 31
GRIDS = ["O32", "F16"]
# (KSIZEI, KSIZEJ, KPHYSICALSIZEI, KPHYSICALSIZEJ, KTRUNCX, KTRUNCY)
LAM = (48, 40, 43, 37, 23, 19)
DX = (1300.0, 1300.0)
CPU = dict(device="cpu")


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got - want).max() <= tol * scale


def kloen(name):
    return np.asarray(ett.make_grid(name, KTRUNC).nloen)


def fa_size(ktrunc):
    """FA blocks of 2n + 1 values, n = 0 .. ktrunc."""
    return (ktrunc + 1) ** 2


def spectrum(n, seed, m0_imag=None):
    x = np.random.default_rng(seed).standard_normal(n)
    if m0_imag is not None:
        x[1: m0_imag: 2] = 0.0
    return x


def test_version_names_the_package():
    assert pc.ectrans_version() == f"ectrans_tpu_torch {ett.__version__}"
    assert jc.ectrans_version().startswith("ectrans_tpu ")


@pytest.mark.parametrize("grid", GRIDS)
def test_trans_inq4py(grid):
    nl = kloen(grid)
    got = pc.trans_inq4py(len(nl), KTRUNC, len(nl) + 4, nl)
    want = jc.trans_inq4py(len(nl), KTRUNC, len(nl) + 4, nl)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2], want[2])


def test_etrans_inq4py():
    assert pc.etrans_inq4py(*LAM, 10, *DX) == jc.etrans_inq4py(*LAM, 10, *DX)


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("gradient", [False, True])
@pytest.mark.parametrize("grid", GRIDS)
def test_gauss_pair_matches_jax(grid, gradient, reorder):
    nl = kloen(grid)
    ks = len(nl)
    ngptot, nspec, _ = pc.trans_inq4py(ks, KTRUNC, ks, nl)
    nspec2 = 2 * nspec
    if reorder:
        ksize = fa_size(KTRUNC)
        sp = spectrum(ksize, 1)
    else:
        ksize = nspec2
        sp = spectrum(ksize, 1, m0_imag=2 * (KTRUNC + 1))
    args = (ks, KTRUNC, 10, ngptot, ks, nl, ksize, gradient, reorder, sp)
    got = pc.sp2gp_gauss4py(*args, **CPU)
    want = jc.sp2gp_gauss4py(*args)
    for g, w in zip(got, want):
        assert g.shape == (ngptot,)
        close(g, w)
    back_args = (ksize, ks, KTRUNC, 10, ks, nl, ngptot, reorder, want[0])
    close(pc.gp2sp_gauss4py(*back_args, **CPU), jc.gp2sp_gauss4py(*back_args))


@pytest.mark.parametrize("reorder", [False, True])
@pytest.mark.parametrize("gradient", [False, True])
def test_lam_pair_matches_jax(gradient, reorder):
    ngptot, nspec2 = pc.etrans_inq4py(*LAM, 10, *DX)
    sp = spectrum(nspec2, 2)
    args = LAM + (10, nspec2, gradient, reorder) + DX + (sp,)
    got = pc.sp2gp_lam4py(*args, **CPU)
    want = jc.sp2gp_lam4py(*args)
    for g, w in zip(got, want):
        assert g.shape == (ngptot,)
        close(g, w)
    back_args = (nspec2,) + LAM + (10,) + DX + (reorder, want[0])
    close(pc.gp2sp_lam4py(*back_args, **CPU), jc.gp2sp_lam4py(*back_args))


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("cut", [0, 1, 2])
def test_get_legendre_assets(grid, cut):
    """cut 0: every column; 1: KSPOLEGL ends inside an m block; 2: inside
    the first block (m = 0)."""
    nl = kloen(grid)
    ks = len(nl)
    ncol = (KTRUNC + 2) * (KTRUNC + 3) // 2 - 1     # n = m .. KTRUNC + 1
    kspolegl = {0: ncol, 1: ncol // 3 + 5, 2: 7}[cut]
    got = pc.get_legendre_assets(ks, KTRUNC, ks, kspolegl, nl)
    want = jc.get_legendre_assets(ks, KTRUNC, ks, kspolegl, nl)
    np.testing.assert_array_equal(got[0], want[0])
    close(got[1], want[1])
    assert got[2].shape == (ks // 2, kspolegl)
    close(got[2], want[2])


def test_fft1d_matches_jax_and_closed_form():
    ktrunc, L = 5, 32
    spec = spectrum(2 * (ktrunc + 1), 3)
    got = pc.sp2gp_fft1d4py(len(spec), ktrunc, spec, L, **CPU)
    close(got, jc.sp2gp_fft1d4py(len(spec), ktrunc, spec, L))
    x = 2 * np.pi * np.arange(L) / L
    k = np.arange(1, ktrunc + 1)[:, None]
    want = spec[0] + 2 * (spec[2::2, None] * np.cos(k * x)
                          - spec[3::2, None] * np.sin(k * x)).sum(0)
    close(got, want)


def test_reorderings_are_jax_and_round_trip_exactly():
    ktrunc = 13
    nspec2 = (ktrunc + 1) * (ktrunc + 2)
    model = spectrum(nspec2, 4, m0_imag=2 * (ktrunc + 1))
    fa = pc._reorder_model_to_fa(model, ktrunc, fa_size(ktrunc))
    np.testing.assert_array_equal(
        fa, jc._reorder_model_to_fa(model, ktrunc, fa_size(ktrunc)))
    np.testing.assert_array_equal(pc._reorder_fa_to_model(fa, ktrunc, nspec2),
                                  model)

    from ectrans_tpu.lam import make_lam_grid as jgrid
    from ectrans_tpu.lam import setup_lam as jsetup

    kw = dict(msmax=10, nsmax=8)
    res, jres = setup_lam(make_lam_grid(32, 24, **kw)), jsetup(jgrid(32, 24,
                                                                     **kw))
    model = spectrum(res.nspec2, 5)
    fa = pc._lam_reorder_model_to_fa(model, res, res.nspec2)
    np.testing.assert_array_equal(
        fa, jc._lam_reorder_model_to_fa(model, jres, jres.nspec2))
    np.testing.assert_array_equal(pc._lam_reorder_fa_to_model(fa, res), model)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_reduced_packing_matches_jax(as_tensor):
    grid = ett.make_grid("O32", KTRUNC)
    rows = np.random.default_rng(6).standard_normal((3, grid.ndgl, grid.ndlon))
    want = [jc._pack_reduced(r, grid.nloen) for r in rows]
    x = torch.from_numpy(rows) if as_tensor else rows
    flat = pc._pack_reduced(x, grid.nloen)
    assert isinstance(flat, torch.Tensor) == as_tensor
    np.testing.assert_array_equal(np.asarray(flat), np.stack(want))
    back = np.asarray(pc._unpack_reduced(flat, grid.nloen, grid.ndlon))
    np.testing.assert_array_equal(
        back, np.stack([jc._unpack_reduced(w, grid.nloen, grid.ndlon)
                        for w in want]))


def _calls():
    nl = kloen("O32")
    ks, ng = len(nl), int(nl.sum())
    sp = np.zeros((KTRUNC + 1) * (KTRUNC + 2))
    lam_ng, lam_ns = pc.etrans_inq4py(*LAM, 10, *DX)
    return {
        "sp2gp_gauss4py": lambda **kw: pc.sp2gp_gauss4py(
            ks, KTRUNC, 10, ng, ks, nl, len(sp), False, False, sp, **kw),
        "gp2sp_gauss4py": lambda **kw: pc.gp2sp_gauss4py(
            len(sp), ks, KTRUNC, 10, ks, nl, ng, False, np.zeros(ng), **kw),
        "sp2gp_lam4py": lambda **kw: pc.sp2gp_lam4py(
            *LAM, 10, lam_ns, False, False, *DX, np.zeros(lam_ns), **kw),
        "gp2sp_lam4py": lambda **kw: pc.gp2sp_lam4py(
            lam_ns, *LAM, 10, *DX, False, np.zeros(lam_ng), **kw),
        "sp2gp_fft1d4py": lambda **kw: pc.sp2gp_fft1d4py(
            4, 1, np.zeros(4), 8, **kw),
    }


@pytest.mark.parametrize("name", sorted(_calls()))
def test_cuda_without_a_card_raises(name, monkeypatch):
    """The default device is the card; without one every transforming
    function raises and none runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _calls()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
    call(device="cpu")


def test_trans_end_empties_the_lam_resolutions():
    pc.etrans_inq4py(*LAM, 10, *DX)
    ng, ns = pc.etrans_inq4py(*LAM, 10, *DX)
    pc.sp2gp_lam4py(*LAM, 10, ns, False, False, *DX, np.zeros(ns), **CPU)
    nl = kloen("O32")
    pc._pack_reduced(np.zeros((len(nl), max(nl))), nl)
    assert pc._lam_res.cache_info().currsize >= 1
    assert pc._reduced_index.cache_info().currsize >= 1
    ett.trans_end()
    assert pc._lam_res.cache_info().currsize == 0
    assert pc._reduced_index.cache_info().currsize == 0
