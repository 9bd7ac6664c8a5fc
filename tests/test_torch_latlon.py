"""ectrans_tpu_torch's uniform-row Fourier layer, its folded Gaussian rows
(rows with 2 nmen >= NLOEN, ROADMAP C1) and the lat-lon output
(``latlon.py``) against ectrans_tpu on the same numpy inputs made from a
seed, on the CPU.  Tolerances: fp64 1e-12 relative to the field's largest
|value| (the uniform DFT also against direct sums), fp32 1e-5; the adjoint
identity 1e-10 (the JAX test's)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu import latlon as jlatlon
from ectrans_tpu.ops import fourier as jfourier
from ectrans_tpu.transform import InvFlags as JaxInvFlags

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import latlon
from ectrans_tpu_torch.grids import GridSpec
from ectrans_tpu_torch.ops import fourier
from ectrans_tpu_torch.resolution import resolution_from_arrays

from test_torch_transform import packed

ALL = dict(vorgp=True, divgp=True, scders=True, uvders=True)


def field_err(got, want) -> float:
    """Worst error over the fields (leading axis), relative to each field's
    largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).reshape(len(want), -1).max(1)
    return float((d / np.abs(want).reshape(len(want), -1).max(1)).max())


def direct_synthesis(re, im, L):
    """Re F_0 + 2 sum_k Re(F_k e^{2 pi i j k / L}) by explicit sums, the
    phase reduced exactly mod L."""
    k = np.arange(re.shape[-1])
    ph = 2 * np.pi * (np.outer(k, np.arange(L)) % L) / L
    w = np.where(k == 0, 1.0, 2.0)
    return (re * w) @ np.cos(ph) - (im * w * (k > 0)) @ np.sin(ph)


def direct_analysis(x, kmax):
    L = x.shape[-1]
    ph = 2 * np.pi * (np.outer(np.arange(kmax + 1), np.arange(L)) % L) / L
    return x @ np.cos(ph).T / L, -(x @ np.sin(ph).T) / L


@pytest.mark.parametrize("L", [36, 47, 48])
@pytest.mark.parametrize("kmax", [10, 17, 18, 24, 47, 80])
def test_uniform_dft_matches_jax_and_direct_sums(L, kmax):
    """Below the Nyquist bin (2 kmax < L), on it (kmax = L/2), above it and
    above L: synthesis and analysis against the JAX chirp-z and direct
    sums, fp64 and fp32."""
    rng = np.random.default_rng(L * 100 + kmax)
    re, im = rng.standard_normal((2, 3, 4, kmax + 1))
    x = rng.standard_normal((3, 4, L))
    ut = jfourier.uniform_dft_tables(L, kmax, "float64")
    want = direct_synthesis(re, im, L)
    got = fourier.synthesis_uniform(torch.from_numpy(re),
                                    torch.from_numpy(im), L).numpy()
    jgot = np.asarray(jax.jit(jfourier.synthesis_uniform)(
        jnp.asarray(re), jnp.asarray(im), ut))
    scale = np.abs(want).max()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * scale
    assert np.abs(got - jgot).max() <= 1e-12 * scale
    got32 = fourier.synthesis_uniform(torch.from_numpy(re).float(),
                                      torch.from_numpy(im).float(), L)
    assert got32.dtype == torch.float32
    assert np.abs(got32.numpy() - want).max() <= 1e-5 * scale

    wr, wi = direct_analysis(x, kmax)
    jr, ji = jax.jit(jfourier.analysis_uniform)(jnp.asarray(x), ut)
    for xx, tol in ((torch.from_numpy(x), 1e-12),
                    (torch.from_numpy(x).float(), 1e-5)):
        gr, gi = fourier.analysis_uniform(xx, kmax)
        assert gr.shape == (3, 4, kmax + 1)
        for g, w, j in ((gr, wr, jr), (gi, wi, ji)):
            s = np.abs(wr).max()
            assert np.abs(g.double().numpy() - w).max() <= tol * s
            assert np.abs(g.double().numpy() - np.asarray(j)).max() <= max(
                tol, 1e-12) * s


def test_fold_weights_nyquist_and_bin_zero_twice():
    """A mode on the Nyquist bin or folded onto bin 0 counts twice (2 Re),
    its imaginary part is dropped there, and a mode past L/2 lands on
    L - k conjugated."""
    L = 8
    for k, expect in ((4, lambda j: 2 * np.cos(np.pi * j)),
                      (8, lambda j: 2 * np.ones_like(j, dtype=float)),
                      (5, lambda j: 2 * np.cos(2 * np.pi * 5 * j / L)
                       - 2 * 0.5 * np.sin(2 * np.pi * 5 * j / L))):
        re = torch.zeros(k + 1, dtype=torch.float64)
        im = torch.zeros(k + 1, dtype=torch.float64)
        re[k] = 1.0
        im[k] = 0.5
        got = fourier.synthesis_uniform(re, im, L).numpy()
        want = expect(np.arange(L))
        assert np.abs(got - want).max() < 1e-13, (k, got, want)


def _custom_res(nloen, nmen, nsmax=47):
    """A Resolution on the F24 latitudes with the given rows and per-row
    truncation, and the duck-typed state JAX's bucketed tables read."""
    ref = ett.setup("F24", nsmax)
    grid = GridSpec("custom", nsmax, 48, tuple(int(x) for x in nloen),
                    reduced=len(set(nloen)) > 1)
    res = resolution_from_arrays(grid, ref.radius, ref.mu, ref.w,
                                 np.asarray(nmen), ref.ndglu, ref.eps)
    jres = SimpleNamespace(grid=SimpleNamespace(nloen=tuple(grid.nloen)),
                           nmen=np.asarray(nmen), nsmax=nsmax)
    return res, jres


def _gaussian_folded_cases():
    o48 = et.setup("O48", 47).grid.nloen
    sub = np.asarray(o48[:24] + o48[-24:])       # 20 .. 112 .. 20
    return {"nyquist": ((94,) * 48, np.full(48, 47)),
            "mixed": (tuple(sub), np.full(48, 47)),
            "partly": (tuple(sub), np.minimum(47, (sub - 1) // 2 + 6))}


@pytest.mark.parametrize("case", ["nyquist", "mixed", "partly"])
def test_gaussian_rows_with_2nmen_at_least_nloen(case):
    """C1: rows with 2 nmen >= NLOEN (on the Nyquist bin; folded from up to
    4.7 times the row's Nyquist, beside unfolded rows; with a per-row nmen)
    are synthesized and analysed with the literal wavenumber, as
    ectrans_tpu's bucketed chirp-z does (no longer refused); the other rows
    keep their per-NLOEN batches; the transposes satisfy the adjoint
    identity."""
    nloen, nmen = _gaussian_folded_cases()[case]
    res, jres = _custom_res(nloen, nmen)
    plan = fourier._plan(res, torch.device("cpu"))
    wide = 2 * np.asarray(nmen) >= np.asarray(nloen)
    assert sum(len(r) for _, r in plan["folded"]) == wide.sum() > 0
    assert sum(len(r) for _, r in plan["batches"]) == (~wide).sum()
    rng = np.random.default_rng(3)
    four = rng.standard_normal((3, 2, res.M, res.ndgl))
    jbt = jfourier.bucketed_tables_for(jres, jnp.float64)
    got = fourier.synthesis(torch.from_numpy(four), res).numpy()
    want = np.asarray(jfourier.synthesis_bucketed(jnp.asarray(four), jbt))
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-12 * scale
    for lat in np.nonzero(wide)[0][:4]:
        me, L = int(nmen[lat]), nloen[lat]
        d = direct_synthesis(four[:, 0, : me + 1, lat],
                             four[:, 1, : me + 1, lat], L)
        assert np.abs(got[:, lat, :L] - d).max() <= 1e-12 * scale
    grid = rng.standard_normal((2, res.ndgl, res.grid.ndlon))
    grid[:, np.arange(res.grid.ndlon)[None, :]
         >= np.asarray(nloen)[:, None]] = 0.0
    got_a = fourier.analysis(torch.from_numpy(grid), res).numpy()
    want_a = np.asarray(jfourier.analysis_bucketed(jnp.asarray(grid), jbt,
                                                   res.M))
    assert np.abs(got_a - want_a).max() <= 1e-12 * np.abs(want_a).max()
    # the adjoint identity of both directions through autograd
    x = torch.from_numpy(four).requires_grad_(True)
    y = torch.from_numpy(rng.standard_normal(got.shape))
    fx = fourier.synthesis(x, res)
    (fty,) = torch.autograd.grad(fx, x, y)
    fx = fx.detach()
    lhs, rhs = float((fx * y).sum()), float((fty * x.detach()).sum())
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)
    g = torch.from_numpy(grid).requires_grad_(True)
    z = torch.from_numpy(rng.standard_normal(got_a.shape))
    fg = fourier.analysis(g, res)
    (ftz,) = torch.autograd.grad(fg, g, z)
    fg = fg.detach()
    lhs, rhs = float((fg * z).sum()), float((ftz * g.detach()).sum())
    assert abs(lhs - rhs) < 1e-10 * abs(lhs)


@pytest.mark.parametrize("name", ["F24", "O48"])
@pytest.mark.parametrize("nlat", [18, 19, 37])
@pytest.mark.parametrize("poles", [True, False])
def test_inv_trans_latlon_matches_jax(name, nlat, poles):
    """T47 onto 36 longitudes (every row folds: 2 * 47 >= 36), even and
    odd nlat, with and without the poles, every flag: fp64 within 1e-12
    and fp32 within 1e-5 of JAX's fp64, relative to each field's max."""
    jres, res = et.setup(name, 47), ett.setup(name, 47)
    sp = [packed(res, n, seed) for n, seed in ((2, 0), (2, 1), (3, 2))]
    jll = jlatlon.LatLonGrid(nlat, 36, poles)
    ll = latlon.LatLonGrid(nlat, 36, poles)
    want = np.asarray(jlatlon.inv_trans_latlon(
        jres, jll, *[jnp.asarray(x) for x in sp], flags=JaxInvFlags(**ALL),
        dtype=jnp.float64))
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        got = latlon.inv_trans_latlon(
            res, ll, *[torch.from_numpy(x) for x in sp],
            flags=ett.InvFlags(**ALL), dtype=dtype)
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        assert field_err(got, want) <= tol


def test_latlon_tables_and_poles():
    """The lat-lon tables hold the JAX package's values (pole rows
    included: P_n^m(1) = 0 for m > 0), the derivatives vanish at the
    poles, and the tables are cached on the Resolution."""
    res = ett.setup("F24", 47)
    ll = latlon.LatLonGrid(19, 36)
    gl, racthe = latlon.latlon_tables(res, ll, torch.float64)
    assert latlon.latlon_tables(res, ll, torch.float64)[0] is gl
    jgl, _, jrac = jlatlon._latlon_tables(et.setup("F24", 47),
                                          jlatlon.LatLonGrid(19, 36),
                                          "float64")
    for g, jg in zip(gl.groups, jgl.groups):
        assert (g.m0, g.m1, g.i0, g.kg) == (jg.m0, jg.m1, jg.i0, jg.kg)
        assert np.array_equal(g.psym.numpy(), np.asarray(jg.psym))
        assert np.array_equal(g.pasym.numpy(), np.asarray(jg.pasym))
    assert np.array_equal(racthe.numpy(), np.asarray(jrac))
    assert float(gl.groups[0].psym[1:, 0].abs().max()) == 0.0
    sp = [packed(res, 1, s) for s in (4, 5, 6)]
    out = latlon.inv_trans_latlon(res, ll, *map(torch.from_numpy, sp),
                                  flags=ett.InvFlags(scders=True,
                                                     uvders=True),
                                  dtype=torch.float64)
    assert out.shape == (7, 19, 36)
    assert float(out[4:, [0, -1]].abs().max()) == 0.0
    res.drop_cached("latlon_tables")
    assert not any(k[0] == "latlon_tables" for k in res._cache)


def test_dir_trans_latlon_matches_jax():
    """The direct LDLL mode on the JAX test's 288 x 192 grid (no poles):
    fp64 within 1e-12 of JAX for u/v and scalars, and the spectra
    recovered to interpolation accuracy."""
    jres, res = et.setup("F24", 47), ett.setup("F24", 47)
    jll = jlatlon.LatLonGrid(288, 192, include_poles=False)
    ll = latlon.LatLonGrid(288, 192, include_poles=False)
    sp = [packed(res, n, seed) for n, seed in ((1, 7), (1, 8), (2, 9))]
    g = latlon.inv_trans_latlon(res, ll, *map(torch.from_numpy, sp),
                                dtype=torch.float64)
    u, v, sc = g[:1], g[1:2], g[2:]
    want = jlatlon.dir_trans_latlon(jres, jll, *[jnp.asarray(x.numpy())
                                                 for x in (u, v, sc)],
                                    dtype=jnp.float64)
    got = latlon.dir_trans_latlon(res, ll, u, v, sc, dtype=torch.float64)
    for a, b in zip(got, want):
        assert field_err(a, b) <= 1e-12
    assert np.abs(got[2].numpy() - sp[2]).max() < 1e-7
    W = latlon.latlon_interp_matrix(res, ll)
    jW = jlatlon._latlon_interp_matrix(jres, jll)
    assert np.abs(W - jW).max() <= 1e-12 * np.abs(jW).max()


def test_latlon_adjoint_identity_and_vjp_matches_jax():
    """inv_trans_latlon is linear: <F x, y> == <x, F^T y> by autograd
    within 1e-10 (the JAX test's), every flag, and its vector-Jacobian
    product equals JAX's."""
    jres, res = et.setup("F24", 47), ett.setup("F24", 47)
    ll, jll = latlon.LatLonGrid(19, 36), jlatlon.LatLonGrid(19, 36)
    rng = np.random.default_rng(4)
    sp = [packed(res, n, s) for n, s in ((1, 10), (1, 11), (2, 12))]
    xs = [torch.from_numpy(x).requires_grad_(True) for x in sp]
    fx = latlon.inv_trans_latlon(res, ll, *xs, flags=ett.InvFlags(**ALL),
                                 dtype=torch.float64)
    y = rng.standard_normal(tuple(fx.shape))
    fty = torch.autograd.grad(fx, xs, torch.from_numpy(y))
    lhs = float((fx.detach().numpy() * y).sum())
    rhs = sum(float((a.numpy() * b).sum()) for a, b in zip(fty, sp))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))

    def fwd(*s):
        return jlatlon.inv_trans_latlon(jres, jll, *s,
                                        flags=JaxInvFlags(**ALL),
                                        dtype=jnp.float64)

    _, vjp = jax.vjp(fwd, *[jnp.asarray(x) for x in sp])
    for a, b in zip(fty, vjp(jnp.asarray(y))):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()


def test_handle_latlon_methods_on_the_cpu():
    """SpectralTransform(device="cpu").inv_trans_latlon/dir_trans_latlon
    (numpy inputs, moved to the handle's device) equal the function API."""
    st = ett.SpectralTransform("F24", 47, dtype=torch.float64, device="cpu")
    res = st.res
    ll = ett.LatLonGrid(25, 48)
    sp = [packed(res, n, s) for n, s in ((1, 13), (1, 14), (2, 15))]
    flags = ett.InvFlags(scders=True, uvders=True)
    got = st.inv_trans_latlon(ll, *sp, flags=flags)
    want = ett.inv_trans_latlon(res, ll, *map(torch.from_numpy, sp),
                                flags=flags, dtype=torch.float64)
    assert got.device == st.device and torch.equal(got, want)
    fields = [got[:1].numpy(), got[1:2].numpy(), got[2:4].numpy()]
    back = st.dir_trans_latlon(ll, *fields)
    want = ett.dir_trans_latlon(res, ll, *map(torch.from_numpy, fields),
                                dtype=torch.float64)
    assert all(torch.equal(a, b) for a, b in zip(back, want))
    with pytest.raises(ValueError, match="nlat"):
        st.dir_trans_latlon(ll, scalars=np.zeros((1, 24, 48)))
