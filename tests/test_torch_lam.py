"""ectrans_tpu_torch.lam (the LAM bi-Fourier package on one device) against
ectrans_tpu.lam on the same numpy inputs made from a seed, on the CPU, at
the reference's ctest size 48 x 40 and at 64 x 48 with a C+I zone of
53 x 37.  Tolerances: fp64 1e-12 and fp32 1e-5 relative to each output's
largest |value|; the adjoint identity 1e-10 (the JAX test's)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ectrans_tpu import lam as jlam
from ectrans_tpu import latlon as jlatlon

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert, lam
from ectrans_tpu_torch.lam import LamInvFlags
from ectrans_tpu_torch.parallel import make_mesh
from torch_world import one_rank_world

SIZES = {"48x40": dict(nx=48, ny=40),
         "64x48": dict(nx=64, ny=48, nxux=53, nyux=37, dx=2.0, dy=3.0)}
ALL = dict(vorgp=True, divgp=True, scders=True, uvders=True)


def grids(size):
    """(JAX LamGrid and resolution, port resolution through convert.py)."""
    jg = jlam.make_lam_grid(**SIZES[size])
    jres = jlam.setup_lam(jg)
    d = {k: getattr(jg, k) for k in convert.LAM_GRID_FIELDS}
    d.update({k: np.asarray(getattr(jres, k)) for k in convert.LAM_MAPS})
    return jres, convert.lam_resolution_from_numpy(d)


def random_packed(res, nfld, seed):
    """tests/test_lam.py's physical-field mask: purely real modes where a
    conjugate pair degenerates."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((nfld, res.nspec2))
    pm, pn, pc = (np.asarray(a) for a in (res.packed_m, res.packed_n,
                                          res.packed_c))
    spec[:, ((pm == 0) & (pc >= 2)) | ((pn == 0) & (pc % 2 == 1))] = 0.0
    return spec


def rel(got, want) -> float:
    got = np.asarray(got.detach().double() if torch.is_tensor(got) else got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_ellips_and_geometry_match_jax():
    for nsmax, msmax in ((20, 30), (19, 23), (639, 767)):
        for a, b in zip(lam.ellips(nsmax, msmax),
                        jlam.ellips(nsmax, msmax)):
            assert np.array_equal(a, b)
    g = lam.make_lam_grid(1536, 1280, nxux=1440, nyux=1200, dx=1300.0,
                          dy=1300.0)
    jg = jlam.make_lam_grid(1536, 1280, nxux=1440, nyux=1200, dx=1300.0,
                            dy=1300.0)
    assert (g.msmax, g.nsmax, g.nspec2, g.exwn, g.eywn) == (
        jg.msmax, jg.nsmax, jg.nspec2, jg.exwn, jg.eywn) == (
        767, 639, jg.nspec2, jg.exwn, jg.eywn)
    with pytest.raises(ValueError, match="exceeds"):
        lam.make_lam_grid(32, 24, nxux=40)
    with pytest.raises(ValueError, match="unresolvable"):
        lam.make_lam_grid(32, 24, msmax=16)


@pytest.mark.parametrize("size", list(SIZES))
def test_packed_maps_cross_through_convert(size):
    jres, res = grids(size)
    for k in convert.LAM_MAPS + ("kntmp", "valid"):
        assert np.array_equal(getattr(res, k), np.asarray(getattr(jres, k)))
    d = {k: getattr(jres.grid, k) for k in convert.LAM_GRID_FIELDS}
    bad = np.asarray(jres.packed_n).copy()
    bad[[3, 7]] = bad[[7, 3]]
    with pytest.raises(ValueError, match="packed_n"):
        convert.lam_resolution_from_numpy(dict(d, packed_n=bad))
    # a lat-lon grid crosses as its three fields
    jll = jlatlon.LatLonGrid(19, 36, include_poles=False)
    ll = ett.LatLonGrid(jll.nlat, jll.nlon, jll.include_poles)
    assert np.array_equal(ll.mu, jll.mu)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("flags", [{}, ALL], ids=["none", "all"])
def test_inverse_and_direct_match_jax(size, flags):
    """inv_trans_lam with the mean wind and the flags, then dir_trans_lam
    of its u, v and scalars: fp64 within 1e-12, fp32 within 1e-5."""
    jres, res = grids(size)
    sp = [random_packed(res, n, s) for n, s in ((2, 1), (2, 2), (3, 3))]
    mean = [np.array([1.5, -0.5]), np.array([0.25, 2.0])]
    want = np.asarray(jlam.inv_trans_lam(
        jres, *[jnp.asarray(x) for x in sp + mean],
        flags=jlam.LamInvFlags(**flags), dtype=jnp.float64))
    o = 2 * (int(flags.get("vorgp", 0)) + int(flags.get("divgp", 0)))
    u, v, sc = (want[o: o + 2].copy(), want[o + 2: o + 4].copy(),
                want[o + 4: o + 7].copy())
    jout = jlam.dir_trans_lam(jres, *[jnp.asarray(x) for x in (u, v, sc)],
                              dtype=jnp.float64)
    for dtype, tol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        got = lam.inv_trans_lam(res, *map(torch.from_numpy, sp + mean),
                                flags=LamInvFlags(**flags), dtype=dtype)
        assert got.dtype == dtype and tuple(got.shape) == want.shape
        worst = max(rel(g, w) for g, w in zip(got, want))
        assert worst <= tol
        out = lam.dir_trans_lam(res, *map(torch.from_numpy, (u, v, sc)),
                                dtype=dtype)
        for a, b in zip(out, jout):
            assert a.dtype == dtype and rel(a, b) <= tol


def test_analytic_modes_and_derivatives():
    """One (m, n) coefficient of each component synthesizes the closed-form
    biperiodic wave (eprfi1b_mod.F90's component conventions), with its
    E-W and N-S derivatives (scders) and the mean wind at (0, 0)."""
    res = lam.setup_lam(lam.make_lam_grid(32, 24, dx=2.0, dy=3.0))
    g = res.grid
    m, n = 3, 2
    kx, ky = m * g.exwn, n * g.eywn
    x = np.arange(g.nx) * g.dx
    y = np.arange(g.ny) * g.dy
    cx, sx = np.cos(kx * x)[None], np.sin(kx * x)[None]
    cy, sy = np.cos(ky * y)[:, None], np.sin(ky * y)[:, None]
    spec = torch.zeros(4, res.nspec2, dtype=torch.float64)
    for c in range(4):
        spec[c, int(res.nesm0[m]) + 4 * n + c] = 1.0
    out = lam.inv_trans_lam(res, spscalar=spec,
                            flags=LamInvFlags(scders=True),
                            dtype=torch.float64).numpy()
    f = [4 * cy * cx, -4 * sy * cx, -4 * cy * sx, 4 * sy * sx]
    dfdy = [-4 * ky * sy * cx, -4 * ky * cy * cx, 4 * ky * sy * sx,
            4 * ky * cy * sx]
    dfdx = [-4 * kx * cy * sx, 4 * kx * sy * sx, -4 * kx * cy * cx,
            4 * kx * sy * cx]
    for c in range(4):
        assert np.abs(out[c] - f[c]).max() < 1e-12
        assert np.abs(out[4 + c] - dfdy[c]).max() < 1e-12 * ky
        assert np.abs(out[8 + c] - dfdx[c]).max() < 1e-12 * kx
    z = torch.zeros(1, res.nspec2, dtype=torch.float64)
    uv = lam.inv_trans_lam(res, z, z, meanu=torch.tensor([1.5]),
                           meanv=torch.tensor([-2.0]), dtype=torch.float64)
    assert torch.allclose(uv[0], torch.full_like(uv[0], 1.5), atol=1e-14)
    assert torch.allclose(uv[1], torch.full_like(uv[1], -2.0), atol=1e-14)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("mode", ["spline", "boyd", "zeros"])
def test_biperiodicize_matches_jax(size, mode):
    jres, res = grids(size)
    g = res.grid
    f = np.random.default_rng(6).standard_normal((2, g.nyux, g.nxux))
    want = np.asarray(jlam.biperiodicize(jnp.asarray(f), jres.grid,
                                         mode=mode))
    got = lam.biperiodicize(torch.from_numpy(f), g, mode=mode)
    assert tuple(got.shape) == want.shape == (2, g.ny, g.nx)
    assert np.abs(got.numpy() - want).max() <= 1e-12 * np.abs(want).max()
    got32 = lam.biperiodicize(torch.from_numpy(f).float(), g, mode=mode)
    assert got32.dtype == torch.float32
    assert np.abs(got32.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    if g.nxux < g.nx:       # without an E zone the field is returned as is
        with pytest.raises(ValueError, match="mode"):
            lam.biperiodicize(torch.from_numpy(f), g, mode="cubic")


def test_biperiodicize_boyd_wider_than_the_zone():
    """Boyd's periodic image repeats the C+I data when the extension zone
    is wider than it (as the JAX package tiles it)."""
    jg = jlam.make_lam_grid(64, 48, nxux=20, nyux=16)
    g = lam.make_lam_grid(64, 48, nxux=20, nyux=16)
    f = np.random.default_rng(7).standard_normal((1, 16, 20))
    want = np.asarray(jlam.biperiodicize(jnp.asarray(f), jg, mode="boyd"))
    got = lam.biperiodicize(torch.from_numpy(f), g, mode="boyd").numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("size", list(SIZES))
def test_norms_match_jax(size):
    jres, res = grids(size)
    spec = random_packed(res, 3, 8)
    met = np.random.default_rng(9).uniform(0.5, 2.0, (res.M, res.N))
    for m in (None, met):
        want = np.asarray(jlam.especnorm(jres, jnp.asarray(spec), m))
        got = lam.especnorm(res, torch.from_numpy(spec), m).numpy()
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    grid = np.array(jlam.inv_trans_lam(jres, spscalar=jnp.asarray(spec),
                                       dtype=jnp.float64))
    for full in (True, False):
        want = jlam.egpnorm(jres, jnp.asarray(grid), full_domain=full)
        got = lam.egpnorm(res, torch.from_numpy(grid), full_domain=full)
        for a, b in zip(got, want):
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12 * np.abs(
                np.asarray(b)).max()
    ave, lo, hi = lam.egpnorm(res, torch.from_numpy(grid), ave_only=True)
    assert lo is None and hi is None and ave.shape == (3,)


@pytest.mark.parametrize("size", list(SIZES))
def test_adjoints_match_jax_and_hold_the_identity(size):
    """Both adjoints (autograd) against JAX's linear transposes within
    1e-12, and <F x, y> == <x, F^T y> within 1e-10."""
    jres, res = grids(size)
    rng = np.random.default_rng(5)
    flags = dict(scders=True, uvders=True)
    nuv, nsc = 1, 2
    x = [random_packed(res, n, s) for n, s in ((nuv, 11), (nuv, 12),
                                               (nsc, 13))]
    x += [rng.standard_normal(nuv), rng.standard_normal(nuv)]
    fx = lam.inv_trans_lam(res, *map(torch.from_numpy, x),
                           flags=LamInvFlags(**flags),
                           dtype=torch.float64).numpy()
    y = rng.standard_normal(fx.shape)
    got = lam.inv_trans_lam_adj(res, torch.from_numpy(y), nuv, nsc,
                                flags=LamInvFlags(**flags),
                                dtype=torch.float64)
    want = jlam.inv_trans_lam_adj(jres, jnp.asarray(y), nuv, nsc,
                                  flags=jlam.LamInvFlags(**flags),
                                  dtype=jnp.float64)
    for a, b in zip(got, want):
        assert rel(a, b) <= 1e-12
    lhs = np.sum(fx * y)
    rhs = sum(np.sum(a.numpy() * b) for a, b in zip(got, x))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))

    g = res.grid
    xg = [rng.standard_normal((n, g.ny, g.nx)) for n in (nuv, nuv, nsc)]
    out = lam.dir_trans_lam(res, *map(torch.from_numpy, xg),
                            dtype=torch.float64)
    ys = [random_packed(res, n, s) for n, s in ((nuv, 21), (nuv, 22),
                                                (nsc, 23))]
    ys += [rng.standard_normal(nuv), rng.standard_normal(nuv)]
    got = lam.dir_trans_lam_adj(res, *map(torch.from_numpy, ys),
                                nfld_uv=nuv, nfld_sc=nsc,
                                dtype=torch.float64)
    want = jlam.dir_trans_lam_adj(jres, *map(jnp.asarray, ys),
                                  nfld_uv=nuv, nfld_sc=nsc,
                                  dtype=jnp.float64)
    for a, b in zip(got, want):
        assert rel(a, b) <= 1e-12
    lhs = sum(np.sum(a.numpy() * b) for a, b in zip(out, ys))
    rhs = sum(np.sum(a.numpy() * b) for a, b in zip(got, xg))
    assert abs(lhs - rhs) < 1e-10 * max(1.0, abs(lhs))
    # scalars only, the mean-wind cotangents absent
    got = lam.dir_trans_lam_adj(res, spscalar_ad=torch.from_numpy(ys[2]),
                                nfld_sc=nsc, dtype=torch.float64)
    assert got[0] is None and got[1] is None and got[2].shape == (
        nsc, g.ny, g.nx)
    with pytest.raises(ValueError, match="grid_ad"):
        lam.inv_trans_lam_adj(res, torch.from_numpy(y[:1]), nuv, nsc)


def test_handle_on_the_cpu():
    """LamTransform(device="cpu"): the transforms, adjoints, norms,
    biperiodicization, dist/gath and ETRANS_INQ against the function API
    and JAX's handle."""
    jres, res = grids("64x48")
    lt = ett.LamTransform(grid=res.grid, dtype=torch.float64, device="cpu")
    assert lt.res is res and lt.device == torch.device("cpu")
    jlt = jlam.LamTransform(grid=jres.grid, dtype=jnp.float64)
    sp = [random_packed(res, n, s) for n, s in ((1, 31), (1, 32), (2, 33))]
    mean = [np.array([0.5]), np.array([-1.0])]
    grid = lt.inv_trans(*sp, *mean, scders=True)
    want = lam.inv_trans_lam(res, *map(torch.from_numpy, sp + mean),
                             flags=LamInvFlags(scders=True),
                             dtype=torch.float64)
    assert torch.equal(grid, want)
    out = lt.dir_trans(grid[:1].numpy(), grid[1:2].numpy(), grid[2:4])
    assert all(torch.equal(a, b) for a, b in zip(
        out, lam.dir_trans_lam(res, grid[:1], grid[1:2], grid[2:4],
                               dtype=torch.float64)))
    ad = lt.inv_trans_adj(grid.numpy(), 1, 2, flags=LamInvFlags(scders=True))
    assert len(ad) == 5 and ad[0].shape == (1, res.nspec2)
    dad = lt.dir_trans_adj(*out, nfld_uv=1, nfld_sc=2)
    assert [a.shape for a in dad] == [(1, 48, 64), (1, 48, 64), (2, 48, 64)]
    f = np.random.default_rng(34).standard_normal((1, 37, 53))
    assert torch.equal(lt.biperiodicize(f), lam.biperiodicize(
        torch.from_numpy(f), res.grid))
    assert torch.equal(lt.specnorm(sp[2]),
                       lam.especnorm(res, torch.from_numpy(sp[2])))
    assert all(torch.equal(a, b) for a, b in zip(
        lt.gpnorm(grid, full_domain=False),
        lam.egpnorm(res, grid, full_domain=False)))
    d = lt.dist_grid(grid.numpy())
    assert isinstance(d, torch.Tensor) and torch.equal(d, grid)
    h = lt.gath_grid(grid)
    assert isinstance(h, np.ndarray) and np.array_equal(h, grid.numpy())
    inq, jinq = lt.inquire(), jlt.inquire()
    assert inq.keys() == jinq.keys()
    for k in inq:
        assert np.array_equal(np.asarray(inq[k]), np.asarray(jinq[k])), k
    lt2 = ett.LamTransform(48, 40, device="cpu")
    assert lt2.grid == lam.make_lam_grid(48, 40)
    assert lt2.inv_trans(spscalar=random_packed(lt2.res, 1, 35)).dtype == (
        torch.float32)


def test_handle_refusals(tmp_path):
    """mesh= takes a Mesh of parallel.make_mesh and refuses anything else
    (a one-rank mesh gives the handle's results); without a card the
    default handle refuses to start (no fallback to the CPU)."""
    with pytest.raises(TypeError, match="Mesh from make_mesh"):
        ett.LamTransform(48, 40, mesh=object(), device="cpu")
    lt = ett.LamTransform(48, 40, dtype=torch.float64, device="cpu")
    spec = random_packed(lt.res, 2, 36)
    want = lt.inv_trans(spscalar=spec)
    with one_rank_world(tmp_path):
        lm = ett.LamTransform(48, 40, mesh=make_mesh(device="cpu"),
                              dtype=torch.float64)
        got = lm.inv_trans(spscalar=lm.dist_spec(spec))
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * want.abs().max().item())
    if torch.cuda.is_available():
        assert ett.LamTransform(48, 40).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ett.LamTransform(48, 40)
    assert lam.ShardedLamTransform is lam.sharded.ShardedLamTransform
    res = lam.setup_lam(lam.make_lam_grid(48, 40))
    with pytest.raises(ValueError, match="together"):
        lam.inv_trans_lam(res, spvor=torch.zeros(1, res.nspec2))
    with pytest.raises(ValueError, match="nspec2"):
        lam.inv_trans_lam(res, spscalar=torch.zeros(1, 7))
    with pytest.raises(ValueError, match="ny=40"):
        lam.dir_trans_lam(res, scalars=torch.zeros(1, 39, 48))
