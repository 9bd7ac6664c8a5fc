"""Adjoints of ectrans_tpu_torch (inv_trans_adj, dir_trans_adj) against
ectrans_tpu's on the same cotangents and tables
(convert.resolution_from_numpy), and the reference's inner-product identity
<F x, y> = <x, F^T y> (tests/trans/test_adjoint.F90: 2000*eps; here within
2e-13 in fp64, as tests/test_adjoint.py holds the JAX package, and 2000*eps
in fp32, with the inner products formed in fp64).  The fp32 identity is
also held with the forward on the default "dense" engine (its plain
versions on the CPU), the pairing a 4D-Var user runs.  Outputs against JAX:
fp64 1e-10 relative to the max, fp32 2e-5 absolute plus 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.adjoint import dir_trans_adj as jax_dir_trans_adj
from ectrans_tpu.adjoint import inv_trans_adj as jax_inv_trans_adj
from ectrans_tpu.transform import InvFlags as JaxInvFlags

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert
from ectrans_tpu_torch.ops import (legendre_dense, legendre_grouped,
                                   legendre_planes, legendre_tablegen, pack)

from test_torch_setup import numpy_state
from test_torch_transform import JDT, assert_close

BENCH = dict(scders=True, uvders=True)
EPS32 = float(np.finfo(np.float32).eps)
IDENTITY_TOL = {torch.float64: 2e-13, torch.float32: 2000 * EPS32}


@pytest.fixture(scope="module", params=["F24", "O48"])
def pair(request):
    jres = et.setup(request.param, 47)
    return jres, convert.resolution_from_numpy(numpy_state(jres))


def rand_spec(res, n, rng):
    """Random spectra with the m = 0 imaginary parts zero (as the
    reference's test)."""
    x = rng.standard_normal((n, res.nspec2))
    x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0
    return x


def dot(a, b) -> float:
    """Inner product in fp64 of tensors or arrays (lists of them)."""
    if isinstance(a, (list, tuple)):
        return sum(dot(x, y) for x, y in zip(a, b))
    a = torch.as_tensor(a).double()
    b = torch.as_tensor(b).double()
    return float((a * b).sum())


def inv_identity(res, dtype, engine="xla", nuv=2, nsc=3, seed=0):
    """|<F x, y> - <x, F^T y>| / |<F x, y>| for inv_trans."""
    rng = np.random.default_rng(seed)
    x = [torch.from_numpy(rand_spec(res, n, rng)).to(dtype)
         for n in (nuv, nuv, nsc)]
    flags = ett.InvFlags(**BENCH)
    fx = ett.inv_trans(res, *x, flags=flags, dtype=dtype, _engine=engine)
    y = torch.from_numpy(rng.standard_normal(tuple(fx.shape))).to(dtype)
    ad = ett.inv_trans_adj(res, y, nuv, nsc, flags=flags, dtype=dtype)
    lhs, rhs = dot(fx, y), dot(x, ad)
    return abs(lhs - rhs) / abs(lhs)


def dir_identity(res, dtype, engine="xla", nuv=2, nsc=2, seed=1):
    """|<F x, y> - <x, F^T y>| / |<F x, y>| for dir_trans."""
    rng = np.random.default_rng(seed)
    shape = (res.ndgl, res.grid.ndlon)
    x = [torch.from_numpy(rng.standard_normal((n,) + shape)).to(dtype)
         for n in (nuv, nuv, nsc)]
    fx = ett.dir_trans(res, *x, dtype=dtype, _engine=engine)
    y = [torch.from_numpy(rand_spec(res, n, rng)).to(dtype)
         for n in (nuv, nuv, nsc)]
    ad = ett.dir_trans_adj(res, *y, nfld_uv=nuv, nfld_sc=nsc, dtype=dtype)
    lhs, rhs = dot(fx, y), dot(x, ad)
    return abs(lhs - rhs) / abs(lhs)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_inv_trans_adjoint_identity(pair, dtype):
    _, res = pair
    assert inv_identity(res, dtype) < IDENTITY_TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dir_trans_adjoint_identity(pair, dtype):
    _, res = pair
    assert dir_identity(res, dtype) < IDENTITY_TOL[dtype]


def test_adjoint_identity_with_dense_forward(pair):
    """The fp32 identity with the forward on the default "dense" engine and
    the adjoint on "xla"."""
    _, res = pair
    assert inv_identity(res, torch.float32, "dense") < 2000 * EPS32
    assert dir_identity(res, torch.float32, "dense") < 2000 * EPS32


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_inv_trans_adj_matches_jax(pair, dtype):
    jres, res = pair
    rng = np.random.default_rng(3)
    nout = ett.num_inv_output_fields(2, 3, ett.InvFlags(**BENCH))
    y = rng.standard_normal((nout, res.ndgl, res.grid.ndlon))
    want = jax_inv_trans_adj(jres, jnp.asarray(y, JDT[dtype]), 2, 3,
                             flags=JaxInvFlags(**BENCH), dtype=JDT[dtype])
    got = ett.inv_trans_adj(res, torch.from_numpy(y), 2, 3,
                            flags=ett.InvFlags(**BENCH), dtype=dtype)
    for a, b in zip(got, want):
        assert a.dtype == dtype and a.shape == (b.shape[0], res.nspec2)
        assert_close(a.numpy(), np.asarray(b), dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_dir_trans_adj_matches_jax(pair, dtype):
    jres, res = pair
    rng = np.random.default_rng(4)
    y = [rand_spec(res, n, rng) for n in (2, 2, 3)]
    want = jax_dir_trans_adj(jres, *[jnp.asarray(x, JDT[dtype]) for x in y],
                             nfld_uv=2, nfld_sc=3, dtype=JDT[dtype])
    got = ett.dir_trans_adj(res, *[torch.from_numpy(x) for x in y],
                            nfld_uv=2, nfld_sc=3, dtype=dtype)
    for a, b in zip(got, want):
        assert a.dtype == dtype
        assert_close(a.numpy(), np.asarray(b), dtype)


@pytest.mark.parametrize("nuv,nsc,flags", [
    (1, 0, dict(vorgp=True, divgp=True)),
    (0, 2, dict(scders=True)),
    (2, 1, dict()),
])
def test_inv_trans_adj_flag_families_match_jax(nuv, nsc, flags):
    """Every PGP group of the inverse output and absent families (None)."""
    jres = et.setup("O48", 47)
    res = convert.resolution_from_numpy(numpy_state(jres))
    nout = ett.num_inv_output_fields(nuv, nsc, ett.InvFlags(**flags))
    y = np.random.default_rng(5).standard_normal(
        (nout, res.ndgl, res.grid.ndlon))
    want = jax_inv_trans_adj(jres, jnp.asarray(y), nuv, nsc,
                             flags=JaxInvFlags(**flags), dtype=jnp.float64)
    got = ett.inv_trans_adj(res, torch.from_numpy(y), nuv, nsc,
                            flags=ett.InvFlags(**flags), dtype=torch.float64)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert_close(a.numpy(), np.asarray(b), torch.float64)


def test_adjoint_roundtrip_gradient():
    """grad of 0.5*||inv_trans(s)||^2 equals inv_trans_adj(inv_trans(s))
    (tests/test_adjoint.py), and matches the JAX package's gradient."""
    jres = et.setup("F24", 31)
    res = convert.resolution_from_numpy(numpy_state(jres))
    sc = rand_spec(res, 1, np.random.default_rng(2))
    s = torch.from_numpy(sc).requires_grad_(True)
    g = ett.inv_trans(res, spscalar=s, dtype=torch.float64, _engine="xla")
    (grad,) = torch.autograd.grad(0.5 * (g * g).sum(), s)
    _, _, expect = ett.inv_trans_adj(res, g.detach(), 0, 1,
                                     dtype=torch.float64)
    assert (grad - expect).abs().max() < 1e-10

    def loss(x):
        gj = et.inv_trans(jres, spscalar=x, dtype=jnp.float64)
        return 0.5 * jnp.sum(gj * gj)

    jgrad = np.asarray(jax.grad(loss)(jnp.asarray(sc)))
    assert_close(grad.numpy(), jgrad, torch.float64)


def test_adjoints_never_call_a_kernel(monkeypatch):
    """The adjoints run on the "xla" engine: no kernel wrapper is called
    (each is made to raise here)."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper was called")

    for mod, names in ((legendre_dense, ("group_inv_dense", "group_dir_dense",
                                         "group_inv_dense2",
                                         "group_dir_dense2")),
                       (legendre_grouped, ("group_inv", "group_dir")),
                       (legendre_planes, ("group_inv_planes",
                                          "group_dir_planes")),
                       (legendre_tablegen, ("gen_groups", "gen_group")),
                       (pack, ("packed_from_group_rows",))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    res = ett.setup("O48", 47)
    rng = np.random.default_rng(6)
    y = torch.from_numpy(rng.standard_normal((3, res.ndgl, res.grid.ndlon)))
    vor, div, sc = ett.inv_trans_adj(res, y, 1, 1)
    assert vor.shape == div.shape == sc.shape == (1, res.nspec2)
    u, v, s = ett.dir_trans_adj(res, vor, div, sc, nfld_uv=1, nfld_sc=1)
    assert u.shape == v.shape == s.shape == (1, res.ndgl, res.grid.ndlon)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        ett.inv_trans(res, spscalar=sc)


def test_adjoint_cotangents_of_ignored_inputs_are_zero():
    """As jax.linear_transpose gives them: the m = 0 imaginary parts of the
    spectral cotangent, and grid points past each row's NLOEN."""
    res = ett.setup("O48", 47)
    rng = np.random.default_rng(7)
    y = torch.from_numpy(rng.standard_normal((1, res.ndgl, res.grid.ndlon)))
    _, _, sc = ett.inv_trans_adj(res, y, 0, 1, dtype=torch.float64)
    assert torch.all(sc[:, 1 : 2 * (res.nsmax + 1) : 2] == 0)
    spec = torch.from_numpy(rng.standard_normal((1, res.nspec2)))
    _, _, g = ett.dir_trans_adj(res, None, None, spec, nfld_sc=1,
                                dtype=torch.float64)
    past = (torch.arange(res.grid.ndlon)[None, :]
            >= torch.as_tensor(res.grid.nloen)[:, None])
    assert past.any() and torch.all(g[0][past] == 0)


def test_adjoint_rejects_bad_arguments():
    res = ett.setup("O48", 47)
    with pytest.raises(ValueError, match="grid_ad"):
        ett.inv_trans_adj(res, torch.zeros(2, res.ndgl, res.grid.ndlon),
                          1, 1)
    with pytest.raises(ValueError, match="spscalar_ad"):
        ett.dir_trans_adj(res, None, None, torch.zeros(2, res.nspec2),
                          nfld_sc=1)
    with pytest.raises(ValueError, match="nothing"):
        ett.dir_trans_adj(res)


def test_layer_transposes():
    """The transposes written out for autograd: the Fourier layer's (each
    direction's, the other one scaled) and packed_to_dense's (a scatter),
    checked by the inner-product identity in fp64, against dense_to_packed,
    and against autograd through the plain torch.fft calls."""
    from ectrans_tpu_torch.ops import fourier, layout

    res = ett.setup("O48", 47)
    rng = np.random.default_rng(8)
    four = torch.from_numpy(rng.standard_normal((2, 2, res.M, res.ndgl)))
    grid = torch.from_numpy(rng.standard_normal((2, res.ndgl,
                                                 res.grid.ndlon)))
    for fwd, x, y in ((fourier.synthesis, four, grid),
                      (fourier.analysis, grid, four)):
        x = x.clone().requires_grad_(True)
        (xt,) = torch.autograd.grad(fwd(x, res), x, y)
        lhs, rhs = dot(fwd(x.detach(), res), y), dot(x.detach(), xt)
        assert abs(lhs - rhs) <= 1e-13 * abs(lhs)
    # the synthesis transpose against autograd through torch.fft itself
    x = four.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(fourier._synthesis(x, res), x, grid)
    (got,) = torch.autograd.grad(fourier.synthesis(x, res), x, grid)
    assert (got - want).abs().max() <= 1e-12 * want.abs().max()
    spec = torch.from_numpy(rng.standard_normal((3, res.nspec2)))
    spec.requires_grad_(True)
    tables = res.device_tables(torch.float64)
    dense = layout.packed_to_dense(spec, tables)
    g = torch.from_numpy(rng.standard_normal(tuple(dense.shape)))
    (st,) = torch.autograd.grad(dense, spec, g)
    assert torch.equal(st, layout.dense_to_packed(g, res))


@pytest.mark.parametrize("nb", ["12", "3"])
def test_bucketed_layer_transposes(nb, monkeypatch):
    """The chirp-z layer with normalize=False, transposed by autograd
    through torch.fft, complex products and slices: the inner-product
    identity in fp64, no NaN, and zero cotangents on the inputs it
    ignores."""
    from ectrans_tpu_torch.ops import fourier

    monkeypatch.setenv("ECTRANS_TPU_FFT_BUCKETS", nb)
    res = ett.setup("O48", 47)
    bt = fourier.bucketed_tables(res, "cpu")
    rng = np.random.default_rng(9)
    four = torch.from_numpy(rng.standard_normal((3, 2, res.M, res.ndgl)))
    grid = torch.from_numpy(rng.standard_normal((3, res.ndgl,
                                                 res.grid.ndlon)))
    syn = lambda x: fourier.synthesis_bucketed(x, bt, normalize=False)
    ana = lambda x: fourier.analysis_bucketed(x, bt, res.M, normalize=False)
    for fwd, x, y in ((syn, four, grid), (ana, grid, four)):
        x = x.clone().requires_grad_(True)
        (xt,) = torch.autograd.grad(fwd(x), x, y)
        assert torch.isfinite(xt).all()
        lhs, rhs = dot(fwd(x.detach()), y), dot(x.detach(), xt)
        assert abs(lhs - rhs) <= 1e-13 * abs(lhs)
        if fwd is syn:
            assert torch.all(xt[:, ~bt.keep] == 0)
        else:
            past = ~torch.from_numpy(np.arange(res.grid.ndlon)[None, :]
                                     < np.asarray(res.grid.nloen)[:, None])
            assert torch.all(xt[:, past] == 0)
