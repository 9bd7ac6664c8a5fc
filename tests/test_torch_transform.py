"""The whole ectrans_tpu_torch slice (inv_trans -> dir_trans) and its
spectral operators against ectrans_tpu on the same inputs and tables
(convert.resolution_from_numpy).  Tolerances: fp64 1e-10 relative to each
output's max; fp32 2e-5 absolute plus 1e-5 relative to the output's max
(the rounding of two fp32 implementations that sum in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.ops import spectral as jspectral
from ectrans_tpu.transform import InvFlags as JaxInvFlags

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert
from ectrans_tpu_torch.ops import layout, spectral

from test_torch_setup import numpy_state

TOL = {torch.float64: (0.0, 1e-10), torch.float32: (2e-5, 1e-5)}
JDT = {torch.float64: jnp.float64, torch.float32: jnp.float32}
BENCH = dict(scders=True, uvders=True)


@pytest.fixture(scope="module", params=["O48", "T47"])
def pair(request):
    jres = et.setup(request.param)
    return jres, convert.resolution_from_numpy(numpy_state(jres))


def packed(res, n, seed):
    """bench.py-style spectra: m = 0 imaginary parts and the mean zero."""
    x = np.random.default_rng(seed).standard_normal((n, res.nspec2))
    x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0
    x[:, 0] = 0.0
    return x


def assert_close(got, want, dtype):
    atol, rtol = TOL[dtype]
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= atol + rtol * np.abs(want).max(), err


def _jax_round_trip(jres, sp, flags, dtype, nuv, nsc):
    jdt = JDT[dtype]
    args = [None if x is None else jnp.asarray(x, jdt) for x in sp]
    grid = et.inv_trans(jres, *args, flags=JaxInvFlags(**flags), dtype=jdt)
    g = np.asarray(grid)
    uv = (jnp.asarray(g[:nuv]), jnp.asarray(g[nuv : 2 * nuv])) if nuv \
        else (None, None)
    sc = jnp.asarray(g[2 * nuv : 2 * nuv + nsc]) if nsc else None
    return g, et.dir_trans(jres, *uv, sc, dtype=jdt)


def _port_round_trip(res, sp, flags, dtype, nuv, nsc, device="cpu"):
    args = [None if x is None else torch.as_tensor(x, device=device)
            for x in sp]
    grid = ett.inv_trans(res, *args, flags=ett.InvFlags(**flags), dtype=dtype)
    uv = (grid[:nuv], grid[nuv : 2 * nuv]) if nuv else (None, None)
    sc = grid[2 * nuv : 2 * nuv + nsc] if nsc else None
    return grid, ett.dir_trans(res, *uv, sc, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bench_slice_matches_jax(pair, dtype):
    """bench.py's round trip (2 vor/div pairs, 6 scalars, scders+uvders;
    26 grid fields; then dir_trans of u, v, scalars) vs the JAX package."""
    jres, res = pair
    sp = [packed(res, n, seed) for n, seed in ((2, 0), (2, 1), (6, 2))]
    gj, outj = _jax_round_trip(jres, sp, BENCH, dtype, 2, 6)
    gp, outp = _port_round_trip(res, sp, BENCH, dtype, 2, 6)
    assert gp.dtype == dtype and tuple(gp.shape) == (26, res.ndgl,
                                                     res.grid.ndlon)
    assert_close(gp.numpy(), gj, dtype)
    for a, b in zip(outp, outj):
        assert a.dtype == dtype
        assert_close(a.numpy(), b, dtype)


@pytest.mark.parametrize("flags,nuv,nsc", [
    (dict(vorgp=True, divgp=True), 1, 0),
    (dict(), 0, 3),
    (dict(scders=True), 0, 2),
    (dict(vorgp=True, uvders=True), 2, 1),
])
def test_flag_families_match_jax(flags, nuv, nsc):
    jres = et.setup("O48", 47)
    res = convert.resolution_from_numpy(numpy_state(jres))
    sp = [packed(res, nuv, 3) if nuv else None,
          packed(res, nuv, 4) if nuv else None,
          packed(res, nsc, 5) if nsc else None]
    gj, outj = _jax_round_trip(jres, sp, flags, torch.float64, nuv, nsc)
    gp, outp = _port_round_trip(res, sp, flags, torch.float64, nuv, nsc)
    assert gp.shape[0] == ett.num_inv_output_fields(
        nuv, nsc, ett.InvFlags(**flags))
    assert_close(gp.numpy(), gj, torch.float64)
    for a, b in zip(outp, outj):
        assert (a is None) == (b is None)
        if a is not None:
            assert_close(a.numpy(), b, torch.float64)


def test_fspgl_hook_matches_jax():
    jres = et.setup("T47")
    res = convert.resolution_from_numpy(numpy_state(jres))
    sc = packed(res, 2, 6)
    jgrid = et.inv_trans(jres, spscalar=jnp.asarray(sc), dtype=jnp.float64,
                         fspgl_proc=lambda f: f * 2.0 + 1.0)
    grid = ett.inv_trans(res, spscalar=torch.from_numpy(sc),
                         dtype=torch.float64,
                         fspgl_proc=lambda f: f * 2.0 + 1.0)
    assert_close(grid.numpy(), np.asarray(jgrid), torch.float64)


def test_round_trip_gate_fp32():
    """The bench's 100*eps relative round-trip gate on every family, T47."""
    res = ett.setup("T47")
    sp = [packed(res, n, seed).astype(np.float32)
          for n, seed in ((2, 7), (2, 8), (6, 9))]
    _, out = _port_round_trip(res, sp, BENCH, torch.float32, 2, 6)
    eps = float(np.finfo(np.float32).eps)
    for i, (got, ref) in enumerate(zip(out, sp)):
        d = np.abs(got.numpy() - ref)
        if i < 2:
            d[:, :2] = 0.0     # (m=0, n=0) of vor/div carries no wind
        assert d.max() <= 100 * eps * np.abs(ref).max(), (i, d.max())


def test_spectral_operators_match_jax(pair):
    jres, res = pair
    rng = np.random.default_rng(11)
    valid = np.asarray(jres.device_tables(jnp.float64).dense_valid)
    vor, div = (rng.standard_normal((2, 2, res.M, res.NP)) * valid
                for _ in range(2))
    jct = {k: jnp.asarray(v) for k, v in
           jspectral.vordiv_coeff_tables(jres, np.float64).items()}
    t = res.device_tables(torch.float64)
    for a, b in zip(spectral.vordiv_to_uv(torch.from_numpy(vor),
                                          torch.from_numpy(div), t.vd),
                    jspectral.vordiv_to_uv(jnp.asarray(vor), jnp.asarray(div),
                                           jct)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14 * np.abs(np.asarray(b)).max())
    jnsd = {k: jnp.asarray(v) for k, v in
            jspectral.nsder_coeff_tables(jres, np.float64).items()}
    np.testing.assert_allclose(
        spectral.ns_derivative(torch.from_numpy(vor), t.nsd).numpy(),
        np.asarray(jspectral.ns_derivative(jnp.asarray(vor), jnsd)),
        rtol=1e-14, atol=1e-14)
    jmm = {k: jnp.asarray(v) for k, v in
           jspectral.uvtvd_coeff_tables_mmajor(jres, np.float64).items()}
    for m0, m1, _, J in res.legendre_groups():
        rows = rng.standard_normal((m1 - m0, 10, J))
        np.testing.assert_allclose(
            spectral.uv_to_vordiv_rows(torch.from_numpy(rows), m0, 2, 5,
                                       t.uvtvd_mm).numpy(),
            np.asarray(jspectral.uv_to_vordiv_rows(jnp.asarray(rows), m0, 2,
                                                   5, jmm)),
            rtol=1e-14, atol=1e-14)


def test_options_not_ported_raise():
    """npromatr packets are not ported and bf16 is no working dtype; the
    tiers "high" and "bf16" run on the default "dense" engine."""
    res = ett.setup("T47")
    sc = torch.from_numpy(packed(res, 1, 0))
    with pytest.raises(NotImplementedError, match="npromatr"):
        ett.inv_trans(res, spscalar=sc, npromatr=1)
    with pytest.raises(TypeError):
        ett.inv_trans(res, spscalar=sc, dtype=torch.bfloat16)
    g = ett.inv_trans(res, spscalar=sc)
    for tier in ("high", "bf16"):
        gt = ett.inv_trans(res, spscalar=sc, precision=tier, _engine="dense")
        assert gt.shape == g.shape and gt.dtype == torch.float32
        assert torch.isfinite(gt).all()
        _, _, st = ett.dir_trans(res, scalars=gt, precision=tier,
                                 _engine="dense")
        assert st.shape == sc.shape and torch.isfinite(st).all()


def test_argument_checks():
    res = ett.setup("T47")
    sc = torch.zeros(1, res.nspec2)
    with pytest.raises(ValueError, match="together"):
        ett.inv_trans(res, spvor=sc)
    with pytest.raises(ValueError, match="nothing"):
        ett.inv_trans(res)
    with pytest.raises(ValueError, match="nspec2"):
        ett.inv_trans(res, spscalar=torch.zeros(1, 5))
    with pytest.raises(ValueError, match="ndgl"):
        ett.dir_trans(res, scalars=torch.zeros(1, 3, 4))
    with pytest.raises(ValueError, match="together"):
        ett.dir_trans(res, u=torch.zeros(1, res.ndgl, res.grid.ndlon))


def test_packed_to_dense_zero_outside_triangle():
    res = ett.setup("T47")
    dense = layout.packed_to_dense(torch.ones(1, res.nspec2, dtype=torch.float64),
                                   res.device_tables(torch.float64))
    n = torch.arange(res.NP)[None, :]
    m = torch.arange(res.M)[:, None]
    inside = (n >= m) & (n <= res.nsmax)
    assert torch.all(dense[0, :, inside] == 1) and torch.all(
        dense[0, :, ~inside] == 0)

