"""The "xla" and "pallas" Legendre engines of ectrans_tpu_torch against
ectrans_tpu on the same inputs and tables (convert.resolution_from_numpy):
the derived parity tables, the parity layouts, the dense UVTVD and packing
of their direct path, kernels K5/K6 through the plain versions that CPU
tensors take, the "xla" einsums, the engine choice, and the bench round
trip per engine.  The "planes" engine is in test_torch_planes.py.

References: the JAX Pallas kernels in interpret mode (mode "f32"); for the
round trip, the JAX "xla" engine for both (the JAX "pallas" engine cannot
run on the CPU: ``inv_grouped`` reads ECTRANS_TPU_LEG_KERNEL inside the
jitted function and passes no ``interpret``).  Tolerances: kernels 5e-6
relative to the output's max in fp32 (two summation orders), 1e-12 in fp64;
the round trip as in test_torch_transform.py (fp32 2e-5 absolute plus 1e-5
relative, fp64 1e-10 relative); tables, layouts and packing exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.ops import layout as jlayout
from ectrans_tpu.ops import legendre_matmul as jlm
from ectrans_tpu.ops import legendre_pallas as jlp
from ectrans_tpu.ops import spectral as jspectral
from ectrans_tpu.transform import InvFlags as JaxInvFlags

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert
from ectrans_tpu_torch.ops import layout, legendre_grouped as lg
from ectrans_tpu_torch.ops import legendre_matmul as lm
from ectrans_tpu_torch.ops import pack, spectral

from test_torch_setup import numpy_state
from test_torch_transform import BENCH, assert_close, packed

NUV, NSC = 2, 6


@functools.lru_cache(maxsize=None)
def _pair(name="O48", nsmax=47):
    jres = et.setup(name, nsmax)
    return jres, convert.resolution_from_numpy(numpy_state(jres))


@pytest.fixture
def pair():
    """O48/T47: the round trips and the tables."""
    return _pair()


@pytest.fixture
def small():
    """O24/T23 (3 m-groups): the kernel-level comparisons, whose interpret-
    mode JAX references compile once per group shape."""
    return _pair("O24", 23)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / np.abs(want).max()


# --------------------------------------------------------------- tables


def test_grouped_tables_match_jax(pair):
    jres, res = pair
    jgl = jres.grouped_legendre("float64")
    gl = res.grouped_legendre(torch.float64)
    assert (gl.ndgnh, gl.kmax) == (jgl.ndgnh, jgl.kmax)
    scale = max(np.abs(np.asarray(g.psym)).max() for g in jgl.groups)
    for g, jg in zip(gl.groups, jgl.groups, strict=True):
        assert (g.m0, g.m1, g.i0, g.kg) == (jg.m0, jg.m1, jg.i0, jg.kg)
        # views of rows zero-padded to a multiple of 4 entries (K5, K6)
        ldk = -(-g.kg // 4) * 4
        for a, b in ((g.psym, jg.psym), (g.pasym, jg.pasym)):
            assert a.stride() == (a.shape[1] * ldk, ldk, 1)
            assert a.dtype == torch.float64
            rows = a.as_strided((*a.shape[:2], ldk), a.stride())
            assert not rows[..., g.kg:].any()
            assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-15 * scale


def test_table_rows_take_padded_rows():
    """K5's and K6's wrappers take tables in rows padded past kg (the
    layout of grouped_legendre, pad_rows) and report the row length, and
    refuse other strides and tables whose rows differ."""
    from ectrans_tpu_torch.ops import legendre_grouped as lg

    t = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    padded = lg.pad_rows(t)
    assert torch.equal(padded, t) and padded.stride() == (24, 8, 1)
    assert lg.table_rows(padded, lg.pad_rows(t), t, (2, 3, 5),
                         torch.float32) == 8
    assert lg.table_rows(t, t, t, (2, 3, 5), torch.float32) == 5
    with pytest.raises(ValueError, match="rows differ"):
        lg.table_rows(padded, t, t, (2, 3, 5), torch.float32)
    with pytest.raises(ValueError, match="padded rows"):
        lg.table_rows(t.transpose(1, 2).contiguous().transpose(1, 2), t, t,
                      (2, 3, 5), torch.float32)
    gap = torch.zeros(2, 4, 5)[:, :3]        # m slabs a row apart
    with pytest.raises(ValueError, match="padded rows"):
        lg.table_rows(gap, gap, t, (2, 3, 5), torch.float32)
    with pytest.raises(TypeError, match="dtype"):
        lg.table_rows(t.double(), t.double(), t, (2, 3, 5), torch.float32)


def test_derived_tables_cache_and_drop():
    """Derived tables are cached per device, keep no full-n copy of their
    own, and drop_cached frees them."""
    res = ett.setup("O48", 47)
    res.drop_cached("full_legendre")    # the setup cache shares res
    gl = res.grouped_legendre(torch.float32)
    ppl = res.planes_legendre(1)
    assert res.grouped_legendre(torch.float32) is gl
    assert res.planes_legendre(1) is ppl
    assert not any(k[0] == "full_legendre" for k in res._cache)
    res.drop_cached("grouped_legendre")
    assert res.grouped_legendre(torch.float32) is not gl
    assert res.planes_legendre(1) is ppl


# -------------------------------------------------------------- layouts


def test_parity_layouts_match_jax(pair):
    jres, res = pair
    rng = np.random.default_rng(1)
    dense = rng.standard_normal((3, 2, res.M, res.NP))
    jt = jres.device_tables(jnp.float64)
    sym, asym = layout.dense_to_parity(torch.from_numpy(dense), res.kmax)
    jsym, jasym = jlayout.dense_to_parity(jnp.asarray(dense), jt)
    np.testing.assert_array_equal(sym.numpy(), np.asarray(jsym))
    np.testing.assert_array_equal(asym.numpy(), np.asarray(jasym))
    back = layout.parity_to_dense(sym, asym, res.NP)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jlayout.parity_to_dense(jsym, jasym, jt,
                                                         res.NP)))
    valid = np.asarray(jt.dense_valid) > 0
    np.testing.assert_array_equal(back.numpy()[..., valid], dense[..., valid])


def test_dense_uvtvd_matches_jax(pair):
    jres, res = pair
    rng = np.random.default_rng(2)
    u, v = (rng.standard_normal((2, 2, res.M, res.NP)) for _ in range(2))
    jt = {k: jnp.asarray(a) for k, a in
          jspectral.uvtvd_coeff_tables(jres, np.float64).items()}
    want = jspectral.uv_to_vordiv(jnp.asarray(u), jnp.asarray(v), jt)
    got = spectral.uv_to_vordiv(torch.from_numpy(u), torch.from_numpy(v),
                                res.device_tables(torch.float64).uvtvd)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14,
                                   atol=1e-14 * np.abs(np.asarray(b)).max())


def test_dense_to_packed_matches_gather(pair):
    """The "pallas" engine's packing (realignment + K3's plain version) is
    the "xla" engine's index gather and the JAX gather, bit for bit."""
    jres, res = pair
    dense = np.random.default_rng(3).standard_normal((4, 2, res.M, res.NP))
    got = pack.dense_to_packed(torch.from_numpy(dense), res).numpy()
    np.testing.assert_array_equal(
        got, layout.dense_to_packed(torch.from_numpy(dense), res).numpy())
    np.testing.assert_array_equal(got, np.asarray(jlayout.dense_to_packed(
        jnp.asarray(dense), jres.device_tables(jnp.float64))))


# ------------------------------------------------- grouped: K5, K6, "xla"


def _parity_inputs(res, nfld, seed, dtype):
    rng = np.random.default_rng(seed)
    shape = (nfld, 2, res.M, res.kmax)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(2)]


def _fourier_input(res, nfld, seed, dtype):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((nfld, 2, res.M, res.ndgl)).astype(dtype)


def test_grouped_kernels_inv_match_pallas(small):
    """K5's plain version through legendre_inv_grouped vs
    legendre_pallas.legendre_inv_grouped (mode f32, interpret), at the
    bench's 16 inverse fields."""
    jres, res = small
    sym, asym = _parity_inputs(res, 16, 16, np.float32)
    want = jlp.legendre_inv_grouped(jnp.asarray(sym), jnp.asarray(asym),
                                    jres.grouped_legendre("float32"),
                                    mode="f32", interpret=True)
    got = lg.legendre_inv_grouped(torch.from_numpy(sym),
                                  torch.from_numpy(asym),
                                  res.grouped_legendre(torch.float32))
    assert got.dtype == torch.float32
    assert rel(got.numpy(), want) < 5e-6


def test_grouped_kernels_dir_match_pallas(small):
    """K6's plain version through legendre_dir_grouped vs
    legendre_pallas.legendre_dir_grouped (mode f32, interpret), at the
    bench's 10 direct fields."""
    jres, res = small
    four = _fourier_input(res, 10, 20, np.float32)
    w = res.w[: res.ndgnh].astype(np.float32)
    want = jlp.legendre_dir_grouped(jnp.asarray(four),
                                    jres.grouped_legendre("float32"),
                                    jnp.asarray(w), mode="f32",
                                    interpret=True)
    got = lg.legendre_dir_grouped(torch.from_numpy(four),
                                  res.grouped_legendre(torch.float32),
                                  torch.from_numpy(w))
    for a, b in zip(got, want, strict=True):
        assert rel(a.numpy(), b) < 5e-6


def test_xla_engine_matches_jax(small):
    """The "xla" engine's einsums vs legendre_matmul in fp64: 1e-12."""
    jres, res = small
    jgl, gl = jres.grouped_legendre("float64"), res.grouped_legendre(
        torch.float64)
    sym, asym = _parity_inputs(res, 4, 5, np.float64)
    want = jlm.legendre_inv_grouped(jnp.asarray(sym), jnp.asarray(asym), jgl)
    got = lm.legendre_inv_grouped(torch.from_numpy(sym),
                                  torch.from_numpy(asym), gl)
    assert rel(got.numpy(), want) < 1e-12
    four = _fourier_input(res, 3, 6, np.float64)
    want = jlm.legendre_dir_grouped(jnp.asarray(four), jgl,
                                    jnp.asarray(res.w[: res.ndgnh]))
    got = lm.legendre_dir_grouped(torch.from_numpy(four), gl,
                                  torch.from_numpy(res.w[: res.ndgnh]))
    for a, b in zip(got, want, strict=True):
        assert rel(a.numpy(), b) < 1e-12


def test_grouped_plain_parity_identity():
    """K5: north and south are fs +- fa; K6 is the adjoint pairing of K5:
    <sym, s> + <asym, a> = <fsym, fs> + <fasym, fa>."""
    rng = np.random.default_rng(4)
    gm, fc2, kg, ig = 3, 4, 6, 7
    s, a = (torch.from_numpy(rng.standard_normal((gm, fc2, kg)))
            for _ in range(2))
    ps, pa = (torch.from_numpy(rng.standard_normal((gm, ig, kg)))
              for _ in range(2))
    north, south = lg.group_inv(s, a, ps, pa)
    torch.testing.assert_close((north + south) / 2,
                               torch.bmm(s, ps.transpose(1, 2)))
    fs, fa = (torch.from_numpy(rng.standard_normal((gm, fc2, ig)))
              for _ in range(2))
    sym, asym = lg.group_dir(fs, fa, ps, pa)
    lhs = (sym * s).sum() + (asym * a).sum()
    fs_inv = torch.bmm(s, ps.transpose(1, 2))
    fa_inv = torch.bmm(a, pa.transpose(1, 2))
    torch.testing.assert_close(lhs, (fs * fs_inv).sum() + (fa * fa_inv).sum())


# ---------------------------------------------- engine choice and tiers


def test_engine_reads_env_dispatch_does_not(pair, monkeypatch):
    _, res = pair
    monkeypatch.delenv("ECTRANS_TPU_LEG_KERNEL", raising=False)
    assert lm.engine() == "dense"
    for name in lm.ENGINES:
        monkeypatch.setenv("ECTRANS_TPU_LEG_KERNEL", name)
        assert lm.engine() == name
    monkeypatch.setenv("ECTRANS_TPU_LEG_KERNEL", "auto")
    assert lm.engine() == "dense"
    # the dispatchers take the engine they are given, whatever the variable
    monkeypatch.setenv("ECTRANS_TPU_LEG_KERNEL", "planes")
    gl = res.grouped_legendre(torch.float64)
    sym, asym = (torch.from_numpy(x) for x in
                 _parity_inputs(res, 2, 7, np.float64))
    np.testing.assert_array_equal(
        lm.inv_grouped(sym, asym, gl, "xla").numpy(),
        lm.legendre_inv_grouped(sym, asym, gl).numpy())
    with pytest.raises(ValueError, match="engine"):
        lm.inv_grouped(sym, asym, gl, "dense")
    with pytest.raises(ValueError, match="engine"):
        ett.inv_trans(res, spscalar=torch.zeros(1, res.nspec2),
                      _engine="cublas")


def test_env_selects_the_transform_engine(pair, monkeypatch):
    """ECTRANS_TPU_LEG_KERNEL picks the engine of inv_trans: "planes" then
    gives the planes engine's result bit for bit."""
    _, res = pair
    sc = torch.from_numpy(packed(res, 2, 8).astype(np.float32))
    want = ett.inv_trans(res, spscalar=sc, _engine="planes")
    monkeypatch.setenv("ECTRANS_TPU_LEG_KERNEL", "planes")
    torch.testing.assert_close(ett.inv_trans(res, spscalar=sc), want,
                               rtol=0, atol=0)


# ------------------------------------------------- the bench round trip


@functools.lru_cache(maxsize=None)
def _jax_round_trip(engine, precision, dtype_name):
    """JAX bench round trip (O48) through ``engine``; the caller sets the
    environment the engine needs."""
    jres, res = _pair()
    jdt = jnp.dtype(dtype_name)
    sp = [packed(res, n, seed) for n, seed in ((NUV, 0), (NUV, 1), (NSC, 2))]
    grid = et.inv_trans(jres, *(jnp.asarray(x, jdt) for x in sp),
                        flags=JaxInvFlags(**BENCH), dtype=jdt,
                        precision=precision, _engine=engine)
    g = np.asarray(grid)
    out = et.dir_trans(jres, jnp.asarray(g[:NUV]),
                       jnp.asarray(g[NUV: 2 * NUV]),
                       jnp.asarray(g[2 * NUV: 2 * NUV + NSC]), dtype=jdt,
                       precision=precision, _engine=engine)
    return sp, g, [np.asarray(x) for x in out]


def _port_round_trip(res, sp, dtype, engine, precision):
    grid = ett.inv_trans(res, *(torch.from_numpy(x) for x in sp),
                         flags=ett.InvFlags(**BENCH), dtype=dtype,
                         precision=precision, _engine=engine)
    return grid, ett.dir_trans(res, grid[:NUV], grid[NUV: 2 * NUV],
                               grid[2 * NUV: 2 * NUV + NSC], dtype=dtype,
                               precision=precision, _engine=engine)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_round_trip_grouped_engines_match_jax(pair, monkeypatch, engine,
                                              dtype):
    _, res = pair
    monkeypatch.delenv("ECTRANS_TPU_LEG_KERNEL", raising=False)
    monkeypatch.delenv("ECTRANS_TPU_PACK_KERNEL", raising=False)
    sp, gj, outj = _jax_round_trip("xla", "highest", str(dtype)[6:])
    gp, outp = _port_round_trip(res, sp, dtype, engine, "highest")
    assert gp.dtype == dtype and gp.shape[0] == 26
    assert_close(gp.numpy(), gj, dtype)
    for a, b in zip(outp, outj, strict=True):
        assert a.dtype == dtype
        assert_close(a.numpy(), b, dtype)


