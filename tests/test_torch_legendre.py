"""Legendre layer of ectrans_tpu_torch against ectrans_tpu: the table
generator (K4), the dense-row inverse (K1) and direct (K2) transforms, each
through the plain PyTorch version that CPU tensors take, on tables identical
to the JAX package's (convert.resolution_from_numpy).  The JAX side runs its
Pallas kernels in interpret mode.  The CUDA kernels themselves are held
against the plain versions in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.ops import legendre_pallas, legendre_tablegen as jtg

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert
from ectrans_tpu_torch.ops import legendre_dense as ld
from ectrans_tpu_torch.ops import legendre_tablegen as tg

from test_torch_setup import numpy_state


@pytest.fixture(scope="module")
def pair():
    """(JAX Resolution, port Resolution on the same fp64 host tables)."""
    jres = et.setup("O48", 47)
    return jres, convert.resolution_from_numpy(numpy_state(jres))


def _plain_tables(res, dtype):
    inp = tg._device_inputs(res, torch.device("cpu"))
    return [tg.gen_group(inp, m0, m1, J, i0, dtype).numpy()
            for m0, m1, i0, J in res.legendre_groups()]


@pytest.mark.parametrize("name,nsmax", [("O48", 47), ("O160", 159)])
def test_tablegen_plain_matches_host_fp64(name, nsmax):
    """K4's plain version vs the JAX fp64 host build: <= 1e-7 relative to
    the table's global scale in fp32 (as tests/test_tablegen.py), <= 1e-12
    in fp64."""
    jfl = et.setup(name, nsmax).full_legendre("float64")
    res = ett.setup(name, nsmax)
    scale = max(1.0, max(np.abs(np.asarray(g.pn)).max() for g in jfl.groups))
    for dtype, tol in ((torch.float32, 1e-7), (torch.float64, 1e-12)):
        for g, pn in zip(jfl.groups, _plain_tables(res, dtype)):
            assert pn.shape == np.asarray(g.pn).shape
            err = np.abs(pn - np.asarray(g.pn)).max() / scale
            assert err < tol, (dtype, g.m0, err)


def test_tablegen_plain_matches_jax_kernel():
    """K4's plain version vs the JAX Pallas generator (interpret mode)."""
    jres = et.setup("O48", 47)
    res = ett.setup("O48", 47)
    groups = res.legendre_groups()
    jfl = jtg.materialize_full_legendre(jres, "float32", ngroups=len(groups),
                                        interpret=True)
    for g, pn in zip(jfl.groups, _plain_tables(res, torch.float32)):
        a = np.asarray(g.pn)
        err = np.abs(pn - a).max() / max(1.0, np.abs(a).max())
        assert err < 1e-7, (g.m0, err)


def test_tablegen_zero_padding():
    """Every entry past n = nsmax+1 and where m > nmen(lat) is exactly 0."""
    res = ett.setup("O48", 47)
    nmen = res.nmen[: res.ndgnh]
    for (m0, m1, i0, J), pn in zip(res.legendre_groups(),
                                   _plain_tables(res, torch.float32)):
        m = np.arange(m0, m1)[:, None, None]
        j = np.arange(J)[None, :, None]
        lat = np.arange(i0, res.ndgnh)[None, None, :]
        dead = (m + j > res.nsmax + 1) | (m > nmen[lat])
        assert np.all(pn[np.broadcast_to(dead, pn.shape)] == 0.0)
        assert np.isfinite(pn).all()


def test_diag_realign_matches_jax():
    rng = np.random.default_rng(5)
    dense = rng.standard_normal((3, 2, 10, 11))
    got = ld._diag_realign(torch.from_numpy(dense)).numpy()
    want = np.asarray(legendre_pallas._diag_realign(jnp.asarray(dense)))
    np.testing.assert_array_equal(got, want)
    back = ld._diag_unalign(torch.from_numpy(got), 11).numpy()
    np.testing.assert_array_equal(
        back, np.asarray(legendre_pallas._diag_unalign(jnp.asarray(want), 11)))


@pytest.mark.parametrize("nfld", [3, 16])
def test_inv_dense_matches_jax(pair, nfld):
    """K1 path (legendre_inv_dense) vs legendre_pallas.legendre_inv_dense
    (mode f32, interpret), fp32: <= 5e-6 relative."""
    jres, res = pair
    rng = np.random.default_rng(nfld)
    dense = rng.standard_normal((nfld, 2, res.M, res.NP)).astype(np.float32)
    dense *= np.asarray(jres.device_tables(jnp.float32).dense_valid)
    want = np.asarray(legendre_pallas.legendre_inv_dense(
        jnp.asarray(dense), jres.full_legendre("float32"), mode="f32",
        interpret=True))
    got = ld.legendre_inv_dense(torch.from_numpy(dense),
                                res.full_legendre(torch.float32)).numpy()
    assert got.shape == want.shape == (nfld, 2, res.M, res.ndgl)
    assert np.abs(got - want).max() / np.abs(want).max() < 5e-6


@pytest.mark.parametrize("nfld", [2, 10])
def test_dir_rows_matches_jax(pair, nfld):
    """K2 path (legendre_dir_rows) vs legendre_pallas.legendre_dir_rows
    (interpret), fp32: <= 5e-6 relative, per group."""
    jres, res = pair
    rng = np.random.default_rng(10 + nfld)
    four = rng.standard_normal((nfld, 2, res.M, res.ndgl)).astype(np.float32)
    w = res.w[: res.ndgnh].astype(np.float32)
    want = legendre_pallas.legendre_dir_rows(
        jnp.asarray(four), jres.full_legendre("float32"), jnp.asarray(w),
        mode="f32", interpret=True)
    got = ld.legendre_dir_rows(torch.from_numpy(four),
                               res.full_legendre(torch.float32),
                               torch.from_numpy(w))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() / np.abs(b).max() < 5e-6


def test_group_kernels_plain_parity_identity():
    """South = north with odd-j terms negated (inverse); the direct result
    is the adjoint pairing: <K2(fn, fs), d2> = <fn, north> + <fs, south>."""
    rng = np.random.default_rng(3)
    gm, fc2, J, ig = 3, 4, 9, 7
    d2 = torch.from_numpy(rng.standard_normal((gm, fc2, J)))
    pn = torch.from_numpy(rng.standard_normal((gm, J, ig)))
    fn = torch.from_numpy(rng.standard_normal((gm, fc2, ig)))
    fs = torch.from_numpy(rng.standard_normal((gm, fc2, ig)))
    north, south = ld.group_inv_dense(d2, pn)
    sgn = torch.tensor([1.0, -1.0] * 5)[:J]
    torch.testing.assert_close(south, torch.bmm(d2 * sgn, pn))
    out = ld.group_dir_dense(fn, fs, pn)
    lhs = (out * d2).sum()
    rhs = (fn * north).sum() + (fs * south).sum()
    torch.testing.assert_close(lhs, rhs)

