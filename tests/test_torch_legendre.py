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
from ectrans_tpu_torch.ops import layout
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
    got = layout.diag_realign(torch.from_numpy(dense)).numpy()
    want = np.asarray(legendre_pallas._diag_realign(jnp.asarray(dense)))
    np.testing.assert_array_equal(got, want)
    back = layout.diag_unalign(torch.from_numpy(got), 11).numpy()
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



def _long_double_table(nsmax: int, mu: np.ndarray) -> np.ndarray:
    """P̄[m, n, lat] (n <= nsmax + 1) by the host's recurrence in long
    double, whose exponent range needs no rescaling at TCO1279."""
    L = np.longdouble
    mul = mu.astype(L)
    M = nsmax + 1
    mm = np.arange(M, dtype=L)[:, None]

    def eps(n):
        num = L(n) * L(n) - mm * mm
        return np.sqrt(np.where(num > 0, num / (L(4) * L(n) * L(n) - 1),
                                L(0)))[:, 0]

    seed = np.ones((M, mu.size), dtype=L)
    c = np.sqrt(L(1) - mul * mul)
    for m in range(1, M):
        seed[m] = seed[m - 1] * c * np.sqrt(L(2 * m - 1) / L(2 * m))
    seed *= np.sqrt(L(2) * np.arange(M, dtype=L) + 1)[:, None]
    out = np.zeros((M, M + 1, mu.size), dtype=L)
    cur = np.zeros((M, mu.size), dtype=L)
    prev = np.zeros_like(cur)
    for n in range(M + 1):
        if n < M:
            cur[n], prev[n] = seed[n], 0
        if n > 0:
            a = slice(0, min(n, M))
            new = (mul * cur[a] - eps(n - 1)[a, None] * prev[a]) / eps(n)[
                a, None]
            prev[a], cur[a] = cur[a], new
        k = min(n, M - 1) + 1
        out[:k, n] = cur[:k]
    return out.astype(np.float64)


def test_fp64_recurrences_at_tco1279_lat_lon_nodes():
    """K4's fp64 recurrence (its plain version, the kernel's bits) and the
    host's (``compute_legendre_table``, the CPU's tables and phase 9(b)'s
    direct sums) at TCO1279 on the 0.25 degree grid's nodes, the pole and
    its neighbours included, both within 1e-11 of the table's largest
    |value| of a long-double recurrence: next to the pole each is ~5e-12
    from it, and they differ by ~3.5e-12, which phase 9(b)'s fp64 output
    shows as ~8e-13 at the rows 0.25 degrees from the poles."""
    from ectrans_tpu_torch.legendre import compute_legendre_table

    nsmax = 1279
    mu = ett.LatLonGrid(721, 1440).mu[[0, 1, 2, 90, 180, 360]]
    ref = _long_double_table(nsmax, mu)
    host = compute_legendre_table(nsmax, mu, 1)
    inp = {k: torch.as_tensor(v) for k, v in tg.recurrence_inputs(
        nsmax, mu, np.full(mu.size, nsmax)).items()}
    k4 = tg.gen_group_plain(inp, 0, nsmax + 1, nsmax + 3, 0,
                            torch.float64).numpy()
    kn = np.zeros_like(host)
    for m in range(nsmax + 1):
        kn[m, m:] = k4[m, : nsmax + 2 - m]
    scale = np.abs(ref).max()
    for table in (host, kn):
        assert np.abs(table - ref).max() <= 1e-11 * scale
