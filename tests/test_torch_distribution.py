"""The distributed layout of ``ectrans_tpu_torch.parallel.distribution``
against ``ectrans_tpu.parallel.distribution`` (host only, no process group).

* ``build_distribution`` and every table of ``host_tables`` (both engines'
  sets), for F24, O48 and O160 on every (w, v) with w * v <= 8: the integer
  maps element for element, the coefficient tables and weights to 1e-15
  relative (the same formulas in float64);
* each w-rank's Legendre rows (``rank_legendre``: the plain recurrence of
  K4 on the CPU, from the recurrence inputs of the rank's m's) against the
  JAX package's host tables ``fl{gi}_pn_w`` / ``lg{gi}_psym_w`` /
  ``lg{gi}_pasym_w`` in fp64, within 1e-12 of the largest entry: every w
  <= 8 at F24 and O48, w = 1, 3 and 8 at O160.

The JAX package's Legendre and Bluestein tables (``fl*``, ``lg*``,
``fb*``) and its unused ``mval`` are not host tables of the port: its
Legendre rows are made per rank, and so are its chirp-z tables
(``rank_fourier``, on the rank's device): those are held here against the
single-device layer on the rank's rows, and the Fourier buckets
(``lat_buckets``) against the JAX package's.
"""

import numpy as np
import pytest
import torch

import ectrans_tpu as et
from ectrans_tpu.parallel import distribution as jdist

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.parallel import distribution as tdist

GRIDS = ("F24", "O48", "O160")
MESHES = [(w, v) for w in range(1, 9) for v in range(1, 9) if w * v <= 8]
NOT_PORTED = ("fl", "lg", "fb")


def _pair(grid, w, v):
    return (jdist.build_distribution(et.setup(grid), w, v),
            tdist.build_distribution(ett.setup(grid), w, v))


@pytest.mark.parametrize("w,v", MESHES)
@pytest.mark.parametrize("grid", GRIDS)
def test_distribution_and_tables_match_jax(grid, w, v):
    jd, td = _pair(grid, w, v)
    for k in ("M_pad", "ndgl_pad", "ML", "LL"):
        assert getattr(td, k) == getattr(jd, k), k
    for k in ("perm", "pos_of_m", "pm_perm_pos", "lat_perm", "lat_pos"):
        assert np.array_equal(getattr(td, k), getattr(jd, k)), k
    assert [dict(vars(g)) for g in td.groups] == \
        [dict(vars(g)) for g in jd.groups]
    for engine in ("xla", "dense"):
        jt = {k: v for k, v in jdist.host_tables(jd, "float32", engine).items()
              if isinstance(v, np.ndarray) and not k.startswith(NOT_PORTED)
              and k != "mval"}
        tt = tdist.host_tables(td, engine)
        assert tt.keys() == jt.keys(), (engine, set(tt) ^ set(jt))
        for k, val in tt.items():
            ref = jt[k]
            assert val.shape == ref.shape, (engine, k)
            if ref.dtype.kind in "iu":
                assert np.array_equal(val, ref), (engine, k)
            else:
                np.testing.assert_allclose(val, ref, rtol=1e-15, atol=0,
                                           err_msg=f"{engine} {k}")


# every w at F24 and O48; at O160 one w-rank, and 3 and 8 (pad rows)
LEGENDRE_CASES = [(g, w) for g in GRIDS[:2] for w in range(1, 9)] + [
    ("O160", w) for w in (1, 3, 8)]


@pytest.mark.parametrize("grid,w", LEGENDRE_CASES)
def test_rank_legendre_rows_match_jax_host_tables(grid, w):
    jd, td = _pair(grid, w, 1)
    dense = jdist.host_tables(jd, "float64", "dense")
    xla = jdist.host_tables(jd, "float64", "xla")
    for iw in range(w):
        fl = tdist.rank_legendre(td, iw, torch.float64, "cpu")
        for gi, (g, jg) in enumerate(zip(fl.groups, jd.groups)):
            rows = slice(iw * jg.Lg, (iw + 1) * jg.Lg)
            want = dense[f"fl{gi}_pn_w"][rows]
            got = g.pn.numpy()
            assert got.shape == want.shape and (g.m0, g.m1) == (
                jg.off, jg.off + jg.Lg)
            tol = 1e-12 * max(np.abs(want).max(), 1.0)
            np.testing.assert_allclose(got, want, rtol=0, atol=tol)
            for k, par in (("psym", 0), ("pasym", 1)):
                np.testing.assert_allclose(
                    got[:, par::2].transpose(0, 2, 1),
                    xla[f"lg{gi}_{k}_w"][rows], rtol=0, atol=tol)


def test_rank_tables_split_the_w_tables():
    """A w-rank's tables: its block of rows of every ``_w`` table (its row
    of ``rom_w``), the others whole; integer maps as int64."""
    td = tdist.build_distribution(ett.setup("O48"), 2, 2)
    host = tdist.host_tables(td, "dense")
    for iw in range(2):
        t = tdist.rank_tables(td, iw, "dense", torch.float64, "cpu")
        for k, val in host.items():
            n = val.shape[0] // 2
            want = (val[iw] if k == "rom_w" else val[iw * n:(iw + 1) * n]
                    if k.endswith("_w") else val)
            assert np.array_equal(t[k].numpy(), want), k
            assert t[k].dtype == (torch.int64 if val.dtype.kind in "iu"
                                  else torch.float64), k


def test_pingpong_blocks_and_grid_blocks():
    """pingpong_blocks is the JAX package's; the grid blocks of the ranks
    tile the pole-to-pole rows in order."""
    for M, w in ((48, 4), (160, 3), (7, 8)):
        assert tdist.pingpong_blocks(M, w) == jdist.pingpong_blocks(M, w)
    td = tdist.build_distribution(ett.setup("F24"), 3, 2)
    blocks = [td.grid_block(r) for r in range(6)]
    assert blocks[0][0] == 0 and blocks[-1][1] == td.res.ndgl
    assert all(a[1] == b[0] for a, b in zip(blocks, blocks[1:]))
    tdist.clear_caches()
    assert tdist.build_distribution.cache_info().currsize == 0


def test_trans_end_clears_distributions():
    """trans_end releases the distributions through the hook that
    parallel.distribution registers, so resolution.py names no higher
    layer."""
    from ectrans_tpu_torch import resolution

    assert tdist.clear_caches in resolution.ON_TRANS_END
    tdist.build_distribution(ett.setup("F24"), 2, 1)
    assert tdist.build_distribution.cache_info().currsize > 0
    ett.trans_end()
    assert tdist.build_distribution.cache_info().currsize == 0


@pytest.mark.parametrize("w,v", [(1, 1), (2, 1), (2, 2), (3, 1), (8, 1)])
@pytest.mark.parametrize("grid", GRIDS)
def test_lat_buckets_match_jax(grid, w, v):
    """The mesh's Fourier buckets: the JAX package's slot ranges, mb and
    ndlon (nfft is the port's own length, at least ndlon + 2 mb + 1)."""
    jd, td = _pair(grid, w, v)
    assert len(td.lat_buckets) == len(jd.lat_buckets) >= 1
    for tb, jb in zip(td.lat_buckets, jd.lat_buckets):
        assert (tb.lb0, tb.lb1, tb.mb, tb.ndlon) == (jb.lb0, jb.lb1, jb.mb,
                                                     jb.ndlon)
        assert tb.nfft >= tb.ndlon + 2 * tb.mb + 1


@pytest.mark.parametrize("grid,w", [("O48", 2), ("O160", 3)])
def test_rank_fourier_matches_single_device(grid, w):
    """Each w-rank's chirp-z buckets (nb > 1 a rank here) on its slots give
    the single-device synthesis and analysis of those rows within 1e-12 in
    fp64; pad slots have zero tables and give zeros."""
    from ectrans_tpu_torch.ops import fourier

    res = ett.setup(grid)
    td = tdist.build_distribution(res, w, 1)
    assert len(td.lat_buckets) > 1
    rng = np.random.default_rng(3)
    four = torch.from_numpy(rng.standard_normal((3, 2, res.M, res.ndgl)))
    grid_all = torch.from_numpy(rng.standard_normal((3, res.ndgl,
                                                     res.grid.ndlon)))
    g_ref = fourier.synthesis(four, res)
    f_ref = fourier.analysis(grid_all, res)
    for iw in range(w):
        bt = tdist.rank_fourier(td, iw, "cpu")
        slots = td.lat_perm[iw * td.LL:(iw + 1) * td.LL]
        pad = torch.from_numpy(slots >= res.ndgl)
        r = torch.from_numpy(np.minimum(slots, res.ndgl - 1))
        x = four[..., r] * ~pad
        g = fourier.synthesis_bucketed(x, bt)
        want = g_ref[:, r] * ~pad[:, None]
        assert (g - want).abs().max() <= 1e-12 * g_ref.abs().max()
        f = fourier.analysis_bucketed(grid_all[:, r], bt, res.M)
        want = f_ref[..., r] * ~pad
        assert (f - want).abs().max() <= 1e-12 * f_ref.abs().max()
        assert torch.all(f[..., pad] == 0) and torch.all(g[:, pad] == 0)
        for bk, meta in zip(bt.buckets, td.lat_buckets):
            assert (bk.mb, bk.ndlon, bk.nfft) == (meta.mb, meta.ndlon,
                                                  meta.nfft)
            rows = pad[meta.lb0:meta.lb1]
            assert torch.all(bk.syn_bh[rows] == 0)
            assert torch.all(bk.ana_out[rows] == 0)
