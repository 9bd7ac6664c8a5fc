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
Legendre rows are made per rank, and its Fourier layer has no chirp-z
tables (``distribution``'s docstring).
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
