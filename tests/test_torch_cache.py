"""ectrans_tpu_torch.cache (the on-disk legpol cache) on the CPU: a pair
written by the port is read back bit for bit as memmaps; the key and the
format are ectrans_tpu.cache's, so a pair written by either package is read
by the other; the empty ECTRANS_TPU_LEGPOL_DIR writes nothing; a legacy
.npz is converted; clear_cache empties the directory; and
Resolution.parity_tables, the host table source, goes through it."""

import numpy as np
import pytest
import torch

from ectrans_tpu import cache as jcache
from ectrans_tpu import grids as jgrids

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import cache
from ectrans_tpu_torch.legendre import build_parity_tables

GRIDS = [("O32", 31), ("F16", 31)]


@pytest.fixture
def legpol(monkeypatch, tmp_path):
    d = tmp_path / "legpol"
    monkeypatch.setenv("ECTRANS_TPU_LEGPOL_DIR", str(d))
    return d


def inputs(name, nsmax, package=ett):
    grid = package.make_grid(name, nsmax)
    mu, _ = grid.gauss()
    nh = grid.ndgnh
    return grid, mu[:nh], grid.nmen()[:nh]


def files(d):
    return sorted(p.name for p in d.iterdir()) if d.exists() else []


@pytest.mark.parametrize("name,nsmax", GRIDS)
def test_port_pair_is_read_back_bit_for_bit(legpol, name, nsmax):
    grid, mu, nmen = inputs(name, nsmax)
    built = cache.load_parity_cached(grid, mu, nmen)
    want = build_parity_tables(nsmax, mu, 1, nmen)
    assert len(files(legpol)) == 2
    got = cache.load_parity_cached(grid, mu, nmen)
    assert all(isinstance(x, np.memmap) for x in got[:2])
    assert got[2] == built[2] == want[2]
    for g, b, w in zip(got[:2], built[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(b, w)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name,nsmax", GRIDS)
def test_pairs_are_shared_with_the_jax_package(legpol, name, nsmax, writer):
    grid, mu, nmen = inputs(name, nsmax)
    jgrid, jmu, jnmen = inputs(name, nsmax, jgrids)
    np.testing.assert_array_equal(mu, jmu)
    assert cache._cache_key(grid, np.float64, mu) == jcache._cache_key(
        jgrid, np.float64, jmu)
    if writer == "jax":
        wrote = jcache.load_parity_cached(jgrid, jmu, jnmen, np.float64)
        read = cache.load_parity_cached(grid, mu, nmen)
    else:
        wrote = cache.load_parity_cached(grid, mu, nmen)
        read = jcache.load_parity_cached(jgrid, jmu, jnmen, np.float64)
    assert len(files(legpol)) == 2
    assert all(isinstance(x, np.memmap) for x in read[:2])
    assert read[2] == wrote[2]
    for r, w in zip(read[:2], wrote[:2]):
        np.testing.assert_array_equal(r, w)


def test_empty_dir_writes_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("ECTRANS_TPU_LEGPOL_DIR", "")
    assert cache._cache_dir() is None
    grid, mu, nmen = inputs(*GRIDS[1])
    got = cache.load_parity_cached(grid, mu, nmen)
    assert not isinstance(got[0], np.memmap)
    assert not any(tmp_path.rglob("*"))
    monkeypatch.delenv("ECTRANS_TPU_LEGPOL_DIR")
    assert cache._cache_dir() == (tmp_path / ".cache" / "ectrans_tpu_torch"
                                  / "legpol")


def test_legacy_npz_is_converted(legpol):
    grid, mu, nmen = inputs(*GRIDS[0])
    psym, pasym, kmax = build_parity_tables(grid.nsmax, mu, 1, nmen)
    legpol.mkdir()
    base = legpol / cache._cache_key(grid, np.float64, mu)
    np.savez(base, psym=psym, pasym=pasym)
    assert files(legpol) == [base.name]
    got = cache.load_parity_cached(grid, mu, nmen)
    assert not base.exists() and len(files(legpol)) == 2
    assert got[2] == kmax
    np.testing.assert_array_equal(got[0], psym)
    np.testing.assert_array_equal(got[1], pasym)


def test_clear_cache(legpol):
    for name, nsmax in GRIDS:
        cache.load_parity_cached(*inputs(name, nsmax))
    (legpol / "other.txt").write_text("kept")
    assert len(files(legpol)) == 5
    cache.clear_cache()
    assert files(legpol) == ["other.txt"]


def test_parity_tables_go_through_the_cache(legpol):
    """The CPU's host table source reads the cached pair, and a transform on
    it is the transform on freshly built tables, bit for bit."""
    ett.trans_end()
    res = ett.setup(*GRIDS[0])
    sc = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, res.nspec2)))
    fresh = ett.inv_trans(res, spscalar=sc, dtype=torch.float64)
    assert len(files(legpol)) == 2
    psym, _ = res.parity_tables()
    assert isinstance(psym, np.memmap)
    ett.trans_end()
    res = ett.setup(*GRIDS[0])
    again = ett.inv_trans(res, spscalar=sc, dtype=torch.float64)
    assert torch.equal(again, fresh)
    ett.trans_end()
