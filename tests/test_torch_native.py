"""ectrans_tpu_torch.native, the host Legendre builder, against the JAX
package's (``ectrans_tpu/native``): the same C++ code built from the port's
own copy writes the same tables bit for bit, in fp64 and fp32; the numpy
recurrence runs only under ``ECTRANS_TPU_DISABLE_NATIVE`` (and agrees with
the builder within 1e-12 of the tables' largest |value| in fp64); a failed
build raises with g++'s stderr; the legpol cache asks the builder for its
dtype."""

import numpy as np
import pytest

import ectrans_tpu as et
from ectrans_tpu import native as jnative

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import cache, legendre, native

GRIDS = [("O48", 47), ("O160", 159)]


def host_inputs(name, nsmax):
    res = ett.setup(name, nsmax)
    nh = res.ndgnh
    return res, res.mu[:nh], res.nmen[:nh]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,nsmax", GRIDS)
def test_native_tables_match_jax_bit_for_bit(name, nsmax, dtype):
    res, mu, nmen = host_inputs(name, nsmax)
    assert native.available() and jnative.available()
    got = native.build_legendre_parity(res.nsmax, mu, 1, nmen, dtype)
    want = jnative.build_legendre_parity(res.nsmax, mu, 1, nmen, dtype)
    assert got[2] == want[2] == res.kmax
    for a, b in zip(got[:2], want[:2]):
        assert a.dtype == np.dtype(dtype) and a.shape == b.shape
        assert np.array_equal(a, b)
    # and they are the tables of the host table source
    ps, pa = legendre.build_parity_tables(res.nsmax, mu, 1, nmen, dtype)[:2]
    assert np.array_equal(ps, got[0]) and np.array_equal(pa, got[1])


@pytest.mark.parametrize("name,nsmax", GRIDS)
def test_disable_native_selects_numpy(monkeypatch, name, nsmax):
    res, mu, nmen = host_inputs(name, nsmax)
    built = legendre.build_parity_tables(res.nsmax, mu, 1, nmen)
    monkeypatch.setenv("ECTRANS_TPU_DISABLE_NATIVE", "1")
    assert not native.available()
    assert native.build_legendre_parity(res.nsmax, mu, 1, nmen) is None
    assert native.state().startswith("disabled")
    ps, pa, kmax = legendre.build_parity_tables(res.nsmax, mu, 1, nmen)
    want = legendre.split_parity(
        legendre.compute_legendre_table(res.nsmax, mu, 1, nmen), res.nsmax)
    assert kmax == want[2] == built[2]
    assert np.array_equal(ps, want[0]) and np.array_equal(pa, want[1])
    scale = np.abs(built[0]).max()
    for a, b in zip((ps, pa), built[:2]):
        assert np.abs(a - b).max() <= 1e-12 * scale
    ps32 = legendre.build_parity_tables(res.nsmax, mu, 1, nmen,
                                        np.float32)[0]
    assert ps32.dtype == np.float32 and np.array_equal(
        ps32, want[0].astype(np.float32))


def test_failed_build_raises_with_stderr(monkeypatch, tmp_path):
    """No silent fallback: a source g++ refuses raises, naming the error."""
    bad = tmp_path / "legendre_builder.cpp"
    bad.write_text("int et_build_legendre_parity( {\n")
    monkeypatch.setenv("ECTRANS_TPU_NATIVE_DIR", str(tmp_path / "lib"))
    monkeypatch.setattr(native, "_SRC", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.build()
    assert "error" in str(e.value)
    assert not list((tmp_path / "lib").glob("*.so"))


def test_native_dir_moves_the_library(monkeypatch, tmp_path):
    monkeypatch.setenv("ECTRANS_TPU_NATIVE_DIR", str(tmp_path))
    path = native.library_path()
    assert path.parent == tmp_path and path.name.startswith(
        "libectrans_native_")
    assert native.state().startswith("not built")
    assert native.build() == path and path.exists()
    assert native.state() == f"built, {path}"
    monkeypatch.delenv("ECTRANS_TPU_NATIVE_DIR")
    assert native.build_dir().name == "_build"


@pytest.mark.parametrize("shape,dtype", [((3, 5), np.float64),
                                         ((64, 512, 129), np.float32)])
def test_alloc_array(shape, dtype):
    a = native.alloc_array(shape, dtype)
    assert a.shape == shape and a.dtype == np.dtype(dtype)
    a[...] = 1.5
    assert float(a.sum()) == 1.5 * a.size


def test_unsupported_dtype_raises():
    res, mu, nmen = host_inputs("O48", 47)
    with pytest.raises(TypeError, match="float16"):
        native.build_legendre_parity(res.nsmax, mu, 1, nmen, np.float16)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cache_builds_in_its_dtype(monkeypatch, tmp_path, dtype):
    """The legpol cache asks the builder for its dtype (no fp64 build and
    cast), writes the JAX package's key, and the JAX package reads the
    entry as its own tables."""
    monkeypatch.setenv("ECTRANS_TPU_LEGPOL_DIR", str(tmp_path))
    res, mu, nmen = host_inputs("O48", 47)
    ps, pa, kmax = cache.load_parity_cached(res.grid, mu, nmen, dtype)
    want = native.build_legendre_parity(res.nsmax, mu, 1, nmen, dtype)
    assert ps.dtype == np.dtype(dtype)
    assert np.array_equal(ps, want[0]) and np.array_equal(pa, want[1])
    from ectrans_tpu import cache as jcache

    jps, jpa, jk = jcache.load_parity_cached(
        et.grids.make_grid("O48", 47), mu, nmen, dtype=dtype)
    assert isinstance(jps, np.memmap) and jk == kmax
    assert np.array_equal(jps, ps) and np.array_equal(jpa, pa)
