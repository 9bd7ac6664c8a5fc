"""ectrans_tpu_torch host setup against ectrans_tpu: grids, Gauss nodes,
index maps and host Legendre tables (bitwise, or 1e-15 relative in fp64),
the numpy carry-over (convert.resolution_from_numpy), and the package's
independence from JAX."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ectrans_tpu as et
from ectrans_tpu import grids as jgrids

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert, grids

REPO = Path(__file__).resolve().parents[1]

HOST_FIELDS = ("mu", "w", "nmen", "ndglu", "eps", "rlapin", "racthe", "nasm0",
               "dense_gather", "packed_gather_c", "packed_gather_m",
               "packed_gather_n")


def numpy_state(jres, with_tables=True) -> dict:
    """The numpy state of a JAX Resolution, as convert.resolution_from_numpy
    takes it."""
    d = {"grid": jres.grid.name, "nsmax": jres.nsmax, "radius": jres.radius}
    for k in ("mu", "w", "nmen", "ndglu", "eps", "racthe", "nasm0"):
        d[k] = np.asarray(getattr(jres, k))
    if with_tables:
        d["pn"] = [np.asarray(g.pn)
                   for g in jres.full_legendre("float64").groups]
    return d


def test_import_leaves_jax_out():
    """Every module of the package (found by walking it) imports neither
    jax nor ectrans_tpu."""
    mods = ["ectrans_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(ett.__path__,
                                              "ectrans_tpu_torch.")]
    assert {"ectrans_tpu_torch.convert", "ectrans_tpu_torch.transform",
            "ectrans_tpu_torch._build", "ectrans_tpu_torch.api",
            "ectrans_tpu_torch.adjoint", "ectrans_tpu_torch.norms",
            "ectrans_tpu_torch.field_layout",
            "ectrans_tpu_torch.utils.timing",
            "ectrans_tpu_torch.programs.benchmark",
            "ectrans_tpu_torch.programs.lam_benchmark",
            "ectrans_tpu_torch.programs.info",
            "ectrans_tpu_torch.programs.world",
            "ectrans_tpu_torch.compat4py", "ectrans_tpu_torch.capi_bridge",
            "ectrans_tpu_torch.cache", "ectrans_tpu_torch.capi",
            "ectrans_tpu_torch.native", "ectrans_tpu_torch.entry"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'ectrans_tpu.'))] + [m for m in ('ectrans_tpu',) "
            "if m in sys.modules]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("name,nsmax", [("O48", 47), ("F24", 47),
                                        ("TL159", None), ("TCO95", None)])
def test_host_state_matches_jax(name, nsmax):
    jres = et.setup(name, nsmax)
    pres = ett.setup(name, nsmax)
    assert pres.grid == grids.GridSpec(**vars(jres.grid))
    assert (pres.M, pres.NP, pres.kmax, pres.nspec2) == (
        jres.M, jres.NP, jres.kmax, jres.nspec2)
    for k in HOST_FIELDS:
        a, b = np.asarray(getattr(jres, k)), getattr(pres, k)
        assert a.shape == b.shape, k
        np.testing.assert_array_equal(b, a, err_msg=k)


@pytest.mark.parametrize("spec", ["TCO1279", "TCO639", "O160", "TQ95", "F24"])
def test_grid_rules_match_jax(spec):
    """nmen/ndglu (per-latitude truncation) at full size, incl. TCO1279."""
    a, b = jgrids.make_grid(spec), grids.make_grid(spec)
    assert vars(a) == vars(b)
    np.testing.assert_array_equal(b.nmen(), a.nmen())
    np.testing.assert_array_equal(b.ndglu(), a.ndglu())
    assert (b.ngptot, b.nspec2, b.ndlon) == (a.ngptot, a.nspec2, a.ndlon)


@pytest.mark.parametrize("name,nsmax", [("O48", 47), ("F24", 47)])
def test_host_tables_match_jax(name, nsmax):
    jres = et.setup(name, nsmax)
    pres = ett.setup(name, nsmax)
    jfl = jres.full_legendre("float64")
    assert [(g.m0, g.m1, g.i0, g.J) for g in jfl.groups] == list(
        pres.legendre_groups())
    scale = max(np.abs(np.asarray(g.pn)).max() for g in jfl.groups)
    for g, pn in zip(jfl.groups, pres.host_full_legendre()):
        err = np.abs(pn - np.asarray(g.pn)).max() / scale
        assert err <= 1e-15, (g.m0, err)


def test_convert_matches_setup():
    jres = et.setup("O48", 47)
    pres = ett.setup("O48", 47)
    cres = convert.resolution_from_numpy(numpy_state(jres))
    for k in HOST_FIELDS:
        np.testing.assert_array_equal(getattr(cres, k), getattr(pres, k),
                                      err_msg=k)
    # the carried tables are the host table source of the new Resolution
    fl = cres.full_legendre(torch.float64)
    for g, jg in zip(fl.groups, jres.full_legendre("float64").groups):
        np.testing.assert_array_equal(g.pn.numpy(), np.asarray(jg.pn))


def test_convert_rejects_inconsistent_state():
    d = numpy_state(et.setup("O48", 47), with_tables=False)
    bad = dict(d, nasm0=d["nasm0"] + 2)
    with pytest.raises(ValueError, match="nasm0"):
        convert.resolution_from_numpy(bad)
    with pytest.raises(ValueError, match="mu"):
        convert.resolution_from_numpy(dict(d, mu=d["mu"][:-1]))
    res = convert.resolution_from_numpy(d)
    with pytest.raises(ValueError, match="tables"):
        res.use_host_tables([np.zeros((1, 1, 1))])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_tables(dtype):
    res = ett.setup("F24", 47)
    t = res.device_tables(dtype)
    assert t.w.dtype == dtype and t.racthe.dtype == dtype
    assert t.nasm0.dtype == torch.int64
    assert tuple(t.dense_gather.shape) == (2, res.M, res.NP)
    assert tuple(t.uvtvd_mm["p"].shape) == (res.M, res.NP + 1)
    assert res.device_tables(dtype) is t      # cached per (dtype, device)
    with pytest.raises(TypeError):
        res.device_tables(torch.float16)
