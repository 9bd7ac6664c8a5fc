"""ectrans_tpu_torch's C API: the bridge (``capi_bridge``) against
ectrans_tpu.capi_bridge, each entry called in-process on the same ctypes
buffers (numpy arrays made from a seed) at O32/T31 and on a 48 x 40 LAM,
on the CPU (``ECTRANS_TPU_CAPI_DEVICE=cpu``): 1e-12 of each output's
largest |value| in fp64, 1e-5 in fp32.  Then the port's shim
(``capi/ectrans_tpu_torch_capi.c``): a copy of ``src/capi/ectrans_tpu_capi.c``
but for the bridge's name, built with cc, loaded into this process with
ctypes, and linked to the unchanged ``src/capi/test_capi.c``, which must
print "C API test OK".  The shim's tests skip only without a C compiler,
as tests/test_capi.py does."""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ectrans_tpu import capi_bridge as jb

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import capi
from ectrans_tpu_torch import capi_bridge as pb

ROOT = pathlib.Path(__file__).resolve().parent.parent
GRID = ("O32", 31)
LAM = (48, 40, 43, 37, -1, -1, 1300.0, 1300.0)
TOL = {np.float64: 1e-12, np.float32: 1e-5}
needs_cc = pytest.mark.skipif(
    shutil.which("cc") is None and shutil.which("gcc") is None,
    reason="no C compiler")


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("ECTRANS_TPU_CAPI_DEVICE", "cpu")
    monkeypatch.delenv("ECTRANS_TPU_CAPI_DTYPE", raising=False)


def close(got, want, dtype=np.float64):
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = max(1.0, float(np.abs(want).max()))
    assert np.abs(got.astype(np.float64) - want).max() <= TOL[dtype] * scale


def ptr(a: np.ndarray) -> int:
    return a.ctypes.data


class Dims:
    def __init__(self, handle):
        (self.nspec2, self.ngptot, self.ndgl, self.ndlon,
         self.nsmax) = pb.inquire(handle)

    def spec(self, nfld, seed, dtype=np.float64):
        x = np.random.default_rng(seed).standard_normal((nfld, self.nspec2))
        x[:, 1: 2 * (self.nsmax + 1): 2] = 0.0
        return x.astype(dtype)

    def grid(self, nfld, seed, dtype=np.float64):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((nfld, self.ngptot)).astype(dtype)

    def out(self, nfld, n, dtype=np.float64):
        return np.zeros((nfld, n), dtype)


def c_invtrans_scalar(b, h, d):
    gp = d.out(2, d.ngptot)
    assert b.invtrans_scalar(h, 2, ptr(d.spec(2, 1)), ptr(gp)) == 0
    return [gp]


def c_dirtrans_scalar(b, h, d):
    sp = d.out(2, d.nspec2)
    assert b.dirtrans_scalar(h, 2, ptr(d.grid(2, 2)), ptr(sp)) == 0
    return [sp]


def c_invtrans_vordiv(b, h, d):
    u, v = d.out(2, d.ngptot), d.out(2, d.ngptot)
    assert b.invtrans_vordiv(h, 2, ptr(d.spec(2, 3)), ptr(d.spec(2, 4)),
                             ptr(u), ptr(v)) == 0
    return [u, v]


def c_dirtrans_vordiv(b, h, d):
    vor, div = d.out(2, d.nspec2), d.out(2, d.nspec2)
    assert b.dirtrans_vordiv(h, 2, ptr(d.grid(2, 5)), ptr(d.grid(2, 6)),
                             ptr(vor), ptr(div)) == 0
    return [vor, div]


def c_invtrans_full(nvd, nsc, ders):
    def case(b, h, d):
        nout = ett.num_inv_output_fields(nvd, nsc, ett.InvFlags(
            scders=ders, uvders=ders, vorgp=ders, divgp=ders))
        gp = d.out(nout, d.ngptot)
        vor, div, sc = d.spec(nvd, 7), d.spec(nvd, 8), d.spec(nsc, 9)
        got = b.invtrans_full(h, nvd, nsc, ptr(vor), ptr(div), ptr(sc),
                              int(ders), int(ders), int(ders), ptr(gp))
        assert got == nout
        return [gp]
    return case


def c_dirtrans_full(b, h, d):
    vor, div, sc = d.out(1, d.nspec2), d.out(1, d.nspec2), d.out(3, d.nspec2)
    assert b.dirtrans_full(h, 1, 3, ptr(d.grid(5, 10)), ptr(vor), ptr(div),
                           ptr(sc)) == 0
    return [vor, div, sc]


def c_invtrans_adj(b, h, d):
    sp = d.out(2, d.nspec2)
    assert b.invtrans_adj_scalar(h, 2, ptr(d.grid(2, 11)), ptr(sp)) == 0
    return [sp]


def c_dirtrans_adj(b, h, d):
    gp = d.out(2, d.ngptot)
    assert b.dirtrans_adj_scalar(h, 2, ptr(d.spec(2, 12)), ptr(gp)) == 0
    return [gp]


def c_specnorm(b, h, d):
    out = np.zeros(3)
    assert b.specnorm(h, 3, ptr(d.spec(3, 13)), ptr(out)) == 0
    return [out]


def c_gpnorm(b, h, d):
    out = np.zeros((3, 3))
    assert b.gpnorm(h, 3, ptr(d.grid(3, 14)), ptr(out)) == 0
    return [out]


def c_vordiv_to_uv(b, h, d):
    u, v = d.out(2, d.nspec2), d.out(2, d.nspec2)
    assert b.vordiv_to_uv(h, 2, ptr(d.spec(2, 15)), ptr(d.spec(2, 16)),
                          ptr(u), ptr(v)) == 0
    return [u, v]


def c_invtrans_lonlat(b, h, d):
    gp = d.out(2, 19 * 36)
    assert b.invtrans_lonlat(h, 19, 36, 2, ptr(d.spec(2, 17)), ptr(gp)) == 0
    return [gp]


def c_dist_gath(b, h, d):
    glob_gp, glob_sp = d.grid(2, 18), d.spec(2, 19)
    loc_gp, loc_sp = d.out(2, d.ngptot), d.out(2, d.nspec2)
    back_gp, back_sp = d.out(2, d.ngptot), d.out(2, d.nspec2)
    assert b.distgrid(h, 2, ptr(glob_gp), ptr(loc_gp)) == 0
    assert b.gathgrid(h, 2, ptr(loc_gp), ptr(back_gp)) == 0
    assert b.distspec(h, 2, ptr(glob_sp), ptr(loc_sp)) == 0
    assert b.gathspec(h, 2, ptr(loc_sp), ptr(back_sp)) == 0
    np.testing.assert_array_equal(back_gp, glob_gp)
    np.testing.assert_array_equal(back_sp, glob_sp)
    return [loc_gp, loc_sp, back_gp, back_sp]


def c_invtrans_f(b, h, d):
    gp = d.out(2, d.ngptot, np.float32)
    sp = d.spec(2, 20, np.float32)
    assert b.invtrans_scalar_f(h, 2, ptr(sp), ptr(gp)) == 0
    return [gp]


def c_dirtrans_f(b, h, d):
    sp = d.out(2, d.nspec2, np.float32)
    gp = d.grid(2, 21, np.float32)
    assert b.dirtrans_scalar_f(h, 2, ptr(gp), ptr(sp)) == 0
    return [sp]


CASES = {
    "invtrans_scalar": c_invtrans_scalar,
    "dirtrans_scalar": c_dirtrans_scalar,
    "invtrans_vordiv": c_invtrans_vordiv,
    "dirtrans_vordiv": c_dirtrans_vordiv,
    "invtrans_full_1_2": c_invtrans_full(1, 2, False),
    "invtrans_full_1_2_ders": c_invtrans_full(1, 2, True),
    "invtrans_full_2_0_ders": c_invtrans_full(2, 0, True),
    "invtrans_full_0_3_ders": c_invtrans_full(0, 3, True),
    "dirtrans_full": c_dirtrans_full,
    "invtrans_adj_scalar": c_invtrans_adj,
    "dirtrans_adj_scalar": c_dirtrans_adj,
    "specnorm": c_specnorm,
    "gpnorm": c_gpnorm,
    "vordiv_to_uv": c_vordiv_to_uv,
    "invtrans_lonlat": c_invtrans_lonlat,
    "dist_gath": c_dist_gath,
    "invtrans_scalar_f": c_invtrans_f,
    "dirtrans_scalar_f": c_dirtrans_f,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_bridge_entry_matches_jax(name):
    hp, hj = pb.setup(*GRID), jb.setup(*GRID)
    d = Dims(hp)
    got, want = CASES[name](pb, hp, d), CASES[name](jb, hj, d)
    for g, w in zip(got, want):
        close(g, w, w.dtype.type)
    pb.release(hp)
    jb.release(hj)


@pytest.mark.parametrize("entry", ["invtrans_lam_scalar",
                                   "dirtrans_lam_scalar"])
def test_bridge_lam_matches_jax(entry):
    hp, hj = pb.setup_lam(*LAM), jb.setup_lam(*LAM)
    nspec2, ngptot, nx, ny = pb.inquire_lam(hp)
    assert (nspec2, ngptot, nx, ny) == jb.inquire_lam(hj)
    rng = np.random.default_rng(22)
    if entry == "invtrans_lam_scalar":
        x, n_out = rng.standard_normal((2, nspec2)), ngptot
    else:
        x, n_out = rng.standard_normal((2, ny, nx)), nspec2
    outs = [np.zeros((2, n_out)) for _ in range(2)]
    for b, h, out in ((pb, hp, outs[0]), (jb, hj, outs[1])):
        assert getattr(b, entry)(h, 2, ptr(x), ptr(out)) == 0
    close(*outs)
    pb.release_lam(hp)
    jb.release_lam(hj)


def test_setup_inquire_nloen_and_shared_counter():
    h = pb.setup(*GRID)
    hl = pb.setup_lam(*LAM)
    assert hl == h + 1          # one counter for global and LAM handles
    hj = jb.setup(*GRID)
    assert pb.inquire(h) == jb.inquire(hj)
    nl_p, nl_j = (np.zeros(pb.inquire(h)[2], np.int32) for _ in range(2))
    pb.fill_nloen(h, ptr(nl_p))
    jb.fill_nloen(hj, ptr(nl_j))
    np.testing.assert_array_equal(nl_p, nl_j)
    assert pb.release(h) == 0 and pb.release_lam(hl) == 0
    with pytest.raises(KeyError):
        pb.inquire(h)
    jb.release(hj)


@pytest.mark.parametrize("how", ["setup_ex", "set_radius"])
def test_radius_and_stretch_match_jax(how):
    radius = 2 * 6371229.0
    hs = []
    for b in (pb, jb):
        if how == "setup_ex":
            hs.append(b.setup_ex(*GRID, radius, 1.5))
        else:
            b.set_radius(radius)
            try:
                hs.append(b.setup(*GRID))
            finally:
                b.set_radius(0.0)
    d = Dims(hs[0])
    got, want = (c_invtrans_vordiv(b, h, d) for b, h in zip((pb, jb), hs))
    assert pb._res(hs[0]).res.radius == radius
    for g, w in zip(got, want):
        close(g, w)


def test_dtype_knob(monkeypatch):
    monkeypatch.setenv("ECTRANS_TPU_CAPI_DTYPE", "float32")
    hp = pb.setup(*GRID)
    assert pb._res(hp).dtype == torch.float32
    monkeypatch.delenv("ECTRANS_TPU_CAPI_DTYPE")
    hj = jb.setup(*GRID)
    d = Dims(hp)
    got, want = c_invtrans_scalar(pb, hp, d), c_invtrans_scalar(jb, hj, d)
    scale = np.abs(want[0]).max()
    assert np.abs(got[0] - want[0]).max() <= TOL[np.float32] * scale
    monkeypatch.setenv("ECTRANS_TPU_CAPI_DTYPE", "float16")
    with pytest.raises(ValueError, match="float16"):
        pb.setup(*GRID)


@pytest.mark.parametrize("want", [None, "cuda"])
def test_no_card_refuses_setup(monkeypatch, want):
    """The default device is the card: without one both setups raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if want is None:
        monkeypatch.delenv("ECTRANS_TPU_CAPI_DEVICE")
    else:
        monkeypatch.setenv("ECTRANS_TPU_CAPI_DEVICE", want)
    with pytest.raises(RuntimeError, match="the C API: no CUDA device"):
        pb.setup(*GRID)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.setup_lam(*LAM)


def test_set_legpol_dir_moves_the_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("ECTRANS_TPU_LEGPOL_DIR", "")
    ett.trans_end()             # the host tables are built anew below
    assert pb.set_legpol_dir(str(tmp_path)) == 0
    h = pb.setup("F16", 31)
    d = Dims(h)
    c_invtrans_scalar(pb, h, d)
    assert len(list(tmp_path.glob("legpol_*.npy"))) == 2
    assert pb.set_legpol_dir("") == 0
    pb.release(h)
    ett.trans_end()


# --- the shim ---------------------------------------------------------


def test_shim_is_the_jax_shim_but_for_the_bridge_name():
    """Line for line src/capi/ectrans_tpu_capi.c, except the bridge's
    module name and, in the opening comment, the lines that name it."""
    ours = capi.SHIM.read_text().splitlines()
    theirs = (ROOT / "src/capi/ectrans_tpu_capi.c").read_text().splitlines()
    assert len(ours) == len(theirs)
    opening = theirs.index(" */") + 1
    changed = [i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b]
    body = [i for i in changed if i >= opening]
    assert [ours[i].strip() for i in body] == [
        'g_bridge = PyImport_ImportModule("ectrans_tpu_torch.capi_bridge");']
    assert theirs[body[0]].strip() == (
        'g_bridge = PyImport_ImportModule("ectrans_tpu.capi_bridge");')
    assert any("ectrans_tpu_torch.capi_bridge" in ours[i] for i in changed
               if i < opening)


@needs_cc
def test_shim_in_process_matches_the_bridge(monkeypatch):
    """The shim loaded with ctypes into this running interpreter (it takes
    the GIL that ctypes released): its setup, inquire and transforms give
    the bridge's handles and numbers; without a card setup returns
    ECTRANS_TPU_ERR_SETUP (-2).  Every entry of the header is declared."""
    lib = capi.load()
    header = (ROOT / "src/capi/ectrans_tpu.h").read_text()
    names = re.findall(r"int (ectrans_tpu_\w+)\(", header)
    assert len(names) == 32
    assert all(getattr(lib, n).argtypes is not None for n in names)
    assert lib.ectrans_tpu_invtrans_full.argtypes == [ctypes.c_int] * 3 + [
        ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    assert lib.ectrans_tpu_setup_ex.argtypes == [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_double, ctypes.c_double]
    assert lib.ectrans_tpu_finalize.argtypes == []
    assert lib.ectrans_tpu_init() == 0
    h = lib.ectrans_tpu_setup(GRID[0].encode(), GRID[1])
    assert h >= 0 and isinstance(pb._res(h), pb._Handle)
    d = Dims(h)
    dims = [ctypes.c_int() for _ in range(5)]
    assert lib.ectrans_tpu_inquire(h, *map(ctypes.byref, dims)) == 0
    assert tuple(x.value for x in dims) == pb.inquire(h)
    sp = d.spec(2, 23)
    gp, want = d.out(2, d.ngptot), d.out(2, d.ngptot)
    assert lib.ectrans_tpu_invtrans(h, 2, ptr(sp), ptr(gp)) == 0
    pb.invtrans_scalar(h, 2, ptr(sp), ptr(want))
    np.testing.assert_array_equal(gp, want)
    assert lib.ectrans_tpu_release(h) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("ECTRANS_TPU_CAPI_DEVICE", "cuda")
    assert lib.ectrans_tpu_setup(GRID[0].encode(), GRID[1]) == -2


@needs_cc
def test_test_capi_c_linked_to_the_shim(tmp_path):
    """The unchanged src/capi/test_capi.c against the port's shim, on the
    CPU: it must exit 0 and print "C API test OK"."""
    exe = tmp_path / "test_capi"
    subprocess.run([capi.cc(), "-O2", str(ROOT / "src/capi/test_capi.c"),
                    "-o", str(exe)] + capi.link_flags() + ["-lm"],
                   check=True, capture_output=True)
    env = dict(capi.bridge_env("cpu"), ECTRANS_TPU_LEGPOL_DIR="",
               HOME=str(tmp_path))
    out = subprocess.run([str(exe)], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "C API test OK" in out.stdout
