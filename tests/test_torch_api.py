"""ectrans_tpu_torch's SpectralTransform handle, norms, inquiry,
vordiv_to_uv, TRANS_PNM, the split call modes, the Schmidt stretch and the
setup cache against ectrans_tpu on the same inputs.  The handles run on
the CPU (device="cpu"); a handle with the default device needs a CUDA card.
Tolerances as in test_torch_transform.py: fp64 1e-10 relative to the
output's max; fp32 2e-5 absolute plus 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu import norms as jnorms
from ectrans_tpu.api import SpectralTransform as JaxTransform
from ectrans_tpu.api import vordiv_to_uv as jax_vordiv_to_uv
from ectrans_tpu.transform import InvFlags as JaxInvFlags

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert, norms
from ectrans_tpu_torch.resolution import get_current, printlev, trans_end

from ectrans_tpu_torch.parallel import make_mesh
from test_torch_setup import numpy_state
from torch_world import one_rank_world
from test_torch_transform import JDT, assert_close, packed

BENCH = dict(scders=True, uvders=True)


@pytest.fixture(scope="module")
def handles():
    """(JAX handle, port handle) at O48 in fp64."""
    return (JaxTransform("O48", 47, dtype=jnp.float64),
            ett.SpectralTransform("O48", 47, dtype=torch.float64,
                                  device="cpu"))


def test_handle_defaults_to_cuda():
    """The default handle runs on a CUDA card; without one it refuses to
    start (no fallback to the CPU)."""
    if torch.cuda.is_available():
        st = ett.SpectralTransform("T47")
        assert st.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ett.SpectralTransform("T47")
    st = ett.SpectralTransform("T47", device="cpu")
    assert st.device == torch.device("cpu")
    assert st.res is ett.setup("T47")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("npromatr", [None, 4])
def test_handle_round_trip_matches_jax(dtype, npromatr):
    """inv_trans and dir_trans of the handle (numpy inputs, moved to its
    device), with and without packets, against the JAX handle."""
    jst = JaxTransform("O48", 47, dtype=JDT[dtype])
    st = ett.SpectralTransform("O48", 47, dtype=dtype, device="cpu")
    sp = [packed(st.res, n, seed) for n, seed in ((2, 0), (2, 1), (6, 2))]
    jgrid = np.asarray(jst.inv_trans(*[jnp.asarray(x) for x in sp],
                                     npromatr=npromatr, **BENCH))
    grid = st.inv_trans(*sp, npromatr=npromatr, **BENCH)
    assert grid.device.type == "cpu" and grid.dtype == dtype
    assert_close(grid.numpy(), jgrid, dtype)
    jout = jst.dir_trans(jnp.asarray(jgrid[:2]), jnp.asarray(jgrid[2:4]),
                         jnp.asarray(jgrid[4:10]), npromatr=npromatr)
    out = st.dir_trans(grid[:2], grid[2:4], grid[4:10], npromatr=npromatr)
    for a, b in zip(out, jout):
        assert_close(a.numpy(), np.asarray(b), dtype)


def test_handle_fspgl_proc_matches_jax(handles):
    jst, st = handles
    sc = packed(st.res, 2, 3)
    hook = lambda f: f * 2.0 + 1.0
    want = jst.inv_trans(spscalar=jnp.asarray(sc), fspgl_proc=hook)
    got = st.inv_trans(spscalar=sc, fspgl_proc=hook)
    assert_close(got.numpy(), np.asarray(want), torch.float64)


def test_handle_adjoints_match_jax(handles):
    jst, st = handles
    rng = np.random.default_rng(4)
    flags = ett.InvFlags(**BENCH)
    y = rng.standard_normal((ett.num_inv_output_fields(1, 2, flags),
                             st.res.ndgl, st.res.grid.ndlon))
    want = jst.inv_trans_adj(jnp.asarray(y), 1, 2,
                             flags=JaxInvFlags(**BENCH))
    got = st.inv_trans_adj(y, 1, 2, flags=flags)
    for a, b in zip(got, want):
        assert_close(a.numpy(), np.asarray(b), torch.float64)
    spec = [packed(st.res, n, seed) for n, seed in ((1, 5), (1, 6), (2, 7))]
    want = jst.dir_trans_adj(*[jnp.asarray(x) for x in spec], nfld_uv=1,
                             nfld_sc=2)
    got = st.dir_trans_adj(*spec, nfld_uv=1, nfld_sc=2)
    for a, b in zip(got, want):
        assert_close(a.numpy(), np.asarray(b), torch.float64)


def test_split_call_modes_match_jax(handles):
    """Callmode 2: split families in and out, against the JAX handle."""
    jst, st = handles
    res = st.res
    rng = np.random.default_rng(8)

    def spec(*lead):
        x = rng.standard_normal(lead + (res.nspec2,))
        x[..., 1 : 2 * (res.nsmax + 1) : 2] = 0.0
        return x

    args = dict(spvor=spec(2), spdiv=spec(2), spsc3a=spec(2, 3),
                spsc3b=spec(1, 2), spsc2=spec(2))
    flags = dict(vorgp=True, scders=True, uvders=True)
    want = jst.inv_trans_split(
        **{k: jnp.asarray(v) for k, v in args.items()},
        flags=JaxInvFlags(**flags))
    got = st.inv_trans_split(**args, flags=ett.InvFlags(**flags))
    assert sorted(got) == sorted(want)
    for k in got:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert_close(got[k].numpy(), np.asarray(want[k]), torch.float64)
    # the flags may come as keywords, as in inv_trans
    kw = st.inv_trans_split(**args, **flags)
    assert all(torch.equal(kw[k], got[k]) for k in got)
    g = {k: np.asarray(want[k]) for k in ("u", "v", "sc3a", "sc3b", "sc2")}
    jv, jd, jsc = jst.dir_trans_split(
        jnp.asarray(g["u"]), jnp.asarray(g["v"]), jnp.asarray(g["sc3a"]),
        jnp.asarray(g["sc3b"]), jnp.asarray(g["sc2"]))
    v, d, sc = st.dir_trans_split(g["u"], g["v"], g["sc3a"], g["sc3b"],
                                  g["sc2"])
    assert_close(v.numpy(), np.asarray(jv), torch.float64)
    assert_close(d.numpy(), np.asarray(jd), torch.float64)
    assert sorted(sc) == sorted(jsc)
    for k in sc:
        assert tuple(sc[k].shape) == tuple(jsc[k].shape), k
        assert_close(sc[k].numpy(), np.asarray(jsc[k]), torch.float64)


@pytest.mark.parametrize("name,nsmax", [("O48", 47), ("F24", 47),
                                        ("TCO95", None)])
def test_inquire_matches_jax(name, nsmax):
    """TRANS_INQ: every key and value of the JAX handle without a mesh."""
    q = ett.SpectralTransform(name, nsmax, device="cpu").inquire()
    jq = JaxTransform(name, nsmax).inquire()
    assert sorted(q) == sorted(jq)
    for k, v in q.items():
        np.testing.assert_allclose(np.asarray(v), np.asarray(jq[k]),
                                   rtol=1e-14, atol=0, err_msg=k)
    assert abs(np.sum(q["rgw"]) - 1.0) < 1e-13


def test_legendre_polynomials_match_jax(handles):
    jst, st = handles
    for m in (0, 3, 17, 47):
        tab = st.legendre_polynomials(m)
        want = jst.legendre_polynomials(m)
        assert tab.shape == want.shape == (st.res.NP - m, st.res.ndgl)
        assert np.abs(tab - want).max() < 1e-12, m


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_vordiv_to_uv_matches_jax(dtype):
    jres = et.setup("F24", 47)
    res = convert.resolution_from_numpy(numpy_state(jres, with_tables=False))
    vor, div = packed(res, 2, 9), packed(res, 2, 10)
    ju, jv = jax_vordiv_to_uv(jres, jnp.asarray(vor), jnp.asarray(div),
                              dtype=JDT[dtype])
    u, v = ett.vordiv_to_uv(res, torch.from_numpy(vor),
                            torch.from_numpy(div), dtype=dtype)
    assert u.dtype == dtype and u.shape == (2, res.nspec2)
    assert_close(u.numpy(), np.asarray(ju), dtype)
    assert_close(v.numpy(), np.asarray(jv), dtype)
    st = ett.SpectralTransform("F24", 47, dtype=dtype, device="cpu")
    u2, v2 = st.vordiv_to_uv(vor, div)
    assert_close(u2.numpy(), np.asarray(ju), dtype)
    assert_close(v2.numpy(), np.asarray(jv), dtype)


@pytest.mark.parametrize("met", [None, "ramp"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_specnorm_matches_jax(dtype, met):
    res = ett.setup("O48", 47)
    jres = et.setup("O48", 47)
    sc = packed(res, 3, 11)
    m = None if met is None else np.linspace(0.5, 2.0, res.nsmax + 1)
    want = jnorms.specnorm(jres, jnp.asarray(sc, JDT[dtype]), m)
    got = norms.specnorm(res, torch.from_numpy(sc).to(dtype), m)
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-12 if dtype == torch.float64 else 1e-6)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_gpnorm_matches_jax(dtype):
    """(ave, min, max) of a grid with garbage past each row's NLOEN: the
    masked points are ignored, min and max exact."""
    res = ett.setup("O48", 47)
    jres = et.setup("O48", 47)
    g = np.random.default_rng(12).standard_normal(
        (3, res.ndgl, res.grid.ndlon)) + 0.25
    g[:, 0, -1] = 1e9                        # past NLOEN on the first row
    jave, jmin, jmax = jnorms.gpnorm(jres, jnp.asarray(g, JDT[dtype]))
    ave, gmin, gmax = norms.gpnorm(res, torch.from_numpy(g).to(dtype))
    assert_close(ave.numpy(), np.asarray(jave), dtype)
    np.testing.assert_array_equal(gmin.numpy(), np.asarray(jmin))
    np.testing.assert_array_equal(gmax.numpy(), np.asarray(jmax))
    assert float(gmax.max()) < 1e9
    st = ett.SpectralTransform("O48", 47, dtype=dtype, device="cpu")
    ave2, _, _ = st.gpnorm(g.astype(np.float64))
    assert_close(ave2.numpy(), np.asarray(jave), dtype)
    assert st.gpnorm(g, ave_only=True)[1] is None


def test_gpnorm_tl_ad_match_jax():
    """GPNORM_TRANSTL/AD against the JAX package, and the adjoint identity
    <TL(x), y> == <x, AD(y)>."""
    res = ett.setup("O48", 47)
    jres = et.setup("O48", 47)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, res.ndgl, res.grid.ndlon))
    y = rng.standard_normal(2)
    tl = norms.gpnorm_tl(res, torch.from_numpy(x))
    ad = norms.gpnorm_ad(res, torch.from_numpy(y))
    np.testing.assert_allclose(tl.numpy(),
                               np.asarray(jnorms.gpnorm_tl(jres, x)),
                               rtol=1e-12)
    np.testing.assert_allclose(ad.numpy(),
                               np.asarray(jnorms.gpnorm_ad(jres,
                                                           jnp.asarray(y))),
                               rtol=1e-12, atol=1e-300)
    lhs, rhs = float((tl * torch.from_numpy(y)).sum()), float(
        (ad * torch.from_numpy(x)).sum())
    assert abs(lhs - rhs) < 1e-12 * max(1.0, abs(lhs))


def test_specnorm_parseval():
    """Parseval: specnorm^2 equals the area-weighted grid mean square."""
    st = ett.SpectralTransform("F24", 47, dtype=torch.float64, device="cpu")
    sc = packed(st.res, 2, 0)
    sn = st.specnorm(sc)
    grid = st.inv_trans(spscalar=sc)
    ave2, _, _ = st.gpnorm(grid * grid)
    np.testing.assert_allclose(sn.numpy() ** 2, ave2.numpy(), rtol=1e-10)


@pytest.mark.parametrize("c", [2.4, 0.5])
def test_stretch_matches_jax(c):
    """The Schmidt stretch: mu, racthe, the Legendre tables' latitudes and
    the inverse output as in the JAX package; stretch 1 changes nothing."""
    jres = et.setup("F24", 47, stretch=c)
    res = ett.setup("F24", 47, stretch=c)
    assert res is not ett.setup("F24", 47)
    np.testing.assert_array_equal(res.mu, jres.mu)
    np.testing.assert_allclose(res.racthe, jres.racthe, rtol=1e-15)
    np.testing.assert_array_equal(res.w, jres.w)
    np.testing.assert_array_equal(ett.setup("F24", 47, stretch=1.0).mu,
                                  et.setup("F24", 47).mu)
    sc = packed(res, 2, 13)
    want = et.inv_trans(jres, spscalar=jnp.asarray(sc), dtype=jnp.float64,
                        flags=JaxInvFlags(scders=True))
    for engine in ("dense", "xla"):
        got = ett.inv_trans(res, spscalar=torch.from_numpy(sc),
                            dtype=torch.float64,
                            flags=ett.InvFlags(scders=True), _engine=engine)
        assert_close(got.numpy(), np.asarray(want), torch.float64)
    st = ett.SpectralTransform("F24", 47, stretch=c, device="cpu")
    assert st.res is res
    np.testing.assert_array_equal(st.inquire()["rmu"], jres.mu)


def test_setup_cache_get_current_trans_end():
    """GET_CURRENT, TRANS_END and TRANS_RELEASE (tests/test_api.py): setup
    is cached on (grid, radius, stretch); trans_end empties the cache and
    drops the cached tables, and a held Resolution keeps working."""
    res = ett.setup("F24", 47)
    assert get_current() is res
    assert ett.setup("F24", 47) is res
    assert ett.setup("F24", 47, radius=1.0) is not res
    assert get_current().radius == 1.0
    sc = torch.from_numpy(packed(res, 1, 14))
    g1 = ett.inv_trans(res, spscalar=sc, dtype=torch.float64)
    assert any(k[0] == "full_legendre" for k in res._cache)
    trans_end()
    assert get_current() is None
    assert not res._cache                    # its tables were dropped
    res2 = ett.setup("F24", 47)
    assert res2 is not res and res2.nspec2 == res.nspec2
    assert get_current() is res2
    assert torch.equal(ett.inv_trans(res, spscalar=sc, dtype=torch.float64),
                       g1)
    st = ett.SpectralTransform("F24", 47, device="cpu")
    assert st.res is res2
    st.inv_trans(spscalar=sc)
    assert res2._cache
    st.release()
    assert not res2._cache
    assert st.inv_trans(spscalar=sc).shape == g1.shape
    assert ett.get_current is get_current and ett.trans_end is trans_end


def test_setup_banner(capsys, monkeypatch):
    monkeypatch.setenv("ECTRANS_TPU_PRINTLEV", "2")
    assert printlev() == 2
    trans_end()
    ett.setup("O48", 47)
    err = capsys.readouterr().err
    assert "ectrans_tpu_torch 0.1.0: setup T47 ndgl=96" in err
    assert "legendre tables" in err and "nloen: 20..208" in err
    ett.setup("O48", 47)                     # cached: no second banner
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("ECTRANS_TPU_PRINTLEV", "x")
    assert printlev() == 0


def test_not_ported_options_raise(handles, tmp_path):
    _, st = handles
    # mesh= takes a Mesh of parallel.make_mesh and refuses anything else;
    # without a mesh the distributed keys of inquire() are absent
    with pytest.raises(TypeError, match="Mesh from make_mesh"):
        ett.SpectralTransform("O48", 47, mesh=object(), device="cpu")
    assert st._inquire_distributed() == {}
    # and a mesh works: a world of one rank, whose (1, 1) mesh gives the
    # handle's results (fp64, 1e-12 of the largest value)
    sp = [packed(st.res, n, seed) for n, seed in ((1, 11), (1, 12), (2, 13))]
    want = st.inv_trans(*sp, flags=ett.InvFlags(**BENCH))
    with one_rank_world(tmp_path):
        sm = ett.SpectralTransform("O48", 47, mesh=make_mesh(device="cpu"),
                                   dtype=torch.float64)
        got = sm.inv_trans(*[sm.dist_spec(x) for x in sp],
                           flags=ett.InvFlags(**BENCH))
        assert sm.inquire()["nprtrw"] == 1 and sm.device.type == "cpu"
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-12 * want.abs().max().item())
    # the lat-lon methods are ported: the handle's outputs are the
    # function API's
    ll = ett.LatLonGrid(19, 36)
    sp = [packed(st.res, n, seed) for n, seed in ((1, 17), (1, 18), (2, 19))]
    grid = st.inv_trans_latlon(ll, *sp, flags=ett.InvFlags(**BENCH))
    assert torch.equal(grid, ett.inv_trans_latlon(
        st.res, ll, *map(torch.from_numpy, sp),
        flags=ett.InvFlags(**BENCH), dtype=st.dtype))
    fields = [grid[:1], grid[1:2], grid[2:4]]
    assert all(torch.equal(a, b) for a, b in zip(
        st.dir_trans_latlon(ll, *fields),
        ett.dir_trans_latlon(st.res, ll, *fields, dtype=st.dtype)))
    sc = packed(st.res, 1, 15)
    with pytest.raises(ValueError, match="kvset"):
        st.inv_trans(spscalar=sc, kvsetsc=[1])
    g = np.zeros((1, st.res.ndgl, st.res.grid.ndlon))
    with pytest.raises(ValueError, match="kvset"):
        st.dir_trans(scalars=g, kvsetuv=[1])
    with pytest.raises(ValueError, match="precision"):
        ett.SpectralTransform("O48", 47, precision="low", device="cpu")


def test_dist_gath_without_mesh(handles):
    jst, st = handles
    g = np.random.default_rng(16).standard_normal(
        (2, st.res.ndgl, st.res.grid.ndlon))
    d = st.dist_grid(g)
    assert isinstance(d, torch.Tensor) and d.device == st.device
    back = st.gath_grid(d)
    assert isinstance(back, np.ndarray) and np.array_equal(back, g)
    np.testing.assert_array_equal(back, jst.gath_grid(jst.dist_grid(g)))
    s = packed(st.res, 2, 17)
    assert np.array_equal(st.gath_spec(st.dist_spec(s)), s)
