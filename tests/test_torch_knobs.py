"""The table knobs of ectrans_tpu_torch against the JAX package, each set
for both packages (and both packages' caches reset around it, as
``tests/test_tablegen.py`` does): ``ECTRANS_TPU_FP64_TABLE_LIMIT`` (fp32
host tables above it, fp64 transforms still within 1e-12),
``ECTRANS_TPU_LEG_GROUPS`` (the round trip at 3, 12 and 24 groups, the
last past K3's and K4's 16 by-value groups at T47, within 1e-12 in fp64;
the mesh and the lat-lon tables keep the fixed count) and
``ECTRANS_TPU_TABLE_SOURCE`` on the CPU; then ``ini_spec_dist``,
``Resolution.ntmax``, the package exports, and the entry points
(``entry.entry`` against ``__graft_entry__.entry`` at 100 eps(fp32) of
each family's largest |value|, ``dryrun_multichip`` on two CPU ranks)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu import compat4py as jc4
from ectrans_tpu import resolution as jresolution
from ectrans_tpu.transform import InvFlags as JaxInvFlags

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import compat4py, entry, resolution
from ectrans_tpu_torch.ops import legendre_tablegen as tg
from ectrans_tpu_torch.parallel import distribution

BENCH = dict(scders=True, uvders=True)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Both packages set up anew around each test, without the legpol cache
    and with the knobs unset."""
    for k in ("ECTRANS_TPU_LEG_GROUPS", "ECTRANS_TPU_TABLE_SOURCE",
              "ECTRANS_TPU_FP64_TABLE_LIMIT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("ECTRANS_TPU_LEGPOL_DIR", "")
    jresolution.trans_end()
    ett.trans_end()
    yield
    jresolution.trans_end()
    ett.trans_end()


def packed(res, n, seed):
    x = np.random.default_rng(seed).standard_normal((n, res.nspec2))
    x[:, 1: 2 * (res.nsmax + 1): 2] = 0.0
    x[:, 0] = 0.0
    return x


def round_trips(name, nsmax, dtype=torch.float64):
    """bench.py's round trip (2 vor/div pairs, 6 scalars, derivatives) in
    both packages: [(port, jax), ...] for the grid and the three spectra."""
    jres, res = et.setup(name, nsmax), ett.setup(name, nsmax)
    sp = [packed(res, n, seed) for n, seed in ((2, 0), (2, 1), (6, 2))]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jg = np.asarray(et.inv_trans(jres, *(jnp.asarray(x, jdt) for x in sp),
                                 flags=JaxInvFlags(**BENCH), dtype=jdt))
    jout = et.dir_trans(jres, jnp.asarray(jg[:2]), jnp.asarray(jg[2:4]),
                        jnp.asarray(jg[4:10]), dtype=jdt)
    g = ett.inv_trans(res, *(torch.from_numpy(x) for x in sp),
                      flags=ett.InvFlags(**BENCH), dtype=dtype)
    out = ett.dir_trans(res, g[:2], g[2:4], g[4:10], dtype=dtype)
    return [(g, jg)] + [(a, np.asarray(b)) for a, b in zip(out, jout)]


def assert_within(pairs, rel):
    for got, want in pairs:
        err = np.abs(got.double().numpy() - want).max()
        assert err <= rel * np.abs(want).max(), err


# -- ECTRANS_TPU_FP64_TABLE_LIMIT --------------------------------------------

def test_fp64_table_limit(monkeypatch):
    """Limit lowered below T47: fp32 host tables (the JAX package's setup
    tables bit for bit), true fp64 tables for an fp64 transform (which
    stays within 1e-12 of the JAX package's), and get_legendre_assets'
    values fp32-rounded as the JAX package's."""
    monkeypatch.setenv("ECTRANS_TPU_FP64_TABLE_LIMIT", "40")
    jres, res = et.setup("O48", 47), ett.setup("O48", 47)
    assert res.host_table_dtype == np.float32 == jres.psym.dtype
    psym, pasym = res.parity_tables()
    assert psym.dtype == np.float32
    assert np.array_equal(psym, jres.psym) and np.array_equal(pasym,
                                                              jres.pasym)
    p64, _ = res.parity_tables(torch.float64)
    assert p64.dtype == np.float64
    assert np.array_equal(p64, jres.parity_tables("float64")[0])
    # the fp32 tables are the fp64 ones rounded
    assert np.abs(psym - p64).max() <= EPS32 * np.abs(p64).max()
    assert_within(round_trips("O48", 47), 1e-12)
    args = (96, 47, 96, (47 + 2) * (47 + 3) // 2 - 1, res.grid.nloen)
    want = jc4.get_legendre_assets(*args)
    got = compat4py.get_legendre_assets(*args)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(got[2], got[2].astype(np.float32))


def test_fp64_table_limit_default_keeps_fp64():
    res = ett.setup("O48", 47)
    assert resolution.fp64_table_limit() == 800
    assert res.host_table_dtype == np.float64
    assert res.parity_tables()[0].dtype == np.float64


# -- ECTRANS_TPU_LEG_GROUPS --------------------------------------------------

@pytest.mark.parametrize("ngroups", [3, 12, 24])
def test_leg_groups_round_trip_matches_jax(monkeypatch, ngroups):
    monkeypatch.setenv("ECTRANS_TPU_LEG_GROUPS", str(ngroups))
    res, jres = ett.setup("O48", 47), et.setup("O48", 47)
    pairs = round_trips("O48", 47)
    assert len(res.legendre_groups()) == ngroups
    jfl = jres.full_legendre("float64")
    assert [(g.m0, g.m1, g.i0, g.J) for g in jfl.groups] == list(
        res.legendre_groups())
    fl = res.full_legendre(torch.float64)
    assert len(fl.groups) == ngroups
    for g, jg in zip(fl.groups, jfl.groups):
        assert np.array_equal(g.pn.numpy(), np.asarray(jg.pn))
    assert_within(pairs, 1e-12)


def test_table_caches_are_keyed_by_the_knobs(monkeypatch):
    """A knob changed between table builds gets tables of its own, never
    the cached ones of another setting."""
    res = ett.setup("O48", 47)
    counts = []
    for ngroups in ("3", "12"):
        monkeypatch.setenv("ECTRANS_TPU_LEG_GROUPS", ngroups)
        counts.append(len(res.full_legendre(torch.float64).groups))
        counts.append(len(res.grouped_legendre(torch.float64).groups))
    assert counts == [3, 3, 12, 12]
    monkeypatch.setenv("ECTRANS_TPU_TABLE_SOURCE", "device")
    dev = res.full_legendre(torch.float64)
    monkeypatch.setenv("ECTRANS_TPU_TABLE_SOURCE", "host")
    host = res.full_legendre(torch.float64)
    assert dev is not host
    keys = [k for k in res._cache if k[0] == "full_legendre"]
    assert sorted(k[3:] for k in keys) == [(3, "host"), (12, "device"),
                                          (12, "host")]


def test_mesh_and_latlon_keep_the_fixed_groups(monkeypatch):
    res = ett.setup("O48", 47)
    fixed = resolution.default_leg_groups(res.M)
    monkeypatch.setenv("ECTRANS_TPU_LEG_GROUPS", "24")
    assert len(res.legendre_groups()) == 24
    d = distribution.build_distribution(res, 2, 1)
    assert [(g.m0, g.m1) for g in d.groups] == [
        (m0, m1) for m0, m1, _, _ in res.legendre_groups(fixed)]
    from ectrans_tpu_torch.latlon import latlon_groups

    assert len(latlon_groups(res)) == fixed


def test_leg_groups_must_be_positive(monkeypatch):
    monkeypatch.setenv("ECTRANS_TPU_LEG_GROUPS", "0")
    with pytest.raises(ValueError, match="at least 1"):
        resolution.leg_groups(48)


# -- ECTRANS_TPU_TABLE_SOURCE -------------------------------------------------

def test_table_source_on_the_cpu(monkeypatch):
    """"auto" and "host" take the host tables on the CPU, "device" K4's
    plain recurrence (within 1e-11 of the host's fp64 tables; its round
    trip within 1e-10 of the host's); an unknown source raises."""
    res = ett.setup("O48", 47)
    sp = [torch.from_numpy(packed(res, n, s)) for n, s in ((2, 3), (4, 4))]
    out, tables = {}, {}
    for src in ("auto", "host", "device"):
        monkeypatch.setenv("ECTRANS_TPU_TABLE_SOURCE", src)
        g = ett.inv_trans(res, sp[0], sp[0], sp[1], dtype=torch.float64)
        out[src] = torch.cat([g.flatten()] + [
            x.flatten() for x in ett.dir_trans(res, g[:2], g[2:4], g[4:],
                                               dtype=torch.float64)])
        tables[src] = res.full_legendre(torch.float64).groups
    assert torch.equal(out["auto"], out["host"])
    inp = tg._device_inputs(res, torch.device("cpu"))
    scale = max(g.pn.abs().max().item() for g in tables["host"])
    for gd, gh in zip(tables["device"], tables["host"]):
        assert torch.equal(gd.pn, tg.gen_group_plain(
            inp, gd.m0, gd.m1, gd.J, gd.i0, torch.float64))
        assert (gd.pn - gh.pn).abs().max().item() <= 1e-11 * scale
    err = (out["device"] - out["host"]).abs().max()
    assert err <= 1e-10 * out["host"].abs().max()
    monkeypatch.setenv("ECTRANS_TPU_TABLE_SOURCE", "disk")
    with pytest.raises(ValueError, match="table source"):
        res.full_legendre(torch.float32)


def test_host_tables_stream_in_the_table_dtype(monkeypatch):
    """Above the fp64 limit the host route rounds each group from the fp32
    host tables (bf16 from them too, as the JAX package casts at upload),
    and an fp64 table from the fp64 ones."""
    monkeypatch.setenv("ECTRANS_TPU_FP64_TABLE_LIMIT", "40")
    res = ett.setup("O48", 47)
    p32, a32 = res.parity_tables()
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        src = res.parity_tables(dtype)
        fl = res.full_legendre(dtype)
        for g in fl.groups:
            kg = g.J // 2
            want = np.empty((g.m1 - g.m0, g.J, res.ndgnh - g.i0),
                            src[0].dtype)
            want[:, 0::2] = np.swapaxes(src[0][g.m0:g.m1, g.i0:, :kg], 1, 2)
            want[:, 1::2] = np.swapaxes(src[1][g.m0:g.m1, g.i0:, :kg], 1, 2)
            assert g.pn.dtype == dtype
            assert torch.equal(g.pn, torch.from_numpy(want).to(dtype))
    assert res.parity_tables(torch.bfloat16)[0].dtype == np.float32


# -- ini_spec_dist, ntmax, exports ------------------------------------------

def test_ini_spec_dist_matches_jax():
    got = resolution.ini_spec_dist(47, 3)
    want = jresolution.ini_spec_dist(47, 3)
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(np.asarray(got[k], dtype=object),
                              np.asarray(want[k], dtype=object)), k
    # tests/test_api.py's checks
    res = ett.setup("F24", 47)
    assert ett.get_current() is res
    assert sum(got["numpp"]) == 48
    assert sum(got["nspec2"]) == got["nspec2_g"] == res.nspec2
    assert max(got["nspec2"]) - min(got["nspec2"]) <= 2 * 48
    np.testing.assert_array_equal(got["nasm0"], res.nasm0)


def test_ntmax_and_exports():
    res, jres = ett.setup("O48", 47), et.setup("O48", 47)
    assert res.ntmax == jres.ntmax == 47
    for name in ("full_gaussian_grid", "octahedral_grid"):
        assert name in ett.__all__
        a, b = getattr(ett, name)(47, 24), getattr(et, name)(47, 24)
        assert vars(a) == vars(b)


# -- the entry points --------------------------------------------------------

def test_entry_matches_graft_entry():
    """entry() on the CPU against the JAX ``__graft_entry__.entry()``: the
    same inputs bit for bit, the outputs within 100 eps(fp32) of each
    family's largest |value|."""
    import __graft_entry__

    jstep, jargs = __graft_entry__.entry()
    step, args = entry.entry(device="cpu")
    for a, b in zip(args, jargs):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(),
                                                           np.asarray(b))
    got, want = step(*args), jstep(*jargs)
    for a, b in zip(got, want):
        b = np.asarray(b, np.float64)
        err = np.abs(a.double().numpy() - b).max()
        assert err <= 100 * EPS32 * np.abs(b).max(), err


def test_entry_points_need_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multichip(2)


def test_dryrun_multichip_on_cpu_ranks():
    reps = entry.dryrun_multichip(2, device="cpu")
    assert [r["rank"] for r in reps] == [0, 1]
    assert all(r["err"] < 1e-3 and r["lam_err"] < 1e-3 for r in reps)
