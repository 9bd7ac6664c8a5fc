"""Distributed transforms of ``ectrans_tpu_torch.parallel`` on the CPU.

One world of 4 spawned ranks (gloo) runs every case of this module once
(``_rank``, a module-scoped fixture); the tests read its results and hold
them, shard by shard, against ``ectrans_tpu.parallel.ShardedTransform`` on
the same (w, v) mesh of the 8 virtual CPU devices of ``conftest.py`` and
against the port's single-device transform:

* decomposition invariance on (1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
  (1, 4) (meshes of fewer than 4 ranks on subgroups): inverse (F24, O48)
  and direct (O48) in fp64 within 1e-12 of the largest value, and every
  pair of meshes within 1e-13 (the JAX package's waiver,
  ``tests/test_sharded.py``), with the chirp-z Fourier buckets of each
  rank's slots (up to 6 a rank, LLW // 16);
* the fp32 round trip; "dense" (the plain K1/K2/K3 on the CPU) against
  "xla" within 100 eps; the bf16 tier; scalar-only and uv-only calls;
  fp64 running "xla"; KVSET ownership and NPROMATR packets; the lat-lon
  output; FSPGL; ``inquire()``'s distributed keys; dist/gath round trips;
  the tiled all_to_all against ``jax.lax.all_to_all``; ``make_mesh``'s
  refusals.

The ranks import neither jax nor ectrans_tpu: the tests import them inside
their bodies.  The world has a time limit of its own (``torch_world``).
"""

import os

import numpy as np
import pytest
import torch

from torch_world import World

MESHES = [(1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4)]
ALL = dict(vorgp=True, divgp=True, scders=True, uvders=True)
BENCH = dict(scders=True, uvders=True)
# kvsetuv, kvsetsc of the inverse (2 uv, 3 scalar fields) and of the
# direct transform (3 uv, 2 scalar fields), by mesh: unbalanced, scrambled
KVSETS = {(1, 4): (([3, 0], [2, 2, 0]), ([3, 0, 3], [2, 0])),
          (1, 2): (([1, 0], [1, 1, 0]), ([1, 0, 1], [0, 0]))}
A2A = [(0, 1), (1, 0), (0, 2), (2, 1), (1, 2)]   # (split, concat) axes
A2A_SHAPE = (8, 4, 12)
LL = (19, 36)
EPS32 = float(np.finfo(np.float32).eps)


def spectra(res, nuv, nsc, seed):
    """Random packed spectra (tests/test_sharded.py's _random_state)."""
    rng = np.random.default_rng(seed)
    n0 = 2 * (res.nsmax + 1)

    def rp(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1:n0:2] = 0.0
        return x

    vor, div, sc = rp(nuv), rp(nuv), rp(nsc)
    vor[:, 0] = 0.0
    div[:, 0] = 0.0
    return vor, div, sc


def grids(res, seed=1):
    """Random grids: 3 u, 3 v, 2 scalars (tests/test_sharded.py)."""
    rng = np.random.default_rng(seed)
    shape = (res.ndgl, res.grid.ndlon)
    return (rng.standard_normal((3,) + shape),
            rng.standard_normal((3,) + shape),
            rng.standard_normal((2,) + shape))


def a2a_input(rank):
    return (torch.arange(np.prod(A2A_SHAPE), dtype=torch.float64)
            .reshape(A2A_SHAPE) + 1000.0 * rank)


def _rank(rank):
    """Every case of the module on this rank: {key: this rank's shard}."""
    import torch.distributed as dist

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.parallel import comm, make_mesh

    os.environ.pop("ECTRANS_TPU_LEG_KERNEL", None)
    out = {}
    groups = {n: dist.new_group(list(range(n))) for n in (1, 2)}
    groups[4] = None

    def mesh(w, v):
        return make_mesh(w, v, group=groups[w * v], device="cpu")

    def handle(grid, w, v, **kw):
        return ett.SpectralTransform(grid, mesh=mesh(w, v), **kw)

    f64 = dict(dtype=torch.float64)
    # decomposition invariance, fp64 (the "xla" engine)
    for w, v in MESHES:
        if rank >= w * v:
            continue
        for grid in ("F24", "O48"):
            st = handle(grid, w, v, **f64)
            out["eng64", w, v] = st._sharded.eng
            out["nb", grid, w, v] = len(st._sharded.fourier.buckets)
            vor, div, sc = spectra(st.res, 2, 3, 0)
            out["inv", grid, w, v] = st.inv_trans(
                *[st.dist_spec(x) for x in (vor, div, sc)],
                flags=ett.InvFlags(**ALL))
        u, vv, sg = grids(st.res)
        out["dir", w, v] = st.dir_trans(*[st.dist_grid(x)
                                          for x in (u, vv, sg)])
    # "dense" against "xla" in fp32, and the fp32 round trip
    for eng in ("dense", "xla"):
        os.environ["ECTRANS_TPU_LEG_KERNEL"] = eng
        for w, v in ((2, 1), (1, 2), (2, 2)):
            if rank >= w * v:
                continue
            st = handle("O48", w, v)
            out["eng32", eng, w, v] = st._sharded.eng
            vor, div, sc = spectra(st.res, 2, 3, 2)
            g = st.inv_trans(*[st.dist_spec(x) for x in (vor, div, sc)],
                             flags=ett.InvFlags(**BENCH))
            out["inv32", eng, w, v] = g
            out["dir32", eng, w, v] = st.dir_trans(g[:2], g[2:4], g[4:7])
            if eng == "dense" and (w, v) == (2, 2):
                # the "dense" packing through the masked gather
                os.environ["ECTRANS_TPU_PACK_KERNEL"] = "xla"
                out["dir32_gather"] = st.dir_trans(g[:2], g[2:4], g[4:7])
                os.environ.pop("ECTRANS_TPU_PACK_KERNEL")
    os.environ.pop("ECTRANS_TPU_LEG_KERNEL")
    # (2, 2): the bf16 tier, scalar-only and uv-only calls, the lat-lon
    # output, FSPGL, KVSET and packets, inquire, dist/gath
    st = handle("O48", 2, 2, precision="bf16")
    out["bf16_table"] = st._sharded.legendre.groups[0].pn.dtype
    _, _, sc = spectra(st.res, 0, 3, 6)
    g = st.inv_trans(spscalar=st.dist_spec(sc))
    out["bf16"] = (g, st.dir_trans(scalars=g)[2])
    st = handle("O48", 2, 2)
    vor, div, sc = spectra(st.res, 2, 3, 7)
    g = st.inv_trans(spscalar=st.dist_spec(sc), flags=ett.InvFlags(**BENCH))
    out["sc_only"] = (g, st.dir_trans(scalars=g[:3])[2])
    g = st.inv_trans(st.dist_spec(vor), st.dist_spec(div),
                     flags=ett.InvFlags(**BENCH))
    out["uv_only"] = (g, st.dir_trans(g[:2], g[2:4])[:2])
    st = handle("O48", 2, 2, **f64)
    vor, div, sc = spectra(st.res, 2, 3, 8)
    loc = [st.dist_spec(x) for x in (vor, div, sc)]
    out["latlon"] = st.inv_trans_latlon(ett.LatLonGrid(*LL), *loc,
                                        flags=ett.InvFlags(**BENCH))
    plain = st.inv_trans(*loc, flags=ett.InvFlags(**BENCH))
    out["fspgl"] = (plain, st.inv_trans(*loc, flags=ett.InvFlags(**BENCH),
                                        fspgl_proc=lambda f: 2.0 * f))
    out["inquire", 2, 2] = st.inquire()
    out["gath"] = (st.gath_spec(loc[2]), st.gath_grid(plain))
    for w, v in ((4, 1), (1, 4)):
        out["inquire", w, v] = handle("O48", w, v, **f64).inquire()
    for (w, v), ((iuv, isc), (duv, dsc)) in KVSETS.items():
        if rank >= w * v:
            continue
        st = handle("O48", w, v, **f64)
        vor, div, sc = spectra(st.res, 2, 3, 0)
        flags = ett.InvFlags(**ALL)
        g = st.inv_trans(st.dist_spec(vor, iuv), st.dist_spec(div, iuv),
                         st.dist_spec(sc, isc), flags=flags,
                         kvsetuv=iuv, kvsetsc=isc)
        pk = st.inv_trans(*[st.dist_spec(x) for x in (vor, div, sc)],
                          flags=flags, npromatr=4)
        blk = [st.dist_grid(x) for x in grids(st.res)]
        d_kv = st.dir_trans(*blk, kvsetuv=duv, kvsetsc=dsc)
        d_pk = st.dir_trans(*blk, npromatr=4)
        out["kvset", w, v] = dict(
            inv=g, packets=pk,
            dir_kv=[st.gath_spec(x, k) for x, k in zip(d_kv, (duv, duv, dsc))],
            dir_pk=[st.gath_spec(x) for x in d_pk],
            spec=st.gath_spec(st.dist_spec(sc, isc), isc))
    # the tiled all_to_all over the world and over the (2, 2) lines
    m = mesh(2, 2)
    x = a2a_input(rank)
    for s, c in A2A:
        out["a2a", s, c] = comm.all_to_all(x, dist.group.WORLD, s, c)
        out["a2a_w", s, c] = comm.all_to_all(x, m.w_group, s, c)
    # make_mesh refuses a wrong w * v
    errors = []
    for args in ((3, 1, None), (2, 2, groups[2])):
        try:
            make_mesh(args[0], args[1], group=args[2], device="cpu")
        except ValueError as e:
            errors.append(str(e))
    out["refusals"] = errors
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(_rank, tmp_path_factory.mktemp("sharded"), limit=240)
    yield w
    w.stop()


_JAX = {}
_REF = {}


def jax_sharded(grid, w, v):
    """The JAX package's ShardedTransform in fp64 on the first w*v
    virtual devices (cached: each compiles its programs once)."""
    import jax.numpy as jnp

    import ectrans_tpu as et
    from ectrans_tpu.parallel import ShardedTransform, make_mesh

    key = (grid, w, v)
    if key not in _JAX:
        _JAX[key] = ShardedTransform(et.setup(grid), make_mesh(w, v),
                                     dtype=jnp.float64)
    return _JAX[key]


def jax_inv(grid, w, v):
    """The JAX package's sharded inverse of ``spectra(res, 2, 3, 0)`` with
    every flag, fp64 (cached)."""
    import jax.numpy as jnp

    import ectrans_tpu as et

    key = ("inv", grid, w, v)
    if key not in _REF:
        st = jax_sharded(grid, w, v)
        vor, div, sc = spectra(st.res, 2, 3, 0)
        _REF[key] = np.asarray(st.inv_trans(
            jnp.asarray(vor), jnp.asarray(div), jnp.asarray(sc),
            et.InvFlags(**ALL)))
    return _REF[key]


def jax_dir(w, v):
    """The JAX package's sharded direct transform of ``grids`` at O48,
    fp64 (cached)."""
    import jax.numpy as jnp

    key = ("dir", w, v)
    if key not in _REF:
        st = jax_sharded("O48", w, v)
        _REF[key] = [np.asarray(x) for x in st.dir_trans(
            *[jnp.asarray(x) for x in grids(st.res)])]
    return _REF[key]


def blocks(grid, w, v):
    """Each mesh rank's pole-to-pole row block [first, end)."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.parallel import build_distribution

    d = build_distribution(ett.setup(grid), w, v)
    return [d.grid_block(r) for r in range(w * v)]


def spec_blocks(n, v, kv=None):
    """Each v-rank's fields (the default blocks unless ``kv``)."""
    from ectrans_tpu_torch.parallel.sharded import default_kvset

    kv = default_kvset(n, v) if kv is None else kv
    return [[i for i, s in enumerate(kv) if s == iv] for iv in range(v)]


def assemble_grid(res, shards, grid, w, v):
    """The global grid from the mesh ranks' row blocks (which must tile
    it)."""
    bl = blocks(grid, w, v)
    assert [s.shape[1] for s in shards] == [e - f for f, e in bl]
    return np.concatenate([s.numpy() for s in shards], axis=1)


def rel(a, b, scale=None):
    """max |a - b| over max |b| (or over ``scale``); 0 for empty shards."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        raise AssertionError(f"shapes {a.shape} and {b.shape}")
    if not a.size:
        return 0.0
    return np.abs(a - b).max() / (np.abs(b).max() if scale is None
                                  else scale)


def port_single(grid, dtype=torch.float64, **kw):
    import ectrans_tpu_torch as ett

    return ett.SpectralTransform(grid, dtype=dtype, device="cpu", **kw)


@pytest.mark.parametrize("w,v", MESHES)
@pytest.mark.parametrize("grid", ["F24", "O48"])
def test_inv_decomposition_invariance(world, grid, w, v):
    import ectrans_tpu_torch as ett

    ref = jax_inv(grid, w, v)
    vor, div, sc = spectra(ett.setup(grid), 2, 3, 0)
    single = port_single(grid).inv_trans(
        vor, div, sc, flags=ett.InvFlags(**ALL)).numpy()
    res = world.results()
    shards = [res[r]["inv", grid, w, v] for r in range(w * v)]
    for r, ((f, e), s) in enumerate(zip(blocks(grid, w, v), shards)):
        scale = np.abs(ref).max()
        assert np.abs(s.numpy() - ref[:, f:e]).max() / scale < 1e-12, r
        assert np.abs(s.numpy() - single[:, f:e]).max() / scale < 1e-12, r
    assert assemble_grid(res, shards, grid, w, v).shape == ref.shape


@pytest.mark.parametrize("w,v", MESHES)
def test_dir_decomposition_invariance(world, w, v):
    import ectrans_tpu_torch as ett

    ref = jax_dir(w, v)
    single = [x.numpy() for x in port_single("O48").dir_trans(
        *grids(ett.setup("O48")))]
    res = world.results()
    for r in range(w * v):
        got = res[r]["dir", w, v]
        for fam, (g, a, b) in enumerate(zip(got, ref, single)):
            own = spec_blocks(a.shape[0], v)[r % v]
            scale = np.abs(a).max()
            assert rel(g.numpy(), a[own], scale) < 1e-12, (r, fam)
            assert rel(g.numpy(), b[own], scale) < 1e-12, (r, fam)


def test_fourier_buckets_on_ranks(world):
    """The decomposition-invariance runs above ran nb = min(12, LLW // 16)
    chirp-z buckets on every rank: several where a rank has 32 or more
    latitude slots."""
    res = world.results()
    want = {("O48", 1, 1): 6, ("O48", 2, 1): 3, ("O48", 1, 2): 6,
            ("O48", 2, 2): 3, ("O48", 4, 1): 1, ("F24", 1, 1): 3,
            ("F24", 2, 2): 1}
    for (grid, w, v), nb in want.items():
        assert all(res[r]["nb", grid, w, v] == nb for r in range(w * v)), (
            grid, w, v)


def test_cross_mesh_max_delta(world):
    """Every pair of meshes within 1e-13 relative in fp64 (the JAX
    package's waiver: summation order follows the decomposition)."""
    res = world.results()
    outs = []
    for w, v in MESHES:
        g = assemble_grid(res, [res[r]["inv", "O48", w, v]
                                for r in range(w * v)], "O48", w, v)
        d = [np.concatenate([res[r]["dir", w, v][k].numpy()
                             for r in range(v)]) for k in range(3)]
        outs.append((g, d))
    sg = max(np.abs(g).max() for g, _ in outs)
    sd = max(np.abs(x).max() for _, d in outs for x in d)
    worst = 0.0
    for i, (ga, da) in enumerate(outs):
        for gb, db in outs[i + 1:]:
            worst = max(worst, np.abs(ga - gb).max() / sg,
                        max(np.abs(a - b).max() for a, b in zip(da, db)) / sd)
    assert worst < 1e-13, worst


def test_sharded_roundtrip_fp32(world):
    """fp32 round trip on (2, 2) through "dense" at the reference's
    single-precision tolerance (tests/test_sharded.py)."""
    import ectrans_tpu_torch as ett

    vor, div, sc = spectra(ett.setup("O48"), 2, 3, 2)
    res = world.results()
    for r in range(4):
        sv, sd, ss = res[r]["dir32", "dense", 2, 2]
        own_uv, own_sc = spec_blocks(2, 2)[r % 2], spec_blocks(3, 2)[r % 2]
        for got, want in ((sv, vor[own_uv]), (sd, div[own_uv]),
                          (ss, sc[own_sc])):
            assert np.abs(got.numpy() - want).max() < 2e-5


@pytest.mark.parametrize("w,v", [(2, 1), (1, 2), (2, 2)])
def test_sharded_dense_matches_xla(world, w, v):
    """"dense" (K1/K2 on the rank's rows and K3 before the sum, their
    plain versions on the CPU) against "xla" on the same mesh, within
    100 eps of the largest value (tests/test_sharded_dense.py)."""
    res = world.results()
    for r in range(w * v):
        assert res[r]["eng32", "dense", w, v] == "dense"
        assert res[r]["eng32", "xla", w, v] == "xla"
        a, b = res[r]["inv32", "dense", w, v], res[r]["inv32", "xla", w, v]
        assert rel(a.numpy(), b.numpy()) < 100 * EPS32
        for x, y in zip(res[r]["dir32", "dense", w, v],
                        res[r]["dir32", "xla", w, v]):
            assert rel(x.numpy(), y.numpy()) < 100 * EPS32


def test_sharded_dense_packing_paths_agree(world):
    """ECTRANS_TPU_PACK_KERNEL=xla packs the "dense" engine's rows by the
    masked gather of packed_j instead of K3: both copy the same values."""
    res = world.results()
    for r in range(4):
        for a, b in zip(res[r]["dir32_gather"],
                        res[r]["dir32", "dense", 2, 2]):
            assert torch.equal(a, b)


def test_sharded_bf16_tier(world):
    """precision="bf16" on (2, 2): bf16 rows of the tables, the round trip
    within the relaxed gate (1e6 eps), and the single device's bf16 tier
    within 100 eps of the largest value."""
    import ectrans_tpu_torch as ett

    res = world.results()
    _, _, sc = spectra(ett.setup("O48"), 0, 3, 6)
    st = port_single("O48", torch.float32, precision="bf16")
    g1 = st.inv_trans(spscalar=sc).numpy()
    s1 = st.dir_trans(scalars=torch.from_numpy(g1))[2].numpy()
    bl = blocks("O48", 2, 2)
    for r in range(4):
        assert res[r]["bf16_table"] == torch.bfloat16
        g, ss = res[r]["bf16"]
        own = spec_blocks(3, 2)[r % 2]
        assert np.abs(ss.numpy() - sc[own]).max() < 1e6 * EPS32 * \
            np.abs(sc).max()
        assert rel(g.numpy(), g1[:, bl[r][0]:bl[r][1]]) < 100 * EPS32
        assert np.abs(ss.numpy() - s1[own]).max() < 100 * EPS32 * \
            np.abs(s1).max()


def test_scalar_only_and_uv_only(world):
    """Calls with scalars alone and with winds alone on (2, 2), fp32
    "dense", against the single device within 100 eps."""
    import ectrans_tpu_torch as ett

    res = world.results()
    vor, div, sc = spectra(ett.setup("O48"), 2, 3, 7)
    st = port_single("O48", torch.float32)
    flags = ett.InvFlags(**BENCH)
    gs = st.inv_trans(spscalar=sc, flags=flags)
    ss = st.dir_trans(scalars=gs[:3])[2]
    gu = st.inv_trans(vor, div, flags=flags)
    su = st.dir_trans(gu[:2], gu[2:4])[:2]
    bl = blocks("O48", 2, 2)
    for r in range(4):
        f, e = bl[r]
        g, s = res[r]["sc_only"]
        assert rel(g.numpy(), gs[:, f:e].numpy()) < 100 * EPS32
        assert rel(s.numpy(), ss[spec_blocks(3, 2)[r % 2]].numpy()) < \
            100 * EPS32
        g, (sv, sd) = res[r]["uv_only"]
        assert g.shape[0] == 4 + 4          # u, v, ewu, ewv
        assert rel(g.numpy(), gu[:, f:e].numpy()) < 100 * EPS32
        own = spec_blocks(2, 2)[r % 2]
        for a, b in ((sv, su[0]), (sd, su[1])):
            assert rel(a.numpy(), b[own].numpy()) < 100 * EPS32


def test_fp64_runs_xla(world):
    """fp64 runs the grouped einsums whatever the engine (the kernels'
    fp32 and bf16 tables cannot carry it), as in the JAX package."""
    res = world.results()
    for w, v in MESHES:
        for r in range(w * v):
            assert res[r]["eng64", w, v] == "xla"


@pytest.mark.parametrize("w,v", [(1, 4), (1, 2)])
def test_kvset_and_packets(world, w, v):
    """KVSETUV/KVSETSC ownership (unbalanced, scrambled) and npromatr=4
    packets on the mesh against the JAX package's sharded transforms of
    the same fields, fp64 within 1e-12 (its own tests hold its KVSET calls
    to its plain ones)."""
    import ectrans_tpu_torch as ett

    ref, dref = jax_inv("O48", w, v), jax_dir(w, v)
    _, _, sc = spectra(ett.setup("O48"), 2, 3, 0)
    res = world.results()
    for r, (f, e) in enumerate(blocks("O48", w, v)):
        got = res[r]["kvset", w, v]
        assert rel(got["inv"].numpy(), ref[:, f:e]) < 1e-12
        assert rel(got["packets"].numpy(), ref[:, f:e]) < 1e-12
        for a, b in zip(got["dir_kv"] + got["dir_pk"], dref + dref):
            assert rel(a, b) < 1e-12
        assert np.array_equal(got["spec"], sc)


def test_latlon_on_mesh(world):
    """inv_trans_latlon on (2, 2): each rank's block of lat-lon rows
    against the JAX package's sharded lat-lon output and the single
    device, fp64 within 1e-12."""
    import jax.numpy as jnp

    import ectrans_tpu as et
    from ectrans_tpu.latlon import LatLonGrid

    import ectrans_tpu_torch as ett

    st = jax_sharded("O48", 2, 2)
    vor, div, sc = spectra(st.res, 2, 3, 8)
    ref = np.asarray(st.inv_trans_latlon(
        LatLonGrid(*LL), jnp.asarray(vor), jnp.asarray(div),
        jnp.asarray(sc), flags=et.InvFlags(**BENCH)))
    single = port_single("O48").inv_trans_latlon(
        ett.LatLonGrid(*LL), vor, div, sc,
        flags=ett.InvFlags(**BENCH)).numpy()
    res = world.results()
    R = -(-LL[0] // 4)
    got = np.concatenate([res[r]["latlon"].numpy() for r in range(4)], 1)
    assert got.shape == ref.shape
    assert [res[r]["latlon"].shape[1] for r in range(4)] == \
        [min(R, LL[0] - r * R) for r in range(4)]
    assert rel(got, ref) < 1e-12 and rel(got, single) < 1e-12


def test_fspgl_on_mesh(world):
    """fspgl_proc sees the rank's Fourier rows; a linear hook scales the
    output."""
    res = world.results()
    for r in range(4):
        plain, hooked = res[r]["fspgl"]
        torch.testing.assert_close(hooked, 2.0 * plain, rtol=0, atol=0)


@pytest.mark.parametrize("w,v", [(2, 2), (4, 1), (1, 4)])
def test_inquire_distributed(world, w, v):
    """The distributed keys of inquire() are the JAX package's."""
    import jax.numpy as jnp

    from ectrans_tpu.api import SpectralTransform
    from ectrans_tpu.parallel import make_mesh

    want = SpectralTransform("O48", mesh=make_mesh(w, v),
                             dtype=jnp.float64)._inquire_distributed()
    got = world.results()[0]["inquire", w, v]
    assert set(want) <= set(got)
    for k, val in want.items():
        if k == "myms_w":
            assert all(np.array_equal(a, b) for a, b in zip(got[k], val))
        else:
            assert np.array_equal(np.asarray(got[k]), np.asarray(val)), k


def test_dist_gath_roundtrips(world):
    """dist_spec -> gath_spec and dist_grid -> inv -> gath_grid give the
    global arrays on every rank (with and without KVSET)."""
    import ectrans_tpu_torch as ett

    vor, div, sc = spectra(ett.setup("O48"), 2, 3, 8)
    st = port_single("O48")
    want = st.inv_trans(vor, div, sc,
                        flags=ett.InvFlags(**BENCH)).numpy()
    res = world.results()
    for r in range(4):
        spec, grid = res[r]["gath"]
        assert np.array_equal(spec, sc)
        assert rel(grid, want) < 1e-12


@pytest.mark.parametrize("split,concat", A2A)
def test_tiled_all_to_all_matches_jax(world, split, concat):
    """comm.all_to_all over the 4 ranks and over the w-lines of (2, 2)
    against jax.lax.all_to_all(tiled=True) on the same arrays."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    def jax_a2a(xs, devices):
        n = len(devices)
        fn = jax.shard_map(
            lambda x: jax.lax.all_to_all(x[0], "x", split, concat,
                                         tiled=True)[None],
            mesh=Mesh(np.asarray(devices), ("x",)), in_specs=P("x"),
            out_specs=P("x"))
        out = np.asarray(fn(jnp.stack([jnp.asarray(x) for x in xs])))
        return [out[k] for k in range(n)]

    devs = jax.devices()
    res = world.results()
    xs = [a2a_input(r).numpy() for r in range(4)]
    want = jax_a2a(xs, devs[:4])
    for r in range(4):
        assert np.array_equal(res[r]["a2a", split, concat].numpy(), want[r])
    # w-lines of (2, 2): ranks (0, 2) and (1, 3)
    for line in ((0, 2), (1, 3)):
        want = jax_a2a([xs[r] for r in line], devs[:2])
        for k, r in enumerate(line):
            assert np.array_equal(res[r]["a2a_w", split, concat].numpy(),
                                  want[k])


def test_make_mesh_refusals(world):
    """make_mesh refuses a missing process group, a w * v that is not the
    group's size, and a 2 x 2 mesh on a group of 2; a handle refuses an
    object that is not a mesh."""
    import torch.distributed as dist

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2, 2, device="cpu")
    with pytest.raises(TypeError, match="Mesh from make_mesh"):
        ett.SpectralTransform("O48", mesh=(2, 2), device="cpu")
    errors = world.results()[0]["refusals"]
    assert len(errors) == 2
    assert "3 x 1 mesh needs 3 ranks" in errors[0]
    assert "2 x 2 mesh needs 4 ranks" in errors[1]
