"""Distributed LAM transforms of ``ectrans_tpu_torch.lam.sharded`` on the
CPU: one world of 4 spawned ranks (gloo, ``torch_world``) runs the cases;
the tests hold each rank's shard against ``ectrans_tpu.lam.sharded.
ShardedLamTransform`` on the same (w, v) mesh of virtual CPU devices and
against the port's single-device transform, in fp64 within 1e-12 of the
largest value: both directions with the mean wind and the derivative
flags on (2, 2) and (4, 1), and scalars alone.  The ranks import neither
jax nor ectrans_tpu.
"""

import numpy as np
import pytest
import torch

from torch_world import World

GRID = (48, 40)
MESHES = [(2, 2), (4, 1)]
NUV, NSC = 2, 3
MEAN = (np.array([0.5, -1.0]), np.array([2.0, 0.25]))
TOL = 1e-12


def random_packed(res, nfld, seed):
    """tests/test_lam_sharded.py's physical-field mask."""
    rng = np.random.default_rng(seed)
    spec = rng.standard_normal((nfld, res.nspec2))
    pm, pn, pc = (np.asarray(a) for a in (res.packed_m, res.packed_n,
                                          res.packed_c))
    spec[:, ((pm == 0) & (pc >= 2)) | ((pn == 0) & (pc % 2 == 1))] = 0.0
    return spec


def inputs(res):
    spvor, spdiv = random_packed(res, NUV, 1), random_packed(res, NUV, 2)
    for s in (spvor, spdiv):
        s[:, 0:4] = 0.0
    return spvor, spdiv, random_packed(res, NSC, 3)


def single():
    import ectrans_tpu_torch as ett

    return ett.LamTransform(*GRID, dtype=torch.float64, device="cpu")


def _rank(rank):
    """Both directions on each mesh and scalars alone on (2, 2): this
    rank's shards."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.lam import LamInvFlags
    from ectrans_tpu_torch.parallel import make_mesh

    out = {}
    ref = single()
    flags = LamInvFlags(scders=True, uvders=True)
    spvor, spdiv, spsc = inputs(ref.res)
    g = ref.inv_trans(spvor, spdiv, spsc, *MEAN, flags=flags)
    u, v, sc = g[:NUV], g[NUV: 2 * NUV], g[2 * NUV: 2 * NUV + NSC]
    for w, vv in MESHES:
        lt = ett.LamTransform(*GRID, mesh=make_mesh(w, vv, device="cpu"),
                              dtype=torch.float64)
        loc = [lt.dist_spec(x) for x in (spvor, spdiv, spsc) + MEAN]
        out["inv", w, vv] = lt.inv_trans(*loc, flags=flags)
        out["dir", w, vv] = lt.dir_trans(*[lt.dist_grid(x)
                                           for x in (u, v, sc)])
        if (w, vv) == (2, 2):
            s = random_packed(ref.res, 5, 9)
            gs = lt.inv_trans(spscalar=lt.dist_spec(s))
            out["sc_only"] = (gs, lt.dir_trans(scalars=gs)[2],
                              lt.gath_grid(gs), lt.gath_spec(
                                  lt.dir_trans(scalars=gs)[2]))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    w = World(_rank, tmp_path_factory.mktemp("lam_sharded"), limit=180)
    yield w
    w.stop()


def jax_sharded(w, v):
    import jax.numpy as jnp

    from ectrans_tpu.lam import make_lam_grid, setup_lam
    from ectrans_tpu.lam.sharded import ShardedLamTransform
    from ectrans_tpu.parallel import make_mesh

    return ShardedLamTransform(setup_lam(make_lam_grid(*GRID)),
                               make_mesh(w, v), dtype=jnp.float64)


def rows(r, w, v, ny):
    R = -(-ny // (w * v))
    return slice(min(r * R, ny), min((r + 1) * R, ny))


def fields(n, v, iv):
    c = max(1, -(-n // v))
    return [i for i in range(n) if min(i // c, v - 1) == iv]


def close(got, want, scale) -> bool:
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return got.shape == want.shape and (
        not got.size or np.abs(got - want).max() <= TOL * scale)


@pytest.mark.parametrize("w,v", MESHES)
def test_lam_sharded_matches_jax_and_single(world, w, v):
    from ectrans_tpu.lam import LamInvFlags as JFlags

    from ectrans_tpu_torch.lam import LamInvFlags

    st = jax_sharded(w, v)
    spvor, spdiv, spsc = inputs(st.res)
    ref = np.asarray(st.inv_trans(spvor, spdiv, spsc, *MEAN,
                                  flags=JFlags(scders=True, uvders=True)))
    one = single()
    g1 = one.inv_trans(spvor, spdiv, spsc, *MEAN,
                       flags=LamInvFlags(scders=True, uvders=True)).numpy()
    u, vv, sc = g1[:NUV], g1[NUV: 2 * NUV], g1[2 * NUV: 2 * NUV + NSC]
    dref = [np.asarray(x) for x in st.dir_trans(u, vv, sc)]
    d1 = [x.numpy() for x in one.dir_trans(u, vv, sc)]
    res = world.results()
    ny = GRID[1]
    scale = np.abs(ref).max()
    for r in range(4):
        blk = rows(r, w, v, ny)
        got = res[r]["inv", w, v]
        assert close(got, ref[:, blk], scale), r
        assert close(got, g1[:, blk], scale), r
        for k, (a, b, c) in enumerate(zip(res[r]["dir", w, v], dref, d1)):
            own = fields(b.shape[0], v, r % v)
            s = np.abs(b).max()
            assert close(a, b[own], s) and close(a, c[own], s), (r, k)


def test_lam_sharded_scalars_only(world):
    from ectrans_tpu.lam import dir_trans_lam, inv_trans_lam

    import jax.numpy as jnp

    st = jax_sharded(2, 2)
    s = random_packed(st.res, 5, 9)
    ref = np.asarray(inv_trans_lam(st.res, spscalar=jnp.asarray(s),
                                   dtype=jnp.float64))
    rs = np.asarray(dir_trans_lam(st.res, scalars=jnp.asarray(ref),
                                  dtype=jnp.float64)[2])
    res = world.results()
    for r in range(4):
        g, spec, G, S = res[r]["sc_only"]
        assert close(g, ref[:, rows(r, 2, 2, GRID[1])], np.abs(ref).max())
        assert close(spec, rs[fields(5, 2, r % 2)], np.abs(rs).max())
        assert close(G, ref, np.abs(ref).max())
        assert close(S, rs, np.abs(rs).max())
