"""Spectral layouts of ectrans_tpu_torch against ectrans_tpu: the packed <->
dense gathers (ops.layout) and the compaction into the packed layout from
m-major rows (ops.pack, kernel K3) — bit-exact, since they move values
without arithmetic.  The JAX compaction kernel runs in interpret mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.ops import layout as jlayout, pack_pallas

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.ops import layout, pack


def _rows(res, nfld, seed):
    """Random c-major m-major rows per Legendre group (gm, 2*nfld, J)."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((m1 - m0, 2 * nfld, J)).astype(np.float32)
            for m0, m1, _, J in res.legendre_groups()]


@pytest.mark.parametrize("config", ["T47", "O48"])
@pytest.mark.parametrize("nfld", [1, 10])
def test_pack_rows_matches_jax(config, nfld):
    jres, res = et.setup(config), ett.setup(config)
    rows = _rows(res, nfld, seed=nfld)
    plan = pack_pallas.plan_for(jres)
    assert [(gp.m0, gp.m1) for gp in plan.groups] == [
        (m0, m1) for m0, m1, _, _ in res.legendre_groups()]
    want = np.asarray(pack_pallas.packed_from_group_rows(
        [jnp.asarray(r) for r in rows], plan, interpret=True))
    got = pack.packed_from_group_rows([torch.from_numpy(r) for r in rows], res)
    assert got.shape == (nfld, res.nspec2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("config", ["T47", "O48", "TCO95"])
def test_layouts_match_jax(config):
    jres, res = et.setup(config), ett.setup(config)
    rng = np.random.default_rng(1)
    spec = rng.standard_normal((3, res.nspec2))
    jt = jres.device_tables(jnp.float64)
    dense_j = np.asarray(jlayout.packed_to_dense(jnp.asarray(spec), jt))
    dense = layout.packed_to_dense(torch.from_numpy(spec),
                                   res.device_tables(torch.float64))
    np.testing.assert_array_equal(dense.numpy(), dense_j)
    np.testing.assert_array_equal(
        layout.dense_to_packed(dense, res).numpy(),
        np.asarray(jlayout.dense_to_packed(jnp.asarray(dense_j), jt)))
    np.testing.assert_array_equal(layout.dense_to_packed(dense, res).numpy(),
                                  spec)


def test_pack_rows_is_dense_to_packed():
    """The compaction of realigned rows equals the dense-layout gather."""
    res = ett.setup("O48", 47)
    rng = np.random.default_rng(2)
    nfld = 4
    dense = torch.from_numpy(rng.standard_normal((nfld, 2, res.M, res.NP)))
    from ectrans_tpu_torch.ops.layout import diag_realign

    d2 = diag_realign(dense)                        # (f, c, M, NP+1)
    mm = d2.permute(2, 1, 0, 3).reshape(res.M, 2 * nfld, res.NP + 1)
    rows = [mm[m0:m1, :, :J].contiguous()
            for m0, m1, _, J in res.legendre_groups()]
    np.testing.assert_array_equal(
        pack.packed_from_group_rows(rows, res).numpy(),
        layout.dense_to_packed(dense, res).numpy())


def test_pack_rows_checks_groups():
    res = ett.setup("O48", 47)
    rows = [torch.from_numpy(r) for r in _rows(res, 2, seed=0)]
    with pytest.raises(ValueError, match="groups"):
        pack.packed_from_group_rows(rows[:-1], res)

