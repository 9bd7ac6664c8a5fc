"""The hemisphere-packed dense-row kernels K7/K8 (the "dense" engine with
ECTRANS_TPU_LEG_DENSE_PACK) and the dense-layout direct path (the "dense"
engine with ECTRANS_TPU_PACK_KERNEL=xla) of ectrans_tpu_torch against
ectrans_tpu, on the same inputs and tables (convert.resolution_from_numpy).

References: ``legendre_pallas.group_inv_dense2``/``group_dir_dense2`` in
interpret mode at modes "f32" and "bf16" (on bf16 tables both packages
round the same fp32 operands to bf16 and form exact products); the JAX
``legendre_inv_dense``, ``legendre_dir_rows`` and ``legendre_dir_dense``
called unjitted with ECTRANS_TPU_LEG_DENSE_PACK set, since they read it at
call time while the jitted transforms keep the trace of their first call;
end to end, the JAX "dense" engine with the packing off, which computes the
same function (on the CPU its direct transform is the dense-layout path).
Tolerances: kernels 1e-5 of the output's max (fp32 sums in two orders);
layers 5e-6 of the output's max; the round trip as in
test_torch_transform.py (fp32 2e-5 absolute plus 1e-5 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ectrans_tpu.ops import legendre_pallas as jlp

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.ops import legendre_dense as ld

from test_torch_engines import (_fourier_input, _jax_round_trip,
                                _port_round_trip, pair, rel)
from test_torch_transform import assert_close

TABLE = {"f32": (torch.float32, "float32"), "bf16": (torch.bfloat16,
                                                     "bfloat16")}
KNOBS = ("ECTRANS_TPU_LEG_DENSE_PACK", "ECTRANS_TPU_PACK_KERNEL",
         "ECTRANS_TPU_LEG_KERNEL")


@pytest.fixture
def clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_packed_kernels_match_jax(pair, mode):
    """K7/K8 plain versions vs the JAX kernels (interpret), on the first and
    last groups, at the bench's stacked rows (2 x 32 inverse, 2 x 20
    direct)."""
    jres, res = pair
    tdt, jdt = TABLE[mode]
    fl, jfl = res.full_legendre(tdt), jres.full_legendre(jdt)
    rng = np.random.default_rng(60)
    for g, jg in ((fl.groups[0], jfl.groups[0]),
                  (fl.groups[-1], jfl.groups[-1])):
        np.testing.assert_array_equal(g.pn.float().numpy(),
                                      np.asarray(jg.pn, np.float32))
        gm, J, ig = g.pn.shape
        dg = torch.from_numpy(rng.standard_normal((gm, 32, J))
                              .astype(np.float32))
        d4 = torch.cat([dg, dg * ld._jsgn(J, dg)], dim=1)
        got = ld.group_inv_dense2(d4, g.pn)
        assert got.dtype == torch.float32 and got.shape == (gm, 64, ig)
        want = jlp.group_inv_dense2(jnp.asarray(d4.numpy()), jg.pn,
                                    mode=mode, interpret=True)
        assert rel(got.numpy(), want) < 1e-5
        f4 = torch.from_numpy(rng.standard_normal((gm, 40, ig))
                              .astype(np.float32))
        got = ld.group_dir_dense2(f4, g.pn)
        assert got.shape == (gm, 40, J)
        want = jlp.group_dir_dense2(jnp.asarray(f4.numpy()), jg.pn,
                                    mode=mode, interpret=True)
        assert rel(got.numpy(), want) < 1e-5


def test_packed_plain_is_the_two_dot_result():
    """K7 on [d2 ; d2 sgn] gives K1's (north, south); K8's raw dots,
    combined as the dense engine combines them, give K2 (fp64)."""
    rng = np.random.default_rng(61)
    gm, fc2, J, ig = 3, 4, 9, 7
    d2, pn = (torch.from_numpy(rng.standard_normal(s))
              for s in ((gm, fc2, J), (gm, J, ig)))
    o = ld.group_inv_dense2(torch.cat([d2, d2 * ld._jsgn(J, d2)], dim=1), pn)
    for a, b in zip((o[:, :fc2], o[:, fc2:]), ld.group_inv_dense(d2, pn)):
        torch.testing.assert_close(a, b, rtol=1e-14, atol=1e-14)
    fn, fs = (torch.from_numpy(rng.standard_normal((gm, fc2, ig)))
              for _ in range(2))
    raw = ld.group_dir_dense2(torch.cat([fn, fs], dim=1), pn)
    torch.testing.assert_close(raw[:, :fc2] + raw[:, fc2:] * ld._jsgn(J, raw),
                               ld.group_dir_dense(fn, fs, pn), rtol=1e-14,
                               atol=1e-14)


@pytest.mark.parametrize("pack2", [False, True])
def test_dense_layers_match_jax(pair, clean_env, pack2):
    """legendre_inv_dense, legendre_dir_rows and legendre_dir_dense, pack2
    on and off, vs the JAX functions of the same names (mode f32,
    interpret, unjitted with ECTRANS_TPU_LEG_DENSE_PACK set to match)."""
    jres, res = pair
    clean_env.setenv("ECTRANS_TPU_LEG_DENSE_PACK", "1" if pack2 else "0")
    fl, jfl = res.full_legendre(torch.float32), jres.full_legendre("float32")
    rng = np.random.default_rng(62)
    dense = rng.standard_normal((5, 2, res.M, res.NP)).astype(np.float32)
    valid = np.asarray(jres.device_tables(jnp.float32).dense_valid)
    dense *= valid
    want = jlp.legendre_inv_dense(jnp.asarray(dense), jfl, mode="f32",
                                  interpret=True)
    got = ld.legendre_inv_dense(torch.from_numpy(dense), fl, pack2)
    assert rel(got.numpy(), want) < 5e-6
    four = _fourier_input(res, 3, 63, np.float32)
    w = res.w[: res.ndgnh].astype(np.float32)
    want = jlp.legendre_dir_rows(jnp.asarray(four), jfl, jnp.asarray(w),
                                 mode="f32", interpret=True)
    got = ld.legendre_dir_rows(torch.from_numpy(four), fl,
                               torch.from_numpy(w), pack2)
    for a, b in zip(got, want, strict=True):
        assert a.is_contiguous() and rel(a.numpy(), b) < 5e-6
    want = np.asarray(jlp.legendre_dir_dense(jnp.asarray(four), jfl,
                                             jnp.asarray(w), res.NP,
                                             mode="f32", interpret=True))
    got = ld.legendre_dir_dense(torch.from_numpy(four), fl,
                                torch.from_numpy(w), res.NP, pack2).numpy()
    assert got.shape == want.shape == (3, 2, res.M, res.NP)
    assert rel(got[..., valid > 0], want[..., valid > 0]) < 5e-6


@pytest.mark.parametrize("env", [
    {"ECTRANS_TPU_LEG_DENSE_PACK": "1"},
    {"ECTRANS_TPU_PACK_KERNEL": "xla"},
    {"ECTRANS_TPU_LEG_DENSE_PACK": "1", "ECTRANS_TPU_PACK_KERNEL": "xla"}])
def test_round_trip_matches_jax_dense(pair, clean_env, env):
    """The port's "dense" round trip with the hemisphere-packed kernels,
    the dense-layout direct path, or both, vs the JAX "dense" engine (its
    packing off; its CPU direct path is the dense-layout one)."""
    _, res = pair
    sp, gj, outj = _jax_round_trip("dense", "highest", "float32")
    for k, v in env.items():
        clean_env.setenv(k, v)
    gp, outp = _port_round_trip(res, sp, torch.float32, "dense", "highest")
    assert gp.shape[0] == 26
    assert_close(gp.numpy(), gj, torch.float32)
    for a, b in zip(outp, outj, strict=True):
        assert_close(a.numpy(), b, torch.float32)


def test_layers_take_pack2_as_an_argument(pair, clean_env, monkeypatch):
    """The module functions never read ECTRANS_TPU_LEG_DENSE_PACK: with it
    set they still run K1/K2 unless given pack2, and inv_trans reads it."""
    _, res = pair
    clean_env.setenv("ECTRANS_TPU_LEG_DENSE_PACK", "1")
    calls = []
    for name in ("group_inv_dense2", "group_dir_dense2"):
        real = getattr(ld, name)
        monkeypatch.setattr(ld, name, lambda *a, real=real, name=name: (
            calls.append(name), real(*a))[1])
    fl = res.full_legendre(torch.float32)
    dense = torch.from_numpy(np.random.default_rng(64).standard_normal(
        (2, 2, res.M, res.NP)).astype(np.float32))
    four = torch.from_numpy(_fourier_input(res, 2, 65, np.float32))
    w = torch.from_numpy(res.w[: res.ndgnh].astype(np.float32))
    ld.legendre_inv_dense(dense, fl)
    ld.legendre_dir_rows(four, fl, w)
    ld.legendre_dir_dense(four, fl, w, res.NP)
    assert calls == []
    ett.inv_trans(res, spscalar=torch.zeros(1, res.nspec2), _engine="dense")
    assert calls == ["group_inv_dense2"] * len(fl.groups)
