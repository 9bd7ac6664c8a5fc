"""The "planes" Legendre engine of ectrans_tpu_torch against ectrans_tpu
on the same inputs and tables (convert.resolution_from_numpy): the limb
split, the derived planes, kernels K9/K10 through the plain versions that
CPU tensors take, the engine's layer, its tiers, and the bench round trip.

References: ``ectrans_tpu.ops.legendre_planes`` with its Pallas kernels in
interpret mode; for the round trip, the JAX package with
ECTRANS_TPU_LEG_KERNEL=planes and ECTRANS_TPU_PACK_KERNEL=force (its
packing kernel in interpret mode).  Tolerances: kernels and layer 5e-6
relative to the output's max (fp32 sums in two orders; at 3 planes the
port keeps the limb products the JAX kernels drop, 2^-24 of a product
each); the round trip as in test_torch_transform.py (fp32 2e-5 absolute
plus 1e-5 relative), except the "bf16" tier's direct outputs (see
test_round_trip_planes_matches_jax); splits and planes bitwise.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ectrans_tpu.ops import legendre_planes as jplanes

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import transform
from ectrans_tpu_torch.ops import legendre_matmul as lm
from ectrans_tpu_torch.ops import legendre_planes as lp

from test_torch_engines import (_fourier_input, _jax_round_trip,
                                _port_round_trip, pair, rel, small)
from test_torch_transform import assert_close, packed


def to_jax_bf16(t: torch.Tensor):
    """A bf16 torch tensor as the identical JAX bf16 array."""
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("nplanes", [3, 1])
def test_split_planes_matches_jax(nplanes):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(500),
        10.0 ** rng.uniform(-30, 3, 500) * np.sign(rng.standard_normal(500)),
        [0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38],
    ]).astype(np.float32)     # no subnormals: XLA's CPU backend flushes them
    got = lp.split_planes(torch.from_numpy(x), nplanes)
    want = jplanes.split_planes(jnp.asarray(x), nplanes)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    if nplanes == 3:
        # three limbs are an exact split: K9/K10 sum them before multiplying
        total = (got[0].float() + got[1].float()) + got[2].float()
        np.testing.assert_array_equal(total.numpy(), x)


@pytest.mark.parametrize("nplanes", [3, 1])
def test_planes_tables_match_jax(pair, nplanes):
    jres, res = pair
    jppl = jres.planes_legendre(nplanes)
    ppl = res.planes_legendre(nplanes)
    for g, jg in zip(ppl.groups, jppl.groups, strict=True):
        assert (g.m0, g.m1, g.i0, g.J) == (jg.m0, jg.m1, jg.i0, jg.J)
        assert len(g.pt) == len(jg.pt) == nplanes
        for a, b in zip(g.pt, jg.pt):
            assert a.dtype == torch.bfloat16 and a.is_contiguous()
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))



@pytest.mark.parametrize("nplanes", [3, 1])
def test_planes_kernels_match_jax(small, nplanes):
    """K9/K10 plain versions vs legendre_planes.group_inv_planes /
    group_dir_planes (interpret) on identical bf16 operands, every group;
    the operand packing is bitwise the JAX package's."""
    jres, res = small
    ppl, jppl = res.planes_legendre(nplanes), jres.planes_legendre(nplanes)
    rng = np.random.default_rng(30 + nplanes)
    for g, jg in zip(ppl.groups, jppl.groups, strict=True):
        gm, ig = g.m1 - g.m0, res.ndgnh - g.i0
        dg = rng.standard_normal((gm, 6, g.J)).astype(np.float32)
        a = lp._pack_inv_rows(torch.from_numpy(dg), nplanes)
        np.testing.assert_array_equal(
            a.float().numpy(), np.asarray(jplanes._pack_inv_rows(
                jnp.asarray(dg), nplanes), np.float32))
        got = lp.group_inv_planes(a, g.pt, nplanes, 6)
        want = jplanes.group_inv_planes(to_jax_bf16(a), jg.pt, nplanes, 6,
                                        interpret=True)
        for x, y in zip(got, want, strict=True):
            assert x.dtype == torch.float32 and rel(x.numpy(), y) < 5e-6
        fn, fs = (rng.standard_normal((gm, 4, ig)).astype(np.float32)
                  for _ in range(2))
        wr = lp._pack_dir_rows(torch.from_numpy(fn), torch.from_numpy(fs),
                               nplanes)
        got = lp.group_dir_planes(wr, g.pt, nplanes, 4)
        want = jplanes.group_dir_planes(to_jax_bf16(wr), jg.pt, nplanes, 4,
                                        interpret=True)
        assert got.dtype == torch.float32 and rel(got.numpy(), want) < 5e-6


@pytest.mark.parametrize("nplanes", [3, 1])
def test_planes_layer_matches_jax(small, nplanes):
    """legendre_inv_planes, legendre_dir_rows_planes and
    legendre_dir_planes vs the JAX package's (interpret): 5e-6 relative."""
    jres, res = small
    ppl, jppl = res.planes_legendre(nplanes), jres.planes_legendre(nplanes)
    rng = np.random.default_rng(40 + nplanes)
    dense = rng.standard_normal((5, 2, res.M, res.NP)).astype(np.float32)
    dense *= np.asarray(jres.device_tables(jnp.float32).dense_valid)
    want = jplanes.legendre_inv_planes(jnp.asarray(dense), jppl, nplanes,
                                       interpret=True)
    got = lp.legendre_inv_planes(torch.from_numpy(dense), ppl, nplanes)
    assert rel(got.numpy(), want) < 5e-6
    four = _fourier_input(res, 3, 50 + nplanes, np.float32)
    w = res.w[: res.ndgnh].astype(np.float32)
    want = jplanes.legendre_dir_rows_planes(jnp.asarray(four), jppl,
                                            jnp.asarray(w), nplanes,
                                            interpret=True)
    got = lp.legendre_dir_rows_planes(torch.from_numpy(four), ppl,
                                      torch.from_numpy(w), nplanes)
    for a, b in zip(got, want, strict=True):
        assert rel(a.numpy(), b) < 5e-6
    valid = np.asarray(jres.device_tables(jnp.float32).dense_valid) > 0
    want = jplanes.legendre_dir_planes(jnp.asarray(four), jppl,
                                       jnp.asarray(w), res.NP, nplanes,
                                       interpret=True)
    got = lm.dir_planes(torch.from_numpy(four), ppl, torch.from_numpy(w),
                        res.NP, {3: "highest", 1: "bf16"}[nplanes])
    assert rel(got.numpy()[..., valid], np.asarray(want)[..., valid]) < 5e-6


def test_tiers_per_engine(pair, monkeypatch):
    _, res = pair
    monkeypatch.delenv("ECTRANS_TPU_LEG_KERNEL", raising=False)
    sc = torch.from_numpy(packed(res, 2, 9).astype(np.float32))
    for eng in ("dense", "xla", "pallas"):
        for tier in ("high", "bf16"):
            with pytest.raises(NotImplementedError, match="queue A item 3"):
                ett.inv_trans(res, spscalar=sc, precision=tier, _engine=eng)
    highest = ett.inv_trans(res, spscalar=sc, _engine="planes")
    torch.testing.assert_close(
        ett.inv_trans(res, spscalar=sc, precision="high", _engine="planes"),
        highest, rtol=0, atol=0)
    bf16 = ett.inv_trans(res, spscalar=sc, precision="bf16", _engine="planes")
    err = (bf16 - highest).abs().max() / highest.abs().max()
    assert 1e-5 < err < 1e6 * torch.finfo(torch.float32).eps
    # fp64 on "planes" is the "xla" engine
    assert transform._resolve_engine("planes", torch.float64) == "xla"
    sc64 = sc.double()
    torch.testing.assert_close(
        ett.inv_trans(res, spscalar=sc64, dtype=torch.float64,
                      _engine="planes"),
        ett.inv_trans(res, spscalar=sc64, dtype=torch.float64, _engine="xla"),
        rtol=0, atol=0)


@pytest.mark.parametrize("precision", ["highest", "bf16"])
def test_round_trip_planes_matches_jax(pair, monkeypatch, precision):
    """At "bf16" the direct outputs are held at 1e-3 of their max: the two
    packages' Fourier analyses differ in the last fp32 bits, so a Fourier
    coefficient can round to the neighbouring bf16 value (2^-8 of
    itself).  That is a hundredth of the tier's own error (~3e-2 of the
    max on vor/div at O48)."""
    _, res = pair
    monkeypatch.setenv("ECTRANS_TPU_LEG_KERNEL", "planes")
    monkeypatch.setenv("ECTRANS_TPU_PACK_KERNEL", "force")
    sp, gj, outj = _jax_round_trip("planes", precision, "float32")
    gp, outp = _port_round_trip(res, sp, torch.float32, "planes", precision)
    assert gp.dtype == torch.float32 and gp.shape[0] == 26
    assert_close(gp.numpy(), gj, torch.float32)
    for a, b in zip(outp, outj, strict=True):
        if precision == "bf16":
            assert rel(a.numpy(), b) <= 1e-3
        else:
            assert_close(a.numpy(), b, torch.float32)
