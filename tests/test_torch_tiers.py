"""The precision tiers "high" and "bf16" on the "dense", "xla" and "pallas"
engines of ectrans_tpu_torch against ectrans_tpu, on the same inputs and
host tables (convert.resolution_from_numpy).

"bf16" stores the tables in bfloat16 (``transform._table_dtype``, as the JAX
package's): "dense" and "pallas" round the fp32 operands to bf16 and sum
exact products, as the JAX kernels' mode "bf16" does; "xla" upcasts the
tables for its einsums, as the JAX "xla" engine does on the CPU.  "high"
is served by the "highest" arithmetic.  References and tolerances:

* tables: bitwise equal to the JAX package's bf16 tables;
* layers ("dense" K1/K2 and "pallas" K5/K6 plain versions on bf16 tables)
  vs the JAX Pallas layers at mode "bf16" in interpret mode: 5e-6 of the
  output's max (the same products, summed in two orders);
* round trips: "dense" vs JAX "dense" and "xla" vs JAX "xla", both at
  "bf16": the grid and the "xla" outputs as in test_torch_transform.py
  (fp32 2e-5 absolute plus 1e-5 relative); the "dense" direct outputs at
  1e-3 of their max, because the two packages' Fourier analyses differ in
  the last fp32 bits and a coefficient can round to the neighbouring bf16
  value (2^-8 of itself, a hundredth of the tier's own error).  "pallas"
  vs JAX "xla" (the JAX "pallas" engine cannot run on the CPU) is
  cross-arithmetic and is held to the tier's 1e6*eps gate on each output;
* fp64: the tiers resolve as in the JAX package (fp64 tables, so the
  "highest" arithmetic), held against the JAX "xla" engine at 1e-10.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ectrans_tpu import transform as jtransform
from ectrans_tpu.ops import legendre_pallas as jlp

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import transform
from ectrans_tpu_torch.ops import legendre_dense as ld
from ectrans_tpu_torch.ops import legendre_grouped as lg

from test_torch_engines import (_fourier_input, _jax_round_trip,
                                _parity_inputs, _port_round_trip, pair, rel)
from test_torch_transform import assert_close, packed

EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture
def clean_env(monkeypatch):
    for k in ("ECTRANS_TPU_LEG_KERNEL", "ECTRANS_TPU_LEG_DENSE_PACK",
              "ECTRANS_TPU_PACK_KERNEL"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def bits(t) -> np.ndarray:
    return np.asarray(t, np.float32) if not isinstance(t, torch.Tensor) \
        else t.float().numpy()


def test_bf16_tables_match_jax(pair):
    """Both packages round the same fp64 host tables to bf16."""
    jres, res = pair
    fl, jfl = res.full_legendre(torch.bfloat16), jres.full_legendre(
        "bfloat16")
    for g, jg in zip(fl.groups, jfl.groups, strict=True):
        assert g.pn.dtype == torch.bfloat16 and jg.pn.dtype == jnp.bfloat16
        np.testing.assert_array_equal(bits(g.pn), bits(jg.pn))
    gl, jgl = res.grouped_legendre(torch.bfloat16), jres.grouped_legendre(
        "bfloat16")
    for g, jg in zip(gl.groups, jgl.groups, strict=True):
        # views of rows zero-padded to a multiple of 4 entries (K5, K6)
        ldk = -(-g.kg // 4) * 4
        for a, b in ((g.psym, jg.psym), (g.pasym, jg.pasym)):
            assert a.dtype == torch.bfloat16
            assert a.stride() == (a.shape[1] * ldk, ldk, 1)
            np.testing.assert_array_equal(bits(a), bits(b))


def test_bf16_layers_match_jax(pair):
    """The "dense" (K1, K2) and "pallas" (K5, K6) layers on bf16 tables vs
    the JAX layers at mode "bf16" (interpret)."""
    jres, res = pair
    fl, jfl = res.full_legendre(torch.bfloat16), jres.full_legendre(
        "bfloat16")
    gl, jgl = res.grouped_legendre(torch.bfloat16), jres.grouped_legendre(
        "bfloat16")
    rng = np.random.default_rng(70)
    dense = rng.standard_normal((4, 2, res.M, res.NP)).astype(np.float32)
    dense *= np.asarray(jres.device_tables(jnp.float32).dense_valid)
    got = ld.legendre_inv_dense(torch.from_numpy(dense), fl)
    assert got.dtype == torch.float32
    assert rel(got.numpy(), jlp.legendre_inv_dense(
        jnp.asarray(dense), jfl, mode="bf16", interpret=True)) < 5e-6
    four = _fourier_input(res, 3, 71, np.float32)
    w = res.w[: res.ndgnh].astype(np.float32)
    for a, b in zip(ld.legendre_dir_rows(torch.from_numpy(four), fl,
                                         torch.from_numpy(w)),
                    jlp.legendre_dir_rows(jnp.asarray(four), jfl,
                                          jnp.asarray(w), mode="bf16",
                                          interpret=True), strict=True):
        assert rel(a.numpy(), b) < 5e-6
    sym, asym = _parity_inputs(res, 4, 72, np.float32)
    got = lg.legendre_inv_grouped(torch.from_numpy(sym),
                                  torch.from_numpy(asym), gl)
    assert rel(got.numpy(), jlp.legendre_inv_grouped(
        jnp.asarray(sym), jnp.asarray(asym), jgl, mode="bf16",
        interpret=True)) < 5e-6
    for a, b in zip(lg.legendre_dir_grouped(torch.from_numpy(four), gl,
                                            torch.from_numpy(w)),
                    jlp.legendre_dir_grouped(jnp.asarray(four), jgl,
                                             jnp.asarray(w), mode="bf16",
                                             interpret=True), strict=True):
        assert rel(a.numpy(), b) < 5e-6


@pytest.mark.parametrize("engine", ["dense", "xla"])
def test_round_trip_bf16_matches_jax(pair, clean_env, engine):
    """The same engine at "bf16" in both packages."""
    _, res = pair
    sp, gj, outj = _jax_round_trip(engine, "bf16", "float32")
    gp, outp = _port_round_trip(res, sp, torch.float32, engine, "bf16")
    assert gp.dtype == torch.float32
    assert_close(gp.numpy(), gj, torch.float32)
    for a, b in zip(outp, outj, strict=True):
        if engine == "dense":
            assert rel(a.numpy(), b) <= 1e-3
        else:
            assert_close(a.numpy(), b, torch.float32)


def test_round_trip_pallas_bf16_within_tier_gate(pair, clean_env):
    """"pallas" at "bf16" vs the JAX "xla" engine at "bf16": every output
    within 1e6*eps of its max (the tier's gate)."""
    _, res = pair
    sp, gj, outj = _jax_round_trip("xla", "bf16", "float32")
    gp, outp = _port_round_trip(res, sp, torch.float32, "pallas", "bf16")
    for a, b in [(gp.numpy(), gj)] + [(x.numpy(), y)
                                      for x, y in zip(outp, outj)]:
        assert np.abs(a - b).max() <= 1e6 * EPS32 * np.abs(b).max()


@pytest.mark.parametrize("engine", ["dense", "xla", "pallas"])
def test_high_is_highest(pair, clean_env, engine):
    """"high" runs the "highest" arithmetic: the same bits."""
    _, res = pair
    sp = [packed(res, n, seed).astype(np.float32)
          for n, seed in ((2, 73), (2, 74), (6, 75))]
    g1, out1 = _port_round_trip(res, sp, torch.float32, engine, "highest")
    g2, out2 = _port_round_trip(res, sp, torch.float32, engine, "high")
    assert torch.equal(g1, g2)
    for a, b in zip(out1, out2, strict=True):
        assert torch.equal(a, b)


def test_tier_resolution_follows_jax():
    """Table dtype per (working dtype, tier) and the engine per (engine,
    dtype) as the JAX package's _table_dtype and _resolve_engine."""
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}
    for dtype in (torch.float32, torch.float64):
        for tier in ("highest", "high", "bf16"):
            assert str(transform._table_dtype(dtype, tier))[6:] == \
                jtransform._table_dtype(jdt[dtype], tier)
        for eng in ("dense", "xla", "pallas", "planes"):
            assert transform._resolve_engine(eng, dtype) == \
                jtransform._resolve_engine(eng, jdt[dtype])


@pytest.mark.parametrize("engine", ["dense", "xla", "pallas"])
def test_fp64_bf16_matches_jax(pair, clean_env, engine):
    """fp64 at "bf16" keeps fp64 tables: the port's result is its "highest"
    bit for bit and the JAX "xla" engine's at "bf16" to 1e-10."""
    _, res = pair
    sp, gj, outj = _jax_round_trip("xla", "bf16", "float64")
    gp, outp = _port_round_trip(res, sp, torch.float64, engine, "bf16")
    g1, out1 = _port_round_trip(res, sp, torch.float64, engine, "highest")
    assert torch.equal(gp, g1)
    assert_close(gp.numpy(), gj, torch.float64)
    for a, b, c in zip(outp, outj, out1, strict=True):
        assert torch.equal(a, c)
        assert_close(a.numpy(), b, torch.float64)


def test_unknown_tier_raises(pair):
    _, res = pair
    with pytest.raises(ValueError, match="precision"):
        ett.inv_trans(res, spscalar=torch.zeros(1, res.nspec2),
                      precision="fp8")
