"""NPROMATR packets and FieldLayout of ectrans_tpu_torch against the port's
own single call (fp64, 1e-11 of the output's max, as
tests/test_roundtrip.py holds the JAX packets) and against ectrans_tpu's
packets on the same inputs and tables (convert.resolution_from_numpy),
through the "dense" engine (its plain versions on the CPU) and "xla".
Tolerances against JAX as in test_torch_transform.py: fp64 1e-10 relative
to the output's max; fp32 2e-5 absolute plus 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu.field_layout import FieldLayout as JaxFieldLayout
from ectrans_tpu.transform import InvFlags as JaxInvFlags

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import convert, transform
from ectrans_tpu_torch.field_layout import KIND, FieldLayout

from test_torch_setup import numpy_state
from test_torch_transform import JDT, assert_close, packed

FLAGS = dict(vorgp=True, scders=True, uvders=True)


@pytest.fixture(scope="module")
def pair():
    jres = et.setup("O48", 47)
    return jres, convert.resolution_from_numpy(numpy_state(jres))


def spectra(res):
    return [packed(res, n, seed) for n, seed in ((3, 11), (3, 12), (5, 13))]


def grids(res, seed=14):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, res.ndgl, res.grid.ndlon))
            for n in (3, 3, 5)]


@pytest.mark.parametrize("engine", ["dense", "xla"])
@pytest.mark.parametrize("npromatr", [1, 4, 7])
def test_packets_match_single_call(pair, engine, npromatr):
    """Packets reproduce the single call and its PGP order (fp64, 1e-11 of
    the max): 3 vor/div pairs and 5 scalars split into uv packets of
    npromatr // 2 pairs and scalar packets of npromatr fields."""
    _, res = pair
    sp = [torch.from_numpy(x) for x in spectra(res)]
    kw = dict(flags=ett.InvFlags(**FLAGS), dtype=torch.float64,
              _engine=engine)
    ref = ett.inv_trans(res, *sp, **kw)
    got = ett.inv_trans(res, *sp, npromatr=npromatr, **kw)
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-11 * ref.abs().max()
    gp = [torch.from_numpy(x) for x in grids(res)]
    r = ett.dir_trans(res, *gp, dtype=torch.float64, _engine=engine)
    g = ett.dir_trans(res, *gp, dtype=torch.float64, npromatr=npromatr,
                      _engine=engine)
    for a, b in zip(g, r):
        assert a.shape == b.shape
        assert (a - b).abs().max() <= 1e-11 * b.abs().max()


@pytest.mark.parametrize("engine", ["dense", "xla"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_packets_match_jax(pair, engine, dtype):
    """The port's packets (npromatr=4: 3 pairs in 2 uv packets of 2 pairs,
    5 scalars in 2 packets of 4, the last of each zero-padded) against the
    JAX package's packets."""
    jres, res = pair
    jdt = JDT[dtype]
    sp = spectra(res)
    jgrid = et.inv_trans(jres, *[jnp.asarray(x, jdt) for x in sp],
                         flags=JaxInvFlags(**FLAGS), dtype=jdt, npromatr=4)
    grid = ett.inv_trans(res, *[torch.from_numpy(x) for x in sp],
                         flags=ett.InvFlags(**FLAGS), dtype=dtype,
                         npromatr=4, _engine=engine)
    assert grid.dtype == dtype
    assert_close(grid.numpy(), np.asarray(jgrid), dtype)
    gp = grids(res)
    jout = et.dir_trans(jres, *[jnp.asarray(x, jdt) for x in gp], dtype=jdt,
                        npromatr=4)
    out = ett.dir_trans(res, *[torch.from_numpy(x) for x in gp], dtype=dtype,
                        npromatr=4, _engine=engine)
    for a, b in zip(out, jout):
        assert_close(a.numpy(), np.asarray(b), dtype)


@pytest.mark.parametrize("nuv,nsc", [(3, 0), (0, 5), (1, 1)])
def test_packets_one_family(pair, nuv, nsc):
    """Runs of one family, and runs that fit one call, match the single
    call."""
    _, res = pair
    vor, div, sc = (torch.from_numpy(x) for x in spectra(res))
    args = (vor[:nuv] if nuv else None, div[:nuv] if nuv else None,
            sc[:nsc] if nsc else None)
    kw = dict(flags=ett.InvFlags(**FLAGS), dtype=torch.float64)
    ref = ett.inv_trans(res, *args, **kw)
    got = ett.inv_trans(res, *args, npromatr=2, **kw)
    assert (got - ref).abs().max() <= 1e-11 * ref.abs().max()


def test_packets_have_one_shape(pair, monkeypatch):
    """Every packet of a kind calls the transform with the same field count
    (the last one zero-padded), so it launches the same kernel shapes."""
    _, res = pair
    seen = []
    inner = transform.fourier.synthesis_bucketed

    def spy(four, *args):
        seen.append(four.shape[0])
        return inner(four, *args)

    monkeypatch.setattr(transform.fourier, "synthesis_bucketed", spy)
    vor, div, sc = (torch.from_numpy(x) for x in spectra(res))
    ett.inv_trans(res, vor, div, sc, flags=ett.InvFlags(**FLAGS),
                  dtype=torch.float64, npromatr=4)
    # uv packets: 2 pairs -> vor, u, v, ewu, ewv; scalar packets: 4 -> 12
    assert seen == [10, 10, 12, 12]


def test_chunk_pad():
    x = torch.arange(5.0)[:, None]
    chunks = list(transform._chunk_pad(x, 2))
    assert [real for _, real in chunks] == [2, 2, 1]
    assert all(c.shape == (2, 1) for c, _ in chunks)
    assert chunks[-1][0].flatten().tolist() == [4.0, 0.0]


LAYOUTS = [
    (2, 3, dict(), None, None),
    (2, 3, dict(vorgp=True, divgp=True, scders=True, uvders=True), None,
     None),
    (1, 0, dict(uvders=True), 4, None),
    (0, 5, dict(scders=True), None, 8),
    (3, 2, dict(vorgp=True, scders=True), 4, 3),
]


@pytest.mark.parametrize("nuv,nsc,flags,pad_uv,pad_sc", LAYOUTS)
def test_field_layout_matches_jax(nuv, nsc, flags, pad_uv, pad_sc):
    """Groups, sizes, split, strip_index and kvset_index as the JAX
    package's FieldLayout gives them."""
    fl = FieldLayout.inv(nuv, nsc, ett.InvFlags(**flags), pad_uv, pad_sc)
    jfl = JaxFieldLayout.inv(nuv, nsc, JaxInvFlags(**flags), pad_uv, pad_sc)
    assert fl.groups == jfl.groups
    assert (fl.names, fl.sizes_padded, fl.total_real, fl.total_padded) == (
        jfl.names, jfl.sizes_padded, jfl.total_real, jfl.total_padded)
    x = np.arange(fl.total_padded)
    got, want = fl.split(x), jfl.split(x)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    a, b = fl.strip_index(), jfl.strip_index()
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a, b)
    nslots_uv, nslots_sc = pad_uv or nuv, pad_sc or nsc
    pos_uv = {i: (i * 3) % max(1, nslots_uv) for i in range(nuv)}
    pos_sc = {i: nslots_sc - 1 - i for i in range(nsc)}
    np.testing.assert_array_equal(
        fl.kvset_index(pos_uv, pos_sc, nslots_uv, nslots_sc),
        jfl.kvset_index(pos_uv, pos_sc, nslots_uv, nslots_sc))
    assert set(KIND) >= set(fl.names)
