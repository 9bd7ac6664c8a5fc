"""ectrans_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card (K1-K4 and the whole slice), marked ``cuda``: they skip without a
CUDA card.  This file imports neither jax nor ectrans_tpu, so it also runs
where those are not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: K1/K2 5e-6 (fp32) / 1e-12 (fp64) relative to the output's max;
K4 1e-7 of the table scale; K3 bit-exact; the slice as in
test_torch_transform.py (fp64 1e-10 relative, fp32 2e-5 + 1e-5 relative).
"""

import numpy as np
import pytest
import torch

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.ops import legendre_dense as ld
from ectrans_tpu_torch.ops import legendre_tablegen as tg
from ectrans_tpu_torch.ops import pack

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
LT_TOL = {torch.float32: 5e-6, torch.float64: 1e-12}
SLICE_TOL = {torch.float64: (0.0, 1e-10), torch.float32: (2e-5, 1e-5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions: bmm
    return torch.device("cuda", torch.cuda.current_device())


def packed(res, n, seed):
    x = np.random.default_rng(seed).standard_normal((n, res.nspec2))
    x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0
    x[:, 0] = 0.0
    return x


def round_trip(res, sp, dtype, device):
    grid = ett.inv_trans(res, *(torch.as_tensor(x, device=device) for x in sp),
                         flags=ett.InvFlags(scders=True, uvders=True),
                         dtype=dtype)
    return grid, ett.dir_trans(res, grid[:2], grid[2:4], grid[4:10],
                               dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_tablegen_kernel_matches_plain(dev, dtype):
    res = ett.setup("O160", 159)
    inp = tg._device_inputs(res, dev)
    for m0, m1, i0, J in res.legendre_groups():
        got = tg.gen_group(inp, m0, m1, J, i0, dtype)
        want = tg.gen_group_plain(inp, m0, m1, J, i0, dtype)
        assert got.shape == want.shape and got.dtype == dtype
        assert (got - want).abs().max().item() <= 1e-7 * max(
            1.0, want.abs().max().item())


@pytest.mark.parametrize("dtype", DTYPES)
def test_legendre_kernels_match_plain(dev, dtype):
    res = ett.setup("O160", 159)
    fl = res.full_legendre(dtype, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for grp in fl.groups:
        gm, J, ig = grp.pn.shape
        d2 = torch.randn(gm, 40, J, generator=g, device=dev, dtype=dtype)
        for a, b in zip(ld.group_inv_dense(d2, grp.pn),
                        ld.group_inv_dense_plain(d2, grp.pn)):
            assert (a - b).abs().max() <= LT_TOL[dtype] * b.abs().max()
        fn, fs = (torch.randn(gm, 12, ig, generator=g, device=dev,
                              dtype=dtype) for _ in range(2))
        a = ld.group_dir_dense(fn, fs, grp.pn)
        b = ld.group_dir_dense_plain(fn, fs, grp.pn)
        assert (a - b).abs().max() <= LT_TOL[dtype] * b.abs().max()


@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_kernel_matches_plain(dev, dtype):
    res = ett.setup("O160", 159)
    g = torch.Generator(device=dev).manual_seed(1)
    rows = [torch.randn(m1 - m0, 20, J, generator=g, device=dev, dtype=dtype)
            for m0, m1, _, J in res.legendre_groups()]
    assert torch.equal(pack.packed_from_group_rows(rows, res),
                       pack.packed_from_group_rows_plain(rows, res))


@pytest.mark.parametrize("dtype", DTYPES)
def test_slice_on_card_matches_cpu(dev, dtype):
    """The kernel path on the card vs the plain path on the CPU in fp64."""
    res = ett.setup("O48", 47)
    sp = [packed(res, n, seed) for n, seed in ((2, 0), (2, 1), (6, 2))]
    g0, out0 = round_trip(res, sp, torch.float64, "cpu")
    g1, out1 = round_trip(res, sp, dtype, dev)
    atol, rtol = SLICE_TOL[dtype]
    for a, b in [(g1, g0)] + list(zip(out1, out0)):
        assert a.device == dev and a.dtype == dtype
        err = (a.cpu().double() - b).abs().max().item()
        assert err <= atol + rtol * b.abs().max().item()


def test_round_trip_launches_every_kernel(dev):
    counters = [ld.group_inv_dense, ld.group_dir_dense,
                pack.packed_from_group_rows, tg.gen_group]
    for c in counters:
        c.launches = 0
    res = ett.setup("O48", 47)
    sp = [packed(res, n, seed) for n, seed in ((2, 3), (2, 4), (6, 5))]
    round_trip(res, sp, torch.float32, dev)
    ngroups = len(res.legendre_groups())
    assert [c.launches for c in counters] == [ngroups] * 4


def test_wrappers_reject_bad_operands(dev):
    pn = torch.zeros(2, 6, 5, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        ld.group_inv_dense(torch.zeros(2, 6, 4, device=dev).transpose(1, 2),
                           pn)
    with pytest.raises(TypeError, match="dtype"):
        ld.group_inv_dense(torch.zeros(2, 4, 6, device=dev), pn.double())
    with pytest.raises(ValueError, match="shape"):
        ld.group_dir_dense(torch.zeros(2, 4, 5, device=dev),
                           torch.zeros(2, 4, 4, device=dev), pn)
    with pytest.raises(ValueError, match="device"):
        ld.group_inv_dense(torch.zeros(2, 4, 6, device=dev), pn.cpu())
