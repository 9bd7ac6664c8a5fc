"""The summation order of the "xla" Legendre engine in fp32
(``legendre_matmul.group_einsum``) against one running fp32 sum, on the
CPU: the card's einsum runs through cuBLAS, whose order a CPU run cannot
reproduce, and the engine's accuracy at TCO1279 rests on the order in which
it adds.

One running fp32 sum over a TCO1279 group's 640-1,280 terms (one fp32
einsum, one cuBLAS accumulation) misses the 100*eps round-trip gate 4.3x on
an H100; the engine multiplies and adds in fp64 and rounds once.  Both
orders are held against an fp64 product over 1,280 terms (TCO1279's largest
latitude count a group): the fp64 order must be within one fp32 rounding
and at least 3x more accurate.  FMA is emulated exactly: the product of two
fp32 values is exact in fp64.  Then ``group_einsum`` itself: the plain
einsum in fp64, the fp64 product rounded once in fp32, bf16 tables upcast.
"""

import numpy as np
import pytest
import torch

from ectrans_tpu_torch.ops import legendre_matmul as lm

F32 = np.float32


def fma(acc, a, b):
    return (acc.astype(np.float64) + a.astype(np.float64) * b).astype(F32)


def running_order(a, b):
    """One running fp32 FMA sum over every term (one fp32 einsum's order)."""
    acc = np.zeros((a.shape[0], b.shape[1]), F32)
    for k in range(a.shape[1]):
        acc = fma(acc, a[:, k, None], b[None, k])
    return acc


def fp64_order(a, b):
    """The engine's order: the exact products added in fp64, rounded once."""
    return (a.astype(np.float64) @ b.astype(np.float64)).astype(F32)


@pytest.mark.parametrize("terms", [1280, 1022])
def test_fp64_order_beats_one_running_sum(terms):
    rng = np.random.default_rng(terms)
    a = rng.standard_normal((48, terms)).astype(F32)
    b = rng.standard_normal((terms, 64)).astype(F32)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    e_run = np.abs(running_order(a, b) - exact).max() / scale
    e_64 = np.abs(fp64_order(a, b) - exact).max() / scale
    assert 0 < e_64 <= np.finfo(F32).eps / 2 and 3 * e_64 <= e_run, (
        e_64, e_run)


@pytest.mark.parametrize("spec, a_shape, b_shape", [
    ("mik,fcmk->fcmi", (3, 7, 45), (2, 2, 3, 45)),     # inverse, 45 degrees
    ("mik,fcmi->fcmk", (3, 70, 5), (2, 2, 3, 70)),     # direct, 70 latitudes
])
def test_group_einsum(spec, a_shape, b_shape):
    rng = np.random.default_rng(7)
    a64 = torch.from_numpy(rng.standard_normal(a_shape))
    b64 = torch.from_numpy(rng.standard_normal(b_shape))
    want = torch.einsum(spec, a64, b64)
    assert torch.equal(lm.group_einsum(spec, a64, b64), want)
    a32, b32 = a64.float(), b64.float()
    got = lm.group_einsum(spec, a32, b32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, torch.einsum(spec, a32.double(),
                                         b32.double()).float())
    a16 = a64.bfloat16()
    assert torch.equal(lm.group_einsum(spec, a16, b32),
                       lm.group_einsum(spec, a16.float(), b32))
