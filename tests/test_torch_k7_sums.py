"""The summation order of K7 (``csrc/legendre_dense2.cu``) against K1's, in
an fp32 emulation on the CPU: the CUDA kernels cannot run here, and their
accuracy contract rests on the order in which they add.

K1 (``csrc/legendre_dense.cu``) sums each 32-degree stage as two 16-term
FMA chains (even and odd degrees) and folds each into a TwoSum total; K7
sums 16-degree FMA chains, adds 4 of them in plain fp32 and folds that into
a TwoSum total every 64 degrees.  Both are held against an fp64 product on
the rows the dense engine stacks, [d2 ; d2 sgn], at TCO1279 group 2's J
(1122) with a cut latitude count: K7's largest error must stay within 1.5x
K1's, the bound the card's test (``test_k7_error_within_k1s``) holds the
kernels to, and one running fp32 sum (torch.bmm's order) must be worse.
FMA is emulated exactly: the product of two fp32 values is exact in fp64.
"""

import numpy as np
import pytest

F32 = np.float32
J, IG, FC2 = 1122, 301, 32


def fma(acc, a, b):
    return (acc.astype(np.float64) + a.astype(np.float64) * b).astype(F32)


def two_sum(s, c, x):
    """K1/K7's add_compensated: s + c += x (legendre_common.cuh)."""
    t = (s + x).astype(F32)
    bb = (t - s).astype(F32)
    c = (c + ((s - (t - bb)).astype(F32) + (x - bb).astype(F32))).astype(F32)
    return t, c


def k1_order(d2, pn):
    """north, south stacked: even/odd 16-term chains per 32-degree stage."""
    shape = (d2.shape[0], pn.shape[1])
    ev, od, evc, odc = (np.zeros(shape, F32) for _ in range(4))
    for j0 in range(0, J, 32):
        pe, po = np.zeros(shape, F32), np.zeros(shape, F32)
        for j in range(j0, min(J, j0 + 32), 2):
            pe = fma(pe, d2[:, j, None], pn[None, j])
            po = fma(po, d2[:, j + 1, None], pn[None, j + 1])
        ev, evc = two_sum(ev, evc, pe)
        od, odc = two_sum(od, odc, po)
    e, o = (ev + evc).astype(F32), (od + odc).astype(F32)
    return np.concatenate([(e + o).astype(F32), (e - o).astype(F32)])


def k7_order(d4, pn):
    """16-term chains, 4 added in fp32, one TwoSum fold every 64 degrees."""
    shape = (d4.shape[0], pn.shape[1])
    s, c, held = (np.zeros(shape, F32) for _ in range(3))
    for h in range(0, J, 16):
        part = np.zeros(shape, F32)
        for j in range(h, min(J, h + 16)):
            part = fma(part, d4[:, j, None], pn[None, j])
        held = (held + part).astype(F32)
        if (h // 16) % 4 == 3 or h + 16 >= J:
            s, c = two_sum(s, c, held)
            held = np.zeros(shape, F32)
    return (s + c).astype(F32)


def running_order(d4, pn):
    acc = np.zeros((d4.shape[0], pn.shape[1]), F32)
    for j in range(J):
        acc = fma(acc, d4[:, j, None], pn[None, j])
    return acc


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k7_order_within_k1s(seed):
    rng = np.random.default_rng(seed)
    pn = rng.standard_normal((J, IG)).astype(F32)
    d2 = rng.standard_normal((FC2, J)).astype(F32)
    d4 = np.concatenate([d2, d2 * (1 - 2 * (np.arange(J) & 1)).astype(F32)])
    want = d4.astype(np.float64) @ pn.astype(np.float64)
    e1 = np.abs(k1_order(d2, pn) - want).max()
    e7 = np.abs(k7_order(d4, pn) - want).max()
    e_run = np.abs(running_order(d4, pn) - want).max()
    assert 0 < e7 <= 1.5 * e1, (e7, e1)
    assert e_run > e7, (e_run, e7)
