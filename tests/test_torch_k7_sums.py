"""The summation orders of the pipelined dense-row Legendre kernels K1, K7
(``csrc/legendre_dense2.cu``), K2 and K8 (``csrc/legendre_dense2_dir.cu``)
against a fixed yardstick, the order of the template K1 and K2 that the
port's first kernels used, in an fp32 emulation on the CPU: the CUDA kernels
cannot run here, and their accuracy contract rests on the order in which
they add.

The yardstick (``template_k1_order``, ``template_k2_order``): the template
K1 sums each 32-degree stage as two 16-term FMA chains (even and odd
degrees) and folds each into a TwoSum total; the template K2 rounds fn +- fs
to fp32 and sums each 32-latitude stage as one FMA chain folded into a
TwoSum total.  The redesigned kernels sum 16-term FMA chains, add nch of
them in plain fp32 and fold that into a TwoSum total every 16 nch terms
(``packed_sums``): K7 and K8 over all their terms with nch 4, K1 over each
parity's degrees apart (north = E + O, south = E - O) and K2 over the
latitudes of fn + fs (even degrees) or fn - fs (odd ones) with nch 2; a K8
or K2 block of two sub-blocks sums each half of the latitudes so and adds
the halves' totals by TwoSum.
Each is held against an fp64 product: K1 and K7 at TCO1279 group 2's J
(1122) with a cut latitude count, K7 on the rows the dense engine stacks,
[d2 ; d2 sgn]; K2 and K8 at TCO1279 group 0's ig (1280) with J cut to 48,
K8 on [fn ; fs] combined as the dense engine combines its raw dots, a + b
sgn.  Each error must stay within 1.5x the yardstick's, the bound the card's
tests (``test_k1_error_within_template`` .. ``test_k8_error_within_k2s``)
hold the kernels to, and one running fp32 sum (torch.bmm's order) must be
worse.  FMA is emulated exactly: the product of two fp32 values is exact in
fp64.
"""

import numpy as np
import pytest

F32 = np.float32


def fma(acc, a, b):
    return (acc.astype(np.float64) + a.astype(np.float64) * b).astype(F32)


def two_sum(s, c, x):
    """The kernels' add_compensated: s + c += x (legendre_common.cuh)."""
    t = (s + x).astype(F32)
    bb = (t - s).astype(F32)
    c = (c + ((s - (t - bb)).astype(F32) + (x - bb).astype(F32))).astype(F32)
    return t, c


def sgn(n):
    return (1 - 2 * (np.arange(n) & 1)).astype(F32)


def template_k1_order(d2, pn):
    """The yardstick, the template K1's order: north, south stacked;
    even/odd 16-term chains per 32-degree stage, each folded by TwoSum."""
    J = pn.shape[0]
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


def template_k2_order(fn, fs, pn):
    """The yardstick, the template K2's order: rows fn +- fs rounded to fp32
    (+ for even degrees), one 32-term chain per 32-latitude stage folded into
    a TwoSum total."""
    J, ig = pn.shape
    x = (fn[:, None] + sgn(J)[None, :, None] * fs[:, None]).astype(F32)
    s, c = (np.zeros((fn.shape[0], J), F32) for _ in range(2))
    for i0 in range(0, ig, 32):
        part = np.zeros_like(s)
        for i in range(i0, min(ig, i0 + 32)):
            part = fma(part, x[:, :, i], pn[None, :, i])
        s, c = two_sum(s, c, part)
    return (s + c).astype(F32)


def packed_sums(a, b, nch=4):
    """The redesigned kernels' a @ b as (sum, compensation): 16-term chains,
    nch added in fp32, one TwoSum fold every 16 nch terms."""
    n = a.shape[1]
    shape = (a.shape[0], b.shape[1])
    s, c, held = (np.zeros(shape, F32) for _ in range(3))
    for h in range(0, n, 16):
        part = np.zeros(shape, F32)
        for t in range(h, min(n, h + 16)):
            part = fma(part, a[:, t, None], b[None, t])
        held = (held + part).astype(F32)
        if (h // 16) % nch == nch - 1 or h + 16 >= n:
            s, c = two_sum(s, c, held)
            held = np.zeros(shape, F32)
    return s, c


def packed_order(a, b, split=1, nch=4):
    """packed_sums; with split, K8's order when a block splits the terms
    among sub-blocks at 32-term stages: each sub-block's own sums, added to
    the first's by TwoSum, the compensations plainly."""
    ns = -(-a.shape[1] // 32)
    cuts = [32 * (k * ns // split) for k in range(split + 1)]
    s, c = packed_sums(a[:, :cuts[1]], b[:cuts[1]], nch)
    for lo, hi in zip(cuts[1:], cuts[2:]):
        sk, ck = packed_sums(a[:, lo:hi], b[lo:hi], nch)
        s, c = two_sum(s, c, sk)
        c = (c + ck).astype(F32)
    return (s + c).astype(F32)


def k1_order(d2, pn):
    """K1's order: north, south stacked from E and O, each the packed sums
    (nch 2) of one parity's degrees (a 32-degree stage holds a 16-term chain
    of each)."""
    e = packed_order(d2[:, 0::2], pn[0::2], nch=2)
    o = packed_order(d2[:, 1::2], pn[1::2], nch=2)
    return np.concatenate([(e + o).astype(F32), (e - o).astype(F32)])


def k2_order(fn, fs, pn, split=1):
    """K2's order: the packed sums (nch 2) of s = fn + fs (even degrees) or
    d = fn - fs (odd ones), each rounded to fp32, over the latitudes; with
    split, a block's two sub-blocks' halves added by TwoSum."""
    J = pn.shape[0]
    even = (np.arange(J) & 1) == 0
    s = packed_order((fn + fs).astype(F32), pn.T, split, nch=2)
    d = packed_order((fn - fs).astype(F32), pn.T, split, nch=2)
    return np.where(even, s, d)


def running_order(a, b):
    acc = np.zeros((a.shape[0], b.shape[1]), F32)
    for t in range(a.shape[1]):
        acc = fma(acc, a[:, t, None], b[None, t])
    return acc


def combine(raw, J):
    """The dense engine's combination of K8's raw dots: a + b sgn(j)."""
    half = raw.shape[0] // 2
    return (raw[:half] + raw[half:] * sgn(J)).astype(F32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k7_order_within_k1s(seed):
    J, ig, fc2 = 1122, 301, 32
    rng = np.random.default_rng(seed)
    pn = rng.standard_normal((J, ig)).astype(F32)
    d2 = rng.standard_normal((fc2, J)).astype(F32)
    d4 = np.concatenate([d2, d2 * sgn(J)])
    want = d4.astype(np.float64) @ pn.astype(np.float64)
    e1 = np.abs(template_k1_order(d2, pn) - want).max()
    e7 = np.abs(packed_order(d4, pn) - want).max()
    e_run = np.abs(running_order(d4, pn) - want).max()
    assert 0 < e7 <= 1.5 * e1, (e7, e1)
    assert e_run > e7, (e_run, e7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k8_order_within_k2s(seed):
    J, ig, fc2 = 48, 1280, 20
    rng = np.random.default_rng(seed)
    pn = rng.standard_normal((J, ig)).astype(F32)
    fn, fs = (rng.standard_normal((fc2, ig)).astype(F32) for _ in range(2))
    f4 = np.concatenate([fn, fs])
    p64 = pn.T.astype(np.float64)
    want = fn.astype(np.float64) @ p64 + (fs.astype(np.float64) @ p64) * sgn(J)
    e2 = np.abs(template_k2_order(fn, fs, pn) - want).max()
    e_run = np.abs(combine(running_order(f4, pn.T), J) - want).max()
    for split in (1, 2):      # whole blocks, and blocks of two sub-blocks
        e8 = np.abs(combine(packed_order(f4, pn.T, split), J) - want).max()
        assert 0 < e8 <= 1.5 * e2, (split, e8, e2)
        assert e_run > e8, (split, e_run, e8)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k1_order_within_template(seed):
    J, ig, fc2 = 1122, 301, 32
    rng = np.random.default_rng(seed)
    pn = rng.standard_normal((J, ig)).astype(F32)
    d2 = rng.standard_normal((fc2, J)).astype(F32)
    d4 = np.concatenate([d2, d2 * sgn(J)])
    want = d4.astype(np.float64) @ pn.astype(np.float64)
    e_tpl = np.abs(template_k1_order(d2, pn) - want).max()
    e1 = np.abs(k1_order(d2, pn) - want).max()
    e_run = np.abs(running_order(d4, pn) - want).max()
    assert 0 < e1 <= 1.5 * e_tpl, (e1, e_tpl)
    assert e_run > e1, (e_run, e1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k2_order_within_template(seed):
    J, ig, fc2 = 48, 1280, 20
    rng = np.random.default_rng(seed)
    pn = rng.standard_normal((J, ig)).astype(F32)
    fn, fs = (rng.standard_normal((fc2, ig)).astype(F32) for _ in range(2))
    p64 = pn.T.astype(np.float64)
    want = fn.astype(np.float64) @ p64 + (fs.astype(np.float64) @ p64) * sgn(J)
    e_tpl = np.abs(template_k2_order(fn, fs, pn) - want).max()
    e_run = np.abs(combine(running_order(np.concatenate([fn, fs]), pn.T), J)
                   - want).max()
    for split in (1, 2):      # whole blocks, and blocks of two sub-blocks
        e2 = np.abs(k2_order(fn, fs, pn, split) - want).max()
        assert 0 < e2 <= 1.5 * e_tpl, (split, e2, e_tpl)
        assert e_run > e2, (split, e_run, e2)
