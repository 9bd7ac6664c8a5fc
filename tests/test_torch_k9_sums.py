"""The summation orders of the pipelined limb-plane Legendre kernels K9 and
K10 (``csrc/legendre_planes.cu``) against a fixed yardstick, the orders of
the template K9 and K10 that the port's first kernels used, in an fp32
emulation on the CPU: the CUDA kernels cannot run here, and their accuracy
contract rests on the order in which they add.

Both kernels sum each value's limbs and each table entry's planes in fp32
first (exact at 3 planes, the bf16 values at 1), so the emulation runs on
those sums.  The yardstick: the template K9 sums each 32-degree stage of j
as two 16-term FMA chains, one over the even and one over the odd degrees,
each folded into a TwoSum total (the template K1's order, on the table
transposed: ``template_k9_order``); the template K10 rounds gn +- gs to fp32
and sums each 32-latitude stage as one FMA chain folded into a TwoSum total
(the template K2's: ``template_k10_order``).  The redesigned kernels run
K5's and K6's bodies on the parity-split tiles (K1's order: 16-term FMA
chains, a stage's two added in plain fp32 and folded into a TwoSum total
every 32 terms of a parity): K9 as K5 with E and O over the even and odd
degrees (north = E + O, south = E - O), K10 as K6 with gn + gs on the even
and gn - gs on the odd degrees, and its latitude split among the S blocks
of a cluster.

Each is held against an fp64 product: K9 at TCO1279 group 0's J (1282) with
the latitudes cut to 301, K10 at group 0's ig (1280) with J cut to 48; at 3
planes and at 1.  Each error must stay within 1.5x the yardstick's, the
bound the card's tests (``test_k9_error_within_template``,
``test_k10_error_within_template``) hold the kernels to, and one running
fp32 sum (torch.bmm's order) must be worse.
"""

import numpy as np
import pytest
import torch

from ectrans_tpu_torch.ops import legendre_planes as lpl
from test_torch_k5_sums import k5_order
from test_torch_k7_sums import (F32, packed_order, running_order, sgn,
                                template_k1_order, template_k2_order)


def template_k9_order(x, p):
    """The yardstick, the template K9's order on rows x (rows, J) and the
    summed table p (ig, J): north, south stacked."""
    return template_k1_order(x, p.T)


def template_k10_order(gn, gs, p):
    """The yardstick, the template K10's order on gn, gs (rows, ig) and p
    (ig, J): out (rows, J)."""
    return template_k2_order(gn, gs, p.T)


def k9_order(x, p):
    """K9's order: K5's on the even (E) and odd (O) degrees, north = E + O,
    south = E - O, stacked."""
    return k5_order(x[:, 0::2], x[:, 1::2], p[:, 0::2], p[:, 1::2])


def k10_order(gn, gs, p, split=1):
    """K10's order: K6's packed sums (nch 2, latitudes split among ``split``
    blocks) of gn + gs on the even degrees and gn - gs on the odd ones."""
    out = np.empty((gn.shape[0], p.shape[1]), F32)
    out[:, 0::2] = packed_order((gn + gs).astype(F32), p[:, 0::2], split,
                                nch=2)
    out[:, 1::2] = packed_order((gn - gs).astype(F32), p[:, 1::2], split,
                                nch=2)
    return out


def summed(rng, shape, nplanes):
    """A standard normal fp32 array as the kernels see it after summing its
    ``nplanes`` limb planes: itself at 3, rounded to bf16 at 1."""
    x = torch.from_numpy(rng.standard_normal(shape).astype(F32))
    return sum(p.float() for p in lpl.split_planes(x, nplanes)).numpy()


@pytest.mark.parametrize("nplanes", [3, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k9_order_within_template(seed, nplanes):
    rng = np.random.default_rng(seed)
    J, ig = 1282, 301
    x, p = summed(rng, (32, J), nplanes), summed(rng, (ig, J), nplanes)
    xs = (x * sgn(J)).astype(F32)
    p64 = p.T.astype(np.float64)
    want = np.concatenate([x.astype(np.float64) @ p64,
                           xs.astype(np.float64) @ p64])
    e_tpl = np.abs(template_k9_order(x, p) - want).max()
    e9 = np.abs(k9_order(x, p) - want).max()
    e_run = np.abs(np.concatenate([running_order(x, p.T),
                                   running_order(xs, p.T)]) - want).max()
    assert 0 < e9 <= 1.5 * e_tpl, (e9, e_tpl)
    assert e_run > e9, (e_run, e9)


@pytest.mark.parametrize("split", [1, 2, 5])
@pytest.mark.parametrize("nplanes", [3, 1])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k10_order_within_template(seed, nplanes, split):
    rng = np.random.default_rng(seed)
    J, ig = 48, 1280
    gn, gs = (summed(rng, (20, ig), nplanes) for _ in range(2))
    p = summed(rng, (ig, J), nplanes)
    p64 = p.astype(np.float64)
    want = gn.astype(np.float64) @ p64 + (gs.astype(np.float64) @ p64) \
        * sgn(J)
    e_tpl = np.abs(template_k10_order(gn, gs, p) - want).max()
    e10 = np.abs(k10_order(gn, gs, p, split) - want).max()
    xe, xo = (gn + gs).astype(F32), (gn - gs).astype(F32)
    run = np.where((np.arange(J) & 1) == 0, running_order(xe, p),
                   running_order(xo, p))
    e_run = np.abs(run - want).max()
    assert 0 < e10 <= 1.5 * e_tpl, (e10, e_tpl)
    assert e_run > e10, (e_run, e10)
