"""The summation orders of the pipelined parity-split Legendre kernels K5
and K6 (``csrc/legendre_grouped.cu``) against a fixed yardstick, the orders
of the template K5 and K6 that the port's first kernels used, in an fp32
emulation on the CPU: the CUDA kernels cannot run here, and their accuracy
contract rests on the order in which they add.

The yardstick (``template_k5_order``, ``template_k6_order``): the template
K6 sums each 32-latitude stage of fsym . psym (and of fasym . pasym) as one
FMA chain folded into a TwoSum total; the template K5 sums each 32-degree
stage of sym . psym^T and of asym . pasym^T so, and writes north = s + a,
south = s - a.  The redesigned kernels take K1's and K2's order
(``packed_order`` with nch 2, from ``test_torch_k7_sums``): 16-term FMA
chains, the stage's two added in plain fp32 and folded into a TwoSum total
every 32 terms; K6 with its latitude split, where the S blocks of a cluster
each sum a run of whole stages and the later blocks' totals are added to the
first's by TwoSum, their compensations plainly; K5 with K1's combine of s
and a at the end.

Each is held against an fp64 product: K6 at TCO1279 group 0's ig (1280)
with kg cut to 48, K5 at group 0's kg (641) with the latitudes cut to 301.
Each error must stay within 1.5x the yardstick's, the bound the card's tests
(``test_k5_error_within_template``, ``test_k6_error_within_template``) hold
the kernels to, and one running fp32 sum (torch.bmm's order) must be worse.
"""

import numpy as np
import pytest

from test_torch_k7_sums import F32, fma, packed_order, running_order, two_sum


def template_chains(a, b):
    """The template's a @ b: one FMA chain per 32-term stage, folded into a
    TwoSum total (sum + compensation at the end)."""
    shape = (a.shape[0], b.shape[1])
    s, c = np.zeros(shape, F32), np.zeros(shape, F32)
    for t0 in range(0, a.shape[1], 32):
        part = np.zeros(shape, F32)
        for t in range(t0, min(a.shape[1], t0 + 32)):
            part = fma(part, a[:, t, None], b[None, t])
        s, c = two_sum(s, c, part)
    return (s + c).astype(F32)


def template_k6_order(fsym, fasym, psym, pasym):
    """The yardstick, the template K6's order: sym and asym stacked."""
    return np.concatenate([template_chains(fsym, psym),
                           template_chains(fasym, pasym)])


def template_k5_order(sym, asym, psym, pasym):
    """The yardstick, the template K5's order: north and south stacked from
    s and a, each one 32-term chain a stage, folded."""
    s = template_chains(sym, psym.T)
    a = template_chains(asym, pasym.T)
    return np.concatenate([(s + a).astype(F32), (s - a).astype(F32)])


def k6_order(fsym, fasym, psym, pasym, split=1):
    """K6's order: sym and asym stacked, each the packed sums (nch 2) over
    the latitudes, split among ``split`` blocks of a cluster."""
    return np.concatenate([packed_order(fsym, psym, split, nch=2),
                           packed_order(fasym, pasym, split, nch=2)])


def k5_order(sym, asym, psym, pasym):
    """K5's order: north = s + a, south = s - a, s and a the packed sums
    (nch 2) over the degrees."""
    s = packed_order(sym, psym.T, nch=2)
    a = packed_order(asym, pasym.T, nch=2)
    return np.concatenate([(s + a).astype(F32), (s - a).astype(F32)])


def operands(rng, rows, ig, kg, across):
    """Two operands of ``rows`` rows and two tables (ig, kg), fp32; the
    operands' rows run across the latitudes (K6) or the degrees (K5)."""
    x = [rng.standard_normal((rows, ig if across == "lat" else kg))
         .astype(F32) for _ in range(2)]
    p = [rng.standard_normal((ig, kg)).astype(F32) for _ in range(2)]
    return x, p


@pytest.mark.parametrize("split", [1, 2, 5])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k6_order_within_template(seed, split):
    rng = np.random.default_rng(seed)
    (fsym, fasym), (psym, pasym) = operands(rng, 20, 1280, 48, "lat")
    want = np.concatenate([fsym.astype(np.float64) @ psym,
                           fasym.astype(np.float64) @ pasym])
    e_tpl = np.abs(template_k6_order(fsym, fasym, psym, pasym) - want).max()
    e6 = np.abs(k6_order(fsym, fasym, psym, pasym, split) - want).max()
    e_run = np.abs(np.concatenate([running_order(fsym, psym),
                                   running_order(fasym, pasym)])
                   - want).max()
    assert 0 < e6 <= 1.5 * e_tpl, (e6, e_tpl)
    assert e_run > e6, (e_run, e6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_k5_order_within_template(seed):
    rng = np.random.default_rng(seed)
    (sym, asym), (psym, pasym) = operands(rng, 32, 301, 641, "deg")
    s = sym.astype(np.float64) @ psym.T.astype(np.float64)
    a = asym.astype(np.float64) @ pasym.T.astype(np.float64)
    want = np.concatenate([s + a, s - a])
    e_tpl = np.abs(template_k5_order(sym, asym, psym, pasym) - want).max()
    e5 = np.abs(k5_order(sym, asym, psym, pasym) - want).max()
    rs, ra = running_order(sym, psym.T), running_order(asym, pasym.T)
    e_run = np.abs(np.concatenate([(rs + ra).astype(F32),
                                   (rs - ra).astype(F32)]) - want).max()
    assert 0 < e5 <= 1.5 * e_tpl, (e5, e_tpl)
    assert e_run > e5, (e_run, e5)
