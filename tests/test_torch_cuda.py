"""ectrans_tpu_torch's CUDA kernels against their plain PyTorch versions on
the card (K1-K12, the bf16-table variants, and the whole slice through every
Legendre engine, tier and knob), marked ``cuda``: they skip without a CUDA
card.  This file imports neither jax nor ectrans_tpu, so it also runs where
those are not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerances: K1/K2/K5/K6/K7/K8 5e-6 (fp32, and on bf16 tables, whose
products of rounded operands are exact in fp32) / 1e-12 (fp64) relative to
the output's max, and K1/K2/K7/K8 within 1.5x the error of the template
K1's and K2's summation order (its fp32 emulation in test_torch_k7_sums.py)
against an fp64 product, K5/K6 within 1.5x the error of the template K5's
and K6's (test_torch_k5_sums.py), K9/K10 5e-6 (fp32 sums of exact bf16
products) and within 1.5x the error of the template K9's and K10's order
(test_torch_k9_sums.py); K4 1e-7
of the table scale one group a launch, and bit-exact on the all-groups
launch; K3 and K11 bit-exact; K12 1e-6 relative; the slice, the
lat-lon output and the LAM transforms as in test_torch_transform.py (fp64
1e-10 relative, fp32 2e-5 + 1e-5 relative).
"""

import numpy as np
import pytest
import torch

import ectrans_tpu_torch as ett
from ectrans_tpu_torch import roofline
from ectrans_tpu_torch.ops import legendre_dense as ld
from ectrans_tpu_torch.ops import legendre_grouped as lg
from ectrans_tpu_torch.ops import legendre_planes as lp
from ectrans_tpu_torch.ops import legendre_tablegen as tg
from ectrans_tpu_torch.ops import pack
from test_torch_k5_sums import template_k5_order, template_k6_order
from test_torch_k7_sums import template_k1_order, template_k2_order
from test_torch_k9_sums import template_k10_order, template_k9_order

pytestmark = pytest.mark.cuda

DTYPES = [torch.float32, torch.float64]
LT_TOL = {torch.float32: 5e-6, torch.float64: 1e-12, torch.bfloat16: 5e-6}
# (working dtype, table dtype) of every Legendre kernel variant
VARIANTS = [(torch.float32, torch.float32), (torch.float64, torch.float64),
            (torch.float32, torch.bfloat16)]
SLICE_TOL = {torch.float64: (0.0, 1e-10), torch.float32: (2e-5, 1e-5)}


@pytest.fixture(autouse=True)
def fresh_setup():
    """Each test starts from a setup of its own, as if no other test had run
    (``setup`` shares one Resolution, and its tables, among its callers), so
    that a test counting K4's launches sees its own table build."""
    ett.trans_end()
    yield
    ett.trans_end()


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


def round_trip(res, sp, dtype, device, engine=None, precision="highest"):
    grid = ett.inv_trans(res, *(torch.as_tensor(x, device=device) for x in sp),
                         flags=ett.InvFlags(scders=True, uvders=True),
                         dtype=dtype, precision=precision, _engine=engine)
    return grid, ett.dir_trans(res, grid[:2], grid[2:4], grid[4:10],
                               dtype=dtype, precision=precision,
                               _engine=engine)


def rel_err(a, b) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


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


@pytest.mark.parametrize("name,nsmax", [("O160", 159), ("F160", 159)])
@pytest.mark.parametrize("dtype", DTYPES + [torch.bfloat16])
def test_tablegen_all_groups_match_plain(dev, name, nsmax, dtype):
    """K4 on every group in one launch (a full_legendre build): the plain
    recurrence's entries bit for bit (the kernel's rescaling every 4 steps
    and its exponent-bit tests change no value), bf16 tables the fp32
    tables rounded to nearest even; and full_legendre makes them in one
    launch."""
    res = ett.setup(name, nsmax)
    inp = tg._device_inputs(res, dev)
    groups = res.legendre_groups()
    tg.gen_groups.launches = 0
    got = tg.gen_groups(inp, groups, dtype)
    assert tg.gen_groups.launches == 1
    for pn, (m0, m1, i0, J) in zip(got, groups):
        want = tg.gen_group_plain(inp, m0, m1, J, i0, dtype)
        assert pn.shape == want.shape and pn.dtype == dtype
        assert torch.equal(pn, want), (m0, (pn.float() - want.float()).abs().max())
    tg.gen_groups.launches = 0
    fl = res.full_legendre(dtype, dev)
    assert tg.gen_groups.launches == 1
    assert all(torch.equal(g.pn, pn) for g, pn in zip(fl.groups, got))


def k7_edge_cases(dev, dtype, tdt, fc4, g):
    """Synthetic K7 (and K1) operands of fc4 rows at the edges of their
    tiles: ig % 4 in {0, 1, 2, 3} (the table copy widths), J = 82 (not a
    multiple of the 32-degree stage) and J = 81 (odd: 4-byte copies of the
    degree chunk), and a table whose base is only 4-byte aligned."""
    for J, ig in ((82, 200), (82, 201), (82, 202), (82, 203), (81, 203)):
        yield (torch.randn(2, fc4, J, generator=g, device=dev, dtype=dtype),
               torch.randn(2, J, ig, generator=g, device=dev,
                           dtype=dtype).to(tdt))
    buf = torch.randn(2 * 82 * 200 + 1, generator=g, device=dev, dtype=dtype)
    yield (torch.randn(2, fc4, 82, generator=g, device=dev, dtype=dtype),
           buf.to(tdt)[1:].view(2, 82, 200))


def k8_edge_cases(dev, dtype, tdt, fc4, g):
    """Synthetic K8 (and K2) operands of fc4 rows at the edges of their
    tiles: ig % 4 in {0, 1, 2, 3} (the copy widths; none a multiple of the
    32-latitude stage), J = 70 and 129 (not a multiple of K8's 64-degree or
    K2's 128-degree tile), a table whose base is only 4-byte aligned, and
    rows that start unaligned.  Small launches split each block's latitudes
    between two sub-blocks; the last, 150 groups of 2 K8 degree tiles (300
    blocks, one round at 4 an SM on an H100; K2: 150 blocks), takes whole
    blocks."""
    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    for J, ig in ((70, 200), (70, 201), (70, 202), (129, 203)):
        yield rnd(2, fc4, ig), rnd(2, J, ig).to(tdt)
    yield rnd(2, fc4, 200), rnd(2 * 70 * 200 + 1).to(tdt)[1:].view(2, 70, 200)
    yield rnd(2 * fc4 * 200 + 1)[1:].view(2, fc4, 200), rnd(2, 70, 200).to(tdt)
    yield rnd(150, fc4, 201), rnd(150, 70, 201).to(tdt)


@pytest.mark.parametrize("fc2", [20, 32, 40])
@pytest.mark.parametrize("dtype,tdt", VARIANTS)
def test_legendre_kernels_match_plain(dev, dtype, tdt, fc2):
    """K1, K2 and the hemisphere-packed K7, K8 (on the rows the dense engine
    stacks, fc4 = 2 fc2 = 40, 64, 80) per table variant, on the O160 groups;
    and all four on synthetic groups at the edges of their tiles."""
    res = ett.setup("O160", 159)
    fl = res.full_legendre(tdt, dev)
    g = torch.Generator(device=dev).manual_seed(0)
    for grp in fl.groups:
        gm, J, ig = grp.pn.shape
        d2 = torch.randn(gm, fc2, J, generator=g, device=dev, dtype=dtype)
        for a, b in zip(ld.group_inv_dense(d2, grp.pn),
                        ld.group_inv_dense_plain(d2, grp.pn)):
            assert a.dtype == dtype and rel_err(a, b) <= LT_TOL[tdt]
        d4 = torch.cat([d2, d2 * ld._jsgn(J, d2)], dim=1)
        assert rel_err(ld.group_inv_dense2(d4, grp.pn),
                       ld.group_inv_dense2_plain(d4, grp.pn)) <= LT_TOL[tdt]
        fn, fs = (torch.randn(gm, fc2, ig, generator=g, device=dev,
                              dtype=dtype) for _ in range(2))
        a = ld.group_dir_dense(fn, fs, grp.pn)
        b = ld.group_dir_dense_plain(fn, fs, grp.pn)
        assert a.dtype == dtype and rel_err(a, b) <= LT_TOL[tdt]
        f4 = torch.cat([fn, fs], dim=1)
        assert rel_err(ld.group_dir_dense2(f4, grp.pn),
                       ld.group_dir_dense2_plain(f4, grp.pn)) <= LT_TOL[tdt]
    for d4, pn in k7_edge_cases(dev, dtype, tdt, 2 * fc2, g):
        got = ld.group_inv_dense2(d4, pn)
        assert got.shape == (2, 2 * fc2, pn.shape[2])
        assert rel_err(got, ld.group_inv_dense2_plain(d4, pn)) <= LT_TOL[tdt]
    for f4, pn in k8_edge_cases(dev, dtype, tdt, 2 * fc2, g):
        got = ld.group_dir_dense2(f4, pn)
        assert got.shape == (len(f4), 2 * fc2, pn.shape[1])
        assert rel_err(got, ld.group_dir_dense2_plain(f4, pn)) <= LT_TOL[tdt]
    for d2, pn in k7_edge_cases(dev, dtype, tdt, fc2, g):
        for a, b in zip(ld.group_inv_dense(d2, pn),
                        ld.group_inv_dense_plain(d2, pn)):
            assert a.shape == (2, fc2, pn.shape[2])
            assert rel_err(a, b) <= LT_TOL[tdt]
    for fn, pn in k8_edge_cases(dev, dtype, tdt, fc2, g):
        fs = torch.randn(fn.shape, generator=g, device=dev, dtype=dtype)
        for a, b in ((fn, fs), (fs, fn)):      # unaligned fn, then fs
            got = ld.group_dir_dense(a, b, pn)
            assert got.shape == (len(fn), fc2, pn.shape[1])
            assert rel_err(got, ld.group_dir_dense_plain(a, b, pn)) \
                <= LT_TOL[tdt]


def inv_error_case(dev, tdt, seed: int):
    """Rows d2 (32 of them) and a synthetic table at TCO1279 group 2's
    widths (J 1122, ig 1203: unaligned rows) with gm cut to 2, the fp64
    product of the (rounded) operands stacked as [d2 ; d2 sgn] (north, then
    south), and the error of the template K1's summation order on them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gm, J, ig = 2, 1122, 1203
    pn = torch.randn(gm, J, ig, generator=g, device=dev).to(tdt)
    d2 = torch.randn(gm, 32, J, generator=g, device=dev)
    pf, d2r = ld.plain_operands(pn, d2)
    want = torch.bmm(torch.cat([d2r, d2r * ld._jsgn(J, d2r)], dim=1).double(),
                     pf.double())
    tpl = np.stack([template_k1_order(a, p) for a, p in
                    zip(d2r.cpu().numpy(), pf.cpu().numpy())])
    return d2, pn, want, np.abs(tpl - want.cpu().numpy()).max()


def dir_error_case(dev, tdt, seed: int):
    """Rows fn, fs (20 each) and a synthetic table at TCO1279 group 2's
    widths with gm cut to 2, the fp64 fn . P + sgn fs . P of the (rounded)
    operands, and the error of the template K2's summation order on them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gm, J, ig = 2, 1122, 1203
    pn = torch.randn(gm, J, ig, generator=g, device=dev).to(tdt)
    fn, fs = (torch.randn(gm, 20, ig, generator=g, device=dev)
              for _ in range(2))
    pf, fnr, fsr = ld.plain_operands(pn, fn, fs)
    pt = pf.double().transpose(1, 2)
    want = torch.bmm(fnr.double(), pt) + torch.bmm(fsr.double(), pt) * \
        ld._jsgn(J, pt)
    tpl = np.stack([template_k2_order(a, b, p) for a, b, p in
                    zip(fnr.cpu().numpy(), fsr.cpu().numpy(),
                        pf.cpu().numpy())])
    return fn, fs, pn, want, np.abs(tpl - want.cpu().numpy()).max()


def max_err(got, want) -> float:
    return (got.double() - want).abs().max().item()


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_k1_error_within_template(dev, tdt):
    """K1's north and south against the fp64 product: at most 1.5x the
    error of the template K1's order on the same operands."""
    d2, pn, want, e_tpl = inv_error_case(dev, tdt, 4)
    e1 = max_err(torch.cat(ld.group_inv_dense(d2, pn), dim=1), want)
    assert 0 < e1 <= 1.5 * e_tpl, (e1, e_tpl)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_k7_error_within_k1s(dev, tdt):
    """K7 on [d2 ; d2 sgn] against the fp64 product: at most 1.5x the error
    of the template K1's order on the same operands."""
    d2, pn, want, e_tpl = inv_error_case(dev, tdt, 4)
    d4 = torch.cat([d2, d2 * ld._jsgn(d2.shape[-1], d2)], dim=1)
    e7 = max_err(ld.group_inv_dense2(d4, pn), want)
    assert 0 < e7 <= 1.5 * e_tpl, (e7, e_tpl)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_k2_error_within_template(dev, tdt):
    """K2 against the fp64 fn . P + sgn fs . P: at most 1.5x the error of
    the template K2's order on the same operands."""
    fn, fs, pn, want, e_tpl = dir_error_case(dev, tdt, 6)
    e2 = max_err(ld.group_dir_dense(fn, fs, pn), want)
    assert 0 < e2 <= 1.5 * e_tpl, (e2, e_tpl)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_k8_error_within_k2s(dev, tdt):
    """K8 on [fn ; fs], its raw dots combined as the dense engine combines
    them (a + b sgn), against the fp64 fn . P + sgn fs . P: at most 1.5x the
    error of the template K2's order on the same operands."""
    fn, fs, pn, want, e_tpl = dir_error_case(dev, tdt, 6)
    raw = ld.group_dir_dense2(torch.cat([fn, fs], dim=1), pn)
    e8 = max_err(raw[:, :20] + raw[:, 20:] * ld._jsgn(raw.shape[-1], raw),
                 want)
    assert 0 < e8 <= 1.5 * e_tpl, (e8, e_tpl)


@pytest.mark.parametrize("dtype,tdt", VARIANTS)
def test_grouped_kernels_match_plain(dev, dtype, tdt):
    """K5 and K6 on the parity tables derived on the card."""
    res = ett.setup("O160", 159)
    gl = res.grouped_legendre(tdt, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    for grp in gl.groups:
        gm, ig, kg = grp.psym.shape
        s, a = (torch.randn(gm, 32, kg, generator=g, device=dev, dtype=dtype)
                for _ in range(2))
        for x, y in zip(lg.group_inv(s, a, grp.psym, grp.pasym),
                        lg.group_inv_plain(s, a, grp.psym, grp.pasym)):
            assert rel_err(x, y) <= LT_TOL[tdt]
        fs, fa = (torch.randn(gm, 20, ig, generator=g, device=dev,
                              dtype=dtype) for _ in range(2))
        for x, y in zip(lg.group_dir(fs, fa, grp.psym, grp.pasym),
                        lg.group_dir_plain(fs, fa, grp.psym, grp.pasym)):
            assert rel_err(x, y) <= LT_TOL[tdt]


# synthetic K5 and K6 groups (gm, ig, kg) at the edges of their tiles: kg %
# 4 in {0, 1, 2, 3} (the copy widths along k), ig 100 and 201 (not a
# multiple of K5's 64-latitude tile or K6's 32-latitude stage), gm 1; TCO1279
# group 15's (ig 474, kg 41) at gm 1, whose few K6 blocks split the
# latitudes among a cluster, and a launch of many short K6 blocks that takes
# none (gm 150, ig 64, kg 200)
GROUPED_EDGES = [(2, 100, 40), (2, 100, 41), (2, 100, 42), (2, 201, 43),
                 (1, 201, 41), (1, 474, 41), (150, 64, 200)]


def rnd_view(g, dev, dtype, shape, offset=0):
    """A standard normal tensor of ``shape``; with offset 1, a view whose
    base is only one element past an allocation's start (4-byte aligned in
    fp32)."""
    n = int(np.prod(shape))
    buf = torch.randn(n + offset, generator=g, device=dev, dtype=dtype)
    return buf[offset:].view(*shape)


def nan_rows(t):
    """t (gm, ig, kg) as a view of rows padded to a multiple of 4 entries,
    the layout of ``pad_rows``, but with NaN past kg in place of zeros: a
    kernel that read a padding entry would put NaN in its outputs."""
    kg = t.shape[-1]
    rows = torch.full((*t.shape[:-1], -(-kg // 4) * 4), float("nan"),
                      device=t.device, dtype=t.dtype)
    rows[..., :kg] = t
    return rows[..., :kg]


@pytest.mark.parametrize("fc2", [1, 20, 32, 40])
@pytest.mark.parametrize("dtype,tdt", VARIANTS)
def test_grouped_kernels_at_tile_edges(dev, dtype, tdt, fc2):
    """K5 and K6 on synthetic groups at the edges of their tiles
    (GROUPED_EDGES), with fc2 1, 20, 32 and 40 (K6's 20-row and K5's 32-row
    blocks, and partial ones); every other group has an operand whose base
    is only 4-byte aligned, and the tables take turns: contiguous, one of
    them 4-byte aligned, both in padded rows (the layout of
    ``grouped_legendre``) whose padding holds NaN (``nan_rows``: no kernel
    reads past kg); fp64 runs the template.  K6's launch report shows the
    split on group 15's shape and none on the last."""
    g = torch.Generator(device=dev).manual_seed(7)
    for n, (gm, ig, kg) in enumerate(GROUPED_EDGES):
        off = n % 2
        ps = rnd_view(g, dev, dtype, (gm, ig, kg)).to(tdt)
        pa = rnd_view(g, dev, dtype, (gm * ig * kg + 1,)).to(tdt)
        pa = pa[int(n % 3 == 1):][:gm * ig * kg].view(gm, ig, kg)
        if n % 3 == 2:
            ps, pa = nan_rows(ps), nan_rows(pa)
        s, a = (rnd_view(g, dev, dtype, (gm, fc2, kg), o) for o in (off, 0))
        for x, y in zip(lg.group_inv(s, a, ps, pa),
                        lg.group_inv_plain(s, a, ps, pa)):
            assert x.shape == (gm, fc2, ig) and x.dtype == dtype
            assert rel_err(x, y) <= LT_TOL[tdt], (gm, ig, kg)
        fs, fa = (rnd_view(g, dev, dtype, (gm, fc2, ig), o) for o in (0, off))
        for x, y in zip(lg.group_dir(fs, fa, ps, pa),
                        lg.group_dir_plain(fs, fa, ps, pa)):
            assert x.shape == (gm, fc2, kg) and x.dtype == dtype
            assert rel_err(x, y) <= LT_TOL[tdt], (gm, ig, kg)
    if dtype == torch.float32:
        chunks = -(-fc2 // 20)
        split = lg.group_dir_shape(1, fc2, 41, 474, tdt)
        assert split["blocks"] > chunks, split
        whole = lg.group_dir_shape(150, fc2, 200, 64, tdt)
        assert whole["blocks"] == 150 * 4 * chunks, whole


def grouped_error_case(dev, tdt, seed: int, inverse: bool):
    """K5's operands sym, asym (32 rows) and tables at TCO1279 widths (kg
    641, ig 1203), or K6's fsym, fasym (20 rows) and tables (ig 1280, kg
    161: 3 degree tiles, 6 blocks, so the latitudes split), gm 2, the
    tables in padded rows as grouped_legendre stores them; the fp64
    product of the (rounded) operands, stacked as the template orders stack
    them ([north; south] or [sym; asym]), and the error of the template
    K5's or K6's summation order on them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gm, rows, ig, kg = (2, 32, 1203, 641) if inverse else (2, 20, 1280, 161)
    ps, pa = (lg.pad_rows(torch.randn(gm, ig, kg, generator=g,
                                      device=dev).to(tdt)) for _ in range(2))
    x, y = (torch.randn(gm, rows, kg if inverse else ig, generator=g,
                        device=dev) for _ in range(2))
    pf, xr, yr = ld.plain_operands(ps, x, y)
    paf = ld.plain_operands(pa)[0]
    if inverse:
        s = torch.bmm(xr.double(), pf.double().transpose(1, 2))
        a = torch.bmm(yr.double(), paf.double().transpose(1, 2))
        want = torch.cat([s + a, s - a], dim=1)
        order = template_k5_order
    else:
        want = torch.cat([torch.bmm(xr.double(), pf.double()),
                          torch.bmm(yr.double(), paf.double())], dim=1)
        order = template_k6_order
    tpl = np.stack([order(*(t.cpu().numpy() for t in ops)) for ops in
                    zip(xr, yr, pf, paf)])
    return x, y, ps, pa, want, np.abs(tpl - want.cpu().numpy()).max()


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_k5_error_within_template(dev, tdt):
    """K5's north and south against the fp64 product: at most 1.5x the
    error of the template K5's order on the same operands."""
    s, a, ps, pa, want, e_tpl = grouped_error_case(dev, tdt, 8, True)
    e5 = max_err(torch.cat(lg.group_inv(s, a, ps, pa), dim=1), want)
    assert 0 < e5 <= 1.5 * e_tpl, (e5, e_tpl)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_k6_error_within_template(dev, tdt):
    """K6's sym and asym (a launch that splits the latitudes) against the
    fp64 product: at most 1.5x the error of the template K6's order on the
    same operands."""
    fs, fa, ps, pa, want, e_tpl = grouped_error_case(dev, tdt, 9, False)
    e6 = max_err(torch.cat(lg.group_dir(fs, fa, ps, pa), dim=1), want)
    assert 0 < e6 <= 1.5 * e_tpl, (e6, e_tpl)


def test_roofline_kernels_match_plain(dev):
    """K11 bit-exact and K12 at 1e-6 relative, at an uneven size and at
    the probe's 512 MiB shape."""
    g = torch.Generator(device=dev).manual_seed(5)
    for shape in ((1000, 12), (roofline.N_ROWS, roofline.N_COLS)):
        x = torch.randn(*shape, generator=g, device=dev)
        assert torch.equal(roofline.stream_copy(x),
                           roofline.stream_copy_plain(x))
        got = roofline.read_reduce(x)
        assert got.shape == (8, shape[1])
        assert rel_err(got, roofline.read_reduce_plain(x)) <= 1e-6
        assert torch.equal(got, roofline.read_reduce(x))   # deterministic


# K11: 4 values, a word short of a block's words, a block's, a block's and a
# word, an uneven count.  K12: a stage holds 2 octets at 512 columns (32 KB)
# and 85 at 12; a stage and less, and a stage and a tail, at each; 5 lane
# windows at 2052 columns
COPY_SIZES = [4, 4 * roofline.COPY_CHUNK - 4, 4 * roofline.COPY_CHUNK,
              4 * roofline.COPY_CHUNK + 4, 4 * 1000003]
REDUCE_SHAPES = [(8, 4), (8, 512), (16, 512), (24, 512), (8 * 84, 12),
                 (8 * 85, 12), (8 * 86, 12), (64, 2052), (8 * 4099, 8)]


@pytest.mark.parametrize("n", COPY_SIZES)
def test_stream_copy_bit_exact(dev, n):
    x = torch.randn(n, generator=torch.Generator(device=dev).manual_seed(n),
                    device=dev)
    assert torch.equal(roofline.stream_copy(x), x)


@pytest.mark.parametrize("shape", REDUCE_SHAPES)
def test_read_reduce_matches_plain(dev, shape):
    """Within 1e-6 relative of the plain version, bit-identical across two
    calls."""
    x = torch.randn(*shape, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    got = roofline.read_reduce(x)
    assert got.shape == (8, shape[1])
    assert rel_err(got, roofline.read_reduce_plain(x)) <= 1e-6
    assert torch.equal(got, roofline.read_reduce(x))


def test_streaming_kernels_on_offset_views(dev):
    """Views 16 bytes into their storage run; 4 bytes in are refused."""
    base = torch.randn(8 * 512 * 9 + 8, device=dev,
                       generator=torch.Generator(device=dev).manual_seed(3))
    x = base[4 : 4 + 8 * 512 * 9]
    assert torch.equal(roofline.stream_copy(x), x)
    x2 = x.view(72, 512)
    assert rel_err(roofline.read_reduce(x2),
                   roofline.read_reduce_plain(x2)) <= 1e-6
    with pytest.raises(ValueError, match="aligned"):
        roofline.stream_copy(base[1:17])
    with pytest.raises(ValueError, match="aligned"):
        roofline.read_reduce(base[1:33].view(8, 4))


def test_streaming_c_entries_refuse_misaligned(dev):
    """The C entries themselves refuse a pointer off 16 bytes (and launch
    nothing), whatever the wrappers check."""
    from ectrans_tpu_torch import _build

    x = torch.zeros(64, device=dev)
    out = torch.zeros(64, device=dev)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("ect_copy", torch.float32, x.data_ptr() + 4,
                      out.data_ptr(), 60, 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("ect_copy", torch.float32, x.data_ptr(),
                      out.data_ptr() + 4, 60, 1)
    partial = torch.zeros(8, 4, device=dev)
    ops = roofline.reduce_plan(8, 4, 1)["ops"]
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("ect_reduce8", torch.float32, x.data_ptr() + 4,
                      partial.data_ptr(), out.data_ptr(), 8, 4, 1, 1, ops)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("ect_reduce8", torch.float32, x.data_ptr(),
                      partial.data_ptr() + 4, out.data_ptr(), 8, 4, 1, 1, ops)
    # and a plan that does not cover the tensor exactly once, or whose
    # stages overflow the ring
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("ect_copy", torch.float32, x.data_ptr(),
                      out.data_ptr(), 64, 2)
    with pytest.raises(RuntimeError, match="launch failed"):
        _build.launch("ect_reduce8", torch.float32, x.data_ptr(),
                      partial.data_ptr(), out.data_ptr(), 8, 4, 1, 1,
                      ops + 1)
    torch.cuda.synchronize()


@pytest.mark.parametrize("nplanes", [3, 1])
def test_planes_kernels_match_plain(dev, nplanes):
    """K9 and K10 on the planes derived on the card, with operands packed
    as the planes engine packs them."""
    res = ett.setup("O160", 159)
    ppl = res.planes_legendre(nplanes, dev)
    g = torch.Generator(device=dev).manual_seed(3)
    for grp in ppl.groups:
        gm, ig, J = grp.pt[0].shape
        a = lp._pack_inv_rows(torch.randn(gm, 32, J, generator=g, device=dev),
                              nplanes)
        for x, y in zip(lp.group_inv_planes(a, grp.pt, nplanes, 32),
                        lp.group_inv_planes_plain(a, grp.pt, nplanes, 32)):
            assert x.dtype == torch.float32 and rel_err(x, y) <= 5e-6
        fn, fs = (torch.randn(gm, 20, ig, generator=g, device=dev)
                  for _ in range(2))
        w = lp._pack_dir_rows(fn, fs, nplanes)
        assert rel_err(lp.group_dir_planes(w, grp.pt, nplanes, 20),
                       lp.group_dir_planes_plain(w, grp.pt, nplanes,
                                                 20)) <= 5e-6


# synthetic K9 and K10 groups (gm, ig, J) at the edges of their tiles: J % 8
# in {2, 0, 4, 6} (J = 2 kg is even; 2 in every TCO1279 group), ig 100, 77,
# 129 and 201 (not a multiple of K9's 64-latitude tile or K10's 32-latitude
# stage), gm 1; TCO1279 group 15's (ig 474, J 82) at gm 1, whose few K10
# blocks split the latitudes among a cluster, and a launch of many short
# K10 blocks that takes none (gm 150, ig 64, J 258)
PLANES_EDGES = [(2, 100, 66), (2, 100, 64), (2, 77, 44), (1, 129, 70),
                (1, 201, 130), (1, 474, 82), (150, 64, 258)]


def shifted(t, offset):
    """A copy of t whose base lies ``offset`` elements past an allocation's
    start (2-byte aligned in bf16 for an odd offset)."""
    buf = torch.empty(t.numel() + offset, device=t.device, dtype=t.dtype)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def padded_planes(planes, fill):
    """The planes (gm, ig, J) as views of rows padded to a multiple of 8
    entries, the layout of ``planes_legendre``, with ``fill`` past J."""
    out = []
    for t in planes:
        J = t.shape[-1]
        rows = torch.full((*t.shape[:-1], -(-J // 8) * 8), fill,
                          device=t.device, dtype=t.dtype)
        rows[..., :J] = t
        out.append(rows[..., :J])
    return tuple(out)


@pytest.mark.parametrize("fc2", [1, 20, 32, 40])
@pytest.mark.parametrize("nplanes", [3, 1])
def test_planes_kernels_at_tile_edges(dev, nplanes, fc2):
    """K9 and K10 on synthetic groups at the edges of their tiles
    (PLANES_EDGES), with fc2 1, 20, 32 and 40 (K10's 20-row and K9's 32-row
    blocks, and partial ones), operands packed as the planes engine packs
    them; the planes take turns: in padded rows whose padding holds NaN (no
    kernel reads past J), contiguous, and contiguous from an odd offset (rows
    not even 4-byte aligned; the wrappers copy both into padded rows); the
    operands of every other group start at an odd offset too.  K10's launch
    report shows the split on group 15's shape and none on the last."""
    g = torch.Generator(device=dev).manual_seed(11)
    for n, (gm, ig, J) in enumerate(PLANES_EDGES):
        planes = lp.split_planes(
            torch.randn(gm, ig, J, generator=g, device=dev), nplanes)
        planes = (padded_planes(planes, float("nan")) if n % 3 == 0 else
                  tuple(shifted(p, n % 3 - 1) for p in planes))
        off = n % 2
        a = shifted(lp._pack_inv_rows(
            torch.randn(gm, fc2, J, generator=g, device=dev), nplanes), off)
        for x, y in zip(lp.group_inv_planes(a, planes, nplanes, fc2),
                        lp.group_inv_planes_plain(a, planes, nplanes, fc2)):
            assert x.shape == (gm, fc2, ig) and x.dtype == torch.float32
            assert rel_err(x, y) <= 5e-6, (gm, ig, J)
        fn, fs = (torch.randn(gm, fc2, ig, generator=g, device=dev)
                  for _ in range(2))
        w = shifted(lp._pack_dir_rows(fn, fs, nplanes), off)
        x = lp.group_dir_planes(w, planes, nplanes, fc2)
        assert x.shape == (gm, fc2, J) and x.dtype == torch.float32
        assert rel_err(x, lp.group_dir_planes_plain(w, planes, nplanes,
                                                    fc2)) <= 5e-6, (gm, ig, J)
    chunks = -(-fc2 // 20)
    split = lp.group_dir_planes_shape(1, fc2, 82, 474, nplanes)
    assert split["blocks"] > chunks, split
    whole = lp.group_dir_planes_shape(150, fc2, 258, 64, nplanes)
    assert whole["blocks"] == 150 * 3 * chunks, whole


@pytest.mark.parametrize("entry", ["ect_inv_planes", "ect_dir_planes"])
def test_planes_entries_refuse_unaligned_rows(dev, entry):
    """K9's and K10's C entries launch only on planes in 16-byte aligned
    rows of a multiple of 8 entries (the wrappers pad any others first):
    contiguous rows of J = 10 entries, or padded rows from an odd offset,
    are refused, not read."""
    from ectrans_tpu_torch import _build

    gm, fc2, ig, J = 2, 4, 6, 10
    padded = lg.pad_rows(torch.zeros(gm, ig, J, device=dev,
                                     dtype=torch.bfloat16), 8)
    flat = padded.contiguous()
    odd = shifted(padded.as_strided((gm * ig * 16,), (1,)), 1)
    rows = torch.zeros(gm, 2 * fc2, ig if entry == "ect_dir_planes" else J,
                       device=dev, dtype=torch.bfloat16)
    outs = ([torch.empty(gm, fc2, J, device=dev)]
            if entry == "ect_dir_planes" else
            [torch.empty(gm, fc2, ig, device=dev) for _ in range(2)])

    def launch(plane, ld):
        _build.launch(entry, None, rows.data_ptr(), *[plane.data_ptr()] * 3,
                      *[o.data_ptr() for o in outs], 1, gm, fc2, J, ig, ld)

    launch(padded, 16)
    torch.cuda.synchronize()
    for plane, ld in ((flat, J), (odd, 16)):
        with pytest.raises(RuntimeError, match="launch failed"):
            launch(plane, ld)


def planes_error_case(dev, nplanes: int, seed: int, inverse: bool):
    """K9's packed rows (32 rows) and planes at TCO1279 widths (J 1282, ig
    1203), or K10's (20 rows; ig 1280, J 322: 3 degree tiles, 6 blocks, so
    the latitudes split), gm 2, the planes in padded rows as planes_legendre
    stores them; the fp64 product of the summed limbs and planes (north and
    south stacked for K9), and the error of the template K9's or K10's
    summation order on them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gm, rows, ig, J = (2, 32, 1203, 1282) if inverse else (2, 20, 1280, 322)
    planes = tuple(lg.pad_rows(p, 8) for p in lp.split_planes(
        torch.randn(gm, ig, J, generator=g, device=dev), nplanes))
    p = lp._plane_sum(planes, nplanes)
    p64 = p.double()
    if inverse:
        packed = lp._pack_inv_rows(torch.randn(gm, rows, J, generator=g,
                                               device=dev), nplanes)
        x = lp._limb_sum(packed, nplanes, rows, 0)
        xs = x * ld._jsgn(J, x)
        want = torch.cat([torch.bmm(x.double(), p64.transpose(1, 2)),
                          torch.bmm(xs.double(), p64.transpose(1, 2))], dim=1)
        tpl = np.stack([template_k9_order(a, b) for a, b in
                        zip(x.cpu().numpy(), p.cpu().numpy())])
    else:
        packed = lp._pack_dir_rows(
            *(torch.randn(gm, rows, ig, generator=g, device=dev)
              for _ in range(2)), nplanes)
        gn = lp._limb_sum(packed, nplanes, rows, 0)
        gs = lp._limb_sum(packed, nplanes, rows, 1)
        want = torch.bmm(gn.double(), p64) + torch.bmm(gs.double(), p64) * \
            ld._jsgn(J, p64)
        tpl = np.stack([template_k10_order(a, b, c) for a, b, c in
                        zip(gn.cpu().numpy(), gs.cpu().numpy(),
                            p.cpu().numpy())])
    return packed, planes, want, np.abs(tpl - want.cpu().numpy()).max()


@pytest.mark.parametrize("nplanes", [3, 1])
def test_k9_error_within_template(dev, nplanes):
    """K9's north and south against the fp64 product of the summed limbs and
    planes: at most 1.5x the error of the template K9's order on the same
    operands."""
    a, planes, want, e_tpl = planes_error_case(dev, nplanes, 12, True)
    e9 = max_err(torch.cat(lp.group_inv_planes(a, planes, nplanes, 32),
                           dim=1), want)
    assert 0 < e9 <= 1.5 * e_tpl, (e9, e_tpl)


@pytest.mark.parametrize("nplanes", [3, 1])
def test_k10_error_within_template(dev, nplanes):
    """K10 (a launch that splits the latitudes) against the fp64 product of
    the summed limbs and planes: at most 1.5x the error of the template
    K10's order on the same operands."""
    w, planes, want, e_tpl = planes_error_case(dev, nplanes, 13, False)
    assert lp.group_dir_planes_shape(2, 20, 322, 1280, nplanes)["blocks"] > 6
    e10 = max_err(lp.group_dir_planes(w, planes, nplanes, 20), want)
    assert 0 < e10 <= 1.5 * e_tpl, (e10, e_tpl)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("engine", ["xla", "pallas", "planes"])
def test_engines_on_card_match_cpu(dev, engine, dtype):
    """Each engine's slice on the card vs the same engine's plain path on
    the CPU in fp64 ("planes" in fp64 is "xla")."""
    res = ett.setup("O48", 47)
    sp = [packed(res, n, seed) for n, seed in ((2, 0), (2, 1), (6, 2))]
    g0, out0 = round_trip(res, sp, torch.float64, "cpu", engine)
    g1, out1 = round_trip(res, sp, dtype, dev, engine)
    atol, rtol = SLICE_TOL[dtype]
    for a, b in [(g1, g0)] + list(zip(out1, out0)):
        assert a.device == dev and a.dtype == dtype
        err = (a.cpu().double() - b).abs().max().item()
        assert err <= atol + rtol * b.abs().max().item()


@pytest.mark.parametrize("engine", ["dense", "xla", "pallas"])
def test_bf16_tier_on_card_matches_cpu(dev, engine):
    """The "bf16" tier on the card vs the same engine and tier on the CPU
    (the same rounded operands): 2e-5 + 1e-3 of each output's max (an fp32
    Fourier coefficient that differs in its last bit can round to the
    neighbouring bf16 value, 2^-8 of itself)."""
    res = ett.setup("O48", 47)
    sp = [packed(res, n, seed) for n, seed in ((2, 0), (2, 1), (6, 2))]
    g0, out0 = round_trip(res, sp, torch.float32, "cpu", engine, "bf16")
    g1, out1 = round_trip(res, sp, torch.float32, dev, engine, "bf16")
    for a, b in [(g1, g0)] + list(zip(out1, out0)):
        err = (a.cpu() - b).abs().max().item()
        assert err <= 2e-5 + 1e-3 * b.abs().max().item()


@pytest.mark.parametrize("engine,env,kernels", [
    ("pallas", {}, ("group_inv", "group_dir", "pack")),
    ("planes", {}, ("group_inv_planes", "group_dir_planes", "pack")),
    ("dense", {"ECTRANS_TPU_LEG_DENSE_PACK": "1"},
     ("group_inv_dense2", "group_dir_dense2", "pack")),
    ("dense", {"ECTRANS_TPU_PACK_KERNEL": "xla"},
     ("group_inv_dense", "group_dir_dense"))])
def test_engine_round_trip_launches_its_kernels(dev, monkeypatch, engine,
                                                env, kernels):
    counters = {"group_inv": lg.group_inv, "group_dir": lg.group_dir,
                "group_inv_planes": lp.group_inv_planes,
                "group_dir_planes": lp.group_dir_planes,
                "group_inv_dense": ld.group_inv_dense,
                "group_dir_dense": ld.group_dir_dense,
                "group_inv_dense2": ld.group_inv_dense2,
                "group_dir_dense2": ld.group_dir_dense2,
                "pack": pack.packed_from_group_rows}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for c in counters.values():
        c.launches = 0
    res = ett.setup("O48", 47)
    sp = [packed(res, n, seed) for n, seed in ((2, 3), (2, 4), (6, 5))]
    round_trip(res, sp, torch.float32, dev, engine)
    ngroups = len(res.legendre_groups())
    # a Legendre kernel launches once a group, K3 once a direct transform
    assert {k: c.launches for k, c in counters.items()} == {
        k: (1 if k == "pack" else ngroups) if k in kernels else 0
        for k in counters}


@pytest.mark.parametrize("nfld", [1, 3, 10])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pack_kernel_matches_plain(dev, dtype, nfld):
    """K3, one launch for all groups, bit-exact against the index gather:
    rows of the Legendre groups' J, rows longer than that (the kernel reads
    only the first nsmax + 1 - m degrees of an m), and rows from the dense
    layout (dense_to_packed: J cut to NP + 1)."""
    res = ett.setup("O160", 159)
    g = torch.Generator(device=dev).manual_seed(1)
    for extra in (0, 5):
        rows = [torch.randn(m1 - m0, 2 * nfld, J + extra, generator=g,
                            device=dev, dtype=dtype)
                for m0, m1, _, J in res.legendre_groups()]
        pack.packed_from_group_rows.launches = 0
        got = pack.packed_from_group_rows(rows, res)
        assert pack.packed_from_group_rows.launches == 1
        assert got.shape == (nfld, res.nspec2) and got.dtype == dtype
        assert torch.equal(got, pack.packed_from_group_rows_plain(rows, res))
    dense = torch.randn(nfld, 2, res.M, res.NP, generator=g, device=dev,
                        dtype=dtype)
    want = pack.dense_to_packed(dense.cpu(), res)
    assert torch.equal(pack.dense_to_packed(dense, res).cpu(), want)


def test_pack_kernel_at_tco1279(dev):
    """K3 at the bench's TCO1279 shape (10 fields, 16 groups, 1,280 m):
    bit-exact against the index gather, in one launch."""
    res = ett.setup("TCO1279")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = [torch.randn(m1 - m0, 20, J, generator=g, device=dev)
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
    """The default path: K1 and K2 once a group, K3 once a direct
    transform, K4 once for the full_legendre build."""
    counters = [ld.group_inv_dense, ld.group_dir_dense,
                pack.packed_from_group_rows, tg.gen_groups]
    for c in counters:
        c.launches = 0
    res = ett.setup("O48", 47)
    sp = [packed(res, n, seed) for n, seed in ((2, 3), (2, 4), (6, 5))]
    round_trip(res, sp, torch.float32, dev)
    ngroups = len(res.legendre_groups())
    assert [c.launches for c in counters] == [ngroups, ngroups, 1, 1]


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
    with pytest.raises(TypeError, match="dtype"):
        ld.group_inv_dense(torch.zeros(2, 4, 6, device=dev).double(),
                           pn.to(torch.bfloat16))
    ps = torch.zeros(2, 5, 6, device=dev)
    with pytest.raises(ValueError, match="padded rows"):
        lg.group_dir(torch.zeros(2, 4, 5, device=dev),
                     torch.zeros(2, 4, 5, device=dev),
                     ps.transpose(1, 2).contiguous().transpose(1, 2), ps)
    with pytest.raises(ValueError, match="rows differ"):
        lg.group_inv(torch.zeros(2, 4, 6, device=dev),
                     torch.zeros(2, 4, 6, device=dev), lg.pad_rows(ps), ps)
    with pytest.raises(ValueError, match="multiple of 4"):
        roofline.stream_copy(torch.zeros(6, device=dev))
    with pytest.raises(ValueError, match="rows % 8"):
        roofline.read_reduce(torch.zeros(12, 8, device=dev))
    res = ett.setup("O48", 47)
    rows = [torch.zeros(m1 - m0, 4, J, device=dev)
            for m0, m1, _, J in res.legendre_groups()]
    with pytest.raises(ValueError, match="need"):
        pack.packed_from_group_rows([r[..., :-3].contiguous() for r in rows],
                                    res)
    with pytest.raises(TypeError, match="dtype"):
        pack.packed_from_group_rows(rows[:-1] + [rows[-1].double()], res)
    with pytest.raises(ValueError, match="contiguous"):
        pack.packed_from_group_rows(
            rows[:-1] + [rows[-1].transpose(0, 1).contiguous()
                         .transpose(0, 1)], res)
    with pytest.raises(ValueError, match="1 to 16"):
        tg.gen_groups(tg._device_inputs(res, dev),
                      [res.legendre_groups()[0]] * 17, torch.float32)
    planes = (torch.zeros(2, 5, 6, device=dev, dtype=torch.bfloat16),)
    with pytest.raises(TypeError, match="dtype"):
        lp.group_inv_planes(torch.zeros(2, 8, 6, device=dev), planes, 1, 4)
    with pytest.raises(ValueError, match="planes"):
        lp.group_dir_planes(torch.zeros(2, 8, 5, device=dev,
                                        dtype=torch.bfloat16), planes * 2, 2,
                            2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("poles", [True, False])
def test_latlon_on_card_matches_cpu(dev, dtype, poles):
    """inv_trans_latlon (every row folds: T47 onto 36 longitudes) and
    dir_trans_latlon on the card against the CPU in fp64 (the slice's
    tolerance): the lat-lon tables by K4 (one launch a build, pole rows
    included) against the host recurrence, no Legendre kernel."""
    from ectrans_tpu_torch import latlon

    res = ett.setup("O48", 47)
    ll = ett.LatLonGrid(37, 36, poles)
    sp = [packed(res, n, seed) for n, seed in ((2, 6), (2, 7), (3, 8))]
    flags = ett.InvFlags(vorgp=True, divgp=True, scders=True, uvders=True)
    want = ett.inv_trans_latlon(res, ll, *map(torch.from_numpy, sp),
                                flags=flags, dtype=torch.float64)
    tg.gen_groups.launches = 0
    ld.group_inv_dense.launches = 0
    got = ett.inv_trans_latlon(res, ll, *(torch.as_tensor(x, device=dev)
                                          for x in sp),
                               flags=flags, dtype=dtype)
    assert tg.gen_groups.launches == 1 and ld.group_inv_dense.launches == 0
    atol, rtol = SLICE_TOL[dtype]
    assert got.device == dev and got.dtype == dtype
    assert (got.cpu().double() - want).abs().max() <= atol + rtol * (
        want.abs().max())
    gl, racthe = latlon.latlon_tables(res, ll, torch.float64, dev)
    hgl, hrac = latlon.latlon_tables(res, ll, torch.float64, "cpu")
    for g, h in zip(gl.groups, hgl.groups):
        assert (g.psym.cpu() - h.psym).abs().max() <= 1e-12
        assert (g.pasym.cpu() - h.pasym).abs().max() <= 1e-12
    assert torch.equal(racthe.cpu(), hrac)
    fields = [want[4:6], want[6:8], want[8:11]]
    back = ett.dir_trans_latlon(res, ll, *(f.to(dev, dtype) for f in fields),
                                dtype=dtype)
    ref = ett.dir_trans_latlon(res, ll, *fields, dtype=torch.float64)
    for a, b in zip(back, ref):
        assert a.device == dev
        err = (a.cpu().double() - b).abs().max().item()
        assert err <= atol + rtol * b.abs().max().item()


@pytest.mark.parametrize("dtype", DTYPES)
def test_lam_on_card_matches_cpu(dev, dtype):
    """inv_trans_lam, dir_trans_lam, both adjoints and biperiodicize on the
    card against the CPU in fp64 (the slice's tolerance); no kernel."""
    from ectrans_tpu_torch import lam

    res = lam.setup_lam(lam.make_lam_grid(64, 48, nxux=53, nyux=37,
                                          dx=1300.0, dy=1300.0))
    rng = np.random.default_rng(9)
    sp = [rng.standard_normal((n, res.nspec2)) for n in (2, 2, 3)]
    sp += [rng.standard_normal(2), rng.standard_normal(2)]
    flags = lam.LamInvFlags(vorgp=True, divgp=True, scders=True, uvders=True)
    counters = [tg.gen_groups, ld.group_inv_dense, ld.group_dir_dense]
    for c in counters:
        c.launches = 0
    want = lam.inv_trans_lam(res, *map(torch.from_numpy, sp), flags=flags,
                             dtype=torch.float64)
    got = lam.inv_trans_lam(res, *(torch.as_tensor(x, device=dev)
                                   for x in sp), flags=flags, dtype=dtype)
    atol, rtol = SLICE_TOL[dtype]

    def close(a, b, scale=None):
        assert a.device == dev and a.dtype == dtype
        err = (a.cpu().double() - b).abs().max().item()
        scale = b.abs().max().item() if scale is None else scale
        assert err <= atol + rtol * scale

    close(got, want)
    fields = [want[4:6], want[6:8], want[8:11]]
    out = lam.dir_trans_lam(res, *(f.to(dev, dtype) for f in fields),
                            dtype=dtype)
    ref = lam.dir_trans_lam(res, *fields, dtype=torch.float64)
    for a, b in zip(out[:3], ref[:3]):
        close(a, b)
    # the mean wind is its wind field's (0, 0) coefficient: as exact as
    # that field (~4e5 here, at 1.3 km), not as its own size
    for a, b, w in zip(out[3:], ref[3:], fields[:2]):
        close(a, b, w.abs().max().item())
    y = torch.from_numpy(rng.standard_normal(tuple(want.shape)))
    for a, b in zip(lam.inv_trans_lam_adj(res, y.to(dev), 2, 3, flags=flags,
                                          dtype=dtype),
                    lam.inv_trans_lam_adj(res, y, 2, 3, flags=flags,
                                          dtype=torch.float64)):
        close(a, b)
    f = torch.from_numpy(rng.standard_normal((2, 37, 53)))
    close(lam.biperiodicize(f.to(dev, dtype), res.grid),
          lam.biperiodicize(f, res.grid))
    assert not any(c.launches for c in counters)


def test_latlon_fp64_tables_repeat_and_match_cpu_at_tco_nodes(dev):
    """K4's fp64 lat-lon tables at TCO1279 onto the 0.25 degree grid with
    poles: a second build, made in memory filled with NaN first (a read of
    an unwritten element would show), bit-identical to the first; the
    card's tables at nodes from pole to equator against the CPU's (the
    host's fp64 recurrence) within 1e-11 of their largest |value|: 1e-14
    away from the poles, ~3.5e-12 at 0.25 degrees from them, where both
    fp64 recurrences are ~5e-12 from a long-double one
    (test_torch_legendre.py)."""
    from ectrans_tpu_torch import latlon
    from ectrans_tpu_torch.legendre import build_parity_tables

    res = ett.setup("TCO1279")
    ll = ett.LatLonGrid(721, 1440)
    gl = latlon._build_tables(res, ll, torch.float64, dev)[0]
    x = torch.empty(int(torch.cuda.mem_get_info(dev)[0] * 0.5),
                    dtype=torch.uint8, device=dev)
    x.fill_(255)
    del x
    again = latlon._build_tables(res, ll, torch.float64, dev)[0]
    for a, b in zip(gl.groups, again.groups):
        assert torch.equal(a.psym, b.psym) and torch.equal(a.pasym, b.pasym)
    del again
    nodes = [0, 1, 2, 45, 90, 180, 270, 359, 360]
    psym, pasym, _ = build_parity_tables(res.nsmax, ll.mu[nodes], 1)
    for g in gl.groups:
        for card, host in ((g.psym, psym), (g.pasym, pasym)):
            ref = torch.from_numpy(host[g.m0:g.m1, :, :g.kg])
            err = (card[:, nodes].cpu() - ref).abs().max().item()
            assert err <= 1e-11 * ref.abs().max().item(), (g.m0, err)


def test_benchmark_driver_on_card_matches_cpu(dev, tmp_path, capsys):
    """The global driver (``programs.benchmark``) at T159 in fp64 on the
    card against ``--device cpu``: every array it dumps within 1e-12 of
    its largest |value|, both checks OK, K1-K4 launched on the card.  The
    check's multiplier is 1000: at T159 the fp64 norms drift 1.6e-13 in two
    round trips on either device, and in the JAX driver too (~360 eps an
    iteration), above 200 eps."""
    from ectrans_tpu_torch.programs import benchmark

    argv = ["-g", "O160", "-t", "159", "-n", "2", "-f", "2", "-l", "2",
            "--vordiv", "--scders", "--uvders", "--check", "1000", "--dtype",
            "float64"]
    counters = [ld.group_inv_dense, ld.group_dir_dense,
                pack.packed_from_group_rows, tg.gen_groups]
    out = {}
    for where in ("cpu", "cuda"):
        for c in counters:
            c.launches = 0
        path = tmp_path / f"{where}.npz"
        benchmark.main(argv + ["--device", where, "--dump-values", str(path)])
        assert "-> OK" in capsys.readouterr().out
        with np.load(path) as z:
            out[where] = {k: z[k] for k in z.files}
        ett.trans_end()
    assert all(c.launches for c in counters)
    for k, want in out["cpu"].items():
        err = np.abs(out["cuda"][k] - want).max()
        assert err <= 1e-12 * np.abs(want).max(), (k, err)
