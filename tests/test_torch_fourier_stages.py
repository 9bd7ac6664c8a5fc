"""The stages of the bucketed chirp-z Fourier layer (``ops/fourier.py``) on
the CPU: each plain stage (the version a CPU tensor runs, and the one the
card's kernels F1-F4 are held to) against a direct numpy formula on O48's
rows in three buckets, in fp32 and fp64 and with an even and an odd field
count; the pass calls each stage once a bucket; the layer's
``autograd.Function``s against ``torch.autograd.gradcheck`` in fp64.

Tolerances: the fp64 stages 1e-13 of the largest |value| (the formulas'
arithmetic in another order); the outputs rounded once to fp32 within one
fp32 ulp of each field's largest |value| (a value rounded from two fp64
results 1e-13 apart may land one ulp apart)."""

import types

import numpy as np
import pytest
import torch

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.ops import fourier

STAGE_CASES = [(dtype, nfld) for dtype in (torch.float32, torch.float64)
               for nfld in (3, 4)]


@pytest.fixture(scope="module")
def o48():
    """O48 T47 in three buckets, and the numpy view of their rows."""
    res = ett.setup("O48", 47)
    bt = fourier.bucket_tables(res.grid.nloen, res.nmen, res.nsmax,
                               fourier.bucket_spans(res.ndgl, 3),
                               res.grid.ndlon, "cpu")
    assert len(bt.buckets) == 3
    return res, bt


def _inputs(res, nfld, dtype, seed):
    rng = np.random.default_rng(seed)
    s = np.array([1.0, 1e3, 1e-4, 2.0])[:nfld]
    four = rng.standard_normal((nfld, 2, res.M, res.ndgl)) * s[:, None,
                                                              None, None]
    grid = rng.standard_normal((nfld, res.ndgl, res.grid.ndlon)) * s[:, None,
                                                                     None]
    return (torch.as_tensor(four, dtype=dtype),
            torch.as_tensor(grid, dtype=dtype))


def _chirp(k, L, sign):
    """exp(sign i pi k^2 / L), the phase reduced mod 2 pi exactly."""
    k = np.asarray(k, np.int64)
    return np.exp(sign * 1j * np.pi * ((k * k) % (2 * L)) / L)


def _scale(sumsq, count):
    r = np.sqrt(sumsq / count)
    return np.where(r > 0, r, 1.0)


def _np_rows(bk):
    return bk.rows[0].numpy(), bk.rows[1].numpy()


def _np_keep_sums(x, mkeep):
    """Each field's sum of squares over the kept inputs."""
    M = x.shape[2]
    keep = np.arange(M)[:, None] <= mkeep[None, :]
    keep = np.stack([keep, keep])
    keep[1, 0] = False
    return (x ** 2 * keep).sum((1, 2, 3))


def _close(got, want, rtol=1e-13):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rtol * np.abs(want).max()


def _fields_close(got, want, dtype):
    """fp64: 1e-13 of each field's max; fp32: one ulp of it."""
    got = np.asarray(got, np.float64)
    for f in range(want.shape[0]):
        s = np.abs(want[f]).max()
        tol = (1e-13 * s if dtype == torch.float64
               else np.spacing(np.float32(s)))
        assert np.abs(got[f] - want[f]).max() <= tol, f


@pytest.mark.parametrize("dtype,nfld", STAGE_CASES)
def test_sums_match_numpy(o48, dtype, nfld):
    """F4's plain stage: each field's sum of squares over the inputs
    synthesis reads, and over each bucket's points j < NLOEN."""
    res, bt = o48
    four, grid = _inputs(res, nfld, dtype, 1)
    x = four.double().numpy()
    _close(fourier.sums_synthesis_plain(four, bt)[:, 0],
           _np_keep_sums(x, bt.mkeep.numpy()))
    g = grid.double().numpy()
    want = np.zeros((nfld, len(bt.buckets)))
    for ib, bk in enumerate(bt.buckets):
        for row, L in zip(*_np_rows(bk)):
            want[:, ib] += (g[:, row, :L] ** 2).sum(-1)
    _close(fourier.sums_analysis_plain(grid, bt)[..., 0], want)


@pytest.mark.parametrize("dtype,nfld", STAGE_CASES)
def test_pre_synthesis_matches_numpy(o48, dtype, nfld):
    """F1's plain stage, synthesis: the kept modes m <= min(nmen, mb) over
    each field's RMS, packed w_k = F_a,k + i F_b,k (k >= 0) and conj F_a,|k|
    + i conj F_b,|k| (k < 0) at slot mb + k, times e^{i pi k^2 / L}, zero
    up to nfft; pairs p0 = 1 on as a chunk of their own."""
    res, bt = o48
    four, _ = _inputs(res, nfld, dtype, 2)
    x = four.double().numpy()
    mkeep = bt.mkeep.numpy()
    s = _scale(_np_keep_sums(x, mkeep), 2.0 * res.M * res.ndgl)
    ss = fourier.sums_synthesis_plain(four, bt)
    npairs = (nfld + 1) // 2
    for bk in bt.buckets:
        mb = bk.mb
        want = np.zeros((npairs, bk.rows.shape[1], bk.nfft), complex)
        for p in range(npairs):
            for i, (row, L) in enumerate(zip(*_np_rows(bk))):
                me = min(mkeep[row], mb)
                m = np.arange(me + 1)

                def coef(f):
                    if f >= nfld:
                        return np.zeros(me + 1, complex)
                    im = np.where(m > 0, x[f, 1, m, row], 0.0)
                    return (x[f, 0, m, row] + 1j * im) / s[f]

                fa, fb = coef(2 * p), coef(2 * p + 1)
                want[p, i, mb + m] = (fa + 1j * fb) * _chirp(m, L, 1)
                want[p, i, mb - m[1:]] = ((fa.conj() + 1j * fb.conj())[1:]
                                          * _chirp(m[1:], L, 1))
        got = fourier.pre_synthesis_plain(four, bt, bk, ss, 0, npairs)
        assert got.dtype == torch.complex128
        _close(got.numpy(), want)
        if npairs > 1:
            _close(fourier.pre_synthesis_plain(four, bt, bk, ss, 1,
                                               npairs).numpy(), want[1:])


@pytest.mark.parametrize("dtype,nfld", STAGE_CASES)
def test_pre_analysis_matches_numpy(o48, dtype, nfld):
    """F1's plain stage, analysis: z_j = (f_a,j / RMS_a + i f_b,j / RMS_b)
    e^{-i pi j^2 / L} for j < NLOEN, the RMS over the bucket's points,
    zero up to nfft."""
    res, bt = o48
    _, grid = _inputs(res, nfld, dtype, 3)
    g = grid.double().numpy()
    ss = fourier.sums_analysis_plain(grid, bt)
    npairs = (nfld + 1) // 2
    for ib, bk in enumerate(bt.buckets):
        rows, Ls = _np_rows(bk)
        sq = np.array([sum((g[f, r, :L] ** 2).sum() for r, L in
                           zip(rows, Ls)) for f in range(nfld)])
        s = _scale(sq, len(rows) * bk.ndlon)
        want = np.zeros((npairs, len(rows), bk.nfft), complex)
        for p in range(npairs):
            for i, (row, L) in enumerate(zip(rows, Ls)):
                fa = g[2 * p, row, :L] / s[2 * p]
                fb = (g[2 * p + 1, row, :L] / s[2 * p + 1]
                      if 2 * p + 1 < nfld else 0.0)
                want[p, i, :L] = (fa + 1j * fb) * _chirp(np.arange(L), L, -1)
        _close(fourier.pre_analysis_plain(grid, bt, bk, ib, ss, 0,
                                          npairs).numpy(), want)


@pytest.mark.parametrize("direction", ["synthesis", "analysis"])
def test_product_matches_numpy(o48, direction):
    """F2's plain stage: a times the FFT of the offset chirp kernel over
    nfft, in place: b[u mod nfft] = e^{-i pi (u + mb)^2 / L} on u = -2 mb
    .. L - 1 (synthesis), e^{+i pi (u - mb)^2 / L} on u = -(L - 1) .. 2 mb
    (analysis)."""
    res, bt = o48
    rng = np.random.default_rng(4)
    for bk in bt.buckets:
        mb, n = bk.mb, bk.nfft
        a = (rng.standard_normal((2, bk.rows.shape[1], n))
             + 1j * rng.standard_normal((2, bk.rows.shape[1], n)))
        bh = np.zeros((bk.rows.shape[1], n), complex)
        for i, L in enumerate(_np_rows(bk)[1]):
            if direction == "synthesis":
                u = np.arange(-2 * mb, L)
                bh[i, u % n] = _chirp(u + mb, L, -1)
            else:
                u = np.arange(-(L - 1), 2 * mb + 1)
                bh[i, u % n] = _chirp(u - mb, L, 1)
        got = torch.from_numpy(a.copy())
        fourier.chirp_product(got, bk.syn_bh if direction == "synthesis"
                              else bk.ana_bh)
        _close(got.numpy(), a * np.fft.fft(bh, axis=-1) / n)


@pytest.mark.parametrize("dtype,nfld", STAGE_CASES)
def test_post_synthesis_matches_numpy(o48, dtype, nfld):
    """F3's plain stage, synthesis: g_j = b_j e^{i pi j^2 / L} for j < L,
    Re g to field 2p and Im g to 2p + 1 times their RMS, rounded once,
    zeros past NLOEN; a chunk from p0 = 1 writes only its own fields."""
    res, bt = o48
    four, _ = _inputs(res, nfld, dtype, 5)
    ss = fourier.sums_synthesis_plain(four, bt)
    s = _scale(ss[:, 0].numpy(), 2.0 * res.M * res.ndgl)
    npairs = (nfld + 1) // 2
    rng = np.random.default_rng(6)
    want = np.zeros((nfld, res.ndgl, res.grid.ndlon))
    got = torch.full((nfld, res.ndgl, res.grid.ndlon), 7.0, dtype=dtype)
    for bk in bt.buckets:
        b = (rng.standard_normal((npairs, bk.rows.shape[1], bk.nfft))
             + 1j * rng.standard_normal((npairs, bk.rows.shape[1], bk.nfft)))
        for p in range(npairs):
            for i, (row, L) in enumerate(zip(*_np_rows(bk))):
                gj = b[p, i, :L] * _chirp(np.arange(L), L, 1)
                want[2 * p, row, :L] = gj.real * s[2 * p]
                if 2 * p + 1 < nfld:
                    want[2 * p + 1, row, :L] = gj.imag * s[2 * p + 1]
        bt_ = torch.from_numpy(b)
        fourier.post_synthesis_plain(bt_[:1], bt, bk, ss, got, 0)
        if npairs > 1:
            fourier.post_synthesis_plain(bt_[1:], bt, bk, ss, got, 1)
    assert got.dtype == dtype
    _fields_close(got.numpy(), want, dtype)


@pytest.mark.parametrize("dtype,nfld", STAGE_CASES)
def test_post_analysis_matches_numpy(o48, dtype, nfld):
    """F3's plain stage, analysis: v_t = b_t e^{-i pi (t - mb)^2 / L} / L
    for |t - mb| <= min(nmen, mb), F_a,m = (Z_m + conj Z_{-m}) / 2 and
    F_b,m = (Z_m - conj Z_{-m}) / 2i with Z_k = v_{mb + k}, times the
    bucket's RMS, rounded once; zeros from min(M, mb + 1) up (M = 40 here,
    below the top buckets' mb + 1)."""
    res, bt = o48
    _, grid = _inputs(res, nfld, dtype, 7)
    ss = fourier.sums_analysis_plain(grid, bt)
    M = 40
    npairs = (nfld + 1) // 2
    mkeep = bt.mkeep.numpy()
    rng = np.random.default_rng(8)
    want = np.zeros((nfld, 2, M, res.ndgl))
    got = torch.full((nfld, 2, M, res.ndgl), 7.0, dtype=dtype)
    for ib, bk in enumerate(bt.buckets):
        mb = bk.mb
        s = _scale(ss[:, ib, 0].numpy(), bk.rows.shape[1] * bk.ndlon)
        b = (rng.standard_normal((npairs, bk.rows.shape[1], bk.nfft))
             + 1j * rng.standard_normal((npairs, bk.rows.shape[1], bk.nfft)))
        for p in range(npairs):
            for i, (row, L) in enumerate(zip(*_np_rows(bk))):
                me = min(mkeep[row], mb, M - 1)
                if me < 0:
                    continue
                m = np.arange(me + 1)
                zp = b[p, i, mb + m] * _chirp(m, L, -1) / L
                zn = b[p, i, mb - m] * _chirp(m, L, -1) / L
                fa = (zp + zn.conj()) / 2
                fb = (zp - zn.conj()) / 2j
                want[2 * p, 0, m, row] = fa.real * s[2 * p]
                want[2 * p, 1, m, row] = fa.imag * s[2 * p]
                if 2 * p + 1 < nfld:
                    want[2 * p + 1, 0, m, row] = fb.real * s[2 * p + 1]
                    want[2 * p + 1, 1, m, row] = fb.imag * s[2 * p + 1]
        fourier.post_analysis_plain(torch.from_numpy(b), bt, bk, ib, ss,
                                    got, 0)
    _fields_close(got.numpy(), want, dtype)


@pytest.mark.parametrize("normalize", [True, False])
def test_pass_calls_each_stage_once_a_bucket(o48, monkeypatch, normalize):
    """A call runs F1, the FFT, F2, the inverse FFT and F3 once a bucket
    (one chunk) and F4 once when it normalizes: 5 a bucket, + 1."""
    res, bt = o48
    four, grid = _inputs(res, 3, torch.float64, 9)
    calls = []
    for name in ("sums_synthesis", "sums_analysis", "pre_synthesis",
                 "pre_analysis", "chirp_fft", "chirp_product",
                 "post_synthesis", "post_analysis"):
        inner = getattr(fourier, name)

        def spy(*a, _inner=inner, _name=name, **k):
            calls.append(_name)
            return _inner(*a, **k)

        monkeypatch.setattr(fourier, name, spy)
    nb = len(bt.buckets)
    fourier.synthesis_bucketed(four, bt, normalize)
    assert len(calls) == 5 * nb + normalize
    assert calls.count("chirp_fft") == 2 * nb
    assert calls.count("sums_synthesis") == normalize
    calls.clear()
    fourier.analysis_bucketed(grid, bt, res.M, normalize)
    assert len(calls) == 5 * nb + normalize
    assert calls.count("post_analysis") == nb


def test_bucket_tables_take_every_row_once():
    """Spans missing a row or holding one twice are refused (the passes
    write every output row, so none is left unwritten)."""
    res = ett.setup("O16")
    args = (res.grid.nloen, res.nmen, res.nsmax)
    with pytest.raises(ValueError, match="every row once"):
        fourier.bucket_tables(*args, [((0, 16),), ((17, 32),)],
                              res.grid.ndlon, "cpu")
    with pytest.raises(ValueError, match="every row once"):
        fourier.bucket_tables(*args, [((0, 17),), ((16, 32),)],
                              res.grid.ndlon, "cpu")


@pytest.mark.parametrize("mesh", [False, True])
def test_bucket_rows_are_one_table(o48, mesh):
    """Each bucket's (2, rows) table (layer row, NLOEN) is a view of the
    tables' ``rows`` from 2 ``starts[b]`` on, in bucket order; ``keep`` and
    ``nloen`` follow from ``mkeep`` and that table (on a mesh rank's
    tables too, whose pad rows have NLOEN 0 and keep nothing)."""
    from ectrans_tpu_torch.parallel import distribution as tdist

    res, bt = o48
    nloen = np.asarray(res.grid.nloen)
    nmen = np.minimum(np.asarray(res.nmen), res.nsmax)
    if mesh:
        dist = tdist.build_distribution(res, 3, 1)
        bt = tdist.rank_fourier(dist, 1, "cpu")
        nloen = bt.nloen.numpy()
    starts = bt.starts.numpy()
    assert starts[0] == 0 and starts[-1] == bt.nrows
    assert bt.rows.shape == (2 * bt.nrows,) and bt.rows.is_contiguous()
    seen = []
    for b, bk in enumerate(bt.buckets):
        s0, s1 = starts[b], starts[b + 1]
        assert bk.rows.shape == (2, s1 - s0) and bk.rows.is_contiguous()
        assert bk.rows.data_ptr() == bt.rows[2 * s0:].data_ptr()
        rows = np.concatenate([np.arange(a, e) for a, e in bk.spans])
        assert np.array_equal(bk.rows[0].numpy(), rows)
        assert np.array_equal(bk.rows[1].numpy(), nloen[rows])
        seen.extend(rows)
    assert sorted(seen) == list(range(bt.nrows))
    assert np.array_equal(bt.nloen.numpy(), nloen)
    mkeep = bt.mkeep.numpy()
    if not mesh:
        assert np.array_equal(mkeep, np.where(nloen > 0, nmen, -1))
    assert np.all(mkeep[nloen == 0] == -1)
    keep = np.arange(res.M)[:, None] <= mkeep[None, :]
    keep = np.stack([keep, keep])
    keep[1, 0] = False
    assert bt.keep.dtype == torch.bool
    assert np.array_equal(bt.keep.numpy(), keep)


# three buckets of O8's and O16's rows (their own spans: bucket_spans gives
# one); gradcheck's full Jacobian on O8, its random projections on O16
GRADCHECK_CASES = [
    ("O8", [((0, 3), (13, 16)), ((3, 6), (10, 13)), ((6, 10),)], 1, False),
    ("O16", [((0, 5), (27, 32)), ((5, 11), (21, 27)), ((11, 21),)], 2,
     True)]


@pytest.mark.parametrize("name,spans,nfld,fast", GRADCHECK_CASES)
@pytest.mark.parametrize("direction", ["synthesis", "analysis"])
def test_functions_pass_gradcheck(direction, name, spans, nfld, fast):
    """Both directions' autograd Functions (normalize=False, fp64) on three
    buckets: the backward, the other direction's pass scaled row by row,
    against the finite differences of the forward."""
    res = ett.setup(name)
    bt = fourier.bucket_tables(res.grid.nloen, res.nmen, res.nsmax, spans,
                               res.grid.ndlon, "cpu")
    four, grid = _inputs(res, nfld, torch.float64, 10)
    if direction == "synthesis":
        fn = lambda x: fourier.synthesis_bucketed(x, bt, False)
        x = four
    else:
        fn = lambda x: fourier.analysis_bucketed(x, bt, res.M - 2, False)
        x = grid
    assert torch.autograd.gradcheck(fn, (x.requires_grad_(True),),
                                    fast_mode=fast)


def test_kernel_operand_checks_refuse_what_the_kernels_do_not_take(o48):
    """The checks the kernel wrappers make before passing pointers: a pass
    array of another dtype or shape or not contiguous, an output of
    another dtype or shape, sums of squares of another layout."""
    res, bt = o48
    bk = bt.buckets[0]
    good = torch.zeros((2,) + tuple(bk.syn_bh.shape), dtype=torch.complex128)
    fourier._check_pass(good, bk.syn_bh)
    for bad in (good.to(torch.complex64), good[:, :-1],
                good.transpose(0, 1)):
        with pytest.raises(ValueError, match="contiguous complex128"):
            fourier._check_pass(bad, bk.syn_bh)
    out = torch.zeros((3, res.ndgl, res.grid.ndlon))
    fourier._check_out(out, bt, (None, bt.nrows, bt.ndlon))
    for bad in (out.half(), out[:, :-1], out.transpose(1, 2)):
        with pytest.raises(ValueError, match="contiguous float32"):
            fourier._check_out(bad, bt, (None, bt.nrows, bt.ndlon))
    fourier._check_sums(torch.zeros((3, fourier.NP), dtype=torch.float64),
                        (3, fourier.NP))
    with pytest.raises(ValueError, match="sums of squares"):
        fourier._check_sums(torch.zeros((3, 1), dtype=torch.float64),
                            (3, fourier.NP))


# F5, the fused pass (``csrc/fourier_fused.cu``): which buckets run it, and
# the host tables its FFT takes, against numpy in float64
def _grid_bucket_nfft(name: str) -> list:
    from ectrans_tpu_torch import grids

    g = grids.make_grid(name)
    nloen, nmen = np.asarray(g.nloen), g.nmen()
    out = []
    for spans in fourier.bucket_spans(g.ndgl, 12):
        rows = np.concatenate([np.arange(a, b) for a, b in spans])
        out.append(fourier.bucket_shape(nloen[rows], nmen[rows], g.nsmax)[2])
    return out


# an H100 block's opt-in shared memory (bytes)
H100_BLOCK_SMEM = 227 * 1024


@pytest.mark.parametrize("name,staged", [("TCO639", 0), ("TCO1279", 0),
                                         ("TCO2559", 4)])
def test_fused_dispatch_follows_the_bucket_shapes(name, staged):
    """A bucket runs F5 on a card when its block's shared memory (the row
    padded by one element in 8, the twiddles and the pair's RMS, 16 bytes
    each) fits the 227 KB an H100's block may use: all twelve buckets of
    TCO639 and TCO1279 (nfft up to 7,776), and TCo2559's but its four
    equatorial ones (nfft 12,960 to 15,435), which run staged."""
    nffts = _grid_bucket_nfft(name)
    assert len(nffts) == 12
    fits = [fourier.fuses(n, H100_BLOCK_SMEM) for n in nffts]
    assert fits == [True] * (12 - staged) + [False] * staged
    for n in nffts:
        assert fourier.fused_smem_bytes(n) == 16 * (
            n + n // 8 + fourier.FINE + -(-n // fourier.FINE) + 1)
    if name == "TCO1279":
        assert max(nffts) == 7776
        assert fourier.fused_smem_bytes(7776) == 142960
    if name == "TCO2559":
        assert nffts[-1] == 15435 and min(nffts[-staged:]) == 12960


def test_smem_limit_is_the_cards_own(monkeypatch):
    """F5's limit is the card's opt-in shared memory a block, read once a
    card; ``_SMEM_LIMIT``, where set, takes its place."""
    reads = []

    def props(index):
        reads.append(index)
        return types.SimpleNamespace(
            shared_memory_per_block_optin=1000 * (index + 1))

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    fourier._optin.cache_clear()
    try:
        assert fourier.smem_limit(torch.device("cuda", 0)) == 1000
        assert fourier.smem_limit("cuda:0") == 1000
        assert fourier.smem_limit(torch.device("cuda")) == 2000
        assert reads == [0, 1]
        monkeypatch.setattr(fourier, "_SMEM_LIMIT", 0)
        assert fourier.smem_limit(torch.device("cuda", 0)) == 0
        assert reads == [0, 1]
    finally:
        fourier._optin.cache_clear()


# one nfft of each factor set TCO1279's buckets use, and TCO639's shortest
PLAN_NFFT = [882, 1715, 3969, 6860, 7776, 480]


@pytest.mark.parametrize("nfft", PLAN_NFFT)
def test_twiddle_table_matches_numpy(nfft):
    """F5's twiddle table in float64: W^l (l < FINE) and W^(FINE h) equal
    numpy's e^(-2 pi i k / nfft) within 8 eps, and every W^e, e < nfft, as
    the kernel forms it (one coarse entry times one fine) within 16 eps
    (the roundings of the product, and of the phases in both: 2 pi k /
    nfft near 2 pi is rounded to 2 eps)."""
    tw = fourier.twiddle_table(nfft)
    assert tw.dtype == np.complex128
    F = fourier.FINE
    k = np.concatenate([np.arange(F), F * np.arange(-(-nfft // F))])
    np.testing.assert_allclose(tw, np.exp(-2j * np.pi * k / nfft), rtol=0,
                               atol=8 * np.finfo(np.float64).eps)
    e = np.arange(nfft)
    w = tw[F + e // F] * tw[e % F]
    assert np.abs(w - np.exp(-2j * np.pi * e / nfft)).max() <= (
        16 * np.finfo(np.float64).eps)


def _f5_fft_model(x, radices, place, inverse=False):
    """The passes of F5's FFT in numpy, as the kernel makes them: forward,
    slot s at position place[s], decimation in time over the radices in
    order (twiddles before each butterfly), natural order out; inverse,
    natural order in, decimation in frequency over the radices in reverse
    order (conjugate twiddles after each butterfly), point j left at
    position place[j]."""
    N = len(x)
    sign = 1.0 if inverse else -1.0
    if inverse:
        a, order = x.astype(complex), radices[::-1]
    else:
        a = np.zeros(N, complex)
        a[place] = x
        order = radices
    L = 1 if not inverse else N
    for R in order:
        Ls = L * R if not inverse else L
        Lb = Ls // R
        t = np.arange(N // R)
        b, j = t // Lb, t % Lb
        idx = (b * Ls + j)[:, None] + Lb * np.arange(R)[None, :]
        tw = np.exp(sign * 2j * np.pi * (j * (N // Ls))[:, None]
                    * np.arange(R)[None, :] / N)
        dft = np.exp(sign * 2j * np.pi * np.outer(np.arange(R),
                                                  np.arange(R)) / R)
        v = a[idx]
        a[idx] = (v @ dft) * tw if inverse else (v * tw) @ dft
        L = Ls if not inverse else Lb
    return a[place] if inverse else a


@pytest.mark.parametrize("nfft", PLAN_NFFT)
def test_fft_plan_and_places_give_numpys_fft(nfft):
    """fft_radices (the fewest radices of 2 to 12, the best-read first)
    multiply to nfft, and with digit_places (a permutation) the kernel's
    passes, modelled in numpy, give numpy's FFT and its unnormalized
    inverse."""
    rad = fourier.fft_radices(nfft)
    assert int(np.prod(rad)) == nfft and set(rad) <= set(fourier.RADICES)
    place = fourier.digit_places(rad)
    assert np.array_equal(np.sort(place), np.arange(nfft))
    assert fourier.fft_plan(rad) == sum(r << 4 * i for i, r in
                                        enumerate(rad))
    rng = np.random.default_rng(nfft)
    x = rng.standard_normal(nfft) + 1j * rng.standard_normal(nfft)
    X = _f5_fft_model(x, rad, place)
    np.testing.assert_allclose(X, np.fft.fft(x), rtol=0,
                               atol=1e-12 * np.abs(X).max())
    y = _f5_fft_model(X, rad, place, inverse=True)
    np.testing.assert_allclose(y, nfft * x, rtol=0,
                               atol=1e-12 * np.abs(y).max())


def test_bucket_tables_carry_the_fused_tables(o48):
    """Each bucket's F5 tables: its radices, its places (nfft,) int16 and
    its twiddles, those of ``fft_radices``, ``digit_places`` and
    ``twiddle_table`` for its nfft."""
    _, bt = o48
    for bk in bt.buckets:
        assert bk.radices == fourier.fft_radices(bk.nfft)
        assert bk.place.dtype == torch.int16 and bk.place.shape == (bk.nfft,)
        assert np.array_equal(bk.place.numpy(),
                              fourier.digit_places(bk.radices))
        assert torch.equal(bk.twiddles,
                           torch.as_tensor(fourier.twiddle_table(bk.nfft)))


def test_layer_counts_its_fused_and_staged_buckets(o48):
    """Each call of the layer counts its buckets run fused and staged
    (``fourier.fused``, ``fourier.staged``) while the recorder is on: on
    the CPU every bucket runs the plain stages."""
    from ectrans_tpu_torch.utils import timing

    res, bt = o48
    four, grid = _inputs(res, 3, torch.float64, 11)
    timing.enable()
    try:
        timing.reset_gstats()
        fourier.synthesis_bucketed(four, bt)
        fourier.analysis_bucketed(grid, bt, res.M)
        got = timing.counters()
    finally:
        timing.disable()
        timing.reset_gstats()
    assert got == {"fourier.fused": 0, "fourier.staged": 2 * len(bt.buckets)}
