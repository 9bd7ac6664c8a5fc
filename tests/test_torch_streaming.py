"""The launch plans and the summation order of the streaming kernels K11
(``stream_copy``) and K12 (``read_reduce``) of ``ectrans_tpu_torch.roofline``,
and the wrappers' refusals, on the CPU: the CUDA kernels need a card,
but their launches are computed in Python (``copy_plan``, ``reduce_plan``,
which the wrappers pass to ``csrc/roofline.cu``) and K12's result rests on
the order in which it adds.

* Plans: every 16-byte word (K11) and every octet of 8 rows in every lane
  window (K12) is covered exactly once, no block is empty, a K12 stage holds
  at most 32 KB, and the scratch holds one (8, cols) partial a slice; at the
  probe's shape and at uneven ones, for the H100 SXM's 132 SMs, the PCIe
  card's 114 and one.
* K12's order in fp32 (each block adds its slice's octets in order, then
  eight warps add a contiguous share of the slices' partials each and the
  first adds the eight sums in order), emulated in numpy at (262144, 16) on
  seed-made data: within 1e-6 relative of the fp64 sum, the contract the
  card's tests hold the kernel to.
* Refusals: wrong dtype, a non-contiguous or misaligned tensor, rows % 8,
  cols % 4, n % 4, on the CPU as on the card.
"""

import numpy as np
import pytest
import torch

from ectrans_tpu_torch import roofline as rf

F32 = np.float32
FINAL_WARPS = 8     # K12's second pass (csrc/roofline.cu k12_final_kernel)
SMS = (132, 114, 1)
REDUCE_SHAPES = [(rf.N_ROWS, rf.N_COLS), (262144, 16), (1000, 12), (8, 4),
                 (64, 2052), (8 * 4099, 8), (8 * 17, 512)]


def assert_tiles(starts, stops, total):
    """[starts[i], stops[i]) are non-empty and tile [0, total) in order."""
    starts, stops = np.asarray(starts), np.asarray(stops)
    assert (stops > starts).all()
    assert starts[0] == 0 and stops[-1] == total
    assert (stops[:-1] == starts[1:]).all()


def ring_stages(plan):
    """The ring stages each K12 block loads under ``plan``: for each slice,
    [(first octet, octets), ...], ``ops`` octets a stage from the slice's
    first, the last stage what is left."""
    out = []
    for s in range(plan["slices"]):
        q0 = s * plan["per"]
        nq = min(plan["per"], plan["octets"] - q0)
        out.append([(q0 + k, min(plan["ops"], nq - k))
                    for k in range(0, nq, plan["ops"])])
    return out


@pytest.mark.parametrize("n", [4, 4 * 511, 4 * rf.COPY_CHUNK,
                               4 * (rf.COPY_CHUNK + 1), 4 * (3 * 512 + 7),
                               rf.N_ROWS * rf.N_COLS])
def test_copy_plan_covers_every_word_once(n):
    plan = rf.copy_plan(n)
    assert plan["words"] == n // 4 and plan["per"] == rf.COPY_CHUNK
    starts = np.arange(plan["blocks"], dtype=np.int64) * plan["per"]
    assert_tiles(starts, np.minimum(starts + plan["per"], plan["words"]),
                 plan["words"])


@pytest.mark.parametrize("sms", SMS)
@pytest.mark.parametrize("shape", REDUCE_SHAPES)
def test_reduce_plan_covers_every_octet_once(shape, sms):
    rows, cols = shape
    plan = rf.reduce_plan(rows, cols, sms)
    assert plan["lanes"] == 2 * cols and plan["octets"] == rows // 8
    assert plan["partial"] == (plan["slices"], 8, cols)
    # one wave: at most REDUCE_BLOCKS_PER_SM blocks an SM, unless the lane
    # windows alone are more
    blocks = plan["slices"] * plan["windows"]
    assert blocks <= max(sms * rf.REDUCE_BLOCKS_PER_SM, plan["windows"])
    widths = [min(rf.REDUCE_WINDOW, plan["lanes"] - w * rf.REDUCE_WINDOW)
              for w in range(plan["windows"])]
    assert min(widths) > 0 and sum(widths) == plan["lanes"]
    starts = np.arange(plan["slices"]) * plan["per"]
    assert_tiles(starts, np.minimum(starts + plan["per"], plan["octets"]),
                 plan["octets"])
    stages = [st for sl in ring_stages(plan) for st in sl]
    assert_tiles([q for q, _ in stages], [q + n for q, n in stages],
                 plan["octets"])
    assert plan["ops"] * max(widths) <= rf.STAGE_WORDS


def test_reduce_plan_at_the_probe_shape():
    """132 blocks of 249 octets (one an SM), 2 octets (32 KB) a stage."""
    plan = rf.reduce_plan(rf.N_ROWS, rf.N_COLS, 132)
    assert (plan["windows"], plan["slices"], plan["per"],
            plan["ops"]) == (1, 132, 249, 2)
    stages = ring_stages(plan)
    assert [len(s) for s in stages] == [125] * 131 + [len(stages[-1])]
    assert {n for s in stages[:-1] for _, n in s} == {1, 2}


def k12_order(x, plan):
    """K12's sums in fp32: block s adds the octets of its slice in order;
    the second pass's warp w adds the partials of slices [w chunk, (w + 1)
    chunk) in order, and the first warp adds the warps' sums in order."""
    rows, cols = x.shape
    slices, per = plan["slices"], plan["per"]
    octets = np.zeros((slices * per, 8 * cols), F32)
    octets[: rows // 8] = x.reshape(-1, 8 * cols)
    blocks = octets.reshape(slices, per, -1)
    acc = np.zeros((slices, 8 * cols), F32)
    for q in range(per):
        acc += blocks[:, q]
    chunk = -(-slices // FINAL_WARPS)
    sums = []
    for w in range(FINAL_WARPS):
        s = np.zeros(8 * cols, F32)
        for i in range(w * chunk, min(slices, (w + 1) * chunk)):
            s = s + acc[i]
        sums.append(s)
    out = sums[0]
    for s in sums[1:]:
        out = out + s
    return out.reshape(8, cols)


def test_k12_order_within_1e6_of_fp64():
    x = np.random.default_rng(11).standard_normal((262144, 16)).astype(F32)
    plan = rf.reduce_plan(*x.shape, 132)
    got = k12_order(x, plan)
    want = x.astype(np.float64).reshape(-1, 8, 16).sum(0)
    assert got.dtype == F32 and got.shape == (8, 16)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert 0 < rel <= 1e-6, rel


def misaligned(shape):
    """A contiguous float32 view that starts 4 bytes past an alignment."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1)[1:].view(shape)


@pytest.mark.parametrize("x, exc, match", [
    (torch.zeros(16, dtype=torch.float64), TypeError, "float32"),
    (torch.zeros(4, 8).t(), ValueError, "contiguous"),
    (torch.zeros(6), ValueError, "multiple of 4"),
    (misaligned((16,)), ValueError, "aligned"),
])
def test_stream_copy_refuses(x, exc, match):
    with pytest.raises(exc, match=match):
        rf.stream_copy(x)


@pytest.mark.parametrize("x, exc, match", [
    (torch.zeros(8, 4, dtype=torch.float64), TypeError, "float32"),
    (torch.zeros(8, 16).t(), ValueError, "contiguous"),
    (torch.zeros(12, 8), ValueError, "rows % 8"),
    (torch.zeros(16, 6), ValueError, "cols % 4"),
    (torch.zeros(64), ValueError, "rows"),
    (misaligned((8, 4)), ValueError, "aligned"),
])
def test_read_reduce_refuses(x, exc, match):
    with pytest.raises(exc, match=match):
        rf.read_reduce(x)


def test_plain_versions_on_the_cpu():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (64, 12)).astype(F32))
    assert torch.equal(rf.stream_copy(x), x)
    torch.testing.assert_close(rf.read_reduce(x),
                               x.reshape(8, 8, 12).sum(0), rtol=0, atol=0)
