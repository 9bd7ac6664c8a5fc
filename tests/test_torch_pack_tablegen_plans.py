"""The host-side plans of kernels K3 (packing) and K4 (table generator), on
the CPU: the cached per-group segments and launch constants of K3 against
the JAX package's packing plan (``pack_pallas.plan_for``) and the Resolution's
groups; K4's work order (group descriptors, longest chains first, blocks of
columns) against ``Resolution.legendre_groups()``; and emulations, in numpy
and PyTorch, of what each kernel computes from its plan: K3's warp-per-row
copy with the closed-form NASM0, and K4's recurrence with rescaling tested
every 4 steps on exponent bits, which must give the plain recurrence's
entries bit for bit.  The kernels themselves run on the card
(tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import ectrans_tpu as et
from ectrans_tpu.ops import pack_pallas

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.ops import legendre_tablegen as tg
from ectrans_tpu_torch.ops import pack

CONFIGS = [("T47", None), ("O48", 47), ("TCO95", None)]


@pytest.mark.parametrize("name,nsmax", CONFIGS)
def test_pack_segments_match_jax_plan(name, nsmax):
    """K3's segments: the JAX plan's groups and segment lengths, NASM0 at
    each group's first m, cached on the Resolution."""
    jres, res = et.setup(name, nsmax), ett.setup(name, nsmax)
    segs = pack.segments(res)
    plan = pack_pallas.plan_for(jres)
    assert [(m0, m1, s1 - s0) for m0, m1, s0, s1 in segs] == [
        (gp.m0, gp.m1, gp.seglen) for gp in plan.groups]
    assert [s0 for _, _, s0, _ in segs] == [int(res.nasm0[m0])
                                            for m0, _, _, _ in segs]
    assert segs[-1][3] == res.nspec2
    assert pack.segments(res) is segs
    m0s, shapes, nsmax, nspec2 = pack._launch_groups(res)
    assert list(m0s) == [m0 for m0, _, _, _ in res.legendre_groups()]
    assert shapes == tuple((m0, m1 - m0, res.nsmax + 1 - m0)
                           for m0, m1, _, _ in res.legendre_groups())
    assert (nsmax, nspec2) == (res.nsmax, res.nspec2)


@pytest.mark.parametrize("name,nsmax", CONFIGS + [("TCO1279", None)])
def test_pack_closed_form_nasm0(name, nsmax):
    """K3 computes NASM0[m] = m (2 nsmax + 3 - m), even, as the JAX
    package's offsets."""
    res = ett.setup(name, nsmax)
    m = np.arange(res.M, dtype=np.int64)
    closed = m * (2 * res.nsmax + 3 - m)
    np.testing.assert_array_equal(closed, res.nasm0)
    np.testing.assert_array_equal(closed, et.setup(name, nsmax).nasm0)
    assert not (closed % 2).any() and res.nspec2 % 2 == 0


def k3_emulation(rows_list, res, m0s) -> np.ndarray:
    """csrc/pack.cu's mapping in numpy: warp w packs field row f = w % nfld
    of m = w // nfld, from the last group whose first m is <= m, each pair
    (re, im) at NASM0[m] + 2 j."""
    nfld = rows_list[0].shape[1] // 2
    out = np.full((nfld, res.nspec2), np.nan)
    for w in range(res.M * nfld):
        m, f = divmod(w, nfld)
        k = max(i for i, g0 in enumerate(m0s) if g0 <= m)
        rows = rows_list[k]
        L = res.nsmax + 1 - m
        base = m * (2 * res.nsmax + 3 - m)
        out[f, base: base + 2 * L: 2] = rows[m - m0s[k], f, :L]
        out[f, base + 1: base + 2 * L: 2] = rows[m - m0s[k], nfld + f, :L]
    return out


@pytest.mark.parametrize("nfld", [1, 3])
@pytest.mark.parametrize("name,nsmax", CONFIGS)
def test_pack_kernel_mapping_is_the_gather(name, nsmax, nfld):
    """K3's warp-per-row mapping writes every packed value once, equal to
    the plain index gather, also from rows longer than the groups' J."""
    res = ett.setup(name, nsmax)
    rng = np.random.default_rng(nfld)
    rows = [rng.standard_normal((m1 - m0, 2 * nfld, J + 3))
            for m0, m1, _, J in res.legendre_groups()]
    m0s = list(pack._launch_groups(res)[0])
    got = k3_emulation(rows, res, m0s)
    want = pack.packed_from_group_rows_plain(
        [torch.from_numpy(r) for r in rows], res).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,nsmax", CONFIGS + [("O160", 159)])
def test_tablegen_plan_covers_every_column_once(name, nsmax):
    """K4's work order for Resolution.legendre_groups(): longest chains
    first, each group on consecutive blocks; a block's group is the last
    whose first block is <= it (the kernel's lookup), and the blocks' flat
    columns cover every (m, latitude) of every group exactly once."""
    res = ett.setup(name, nsmax)
    groups = res.legendre_groups()
    desc, nblocks = tg.launch_plan(groups, res.ndgnh)
    assert sorted(d[0] for d in desc) == list(range(len(groups)))
    assert [d[3] for d in desc] == sorted((g[3] for g in groups),
                                          reverse=True)
    seen = {k: np.zeros((m1 - m0, res.ndgnh - i0), np.int64)
            for k, (m0, m1, i0, J) in enumerate(groups)}
    firsts = [d[6] for d in desc]
    assert firsts[0] == 0 and firsts == sorted(firsts)
    for b in range(nblocks):
        k, m0, gm, J, i0, ig, block0 = desc[max(
            i for i, f in enumerate(firsts) if f <= b)]
        assert groups[k] == (m0, m0 + gm, i0, J) and ig == res.ndgnh - i0
        col = (b - block0) * tg.THREADS + np.arange(tg.THREADS)
        col = col[col < gm * ig]
        np.add.at(seen[k], (col // ig, col % ig), 1)
    assert all((s == 1).all() for s in seen.values())


def test_tablegen_plan_refuses_more_groups_than_a_launch_takes():
    """A K4 launch takes any count of groups from one (past 16 their
    descriptors go to a device array): the plan refuses an empty launch,
    and plans 24 and 48 groups (one an m) in launch order, first blocks
    ascending from 0."""
    res = ett.setup("O48", 47)
    with pytest.raises(ValueError, match="at least one group"):
        tg.launch_plan([], res.ndgnh)
    for ngroups in (24, 48):
        groups = res.legendre_groups(ngroups)
        assert len(groups) == ngroups
        desc, nblocks = tg.launch_plan(groups, res.ndgnh)
        firsts = [d[6] for d in desc]
        assert firsts[0] == 0 and firsts == sorted(firsts)
        assert nblocks == firsts[-1] + -(-desc[-1][2] * desc[-1][5]
                                         // tg.THREADS)


def _pow2(e):
    return ((e + 1023) << 52).view(torch.float64)


def _exponent_bits(v):
    return (v.view(torch.int64) >> 52) & 0x7FF


def k4_emulation(inp, m0, m1, J, i0, dtype):
    """csrc/tablegen.cu's loop in fp64 PyTorch: emission by the cached
    scale 2^E (0 below -1022; fp64's two-step scaling there), the flush as
    an exponent-bit test, bf16 by way of fp32, and the rescaling tested
    every 4 steps on the exponent bits of p, scaling p and q alike."""
    x = inp["mu"][i0:]
    p = inp["mant"][m0:m1, i0:].clone()
    E = inp["exp"][m0:m1, i0:].to(torch.int64)
    q = torch.zeros_like(p)
    zero = torch.zeros_like(p)

    def scale(E):
        return torch.where(E >= -1022, _pow2(E.clamp(min=-1022)), zero)

    s = scale(E)
    out = torch.empty((m1 - m0, J, x.shape[0]), dtype=dtype)
    for t in range(J):
        v = p * s
        if dtype == torch.float64:
            e1 = torch.div(E, 2, rounding_mode="trunc").clamp(min=-1022)
            slow = p * _pow2(e1) * _pow2((E - e1).clamp(min=-1022))
            v = torch.where(E >= -1022, v, torch.where(E < -1400, zero, slow))
            out[:, t] = torch.where(_exponent_bits(v) != 0, v, zero)
        else:
            f = torch.where(_exponent_bits(v) >= 1023 - 126,
                            v.to(torch.float32), zero.float())
            out[:, t] = f.to(dtype)
        r = inp["A"][m0:m1, t + 1, None] * (x * p) - \
            inp["B"][m0:m1, t + 1, None] * q
        q, p = p, r
        if (t + 1) % 4 == 0:
            e = _exponent_bits(p)
            down, up = e > 1023 + 256, (e != 0) & (e < 1023 - 256)
            fac = torch.where(down, p.new_tensor(2.0 ** -256),
                              torch.where(up, p.new_tensor(2.0 ** 256),
                                          p.new_tensor(1.0)))
            p, q = p * fac, q * fac
            E = E + torch.where(down, 256, torch.where(up, -256, 0))
            s = scale(E)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_tablegen_kernel_schedule_is_bit_identical(dtype):
    """At F160 (full Gaussian grid: polar seeds down to 2^-1120, so fp64's
    two-step emission and the zero scale run), K4's schedule gives the
    plain recurrence's entries bit for bit on every group."""
    res = ett.setup("F160", 159)
    inp = tg._device_inputs(res, torch.device("cpu"))
    seeds = inp["exp"][inp["mant"] != 0]
    assert seeds.min() < -1022
    for m0, m1, i0, J in res.legendre_groups():
        want = tg.gen_group_plain(inp, m0, m1, J, i0, dtype)
        got = k4_emulation(inp, m0, m1, J, i0, dtype)
        assert torch.equal(got, want), m0


def test_tablegen_plain_bf16_is_rounded_fp32():
    """The plain bf16 table is the fp32 table rounded to nearest even (the
    two roundings the kernel and the JAX package apply)."""
    res = ett.setup("O48", 47)
    inp = tg._device_inputs(res, torch.device("cpu"))
    for m0, m1, i0, J in res.legendre_groups():
        assert torch.equal(
            tg.gen_group_plain(inp, m0, m1, J, i0, torch.bfloat16),
            tg.gen_group_plain(inp, m0, m1, J, i0,
                               torch.float32).to(torch.bfloat16))
