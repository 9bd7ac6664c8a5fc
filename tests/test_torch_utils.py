"""ectrans_tpu_torch.utils against ectrans_tpu.utils: NPROMA blocking and
field checksums bit for bit, the GSTATS report and the profiler and
NVTX ranges of hook."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ectrans_tpu as et
from ectrans_tpu import utils as jutils

import ectrans_tpu_torch as ett
from ectrans_tpu_torch.utils import (blocked_to_fields, field_checksum,
                                     fields_to_blocked, gstats,
                                     gstats_report, hook, reset_gstats, timed)


def padded_fields(res, nfld, seed):
    """Random fields, zero past each row's NLOEN (as the transforms give)."""
    f = np.random.default_rng(seed).standard_normal(
        (nfld, res.ndgl, res.grid.ndlon))
    mask = (np.arange(res.grid.ndlon)[None, :]
            < np.asarray(res.grid.nloen)[:, None])
    return f * mask[None]


@pytest.mark.parametrize("name,nsmax,nproma", [("O48", 47, 17),
                                               ("F24", 47, 32),
                                               ("O48", 47, 1)])
def test_blocking_matches_jax(name, nsmax, nproma):
    res = ett.setup(name, nsmax)
    f = padded_fields(res, 3, nproma)
    blocked = fields_to_blocked(torch.from_numpy(f), res.grid, nproma)
    want = jutils.fields_to_blocked(f, et.setup(name, nsmax).grid, nproma)
    assert blocked.shape == want.shape and blocked.dtype == torch.float64
    np.testing.assert_array_equal(blocked.numpy(), want)
    back = blocked_to_fields(blocked, res.grid)
    np.testing.assert_array_equal(back.numpy(), f)
    np.testing.assert_array_equal(
        back.numpy(), jutils.blocked_to_fields(want, et.setup(name,
                                                              nsmax).grid))
    # numpy in, tensor out
    assert torch.equal(fields_to_blocked(f, res.grid, nproma), blocked)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32])
def test_checksum_matches_jax(dtype):
    a = (np.arange(60).reshape(3, 4, 5) * 0.37).astype(dtype)
    want = jutils.field_checksum(jnp.asarray(a))
    assert field_checksum(a) == want
    assert field_checksum(torch.from_numpy(a)) == want
    # a non-contiguous view of the same values
    t = torch.from_numpy(a).transpose(0, 2).contiguous().transpose(0, 2)
    assert not t.is_contiguous() and field_checksum(t) == want


def test_checksum_stable_and_sensitive():
    a = np.arange(12.0).reshape(3, 4)
    c1 = field_checksum(a)
    assert c1 == field_checksum(a.copy())
    b = a.copy()
    b[0, 0] += 1e-15
    assert field_checksum(b) != c1
    assert field_checksum(a.reshape(4, 3)) != c1
    assert field_checksum(a.astype(np.float32)) != c1


def test_transform_output_checksum_is_deterministic():
    """Two identical transforms give one digest; a changed input another."""
    res = ett.setup("O48", 47)
    sc = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, res.nspec2)))
    a = field_checksum(ett.inv_trans(res, spscalar=sc))
    assert a == field_checksum(ett.inv_trans(res, spscalar=sc.clone()))
    sc[1, 8] += 1.0                       # (m=0, n=4) real part
    assert a != field_checksum(ett.inv_trans(res, spscalar=sc))


def test_gstats_report():
    reset_gstats()
    with gstats("phase_a"):
        pass
    with hook("phase_b"):
        pass
    out = timed("phase_c", lambda x: (x + 1, [x * 2]), torch.ones(3))
    assert torch.equal(out[0], torch.full((3,), 2.0))
    rep = gstats_report(io.StringIO())
    assert "phase_a" in rep and "phase_b" in rep and "phase_c" in rep
    lines = rep.splitlines()
    assert lines[0].split() == ["region", "count", "total", "avg", "min",
                                "max"]
    assert [ln.split()[1] for ln in lines[1:]] == ["1", "1", "1"]
    reset_gstats()
    assert len(gstats_report().splitlines()) == 1


def test_hook_marks_the_profiler_trace():
    with torch.profiler.profile() as prof:
        with hook("ectrans_region"):
            torch.ones(4).sum()
    assert any(e.name == "ectrans_region" for e in prof.events())

