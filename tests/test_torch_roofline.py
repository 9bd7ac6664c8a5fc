"""The roofline probes' kernels K11 (copy) and K12 (read-reduce) of
ectrans_tpu_torch against the JAX probe's own kernel bodies.

``tools/roofline.py``'s jitted ``pallas_copy``/``pallas_reduce`` pass no
``interpret`` and cannot run on the CPU, and that file is not edited, so
the reference is a ``pl.pallas_call`` built here around its
``_copy_kernel``/``_reduce_kernel`` with the same grid and block specs, in
interpret mode, on a small array.  Tolerances: K11 bit-exact; K12 1e-6 of
the output's max (fp32 sums in another order).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ectrans_tpu_torch import roofline

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_roofline_probe", ROOT / "tools" / "roofline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JR = _jax_probe()


def jax_copy(x):
    n, c = x.shape
    t = JR.ROW_TILE
    return pl.pallas_call(
        JR._copy_kernel, grid=(n // t,),
        in_specs=[pl.BlockSpec((t, c), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((t, c), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        interpret=True)(x)


def jax_reduce(x):
    n, c = x.shape
    t = JR.ROW_TILE
    return pl.pallas_call(
        JR._reduce_kernel, grid=(n // t,),
        in_specs=[pl.BlockSpec((t, c), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((8, c), lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct((8, c), x.dtype),
        interpret=True)(x)


@pytest.fixture(scope="module")
def x():
    """Four of the probe's row tiles, 128 columns, from a numpy seed."""
    return np.random.default_rng(0).standard_normal(
        (4 * JR.ROW_TILE, 128)).astype(np.float32)


def test_copy_matches_jax_kernel(x):
    got = roofline.stream_copy(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_copy(jnp.asarray(x))))


def test_reduce_matches_jax_kernel(x):
    got = roofline.read_reduce(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_reduce(jnp.asarray(x)))
    assert got.shape == want.shape == (8, x.shape[1])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_probe_shapes_match_jax():
    assert (roofline.N_ROWS, roofline.N_COLS) == (JR.N_ROWS, 512)
    assert roofline.GROUP0 == dict(gm=80, J=2562, ig=1280, fc2=32)
