"""The plain reference: its geometry, its Legendre functions, cases known
in closed form, and agreement with the program at a small size."""

import math

import numpy as np
import pytest
import torch

from perfbench import reference

GEO = reference.Geometry(48, 47)


@pytest.fixture(scope="module")
def ref():
    return reference.Reference(GEO, "cpu")


def test_gauss_weights_and_nodes():
    mu, w = GEO.gauss
    assert w.sum() == pytest.approx(1.0, abs=1e-14)
    # exact for polynomials of degree < 2 ndgl: the mean of mu^4 is 1/5
    assert (w * mu ** 4).sum() == pytest.approx(0.2, abs=1e-14)
    assert np.all(np.diff(mu) < 0) and np.allclose(mu, -mu[::-1])


def test_legendre_functions_are_orthonormal(ref):
    mu, w = GEO.gauss
    for m in (0, 5, 30):
        p = ref.leg(m).numpy()                      # northern rows
        keep = GEO.nmen[:48] >= m
        if not keep.all():
            continue
        sgn = (-1.0) ** np.arange(p.shape[0])
        full = np.concatenate([p, (p * sgn[:, None])[:, ::-1]], 1)
        g = (full * w) @ full.T
        t = 47 - m + 1                               # degrees m .. T
        assert np.abs(g[:t, :t] - np.eye(t)).max() < 1e-12


def test_closed_form_fields(ref):
    """P(1, 0) = sqrt(3) mu; the wind of vorticity in P(1, 0) is a solid
    rotation u = a zeta_10 sqrt(3) cos(lat) / 2 with v = 0; the E-W
    derivative of Re(P(1, 1) e^{i lambda}) follows its closed form."""
    mu = torch.as_tensor(GEO.gauss[0])
    a = GEO.radius
    sp = torch.zeros(1, GEO.nspec2, dtype=torch.float64)
    sp[0, 2] = 1.0                                  # m = 0, n = 1, re
    g = ref.inv(None, None, sp)
    assert torch.allclose(g[0, :, 0], math.sqrt(3) * mu, atol=1e-13)
    assert torch.allclose(g[0, 10, :GEO.nloen[10]],
                          math.sqrt(3) * mu[10].expand(GEO.nloen[10]))
    vor = sp * 1e-5
    g = ref.inv(vor, torch.zeros_like(vor), None)
    cos = torch.sqrt(1 - mu * mu)
    u = a * 1e-5 * math.sqrt(3) * cos / 2
    assert torch.allclose(g[0, :, 0], u, rtol=1e-12)
    assert g[1].abs().max() < 1e-12
    sp = torch.zeros(1, GEO.nspec2, dtype=torch.float64)
    sp[0, 2 * 48] = 1.0                             # m = 1, n = 1, re
    g = ref.inv(None, None, sp, scders=True)
    j, L = 7, int(GEO.nloen[7])
    lam = 2 * math.pi * torch.arange(L, dtype=torch.float64) / L
    c = math.sqrt(1.5) * cos[j]                     # P(1, 1) = sqrt(3/2) cos
    assert torch.allclose(g[0, j, :L], 2 * c * torch.cos(lam), atol=1e-13)
    ew = -2 * c * torch.sin(lam) / (a * cos[j])
    assert torch.allclose(g[2, j, :L], ew, atol=1e-18)


def test_direct_inverts_the_inverse_below_the_row_truncation(ref):
    torch.manual_seed(0)
    sp = torch.randn(2, GEO.nspec2, dtype=torch.float64)
    sp[:, 1: 2 * 48: 2] = 0
    sp[:, 0] = 0
    _, _, back = ref.dir(None, None, ref.inv(None, None, sp))
    assert (back - sp).abs().max() < 1e-8 * sp.abs().max()


def test_reference_agrees_with_the_program():
    import ectrans_tpu_torch as ett

    res = ett.setup("O48", 47)
    assert np.array_equal(GEO.nmen, res.grid.nmen())
    r = reference.Reference(GEO, "cpu")
    torch.manual_seed(1)

    def sp(n):
        x = torch.randn(n, res.nspec2, dtype=torch.float64)
        x[:, 1: 2 * 48: 2] = 0
        x[:, 0] = 0
        return x

    vor, div, sc = sp(2), sp(2), sp(3)
    flags = ett.InvFlags(scders=True, uvders=True)
    g = ett.inv_trans(res, vor, div, sc, flags=flags, dtype=torch.float64)
    gr = r.inv(vor, div, sc, scders=True, uvders=True)
    assert (g - gr).abs().max() < 1e-13 * gr.abs().max()
    got = ett.dir_trans(res, gr[:2], gr[2:4], gr[4:7], dtype=torch.float64)
    for x, y in zip(got, r.dir(gr[:2], gr[2:4], gr[4:7])):
        assert (x - y).abs().max() < 1e-13 * y.abs().max()


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10, 1 + 3 * 2 ** -12])
    assert reference.tf32(x).tolist() == [1.0, 1 + 2 ** -10, 1 + 2 ** -10,
                                          1 + 2 ** -10]


def test_grid_update_is_zero_on_pads_and_of_the_inputs_order(ref):
    g = torch.Generator().manual_seed(5)
    sc, wind = GEO.grid_update(g, "cpu", torch.float64)
    pads = torch.ones(GEO.ndgl * GEO.ndlon, dtype=torch.bool)
    pads[GEO.valid_points("cpu")] = False
    assert not sc.view(-1)[pads].any() and not wind.view(-1)[pads].any()
    vor, div, s = ref.dir(wind[None], -wind[None], sc[None])
    assert 0.5 < s.std().item() < 0.9
    assert 0.25 < vor.std().item() < 0.6 and 0.25 < div.std().item() < 0.6


def test_constrain_zeroes_the_imaginary_parts_of_m0_and_the_mean():
    x = torch.ones(2, GEO.nspec2)
    GEO.constrain(x)
    assert x[:, 0].eq(0).all() and x[:, 1: 96: 2].eq(0).all()
    assert x[:, 2: 96: 2].eq(1).all() and x[:, 96:].eq(1).all()
