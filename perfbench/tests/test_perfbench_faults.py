"""``correct`` at a small size on the CPU: the program passes with a
cell's limits; the control (the reference in float32 with TF32 operands
in the program's place) fails them, and so does each fault of the timed
path that a cell can have: a step that returns its state unchanged (with
no grid, or with a right inverse and a direct transform that gives back
the spectra the inverse was given), half of the fields of a call left
out, an answer altered where it is made.  (One card: no exchange between
chips to leave out.)"""

import pytest
import torch

from perfbench import harness, spec

from .small import F1, STEP, cell, run

Program = spec.program("octahedral").Program

CELLS = [(STEP, "tco1279-l137-step"), (F1, "tco639-f1-rt"),
         (F1, "tco1279-f1-rt")]


class Unchanged(Program):
    """Returns the state it was given and computes no grid."""

    def __init__(self, geo, traffic, device):
        super().__init__(dict(grid="O48", truncation=47, dtype="float32",
                              precision="highest"), traffic)
        self.geo = geo

    def inv(self, vor, div, sc):
        self.last = (vor, div, sc)
        nuv = 0 if vor is None else vor.shape[0]
        n = 4 * nuv + 3 * sc.shape[0] if self.flags.scders else sc.shape[0]
        return torch.zeros((n, self.geo.ndgl, self.geo.ndlon))

    def dir(self, u, v, sc):
        return tuple(None if x is None else x.clone() for x in self.last)


class HalfLeftOut(Unchanged):
    """Leaves the second half of each call's fields out."""

    def inv(self, vor, div, sc):
        def half(x):
            if x is None:
                return None
            x = x.clone()
            x[(x.shape[0] + 1) // 2:] = 0
            return x
        return Program.inv(self, half(vor), half(div), half(sc))

    def dir(self, u, v, sc):
        return Program.dir(self, u, v, sc)


class Altered(Unchanged):
    """Alters one grid value of each inverse output by 1 % of the
    largest."""

    def inv(self, vor, div, sc):
        g = Program.inv(self, vor, div, sc)
        g[0, 3, 5] += 0.01 * g.abs().max()
        return g

    def dir(self, u, v, sc):
        return Program.dir(self, u, v, sc)


class DirectGivesBack(Unchanged):
    """A right inverse; the direct transform returns the spectra that the
    inverse was given."""

    def inv(self, vor, div, sc):
        self.last = (vor, div, sc)
        return Program.inv(self, vor, div, sc)


@pytest.mark.parametrize("shape,limits", CELLS)
def test_program_is_correct(shape, limits):
    r = run(cell(shape, limits))
    assert r["correct"] and r["failed"] == 0
    assert set(r["checks"]) <= set(cell(shape, limits).limits)
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("shape,limits", CELLS)
def test_control_fails(shape, limits):
    r = run(cell(shape, limits), program=harness.Control)
    assert not r["correct"] and r["failed"] >= 1


# one field a call has no half to leave out
FAULTS = [(f, s, lim)
          for f in (Unchanged, DirectGivesBack, HalfLeftOut, Altered)
          for s, lim in CELLS if not (f is HalfLeftOut and s is F1)]


@pytest.mark.parametrize("fault,shape,limits", FAULTS)
def test_faults_fail(fault, shape, limits):
    r = run(cell(shape, limits), program=fault)
    assert not r["correct"]


@pytest.mark.parametrize("shape,limits", CELLS)
def test_the_update_is_what_catches_a_direct_that_gives_back(shape, limits):
    """Without the grid-point update the direct transform gets back the
    inverse's output, and one that returns its input reads right."""
    r = run(cell(shape, limits), program=DirectGivesBack)
    assert all(c["value"] <= c["limit"] for k, c in r["checks"].items()
               if k.startswith("inv."))
    assert r["checks"]["dir.sc"]["value"] > 0.1
    if shape is STEP:
        assert r["checks"]["dir.vordiv"]["value"] > 0.1
    r = run(cell(dict(shape, grid_update=0.0), limits),
            program=DirectGivesBack)
    assert r["correct"]
