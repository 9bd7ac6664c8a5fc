"""The IFS step on a (w, v) mesh driven from one process, on the CPU: 4
gloo ranks at O48 T47 through ``programs/world.py``.

* the benchmark's ``mesh`` program (``perfbench/programs/mesh.py``: this
  process is rank 0 of a ``world.World``, the others follow it through
  ``programs/driven.py``) through ``perfbench``'s ``Runner`` under the
  step traffic's packet shape (8 levels a packet, vor/div to u, v with
  derivatives, scalars with derivatives): against the float64 reference
  within the cell's limits, and against the single-device ``octahedral``
  program on the same seeded inputs within fp32 rounding;
* the rooted DIST_*/GATH_* of ``ShardedTransform``: scatter then gather
  gives back the root's array exactly, and the other ranks receive nothing
  global;
* the spans and the bytes counters of a driven call, with the recorder
  on, by name and count;
* a spawned rank that fails ends rank 0's process with its traceback, and
  leaves no process behind;
* ``perfbench/meshwork.py``'s rank shares against the port's distribution;
* ``perfbench/reference.py`` loads neither the port nor JAX.

The spawned ranks import this module: it imports neither jax nor
ectrans_tpu.
"""

import os
import pathlib
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
CONF = dict(program="mesh", mesh="2x2", grid="O48", gauss_number=48,
            truncation=47, dtype="float32", precision="highest", env={})
# the step traffic's packets (8 levels, vor/div, derivatives) at 16 levels
STEP = dict(levels=16, packet_levels=8, vordiv=True, scalars_per_level=2,
            surface_scalars=1, scders=True, uvders=True, grid_update=1.0,
            warmup_steps=1, trace_steps=1, kept_steps=1)
SEED = 3141592653589
EPS32 = float(np.finfo(np.float32).eps)


def _cell(program: str):
    from perfbench import spec, traffic

    lim = spec.HERE / "limits" / "tco1279-l137-mesh2x2.json"
    import json

    return spec.Cell("mesh-small", 4, dict(CONF, program=program),
                     traffic.from_dict("step-small", STEP),
                     json.loads(lim.read_text()), [], [])


def _mesh_program(conf, t):
    from perfbench import spec

    return spec.program("mesh").Program(conf, t, device="cpu")


def _step(program: str, seed: int):
    """One step of the cell's program through the Runner; (state after
    the step, the kept slot's numbers against the float64 reference)."""
    from perfbench import harness, spec

    cell = _cell(program)
    mod = spec.program(program)
    geo = mod.geometry(cell.config)
    prog = (_mesh_program(cell.config, cell.traffic) if program == "mesh"
            else mod.Program(cell.config, cell.traffic))
    cpu = torch.device("cpu")
    runner = harness.Runner(cell.traffic, geo, prog, cpu, torch.float32)
    try:
        state = runner.step(runner.inputs(seed), 0, (0, 1))
    finally:
        prog.close()
    numbers = harness.check(runner, geo.reference(cpu))
    return state, {k: v for k, (v, _) in numbers.items()}, cell.limits


@pytest.mark.parametrize("against", ["reference", "octahedral"])
def test_mesh_step(against):
    """The mesh program's step: within the cell's limits of the float64
    reference, and within fp32 rounding of the single-device program's."""
    state, numbers, limits = _step("mesh", SEED)
    assert set(numbers) == set(limits)
    if against == "reference":
        for k, v in numbers.items():
            assert v <= limits[k] / 10, (k, v, limits[k])
        return
    one, _, _ = _step("octahedral", SEED)
    for a, b in zip(state, one):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 64 * EPS32 * scale


def _rooted(rank, dev):
    """Every rank: rooted DIST then GATH of a grid and of spectra on a
    2 x 2 mesh at O48; the root's arrays come from a seed."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.parallel import make_mesh

    st = ett.SpectralTransform("O48", 47, mesh=make_mesh(2, 2, device=dev),
                               dtype=torch.float64)
    res = st.res
    kv = [1, 0, 1, 1, 0]                  # scrambled KVSET of 5 fields
    grid = spec = None
    if rank == 0:
        g = torch.Generator().manual_seed(7)
        grid = torch.randn(3, res.ndgl, res.grid.ndlon, generator=g,
                           dtype=torch.float64)
        spec = torch.randn(5, res.nspec2, generator=g, dtype=torch.float64)
    blk = st.dist_grid(grid, root=0, nfld=3)
    sp = st.dist_spec(spec, kvset=kv, root=0)
    sp_default = st.dist_spec(spec, root=0, nfld=5)
    first = int(st.inquire()["nfrstlat"][rank])
    back = st.gath_grid(blk, root=0)
    sback = st.gath_spec(sp, kvset=kv, root=0)
    sback_default = st.gath_spec(sp_default, root=0, nfld=5)
    out = dict(block=tuple(blk.shape), first=first, fields=sp.shape[0],
               default_fields=sp_default.shape[0],
               none=[x is None for x in (back, sback, sback_default)])
    if rank == 0:
        out.update(grid=bool(torch.equal(back, grid)),
                   spec=bool(torch.equal(sback, spec)),
                   spec_default=bool(torch.equal(sback_default, spec)),
                   own=bool(torch.equal(sp, spec[[1, 4]])),
                   rows=bool(torch.equal(blk, grid[:, :blk.shape[1]])))
    return out


def test_rooted_dist_and_gath():
    """Scatter then gather gives back the root's grid and spectra exactly;
    each rank gets its block and its v-rank's fields, and only the root
    receives the global arrays."""
    from ectrans_tpu_torch.programs import world

    out = world.run(_rooted, 4, "cpu", limit=120)
    root = out[0]
    assert root["grid"] and root["spec"] and root["spec_default"]
    assert root["own"] and root["rows"]
    assert root["none"] == [False, False, False]
    for r, o in enumerate(out[1:], 1):
        assert o["none"] == [True, True, True], r
    assert sum(o["block"][1] for o in out) == 96
    assert [o["first"] for o in out] == [0, 24, 48, 72]
    assert [o["fields"] for o in out] == [2, 3, 2, 3]
    assert [o["default_fields"] for o in out] == [3, 2, 3, 2]


def _spans(rank, dev):
    """Every rank: one driven inverse and one direct call on a 2 x 2 mesh
    with the recorder on; the spans and counters of each."""
    import collections

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.parallel import make_mesh
    from ectrans_tpu_torch.programs import driven
    from ectrans_tpu_torch.utils import timing

    st = ett.SpectralTransform("O48", 47, mesh=make_mesh(2, 2, device=dev))
    res = st.res
    flags = ett.InvFlags(scders=True, uvders=True)
    sp = [None] * 3
    if rank == 0:
        g = torch.Generator().manual_seed(11)
        sp = [torch.randn(n, res.nspec2, generator=g) for n in (2, 2, 3)]
    out = {}
    for name, call in (
            ("inv", lambda: driven._inv(st, flags, 2, 3, *sp)),
            ("dir", lambda: driven._dir(st, 2, 3, *grid))):
        timing.reset_gstats()
        timing.enable()
        try:
            got = call()
        finally:
            timing.disable()
        if name == "inv":
            grid = [None] * 3 if got is None else [got[:2], got[2:4],
                                                    got[4:7]]
        recs = timing.spans()
        out[name] = dict(
            spans=dict(collections.Counter(r[0] for r in recs)),
            counters=timing.counters(),
            within={n: recs[i][0] for n, _, i in timing.counts()})
    return out


# spans a rank enters in one call of 2 uv and 3 scalar fields (every rank,
# then the root's own)
INV_SPANS = dict(**{"api.inv_trans": 1, "legendre": 1, "fourier": 1,
                    "trmtol": 1, "trltog": 1, "boundary": 1, "spectral": 2,
                    "dist_spec": 3, "gath_grid": 1})
DIR_SPANS = dict(**{"api.dir_trans": 1, "legendre": 1, "fourier": 1,
                    "trgtol": 1, "trltom": 1, "updsp": 1, "boundary": 1,
                    "dist_grid": 3, "gath_spec": 3})


def test_spans_and_bytes_of_a_driven_call():
    """With the recorder on a call enters each span of its path the
    expected number of times, and the bytes a rank sends are counted under
    the span that sent them."""
    from ectrans_tpu_torch.programs import world

    out = world.run(_spans, 4, "cpu", limit=120)
    for r, o in enumerate(out):
        inv, dr = o["inv"]["spans"], o["dir"]["spans"]
        assert {k: inv.get(k) for k in INV_SPANS} == INV_SPANS, (r, inv)
        assert {k: dr.get(k) for k in DIR_SPANS if k != "spectral"} == \
            {k: v for k, v in DIR_SPANS.items() if k != "spectral"}, (r, dr)
        assert "fourier.bucket" in inv and "fourier.bucket" in dr
        assert o["inv"]["within"]["sent.TRMTOL"] == "trmtol"
        assert o["inv"]["within"]["sent.TRLTOG"] == "trltog"
        assert o["inv"]["within"]["sent.grid"] == "boundary"
        assert o["dir"]["within"]["sent.TRGTOL"] == "trgtol"
        assert o["dir"]["within"]["sent.TRLTOM"] == "trltom"
        assert o["dir"]["within"]["sent.psum"] == "updsp"
        for k in ("sent.TRMTOL", "sent.TRLTOG"):
            assert o["inv"]["counters"][k] > 0
    assert out[0]["inv"]["within"]["sent.dist"] == "dist_spec"
    assert out[0]["dir"]["within"]["sent.dist"] == "dist_grid"
    assert "sent.dist" not in out[1]["inv"]["counters"]
    assert out[1]["inv"]["within"]["sent.gath"] == "gath_grid"
    assert out[1]["dir"]["within"]["sent.gath"] == "gath_spec"
    assert "sent.gath" not in out[2]["dir"]["counters"]


FAILING = """
import os, sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
import test_torch_mesh_step as t
from ectrans_tpu_torch.programs import world
if __name__ == "__main__":
    w = world.World(t._fails, 4, "cpu")
    print("ranks", *[p.pid for p in w.ctx.processes], flush=True)
    time.sleep(120)
    print("not ended", flush=True)
"""


def _fails(rank, dev):
    if rank == 2:
        time.sleep(3)               # after rank 0 has printed the pids
        raise ValueError("rank 2 fails on purpose")
    time.sleep(120)


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/status") as f:
            return "\nState:\tZ" not in f.read()
    except FileNotFoundError:
        return False


def test_driven_world_ends_with_a_failing_rank(tmp_path):
    """A spawned rank that raises ends rank 0's process with exit code 1
    and that rank's traceback, and no rank is left running."""
    script = tmp_path / "fails.py"
    script.write_text(textwrap.dedent(FAILING).format(
        root=str(ROOT), tests=str(ROOT / "tests")))
    t0 = time.monotonic()
    p = subprocess.run([sys.executable, str(script)], capture_output=True,
                       text=True, timeout=110,
                       env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert p.returncode == 1, p.stderr[-2000:]
    assert time.monotonic() - t0 < 100
    assert "rank 2 of the 4-rank world failed" in p.stderr
    assert "rank 2 fails on purpose" in p.stderr
    assert "not ended" not in p.stdout
    pids = [int(x) for x in p.stdout.split()[1:4]]
    time.sleep(1)
    assert not [pid for pid in pids if _alive(pid)]


@pytest.mark.parametrize("iw", [0, 1])
def test_rank_rows_in_one_array(iw):
    """A w-rank's inverse Legendre outputs written in place
    (``_inv_rows_in_place``, read through ``_lat_cols``) and its direct
    rows in one array with one UVTVD (``_rows_vordiv``) are exactly the
    per-group forms, concatenated and padded with zeros."""
    import torch.nn.functional as F

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.ops import legendre_dense, spectral
    from ectrans_tpu_torch.parallel import distribution, sharded

    res = ett.setup("O48", 47)
    d = distribution.build_distribution(res, 2, 2)
    fl = distribution.rank_legendre(d, iw, torch.float32, "cpu")
    tables = distribution.rank_tables(d, iw, "dense", torch.float32, "cpu")
    tv = {k: tables[f"tvr_{k}_w"] for k in ("p", "q", "r", "valid")}
    g = torch.Generator().manual_seed(5 + iw)
    nfld, W1 = 5, res.NP + 1

    d2 = torch.randn(nfld, 2, d.ML, W1, generator=g)
    got = sharded._inv_rows_in_place(d2, fl)
    cols = sharded._lat_cols(res.ndgl, "dense")
    assert torch.equal(got[..., cols[:res.ndgl]],
                       legendre_dense.legendre_inv_rows(d2, fl))
    assert not got[..., res.ndgl].any()

    rows = [torch.randn(gr.m1 - gr.m0, 2 * nfld, gr.J, generator=g)
            for gr in fl.groups]
    for nuv in (0, 2):
        vd = spectral.vordiv_rows(rows, fl.groups, nuv, nfld, tv) \
            if nuv else rows
        want = torch.cat([F.pad(r, (0, W1 - r.shape[-1])) for r in vd]
                         + [torch.zeros(1, 2 * nfld, W1)])
        assert torch.equal(
            sharded._rows_vordiv(rows, fl.groups, d.ML, W1, nuv, tv), want)


@pytest.mark.parametrize("mesh", [(2, 2), (4, 1), (2, 1), (1, 4)])
def test_meshwork_shares_are_the_ports(mesh):
    """``perfbench/meshwork.py`` deals rows and m's as the port's
    distribution does."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.parallel.distribution import build_distribution
    from perfbench import meshwork, reference

    w, v = mesh
    res = ett.setup("O48", 47)
    d = build_distribution(res, w, v)
    geo = reference.Geometry(48, 47)
    for iw in range(w):
        rows = d.lat_perm[iw * d.LL: (iw + 1) * d.LL]
        assert meshwork.rank_rows(geo, w, v, iw).tolist() == \
            [int(r) for r in rows if r < res.ndgl]
        ms = d.perm[iw * d.ML: (iw + 1) * d.ML]
        assert sorted(meshwork.rank_ms(geo, w, iw).tolist()) == \
            sorted(int(m) for m in ms if m < res.M)


def test_reference_loads_neither_the_port_nor_jax():
    code = ("import sys; sys.path.insert(0, %r); import perfbench.reference;"
            " print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'ectrans_tpu', 'ectrans_tpu_torch'}))"
            % str(ROOT))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"
