"""The programs of ``ectrans_tpu_torch.programs`` on the CPU, against the
JAX package's drivers:

* the global driver (``main(argv)`` in this process, ``--device cpu``)
  against ``ectrans_tpu.programs.benchmark`` on the same arguments (F24
  T47, ``-n 2 --check 200 --dump-values``): each array of the two npz
  files within 1e-12 of its largest |value| in fp64 (100 eps in fp32), and
  both checks OK;
* decomposition invariance through the command line (a subprocess, as
  ``tests/test_benchmark_cli.py`` runs the JAX one): serial against
  ``--mesh 4x2`` (8 gloo ranks) within 1e-10, two serial runs' checksum
  files bit-identical, and the port's ``--mesh 4x2`` norms within 1e-10 of
  the JAX driver's;
* the LAM driver's final spectra against the JAX LAM loop written out here
  (the JAX LAM driver dumps nothing), 1e-12;
* the IFS-layout driver (F24 T47, 5 levels in packets of 2 + sp, 2 and 1
  levels, fp64) against the JAX IFS driver's loop written out here, 1e-12
  of each family's largest |value|, both drivers' ``--check 1000`` OK,
  and serial against ``--mesh 2x2`` within 1e-10;
* ``info``, ``--device cuda`` without a card, and ``world.run``'s failing
  ranks.

Spawned ranks import the module of their function: this one imports jax
and ectrans_tpu inside the tests only.
"""

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ectrans_tpu_torch.programs import (benchmark, benchmark_ifs, info,
                                        lam_benchmark, world)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EPS32 = float(np.finfo(np.float32).eps)
BASE = ["-g", "F24", "-t", "47", "-n", "2", "--check", "200"]
CLI = ["-g", "F24", "-t", "47", "-n", "2", "-f", "2", "--check", "200",
       "--dtype", "float64"]
CASES = {
    "fields": ["-f", "2", "-l", "2"],
    "derivatives": ["--vordiv", "--scders", "--uvders"],
    "vordiv_gp": ["--vordiv", "--vordiv-uv-gp"],
    "npromatr": ["--vordiv", "-f", "3", "--npromatr", "4"],
    "callmode2": ["--vordiv", "-f", "2", "-l", "2", "--callmode", "2"],
    "nproma": ["-f", "2", "--nproma", "16"],
}
LAM = ["--nlon", "48", "--nlat", "40", "-n", "2", "-f", "2", "--vordiv",
       "--scders", "--uvders", "--check", "200", "--dtype", "float64"]
IFS = ["-g", "F24", "-t", "47", "-l", "5", "--npromatr", "2", "-n", "2",
       "--dtype", "float64", "--check", "1000"]


def dumped(mod, argv, path, capsys):
    """Run a driver's main in this process with ``--dump-values path``;
    returns the arrays it wrote and what it printed."""
    mod.main(argv + ["--dump-values", str(path)])
    out = capsys.readouterr().out
    with np.load(path) as z:
        return {k: z[k] for k in z.files}, out


@pytest.mark.parametrize("dtype,case", [("float64", c) for c in CASES]
                         + [("float32", "derivatives")])
def test_driver_matches_jax_driver(tmp_path, capsys, dtype, case):
    from ectrans_tpu.programs import benchmark as jax_benchmark

    argv = BASE + CASES[case] + ["--dtype", dtype]
    want, jax_out = dumped(jax_benchmark, argv, tmp_path / "jax.npz", capsys)
    got, out = dumped(benchmark, argv + ["--device", "cpu"],
                      tmp_path / "port.npz", capsys)
    assert "-> OK" in jax_out and "-> OK" in out, jax_out + out
    if case == "nproma":
        assert "blocked round-trip exact" in out
    tol = 1e-12 if dtype == "float64" else 100 * EPS32
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max()
        assert err <= tol * np.abs(want[k]).max(), (k, err)


def test_main_returns_the_times_and_drift(capsys):
    rep = benchmark.main(BASE + ["-f", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[1] == "device cpu"
    assert [len(rep[k]) for k in ("t_inv", "t_dir", "t_rt")] == [2, 2, 2]
    assert np.allclose(rep["t_rt"], np.add(rep["t_inv"], rep["t_dir"]))
    assert rep["first"] > 0 and rep["throughput"] > 0
    assert 0 <= rep["drift"] < 200 * EPS32 * 2


def run_cli(module, args, home):
    out = subprocess.run(
        [sys.executable, "-m", module] + args, capture_output=True,
        text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
             "HOME": str(home)})
    assert out.returncode == 0, out.stdout + out.stderr
    return out.stdout


def norms_of(path):
    return [float(line.split()[2]) for line in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def checksums(tmp_path_factory):
    """The port's CLI at F24 T47 fp64: two serial runs and one on a 4 x 2
    mesh of 8 gloo ranks, each writing --dump-checksums."""
    tmp = tmp_path_factory.mktemp("cli")
    files = {k: tmp / f"{k}.sum" for k in ("serial", "serial2", "mesh")}
    outs = {}
    for key, extra in (("serial", []), ("mesh", ["--mesh", "4x2"]),
                       ("serial2", [])):
        outs[key] = run_cli("ectrans_tpu_torch.programs.benchmark",
                            CLI + extra + ["--device", "cpu",
                                           "--dump-checksums",
                                           str(files[key])], tmp)
    return files, outs


def test_cli_decomposition_invariant_checksums(checksums):
    files, outs = checksums
    assert all("-> OK" in o for o in outs.values()), outs
    assert "mesh 4x2 over 8 ranks (gloo)" in outs["mesh"]
    assert files["serial"].read_text() == files["serial2"].read_text()
    n1, n2 = norms_of(files["serial"]), norms_of(files["mesh"])
    assert len(n1) == len(n2) == 2
    for a, b in zip(n1, n2):
        assert abs(a - b) < 1e-10 * max(1.0, abs(a))


def test_cli_mesh_norms_match_jax_mesh(checksums, tmp_path, capsys):
    from ectrans_tpu.programs import benchmark as jax_benchmark

    path = tmp_path / "jax_mesh.sum"
    jax_benchmark.main(CLI + ["--mesh", "4x2", "--dump-checksums", str(path)])
    assert "-> OK" in capsys.readouterr().out
    got, want = norms_of(checksums[0]["mesh"]), norms_of(path)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert abs(a - b) < 1e-10 * max(1.0, abs(b))


def jax_lam_loop(argv):
    """The JAX LAM driver's loop (``ectrans_tpu/programs/lam_benchmark.py``)
    on its seeded inputs: the final (vor, div, sc, meanu, meanv), and the
    scale of each: its largest |value|, for the mean wind its wind field's
    (it is that field's (0, 0) coefficient, round-off of a zero mean
    here)."""
    import jax.numpy as jnp

    from ectrans_tpu.lam import (LamInvFlags, dir_trans_lam, inv_trans_lam,
                                 make_lam_grid, setup_lam)

    args = lam_benchmark.parse_args(argv)
    grid = make_lam_grid(args.nlon, args.nlat, nxux=args.nlon_ci,
                         nyux=args.nlat_ci, msmax=args.truncx,
                         nsmax=args.truncy, dx=args.dx, dy=args.dy)
    res = setup_lam(grid)
    rng = np.random.default_rng(0)
    pm, pn, pc = (np.asarray(x) for x in (res.packed_m, res.packed_n,
                                          res.packed_c))
    kill = ((pm == 0) & (pc >= 2)) | ((pn == 0) & (pc % 2 == 1))

    def packed(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, kill] = 0.0
        return jnp.asarray(x, jnp.float64)

    n = args.nfld
    ss, sv, sd = packed(n), packed(n), packed(n)
    sv, sd = sv.at[:, 0:4].set(0), sd.at[:, 0:4].set(0)
    flags = LamInvFlags(scders=args.scders, uvders=args.uvders)
    mu = mv = None
    for _ in range(args.niter + 1):
        g = inv_trans_lam(res, sv, sd, ss, mu, mv, flags=flags,
                          dtype=jnp.float64)
        sv, sd, ss, mu, mv = dir_trans_lam(res, g[:n], g[n: 2 * n],
                                           g[2 * n: 3 * n], dtype=jnp.float64)
    out = dict(vor=sv, div=sd, sc=ss, meanu=mu, meanv=mv)
    scale = {k: np.abs(np.asarray(x)).max() for k, x in out.items()}
    scale["meanu"] = np.abs(np.asarray(g[:n])).max()
    scale["meanv"] = np.abs(np.asarray(g[n: 2 * n])).max()
    return out, scale


def test_lam_driver_matches_jax_loop(capsys):
    rep = lam_benchmark.main(LAM + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "-> OK" in out and "device cpu" in out
    assert rep["drift"] < 200 * np.finfo(np.float64).eps * 2
    want, scale = jax_lam_loop(LAM)
    for k, w in want.items():
        err = np.abs(rep["spectra"][k] - np.asarray(w)).max()
        assert err <= 1e-12 * scale[k], (k, err, scale[k])


def jax_ifs_loop(argv):
    """The JAX IFS driver's loop (``ectrans_tpu/programs/benchmark_ifs.py``
    :90-118) on its seeded inputs: the final (vor, div, sc)."""
    import jax.numpy as jnp

    import ectrans_tpu as et
    from ectrans_tpu.transform import InvFlags

    args = benchmark_ifs.parse_args(argv)
    res = et.setup(args.grid, args.truncation)
    nlev, pk = args.nlev, args.npromatr
    rng = np.random.default_rng(0)

    def packed(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1: 2 * (res.nsmax + 1): 2] = 0.0
        x[:, 0] = 0.0
        return jnp.asarray(x, jnp.float64)

    sv, sd, ss = packed(nlev), packed(nlev), packed(2 * nlev + 1)
    flags = InvFlags(scders=True, uvders=True)
    for _ in range(args.niter + 1):
        sv2, sd2, ss2 = [], [], []
        for lo in range(0, nlev, pk):
            hi = min(nlev, lo + pk)
            m = hi - lo
            sc_idx = list(range(lo, hi)) + list(range(nlev + lo, nlev + hi))
            if lo == 0:
                sc_idx.append(2 * nlev)
            g = et.inv_trans(res, spvor=sv[lo:hi], spdiv=sd[lo:hi],
                             spscalar=ss[np.asarray(sc_idx)], flags=flags,
                             dtype=jnp.float64)
            pv, pd, psc = et.dir_trans(
                res, u=g[:m], v=g[m: 2 * m],
                scalars=g[2 * m: 2 * m + len(sc_idx)], dtype=jnp.float64)
            sv2.append(pv)
            sd2.append(pd)
            ss2.append(psc)
        sv, sd = jnp.concatenate(sv2), jnp.concatenate(sd2)
        tpar, qpar, sp_f = [], [], None
        for blk, lo in zip(ss2, range(0, nlev, pk)):
            m = min(nlev, lo + pk) - lo
            tpar.append(blk[:m])
            qpar.append(blk[m: 2 * m])
            if lo == 0:
                sp_f = blk[2 * m:]
        ss = jnp.concatenate(tpar + qpar + [sp_f])
    return dict(vor=np.asarray(sv), div=np.asarray(sd), sc=np.asarray(ss))


def test_ifs_packets():
    """Packets of 2 + sp, 2 and 1 levels: three field-count shapes."""
    assert benchmark_ifs.packets(5, 2) == [
        (0, 2, [0, 1, 5, 6, 10]), (2, 4, [2, 3, 7, 8]), (4, 5, [4, 9])]
    assert benchmark_ifs.packets(3, 8) == [(0, 3, [0, 1, 2, 3, 4, 5, 6])]


def test_ifs_driver_matches_jax_loop(capsys):
    from ectrans_tpu.programs import benchmark_ifs as jax_ifs

    rep = benchmark_ifs.main(IFS + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "-> OK" in out and "device cpu" in out, out
    assert "IFS layout: 5 levels vor/div + 11 scalar fields" in out
    assert len(rep["t_rt"]) == 2 and rep["first"] > 0
    jax_ifs.main(IFS)
    jax_out = capsys.readouterr().out
    assert "-> OK" in jax_out, jax_out
    want = jax_ifs_loop(IFS)
    for k, w in want.items():
        got = rep["spectra"][k]
        assert got.shape == w.shape, k
        err = np.abs(got - w).max()
        assert err <= 1e-12 * np.abs(w).max(), (k, err)


def test_ifs_driver_mesh_matches_serial(capfd):
    serial = benchmark_ifs.main(IFS + ["--device", "cpu"])
    mesh = benchmark_ifs.main(IFS + ["--device", "cpu", "--mesh", "2x2"])
    out = capfd.readouterr().out     # the ranks print from their processes
    assert "mesh 2x2 over 4 ranks (gloo)" in out
    assert out.count("-> OK") == 2, out
    for k, w in serial["spectra"].items():
        err = np.abs(mesh["spectra"][k] - w).max()
        assert err <= 1e-10 * np.abs(w).max(), (k, err)


def test_info_runs_without_a_card(capsys, monkeypatch):
    import ectrans_tpu_torch as ett

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info.main()
    out = capsys.readouterr().out
    assert f"ectrans_tpu_torch version {ett.__version__}" in out
    assert "device: no CUDA device" in out
    assert f"torch {torch.__version__}" in out


@pytest.mark.parametrize("mod,argv", [
    (benchmark, BASE), (benchmark, BASE + ["--mesh", "2x1"]),
    (lam_benchmark, ["--nlon", "48", "--nlat", "40", "-n", "1"]),
    (benchmark_ifs, ["-g", "F24", "-l", "2", "-n", "1"])])
def test_device_cuda_without_a_card_stops(monkeypatch, capsys, mod, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        mod.main(argv)
    assert "--device cpu" in str(e.value.code)
    assert "check:" not in capsys.readouterr().out


def test_bfloat16_working_dtype_is_refused():
    with pytest.raises(SystemExit) as e:
        benchmark.main(BASE + ["--dtype", "bfloat16", "--device", "cpu"])
    assert "--precision bf16" in str(e.value.code)


def _rank_of(rank, dev, how):
    if rank == 1:
        if how == "raise":
            raise ValueError("rank 1 fails on purpose")
        if how == "exit":
            os._exit(3)
        if how == "hang":
            time.sleep(120)
    return {"rank": rank, "device": str(dev),
            "threads": torch.get_num_threads()}


def test_world_returns_each_ranks_result():
    assert world.run(_rank_of, 2, "cpu", ("none",), limit=120) == [
        {"rank": 0, "device": "cpu", "threads": 1},
        {"rank": 1, "device": "cpu", "threads": 1}]


@pytest.mark.parametrize("how,match", [
    ("raise", "(?s)rank 1 of the 2-rank world failed.*rank 1 fails on purpose"),
    ("exit", "(?s)rank 1 of the 2-rank world failed.*exit code 3"),
    ("hang", "outlasted its 8 s limit")])
def test_world_fails_with_the_failing_rank(how, match):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=match):
        world.run(_rank_of, 2, "cpu", (how,), limit=8)
    assert time.monotonic() - t0 < 100
