"""LAM bi-Fourier benchmark driver.

Counterpart of ``ectrans_tpu/programs/lam_benchmark.py``, the mirror of the
reference ``src/programs/ectrans-lam-benchmark.F90`` (--nlon/--nlat domain
options, timed einv/edir loop, correctness gate): the same flags, seeded
inputs and lines, plus ``--device`` (the card unless told "cpu") and a
device line.

Usage:
    python -m ectrans_tpu_torch.programs.lam_benchmark --nlon 128 \
        --nlat 96 --nlon-ci 107 --nlat-ci 75 -n 10 -f 8 --vordiv --check 100

``main(argv)`` returns what the global driver's does (``t_inv``, ``t_dir``,
``t_rt``, ``first``, ``throughput``, ``drift``) and the final spectra
(``spectra``: host fp64 arrays ``vor``, ``div``, ``sc``, ``meanu``,
``meanv``, None where absent).
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from . import (DEVICES, check_line, device, device_line, drift,
               synchronize, working_dtype)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="ectrans_tpu_torch LAM benchmark")
    p.add_argument("--nlon", type=int, default=128)
    p.add_argument("--nlat", type=int, default=96)
    p.add_argument("--nlon-ci", type=int, default=None,
                   help="C+I zone longitudes (default: nlon)")
    p.add_argument("--nlat-ci", type=int, default=None)
    p.add_argument("--truncx", type=int, default=None)
    p.add_argument("--truncy", type=int, default=None)
    p.add_argument("--dx", type=float, default=1000.0)
    p.add_argument("--dy", type=float, default=1000.0)
    p.add_argument("-n", "--niter", type=int, default=10)
    p.add_argument("-f", "--nfld", type=int, default=1)
    p.add_argument("--vordiv", action="store_true")
    p.add_argument("--scders", action="store_true")
    p.add_argument("--uvders", action="store_true")
    p.add_argument("--check", type=float, default=0.0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the transforms run: the CUDA card (default; "
                        "no card is an error) or the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dtype = working_dtype(args.dtype)
    dev = device(args.device)

    from ectrans_tpu_torch.lam import (LamInvFlags, dir_trans_lam,
                                       especnorm, inv_trans_lam,
                                       make_lam_grid, setup_lam)

    grid = make_lam_grid(args.nlon, args.nlat,
                         nxux=args.nlon_ci, nyux=args.nlat_ci,
                         msmax=args.truncx, nsmax=args.truncy,
                         dx=args.dx, dy=args.dy)
    res = setup_lam(grid)
    print(f"LAM {grid.nx}x{grid.ny} (C+I {grid.nxux}x{grid.nyux})  "
          f"trunc ({grid.msmax},{grid.nsmax})  nspec2 {grid.nspec2}")
    print(device_line(dev))

    flags = LamInvFlags(scders=args.scders, uvders=args.uvders)
    rng = np.random.default_rng(0)
    pm, pn, pc = res.packed_m, res.packed_n, res.packed_c
    kill = ((pm == 0) & (pc >= 2)) | ((pn == 0) & (pc % 2 == 1))

    def packed(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, kill] = 0.0
        return torch.as_tensor(x, dtype=dtype, device=dev)

    nsc = args.nfld
    nuv = args.nfld if args.vordiv else 0
    ss = packed(nsc)
    sv = packed(nuv) if nuv else None
    sd = packed(nuv) if nuv else None
    if nuv:
        sv[:, 0:4] = 0
        sd[:, 0:4] = 0
    norm0 = especnorm(res, ss).cpu().numpy()

    times = []
    mu = mv = None
    for it in range(args.niter + 1):
        t0 = time.perf_counter()
        g = inv_trans_lam(res, sv, sd, ss, mu, mv, flags=flags, dtype=dtype)
        synchronize(dev)
        t1 = time.perf_counter()
        u = g[:nuv] if nuv else None
        v = g[nuv : 2 * nuv] if nuv else None
        sc = g[2 * nuv : 2 * nuv + nsc]
        sv2, sd2, ss2, mu2, mv2 = dir_trans_lam(res, u, v, sc, dtype=dtype)
        synchronize(dev)
        t2 = time.perf_counter()
        times.append((t1 - t0, t2 - t1, t2 - t0))
        ss = ss2
        if nuv:
            sv, sd, mu, mv = sv2, sd2, mu2, mv2

    t = np.asarray(times)
    t_inv, t_dir, t_rt = (t[1:, k].tolist() for k in range(3))
    for name, ts in (("e-inverse transform", t_inv),
                     ("e-direct transform", t_dir),
                     ("roundtrip", t_rt)):
        a = np.asarray(ts)
        print(f"{name:22s} avg {a.mean()*1e3:8.3f} ms  min {a.min()*1e3:8.3f}"
              f"  max {a.max()*1e3:8.3f}  med {np.median(a)*1e3:8.3f}")
    gpps = grid.ngptot * (nsc + 2 * nuv) / np.mean(t_rt)
    print(f"throughput {gpps:.3e} gridpoints*fields/s")

    err = None
    if args.check:
        err = drift(especnorm(res, ss).cpu().numpy(), norm0)
        if not check_line(err, args.check, dtype, args.niter):
            sys.exit(1)

    def host(x):
        return None if x is None else x.detach().cpu().double().numpy()

    return dict(t_inv=t_inv, t_dir=t_dir, t_rt=t_rt, first=float(t[0, 2]),
                throughput=gpps, drift=err,
                spectra=dict(vor=host(sv), div=host(sd), sc=host(ss),
                             meanu=host(mu), meanv=host(mv)))


if __name__ == "__main__":
    main()
