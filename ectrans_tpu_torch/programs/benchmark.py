"""Global spectral-transform benchmark driver.

Counterpart of ``ectrans_tpu/programs/benchmark.py``, the command-line
mirror of the reference benchmark (``src/programs/ectrans-benchmark.F90``):
timed inverse/direct transform loop with per-phase avg/min/max/median
statistics (:874-945), optional vor/div and derivative flags, spectral-norm
printing (--norms) and the analytic correctness gate (--check <mult>: max
spectral-norm error vs the initial condition must stay below mult *
machine-eps, :850-860).  The same flags, the same seeded inputs and the same
lines as the JAX driver, plus ``--device`` (the card unless told "cpu") and
a device line.

``--mesh WxV`` runs W·V ranks of one world (``world.py``: NCCL with a
card a rank, else gloo), each on its shards of the same inputs
(``dist_spec``); an iteration's time is the slowest rank's, and rank 0
prints, from the spectra ``gath_spec`` brings it.

Usage:
    python -m ectrans_tpu_torch.programs.benchmark -g O48 -t 47 -n 10 \
        -f 4 -l 5 --vordiv --scders --uvders --check 100 --dtype float32 \
        --mesh 4x2

``main(argv)`` returns the times of the timed iterations (seconds:
``t_inv``, ``t_dir``, ``t_rt``), the warm-up round trip ``first``, the
``throughput`` and the check's ``drift`` (None without --check).
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
    p = argparse.ArgumentParser(
        description="ectrans_tpu_torch benchmark (reference ectrans-benchmark "
                    "equivalent)")
    p.add_argument("-g", "--grid", default="O48",
                   help="grid spec: O<N> octahedral, F<N> full, TCO<S>, TL<S>")
    p.add_argument("-t", "--truncation", type=int, default=None,
                   help="spectral truncation (default: grid-implied)")
    p.add_argument("-n", "--niter", type=int, default=10)
    p.add_argument("-f", "--nfld", type=int, default=1,
                   help="number of scalar fields (per level)")
    p.add_argument("-l", "--nlev", type=int, default=1,
                   help="number of levels (scalar fields = nfld * nlev)")
    p.add_argument("--vordiv", action="store_true",
                   help="also transform vorticity/divergence -> winds")
    p.add_argument("--scders", action="store_true",
                   help="compute scalar derivatives")
    p.add_argument("--uvders", action="store_true",
                   help="compute E-W derivatives of u, v")
    p.add_argument("--vordiv-uv-gp", action="store_true", dest="vorgp",
                   help="output grid-point vor/div too")
    p.add_argument("--norms", action="store_true",
                   help="print spectral norms each iteration")
    p.add_argument("--check", type=float, default=0.0, metavar="MULT",
                   help="correctness gate: err < MULT * eps (0 = off)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"],
                   help="working dtype (float32 or float64; bf16 tables are "
                        "--precision bf16)")
    p.add_argument("--precision", default="highest",
                   choices=["highest", "high", "bf16"],
                   help="Legendre contraction precision tier")
    p.add_argument("--mesh", default=None, metavar="WxV",
                   help="distributed mesh, e.g. 4x2 (default: single "
                        "device): W*V ranks spawned by this program in one "
                        "gloo group (NCCL refuses two ranks on one card), "
                        "rank r on cuda:(r %% device_count)")
    p.add_argument("--nproma", type=int, default=0, metavar="N",
                   help="grid-point blocking size: run outputs through the "
                        "(nproma, nfld, ngpblks) blocked layout each "
                        "iteration (reference --nproma / INIGPTR)")
    p.add_argument("--npromatr", type=int, default=0, metavar="N",
                   help="spectral field-packet cap per transform "
                        "(reference NPROMATR, 0 = off)")
    p.add_argument("--callmode", type=int, default=1, choices=[1, 2],
                   help="1 = combined PGP arrays; 2 = split PGPUV/PGP3A/PGP2 "
                        "families (reference ectrans-benchmark callmode)")
    p.add_argument("--meminfo", action="store_true",
                   help="print device memory stats + host peak RSS "
                        "(reference ectrans_memory / setup_trans meminfo)")
    p.add_argument("--dump-checksums", default=None, metavar="FILE",
                   help="write per-field output checksums (reference "
                        "--dump-checksums; decomposition invariance)")
    p.add_argument("--dump-values", default=None, metavar="FILE",
                   help="write final grid + spectral field values (npz) for "
                        "external comparison (reference --dump-values)")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the transforms run: the CUDA card (default; "
                        "no card is an error) or the CPU")
    return p.parse_args(argv)


def _stats(times):
    t = np.asarray(times)
    return dict(avg=t.mean(), min=t.min(), max=t.max(), med=np.median(t))


def _print_stats(name, times):
    s = _stats(times)
    print(f"{name:28s} avg {s['avg']*1e3:9.3f} ms  min {s['min']*1e3:9.3f}"
          f"  max {s['max']*1e3:9.3f}  med {s['med']*1e3:9.3f}")


def main(argv=None) -> dict:
    args = parse_args(argv)
    dtype = working_dtype(args.dtype)
    if args.mesh:
        from . import world

        if args.callmode == 2:
            sys.exit("--callmode 2 requires a single-device run")
        device(args.device)             # exits without a card
        w, v = (int(x) for x in args.mesh.lower().split("x"))
        out = world.run(_rank, w * v, args.device, (args, w, v))[0]
    else:
        out = run(args, device(args.device), dtype)
    if not out.pop("ok"):
        sys.exit(1)
    return out


def _rank(rank: int, dev: torch.device, args, w: int, v: int) -> dict:
    """One rank of ``--mesh``: the program on its shards, on its mesh."""
    from ..parallel import make_mesh

    return run(args, dev, working_dtype(args.dtype),
               mesh=make_mesh(w, v, device=dev))


def run(args, dev: torch.device, dtype: torch.dtype, mesh=None) -> dict:
    """The benchmark on ``dev`` (one rank's part of it on ``mesh``); rank 0
    alone prints.  Returns the times, throughput, drift and ``ok``."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import norms

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    res = ett.setup(args.grid, args.truncation)
    say(f"grid {res.grid.name}  T{res.nsmax}  ndgl {res.ndgl}  "
        f"ngptot {res.grid.ngptot}  nspec2 {res.nspec2}  dtype {args.dtype}")
    say(device_line(dev))

    st = None
    if mesh is not None:
        st = ett.SpectralTransform(args.grid, args.truncation, mesh=mesh,
                                   dtype=dtype, precision=args.precision)
        say(f"mesh {mesh.w}x{mesh.v} over {mesh.w * mesh.v} ranks "
            f"({torch.distributed.get_backend(mesh.group)})")

    split_api = None
    if args.callmode == 2:
        split_api = ett.SpectralTransform(args.grid, args.truncation,
                                          dtype=dtype,
                                          precision=args.precision,
                                          device=dev)

    nsc = args.nfld * args.nlev
    nuv = args.nlev if args.vordiv else 0
    flags = ett.InvFlags(scders=args.scders, uvders=args.uvders,
                         vorgp=args.vorgp, divgp=args.vorgp)

    rng = np.random.default_rng(0)

    def packed(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0  # m=0 imag = 0
        x[:, 0] = 0.0
        return torch.as_tensor(x, dtype=dtype, device=dev)

    spsc = packed(nsc)
    spvor = packed(nuv) if nuv else None
    spdiv = packed(nuv) if nuv else None
    norm0 = norms.specnorm(res, spsc).cpu().numpy()
    if st is not None:
        spsc, spvor, spdiv = (None if x is None else st.dist_spec(x)
                              for x in (spsc, spvor, spdiv))

    def gathered(x):
        """The global spectra of a family (a collective on a mesh)."""
        if st is None:
            return x
        return torch.as_tensor(st.gath_spec(x), device=dev)

    npromatr = args.npromatr or None

    def inv(sv, sd, ss):
        if st is not None:
            return st.inv_trans(spvor=sv, spdiv=sd, spscalar=ss, flags=flags,
                                npromatr=npromatr)
        return ett.inv_trans(res, spvor=sv, spdiv=sd, spscalar=ss,
                             flags=flags, dtype=dtype, npromatr=npromatr,
                             precision=args.precision)

    def dirt(u, v, sc):
        if st is not None:
            return st.dir_trans(u=u, v=v, scalars=sc, npromatr=npromatr)
        return ett.dir_trans(res, u=u, v=v, scalars=sc, dtype=dtype,
                             npromatr=npromatr, precision=args.precision)

    def inv_split(sv, sd, ss):
        # callmode 2: scalars as the SC3A (nfld, nlev) family
        out = split_api.inv_trans_split(
            spvor=sv, spdiv=sd,
            spsc3a=ss.reshape(args.nfld, args.nlev, res.nspec2),
            flags=flags, npromatr=npromatr)
        sc = out["sc3a"].reshape(nsc, res.ndgl, res.grid.ndlon)
        return out.get("u"), out.get("v"), sc

    def dirt_split(u, v, sc):
        sv, sd, fam = split_api.dir_trans_split(
            u=u, v=v,
            gp3a=sc.reshape(args.nfld, args.nlev, res.ndgl, res.grid.ndlon),
            npromatr=npromatr)
        return sv, sd, fam["sc3a"].reshape(nsc, res.nspec2)

    off = nuv * (2 if args.vorgp else 0)     # u, v follow vor, div
    times = []
    sv, sd, ss = spvor, spdiv, spsc
    for it in range(args.niter + 1):  # first iteration = warmup
        t0 = time.perf_counter()
        if split_api is not None:
            u, v, sc = inv_split(sv, sd, ss)
            synchronize(dev)
            t1 = time.perf_counter()
            sv2, sd2, ss2 = dirt_split(u, v, sc)
        else:
            grid = inv(sv, sd, ss)
            synchronize(dev)
            t1 = time.perf_counter()
            u = grid[off : off + nuv] if nuv else None
            v = grid[off + nuv : off + 2 * nuv] if nuv else None
            sc = grid[off + 2 * nuv : off + 2 * nuv + nsc]
            sv2, sd2, ss2 = dirt(u, v, sc)
        synchronize(dev)
        t2 = time.perf_counter()
        times.append((t1 - t0, t2 - t1, t2 - t0))
        if nuv:
            sv, sd = sv2, sd2
        ss = ss2
        if args.norms:
            nn = norms.specnorm(res, gathered(ss)).cpu().numpy()
            say(f"iter {it:3d}  specnorm[0] {nn[0]:.9e}")

    t = torch.tensor(times, dtype=torch.float64)
    if mesh is not None:             # each iteration at its slowest rank
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    t_inv, t_dir, t_rt = (t[1:, k].tolist() for k in range(3))
    _print = _print_stats if lead else (lambda *a: None)
    _print("inverse transform", t_inv)
    _print("direct transform", t_dir)
    _print("inv+dir roundtrip", t_rt)
    gpps = res.grid.ngptot * (nsc + 2 * nuv) / np.mean(t_rt)
    say(f"throughput {gpps:.3e} gridpoints*fields/s")

    ss, sv, sd = (None if x is None else gathered(x) for x in (ss, sv, sd))
    if st is not None and (args.nproma or args.dump_values):
        sc = torch.as_tensor(st.gath_grid(sc))
    if not lead:
        return dict(ok=True)

    if args.nproma:
        # NPROMA blocked-layout exercise (reference PGP(NPROMA,NFLD,NGPBLKS)
        # contract): round-trip the scalar outputs through the blocked
        # layout and require exactness.
        from ectrans_tpu_torch.utils.blocking import (_point_index,
                                                      blocked_to_fields,
                                                      fields_to_blocked)

        sc_h = sc.cpu()
        blk = fields_to_blocked(sc_h, res.grid, args.nproma)
        back = blocked_to_fields(blk, res.grid)
        lat, lon = _point_index(res.grid, sc_h.device)
        same = torch.equal(back[:, lat, lon], sc_h[:, lat, lon])
        print(f"nproma {args.nproma}: ngpblks {blk.shape[2]}, blocked "
              f"round-trip {'exact' if same else 'MISMATCH'}")
        if not same:
            return dict(ok=False)

    if args.meminfo:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        print(f"host peak RSS {ru.ru_maxrss/2**10:.0f} MiB "
              f"(reference ectrans_memory peak-heap analogue)")
        if dev.type == "cuda":
            print(f"{dev}: in_use "
                  f"{torch.cuda.memory_allocated(dev)/2**20:.0f} MiB, peak "
                  f"{torch.cuda.max_memory_allocated(dev)/2**20:.0f} MiB")
        else:
            print(f"meminfo unavailable: no memory statistics on {dev}")

    if args.dump_values:
        # reference --dump-values: raw output fields for external diffing
        def host(x):
            return x.detach().cpu().double().numpy()

        np.savez_compressed(
            args.dump_values, spscalar=host(ss), grid_sc=host(sc),
            **({"spvor": host(sv), "spdiv": host(sd)} if nuv else {}))
        print(f"dumped values -> {args.dump_values}")

    if args.dump_checksums:
        from ectrans_tpu_torch.utils import field_checksum

        with open(args.dump_checksums, "w") as fh:
            out = ss.detach().cpu().double()
            nn = norms.specnorm(res, out).numpy()
            for f in range(out.shape[0]):
                fh.write(f"sc{f} {field_checksum(out[f].numpy())} "
                         f"{nn[f]:.14e}\n")

    err, ok = None, True
    if args.check:
        err = drift(norms.specnorm(res, ss).cpu().numpy(), norm0)
        ok = check_line(err, args.check, dtype, args.niter)
    return dict(t_inv=t_inv, t_dir=t_dir, t_rt=t_rt, first=t[0, 2].item(),
                throughput=gpps, drift=err, ok=ok)


if __name__ == "__main__":
    main()
