"""IFS-layout benchmark driver.

Counterpart of ``ectrans_tpu/programs/benchmark_ifs.py``, the mirror of
``src/programs/ectrans-benchmark-ifs.F90``: the field set of one IFS time
step — nlev levels of vorticity/divergence (transformed to winds with
their E-W derivatives), nlev levels each of temperature and humidity-like
scalars with derivatives, and one surface-pressure field — run as the
reference's NPROMATR packet loop over levels: each packet of ``--npromatr``
levels (the surface pressure in the first) is one inverse and one direct
transform.  The same flags, seeded inputs, loop and lines as the JAX
driver, plus ``--device`` (the card unless told "cpu") and a device line.

``--mesh WxV`` runs W·V ranks of one world (``world.py``: NCCL with a
card a rank, else gloo): every rank keeps the global spectra, hands each
packet's fields to the mesh (``dist_spec``) and gathers the packet's direct
output back (``gath_spec``, counted in the time); an iteration's time is
the slowest rank's, and rank 0 prints.

Usage:
    python -m ectrans_tpu_torch.programs.benchmark_ifs -g TCO159 -l 137 -n 5

``main(argv)`` returns the final spectra (``spectra``: vor, div, sc as
fp64 numpy arrays), the times of the timed iterations (``t_rt``, seconds),
the warm-up iteration ``first``, the ``throughput`` and the check's
``drift`` (None without --check).
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
        description="ectrans_tpu_torch IFS-layout benchmark")
    p.add_argument("-g", "--grid", default="O48")
    p.add_argument("-t", "--truncation", type=int, default=None)
    p.add_argument("-l", "--nlev", type=int, default=19,
                   help="model levels (vor/div/T/q per level)")
    p.add_argument("-n", "--niter", type=int, default=5)
    p.add_argument("--check", type=float, default=0.0)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64"])
    p.add_argument("--mesh", default=None, metavar="WxV",
                   help="distributed mesh: W*V ranks spawned by this program "
                        "in one gloo group, rank r on cuda:(r %% "
                        "device_count)")
    p.add_argument("--npromatr", type=int, default=8, metavar="NLEV",
                   help="levels per transform packet (the reference's "
                        "NPROMATR field-packet loop, inv_trans_ctl_mod."
                        "F90:143-276: bounds the padded grid-space working "
                        "set; 0 = single packet)")
    p.add_argument("--device", default="cuda", choices=DEVICES,
                   help="where the transforms run: the CUDA card (default; "
                        "no card is an error) or the CPU")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    dtype = working_dtype(args.dtype)
    if args.mesh:
        from . import world

        device(args.device)             # exits without a card
        w, v = (int(x) for x in args.mesh.lower().split("x"))
        out = world.run(_rank, w * v, args.device, (args, w, v))[0]
    else:
        out = run(args, device(args.device), dtype)
    if not out.pop("ok"):
        sys.exit(1)
    return out


def _rank(rank: int, dev: torch.device, args, w: int, v: int) -> dict:
    """One rank of ``--mesh``: the program on its mesh."""
    from ..parallel import make_mesh

    return run(args, dev, working_dtype(args.dtype),
               mesh=make_mesh(w, v, device=dev))


def packets(nlev: int, pk: int) -> list:
    """The packet loop's (lo, hi, scalar rows) over ``nlev`` levels, ``pk``
    a packet: T and q of levels [lo, hi) and, in the first, the surface
    pressure (row 2 nlev of the scalars)."""
    out = []
    for lo in range(0, nlev, pk):
        hi = min(nlev, lo + pk)
        sc = list(range(lo, hi)) + list(range(nlev + lo, nlev + hi))
        out.append((lo, hi, sc + ([2 * nlev] if lo == 0 else [])))
    return out


def run(args, dev: torch.device, dtype: torch.dtype, mesh=None) -> dict:
    """The driver on ``dev`` (one rank's part of it on ``mesh``); rank 0
    alone prints.  Returns the spectra, times, throughput, drift and
    ``ok``."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import norms

    lead = mesh is None or mesh.rank == 0
    say = print if lead else (lambda *a, **k: None)
    res = ett.setup(args.grid, args.truncation)
    nlev = args.nlev
    nsc = 2 * nlev + 1   # T, q per level + surface pressure
    say(f"IFS layout: {nlev} levels vor/div + {nsc} scalar fields at "
        f"{res.grid.name} T{res.nsmax}")
    say(device_line(dev))

    st = None
    if mesh is not None:
        st = ett.SpectralTransform(args.grid, args.truncation, mesh=mesh,
                                   dtype=dtype)
        say(f"mesh {mesh.w}x{mesh.v} over {mesh.w * mesh.v} ranks "
            f"({torch.distributed.get_backend(mesh.group)})")

    flags = ett.InvFlags(scders=True, uvders=True)
    rng = np.random.default_rng(0)

    def packed(n):
        x = rng.standard_normal((n, res.nspec2))
        x[:, 1: 2 * (res.nsmax + 1): 2] = 0.0
        x[:, 0] = 0.0
        return torch.as_tensor(x, dtype=dtype, device=dev)

    sv, sd, ss = packed(nlev), packed(nlev), packed(nsc)
    norm0 = norms.specnorm(res, ss).cpu().numpy()

    def round_trip(pv, pd, psc):
        """One packet's inverse and direct transform -> its spectra."""
        if st is None:
            g = ett.inv_trans(res, spvor=pv, spdiv=pd, spscalar=psc,
                              flags=flags, dtype=dtype)
        else:
            g = st.inv_trans(spvor=st.dist_spec(pv), spdiv=st.dist_spec(pd),
                             spscalar=st.dist_spec(psc), flags=flags)
        m, n = pv.shape[0], psc.shape[0]
        u, v, sc = g[:m], g[m: 2 * m], g[2 * m: 2 * m + n]
        if st is None:
            return ett.dir_trans(res, u=u, v=v, scalars=sc, dtype=dtype)
        return tuple(torch.as_tensor(st.gath_spec(x), device=dev)
                     for x in st.dir_trans(u=u, v=v, scalars=sc))

    loop = packets(nlev, args.npromatr if args.npromatr > 0 else nlev)
    ts = []
    for it in range(args.niter + 1):     # the first iteration = warm-up
        t0 = time.perf_counter()
        # packet loop over levels (NPROMATR): one inv + dir round trip a
        # packet keeps the padded grid-space working set bounded
        outs = [round_trip(sv[lo:hi], sd[lo:hi],
                           ss[torch.as_tensor(sc, device=dev)])
                for lo, hi, sc in loop]
        sv = torch.cat([pv for pv, _, _ in outs])
        sd = torch.cat([pd for _, pd, _ in outs])
        # reassemble the scalar order: T blocks, q blocks, sp
        tpar = [psc[: hi - lo] for (lo, hi, _), (_, _, psc) in zip(loop, outs)]
        qpar = [psc[hi - lo: 2 * (hi - lo)]
                for (lo, hi, _), (_, _, psc) in zip(loop, outs)]
        ss = torch.cat(tpar + qpar + [outs[0][2][2 * loop[0][1]:]])
        synchronize(dev)
        ts.append(time.perf_counter() - t0)

    t = torch.tensor(ts, dtype=torch.float64)
    if mesh is not None:             # each iteration at its slowest rank
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    a = t[1:].numpy()
    say(f"roundtrip avg {a.mean()*1e3:.2f} ms  min {a.min()*1e3:.2f}  "
        f"max {a.max()*1e3:.2f}  med {np.median(a)*1e3:.2f}")
    gpps = res.grid.ngptot * (nsc + 2 * nlev) / a.mean()
    say(f"throughput {gpps:.3e} gridpoints*fields/s")
    if not lead:
        return dict(ok=True)

    err, ok = None, True
    if args.check:
        err = drift(norms.specnorm(res, ss).cpu().numpy(), norm0)
        ok = check_line(err, args.check, dtype, args.niter)

    def host(x):
        return x.detach().cpu().double().numpy()

    return dict(spectra=dict(vor=host(sv), div=host(sd), sc=host(ss)),
                t_rt=a.tolist(), first=t[0].item(), throughput=gpps,
                drift=err, ok=ok)


if __name__ == "__main__":
    main()
