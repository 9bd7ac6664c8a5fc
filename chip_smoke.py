#!/usr/bin/env python3
"""Smoke test of ectrans_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing a line:

1. build the CUDA kernels from ``ectrans_tpu_torch/csrc`` and print the
   card's name and power limit (nvidia-smi);
2. hold each kernel against its plain PyTorch version on the card, at the
   TCO1279 shapes of the benchmark round trip, all groups: K4 (table
   generator, against the plain fp64 recurrence), K1 and K2 (dense-row
   Legendre), K5 and K6 (parity-split Legendre, on the parity tables derived
   on the card), K9 and K10 (bf16 limb-plane Legendre, at 3 planes and at 1,
   on planes derived on the card), with fields as in the round trip, and K3
   (packing, bit-exact); kernel and plain times with CUDA events;
3. the whole inv_trans + dir_trans at T159 (O160 grid) on the card through
   every Legendre engine ("dense", "xla", "pallas", "planes"), in fp32 and
   fp64, against the same engine's plain path on the CPU in fp64;
4. the benchmark configuration of ``bench.py``: TCO1279, 2 vor/div pairs and
   6 scalars with N-S and E-W derivatives (26 grid fields), then dir_trans
   of u, v and the scalars in fp32, "dense" engine; the 100*eps round-trip
   gate on every field family; setup and round-trip times; the launch count
   of every kernel of that path (K1-K4) must be above 0;
5. the same round trip on phase 4's inputs (so the cuFFT plans are reused)
   through "pallas" and "planes" at "highest" (100*eps gate on every
   family) and "planes" at "bf16" (1e6*eps gate on the scalars, the vor/div
   ratio printed); first call, median of 3, peak memory, and the launch
   counts of that path's kernels (K5, K6, K3; K9, K10, K3), which must be
   above 0.  Each engine's tables are freed after its run.

Then one JSON line with the kernels, and last the line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; with
no CUDA device it exits 2 before doing anything.  TF32 is off for every
matmul and convolution (the plain Legendre versions use torch.bmm).
"""

from __future__ import annotations

import gc
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    "K1": dict(name="group_inv_dense", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_dense.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:239"),
    "K2": dict(name="group_dir_dense", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_dense.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:286"),
    "K3": dict(name="packed_from_group_rows", route="cuda",
               source="ectrans_tpu_torch/csrc/pack.cu",
               replaces="ectrans_tpu/ops/pack_pallas.py:96"),
    "K4": dict(name="gen_group", route="cuda",
               source="ectrans_tpu_torch/csrc/tablegen.cu",
               replaces="ectrans_tpu/ops/legendre_tablegen.py:148"),
    "K5": dict(name="group_inv", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_grouped.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:131"),
    "K6": dict(name="group_dir", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_grouped.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:179"),
    "K9": dict(name="group_inv_planes", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_planes.cu",
               replaces="ectrans_tpu/ops/legendre_planes.py:159"),
    "K10": dict(name="group_dir_planes", route="cuda",
                source="ectrans_tpu_torch/csrc/legendre_planes.cu",
                replaces="ectrans_tpu/ops/legendre_planes.py:227"),
}
NFLD_UV, NFLD_SC = 2, 6          # bench.py's field counts
FC2_INV, FC2_DIR = 32, 20        # kernel rows: 2 x (16 inverse, 10 direct)
ENGINES = ("dense", "xla", "pallas", "planes")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of fn() in ms over reps calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def launch_counters():
    from ectrans_tpu_torch.ops import (legendre_dense, legendre_grouped,
                                       legendre_planes, legendre_tablegen,
                                       pack)

    return {"K1": legendre_dense.group_inv_dense,
            "K2": legendre_dense.group_dir_dense,
            "K3": pack.packed_from_group_rows,
            "K4": legendre_tablegen.gen_group,
            "K5": legendre_grouped.group_inv,
            "K6": legendre_grouped.group_dir,
            "K9": legendre_planes.group_inv_planes,
            "K10": legendre_planes.group_dir_planes}


def phase_build() -> None:
    from ectrans_tpu_torch import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"phase 1 build: {path.name} in {time.perf_counter() - t0:.1f} s; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.splitlines()[0])


def hold(key: str, kern, plain, args_list, tol: float = 5e-6) -> dict:
    """A kernel against its plain version on each argument tuple (one per
    m-group): max abs error, the largest error relative to the plain
    output's max (must be <= tol), and both times summed over the groups."""
    err, rel, t_k, t_p = 0.0, 0.0, 0.0, 0.0
    for args in args_list:
        got, want = kern(*args), plain(*args)
        if isinstance(got, tuple):
            got, want = torch.cat(got), torch.cat(want)
        check(bool(torch.isfinite(got).all()), f"{key}: non-finite output")
        d = (got - want).abs().max().item()
        err = max(err, d)
        rel = max(rel, d / want.abs().max().item())
        del got, want
        t_k += cuda_ms(lambda: kern(*args))
        t_p += cuda_ms(lambda: plain(*args))
    check(rel <= tol, f"{key} vs plain: {rel:.3e} > {tol:g} relative")
    return dict(max_abs_err=err, rel=rel, ms=t_k, plain_ms=t_p,
                tol=f"{tol:g} rel")


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version at the TCO1279 shapes."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.ops import legendre_dense as ld
    from ectrans_tpu_torch.ops import legendre_grouped as lg
    from ectrans_tpu_torch.ops import legendre_planes as lpl
    from ectrans_tpu_torch.ops import legendre_tablegen as tg
    from ectrans_tpu_torch.ops import pack

    res = ett.setup("TCO1279")
    groups = res.legendre_groups()
    inp = tg._device_inputs(res, dev)
    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    # K4: all groups, kernel vs the plain fp64 recurrence (fp32 tables)
    err, scale, t_k, t_p = 0.0, 0.0, 0.0, 0.0
    for m0, m1, i0, J in groups:
        t_k += cuda_ms(lambda: tg.gen_group(inp, m0, m1, J, i0, torch.float32),
                       reps=2)
        got = tg.gen_group(inp, m0, m1, J, i0, torch.float32)
        t_p += cuda_ms(lambda: tg.gen_group_plain(inp, m0, m1, J, i0,
                                                  torch.float32), reps=1)
        want = tg.gen_group_plain(inp, m0, m1, J, i0, torch.float32)
        check(bool(torch.isfinite(got).all()), f"K4 group {m0}: non-finite")
        err = max(err, (got - want).abs().max().item())
        scale = max(scale, want.abs().max().item())
        del got, want
    rel = err / max(1.0, scale)
    check(rel <= 1e-7, f"K4 vs plain: {rel:.3e} > 1e-7 (table scale)")
    out["K4"] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p, tol="1e-7 rel")
    fl = res.full_legendre(torch.float32, dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # K1 (inverse: 16 fields -> fc2 32) and K2 (direct: 10 fields -> fc2 20)
    out["K1"] = hold("K1", ld.group_inv_dense, ld.group_inv_dense_plain,
                     [(rnd(g.m1 - g.m0, FC2_INV, g.J), g.pn)
                      for g in fl.groups])
    out["K2"] = hold("K2", ld.group_dir_dense, ld.group_dir_dense_plain,
                     [(rnd(g.m1 - g.m0, FC2_DIR, g.pn.shape[2]),
                       rnd(g.m1 - g.m0, FC2_DIR, g.pn.shape[2]), g.pn)
                      for g in fl.groups])

    # K5 and K6 on the parity tables derived from pn on the card
    gl = res.grouped_legendre(torch.float32, dev)
    out["K5"] = hold("K5", lg.group_inv, lg.group_inv_plain,
                     [(rnd(g.m1 - g.m0, FC2_INV, g.kg),
                       rnd(g.m1 - g.m0, FC2_INV, g.kg), g.psym, g.pasym)
                      for g in gl.groups])
    out["K6"] = hold("K6", lg.group_dir, lg.group_dir_plain,
                     [(rnd(g.m1 - g.m0, FC2_DIR, g.psym.shape[1]),
                       rnd(g.m1 - g.m0, FC2_DIR, g.psym.shape[1]),
                       g.psym, g.pasym) for g in gl.groups])
    del gl
    res.drop_cached("grouped_legendre")

    # K9 and K10 on the planes derived on the card, operands packed as the
    # planes engine packs them; 3 planes ("highest") and 1 plane ("bf16")
    for nplanes, tag in ((3, ""), (1, " (1 plane)")):
        ppl = res.planes_legendre(nplanes, dev)
        out["K9" + tag] = hold(
            "K9" + tag, lambda a, pt: lpl.group_inv_planes(a, pt, nplanes, FC2_INV),
            lambda a, pt: lpl.group_inv_planes_plain(a, pt, nplanes,
                                                     FC2_INV),
            [(lpl._pack_inv_rows(rnd(g.m1 - g.m0, FC2_INV, g.J), nplanes),
              g.pt) for g in ppl.groups])
        out["K10" + tag] = hold(
            "K10" + tag, lambda w, pt: lpl.group_dir_planes(w, pt, nplanes, FC2_DIR),
            lambda w, pt: lpl.group_dir_planes_plain(w, pt, nplanes,
                                                     FC2_DIR),
            [(lpl._pack_dir_rows(rnd(g.m1 - g.m0, FC2_DIR, g.pt[0].shape[1]),
                                 rnd(g.m1 - g.m0, FC2_DIR, g.pt[0].shape[1]),
                                 nplanes), g.pt) for g in ppl.groups])
        torch.cuda.synchronize()
        del ppl
        res.drop_cached("planes_legendre")

    # K3: 10 output fields (vor, div x2, 6 scalars), all groups, bit-exact
    rows = [torch.randn(m1 - m0, 2 * (2 * NFLD_UV + NFLD_SC), J,
                        generator=gen, device=dev)
            for m0, m1, i0, J in groups]
    got = pack.packed_from_group_rows(rows, res)
    want = pack.packed_from_group_rows_plain(rows, res)
    check(torch.equal(got, want), "K3 vs plain: not bit-exact")
    out["K3"] = dict(max_abs_err=(got - want).abs().max().item(),
                     ms=cuda_ms(lambda: pack.packed_from_group_rows(rows, res)),
                     plain_ms=cuda_ms(
                         lambda: pack.packed_from_group_rows_plain(rows, res)),
                     tol="bit-exact")
    print("phase 2 kernels vs plain (TCO1279 shapes): " + "; ".join(
        f"{k} err {v['max_abs_err']:.3e} ({v['tol']}) {v['ms']:.3f} ms vs "
        f"plain {v['plain_ms']:.3f} ms"
        for k, v in sorted(out.items(), key=lambda kv: int(kv[0][1:3]))))
    return out


def bench_inputs(nspec2: int, nsmax: int):
    """bench.py's spectral inputs (seed 0, m=0 imaginary parts and the
    global mean zero)."""
    rng = np.random.default_rng(0)

    def packed(n):
        x = rng.standard_normal((n, nspec2)).astype(np.float32)
        x[:, 1 : 2 * (nsmax + 1) : 2] = 0.0
        x[:, 0] = 0.0
        return torch.from_numpy(x)

    return packed(NFLD_UV), packed(NFLD_UV), packed(NFLD_SC)


def round_trip(res, sp, dtype, engine="dense", precision="highest"):
    import ectrans_tpu_torch as ett

    kw = dict(dtype=dtype, precision=precision, _engine=engine)
    grid = ett.inv_trans(res, *sp, flags=ett.InvFlags(scders=True, uvders=True),
                         **kw)
    u = grid[:NFLD_UV]
    v = grid[NFLD_UV : 2 * NFLD_UV]
    sc = grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]
    return grid, ett.dir_trans(res, u, v, sc, **kw)


def phase_small(dev: torch.device) -> None:
    """Each engine's kernel path on the card vs the same engine's plain path
    on the CPU in fp64 ("planes" in fp64 is the "xla" engine)."""
    import ectrans_tpu_torch as ett

    res = ett.setup("O160", 159)
    sp = bench_inputs(res.nspec2, res.nsmax)
    msg = []
    for engine in ENGINES:
        ref_grid, ref_spec = round_trip(res, [x.double() for x in sp],
                                        torch.float64, engine)
        # fp64: 1e-10 relative to each output's max; fp32: 2e-5 absolute
        # plus 1e-5 relative to the output's max
        for dtype, atol, rtol in ((torch.float64, 0.0, 1e-10),
                                  (torch.float32, 2e-5, 1e-5)):
            grid, spec = round_trip(res, [x.to(dev, dtype) for x in sp],
                                    dtype, engine)
            pairs = [(grid, ref_grid)] + list(zip(spec, ref_spec))
            worst = max((a.cpu().double() - b).abs().max().item()
                        / (atol + rtol * b.abs().max().item())
                        for a, b in pairs)
            check(worst <= 1.0, f"T159 {engine} {dtype} card vs CPU fp64: "
                                f"{worst:.3f} of the tolerance")
            msg.append(f"{engine} {str(dtype)[6:]} {worst:.3f}")
    print("phase 3 T159 O160 round trip, card vs CPU fp64 plain, worst "
          "error as a share of the tolerance (fp64 1e-10 rel; fp32 2e-5 + "
          "1e-5 rel): " + "; ".join(msg))


def family_errors(out, sp) -> list:
    """Per field family (vor, div, scalars): (max abs round-trip error,
    max |reference|); the (m=0, n=0) coefficient of vor/div carries no wind
    information and is left out (bench.py 365-384)."""
    errs = []
    for i, (got, ref) in enumerate(zip(out, sp)):
        check(got is not None and got.shape == ref.shape, f"family {i}: shape")
        d = (got - ref).abs()
        if i < 2:
            d[:, :2] = 0.0
        e = d.max().item()
        check(np.isfinite(e), f"family {i}: non-finite error")
        errs.append((e, ref.abs().max().item()))
    return errs


def drive(res, sp, counters: dict, need: tuple, engine="dense",
          precision="highest", reset=True):
    """One round trip through an engine's main path with every launch
    counter set to 0 just before (unless the caller did) and read just
    after; each kernel in ``need`` must have been launched.  Returns (grid,
    spectra, seconds, launches)."""
    if reset:
        for c in counters.values():
            c.launches = 0
    t0 = time.perf_counter()
    grid, out = round_trip(res, sp, torch.float32, engine, precision)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {k: counters[k].launches for k in need}
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched on the {engine} path: {launches}")
    check(tuple(grid.shape) == (26, res.ndgl, res.grid.ndlon),
          f"grid shape {tuple(grid.shape)}")
    check(bool(torch.isfinite(grid).all()), "non-finite grid values")
    return grid, out, t_first, launches


def median_ms(res, sp, n: int, engine="dense", precision="highest"):
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        round_trip(res, sp, torch.float32, engine, precision)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (statistics.median(times) * 1e3, min(times) * 1e3,
            max(times) * 1e3)


def phase_bench(dev: torch.device, counters: dict):
    """bench.py's configuration on the card through the "dense" engine,
    with the setup's table generation (K4) counted."""
    import ectrans_tpu_torch as ett

    from ectrans_tpu_torch.gauss import gauss_legendre

    gauss_legendre.cache_clear()     # time a cold setup
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = ett.setup("TCO1279")
    res.full_legendre(torch.float32, dev)
    res.device_tables(torch.float32, dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    sp = [x.to(dev) for x in bench_inputs(res.nspec2, res.nsmax)]
    torch.cuda.reset_peak_memory_stats()
    # the counts were set to 0 before the setup, whose tables K4 makes
    grid, out, t_first, launches = drive(res, sp, counters,
                                         ("K1", "K2", "K3", "K4"),
                                         reset=False)
    del grid

    eps32 = float(np.finfo(np.float32).eps)
    err, gate = max(((e, 100 * eps32 * m) for e, m in family_errors(out, sp)),
                    key=lambda x: x[0] / x[1])
    check(err <= gate, f"round-trip gate: err {err:.4e} > 100*eps*max "
                       f"{gate:.4e}")
    med, lo, hi = median_ms(res, sp, 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 4 TCO1279 bench round trip (dense): err {err:.4e} gate "
          f"{gate:.4e}; setup {t_setup:.2f} s (tables on the card); first "
          f"round trip {t_first:.3f} s; median {med:.1f} ms (min {lo:.1f}, "
          f"max {hi:.1f}, n 5); peak {peak:.2f} GiB; launches {launches}; "
          f"cuFFT plans cached {torch.backends.cuda.cufft_plan_cache[dev.index].size}")
    return res, sp, launches


def phase_engines(dev: torch.device, res, sp, counters: dict) -> dict:
    """Phase 4's round trip through the "pallas" and "planes" engines."""
    eps32 = float(np.finfo(np.float32).eps)
    launches = {}
    for engine, precision, need in (("pallas", "highest", ("K3", "K5", "K6")),
                                    ("planes", "highest", ("K3", "K9", "K10")),
                                    ("planes", "bf16", ("K3", "K9", "K10"))):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        grid, out, t_first, got = drive(res, sp, counters, need, engine,
                                        precision)
        del grid
        errs = family_errors(out, sp)
        if precision == "highest":
            err, gate = max(((e, 100 * eps32 * m) for e, m in errs),
                            key=lambda x: x[0] / x[1])
            check(err <= gate, f"{engine} round-trip gate: err {err:.4e} > "
                               f"100*eps*max {gate:.4e}")
            verdict = f"err {err:.4e} gate (100 eps) {gate:.4e}"
            launches.update({k: n for k, n in got.items() if k != "K3"})
        else:
            # the 1e6*eps gate holds the scalars; vor/div go through UVTVD's
            # ~n amplification and are printed beside it
            err, m = errs[2]
            gate = 1e6 * eps32 * m
            check(err <= gate, f"{engine} {precision} scalar gate: err "
                               f"{err:.4e} > 1e6*eps*max {gate:.4e}")
            ratios = [e / (1e6 * eps32 * mm) for e, mm in errs[:2]]
            verdict = (f"scalars err {err:.4e} gate (1e6 eps) {gate:.4e}; "
                       f"vor/div at {ratios[0]:.3f} / {ratios[1]:.3f} of "
                       "their 1e6 eps gate")
        med, lo, hi = median_ms(res, sp, 3, engine, precision)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"phase 5 TCO1279 bench round trip ({engine}, {precision}): "
              f"{verdict}; first call {t_first:.3f} s; median {med:.1f} ms "
              f"(min {lo:.1f}, max {hi:.1f}, n 3); peak {peak:.2f} GiB; "
              f"launches {got}; cuFFT plans cached "
              f"{torch.backends.cuda.cufft_plan_cache[dev.index].size}")
        res.drop_cached("grouped_legendre")
        res.drop_cached("planes_legendre")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    phase_build()
    kern = phase_kernels(dev)
    gc.collect()
    torch.cuda.empty_cache()
    phase_small(dev)
    counters = launch_counters()
    res, sp, launches = phase_bench(dev, counters)
    launches.update(phase_engines(dev, res, sp, counters))
    print(json.dumps({"kernels": [
        dict(KERNELS[k], launches=launches[k],
             max_abs_err=kern[k]["max_abs_err"], ms=kern[k]["ms"],
             plain_ms=kern[k]["plain_ms"])
        for k in sorted(KERNELS, key=lambda k: int(k[1:]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
