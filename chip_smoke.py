#!/usr/bin/env python3
"""Smoke test of ectrans_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing a line:

1. build the CUDA kernels from ``ectrans_tpu_torch/csrc`` and print the
   card's name and power limit (nvidia-smi);
2. hold each kernel against its plain PyTorch version on the card, at the
   TCO1279 shapes of the benchmark round trip: K4 (table generator, all
   groups, against the plain fp64 recurrence), K1 and K2 (inverse and direct
   Legendre, all groups, fields as in the round trip), K3 (packing, all
   groups, bit-exact); kernel and plain times with CUDA events;
3. the whole inv_trans + dir_trans at T159 (O160 grid) on the card, in fp32
   and fp64, against the plain path on the CPU in fp64;
4. the benchmark configuration of ``bench.py``: TCO1279, 2 vor/div pairs and
   6 scalars with N-S and E-W derivatives (26 grid fields), then dir_trans
   of u, v and the scalars in fp32; the 100*eps round-trip gate on every
   field family; setup and round-trip times; the launch count of every
   kernel in that run must be above 0.

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
}
NFLD_UV, NFLD_SC = 2, 6          # bench.py's field counts


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
    from ectrans_tpu_torch.ops import legendre_dense, legendre_tablegen, pack

    return {"K1": legendre_dense.group_inv_dense,
            "K2": legendre_dense.group_dir_dense,
            "K3": pack.packed_from_group_rows,
            "K4": legendre_tablegen.gen_group}


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


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version at the TCO1279 shapes."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.ops import legendre_dense as ld
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

    # K1 (inverse: 16 fields -> fc2 32) and K2 (direct: 10 fields -> fc2 20)
    for key, fc2 in (("K1", 32), ("K2", 20)):
        err, rel, t_k, t_p = 0.0, 0.0, 0.0, 0.0
        for g in fl.groups:
            gm, J, ig = g.pn.shape
            if key == "K1":
                args = (torch.randn(gm, fc2, J, generator=gen, device=dev),
                        g.pn)
                kern, plain = ld.group_inv_dense, ld.group_inv_dense_plain
            else:
                args = tuple(torch.randn(gm, fc2, ig, generator=gen,
                                         device=dev) for _ in range(2)) + (g.pn,)
                kern, plain = ld.group_dir_dense, ld.group_dir_dense_plain
            got, want = kern(*args), plain(*args)
            if key == "K1":
                got, want = torch.cat(got), torch.cat(want)
            d = (got - want).abs().max().item()
            err = max(err, d)
            rel = max(rel, d / want.abs().max().item())
            t_k += cuda_ms(lambda: kern(*args))
            t_p += cuda_ms(lambda: plain(*args))
        check(rel <= 5e-6, f"{key} vs plain: {rel:.3e} > 5e-6 relative")
        out[key] = dict(max_abs_err=err, ms=t_k, plain_ms=t_p,
                        tol="5e-6 rel")

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
        f"plain {v['plain_ms']:.3f} ms" for k, v in sorted(out.items())))
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


def round_trip(res, sp, dtype):
    import ectrans_tpu_torch as ett

    grid = ett.inv_trans(res, *sp, dtype=dtype,
                         flags=ett.InvFlags(scders=True, uvders=True))
    u = grid[:NFLD_UV]
    v = grid[NFLD_UV : 2 * NFLD_UV]
    sc = grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]
    return grid, ett.dir_trans(res, u, v, sc, dtype=dtype)


def phase_small(dev: torch.device) -> None:
    """Kernel path on the card vs the plain path on the CPU in fp64."""
    import ectrans_tpu_torch as ett

    res = ett.setup("O160", 159)
    sp = bench_inputs(res.nspec2, res.nsmax)
    ref_grid, ref_spec = round_trip(res, [x.double() for x in sp],
                                    torch.float64)
    msg = []
    # fp64: 1e-10 relative to each output's max; fp32: 2e-5 absolute plus
    # 1e-5 relative to the output's max
    for dtype, atol, rtol in ((torch.float64, 0.0, 1e-10),
                              (torch.float32, 2e-5, 1e-5)):
        grid, spec = round_trip(res, [x.to(dev, dtype) for x in sp], dtype)
        pairs = [(grid, ref_grid)] + list(zip(spec, ref_spec))
        worst = max((a.cpu().double() - b).abs().max().item()
                    / (atol + rtol * b.abs().max().item()) for a, b in pairs)
        check(worst <= 1.0, f"T159 {dtype} kernel vs CPU fp64: "
                            f"{worst:.3f} of the tolerance")
        msg.append(f"{dtype} {worst:.3f} of tolerance (atol {atol:g}, "
                   f"rtol {rtol:g})")
    print("phase 3 T159 O160 round trip, card vs CPU fp64 plain: "
          + "; ".join(msg))


def phase_bench(dev: torch.device, counters: dict) -> dict:
    """bench.py's configuration on the card, with every kernel counted."""
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
    t0 = time.perf_counter()
    grid, out = round_trip(res, sp, torch.float32)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    check(all(n > 0 for n in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    check(tuple(grid.shape) == (26, res.ndgl, res.grid.ndlon),
          f"grid shape {tuple(grid.shape)}")
    check(bool(torch.isfinite(grid).all()), "non-finite grid values")
    del grid

    # 100*eps relative round-trip gate over every field family (bench.py
    # 365-384); the (m=0, n=0) coefficient of vor/div carries no wind
    # information and is left out
    eps32 = float(np.finfo(np.float32).eps)
    worst, err, gate = 0.0, 0.0, 1.0
    for i, (got, ref) in enumerate(zip(out, sp)):
        check(got is not None and got.shape == ref.shape,
              f"family {i}: shape")
        d = (got - ref).abs()
        if i < 2:
            d[:, :2] = 0.0
        e = d.max().item()
        g = 100 * eps32 * ref.abs().max().item()
        check(np.isfinite(e), f"family {i}: non-finite error")
        if e / g >= worst:
            worst, err, gate = e / g, e, g
    check(err <= gate, f"round-trip gate: err {err:.4e} > 100*eps*max "
                       f"{gate:.4e}")

    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        round_trip(res, sp, torch.float32)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 4 TCO1279 bench round trip: err {err:.4e} gate {gate:.4e}; "
          f"setup {t_setup:.2f} s (tables on the card); first round trip "
          f"{t_first:.3f} s; median {statistics.median(times) * 1e3:.1f} ms "
          f"(min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}, n 5); "
          f"peak {peak:.2f} GiB; launches {launches}")
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
    launches = phase_bench(dev, counters)
    print(json.dumps({"kernels": [
        dict(KERNELS[k], launches=launches[k],
             max_abs_err=kern[k]["max_abs_err"], ms=kern[k]["ms"],
             plain_ms=kern[k]["plain_ms"]) for k in sorted(KERNELS)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
