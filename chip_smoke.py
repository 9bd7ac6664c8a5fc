#!/usr/bin/env python3
"""Smoke test of ectrans_tpu_torch on one CUDA card (an NVIDIA H100).

    python3 chip_smoke.py

Phases, each printing a line:

1. build the CUDA kernels from ``ectrans_tpu_torch/csrc`` and print the
   card's name and power limit (nvidia-smi);
2. hold each kernel against its plain PyTorch version on the card, at the
   TCO1279 shapes of the benchmark round trip, all groups: K4 (table
   generator, every group in one launch, against the plain fp64
   recurrence; its bf16 tables must be the fp32 tables rounded), K1 and K2
   (dense-row Legendre), K7 and K8 (hemisphere-packed, at twice K1's and
   K2's rows), K5 and K6 (parity-split Legendre, on the parity tables
   derived on the card), K9 and K10 (bf16 limb-plane Legendre, at 3 planes
   and at 1, on planes derived on the card), the bf16-table variants of K1,
   K2, K5, K6, K7 and K8 (on the "bf16" tier's tables made on the card),
   with fields as in the round trip, K3 (packing, one launch, bit-exact),
   and at the roofline probe's 512 MiB shape K11 (copy, bit-exact) and K12
   (read-reduce, 1e-6 relative, bit-identical across two calls); kernel and
   plain times with CUDA events (mean of 3
   calls, the host's launch cost included where it outlasts the kernel),
   each kernel's bound (the larger of its bytes over 3.35 TB/s and its
   operations over the data sheet's peak; the bytes each input read once
   and each output written once, so K3's count each packed value twice
   and K4's the tables and the inputs its columns read; K4's operations
   are the fp64-pipe issue slots of its loop) and, for K3, K5, K6, K7, K8
   (fp32), K11 and K12, the one PyTorch call that computes the same
   function (torch.take for K3, on the groups' rows concatenated and the
   index of each packed value in them, both made untimed; torch.bmm: for
   K5 on the rows [sym, asym; sym, -asym] against [psym, pasym], which
   gives north and south at twice K5's FLOP, for K6 on its parity operands
   stacked along the batch; clone, sum), and for K9
   and K10 a yardstick (one torch.bmm on fp32 operands whose limbs and
   planes were summed beforehand, untimed, at twice their FLOP; a
   different function, so their ``library_ms`` stays null and the
   yardstick's time is ``yardstick_ms``), timed in turns with the kernel.
   K1-K12, the kernels redesigned for the card, get a line each
   (``redesign_report``): the time (for K1, K2, K7, K8 against torch.bmm's
   on the stacked rows: K7's and K8's one-call counterpart, timed in their
   turns; for K1 and K2 a reference at twice their FLOP, not a route; for
   K3 (one torch.take on the concatenated group rows), K5, K6, K11 and K12
   against their own one call; for K9 and K10 against
   their yardsticks), the bound with both its terms and the share of it,
   beside them a second measure (the device time with the calls enqueued
   behind a spin kernel, and the host's time to enqueue a call), the blocks
   per launch, threads and waves, and the registers and spills from
   ``build.log`` (a spill fails the run); K5's and K6's lines add their
   bf16-table variants' times, K9's and K10's their 1-plane numbers, K6's
   and K10's their latitude split per group, and K12's its plan and its
   second launch's registers; then the padding A/B of K9 and K10 (3 planes
   in rows padded to 8 entries against contiguous copies, which the
   wrappers copy into padded rows on each call, in turns, outputs
   bit-identical);
3. the whole inv_trans + dir_trans at T159 (O160 grid) on the card through
   every Legendre engine ("dense", "xla", "pallas", "planes"), in fp32 and
   fp64, against the same engine's plain path on the CPU in fp64;
4. the benchmark configuration of ``bench.py``: TCO1279, 2 vor/div pairs and
   6 scalars with N-S and E-W derivatives (26 grid fields), then dir_trans
   of u, v and the scalars in fp32, "dense" engine; the 100*eps round-trip
   gate on every field family, of which the worst may take at most 0.65 (the
   margin that K1's and K2's summation order must keep); setup and
   round-trip times; every kernel of that path (K1-K4) must have been
   launched, K3 once (the direct transform) and K4 once (the setup's
   full_legendre build);
5. the same round trip on phase 4's inputs (so the cuFFT plans are reused)
   through "xla" (its einsums alone: no Legendre kernel and no K3; at most
   1.0 of the gate), "pallas" and "planes" at "highest", "dense" with
   ECTRANS_TPU_LEG_DENSE_PACK=1 (K7 once per m-group, K8, K3 launched and
   K1, K2 not) and
   "dense" with ECTRANS_TPU_PACK_KERNEL=xla (K1, K2 and not K3), all with
   the 100*eps gate on every family ("pallas" may take at most 0.80 of it,
   the margin K5's and K6's summation order must keep, and launches K5 and
   K6 once per m-group each and never K1 or K2; "planes" at most 0.65,
   K9's and K10's margin, and K9 and K10 once per m-group each, at both
   tiers); then "planes", "dense"
   and "pallas" at "bf16" (the 1e6*eps gate on the scalars, the vor/div
   ratio printed;
   "dense" makes its bf16 tables in one K4 launch). K3 runs once a row.
   First call, median of 3, peak memory, and the launch counts of that
   path's kernels.  Each engine's derived tables are freed after its run,
   and the "dense" fp32 tables before the "bf16" rows of "dense" and
   "pallas", so that their peaks show their own tables;
6. the roofline probes of ``ectrans_tpu_torch.roofline`` (torch's ``x + 1``,
   K11 and K12 streaming rates, K1 against K7 and K2 against K8 at the JAX
   roofline tool's dense shape, J 2562: twice TCO1279 group 0's J of
   1282); K11 and K12 must have been launched;
7. bench.py's second configuration, TCO639, through the default "dense"
   fp32 path on inputs made as phase 4's: the 100*eps gate (at most 1.0 of
   it), setup, first call, median of 3, and K1-K4's launches (K3 and K4
   once).

Between phases 5 and 6, phase 8, the handle at TCO1279, on phase 4's
inputs: (a) ``SpectralTransform("TCO1279")`` on the default device, the
card, gets phase 4's Resolution from the setup cache; its round trip must
match phase 4's outputs (the largest difference and bit identity printed)
and take at most 0.65 of the 100*eps gate, with K1 and K2 once per m-group
and K3 once; (b) the same round trip with npromatr=4 (one uv packet, two
scalar packets, the second padded with two zero fields; each way): within
2e-5 abs + 1e-5 of each output's max of the single call, at most 0.65 of the
gate, K1 and K2 16 launches a packet and K3 one a direct packet, median and
peak beside the single call's; (c) the adjoint identity in fp32 on the
bench fields (random cotangents from a seeded generator, the inner products
in fp64) within 2000 eps for inv_trans_adj and dir_trans_adj, with the
forward on "xla" and on the default "dense", no kernel launched inside an
adjoint (first call, median of 3, peak); (d) specnorm of the input spectra
and gpnorm of the inverse grid on the card against the CPU in fp64 (1e-6
relative; the average's error against each field's mean |value|; min and
max exact); (e) the allocated memory before and after trans_end() and
empty_cache: the tables must be freed.  Phase 8 raises the cuFFT plan
cache to 16,384 plans: its packets and adjoints add four field counts of
1,280 lengths each.  Then the DENSE_PACK A/B line: K7 + K8 against K1 + K2
from phase 2 (the same call), and the two round trips' gate ratios, medians
and launch counts from phases 4 and 5.  Phase 2 ends with trans_end, so
that phase 4 times a setup of its own.

After phase 7, three phases at full width:

9. the lat-lon output at TCO1279 onto the 0.25 degree grid with poles (721 x
   1440, ECMWF's open-data grid; every row folds modes, 2 * 1279 >= 1440):
   ``SpectralTransform("TCO1279").inv_trans_latlon`` on phase 4's inputs and
   flags (26 fields, fp32; the tables set up again after phase 8e's
   trans_end, by K4 in one launch, and timed), with no Legendre or packing
   kernel; (a) against the card's fp64 path, (b) against a host fp64
   evaluation by direct sums at 10 sample rows (both poles and their
   neighbours, the equator and its neighbours, rows between):
   ``compute_legendre_table`` and explicit cos/sin sums over every
   longitude, no FFT and no folding code, and the fp64 output there
   within 1e-10 of each field's largest |value|, with the host sums, the
   fp64 lat-lon tables built anew and a second fp64 call bit-identical
   (the last two in memory filled with NaN first, so that a read of an
   unwritten element shows) and the card's fp64 tables at the rows' nodes
   within 1e-11 of the host's recurrence (``c1_probe``, not run here,
   also holds the card's fp64 output against the same code on the CPU);
   (c) ``dir_trans_latlon`` fp32
   against fp64 (the Gaussian tables by K4, a launch a group), and the
   interpolation-limited round trip of the scalars truncated at n <= 319
   (printed: the error on n <= 319 and the aliases above it); (d) the
   adjoint identity by autograd, 2000 eps; (a)-(c) at 100 eps of each
   field's largest |value|; K4 held against its plain version at the
   lat-lon nodes (the pole row included);
10. the LAM at the 1.3 km domain (1536 x 1280, C+I 1440 x 1200, dx = dy =
   1300 m, truncation (767, 639)) through ``LamTransform``: 10 vor/div
   pairs and 10 scalars (the physical-field mask, seed 0), the mean wind,
   every flag (90 fields, fp32); (a) the round trip at 100 eps of each
   family's largest |value| (the mean wind of its wind field's: it is that
   field's (0, 0) coefficient); (b) one (m, n) mode of each component and
   its derivatives against the closed form in fp64, 1e-10; (c)
   ``biperiodicize("spline")`` of a smooth C+I field and its round trip,
   fp32 on the card against the CPU's fp64, 100 eps; (d) both adjoint
   identities, 2000 eps; (e) the norms against the CPU's fp64 (as 8d); no
   kernel may run.

11. the distributed transforms (``parallel/``, ``lam/sharded.py``) on a
   (w, v) mesh of 4 ranks, all on the card, spawned with
   ``torch.multiprocessing`` and joined within their own limit, in one gloo
   group (NCCL refuses two ranks on one device; gloo stages its collectives
   through the host, so the phase's times are a check's, not distributed
   performance); each rank makes its inputs from phase 4's seed and takes
   its shard (``dist_spec``/``dist_grid``): (a) the bench round trip at
   TCO1279 on (2, 2), fp32 "dense", at most 0.65 of the 100 eps gate and
   within 100 eps of each family's max of phase 4's grid and spectra, K1
   and K2 16 times a rank, K3 and K4 once (first call, median of 3, peak
   per rank, MiB each collective sends); (e) its handle's
   ``inv_trans_latlon`` onto 721 x 1440 against phase 9's output (100 eps
   of each field's max; K4 once a rank); (b) T159 fp64 on (1, 1), (2, 1),
   (1, 2), (2, 2), (4, 1), (1, 4) (the smaller meshes on subgroups), each
   within 1e-12 of the single device, every pair within 1e-13; (c) the
   same meshes in fp32 "dense" (and "bf16" on (2, 2)) within 100 eps of
   each family's max of the single device's tier, K1-K3 on every rank;
   (d) kvsetuv/kvsetsc and npromatr=4 packets on (1, 2) within 1e-12 of
   the plain mesh call; (f) the LAM of phase 10 on (2, 2), both
   directions against phase 10's outputs at 100 eps, no kernel.

12. the programs (``ectrans_tpu_torch.programs``), each run's lines printed
   behind its row: (a) ``info`` names the card; (b) the global driver at
   TCO1279 on bench.py's field set (``-f 3 -l 2 --vordiv --scders
   --uvders``, 26 grid fields) in fp32, ``-n 5 --check 100 --meminfo``, in
   this process through ``main(argv)``: its check OK, K1 and K2 16 times a
   transform, K3 once a direct transform, K4 once (first call, medians,
   throughput, peak); (c) the same in fp64 at ``-n 2`` (K1 and K2 in their
   fp64 variant); (d) (b)'s flags with ``--mesh 2x2`` as a command (4
   ranks on the card over gloo, started by ``programs/world.py``): its
   check OK and each field's norm in its checksum file within 100 eps(fp32)
   niter of (b)'s; (e) the LAM driver at phase 10's domain and field
   count: its check OK, no kernel.

Each prints its times, peak memory and seconds.  Then one JSON line with the
kernels (K1-K4's launches: phase 4's and phase 8's (a) and (b), K4's of
phase 9, phase 11's (a) and (e) summed over its ranks, and phase 12's (b)
and (c)), and last the line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; with
no CUDA device it exits 2 before doing anything.  TF32 is off for every
matmul and convolution (the plain Legendre versions use torch.bmm).
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

KERNELS = {
    "K1": dict(name="group_inv_dense", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_dense2.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:239"),
    "K2": dict(name="group_dir_dense", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_dense2_dir.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:286"),
    "K3": dict(name="packed_from_group_rows", route="cuda",
               source="ectrans_tpu_torch/csrc/pack.cu",
               replaces="ectrans_tpu/ops/pack_pallas.py:96"),
    "K4": dict(name="gen_groups", route="cuda",
               source="ectrans_tpu_torch/csrc/tablegen.cu",
               replaces="ectrans_tpu/ops/legendre_tablegen.py:148"),
    "K5": dict(name="group_inv", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_grouped.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:131"),
    "K6": dict(name="group_dir", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_grouped.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:179"),
    "K7": dict(name="group_inv_dense2", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_dense2.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:335"),
    "K8": dict(name="group_dir_dense2", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_dense2_dir.cu",
               replaces="ectrans_tpu/ops/legendre_pallas.py:370"),
    "K9": dict(name="group_inv_planes", route="cuda",
               source="ectrans_tpu_torch/csrc/legendre_planes.cu",
               replaces="ectrans_tpu/ops/legendre_planes.py:159"),
    "K10": dict(name="group_dir_planes", route="cuda",
                source="ectrans_tpu_torch/csrc/legendre_planes.cu",
                replaces="ectrans_tpu/ops/legendre_planes.py:227"),
    "K11": dict(name="stream_copy", route="cuda",
                source="ectrans_tpu_torch/csrc/roofline.cu",
                replaces="tools/roofline.py:79"),
    "K12": dict(name="read_reduce", route="cuda",
                source="ectrans_tpu_torch/csrc/roofline.cu",
                replaces="tools/roofline.py:107"),
}
NFLD_UV, NFLD_SC = 2, 6          # bench.py's field counts
# the card's peaks (NVIDIA's H100 SXM data sheet, at 700 W): device memory,
# fp32 FMA outside the tensor cores, and fp64 outside them (K4's recurrence)
HBM_BPS, FP32_FLOPS, FP64_FLOPS = 3.35e12, 67e12, 34e12
# fp64 instructions a second: the FLOP rate counts an FMA as 2 operations
FP64_INSTR = FP64_FLOPS / 2
# K4's fp64-pipe issue slots per fp32 table entry (csrc/tablegen.cu): 3
# multiplies and 1 subtraction of the recurrence and 1 multiply by 2^E, each
# one slot, and the fp64 -> fp32 conversion, which issues at a quarter of the
# multiply rate (CUDA C++ Programming Guide, throughput of conversions from
# 64-bit types on compute capability 9.0): 4 slots
K4_FP64_PER_ENTRY, K4_CVT_PER_ENTRY, CVT_SLOTS = 5, 1, 4
FC2_INV, FC2_DIR = 32, 20        # kernel rows: 2 x (16 inverse, 10 direct)
SPIN_CYCLES = 2_000_000          # spin_ms's spin kernel: ~1 ms on an H100
# the largest share of the 100*eps gate the default round trip may take:
# its margin decides K1's and K2's summation order
DENSE_GATE_SHARE = 0.65
# and the "pallas" fp32 round trip's (K5's and K6's order; 0.764 on the
# template kernels)
PALLAS_GATE_SHARE = 0.80
# and the "planes" fp32 round trip's (K9's and K10's order; 0.624 on the
# template kernels)
PLANES_GATE_SHARE = 0.65
ENGINES = ("dense", "xla", "pallas", "planes")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean time of fn() in ms over reps calls, after one warm-up, between
    two CUDA events: the kernel-table measure, in which a short call's host
    launch cost shows as it does on the main path."""
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


def spin_ms(fn, reps: int = 3) -> tuple:
    """(device ms, host ms) per call of fn(), over reps calls after one
    warm-up: a spin kernel (~1 ms) holds the stream while the host enqueues
    the calls, so the events time the device alone, and the host's clock
    times the enqueueing alone."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t_host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, t_host * 1e3 / reps


def launch_counters():
    from ectrans_tpu_torch import roofline
    from ectrans_tpu_torch.ops import (legendre_dense, legendre_grouped,
                                       legendre_planes, legendre_tablegen,
                                       pack)

    return {"K1": legendre_dense.group_inv_dense,
            "K2": legendre_dense.group_dir_dense,
            "K3": pack.packed_from_group_rows,
            "K4": legendre_tablegen.gen_groups,
            "K5": legendre_grouped.group_inv,
            "K6": legendre_grouped.group_dir,
            "K7": legendre_dense.group_inv_dense2,
            "K8": legendre_dense.group_dir_dense2,
            "K9": legendre_planes.group_inv_planes,
            "K10": legendre_planes.group_dir_planes,
            "K11": roofline.stream_copy,
            "K12": roofline.read_reduce}


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the duration of a block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


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


def tensor_bytes(*xs) -> int:
    """Bytes of the tensors in xs (nested in tuples and lists)."""
    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            n += tensor_bytes(*x)
    return n


def bound(flop: float, nbytes: float, rate: float = FP32_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over their peak rate (both terms kept)."""
    t_b, t_f = nbytes / HBM_BPS * 1e3, flop / rate * 1e3
    return dict(bound_ms=max(t_b, t_f),
                bound_by="bytes" if t_b >= t_f else "operations",
                bytes_ms=t_b, ops_ms=t_f)


def compare(key: str, got, want) -> tuple:
    """(max abs difference, max |want|, bit-identical) of a kernel's output
    and its plain version's: tensors, or tuples or lists of them."""
    pairs = (zip(got, want) if isinstance(got, (tuple, list))
             else [(got, want)])
    d, scale, exact = 0.0, 0.0, True
    for g, w in pairs:
        check(bool(torch.isfinite(g).all()), f"{key}: non-finite output")
        d = max(d, (g - w).abs().max().item())
        scale = max(scale, w.abs().max().item())
        exact = exact and torch.equal(g, w)
    return d, scale, exact


def hold(key: str, kern, plain, args_list, tol: float = 5e-6, flop=None,
         library=None, spin=False, nbytes=None, rate: float = FP32_FLOPS,
         reps: int = 3, plain_reps: int = 3) -> dict:
    """A kernel against its plain version on each argument tuple (one per
    m-group, or one for a kernel that takes every group in one launch): max
    abs error, the largest error relative to the plain output's max (must
    be <= tol; tol 0 asks for bit-exact outputs), whether every output is
    bit-identical, and both times summed over the tuples (means of ``reps``
    and ``plain_reps`` calls); the bound from ``flop(*args)`` operations at
    ``rate`` (fp32 FMA by default) and ``nbytes(args, got)`` bytes (by
    default the bytes of the arguments and the output); with ``library``,
    the time of that one PyTorch call on the same arguments, taken in turns
    with the kernel's (kernel, library, kernel, library; each kernel time is
    the mean of its two); with ``spin``, also the kernel's device time
    behind a spin kernel (``spin_ms``, summed) and its host time a call (the
    mean over the tuples).  ``library`` may be a pair (prepare, call): the
    call times on ``prepare(*args)``, made before the timing."""
    err, rel, t_k, t_p, t_l, nflop, moved = 0.0, 0.0, 0.0, 0.0, 0.0, 0, 0
    t_dev, t_host, exact = 0.0, 0.0, True
    for args in args_list:
        got, want = kern(*args), plain(*args)
        moved += nbytes(args, got) if nbytes else tensor_bytes(args, got)
        nflop += flop(*args) if flop else 0
        d, scale, same = compare(key, got, want)
        del got, want
        err, rel, exact = max(err, d), max(rel, d / scale), exact and same
        if library is None:
            t_k += cuda_ms(lambda: kern(*args), reps)
        else:
            prep, call = (library if isinstance(library, tuple)
                          else (lambda *a: a, library))
            largs = prep(*args)
            turns = [cuda_ms(lambda: f(*a), reps) for f, a in
                     ((kern, args), (call, largs), (kern, args),
                      (call, largs))]
            del largs
            t_k += (turns[0] + turns[2]) / 2
            t_l += (turns[1] + turns[3]) / 2
        t_p += cuda_ms(lambda: plain(*args), plain_reps)
        if spin:
            d, h = spin_ms(lambda: kern(*args), reps)
            t_dev += d
            t_host += h / len(args_list)
    if tol == 0:
        check(exact, f"{key} vs plain: not bit-exact")
    else:
        check(rel <= tol, f"{key} vs plain: {rel:.3e} > {tol:g} relative")
    return dict(max_abs_err=err, rel=rel, exact=exact, ms=t_k, plain_ms=t_p,
                library_ms=t_l if library else None, reps=reps,
                tol="bit-exact" if tol == 0 else f"{tol:g} rel",
                spin_ms=t_dev if spin else None,
                host_ms=t_host if spin else None, **bound(nflop, moved, rate))


def ptxas_report(needle: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name contains
    ``needle``, from the compiler's report beside the kernel library."""
    from ectrans_tpu_torch import _build

    out, name = {}, None
    for line in (_build.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if needle in line else None
        elif name and "spill stores" in line:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            out.setdefault(name, {}).update(stack=nums[0], spill_stores=nums[1],
                                            spill_loads=nums[2])
        elif name and "Used" in line and "registers" in line:
            words = line.split()
            out.setdefault(name, {})["registers"] = int(
                words[words.index("registers,") - 1])
    return out


def registers(key: str, needle: str, variants: int = 2) -> dict:
    """A kernel's registers by variant (fp32, fp64, bf16) from
    ``build.log``; its ``variants`` variants must be there, and none may
    spill."""
    rep = ptxas_report(needle)
    check(len(rep) == variants,
          f"{key}: {len(rep)} kernels in build.log, expected {variants}")
    for name, r in rep.items():
        check(r["spill_stores"] == 0 and r["spill_loads"] == 0,
              f"{key} {name} spills: {r}")
    return {variant_of(name, needle): r["registers"]
            for name, r in rep.items()}


def variant_of(name: str, needle: str) -> str:
    """The variant a mangled kernel name in build.log is: fp32, fp64, bf16
    (its table type), or for K9 and K10 its plane count (template argument
    <P>)."""
    if needle + "ILi3E" in name:
        return "3 planes"
    if needle + "ILi1E" in name:
        return "1 plane"
    return ("bf16" if "bfloat16" in name else
            "fp64" if needle + "Id" in name else "fp32")

# the kernels whose library line is a yardstick, not the same inputs: one
# torch.bmm on fp32 operands whose limbs and planes were summed beforehand
YARDSTICKS = ("K9", "K10")
# the kernels redesigned for the card: mangled-name needle in build.log, the
# variants compiled, and the kernel whose torch.bmm on the stacked rows is
# the line's yardstick (its own library call, or K7's and K8's for K1 and K2:
# the same outputs at twice the FLOP, a reference only; None: no one call)
REDESIGNED = {"K1": ("k116inv_dense_kernel", ("fp32", "bf16"), "K7"),
              "K2": ("k216dir_dense_kernel", ("fp32", "bf16"), "K8"),
              "K3": ("14k3_pack_kernel", ("fp32", "fp64"), "K3"),
              "K4": ("18k4_tablegen_kernel", ("fp32", "fp64", "bf16"), None),
              "K5": ("k518inv_grouped_kernel", ("fp32", "bf16"), "K5"),
              "K6": ("k618dir_grouped_kernel", ("fp32", "bf16"), "K6"),
              "K7": ("k717inv_dense2_kernel", ("fp32", "bf16"), "K7"),
              "K8": ("k817dir_dense2_kernel", ("fp32", "bf16"), "K8"),
              "K9": ("k917inv_planes_kernel", ("3 planes", "1 plane"), "K9"),
              "K10": ("k1017dir_planes_kernel", ("3 planes", "1 plane"),
                      "K10"),
              "K11": ("15k11_copy_kernel", ("fp32",), "K11"),
              "K12": ("17k12_reduce_kernel", ("fp32",), "K12")}
# K12's second launch, which adds the blocks' partials in order
K12_FINAL = "16k12_final_kernel"
# the one PyTorch call a kernel's line is timed against (torch.bmm if not
# named)
LIBRARY_CALLS = {"K3": "torch.take", "K11": "x.clone()", "K12": "sum"}
# K1's, K2's, K7's and K8's launch-shape reports in legendre_dense, their
# rows at the bench shapes, and the table axis (ig or J) they take last
DENSE_SHAPES = {"K1": ("group_inv_dense_shape", FC2_INV, 2),
                "K2": ("group_dir_dense_shape", FC2_DIR, 1),
                "K7": ("group_inv_dense2_shape", 2 * FC2_INV, 2),
                "K8": ("group_dir_dense2_shape", 2 * FC2_DIR, 1)}


def redesign_report(key: str, out: dict) -> None:
    """Phase 2's line for a kernel of REDESIGNED, from its ``hold`` in
    ``out`` and what phase 2 added to it (``what``: the call; ``shapes``:
    each launch's shape; ``moved``: a label and the bytes whose rate the line
    gives; ``note``, optional): the table measure (against torch.bmm where
    there is a yardstick), the bound with both its terms and the share of
    it, the rate, the device time behind a spin kernel and the host time a
    call (a separate measure, labelled so), blocks, threads and waves, and
    the compiler's registers and spills; no spill is allowed."""
    k = out[key]
    needle, variants, ref = REDESIGNED[key]
    shapes = k["shapes"]
    vs = ""
    if key in YARDSTICKS:
        bmm = out[ref]["yardstick_ms"]
        vs = (f" vs torch.bmm on the summed limbs and planes {bmm:.3f} ms, in "
              f"turns (a yardstick at twice the FLOP, the sums untimed: "
              f"{k['ms'] / bmm:.2f}x)")
    elif ref == key:
        bmm = out[ref]["library_ms"]
        vs = (f" vs {LIBRARY_CALLS.get(key, 'torch.bmm')} {bmm:.3f} ms, in "
              f"turns ({k['ms'] / bmm:.2f}x)")
    elif ref:
        bmm = out[ref]["library_ms"]
        vs = (f" vs torch.bmm on the stacked rows {bmm:.3f} ms ({ref}'s "
              f"turns; a reference at twice the FLOP, not a route: "
              f"{k['ms'] / bmm:.2f}x)")
    label, moved = k["moved"]
    regs = registers(key, needle, len(variants))

    def values(f):
        return "/".join(str(v) for v in sorted({s[f] for s in shapes}))

    def span(xs, fmt="{}"):
        lo, hi = fmt.format(min(xs)), fmt.format(max(xs))
        return lo if lo == hi else f"{lo}-{hi}"

    wide = [i for i, s in enumerate(shapes)
            if s["threads"] > min(s["threads"] for s in shapes)]
    waves = [s["waves"] for s in shapes]
    first = (f" (groups 0-2: {', '.join(f'{w:.2f}' for w in waves[:3])})"
             if len(shapes) > 1 else "")
    err = ("bit-exact" if k["tol"] == "bit-exact" else
           f"err {k['rel']:.2e} relative (limit {k['tol']}), "
           f"{'' if k['exact'] else 'not '}bit-identical to the plain version")
    print(f"phase 2 {key} ({k['what']}): kernel {k['ms']:.3f} ms (table "
          f"measure, {k['reps']}-call mean){vs}; bound {k['bound_ms']:.4f} ms "
          f"({k['bound_by']}: bytes {k['bytes_ms']:.4f} ms, operations "
          f"{k['ops_ms']:.4f} ms), {100 * k['bound_ms'] / k['ms']:.1f} % of "
          f"it; {label} {moved / k['ms'] / 1e6:.0f} GB/s; behind a spin "
          f"kernel (device only, not the table's measure) "
          f"{k['spin_ms']:.3f} ms, {100 * k['bound_ms'] / k['spin_ms']:.1f} % "
          f"of the bound; host {1e3 * k['host_ms']:.1f} us a call; blocks "
          f"per launch {span([s['blocks'] for s in shapes])} of "
          f"{values('threads')} threads"
          f"{f' (the more on groups {wide})' if wide else ''}, "
          f"{values('blocks_per_sm')} an SM x {shapes[0]['sms']} SMs: "
          f"{span(waves, '{:.2f}')} waves{first}, {values('smem_bytes')} B "
          f"dynamic shared memory; registers "
          f"{' / '.join(f'{regs[v]} ({v})' for v in variants)}, no spills; "
          f"{err}{k.get('note', '')}")


def k4_slots(table_dtype=torch.float32) -> int:
    """K4's fp64-pipe issue slots an entry of a table of ``table_dtype``."""
    return K4_FP64_PER_ENTRY + (
        0 if table_dtype == torch.float64 else K4_CVT_PER_ENTRY * CVT_SLOTS)


def k4_bound(n_entries: int, nbytes: int, table_dtype=torch.float32) -> dict:
    """K4's bound: the bytes term and the fp64 term (the fp64-pipe issue
    slots the kernel's loop takes an entry, at the pipe's instruction rate),
    in ms, and the larger of the two."""
    slots = k4_slots(table_dtype)
    b = bound(n_entries * slots, nbytes, FP64_INSTR)
    return dict(b, fp64_ms=b["ops_ms"], slots=slots)


def k4_input_bytes(groups, ndgnh: int) -> int:
    """The bytes K4's launch must read for ``groups`` [(m0, m1, i0, J), ...]:
    for each m, the J recurrence coefficients A and B its columns step
    through (fp64) and its seeds' mantissas (fp64) and exponents (int32) at
    the group's latitudes i0 ... ndgnh - 1; and the nodes mu from the first
    group latitude on (fp64)."""
    per_m = sum((m1 - m0) * (2 * 8 * J + (8 + 4) * (ndgnh - i0))
                for m0, m1, i0, J in groups)
    return per_m + 8 * (ndgnh - min(i0 for _, _, i0, _ in groups))


def hold_k4(res, dev: torch.device) -> dict:
    """K4 at TCO1279: every group in one launch, held against the plain fp64
    recurrence (1e-7 of the table scale; bit identity reported), on fp32
    tables and on the "bf16" tier's (which must be the fp32 table rounded to
    nearest even, bit for bit); times on the table measure (2-call means;
    plain: 1 call) and behind a spin kernel; its bound counts the tables
    written and the inputs read (``k4_input_bytes``) against the fp64-pipe
    slots of its loop."""
    from ectrans_tpu_torch.ops import legendre_tablegen as tg

    groups = res.legendre_groups()
    inp = tg._device_inputs(res, dev)
    f32, bf16 = torch.float32, torch.bfloat16
    n = sum((m1 - m0) * J * (res.ndgnh - i0) for m0, m1, i0, J in groups)
    in_bytes = k4_input_bytes(groups, res.ndgnh)
    k = hold("K4", lambda: tg.gen_groups(inp, groups, f32),
             lambda: [tg.gen_group_plain(inp, m0, m1, J, i0, f32)
                      for m0, m1, i0, J in groups],
             [()], tol=1e-7, flop=lambda: n * k4_slots(f32), rate=FP64_INSTR,
             nbytes=lambda args, got: tensor_bytes(got) + in_bytes, spin=True,
             reps=2, plain_reps=1)
    pns, bf = tg.gen_groups(inp, groups, f32), tg.gen_groups(inp, groups, bf16)
    check(all(torch.equal(b, p.to(bf16)) for b, p in zip(bf, pns)),
          "K4 bf16 tables are not the fp32 tables rounded to bf16")
    del pns, bf
    k["bf16_ms"] = cuda_ms(lambda: tg.gen_groups(inp, groups, bf16), reps=2)
    b16 = k4_bound(n, 2 * n + in_bytes, bf16)
    k.update(what=f"fp32 tables, {len(groups)} groups, one launch, {n:,} "
                  f"entries",
             shapes=[tg.gen_groups_shape(tg.launch_plan(groups, res.ndgnh)[1])],
             moved=("writes", 4 * n),
             note=f"; operations: {k4_slots(f32)} fp64-pipe slots an entry "
                  f"at {FP64_INSTR:.3g} a second; inputs read "
                  f"{in_bytes:,} B; bf16 tables {k['bf16_ms']:.3f} ms (bound "
                  f"{b16['bound_ms']:.4f} ms, {b16['bound_by']}), the fp32 "
                  f"tables rounded, bit for bit")
    return k


def hold_k3(res, dev: torch.device, gen: torch.Generator) -> dict:
    """K3 at TCO1279 with bench.py's 10 output fields (vor, div x2, 6
    scalars), all groups in one launch, bit-exact against the index gather;
    times on the table measure (3-call means) and behind a spin kernel; its
    bound counts each packed value read once and written once (the rows
    past an m's last degree are never read)."""
    from ectrans_tpu_torch.ops import pack

    nfld = 2 * NFLD_UV + NFLD_SC
    rows = [torch.randn(m1 - m0, 2 * nfld, J, generator=gen, device=dev)
            for m0, m1, i0, J in res.legendre_groups()]
    k = hold("K3", lambda r: pack.packed_from_group_rows(r, res),
             lambda r: pack.packed_from_group_rows_plain(r, res), [(rows,)],
             tol=0, nbytes=lambda args, got: 2 * tensor_bytes(got), spin=True,
             library=(lambda r: k3_library(r, res), torch.take))
    k.update(what=f"fp32, {nfld} fields, {len(rows)} groups, one launch, a "
                  f"warp a field row of an m",
             shapes=[pack.packed_from_group_rows_shape(nfld, res.nsmax)],
             moved=("moves", 2 * 4 * nfld * res.nspec2))
    return k


def k3_library(rows: list, res) -> tuple:
    """K3's one-call counterpart's operands: the groups' rows concatenated
    into one flat tensor, and the (nfld, nspec2) index of each packed
    value in it (both made before the timing), for one ``torch.take``."""
    from ectrans_tpu_torch.ops import pack

    nfld = rows[0].shape[1] // 2
    f = np.arange(nfld)[:, None]
    idx, off = [], 0
    for r, (m0, _, seg0, seg1) in zip(rows, pack.segments(res)):
        gm, nrow, J = r.shape
        sl = slice(seg0, seg1)
        m, c = res.packed_gather_m[sl], res.packed_gather_c[sl]
        j = res.packed_gather_n[sl] - m
        idx.append(off + ((m - m0) * nrow + c * nfld + f) * J + j)
        off += r.numel()
    flat = torch.cat([r.reshape(-1) for r in rows])
    return flat, torch.as_tensor(np.concatenate(idx, axis=1),
                                 device=flat.device)


def k6_split(shape: dict, gm: int, kg: int) -> int:
    """K6's latitude split in a launch of ``shape`` (group_dir_shape) for gm
    m and kg degrees at FC2_DIR rows: its blocks over the unsplit grid's."""
    return shape["blocks"] // (gm * -(-kg // 64) * -(-FC2_DIR // 20))


def grouped_note(key: str, out: dict) -> str:
    """The end of K5's or K6's phase-2 line: its bf16-table variant (table
    measure, bound share, table stream, device time behind a spin kernel,
    error) and, for K6, the latitude split a group."""
    k, b = out[key], out[key + " bf16"]
    label, moved = b["moved"]
    note = (f"; bf16 tables {b['ms']:.3f} ms (table measure), "
            f"{100 * b['bound_ms'] / b['ms']:.1f} % of its "
            f"{b['bound_ms']:.4f} ms bound, {label} "
            f"{moved / b['ms'] / 1e6:.0f} GB/s, behind a spin kernel "
            f"{b['spin_ms']:.3f} ms, err {b['rel']:.2e} relative")
    if key == "K6":
        note += "; latitude split per group " + ",".join(
            str(k6_split(s, gm, kg)) for s, (gm, kg) in
            zip(k["shapes"], k["groups"]))
    return note


def hold_grouped(res, dev: torch.device, tdt: torch.dtype, rnd) -> dict:
    """K5 and K6 against their plain versions on every group of the parity
    tables of table dtype ``tdt`` derived on the card, with the round trip's
    rows (random operands from ``rnd(*shape)``); on fp32 tables timed in
    turns with their one-call counterparts (k5_library, k6_library, their
    operands stacked before the timing); both variants also behind a spin
    kernel; each with its launch shapes per group.  Returns {"K5": ...,
    "K6": ...}, the keys ending in " bf16" on bf16 tables."""
    from ectrans_tpu_torch.ops import legendre_grouped as lg

    tag = " bf16" if tdt == torch.bfloat16 else ""
    bmm = torch.bmm if tdt == torch.float32 else None
    gl = res.grouped_legendre(tdt, dev)
    inv = [(rnd(g.m1 - g.m0, FC2_INV, g.kg), rnd(g.m1 - g.m0, FC2_INV, g.kg),
            g.psym, g.pasym) for g in gl.groups]
    out = {"K5" + tag: hold(
        "K5" + tag, lg.group_inv, lg.group_inv_plain, inv,
        flop=lambda s, a, ps, pa: 4 * s.numel() * ps.shape[1],
        library=bmm and (k5_library, bmm), spin=True)}
    del inv
    dirs = [(rnd(g.m1 - g.m0, FC2_DIR, g.psym.shape[1]),
             rnd(g.m1 - g.m0, FC2_DIR, g.psym.shape[1]), g.psym, g.pasym)
            for g in gl.groups]
    out["K6" + tag] = hold(
        "K6" + tag, lg.group_dir, lg.group_dir_plain, dirs,
        flop=lambda fs, fa, ps, pa: 4 * fs.numel() * ps.shape[2],
        library=bmm and (k6_library, bmm), spin=True)
    del dirs
    tables = tensor_bytes([(g.psym, g.pasym) for g in gl.groups])
    for key, rows, shape_of in (("K5", FC2_INV, lg.group_inv_shape),
                                ("K6", FC2_DIR, lg.group_dir_shape)):
        out[key + tag].update(
            what=f"{'bf16 tables' if tag else 'fp32'}, {len(gl.groups)} "
                 f"groups, rows {rows}",
            shapes=[shape_of(g.m1 - g.m0, rows, g.kg, g.psym.shape[1], tdt)
                    for g in gl.groups],
            groups=[(g.m1 - g.m0, g.kg) for g in gl.groups],
            moved=("table", tables))
    return out


def k5_library(s, a, ps, pa) -> tuple:
    """The operands of K5's one-call counterpart: the rows [sym, asym; sym,
    -asym] (gm, 2 fc2, 2 kg) and the tables [psym, pasym] (gm, 2 kg, ig),
    whose one torch.bmm is [north; south], at twice K5's FLOP."""
    return (torch.cat([torch.cat([s, a], 2), torch.cat([s, -a], 2)], 1),
            torch.cat([ps, pa], 2).transpose(1, 2))


def k6_library(fs, fa, ps, pa) -> tuple:
    """The operands of K6's one-call counterpart: [fsym; fasym] and [psym;
    pasym] stacked along the batch, whose one torch.bmm is [sym; asym]."""
    return torch.cat([fs, fa]), torch.cat([ps, pa])


def planes_tag(nplanes: int) -> str:
    """The key suffix of K9's and K10's holds: none at 3 planes."""
    return "" if nplanes == 3 else " (1 plane)"


def k9_bytes(args, got) -> int:
    """The bytes K9 must move: the planes' entries (views of the first J of
    their padded rows), the x_l half of the packed rows a (the sign rows
    are not read: south comes from the parity of j) and both outputs."""
    a, pt = args
    return tensor_bytes(pt, got) + tensor_bytes(a) // 2


def hold_planes(res, dev: torch.device, nplanes: int, rnd) -> dict:
    """K9 and K10 against their plain versions on every group of the
    ``nplanes`` limb planes derived on the card, with the round trip's rows
    (random operands from ``rnd(*shape)``, packed as the planes engine
    packs them), timed in turns with their yardsticks (k9_library,
    k10_library: one torch.bmm on fp32 operands whose limbs and planes were
    summed before the timing; ``yardstick_ms``, ``library_ms`` None: no one
    call computes their function) and behind a spin kernel; each with its
    launch shapes per group; K9's bound counts ``k9_bytes``.  Returns
    {"K9...": ..., "K10...": ...}, keys tagged by ``planes_tag``."""
    from ectrans_tpu_torch.ops import legendre_planes as lpl

    tag = planes_tag(nplanes)
    ppl = res.planes_legendre(nplanes, dev)
    inv = [(lpl._pack_inv_rows(rnd(g.m1 - g.m0, FC2_INV, g.J), nplanes), g.pt)
           for g in ppl.groups]
    out = {"K9" + tag: hold(
        "K9" + tag, lambda a, pt: lpl.group_inv_planes(a, pt, nplanes, FC2_INV),
        lambda a, pt: lpl.group_inv_planes_plain(a, pt, nplanes, FC2_INV),
        inv, flop=lambda a, pt: (2 * FC2_INV + nplanes - 1) * pt[0].numel(),
        library=(lambda a, pt: k9_library(a, pt, nplanes, FC2_INV),
                 torch.bmm), spin=True, nbytes=k9_bytes)}
    del inv
    dirs = [(lpl._pack_dir_rows(rnd(g.m1 - g.m0, FC2_DIR, g.pt[0].shape[1]),
                                rnd(g.m1 - g.m0, FC2_DIR, g.pt[0].shape[1]),
                                nplanes), g.pt) for g in ppl.groups]
    out["K10" + tag] = hold(
        "K10" + tag,
        lambda w, pt: lpl.group_dir_planes(w, pt, nplanes, FC2_DIR),
        lambda w, pt: lpl.group_dir_planes_plain(w, pt, nplanes, FC2_DIR),
        dirs, flop=lambda w, pt: (2 * FC2_DIR + nplanes - 1) * pt[0].numel(),
        library=(lambda w, pt: k10_library(w, pt, nplanes, FC2_DIR),
                 torch.bmm), spin=True)
    del dirs
    planes = tensor_bytes([g.pt for g in ppl.groups])
    for key, rows, shape_of in (("K9", FC2_INV, lpl.group_inv_planes_shape),
                                ("K10", FC2_DIR, lpl.group_dir_planes_shape)):
        k = out[key + tag]
        k["yardstick_ms"], k["library_ms"] = k["library_ms"], None
        k.update(
            what=f"{nplanes} plane{'s' if nplanes > 1 else ''}, "
                 f"{len(ppl.groups)} groups, rows {rows}",
            shapes=[shape_of(g.m1 - g.m0, rows, g.J, g.pt[0].shape[1],
                             nplanes) for g in ppl.groups],
            groups=[(g.m1 - g.m0, g.J) for g in ppl.groups],
            moved=("planes", planes))
    return out


def k9_library(a, pt, nplanes: int, fc2: int) -> tuple:
    """The operands of K9's yardstick: the limb-summed rows [x; x sgn] (gm,
    2 fc2, J) and the plane-summed table transposed (gm, J, ig), fp32, whose
    one torch.bmm is [north; south], at twice K9's FLOP."""
    from ectrans_tpu_torch.ops import legendre_planes as lpl

    x = lpl._limb_sum(a, nplanes, fc2, 0)
    return (torch.cat([x, x * lpl._jsgn(x.shape[-1], x)], 1),
            lpl._plane_sum(pt, nplanes).transpose(1, 2))


def k10_library(w, pt, nplanes: int, fc2: int) -> tuple:
    """The operands of K10's yardstick: the limb-summed rows [gn + gs;
    gn - gs] (gm, 2 fc2, ig) and the plane-summed table (gm, ig, J), fp32,
    whose one torch.bmm holds out's even columns in its first fc2 rows and
    its odd columns in the rest, at twice K10's FLOP."""
    from ectrans_tpu_torch.ops import legendre_planes as lpl

    gn = lpl._limb_sum(w, nplanes, fc2, 0)
    gs = lpl._limb_sum(w, nplanes, fc2, 1)
    return torch.cat([gn + gs, gn - gs], 1), lpl._plane_sum(pt, nplanes)


def planes_note(key: str, out: dict) -> str:
    """The end of K9's or K10's phase-2 line: its 1-plane numbers (table
    measure, against its yardstick, bound with its terms and share, device
    time behind a spin kernel, error) and, for K10, the latitude split a
    group."""
    k, b = out[key], out[key + planes_tag(1)]
    note = (f"; 1 plane {b['ms']:.3f} ms (table measure; yardstick "
            f"{b['yardstick_ms']:.3f} ms), "
            f"{100 * b['bound_ms'] / b['ms']:.1f} % of its "
            f"{b['bound_ms']:.4f} ms bound ({b['bound_by']}: bytes "
            f"{b['bytes_ms']:.4f} ms, operations {b['ops_ms']:.4f} ms), behind "
            f"a spin kernel {b['spin_ms']:.3f} ms, err {b['rel']:.2e} relative")
    if key == "K10":
        # K10's grid is K6's: ceil(J / 128) = ceil(kg / 64) blocks of degrees
        note += "; latitude split per group " + ",".join(
            str(k6_split(s, gm, J // 2)) for s, (gm, J) in
            zip(k["shapes"], k["groups"]))
    return note


def planes_padding_ab(res, dev: torch.device, rnd) -> dict:
    """The padding A/B of K9 and K10 at 3 planes: each group's kernel on the
    planes in rows padded to 8 entries (as planes_legendre stores them) and
    on contiguous copies of them, which the wrappers copy into padded rows
    on each call (aligned_planes), timed in turns (padded, contiguous,
    padded, contiguous; table measure), summed over the groups; the outputs
    must be bit-identical (the same kernel on the same values)."""
    from ectrans_tpu_torch.ops import legendre_planes as lpl

    ppl = res.planes_legendre(3, dev)
    sums = {k: 0.0 for k in ("K9 padded", "K9 contiguous", "K10 padded",
                             "K10 contiguous", "K9 rel", "K10 rel")}
    for g in ppl.groups:
        flat = tuple(p.contiguous() for p in g.pt)
        ig = g.pt[0].shape[1]
        for key, fn, x in (
                ("K9", lambda x, pt: lpl.group_inv_planes(x, pt, 3, FC2_INV),
                 lpl._pack_inv_rows(rnd(g.m1 - g.m0, FC2_INV, g.J), 3)),
                ("K10", lambda x, pt: lpl.group_dir_planes(x, pt, 3, FC2_DIR),
                 lpl._pack_dir_rows(rnd(g.m1 - g.m0, FC2_DIR, ig),
                                    rnd(g.m1 - g.m0, FC2_DIR, ig), 3))):
            d, scale, exact = compare(key, fn(x, g.pt), fn(x, flat))
            sums[key + " rel"] = max(sums[key + " rel"], d / scale)
            check(exact, f"{key}: padded and contiguous planes disagree, "
                         f"{d / scale} relative")
            turns = [cuda_ms(lambda pt=pt: fn(x, pt))
                     for pt in (g.pt, flat, g.pt, flat)]
            sums[key + " padded"] += (turns[0] + turns[2]) / 2
            sums[key + " contiguous"] += (turns[1] + turns[3]) / 2
        del flat
    return sums


def padding_report(ab: dict) -> None:
    """Phase 2's line of the K9 and K10 padding A/B (planes_padding_ab)."""
    print(f"phase 2 planes padding A/B (3 planes, table measure, in turns; "
          f"contiguous planes are copied into padded rows on each call): "
          f"K9 padded rows {ab['K9 padded']:.3f} ms vs contiguous "
          f"{ab['K9 contiguous']:.3f} ms; K10 padded {ab['K10 padded']:.3f} "
          f"ms vs contiguous {ab['K10 contiguous']:.3f} ms; outputs apart "
          f"by {ab['K9 rel']:.2e} / {ab['K10 rel']:.2e} relative")


def hold_streaming(x: torch.Tensor) -> dict:
    """K11 (bit-exact) and K12 (1e-6 relative, and bit-identical across two
    calls) on x against their plain versions, each timed in turns with its
    one PyTorch call (``x.clone()``, the reshape-sum) and behind a spin
    kernel, with its launch; K12's line adds its plan (slices, octets a
    slice, ring stages a block) and its second launch's registers, where a
    spill fails the run."""
    from ectrans_tpu_torch import roofline

    out = {"K11": hold("K11", roofline.stream_copy,
                       roofline.stream_copy_plain, [(x,)], tol=0,
                       library=lambda x: x.clone(), spin=True),
           "K12": hold("K12", roofline.read_reduce,
                       roofline.read_reduce_plain, [(x,)], tol=1e-6,
                       flop=lambda x: x.numel(),
                       library=lambda x: x.reshape(-1, roofline.OCTET,
                                                   x.shape[-1]).sum(0),
                       spin=True)}
    check(torch.equal(roofline.read_reduce(x), roofline.read_reduce(x)),
          "K12: two calls differ")
    what = f"fp32 {tuple(x.shape)}, {tensor_bytes(x) / 2**20:.0f} MiB"
    shape = roofline.read_reduce_shape(*x.shape)
    plan = roofline.reduce_plan(*x.shape, shape["sms"])
    stages = -(-plan["per"] // plan["ops"])
    final = registers("K12 final", K12_FINAL, 1)["fp32"]
    out["K11"].update(what=f"{what}, {roofline.COPY_CHUNK * 16} B a block",
                      shapes=[roofline.stream_copy_shape(x.numel())],
                      moved=("read + write", 2 * tensor_bytes(x)))
    out["K12"].update(
        what=what + ", a block an SM", shapes=[shape],
        moved=("reads", tensor_bytes(x)),
        note=f"; {plan['slices']} slices of {plan['per']} octets, {stages} "
             f"ring stages of {plan['ops']} octets a block; second launch (the partials in order) {final} "
             f"registers, no spills; bit-identical across two calls")
    return out


def phase_kernels(dev: torch.device) -> dict:
    """Each kernel against its plain version at the TCO1279 shapes."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import roofline
    from ectrans_tpu_torch.ops import legendre_dense as ld
    from ectrans_tpu_torch.ops import legendre_planes as lpl

    res = ett.setup("TCO1279")
    out = {}
    gen = torch.Generator(device=dev).manual_seed(0)

    out["K4"] = hold_k4(res, dev)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    # K1 (inverse: 16 fields -> fc2 32), K2 (direct: 10 fields -> fc2 20),
    # K7 and K8 on the hemispheres stacked as the dense engine stacks them
    # (2 x 32 and 2 x 20 rows), K5 and K6 on the parity tables derived from
    # pn on the card (hold_grouped); first on the fp32 tables, then on the
    # "bf16" tier's
    for tag, tdt in (("", torch.float32), (" bf16", torch.bfloat16)):
        fl = res.full_legendre(tdt, dev)
        # the redesigned kernels' fp32 lines also take the spin-timed measure
        spin = tdt == torch.float32
        out["K1" + tag] = hold(
            "K1" + tag, ld.group_inv_dense, ld.group_inv_dense_plain,
            [(rnd(g.m1 - g.m0, FC2_INV, g.J), g.pn) for g in fl.groups],
            flop=lambda d2, pn: 2 * d2.numel() * pn.shape[2], spin=spin)
        out["K2" + tag] = hold(
            "K2" + tag, ld.group_dir_dense, ld.group_dir_dense_plain,
            [(rnd(g.m1 - g.m0, FC2_DIR, g.pn.shape[2]),
              rnd(g.m1 - g.m0, FC2_DIR, g.pn.shape[2]), g.pn)
             for g in fl.groups],
            flop=lambda fn, fs, pn: 2 * fn.numel() * pn.shape[1], spin=spin)
        # the bf16-table variants have no one-call counterpart (torch.bmm
        # takes one dtype)
        bmm = torch.bmm if tdt == torch.float32 else None
        d2s = [rnd(g.m1 - g.m0, FC2_INV, g.J) for g in fl.groups]
        out["K7" + tag] = hold(
            "K7" + tag, ld.group_inv_dense2, ld.group_inv_dense2_plain,
            [(torch.cat([d2, d2 * ld._jsgn(g.J, d2)], dim=1), g.pn)
             for d2, g in zip(d2s, fl.groups)],
            flop=lambda d4, pn: 2 * d4.numel() * pn.shape[2], library=bmm,
            spin=spin)
        del d2s
        out["K8" + tag] = hold(
            "K8" + tag, ld.group_dir_dense2, ld.group_dir_dense2_plain,
            [(rnd(g.m1 - g.m0, 2 * FC2_DIR, g.pn.shape[2]), g.pn)
             for g in fl.groups],
            flop=lambda f4, pn: 2 * f4.numel() * pn.shape[1],
            library=bmm and (lambda f4, pn: torch.bmm(f4, pn.transpose(1, 2))),
            spin=spin)
        if tdt == torch.float32:
            for key, (shape_of, rows, axis) in DENSE_SHAPES.items():
                out[key].update(
                    what=f"fp32, {len(fl.groups)} groups, rows {rows}",
                    shapes=[getattr(ld, shape_of)(g.m1 - g.m0, rows,
                                                  g.pn.shape[axis])
                            for g in fl.groups],
                    moved=("table", tensor_bytes([g.pn for g in fl.groups])))
        out.update(hold_grouped(res, dev, tdt, rnd))
        res.drop_cached("grouped_legendre")
    del fl
    res.drop_cached("full_legendre")

    # K9 and K10 on the planes derived on the card, operands packed as the
    # planes engine packs them; 3 planes ("highest") and 1 plane ("bf16"),
    # then the padding A/B
    for nplanes in (3, 1):
        out.update(hold_planes(res, dev, nplanes, rnd))
        res.drop_cached("planes_legendre")
    padding = planes_padding_ab(res, dev, rnd)
    res.drop_cached("planes_legendre")

    out["K3"] = hold_k3(res, dev, gen)

    # K11 and K12 at the roofline probe's 512 MiB shape
    x = rnd(roofline.N_ROWS, roofline.N_COLS)
    out.update(hold_streaming(x))
    del x
    for key in ("K5", "K6"):
        out[key]["note"] = grouped_note(key, out)
    for key in ("K9", "K10"):
        out[key]["note"] = planes_note(key, out)
    for key in REDESIGNED:
        redesign_report(key, out)
    padding_report(padding)
    print("phase 2 kernels vs plain (TCO1279 shapes): " + "; ".join(
        f"{k} err {v['max_abs_err']:.3e} ({v['tol']}) {v['ms']:.3f} ms vs "
        f"plain {v['plain_ms']:.3f} ms"
        for k, v in sorted(out.items(),
                           key=lambda kv: int(kv[0][1:].split()[0]))))
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
          precision="highest", reset=True, absent=(), once=()):
    """One round trip through an engine's main path with every launch
    counter set to 0 just before (unless the caller did) and read just
    after; each kernel in ``need`` must have been launched, exactly once
    for those in ``once`` (K3: one launch a direct transform; K4: one a
    table build), and none in ``absent``.  Returns (grid, spectra,
    seconds, launches)."""
    if reset:
        for c in counters.values():
            c.launches = 0
    t0 = time.perf_counter()
    grid, out = round_trip(res, sp, torch.float32, engine, precision)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = {k: counters[k].launches for k in need + absent}
    check(all(launches[k] > 0 for k in need) and
          all(launches[k] == 1 for k in once) and
          not any(launches[k] for k in absent),
          f"the {engine} path launched {launches}; expected {need} (once: "
          f"{once}) and not {absent}")
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
    # the counts were set to 0 before the setup, whose tables K4 makes in
    # one launch; K3 packs the direct transform in one
    grid, out, t_first, launches = drive(res, sp, counters,
                                         ("K1", "K2", "K3", "K4"),
                                         reset=False, once=("K3", "K4"))
    # phase 8 holds the handle's outputs to these, kept on the host
    outputs = (grid.cpu(), [x.cpu() for x in out])
    del grid

    eps32 = float(np.finfo(np.float32).eps)
    err, gate = max(((e, 100 * eps32 * m) for e, m in family_errors(out, sp)),
                    key=lambda x: x[0] / x[1])
    check(err <= DENSE_GATE_SHARE * gate,
          f"round-trip gate: err {err:.4e} is {err / gate:.3f} of "
          f"100*eps*max {gate:.4e}, over the {DENSE_GATE_SHARE} allowed")
    med, lo, hi = median_ms(res, sp, 5)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 4 TCO1279 bench round trip (dense): err {err:.4e} gate "
          f"{gate:.4e}, {err / gate:.3f} of it (at most {DENSE_GATE_SHARE}); "
          f"setup {t_setup:.2f} s (tables on the card); first "
          f"round trip {t_first:.3f} s; median {med:.1f} ms (min {lo:.1f}, "
          f"max {hi:.1f}, n 5); peak {peak:.2f} GiB; launches {launches}; "
          f"cuFFT plans cached {torch.backends.cuda.cufft_plan_cache[dev.index].size}")
    return res, sp, launches, dict(ratio=err / gate, median=med,
                                   launches=dict(launches), outputs=outputs)


# phase 5 rows: engine, tier, environment, kernels that must run, kernels
# that must not, kernels that must run exactly once (K3 a direct
# transform; K4 the "dense" bf16 row's full_legendre build; the "pallas"
# bf16 row derives its tables one group at a time, a K4 launch each); a
# "bf16" row of "dense" or "pallas" drops every full-n table first, so that
# the peak shows its own
# the largest share of the 100*eps gate an engine's fp32 row may take in
# phase 5, and the kernels that its rows launch once per m-group each
GATE_SHARES = {"pallas": PALLAS_GATE_SHARE, "planes": PLANES_GATE_SHARE,
               "xla": 1.0}
# the kernels of the Legendre engines, none of which the "xla" engine runs
LEGENDRE_KERNELS = ("K1", "K2", "K5", "K6", "K7", "K8", "K9", "K10")
GROUP_KERNELS = {"pallas": ("K5", "K6"), "planes": ("K9", "K10")}
ENGINE_ROWS = (
    ("xla", "highest", {}, (), LEGENDRE_KERNELS + ("K3",), ()),
    ("pallas", "highest", {}, ("K3", "K5", "K6"), ("K1", "K2"), ("K3",)),
    ("planes", "highest", {}, ("K3", "K9", "K10"), (), ("K3",)),
    ("planes", "bf16", {}, ("K3", "K9", "K10"), (), ("K3",)),
    ("dense", "highest", {"ECTRANS_TPU_LEG_DENSE_PACK": "1"},
     ("K3", "K7", "K8"), ("K1", "K2"), ("K3",)),
    ("dense", "highest", {"ECTRANS_TPU_PACK_KERNEL": "xla"}, ("K1", "K2"),
     ("K3",), ()),
    ("dense", "bf16", {}, ("K1", "K2", "K3", "K4"), (), ("K3", "K4")),
    ("pallas", "bf16", {}, ("K3", "K5", "K6"), ("K1", "K2"), ("K3",)),
)


def phase_engines(dev: torch.device, res, sp, counters: dict,
                  launches: dict) -> dict:
    """Phase 4's round trip through the other engines, tiers and knobs;
    each kernel's count in ``launches`` comes from the first path that runs
    it (phase 4 for K1-K4).  Returns the DENSE_PACK row's gate ratio, median
    and launches."""
    eps32 = float(np.finfo(np.float32).eps)
    for engine, precision, env, need, absent, once in ENGINE_ROWS:
        if precision == "bf16" and engine != "planes":
            res.drop_cached("full_legendre")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with environ(**env):
            grid, out, t_first, got = drive(res, sp, counters, need, engine,
                                            precision, absent=absent,
                                            once=once)
            del grid
            med, lo, hi = median_ms(res, sp, 3, engine, precision)
        peak = torch.cuda.max_memory_allocated() / 2**30
        errs = family_errors(out, sp)
        if precision == "highest":
            err, gate = max(((e, 100 * eps32 * m) for e, m in errs),
                            key=lambda x: x[0] / x[1])
            check(err <= gate, f"{engine} {env} round-trip gate: err "
                               f"{err:.4e} > 100*eps*max {gate:.4e}")
            verdict = f"err {err:.4e} gate (100 eps) {gate:.4e}"
            share = GATE_SHARES.get(engine)
            if share is not None:
                check(err <= share * gate,
                      f"{engine} round-trip gate: err {err:.4e} is "
                      f"{err / gate:.3f} of 100*eps*max {gate:.4e}, over "
                      f"the {share} allowed")
                verdict += f", {err / gate:.3f} of it (at most {share})"
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
        if engine in GROUP_KERNELS:
            ngroups = len(res.legendre_groups())
            a, b = GROUP_KERNELS[engine]
            check(got[a] == got[b] == ngroups,
                  f"{engine} launched {a} {got[a]} and {b} {got[b]} times, "
                  f"expected {ngroups} each")
        if "ECTRANS_TPU_LEG_DENSE_PACK" in env:
            ngroups = len(res.legendre_groups())
            check(got["K7"] == got["K8"] == ngroups,
                  f"DENSE_PACK launched K7 {got['K7']} and K8 {got['K8']} "
                  f"times, expected {ngroups} each")
            packed = dict(ratio=err / gate, median=med, launches=got)
        for k in need:
            launches.setdefault(k, got[k])
        knobs = "".join(f" {k}={v}" for k, v in env.items())
        print(f"phase 5 TCO1279 bench round trip ({engine}, {precision}"
              f"{knobs}): {verdict}; first call {t_first:.3f} s; median "
              f"{med:.1f} ms (min {lo:.1f}, max {hi:.1f}, n 3); peak "
              f"{peak:.2f} GiB; launches {got}; cuFFT plans cached "
              f"{torch.backends.cuda.cufft_plan_cache[dev.index].size}")
        res.drop_cached("grouped_legendre")
        res.drop_cached("planes_legendre")
    res.drop_cached("full_legendre")
    return packed


def ab_report(kern: dict, dense: dict, packed: dict) -> None:
    """The DENSE_PACK A/B: the packed Legendre kernels K7 + K8 against the
    default K1 + K2 at the bench shapes (phase 2, same call), and the two
    round trips (phases 4 and 5)."""
    default = kern["K1"]["ms"] + kern["K2"]["ms"]
    pack2 = kern["K7"]["ms"] + kern["K8"]["ms"]
    print(f"DENSE_PACK A/B (TCO1279): Legendre kernels K7 + K8 "
          f"{pack2:.3f} ms vs K1 + K2 {default:.3f} ms ({pack2 - default:+.3f}"
          f" ms a round trip); round trip with DENSE_PACK=1: "
          f"{packed['ratio']:.3f} of the 100 eps gate, median "
          f"{packed['median']:.1f} ms, launches {packed['launches']}; "
          f"default: {dense['ratio']:.3f} of the gate, median "
          f"{dense['median']:.1f} ms, launches {dense['launches']}")


def phase_tco639(dev: torch.device, counters: dict) -> None:
    """bench.py's second configuration, TCO639 (O640 grid), through the
    default "dense" fp32 path on inputs made as phase 4's (seed 0): the
    100*eps gate on every family (at most 1.0 of it), setup time (tables on
    the card), first call (its own cuFFT plans: a length per NLOEN), median
    of 3, and K1-K4's launches (K3 and K4 once)."""
    import ectrans_tpu_torch as ett

    gc.collect()
    torch.cuda.empty_cache()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = ett.setup("TCO639")
    res.full_legendre(torch.float32, dev)
    res.device_tables(torch.float32, dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    sp = [x.to(dev) for x in bench_inputs(res.nspec2, res.nsmax)]
    torch.cuda.reset_peak_memory_stats()
    grid, out, t_first, launches = drive(res, sp, counters,
                                         ("K1", "K2", "K3", "K4"),
                                         reset=False, once=("K3", "K4"))
    del grid
    eps32 = float(np.finfo(np.float32).eps)
    err, gate = max(((e, 100 * eps32 * m) for e, m in family_errors(out, sp)),
                    key=lambda x: x[0] / x[1])
    check(err <= gate, f"TCO639 round-trip gate: err {err:.4e} > 100*eps*max "
                       f"{gate:.4e}")
    med, lo, hi = median_ms(res, sp, 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"phase 7 TCO639 bench round trip (dense, O640 grid, nsmax "
          f"{res.nsmax}, nspec2 {res.nspec2:,}): err {err:.4e} gate "
          f"{gate:.4e}, {err / gate:.3f} of it (at most 1.0); setup "
          f"{t_setup:.2f} s (tables on the card); first round trip "
          f"{t_first:.3f} s; median {med:.1f} ms (min {lo:.1f}, max "
          f"{hi:.1f}, n 3); peak {peak:.2f} GiB; launches {launches}; cuFFT "
          f"plans cached "
          f"{torch.backends.cuda.cufft_plan_cache[dev.index].size}")
    res.drop_cached("full_legendre")


# phase 8: the handle's adjoint identity must hold within 2000 fp32 eps
# (tests/trans/test_adjoint.F90), its packets within the fp32 tolerance of
# the single call, and its norms within 1e-6 of the CPU's fp64 ones
ADJOINT_TOL = 2000 * float(np.finfo(np.float32).eps)
PACKET_TOL = (2e-5, 1e-5)
NORM_TOL = 1e-6
NPROMATR = 4
# cuFFT plans cached: a round trip's field counts take 2 x 1,280 at
# TCO1279, and phase 8's packets and adjoints four more field counts
CUFFT_PLANS = 16384


def inner(a, b) -> float:
    """Inner product in fp64 of two tensors, or of two lists of them."""
    if isinstance(a, (tuple, list)):
        return sum(inner(x, y) for x, y in zip(a, b))
    return float((a.double() * b.double()).sum())


def adjoint_identity(fx, y, x, fty) -> float:
    """|<F x, y> - <x, F^T y>| / |<F x, y>|, the inner products in fp64."""
    lhs = inner(fx, y)
    return abs(lhs - inner(x, fty)) / abs(lhs)


def packet_share(got, want) -> float:
    """The worst difference of packets' outputs from the single call's, as
    a share of the fp32 tolerance (2e-5 abs + 1e-5 of each output's max):
    the grid, then the spectra."""
    atol, rtol = PACKET_TOL
    return max((g - w).abs().max().item()
               / (atol + rtol * w.abs().max().item())
               for g, w in zip(got, want))


def gate_share(out, sp) -> float:
    """The round trip's worst family error as a share of the 100*eps
    gate."""
    eps32 = float(np.finfo(np.float32).eps)
    return max(e / (100 * eps32 * m) for e, m in family_errors(out, sp))


def handle_round_trip(st, sp, npromatr=None):
    """The bench round trip through a SpectralTransform handle."""
    grid = st.inv_trans(*sp, npromatr=npromatr, scders=True, uvders=True)
    u = grid[:NFLD_UV]
    v = grid[NFLD_UV : 2 * NFLD_UV]
    sc = grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]
    return grid, st.dir_trans(u, v, sc, npromatr=npromatr)


def cotangents(res, nout: int, dev: torch.device, seed: int = 12):
    """Random cotangents from a seeded generator: a grid of nout fields and
    spectra of the bench's families (m = 0 imaginary parts zero)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y_grid = torch.randn(nout, res.ndgl, res.grid.ndlon, generator=gen,
                         device=dev)
    y_spec = []
    for n in (NFLD_UV, NFLD_UV, NFLD_SC):
        y = torch.randn(n, res.nspec2, generator=gen, device=dev)
        y[:, 1 : 2 * (res.nsmax + 1) : 2] = 0.0
        y_spec.append(y)
    return y_grid, y_spec


def bench_fields(grid):
    """u, v and the scalars of the bench's inverse output."""
    return [grid[:NFLD_UV], grid[NFLD_UV : 2 * NFLD_UV],
            grid[2 * NFLD_UV : 2 * NFLD_UV + NFLD_SC]]


def handle_identities(sp, x_grid, fx_grid, fx_out, y_grid, y_spec, inv_ad,
                      dir_ad) -> tuple:
    """The adjoint identities of inv_trans_adj (x the bench spectra sp, F x
    the grid fx_grid) and dir_trans_adj (x the grid fields x_grid, F x the
    spectra fx_out), against the cotangents y_grid and y_spec."""
    return (adjoint_identity(fx_grid, y_grid, list(sp), inv_ad),
            adjoint_identity(list(fx_out), y_spec, x_grid, dir_ad))


def first_call(fn):
    """(result, seconds) of one call of fn() on the card, with the peak
    memory counted from it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    return result, time.perf_counter() - t0


def median_peak(fn, n: int = 3) -> tuple:
    """(median ms of n calls of fn(), peak GiB since the last reset)."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return (statistics.median(times) * 1e3,
            torch.cuda.max_memory_allocated() / 2**30)


def phase_handle(dev: torch.device, res, sp, outputs, counters: dict,
                 name: str = "TCO1279") -> dict:
    """Phase 8: ``SpectralTransform(name)`` on the default device, on phase
    4's inputs and Resolution: (a) its round trip against phase 4's outputs;
    (b) NPROMATR packets; (c) the adjoint identity in fp32 with the forward
    on "xla" and on the default "dense", no kernel inside an adjoint; (d)
    the norms against the CPU's fp64; (e) trans_end frees the tables.
    Returns the launches of K1-K4 in (a) and (b)."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import norms

    t_phase = time.perf_counter()
    torch.backends.cuda.cufft_plan_cache[dev.index].max_size = CUFFT_PLANS
    gc.collect()
    torch.cuda.empty_cache()
    keys = ("K1", "K2", "K3", "K4")
    ngroups = len(res.legendre_groups())

    # (a) the handle's round trip against phase 4's
    for c in counters.values():
        c.launches = 0
    st = ett.SpectralTransform(name)
    check(st.device.type == "cuda" and st.res is res,
          "the handle is not on the card or did not get phase 4's "
          "Resolution from the setup cache")
    (grid, out), first = first_call(lambda: handle_round_trip(st, sp))
    single = {k: counters[k].launches for k in keys}
    check(single["K1"] == single["K2"] == ngroups and single["K3"] == 1,
          f"the handle launched {single}; expected K1 and K2 {ngroups} "
          "times, K3 once")
    ref_grid, ref_out = outputs
    got_host = [grid.cpu()] + [x.cpu() for x in out]
    want_host = [ref_grid] + list(ref_out)
    diff = max((a - b).abs().max().item() for a, b in zip(got_host,
                                                          want_host))
    same = all(torch.equal(a, b) for a, b in zip(got_host, want_host))
    share = packet_share(got_host, want_host)
    check(share <= 1.0, f"the handle's outputs differ from phase 4's by "
                        f"{diff:.3e} ({share:.3f} of the fp32 tolerance)")
    del got_host, want_host
    ratio = gate_share(out, sp)
    check(ratio <= DENSE_GATE_SHARE,
          f"handle round trip at {ratio:.3f} of the 100*eps gate")
    med, peak = median_peak(lambda: handle_round_trip(st, sp))
    print(f"phase 8a TCO1279 SpectralTransform({name!r}) on "
          f"{st.device}, phase 4's Resolution: round trip vs phase 4 max "
          f"diff {diff:.3e}, bit-identical {same}; {ratio:.3f} of the 100 "
          f"eps gate (at most {DENSE_GATE_SHARE}); first call {first:.3f} s "
          f"(K4 tables made again); median {med:.1f} ms (n 3); peak "
          f"{peak:.2f} GiB; launches {single}")

    # (b) NPROMATR packets: 1 uv packet of 2 pairs, 2 scalar packets of 4
    # (the second padded with 2 zero fields), each way
    for c in counters.values():
        c.launches = 0
    (pgrid, pout), pfirst = first_call(
        lambda: handle_round_trip(st, sp, NPROMATR))
    packets = {k: counters[k].launches for k in keys}
    npk = -(-NFLD_UV // (NPROMATR // 2)) + -(-NFLD_SC // NPROMATR)
    check(packets["K1"] == packets["K2"] == ngroups * npk
          and packets["K3"] == npk,
          f"packets launched {packets}; expected K1 and K2 {ngroups} a "
          f"packet ({npk} packets each way), K3 once a direct packet")
    pshare = packet_share([pgrid] + list(pout), [grid] + list(out))
    psame = all(torch.equal(a, b) for a, b in zip([pgrid, *pout],
                                                  [grid, *out]))
    check(pshare <= 1.0, f"packets differ from the single call: "
                         f"{pshare:.3f} of the fp32 tolerance")
    pratio = gate_share(pout, sp)
    check(pratio <= DENSE_GATE_SHARE,
          f"packet round trip at {pratio:.3f} of the 100*eps gate")
    del pgrid, pout
    pmed, ppeak = median_peak(lambda: handle_round_trip(st, sp, NPROMATR))
    print(f"phase 8b packets (npromatr {NPROMATR}: {npk} packets each way): "
          f"{pshare:.3e} of the fp32 tolerance from the single call, "
          f"bit-identical {psame}; "
          f"{pratio:.3f} of the 100 eps gate; first call {pfirst:.3f} s "
          f"(cuFFT plans of their field counts); median {pmed:.1f} ms vs "
          f"the single call's {med:.1f} ms; peak {ppeak:.2f} GiB vs "
          f"{peak:.2f} GiB; launches {packets}")

    # (c) the adjoint identity in fp32 on the bench fields
    flags = ett.InvFlags(scders=True, uvders=True)
    y_grid, y_spec = cotangents(res, grid.shape[0], dev)
    adj = {}
    for label, fn in (
            ("inv_trans_adj", lambda: st.inv_trans_adj(
                y_grid, NFLD_UV, NFLD_SC, flags=flags)),
            ("dir_trans_adj", lambda: st.dir_trans_adj(
                *y_spec, nfld_uv=NFLD_UV, nfld_sc=NFLD_SC))):
        for c in counters.values():
            c.launches = 0
        result, t_first = first_call(fn)
        ran = {k: c.launches for k, c in counters.items() if c.launches}
        check(not ran, f"{label} launched kernels: {ran}")
        adj[label] = (result, t_first) + median_peak(fn)
    inv_ad, dir_ad = adj["inv_trans_adj"][0], adj["dir_trans_adj"][0]
    # x: the bench spectra and the bench grid's fields; F x on "xla", and
    # on the default "dense" engine from (a)
    x_grid = bench_fields(grid)
    xgrid = ett.inv_trans(res, *sp, flags=flags, _engine="xla")
    xout = ett.dir_trans(res, *x_grid, _engine="xla")
    ids = {eng: handle_identities(sp, x_grid, fg, fo, y_grid, y_spec, inv_ad,
                                  dir_ad)
           for eng, fg, fo in (("xla", xgrid, xout), ("dense", grid, out))}
    del xgrid, xout
    for eng, (r_inv, r_dir) in ids.items():
        check(r_inv <= ADJOINT_TOL and r_dir <= ADJOINT_TOL,
              f"adjoint identity with the {eng} forward: inverse {r_inv:.3e}"
              f", direct {r_dir:.3e}, over 2000 eps {ADJOINT_TOL:.3e}")
    print("phase 8c adjoint identity, fp32, bench fields (2000 eps = "
          f"{ADJOINT_TOL:.3e}): " + "; ".join(
              f"{eng} forward: inverse {r[0]:.3e} ({r[0] / ADJOINT_TOL:.4f} "
              f"of it), direct {r[1]:.3e} ({r[1] / ADJOINT_TOL:.4f})"
              for eng, r in ids.items()) + "; " + "; ".join(
              f"{k} first call {v[1]:.3f} s, median {v[2]:.1f} ms (n 3), "
              f"peak {v[3]:.2f} GiB" for k, v in adj.items())
          + "; no kernel launched inside an adjoint")
    del adj, inv_ad, dir_ad, y_grid, y_spec, x_grid

    # (d) norms on the card (fp32) against the CPU's fp64
    spec = torch.cat(list(sp))
    sn = st.specnorm(spec).cpu().double()
    sn64 = norms.specnorm(res, spec.cpu().double())
    sn_rel = ((sn - sn64).abs() / sn64).max().item()
    ave, gmin, gmax = (x.cpu().double() for x in st.gpnorm(grid))
    g64 = grid.cpu().double()
    ave64, min64, max64 = norms.gpnorm(res, g64)
    # an average of 0 (a field without the (0, 0) mode) has no relative
    # error: the average's error is taken against the field's mean |value|
    scale = norms.gpnorm(res, g64.abs(), ave_only=True)[0]
    del g64
    ave_rel = ((ave - ave64).abs() / scale).max().item()
    exact = torch.equal(gmin, min64) and torch.equal(gmax, max64)
    check(sn_rel <= NORM_TOL and ave_rel <= NORM_TOL and exact,
          f"norms on the card vs the CPU fp64: specnorm {sn_rel:.3e}, "
          f"gpnorm average {ave_rel:.3e}, min/max exact {exact}")
    print(f"phase 8d norms, card fp32 vs CPU fp64: specnorm {sn_rel:.3e} "
          f"relative, gpnorm average {ave_rel:.3e} of each field's mean "
          f"|value| (at most {NORM_TOL:g}), min and max exact {exact}")
    del grid, out, spec

    # (e) trans_end frees the tables
    tables = [k for k in res._cache if k[0] in (
        "full_legendre", "grouped_legendre", "planes_legendre")]
    table_bytes = sum(tensor_bytes([g.pn] if hasattr(g, "pn") else
                                   [g.psym, g.pasym])
                      for k in tables for g in res._cache[k].groups)
    gc.collect()
    before = torch.cuda.memory_allocated()
    ett.trans_end()
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated()
    check(not res._cache and before - after >= table_bytes,
          f"trans_end freed {(before - after) / 2**30:.2f} GiB of the "
          f"tables' {table_bytes / 2**30:.2f} GiB")
    print(f"phase 8e trans_end: allocated {before / 2**30:.2f} GiB before, "
          f"{after / 2**30:.2f} GiB after (with empty_cache); tables "
          f"{[k[:2] for k in tables]} {table_bytes / 2**30:.2f} GiB freed; "
          f"cuFFT plans cached "
          f"{torch.backends.cuda.cufft_plan_cache[dev.index].size}")
    print(f"phase 8 done in {time.perf_counter() - t_phase:.1f} s")
    return {k: single[k] + packets[k] for k in keys}


def phase_roofline(dev: torch.device, counters: dict) -> dict:
    """The roofline probes, with K11 and K12 counted."""
    from ectrans_tpu_torch import roofline

    gc.collect()
    torch.cuda.empty_cache()
    for c in counters.values():
        c.launches = 0
    print("phase 6 roofline probes (ectrans_tpu_torch.roofline):")
    roofline.run(dev)
    launches = {k: counters[k].launches for k in ("K11", "K12")}
    check(all(n > 0 for n in launches.values()),
          f"a roofline kernel was not launched: {launches}")
    return launches


# phases 9 and 10: the lat-lon output at TCO1279 onto the 0.25 degree grid
# with poles (ECMWF's open-data grid), and the LAM at the 1.3 km domain
# (BASELINE.md:287); every gate relative to each field's largest |value|
EPS32 = float(np.finfo(np.float32).eps)
LATLON_GATE = 100 * EPS32
LATLON = (721, 1440)
LATLON_TRUNC = 319           # (c)'s interpolation-limited round trip
# (b)'s fp64 lat-lon output against the host's direct sums, of each field's
# largest |value|: ~4.5e5 fp64 eps, room for two different fp64 Legendre
# recurrences over 1,280 degrees (K4's and the host's) and sums of ~1,300
# terms in two orders; a wrong or unwritten element shows far above it
LATLON_FP64_TOL = 1e-10
# and the card's fp64 lat-lon tables at those rows' nodes against the host's
# recurrence, of the tables' largest |value|: both fp64 recurrences are
# ~5e-12 from a long-double one next to the poles (tests/test_torch_legendre)
LATLON_TABLE_TOL = 1e-11
LAM_DOMAIN = dict(nx=1536, ny=1280, nxux=1440, nyux=1200, dx=1300.0,
                  dy=1300.0)
LAM_NUV, LAM_NSC = 10, 10
LAM_MODE = (300, 200)        # (m, n) of check (b), inside the ellipse
LAM_MODE_TOL = 1e-10


def field_shares(got, want, gate: float, scale=None) -> list:
    """Per field (the leading axis): max |got - want| over the field as a
    share of gate times the field's largest |value| (of ``scale`` where it
    is given, else of want)."""
    ref = want if scale is None else scale
    d = (got.double() - want.double()).flatten(1).abs().amax(1)
    m = ref.double().flatten(1).abs().amax(1)
    return (d / (gate * m.clamp(min=torch.finfo(torch.float64).tiny))
            ).tolist()


def sample_rows(nlat: int) -> list:
    """Lat-lon rows for the direct evaluation: both poles and their
    neighbours, the equator (and its neighbours), and rows between."""
    return sorted({0, 1, nlat // 8, nlat // 4, nlat // 2 - 1, nlat // 2,
                   nlat // 2 + 1, 3 * nlat // 4, nlat - 2, nlat - 1})


def latlon_direct(res, ll, sp, flags, rows) -> torch.Tensor:
    """inv_trans_latlon's fields at the lat-lon ``rows`` in fp64 on the
    host by direct sums, with no FFT and no folding: the dense spectra
    (VDTUV, SPNSDE), P̄_n^m at the rows (``compute_legendre_table``) summed
    over n, 1/(a cos) and the E-W derivative, then explicit cos/sin sums
    over every longitude.  Returns (nout, len(rows), nlon)."""
    from ectrans_tpu_torch.legendre import compute_legendre_table
    from ectrans_tpu_torch.ops import layout, spectral

    t = res.device_tables(torch.float64, "cpu")
    spvor, spdiv, spsc = (x.detach().cpu().double() for x in sp)
    dvor = layout.packed_to_dense(spvor, t)
    ddiv = layout.packed_to_dense(spdiv, t)
    du, dv = spectral.vordiv_to_uv(dvor, ddiv, t.vd)
    dsc = layout.packed_to_dense(spsc, t)
    mu = ll.mu[rows]
    P = torch.from_numpy(compute_legendre_table(res.nsmax, mu, 1))

    def four(d):                               # (f, 2, M, rows)
        return torch.einsum("fcmn,mnr->fcmr", d, P)

    cos = np.sqrt(np.maximum(0.0, 1.0 - mu * mu))
    rc = np.where(cos > 0, 1.0 / np.where(cos > 0, cos, 1.0), 0.0)
    if ll.include_poles:
        rc[[i for i, r in enumerate(rows) if r in (0, ll.nlat - 1)]] = 0.0
    rc = torch.from_numpy(rc / res.radius)
    m = torch.arange(res.M, dtype=torch.float64)[None, :, None]

    def ew(f):
        return torch.stack([-f[:, 1] * m, f[:, 0] * m], 1) * rc

    uv = torch.cat([four(du), four(dv)]) * rc
    sc = four(dsc)
    groups = ([four(dvor)] if flags.vorgp else []) + (
        [four(ddiv)] if flags.divgp else []) + [uv, sc]
    if flags.scders:
        groups.append(four(spectral.ns_derivative(dsc, t.nsd)) * rc)
    if flags.uvders:
        groups.append(ew(uv))
    if flags.scders:
        groups.append(ew(sc))
    F = torch.cat(groups)                          # (nout, 2, M, rows)
    # cos/sin of 2 pi m j / nlon, the phase reduced exactly mod nlon
    mj = np.outer(np.arange(res.M), np.arange(ll.nlon)) % ll.nlon
    ph = torch.from_numpy(2 * np.pi * mj / ll.nlon)
    w = torch.full((res.M,), 2.0, dtype=torch.float64)
    w[0] = 1.0
    re = F[:, 0] * w[None, :, None]
    im = F[:, 1] * w[None, :, None]
    im[:, 0] = 0.0
    return (torch.einsum("fmr,mj->frj", re, torch.cos(ph))
            - torch.einsum("fmr,mj->frj", im, torch.sin(ph)))


def latlon_identity(res, ll, sp, flags, y) -> float:
    """The adjoint identity of inv_trans_latlon in fp32 by autograd: x the
    spectra sp, F x the lat-lon fields, F^T y the vector-Jacobian product
    with the cotangent y."""
    import ectrans_tpu_torch as ett

    xs = [x.detach().clone().requires_grad_(True) for x in sp]
    with torch.enable_grad():
        fx = ett.inv_trans_latlon(res, ll, *xs, flags=flags)
        fty = torch.autograd.grad(fx, xs, y)
    return adjoint_identity(fx.detach(), y, [x.detach() for x in xs],
                            list(fty))


def truncate(spec: torch.Tensor, res, nmax: int) -> torch.Tensor:
    """spec with every coefficient of degree n > nmax set to 0."""
    keep = torch.as_tensor(res.packed_gather_n <= nmax, device=spec.device)
    return spec * keep


def truncated_errors(back, spec, res, nmax: int) -> tuple:
    """The round trip of spectra truncated at n <= nmax: the largest error
    on the coefficients n <= nmax and the largest coefficient above it (the
    lat-lon analysis's periodic continuation past nlon / 2 aliases low
    zonal modes onto m >= nlon / 2), both relative to the largest
    |input|."""
    low = torch.as_tensor(res.packed_gather_n <= nmax, device=spec.device)
    scale = spec.abs().max()
    return (((back - spec).abs() * low).max() / scale).item(), (
        (back.abs() * ~low).max() / scale).item()


def fill_free_memory(dev: torch.device, share: float = 0.5) -> None:
    """Fill ``share`` of the card's free memory with all bits set (NaN in
    fp32 and fp64) and hand it back to the caching allocator, whose next
    blocks come from it: a kernel or a wrapper that reads an element it
    never wrote then reads NaN."""
    x = torch.empty(int(torch.cuda.mem_get_info(dev)[0] * share),
                    dtype=torch.uint8, device=dev)
    x.fill_(255)
    del x


def latlon_fp64_checks(res, ll, st64, sp, flags, grid64, want, rows,
                       dev: torch.device) -> dict:
    """Phase 9(b)'s fp64 reading held still (ROADMAP C1): the host's direct
    sums ``want`` again, bit for bit; the fp64 lat-lon tables built anew by
    K4 and a second fp64 call, both in memory filled with NaN first
    (``fill_free_memory``), bit-identical to the first; and the card's
    tables at the nodes of the sample ``rows`` against the host's fp64
    recurrence (``build_parity_tables``, the CPU's tables), relative to
    their largest |value|."""
    from ectrans_tpu_torch import latlon
    from ectrans_tpu_torch.legendre import build_parity_tables

    same = {"host sums": torch.equal(want, latlon_direct(res, ll, sp, flags,
                                                         rows))}
    gl = latlon.latlon_tables(res, ll, torch.float64, dev)[0]
    fill_free_memory(dev)
    again = latlon._build_tables(res, ll, torch.float64, dev)[0]
    same["tables"] = all(torch.equal(a.psym, b.psym) and
                         torch.equal(a.pasym, b.pasym)
                         for a, b in zip(gl.groups, again.groups))
    del again
    same["fp64 call"] = torch.equal(
        grid64, st64.inv_trans_latlon(ll, *sp, flags=flags))
    nodes = sorted({min(r, ll.nlat - 1 - r) for r in rows})
    psym, pasym, _ = build_parity_tables(res.nsmax, ll.mu[nodes], 1)
    err = scale = 0.0
    for g in gl.groups:
        for card, host in ((g.psym, psym), (g.pasym, pasym)):
            ref = torch.from_numpy(host[g.m0:g.m1, :, :g.kg])
            err = max(err, (card[:, nodes].cpu() - ref).abs().max().item())
            scale = max(scale, ref.abs().max().item())
    gc.collect()
    torch.cuda.empty_cache()
    return dict(same=same, nodes=err / scale)


def c1_probe(dev: torch.device, name: str = "TCO1279",
             shape=LATLON) -> dict:
    """Phase 9(b)'s fp64 reading taken apart (not a phase: run it behind
    ``phase_build``): the card's fp64 lat-lon output at the sample rows
    against the same code on the CPU (``device="cpu"``: its tables from the
    host's fp64 recurrence, its einsums and FFTs on the CPU) and against
    the host's direct sums, each field relative to its largest |value|;
    the worst field and row.  Prints and returns one JSON object."""
    import ectrans_tpu_torch as ett

    st64 = ett.SpectralTransform(name, dtype=torch.float64, device=dev)
    res = st64.res
    ll = ett.LatLonGrid(*shape)
    flags = ett.InvFlags(scders=True, uvders=True)
    rows = sample_rows(shape[0])
    sp = [x.to(dev) for x in bench_inputs(res.nspec2, res.nsmax)]
    card = st64.inv_trans_latlon(ll, *sp, flags=flags)[:, rows].cpu()
    host = latlon_direct(res, ll, sp, flags, rows)
    t0 = time.perf_counter()
    cpu = ett.inv_trans_latlon(res, ll, *(x.cpu() for x in sp), flags=flags,
                               dtype=torch.float64)[:, rows]
    t_cpu = time.perf_counter() - t0
    res.drop_cached("latlon_tables")
    card_host = field_shares(card, host, 1.0)
    f = int(np.argmax(card_host))
    by_row = ((card[f] - host[f]).abs().amax(1)
              / host[f].abs().max()).tolist()
    out = dict(card_host=max(card_host), card_cpu=max(field_shares(
        card, cpu, 1.0)), cpu_host=max(field_shares(cpu, host, 1.0)),
        worst_field=f, rows=rows, by_row=by_row,
        card_host_by_field=card_host, cpu_seconds=t_cpu)
    print(json.dumps({"c1_probe": out}))
    ett.trans_end()
    return out


def hold_k4_latlon(res, ll, dev: torch.device) -> tuple:
    """K4 at the lat-lon nodes (the north pole's row included; its sectoral
    seeds of m > 0 are 0) against its plain version: (max abs difference,
    largest |value|, bit-identical)."""
    from ectrans_tpu_torch import latlon
    from ectrans_tpu_torch.ops import legendre_tablegen as tg

    mu = latlon.latlon_nodes(ll)
    inp = {k: torch.as_tensor(v, device=dev).contiguous()
           for k, v in tg.recurrence_inputs(
               res.nsmax, mu, np.full(mu.size, res.nsmax)).items()}
    groups = latlon.latlon_groups(res)
    got = tg.gen_groups(inp, groups, torch.float32)
    want = [tg.gen_group_plain(inp, m0, m1, J, i0, torch.float32)
            for m0, m1, i0, J in groups]
    return compare("K4 lat-lon", got, want)


def phase_latlon(dev: torch.device, counters: dict,
                 name: str = "TCO1279", shape=LATLON) -> dict:
    """Phase 9: ``SpectralTransform(name).inv_trans_latlon`` onto the
    regular lat-lon grid with poles ``shape``, the bench's fields and
    flags (phase 4's inputs), in fp32 on the card: its setup (the lat-lon
    tables by K4, one launch) timed; (a) against the card's fp64 path;
    (b) against a host fp64 evaluation by direct sums at sample rows; (c)
    ``dir_trans_latlon`` fp32 against fp64, and the interpolation-limited
    round trip of fields truncated at n <= 319 (printed, not gated); (d)
    the adjoint identity by autograd.  No Legendre kernel may run (the
    grouped einsums carry the sums); K4 is held against its plain version
    on the lat-lon nodes.  Returns K4's launches and the fp32 lat-lon
    grid (on the host)."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import latlon

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    flags = ett.InvFlags(scders=True, uvders=True)
    ll = ett.LatLonGrid(*shape)
    legendre = ("K1", "K2", "K3", "K5", "K6", "K7", "K8", "K9", "K10")
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    st = ett.SpectralTransform(name)
    st64 = ett.SpectralTransform(name, dtype=torch.float64)
    res = st.res
    latlon.latlon_tables(res, ll, torch.float32, dev)
    res.device_tables(torch.float32, dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    sp = [x.to(dev) for x in bench_inputs(res.nspec2, res.nsmax)]
    torch.cuda.reset_peak_memory_stats()
    grid, t_first = first_call(lambda: st.inv_trans_latlon(ll, *sp,
                                                           flags=flags))
    launches = {k: counters[k].launches for k in ("K4",) + legendre}
    check(launches["K4"] == 1 and not any(launches[k] for k in legendre),
          f"the lat-lon path launched {launches}; expected K4 once (its "
          "tables) and no Legendre or packing kernel")
    nout = grid.shape[0]
    check(tuple(grid.shape) == (26, *shape) and grid.device == dev
          and bool(torch.isfinite(grid).all()),
          f"lat-lon output {tuple(grid.shape)} on {grid.device}")
    med, peak = median_peak(lambda: st.inv_trans_latlon(ll, *sp,
                                                        flags=flags))
    # (a) fp32 against the card's fp64 path on the same inputs
    grid64 = st64.inv_trans_latlon(ll, *sp, flags=flags)
    share_a = max(field_shares(grid, grid64, LATLON_GATE))
    check(share_a <= 1.0, f"lat-lon fp32 vs fp64: {share_a:.3f} of 100 eps")
    # (b) the host's direct sums at the sample rows
    rows = sample_rows(shape[0])
    t0 = time.perf_counter()
    want = latlon_direct(res, ll, sp, flags, rows)
    t_host = time.perf_counter() - t0
    share_b = max(field_shares(grid[:, rows].cpu(), want, LATLON_GATE))
    b64 = field_shares(grid64[:, rows].cpu(), want, 1.0)
    worst64 = int(np.argmax(b64))
    share_b64 = b64[worst64]
    check(share_b <= 1.0, f"lat-lon fp32 vs the host's direct sums: "
                          f"{share_b:.3f} of 100 eps")
    peak_b = torch.cuda.max_memory_allocated()
    c1 = latlon_fp64_checks(res, ll, st64, sp, flags, grid64, want, rows,
                            dev)
    torch.cuda.reset_peak_memory_stats()
    check(share_b64 <= LATLON_FP64_TOL and all(c1["same"].values())
          and c1["nodes"] <= LATLON_TABLE_TOL,
          f"lat-lon fp64 vs the host's direct sums: {share_b64:.3e} of the "
          f"field's largest |value| (at most {LATLON_FP64_TOL:g}); "
          f"bit-identical {c1['same']}; tables at the rows' nodes "
          f"{c1['nodes']:.3e} from the host's (at most "
          f"{LATLON_TABLE_TOL:g})")
    del want, grid64
    # (c) the direct transform from the lat-lon grid
    x_grid = bench_fields(grid)
    out32, t_dir = first_call(lambda: st.dir_trans_latlon(ll, *x_grid))
    out64 = st64.dir_trans_latlon(ll, *x_grid)
    share_c = max(max(field_shares(a, b, LATLON_GATE))
                  for a, b in zip(out32, out64))
    check(share_c <= 1.0, f"dir_trans_latlon fp32 vs fp64: {share_c:.3f} "
                          "of 100 eps")
    del out32, out64
    sc_t = truncate(sp[2], res, LATLON_TRUNC)
    back = st.dir_trans_latlon(ll, scalars=st.inv_trans_latlon(
        ll, spscalar=sc_t))[2]
    trunc_err, alias = truncated_errors(back, sc_t, res, LATLON_TRUNC)
    res.drop_cached("grouped_legendre")
    # (d) the adjoint identity by autograd
    gen = torch.Generator(device=dev).manual_seed(12)
    y = torch.randn(grid.shape, generator=gen, device=dev)
    grid_host = grid.cpu()       # phase 11 holds its mesh to it
    del grid, x_grid
    ident, t_adj = first_call(lambda: latlon_identity(res, ll, sp, flags, y))
    check(ident <= ADJOINT_TOL, f"lat-lon adjoint identity {ident:.3e} over "
                                f"2000 eps {ADJOINT_TOL:.3e}")
    peak_all = max(peak_b, torch.cuda.max_memory_allocated()) / 2**30
    k4 = counters["K4"].launches
    k4_err, k4_scale, k4_same = hold_k4_latlon(res, ll, dev)
    check(k4_err <= 1e-7 * k4_scale, f"K4 at the lat-lon nodes: "
                                     f"{k4_err:.3e} from its plain version")
    table_gib = sum(tensor_bytes([g.psym, g.pasym]) for g in
                    latlon.latlon_tables(res, ll, torch.float32,
                                         dev)[0].groups) / 2**30
    print(f"phase 9 TCO1279 -> lat-lon {shape[0]} x {shape[1]} with poles "
          f"({nout} fields, fp32): setup {t_setup:.2f} s (lat-lon "
          f"tables {table_gib:.2f} GiB by K4); first call {t_first:.3f} s; "
          f"median {med:.1f} ms (n 3); peak {peak:.2f} GiB; (a) vs the card's "
          f"fp64 {share_a:.3f} of 100 eps; (b) vs host direct sums at rows "
          f"{rows}: fp32 {share_b:.3f} of 100 eps, fp64 {share_b64:.2e} "
          f"of the field's largest |value| (field {worst64}; at most "
          f"{LATLON_FP64_TOL:g}; bit-identical, in memory filled with NaN "
          f"first: {c1['same']}; the card's fp64 tables at the rows' nodes "
          f"{c1['nodes']:.2e} from the host's recurrence, at most "
          f"{LATLON_TABLE_TOL:g}; host "
          f"{t_host:.1f} s); (c) dir_trans_latlon fp32 vs "
          f"fp64 {share_c:.3f} of 100 eps (first call {t_dir:.3f} s), round "
          f"trip of fields truncated at n <= {LATLON_TRUNC}: {trunc_err:.3e} "
          f"of their max on n <= {LATLON_TRUNC}, {alias:.3e} above it (the "
          f"aliases of m >= {shape[1] // 2}; not gated); (d) adjoint identity {ident:.3e} "
          f"({ident / ADJOINT_TOL:.4f} of 2000 eps, {t_adj:.2f} s); peak of "
          f"the phase {peak_all:.2f} GiB; K4 launches {k4} (1 lat-lon table "
          f"build a dtype and (b)'s fp64 rebuild, 16 for the Gaussian "
          f"tables of each dir_trans_latlon dtype), at the lat-lon nodes {k4_err:.2e} from "
          f"its plain version (bit-identical {k4_same}); no Legendre or "
          f"packing kernel {launches}")
    del y, sp
    ett.trans_end()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 9 done in {time.perf_counter() - t_phase:.1f} s")
    return {"K4": k4, "grid": grid_host}


def lam_inputs(res, nuv: int, nsc: int, seed: int = 0):
    """Packed LAM spectra with the physical-field mask (purely real modes
    where a conjugate pair degenerates: the m = 0 zonal-imaginary and the
    n = 0 meridional-imaginary parts; tests/test_lam.py), vor/div without
    their (0, 0) mode (it carries no wind), and a mean wind."""
    rng = np.random.default_rng(seed)
    pm, pn, pc = res.packed_m, res.packed_n, res.packed_c
    kill = ((pm == 0) & (pc >= 2)) | ((pn == 0) & (pc % 2 == 1))

    def packed(n):
        x = rng.standard_normal((n, res.nspec2)).astype(np.float32)
        x[:, kill] = 0.0
        return x

    vor, div, sc = packed(nuv), packed(nuv), packed(nsc)
    vor[:, :4] = 0.0
    div[:, :4] = 0.0
    mean = rng.standard_normal((2, nuv)).astype(np.float32)
    return [torch.from_numpy(x) for x in (vor, div, sc, mean[0], mean[1])]


def lam_round_trip_shares(out, x, u, v) -> tuple:
    """Check (a): the round trip's worst error as a share of 100 eps, for
    vor, div and the scalars of each family's largest |value|, for the mean
    wind of its wind field's (u's for meanu, v's for meanv): the mean wind
    is the (0, 0) coefficient of that field, so fp32 carries it to eps of
    the field, not of itself.  Also the mean wind's share of its own
    largest |value| (printed)."""
    spectra = max(max(field_shares(a[None], b[None], LATLON_GATE))
                  for a, b in zip(out[:3], x[:3]))
    wind = max(max(field_shares(a[None], b[None], LATLON_GATE, w[None]))
               for a, b, w in zip(out[3:], x[3:], (u, v)))
    own = max(max(field_shares(a[None], b[None], LATLON_GATE))
              for a, b in zip(out[3:], x[3:]))
    return max(spectra, wind), own


def lam_mode_fields(grid, m: int, n: int) -> torch.Tensor:
    """The closed forms of one (m, n) coefficient of value 1 in each of the
    four components (RR, RI, IR, II): (3, 4, ny, nx) fp64 — the field, its
    N-S and its E-W derivatives — with kx = m exwn, ky = n eywn, the phases
    reduced exactly mod nx and ny."""
    kx, ky = m * grid.exwn, n * grid.eywn
    ax = 2 * np.pi * ((m * np.arange(grid.nx)) % grid.nx) / grid.nx
    ay = 2 * np.pi * ((n * np.arange(grid.ny)) % grid.ny) / grid.ny
    cx, sx = np.cos(ax)[None, :], np.sin(ax)[None, :]
    cy, sy = np.cos(ay)[:, None], np.sin(ay)[:, None]
    f = [4 * cy * cx, -4 * sy * cx, -4 * cy * sx, 4 * sy * sx]
    dy = [-4 * ky * sy * cx, -4 * ky * cy * cx, 4 * ky * sy * sx,
          4 * ky * cy * sx]
    dx = [-4 * kx * cy * sx, 4 * kx * sy * sx, -4 * kx * cy * cx,
          4 * kx * sy * cx]
    return torch.from_numpy(np.stack([np.stack(f), np.stack(dy),
                                      np.stack(dx)]))


def lam_mode_share(lt, m: int, n: int) -> float:
    """Check (b): one (m, n) mode of each component through the handle's
    inverse with scders, against ``lam_mode_fields``: the worst error
    relative to each field's largest |value|."""
    res = lt.res
    spec = torch.zeros(4, res.nspec2, dtype=torch.float64)
    for c in range(4):
        spec[c, int(res.nesm0[m]) + 4 * n + c] = 1.0
    from ectrans_tpu_torch.lam import LamInvFlags

    got = lt.inv_trans(spscalar=spec, flags=LamInvFlags(scders=True))
    want = lam_mode_fields(res.grid, m, n).to(got.device)
    return max(field_shares(got, want.reshape(12, *got.shape[1:]), 1.0))


def smooth_ci_field(grid) -> torch.Tensor:
    """A smooth (1, nyux, nxux) fp64 field on the C+I zone, not periodic."""
    gy, gx = np.meshgrid(np.arange(grid.nyux), np.arange(grid.nxux),
                         indexing="ij")
    f = (np.sin(2 * np.pi * 3 * gx / grid.nx) * np.cos(2 * np.pi * 2 * gy
                                                     / grid.ny)
         + 0.5 * np.cos(gx / 97.0 + gy / 131.0) + 1e-3 * gx)
    return torch.from_numpy(f[None])


def biper_round_trip(res, field: torch.Tensor, dtype) -> tuple:
    """biperiodicize("spline") of a C+I field, then dir_trans_lam and
    inv_trans_lam of it: (extended field, round-trip field)."""
    from ectrans_tpu_torch import lam

    ext = lam.biperiodicize(field.to(dtype), res.grid, mode="spline")
    spec = lam.dir_trans_lam(res, scalars=ext, dtype=dtype)[2]
    return ext, lam.inv_trans_lam(res, spscalar=spec, dtype=dtype)


def phase_lam(dev: torch.device, counters: dict, domain=LAM_DOMAIN,
              nuv: int = LAM_NUV, nsc: int = LAM_NSC) -> dict:
    """Phase 10: ``LamTransform`` at the 1.3 km LAM domain in fp32 on the
    card, 10 vor/div pairs and 10 scalars with the mean wind and every
    flag (90 fields): (a) the round trip against the inputs; (b) one mode
    of each component and its derivatives against the closed form, fp64;
    (c) biperiodicize + round trip against the CPU's fp64; (d) both
    adjoint identities; (e) the norms against the CPU's fp64.  No kernel
    may run (the path has none).  Returns the inverse grid and the direct
    outputs of (a) (on the host)."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.lam import LamInvFlags, norms
    from ectrans_tpu_torch.transform import num_inv_output_fields

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    for c in counters.values():
        c.launches = 0
    flags = LamInvFlags(vorgp=True, divgp=True, scders=True, uvders=True)
    t0 = time.perf_counter()
    lt = ett.LamTransform(**domain)
    res, g = lt.res, lt.grid
    res.device_tables(torch.float32, dev)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    x = [v.to(dev) for v in lam_inputs(res, nuv, nsc)]
    torch.cuda.reset_peak_memory_stats()
    grid, t_first = first_call(lambda: lt.inv_trans(*x, flags=flags))
    nout = num_inv_output_fields(nuv, nsc, flags)
    check(tuple(grid.shape) == (nout, g.ny, g.nx)
          and grid.device == dev and bool(torch.isfinite(grid).all()),
          f"LAM output {tuple(grid.shape)} on {grid.device}")
    med, peak = median_peak(lambda: lt.inv_trans(*x, flags=flags))
    # (a) the round trip: u, v and the scalars back to the inputs
    u = grid[2 * nuv: 3 * nuv]
    v = grid[3 * nuv: 4 * nuv]
    sc = grid[4 * nuv: 4 * nuv + nsc]
    out, t_dir = first_call(lambda: lt.dir_trans(u, v, sc))
    share_a, mean_own = lam_round_trip_shares(out, x, u, v)
    check(share_a <= 1.0, f"LAM round trip: {share_a:.3f} of 100 eps")
    dmed, _ = median_peak(lambda: lt.dir_trans(u, v, sc))
    # (b) one mode of each component, fp64 on the card
    lt64 = ett.LamTransform(**domain, dtype=torch.float64)
    share_b = lam_mode_share(lt64, *LAM_MODE)
    check(share_b <= LAM_MODE_TOL, f"LAM mode {LAM_MODE} vs closed form: "
                                   f"{share_b:.3e}")
    # (c) biperiodicize + round trip against the CPU's fp64
    field = smooth_ci_field(g)
    t0 = time.perf_counter()
    ext64, back64 = biper_round_trip(res, field, torch.float64)
    t_cpu = time.perf_counter() - t0
    ext, back = biper_round_trip(res, field.to(dev), torch.float32)
    share_c = max(max(field_shares(ext.cpu(), ext64, LATLON_GATE)),
                  max(field_shares(back.cpu(), back64, LATLON_GATE)))
    check(share_c <= 1.0, f"LAM biperiodicize + round trip, card fp32 vs "
                          f"CPU fp64: {share_c:.3f} of 100 eps")
    ci = (back64[0, : g.nyux, : g.nxux] - field[0]).abs().max().item()
    del ext, back, ext64, back64
    # (d) both adjoint identities, fp32
    gen = torch.Generator(device=dev).manual_seed(12)
    y = torch.randn(grid.shape, generator=gen, device=dev)
    y_spec = [torch.randn(n, res.nspec2, generator=gen, device=dev)
              for n in (nuv, nuv, nsc)] + [
        torch.randn(nuv, generator=gen, device=dev) for _ in range(2)]
    inv_ad, t_iad = first_call(lambda: lt.inv_trans_adj(y, nuv, nsc,
                                                        flags=flags))
    dir_ad, t_dad = first_call(lambda: lt.dir_trans_adj(
        *y_spec, nfld_uv=nuv, nfld_sc=nsc))
    r_inv = adjoint_identity(grid, y, x, list(inv_ad))
    r_dir = adjoint_identity(list(out), y_spec, [u, v, sc], list(dir_ad))
    check(r_inv <= ADJOINT_TOL and r_dir <= ADJOINT_TOL,
          f"LAM adjoint identities: inverse {r_inv:.3e}, direct {r_dir:.3e}"
          f" over 2000 eps {ADJOINT_TOL:.3e}")
    del y, y_spec, inv_ad, dir_ad
    # (e) the norms against the CPU's fp64
    spec = torch.cat(x[:3])
    sn = lt.specnorm(spec).cpu().double()
    sn64 = norms.especnorm(res, spec.cpu().double())
    sn_rel = ((sn - sn64).abs() / sn64).max().item()
    g64 = grid.cpu().double()
    worst, exact = 0.0, True
    for full in (True, False):
        ave, gmin, gmax = (t.cpu().double() for t in lt.gpnorm(
            grid, full_domain=full))
        ave64, min64, max64 = norms.egpnorm(res, g64, full_domain=full)
        scale = norms.egpnorm(res, g64.abs(), ave_only=True,
                              full_domain=full)[0]
        worst = max(worst, ((ave - ave64).abs() / scale).max().item())
        exact = exact and torch.equal(gmin, min64) and torch.equal(gmax,
                                                                   max64)
    del g64
    check(sn_rel <= NORM_TOL and worst <= NORM_TOL and exact,
          f"LAM norms vs the CPU fp64: especnorm {sn_rel:.3e}, egpnorm "
          f"average {worst:.3e}, min/max exact {exact}")
    peak_all = torch.cuda.max_memory_allocated() / 2**30
    ran = {k: c.launches for k, c in counters.items() if c.launches}
    check(not ran, f"the LAM path launched kernels: {ran}")
    print(f"phase 10 LAM {g.nx} x {g.ny} (C+I {g.nxux} x {g.nyux}, dx "
          f"{g.dx:g} m, truncation ({g.msmax}, {g.nsmax}), nspec2 "
          f"{res.nspec2:,}; {nuv} vor/div pairs, {nsc} scalars, mean wind, "
          f"every flag: {nout} fields, fp32): setup {t_setup:.2f} s; inverse "
          f"first call {t_first:.3f} s, median {med:.1f} ms (n 3), peak "
          f"{peak:.2f} GiB; direct first call {t_dir:.3f} s, median "
          f"{dmed:.1f} ms; (a) round trip {share_a:.3f} of 100 eps (the mean "
          f"wind of its wind field's max; of its own {mean_own:.3g}, not "
          f"gated); (b) mode "
          f"{LAM_MODE} of each component, fp64 vs closed form {share_b:.2e} "
          f"(at most {LAM_MODE_TOL:g}); (c) biperiodicize + round trip, card "
          f"fp32 vs CPU fp64 {share_c:.3f} of 100 eps (CPU {t_cpu:.1f} s; "
          f"C+I error of the truncated round trip {ci:.2e}, not gated); (d) "
          f"adjoint identities inverse {r_inv:.3e}, direct {r_dir:.3e} "
          f"({max(r_inv, r_dir) / ADJOINT_TOL:.4f} of 2000 eps; first calls "
          f"{t_iad:.2f} / {t_dad:.2f} s); (e) especnorm {sn_rel:.2e}, "
          f"egpnorm average {worst:.2e} (full domain and C+I), min/max exact "
          f"{exact}; peak of the phase {peak_all:.2f} GiB; no kernel "
          "launched")
    outputs = dict(grid=grid.cpu(), spec=[o.cpu() for o in out])
    del grid, out
    res.drop_cached()
    print(f"phase 10 done in {time.perf_counter() - t_phase:.1f} s")
    return outputs


# -- phase 11: the distributed transforms on four ranks sharing the card ------

MESH_WORLD = 4               # ranks, all on cuda:0, in one gloo group
MESH_SHAPES = ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (1, 4))
MESH_LIMIT = 480             # s: the world's own limit, joined with it
MESH_COLLECTIVE_LIMIT = 300  # s: a collective that waits longer raises
MESH_FP64_TOL = 1e-12        # each mesh against the single-device fp64
MESH_PAIR_TOL = 1e-13        # every pair of meshes (tests/test_sharded.py)
MESH_GATE = 100 * float(np.finfo(np.float32).eps)
MESH_SMALL = ("O160", 159)   # rows (b)-(d): T159
MESH_KVSET = ([1, 0], [1, 0, 0, 1, 1, 0])    # row (d): kvsetuv, kvsetsc
MESH_NPROMATR = 4
# what the ranks run: the bench grid of (a) and (e), the lat-lon grid of
# (e), the grid of (b)-(d), the LAM domain of (f) and the device (a CPU
# rehearsal passes small ones and "cpu")
MESH_CONFIG = dict(bench="TCO1279", latlon=LATLON, small=MESH_SMALL,
                   lam=LAM_DOMAIN, device="cuda")
# the rows of phase 11: key, what it runs, on which meshes
MESH_ROWS = (
    ("a", "TCO1279 bench round trip, fp32 dense, vs phase 4", ((2, 2),)),
    ("e", "TCO1279 -> lat-lon 721 x 1440, vs phase 9", ((2, 2),)),
    ("b", "T159 decomposition invariance, fp64", MESH_SHAPES),
    ("c", "T159 fp32 dense (and bf16 on 2 x 2) vs single device",
     MESH_SHAPES),
    ("d", "T159 kvset and npromatr packets, fp64", ((1, 2),)),
    ("f", "LAM 1.3 km, both directions, vs phase 10", ((2, 2),)),
)


def mesh_rows() -> tuple:
    """Phase 11's rows in the order the ranks run them (the TCO1279 handle
    of (a) serves (e))."""
    return MESH_ROWS


def family_stats(got, want, sizes) -> list:
    """Per family of consecutive leading-axis fields (``sizes``): [max
    |got - want|, max |want|, bit-identical] on this rank's shard."""
    out, i = [], 0
    for n in sizes:
        a = torch.as_tensor(got[i: i + n]).double().cpu()
        b = torch.from_numpy(np.array(want[i: i + n])).double()
        d = (a - b).abs().max().item() if a.numel() else 0.0
        s = b.abs().max().item() if b.numel() else 0.0
        out.append([d, s, bool(torch.equal(a, b))])
        i += n
    return out


def merge_families(per_rank: list) -> list:
    """The ranks' ``family_stats`` of one comparison combined: the largest
    difference and the largest |value| over the ranks, and whether every
    shard was bit-identical."""
    return [[max(r[k][0] for r in per_rank), max(r[k][1] for r in per_rank),
             all(r[k][2] for r in per_rank)]
            for k in range(len(per_rank[0]))]


def worst_share(merged: list, gate: float) -> float:
    """The worst family's difference as a share of gate times its largest
    |value|."""
    return max(d / (gate * max(s, np.finfo(np.float64).tiny))
               for d, s, _ in merged)


def merge_launches(launches: dict, per_rank: list) -> dict:
    """Add the ranks' launch counts of the main path to the kernels line's
    ``launches``; returns the per-kernel totals added."""
    added = {}
    for counts in per_rank:
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
            added[k] = added.get(k, 0) + n
    return added


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev) -> float:
    """Peak GiB allocated on dev since the last reset (0 on the CPU)."""
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)


def _timed(dev, fn):
    """(fn(), seconds) on dev."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _counts(counters: dict, keys=("K1", "K2", "K3", "K4")) -> dict:
    return {k: counters[k].launches for k in keys}


def _zero(counters: dict) -> None:
    for c in counters.values():
        c.launches = 0


def mesh_round_trip(st, loc, nuv: int, nsc: int, flags):
    """inv_trans of this rank's spectra, then dir_trans of the u, v and
    scalars of its grid block."""
    grid = st.inv_trans(*loc, flags=flags)
    return grid, st.dir_trans(grid[:nuv], grid[nuv: 2 * nuv],
                              grid[2 * nuv: 2 * nuv + nsc])


def mesh_bench(dev, counters, tmp: str, rank: int, cfg: dict) -> tuple:
    """Row (a) and, on the same handle, row (e); returns their reports and
    the handle's Resolution."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.field_layout import FieldLayout
    from ectrans_tpu_torch.parallel import comm, make_mesh

    flags = ett.InvFlags(scders=True, uvders=True)
    _reset_peak(dev)
    _zero(counters)
    t_row = time.perf_counter()
    mesh = make_mesh(2, 2, device=dev)
    st, t_setup = _timed(dev, lambda: ett.SpectralTransform(cfg["bench"],
                                                            mesh=mesh))
    res = st.res
    sp = bench_inputs(res.nspec2, res.nsmax)
    loc = [st.dist_spec(x) for x in sp]
    comm.TRAFFIC.clear()
    (grid, out), t_first = _timed(dev, lambda: mesh_round_trip(
        st, loc, NFLD_UV, NFLD_SC, flags))
    launches = _counts(counters)
    traffic = dict(comm.TRAFFIC)
    first = int(st.inquire()["nfrstlat"][mesh.rank])
    end = first + grid.shape[1]
    sizes = FieldLayout.inv(NFLD_UV, NFLD_SC, flags).sizes_padded
    check(tuple(grid.shape) == (26, res.ndgl // 4, res.grid.ndlon)
          and bool(torch.isfinite(grid).all()),
          f"rank {rank}: grid block {tuple(grid.shape)}")
    ref = np.load(os.path.join(tmp, "a_grid.npy"), mmap_mode="r")
    grid_stats = family_stats(grid, ref[:, first:end], sizes)
    del ref
    want = np.load(os.path.join(tmp, "a_spec.npz"))
    spec_stats = [family_stats(o, st.dist_spec(want[k]).cpu(), [o.shape[0]])[0]
                  for o, k in zip(out, ("vor", "div", "sc"))]
    gate = family_errors(out, loc)
    med = statistics.median(_timed(dev, lambda: mesh_round_trip(
        st, loc, NFLD_UV, NFLD_SC, flags))[1] for _ in range(3)) * 1e3
    peak = _peak(dev)
    del grid, out
    report_a = dict(setup=t_setup, first=t_first, median=med, peak=peak,
                    groups=len(res.legendre_groups()),
                    launches=launches, traffic=traffic, grid=grid_stats,
                    spec=spec_stats, gate=gate,
                    seconds=time.perf_counter() - t_row)
    # (e): the lat-lon output on the same handle
    t_row = time.perf_counter()
    ll = ett.LatLonGrid(*cfg["latlon"])
    _zero(counters)
    _reset_peak(dev)
    lgrid, t_first = _timed(dev, lambda: st.inv_trans_latlon(ll, *loc,
                                                             flags=flags))
    R = -(-ll.nlat // 4)
    lo = min(mesh.rank * R, ll.nlat)
    ref = np.load(os.path.join(tmp, "e_grid.npy"), mmap_mode="r")
    check(tuple(lgrid.shape) == (26, min(lo + R, ll.nlat) - lo, ll.nlon),
          f"rank {rank}: lat-lon block {tuple(lgrid.shape)}")
    report_e = dict(first=t_first, peak=_peak(dev),
                    launches=_counts(counters),
                    fields=family_stats(lgrid, ref[:, lo: lo + R], [1] * 26),
                    seconds=time.perf_counter() - t_row)
    del lgrid, ref, st
    ett.trans_end()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return report_a, report_e


def mesh_small(dev, counters, groups: dict, rank: int, cfg: dict) -> dict:
    """Rows (b), (c) and (d) at T159 on the meshes of their rows, each on
    the first w*v ranks: every rank of a mesh against the single-device
    transform on its shard; rank 0 (in every mesh) gathers the global
    results for the cross-mesh deltas."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.field_layout import FieldLayout
    from ectrans_tpu_torch.parallel import make_mesh

    name, nsmax = cfg["small"]
    flags = ett.InvFlags(vorgp=True, divgp=True, scders=True, uvders=True)
    sizes = FieldLayout.inv(NFLD_UV, NFLD_SC, flags).sizes_padded
    nout = sum(sizes)
    rep = {"b": {}, "c": {}, "d": {}}
    t_row = {k: 0.0 for k in rep}

    def single(dtype, precision="highest"):
        st = ett.SpectralTransform(name, nsmax, dtype=dtype,
                                   precision=precision, device=dev)
        sp = [x.to(dev, dtype) for x in bench_inputs(st.res.nspec2, nsmax)]
        grid = st.inv_trans(*sp, flags=flags)
        fields = (grid[2 * NFLD_UV: 3 * NFLD_UV],
                  grid[3 * NFLD_UV: 4 * NFLD_UV],
                  grid[4 * NFLD_UV: 4 * NFLD_UV + NFLD_SC])
        return sp, grid, fields, st.dir_trans(*fields)

    def on_mesh(w, v, dtype, precision="highest"):
        mesh = make_mesh(w, v, group=groups[w * v], device=dev)
        st = ett.SpectralTransform(name, nsmax, mesh=mesh, dtype=dtype,
                                   precision=precision)
        return mesh, st

    gathered = {}
    for tier, dtype, precision in (("b", torch.float64, "highest"),
                                   ("c", torch.float32, "highest"),
                                   ("c", torch.float32, "bf16")):
        sp, grid, fields, spec = single(dtype, precision)
        for w, v in MESH_SHAPES:
            if precision == "bf16" and (w, v) != (2, 2):
                continue
            if rank >= w * v:
                continue
            t0 = time.perf_counter()
            _zero(counters)
            mesh, st = on_mesh(w, v, dtype, precision)
            g = st.inv_trans(*[st.dist_spec(x.cpu()) for x in sp],
                             flags=flags)
            first = int(st.inquire()["nfrstlat"][mesh.rank])
            end = first + g.shape[1]
            out = st.dir_trans(*[st.dist_grid(f.cpu()) for f in fields])
            _sync(dev)
            key = f"{w}x{v}" + ("" if precision == "highest" else " bf16")
            ent = dict(launches=_counts(counters))
            if tier == "b":
                ent["inv"] = (g.double().cpu() - grid[:, first:end].cpu()
                              ).abs().max().item() / grid.abs().max().item()
                ent["dir"] = max(
                    family_stats(o, st.dist_spec(s.cpu()).cpu(),
                                 [o.shape[0]])[0][0] / s.abs().max().item()
                    for o, s in zip(out, spec))
                G = st.gath_grid(g)
                S = [st.gath_spec(o) for o in out]
                if rank == 0:
                    gathered[key] = (G, S)
            else:
                ent["grid"] = family_stats(g, grid[:, first:end].cpu(),
                                           sizes)
                ent["spec"] = [family_stats(o, st.dist_spec(s.cpu()).cpu(),
                                            [o.shape[0]])[0]
                               for o, s in zip(out, spec)]
            rep[tier][key] = ent
            t_row[tier] += time.perf_counter() - t0
            del st, g, out
        del sp, grid, fields, spec
    if rank == 0:
        keys = sorted(gathered)
        scale_g = max(np.abs(gathered[k][0]).max() for k in keys)
        scale_s = max(np.abs(s).max() for k in keys for s in gathered[k][1])
        pair = 0.0
        for i, a in enumerate(keys):
            for b in keys[i + 1:]:
                ga, sa = gathered[a]
                gb, sb = gathered[b]
                pair = max(pair, np.abs(ga - gb).max() / scale_g,
                           max(np.abs(x - y).max() for x, y in zip(sa, sb))
                           / scale_s)
        rep["b"]["pairs"] = pair
        del gathered
    # (d): ownership vectors and packets against the plain mesh call
    t0 = time.perf_counter()
    if rank < 2:
        kvuv, kvsc = MESH_KVSET
        sp, grid, fields, spec = single(torch.float64)
        mesh, st = on_mesh(1, 2, torch.float64)
        host = [x.cpu() for x in sp]
        plain = st.inv_trans(*[st.dist_spec(x) for x in host], flags=flags)
        kv = st.inv_trans(st.dist_spec(host[0], kvuv),
                          st.dist_spec(host[1], kvuv),
                          st.dist_spec(host[2], kvsc), flags=flags,
                          kvsetuv=kvuv, kvsetsc=kvsc)
        pk = st.inv_trans(*[st.dist_spec(x) for x in host], flags=flags,
                          npromatr=MESH_NPROMATR)
        scale = plain.abs().max().item()
        inv = max((x - plain).abs().max().item() for x in (kv, pk)) / scale
        blk = [st.dist_grid(f.cpu()) for f in fields]
        d_plain = [st.gath_spec(o) for o in st.dir_trans(*blk)]
        d_kv = st.dir_trans(*blk, kvsetuv=kvuv, kvsetsc=kvsc)
        d_kv = [st.gath_spec(o, k) for o, k in zip(d_kv, (kvuv, kvuv, kvsc))]
        d_pk = [st.gath_spec(o) for o in st.dir_trans(
            *blk, npromatr=MESH_NPROMATR)]
        dirs = max(np.abs(a - b).max() / np.abs(b).max()
                   for got in (d_kv, d_pk) for a, b in zip(got, d_plain))
        rep["d"]["1x2"] = dict(inv=inv, dir=dirs, nout=nout)
        del st, plain, kv, pk
    t_row["d"] = time.perf_counter() - t0
    for k in rep:
        rep[k]["seconds"] = t_row[k]
    ett.trans_end()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return rep


def mesh_lam(dev, counters, tmp: str, rank: int, cfg: dict) -> dict:
    """Row (f): ``LamTransform(..., mesh=)`` at phase 10's domain and
    inputs on (2, 2), both directions against phase 10's outputs; no
    kernel may run."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.field_layout import FieldLayout
    from ectrans_tpu_torch.lam import LamInvFlags
    from ectrans_tpu_torch.parallel import make_mesh

    t_row = time.perf_counter()
    _zero(counters)
    _reset_peak(dev)
    flags = LamInvFlags(vorgp=True, divgp=True, scders=True, uvders=True)
    mesh = make_mesh(2, 2, device=dev)
    lt = ett.LamTransform(**cfg["lam"], mesh=mesh)
    x = lam_inputs(lt.res, LAM_NUV, LAM_NSC)
    loc = [lt.dist_spec(a) for a in x]
    grid, t_inv = _timed(dev, lambda: lt.inv_trans(*loc, flags=flags))
    R = -(-lt.grid.ny // 4)
    lo = min(mesh.rank * R, lt.grid.ny)
    hi = min(lo + R, lt.grid.ny)
    check(tuple(grid.shape[1:]) == (hi - lo, lt.grid.nx),
          f"rank {rank}: LAM block {tuple(grid.shape)}")
    ref = np.load(os.path.join(tmp, "f_grid.npy"), mmap_mode="r")
    sizes = FieldLayout.inv(LAM_NUV, LAM_NSC, flags).sizes_padded
    inv = family_stats(grid, ref[:, lo:hi], sizes)
    n = LAM_NUV
    blk = [torch.from_numpy(np.array(ref[a: a + k, lo:hi])) for a, k in
           ((2 * n, n), (3 * n, n), (4 * n, LAM_NSC))]
    del ref, grid
    out, t_dir = _timed(dev, lambda: lt.dir_trans(*blk))
    want = np.load(os.path.join(tmp, "f_spec.npz"))
    keys = ("vor", "div", "sc", "meanu", "meanv")
    spec = [family_stats(o, lt.dist_spec(want[k]).cpu(), [o.shape[0]])[0]
            for o, k in zip(out, keys)]
    rep = dict(first_inv=t_inv, first_dir=t_dir, peak=_peak(dev),
               launches={k: c.launches for k, c in counters.items()
                         if c.launches},
               grid=inv, spec=spec, seconds=time.perf_counter() - t_row)
    del lt, out, blk
    return rep


def mesh_rank(rank: int, world: int, store: str, tmp: str,
              cfg: dict) -> None:
    """One rank of phase 11 (a spawned process, on cuda:0 like every other
    rank): rows (a), (e), (b)-(d), (f) as ``cfg`` sizes them; writes its
    report to ``tmp``/rank{rank}.json."""
    import datetime

    import torch.distributed as dist

    dev = torch.device(cfg["device"], 0) if cfg["device"] == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.cufft_plan_cache[0].max_size = CUFFT_PLANS
    dist.init_process_group(
        "gloo", store=dist.FileStore(store, world), rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=MESH_COLLECTIVE_LIMIT))
    try:
        # every rank makes every subgroup, in the same order
        groups = {n: dist.new_group(list(range(n))) for n in (1, 2)}
        groups[world] = None
        counters = launch_counters()
        rep = {}
        rep["a"], rep["e"] = mesh_bench(dev, counters, tmp, rank, cfg)
        rep.update(mesh_small(dev, counters, groups, rank, cfg))
        rep["f"] = mesh_lam(dev, counters, tmp, rank, cfg)
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(rep, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(fn, tmp: str, cfg: dict, world: int = MESH_WORLD,
              limit: float = MESH_LIMIT) -> list:
    """Spawn ``world`` ranks of fn(rank, world, store, tmp, cfg) and join them
    within ``limit`` seconds; a rank that raises or exits non-zero fails
    the run, and so does a world that outlasts its limit (its ranks are
    killed).  Returns the ranks' reports."""
    import torch.multiprocessing as mp

    store = os.path.join(tmp, "store")
    ctx = mp.start_processes(fn, args=(world, store, tmp, cfg), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + limit
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {world}-rank world outlasted its "
                                   f"{limit:.0f} s limit")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    reports = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports


def phase_mesh(dev: torch.device, refs: dict,
               cfg: dict = MESH_CONFIG) -> dict:
    """Phase 11: the distributed transforms on a (w, v) mesh of four ranks
    sharing the card (gloo: NCCL refuses two ranks on one device; gloo
    stages its collectives through the host, so the times are a check's,
    not distributed performance).  ``refs``: phase 4's grid and spectra,
    phase 9's lat-lon grid and phase 10's grid and direct outputs (host
    tensors).  Returns the launches of rows (a) and (e) summed over the
    ranks, for the kernels line."""
    import shutil
    import tempfile

    import ectrans_tpu_torch as ett

    t_phase = time.perf_counter()
    ett.trans_end()
    gc.collect()
    if dev.type == "cuda":
        torch.backends.cuda.cufft_plan_cache[dev.index].clear()
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        np.save(os.path.join(tmp, "a_grid.npy"), refs["a_grid"].numpy())
        np.savez(os.path.join(tmp, "a_spec.npz"),
                 **{k: x.numpy() for k, x in zip(("vor", "div", "sc"),
                                                 refs["a_spec"])})
        np.save(os.path.join(tmp, "e_grid.npy"), refs["e_grid"].numpy())
        np.save(os.path.join(tmp, "f_grid.npy"), refs["f_grid"].numpy())
        np.savez(os.path.join(tmp, "f_spec.npz"),
                 **{k: x.numpy() for k, x in zip(
                     ("vor", "div", "sc", "meanu", "meanv"), refs["f_spec"])})
        t0 = time.perf_counter()
        reps = run_world(mesh_rank, tmp, cfg)
        t_world = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    card = "the CPU"
    if dev.type == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    return mesh_report(reps, t_world, time.perf_counter() - t_phase, card,
                       cfg)


def mesh_report(reps: list, t_world: float, t_phase: float, card: str,
                cfg: dict = MESH_CONFIG) -> dict:
    """Check and print phase 11's rows from the ranks' reports; returns the
    launches of rows (a) and (e) summed over the ranks."""
    # (a)
    a = [r["a"] for r in reps]
    for r, x in enumerate(a):
        want = {"K1": x["groups"], "K2": x["groups"], "K3": 1, "K4": 1}
        check(x["launches"] == want, f"phase 11 (a) rank {r} launched "
                                     f"{x['launches']}; expected {want}")
    gate = [(max(x["gate"][k][0] for x in a), max(x["gate"][k][1] for x in a))
            for k in range(3)]
    share = max(e / (MESH_GATE * m) for e, m in gate)
    grid = merge_families([x["grid"] for x in a])
    spec = merge_families([x["spec"] for x in a])
    g_share, s_share = worst_share(grid, MESH_GATE), worst_share(spec,
                                                                 MESH_GATE)
    check(share <= DENSE_GATE_SHARE,
          f"phase 11 (a) round trip {share:.3f} of the 100 eps gate, over "
          f"{DENSE_GATE_SHARE}")
    check(g_share <= 1.0 and s_share <= 1.0,
          f"phase 11 (a) against phase 4: grid {g_share:.3f}, spectra "
          f"{s_share:.3f} of 100 eps")
    traffic = {k: max(x["traffic"].get(k, 0) for x in a) / 2**20
               for k in sorted(a[0]["traffic"])}
    print(f"phase 11 (a) {cfg['bench']} round trip on a 2 x 2 mesh of 4 ranks on "
          f"one card ({card}; gloo, host-staged: times of a check, not "
          f"distributed performance): gate {share:.3f} of 100 eps (at most "
          f"{DENSE_GATE_SHARE}); against phase 4, grid "
          f"{max(d for d, _, _ in grid):.3e} ({g_share:.3f} of 100 eps of "
          f"the family max, bit-identical {all(b for _, _, b in grid)}), "
          f"spectra {max(d for d, _, _ in spec):.3e} ({s_share:.3f}, "
          f"bit-identical {all(b for _, _, b in spec)}); setup "
          f"{max(x['setup'] for x in a):.2f} s; first call "
          f"{max(x['first'] for x in a):.2f} s; median of 3 "
          f"{max(x['median'] for x in a):.1f} ms (slowest rank); peak per "
          f"rank {[round(x['peak'], 2) for x in a]} GiB; launches per rank "
          f"{a[0]['launches']}; MiB sent per rank a round trip "
          f"{ {k: round(v, 1) for k, v in traffic.items()} }; "
          f"{max(x['seconds'] for x in a):.1f} s")
    # (e)
    e = [r["e"] for r in reps]
    for r, x in enumerate(e):
        ran = {k: n for k, n in x["launches"].items() if n}
        check(ran == {"K4": 1}, f"phase 11 (e) rank {r} launched {ran}; "
                                "expected K4 once (its lat-lon tables)")
    fields = merge_families([x["fields"] for x in e])
    e_share = worst_share(fields, MESH_GATE)
    check(e_share <= 1.0, f"phase 11 (e) lat-lon against phase 9: "
                          f"{e_share:.3f} of 100 eps")
    print(f"phase 11 (e) {cfg['bench']} -> lat-lon {cfg['latlon'][0]} x "
          f"{cfg['latlon'][1]} on "
          f"2 x 2: against phase 9 {e_share:.3f} of 100 eps of each "
          f"field's max (bit-identical {all(b for _, _, b in fields)}); "
          f"first call {max(x['first'] for x in e):.2f} s; peak per rank "
          f"{[round(x['peak'], 2) for x in e]} GiB; K4 once a rank; "
          f"{max(x['seconds'] for x in e):.1f} s")
    # (b)
    b = [r["b"] for r in reps]
    worst_b = max(max(x[k]["inv"], x[k]["dir"]) for x in b for k in x
                  if "x" in k)
    pairs = b[0]["pairs"]
    check(worst_b <= MESH_FP64_TOL and pairs <= MESH_PAIR_TOL,
          f"phase 11 (b) fp64: worst mesh {worst_b:.3e} (at most "
          f"{MESH_FP64_TOL:g}), worst pair {pairs:.3e} (at most "
          f"{MESH_PAIR_TOL:g})")
    print(f"phase 11 (b) T{cfg['small'][1]} fp64 decomposition invariance on "
          f"{[f'{w}x{v}' for w, v in MESH_SHAPES]}: worst against the single "
          f"device {worst_b:.3e} relative (at most {MESH_FP64_TOL:g}), worst "
          f"pair of meshes {pairs:.3e} (at most {MESH_PAIR_TOL:g}); "
          f"{max(x['seconds'] for x in b):.1f} s")
    # (c)
    c = [r["c"] for r in reps]
    msg = []
    for key in [k for k in c[0] if "x" in k]:
        ents = [x[key] for x in c if key in x]
        for r, ent in enumerate(ents):
            lc = ent["launches"]
            check(lc["K1"] > 0 and lc["K2"] > 0 and lc["K3"] > 0,
                  f"phase 11 (c) {key} rank {r} launched {lc}")
        sh = max(worst_share(merge_families([x["grid"] for x in ents]),
                             MESH_GATE),
                 worst_share(merge_families([x["spec"] for x in ents]),
                             MESH_GATE))
        check(sh <= 1.0, f"phase 11 (c) {key}: {sh:.3f} of 100 eps")
        msg.append(f"{key} {sh:.3f}")
    print(f"phase 11 (c) T{cfg['small'][1]} fp32 dense (and bf16 on 2 x 2) against the "
          f"single device, share of 100 eps of each family's max: "
          f"{'; '.join(msg)}; K1, K2, K3 on every rank; "
          f"{max(x['seconds'] for x in c):.1f} s")
    # (d)
    d = reps[0]["d"]["1x2"]
    worst_d = max(max(r["d"]["1x2"]["inv"], r["d"]["1x2"]["dir"])
                  for r in reps[:2])
    check(worst_d <= MESH_FP64_TOL,
          f"phase 11 (d) kvset/packets vs the plain call {worst_d:.3e}")
    print(f"phase 11 (d) T{cfg['small'][1]} fp64 on 1 x 2, kvsetuv {MESH_KVSET[0]} kvsetsc "
          f"{MESH_KVSET[1]} and npromatr={MESH_NPROMATR} against the plain "
          f"mesh call: {worst_d:.3e} relative (at most {MESH_FP64_TOL:g}; "
          f"{d['nout']} fields); {max(r['d']['seconds'] for r in reps):.1f} s")
    # (f)
    f = [r["f"] for r in reps]
    for r, x in enumerate(f):
        check(not x["launches"], f"phase 11 (f) rank {r} launched "
                                 f"{x['launches']}")
    fgrid = merge_families([x["grid"] for x in f])
    fspec = merge_families([x["spec"] for x in f])
    # the mean wind against its wind field's largest |value| (phase 10):
    # meanu against u's (family 2), meanv against v's (family 3)
    fspec = fspec[:3] + [[dd, fgrid[k][1], bb]
                         for (dd, _, bb), k in zip(fspec[3:], (2, 3))]
    f_share = max(worst_share(fgrid, MESH_GATE), worst_share(fspec,
                                                             MESH_GATE))
    check(f_share <= 1.0, f"phase 11 (f) LAM against phase 10: "
                          f"{f_share:.3f} of 100 eps")
    print(f"phase 11 (f) LAM {cfg['lam']['nx']} x {cfg['lam']['ny']} on "
          f"2 x 2 ({LAM_NUV} vor/div pairs, {LAM_NSC} scalars, every flag): "
          f"against phase 10 {f_share:.3f} of 100 eps (grid bit-identical "
          f"{all(b for _, _, b in fgrid)}, spectra "
          f"{all(b for _, _, b in fspec)}); first calls inverse "
          f"{max(x['first_inv'] for x in f):.2f} s, direct "
          f"{max(x['first_dir'] for x in f):.2f} s; peak per rank "
          f"{[round(x['peak'], 2) for x in f]} GiB; no kernel; "
          f"{max(x['seconds'] for x in f):.1f} s")
    launches = {}
    merge_launches(launches, [x["launches"] for x in a])
    merge_launches(launches, [{"K4": x["launches"]["K4"]} for x in e])
    print(f"phase 11 done in {t_phase:.1f} s (the world {t_world:.1f} s); "
          f"launches of (a) and (e) over the ranks {launches}")
    return launches


# Phase 12: the programs of ``ectrans_tpu_torch.programs`` on the card.
# The global driver on bench.py's field set (-f 3 -l 2 with vor/div: 2
# vor/div pairs and 6 scalars, 26 grid fields), then the same in fp64, on a
# 2 x 2 mesh through the command line, and the LAM driver at phase 10's
# domain and field count.
PROGRAM_BENCH = ("-g", "TCO1279", "-f", "3", "-l", "2", "--vordiv",
                 "--scders", "--uvders", "-n", "5", "--check", "100",
                 "--meminfo")
PROGRAM_FP64 = ("--dtype", "float64", "-n", "2")   # (c): the last -n holds
PROGRAM_MESH = "2x2"
PROGRAM_MESH_LIMIT = 600     # s: (d)'s command, its ranks included
PROGRAM_LAM = ("--nlon", "1536", "--nlat", "1280", "--nlon-ci", "1440",
               "--nlat-ci", "1200", "--truncx", "767", "--truncy", "639",
               "--dx", "1300", "--dy", "1300", "-f", "10", "--vordiv",
               "--scders", "--uvders", "-n", "5", "--check", "100")
PROGRAMS = dict(bench=PROGRAM_BENCH, fp64=PROGRAM_FP64, mesh=PROGRAM_MESH,
                lam=PROGRAM_LAM, mesh_limit=PROGRAM_MESH_LIMIT)
ROOT = os.path.dirname(os.path.abspath(__file__))


def run_program(main, argv, tag: str) -> tuple:
    """main(argv) of a program in this process, its lines printed behind
    ``tag`` (also when it exits); returns (what main returned, its
    output)."""
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rep = main(list(argv))
    finally:
        for line in buf.getvalue().splitlines():
            print(f"  {tag} | {line}")
    return rep, buf.getvalue()


def run_command(argv, tag: str, limit: float) -> str:
    """A program as its own command (``python -m ...``, from the root of the
    checkout), in a process group of its own that is killed whole if it
    outlasts ``limit`` seconds; its lines printed behind ``tag``.  Fails
    unless it exits 0.  Returns its output."""
    import signal

    proc = subprocess.Popen([sys.executable, "-m", *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=limit)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        for line in out.splitlines():
            print(f"  {tag} | {line}")
        raise RuntimeError(f"{tag}: {' '.join(argv)} outlasted its "
                           f"{limit:.0f} s limit")
    for line in out.splitlines():
        print(f"  {tag} | {line}")
    check(proc.returncode == 0, f"{tag}: {' '.join(argv)} exited "
                                f"{proc.returncode}")
    return out


def checksum_norms(path: str) -> list:
    """The fp64 spectral norms of a --dump-checksums file, field by field."""
    with open(path) as f:
        return [float(line.split()[2]) for line in f]


def medians_ms(out: str) -> dict:
    """The median (ms) of each timed line of a driver's output."""
    meds = {}
    for line in out.splitlines():
        if " med " in line:
            name = line.split(" avg ")[0].strip()
            meds[name] = float(line.split(" med ")[1].split()[0])
    return meds


def _fresh(counters: dict) -> None:
    """Drop every cached Resolution and free the card's cache: the next run
    builds its tables (one K4 launch) and its peak is its own."""
    import ectrans_tpu_torch as ett

    ett.trans_end()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _zero(counters)


def program_line(key: str, what: str, rep: dict, out: str, peak: float,
                 launches: dict, secs: float) -> str:
    med = medians_ms(out)
    return (f"phase 12 ({key}) {what}: check OK (drift {rep['drift']:.3e}); "
            f"first call (the warm-up iteration) {rep['first']:.2f} s; "
            f"medians (n {len(rep['t_rt'])}) "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in med.items())
            + f"; throughput {rep['throughput']:.3e} gridpoints*fields/s; "
            f"peak {peak:.2f} GiB; launches {launches}; {secs:.1f} s")


def phase_programs(dev: torch.device, counters: dict,
                   cfg: dict = PROGRAMS) -> dict:
    """Phase 12: (a) ``info``; (b) the global driver at TCO1279 in fp32,
    in this process through ``main(argv)``: its check OK, K1 and K2 16
    times a transform (once an m-group), K3 once a direct transform, K4
    once (the setup); (c) the same in fp64 (K1 and K2 in their fp64
    variant); (d) ``--mesh 2x2`` as a command (4 ranks on the card over
    gloo, ``programs/world.py``): its check OK and each field's norm within
    100 eps(fp32) niter of (b)'s; (e) the LAM driver at the 1.3 km domain:
    its check OK, no kernel.  Returns (b)'s and (c)'s launches."""
    import shutil
    import tempfile

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.programs import benchmark, info, lam_benchmark

    t_phase = time.perf_counter()
    device = ("--device", dev.type)
    _fresh(counters)
    _, out = run_program(lambda argv: info.main(), (), "12(a)")
    name = (torch.cuda.get_device_name(0) if dev.type == "cuda"
            else "no CUDA device")
    check(f"device: {name}" in out, f"info names no {name!r}")
    print(f"phase 12 (a) info: names the card ({name})")
    args = benchmark.parse_args(list(cfg["bench"]))
    groups = len(ett.setup(args.grid, args.truncation).legendre_groups())
    total = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_programs_")
    try:
        norms = {}
        for key, extra, what in (
                ("b", (), f"benchmark {args.grid} fp32"),
                ("c", cfg["fp64"], f"benchmark {args.grid} fp64 (K1, K2 "
                                   "in their fp64 variant)")):
            _fresh(counters)
            path = os.path.join(tmp, f"{key}.sum")
            t0 = time.perf_counter()
            rep, out = run_program(benchmark.main, cfg["bench"] + extra
                                   + device + ("--dump-checksums", path),
                                   f"12({key})")
            secs = time.perf_counter() - t0
            calls = len(rep["t_rt"]) + 1
            launches = {k: c.launches for k, c in counters.items()
                        if c.launches}
            want = {"K1": groups * calls, "K2": groups * calls, "K3": calls,
                    "K4": 1}
            check("-> OK" in out, f"phase 12 ({key}): the check failed")
            check(launches == want, f"phase 12 ({key}) launched {launches}; "
                                    f"expected {want}")
            merge_launches(total, [launches])
            norms[key] = checksum_norms(path)
            peak = _peak(dev)
            print(program_line(key, what, rep, out, peak, launches, secs))
        _fresh(counters)
        path = os.path.join(tmp, "d.sum")
        t0 = time.perf_counter()
        out = run_command(("ectrans_tpu_torch.programs.benchmark",
                           *cfg["bench"], "--mesh", cfg["mesh"], *device,
                           "--dump-checksums", path), "12(d)",
                          cfg["mesh_limit"])
        secs = time.perf_counter() - t0
        check("-> OK" in out, "phase 12 (d): the mesh's check failed")
        tol = 100 * EPS32 * args.niter
        worst = max(abs(a - b) / b for a, b in zip(checksum_norms(path),
                                                   norms["b"]))
        check(len(checksum_norms(path)) == len(norms["b"]) and worst <= tol,
              f"phase 12 (d): a field's norm {worst:.3e} from (b)'s "
              f"(at most {tol:.3e})")
        med = medians_ms(out)
        print(f"phase 12 (d) benchmark --mesh {cfg['mesh']} as a command "
              f"(4 ranks on one card, gloo, host-staged: a check's times): "
              f"check OK; norms against (b) at most {worst:.3e} relative "
              f"(at most 100 eps niter {tol:.3e}); medians "
              + ", ".join(f"{k} {v:.1f} ms" for k, v in med.items())
              + f" (slowest rank); {secs:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _fresh(counters)
    t0 = time.perf_counter()
    rep, out = run_program(lam_benchmark.main, cfg["lam"] + device, "12(e)")
    secs = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    check("-> OK" in out and not launches,
          f"phase 12 (e): check {'OK' if '-> OK' in out else 'FAILED'}, "
          f"launched {launches}")
    lam = lam_benchmark.parse_args(list(cfg["lam"]))
    print(program_line("e", f"lam_benchmark {lam.nlon} x {lam.nlat} at dx "
                            f"{lam.dx:g} m fp32", rep, out, _peak(dev),
                       launches, secs))
    _fresh(counters)
    print(f"phase 12 done in {time.perf_counter() - t_phase:.1f} s; "
          f"launches of (b) and (c) {total}")
    return total


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import ectrans_tpu_torch as ett

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    t_run = time.perf_counter()
    phase_build()
    kern = phase_kernels(dev)
    ett.trans_end()      # phase 4 times a setup of its own
    gc.collect()
    torch.cuda.empty_cache()
    phase_small(dev)
    counters = launch_counters()
    res, sp, launches, dense = phase_bench(dev, counters)
    packed = phase_engines(dev, res, sp, counters, launches)
    bench_out = dense.pop("outputs")
    for k, n in phase_handle(dev, res, sp, bench_out, counters).items():
        launches[k] += n
    del res, sp
    ab_report(kern, dense, packed)
    launches.update(phase_roofline(dev, counters))
    phase_tco639(dev, counters)
    ll = phase_latlon(dev, counters)
    launches["K4"] += ll["K4"]
    lam_out = phase_lam(dev, counters)
    merge_launches(launches, [phase_mesh(dev, dict(
        a_grid=bench_out[0], a_spec=bench_out[1], e_grid=ll["grid"],
        f_grid=lam_out["grid"], f_spec=lam_out["spec"]))])
    merge_launches(launches, [phase_programs(dev, counters)])
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_run:.1f}"
          " s")
    print(json.dumps({"kernels": [
        dict(KERNELS[k], launches=launches[k],
             **{f: kern[k][f] for f in ("max_abs_err", "ms", "plain_ms",
                                        "bound_ms", "bound_by", "library_ms",
                                        "yardstick_ms") if f in kern[k]})
        for k in sorted(KERNELS, key=lambda k: int(k[1:]))]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
