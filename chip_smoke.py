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
cache to 16,384 plans: phase 13's per-NLOEN layer plans 1,280 lengths a
field count (the bucketed layer of every other phase a dozen).  Then the
DENSE_PACK A/B line: K7 + K8 against K1 + K2
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

13. the Fourier layer: (a) the bucketed chirp-z layer (every phase's) and
   the per-NLOEN one (``_fourier="rows"``) on phase 4's Fourier tensors,
   the 26-field synthesis input (caught by the inverse's fspgl_proc hook)
   and its output grid, each direction, in turns: first call (planning),
   median of 5 (host clock to synchronize), the device time of one call
   from ``torch.profiler`` and the peak; the two layers within 100
   eps(fp32) of each field's largest |value| of each other and of the
   per-NLOEN layer in fp64 on the CPU; (b) phase 4's round trip on each
   layer: a warm-up (its share of the 100 eps gate, with the (field, m,
   n) of each family's largest error and the median error), the median of
   3 in turns, and one steady round trip under the profiler: the device
   busy share (the union of the device intervals over the wall time); (d)
   the same error tail on the bucketed layer for the round trip, its
   inverse alone (through an fp64 direct transform) and its direct
   transform alone (of the fp64 inverse's grid rounded to fp32); (c) the
   IFS-layout driver
   (``benchmark_ifs``) at TCO1279 ``-l 137 --npromatr 8 -n 3 --check
   100``, fp32, in this process through ``main(argv)``: 18 packets a
   direction an iteration, of 8 vor/div pairs and 17 scalars, 8 and 16,
   and 1 and 2; its check OK, K1 and K2 16 times a transform, K3 once a
   direct transform, K4 once (first call, median, throughput, peak); (e)
   (printed after (a)) the chirp-z kernels at the step's largest calls, 83
   fields through synthesis and 32 through analysis: the staged kernels
   F1-F4 (``csrc/fourier_chirp.cu``), the yardstick, each against its
   plain stage (fp64 arrays within 1e-12 of the largest |value|, outputs
   within 2 fp32 ulps of each field's), both timed by CUDA events summed
   over the buckets, the FFTs beside them, each kernel's bound (its bytes
   over 3.35 TB/s) and its launches in one call of the layer with every
   bucket staged, which must be 5 a bucket and one F4 launch; F5, the
   fused pass (``csrc/fourier_fused.cu``), against the staged kernels
   (2 fp32 ulps), timed a bucket beside the staged stages' sum, with each
   bucket's shared memory and fp64 rate and its bound by bytes and fp64
   operations; one call of the layer launches F4 once and F5 once a bucket
   (every bucket of TCO1279 fits a block), with no ``torch.fft`` call.

14. the ectrans4py and C surfaces (``compat4py``, ``capi_bridge`` and the
   port's shim ``capi/ectrans_tpu_torch_capi.c``), after ``trans_end``:
   (a) one fp64 field through ``sp2gp_gauss4py`` (LGRADIENT, LREORDER) on
   O1280's KLOEN at KTRUNC 1279 and back through ``gp2sp_gauss4py``: bit
   for bit the module path (``inv_trans``/``dir_trans`` in fp64 on the
   card, the reduced packing and the FA order around them), each field's
   spectral-norm drift within 100 eps(fp64) (the drivers' fp64 check; the
   largest coefficient error is printed, the reduced grid's aliasing puts
   it far above 100 eps), K1 and K2 16 times, K3 and K4 once (first call,
   median of 3, peak); (b) ``sp2gp_lam4py``/``gp2sp_lam4py`` on phase
   10's domain in fp64, bit for bit ``inv_trans_lam``/``dir_trans_lam``,
   no kernel; (c) ``get_legendre_assets`` at TCO639 with every column
   (640 x 205,760, ~1 GB), built and read back bit for bit through a
   legpol cache in a temporary directory, within 1e-11 of the card's fp64
   tables (K4), and ``sp2gp_fft1d4py`` against numpy's cos/sin sums
   (1e-12); (d) the C API: the unchanged ``src/capi/test_capi.c`` linked
   to the shim and run on the card ("C API test OK"), then the shim in
   this process (ctypes): ``ectrans_tpu_setup("TCO1279", -1)``, bench.py's
   fields through ``invtrans_full`` and ``dirtrans_full`` in fp64 bit for
   bit the module path, and the ``_f`` entries on the 6 scalars bit for
   bit the module path in fp32 and within 0.65 of the 100 eps gate, each
   with K1 and K2 16 times, K3 and K4 once.

15. the host tables and the table knobs, after ``trans_end``: (a) the
   native Legendre builder (``native/``): its g++ build time, its fp64
   tables at TCO639 against the numpy recurrence's
   (``ECTRANS_TPU_DISABLE_NATIVE``; 1e-12 of the largest |value|, both
   timed), its fp32 tables at TCO1279 (2 x 1280 x 1280 x 641 x 4 B, the
   build timed) against K4's fp32 tables group by group (1e-7 of the
   largest |value|); (b) phase 4's round trip under
   ``ECTRANS_TPU_TABLE_SOURCE=host`` (the host tables built and copied up
   a group at a time in the setup): K4 0, K1 and K2 16, K3 1, the gate
   share beside phase 4's and held to 1.0, grid and spectra within 100 eps
   of each family's max of phase 4's; (c) the same at
   ``ECTRANS_TPU_LEG_GROUPS`` 8 and 40 (``TABLE_GROUPS``; 40 is past K3's
   and K4's 16 by-value groups): K1 and K2 a launch a group, K3 and K4
   once, the tables' GiB against the default groups'; (b) and (c) print
   setup, first call, median of 3, the device time and busy share of one
   steady round trip (``torch.profiler``) and peak; (d) ``entry.entry()`` on the
   card against the same step on the CPU (100 eps of each family's max,
   K1-K4 launched), then ``entry.dryrun_multichip(4)`` on four gloo ranks
   sharing the card.  Phase 2 also holds K3 and K4 at 40 groups against
   their plain versions (their line after the redesign lines, beside the
   16-group times).

Every phase runs the bucketed chirp-z Fourier layer of ``ops/fourier.py``
but phase 13's per-NLOEN rows.  Each prints its times, peak memory and
seconds.  Then one JSON line with the kernels (K1-K4's launches: phase
4's and phase 8's (a) and (b), K4's of
phase 9, phase 11's (a) and (e) summed over its ranks, phase 12's (b)
and (c), phase 13's (c), phase 14's (a) and (d) and phase 15's (b)-(d)),
and last the line
{"ok": true, "device": {...}}.  Any failure raises and exits non-zero; with
no CUDA device it exits 2 before doing anything.  TF32 is off for every
matmul and convolution (the plain Legendre versions use torch.bmm).
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import math
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
# ECTRANS_TPU_LEG_GROUPS of phase 15 (c) at TCO1279 (8 and 40 groups; the
# last past K3's and K4's 16 by-value groups, also held in phase 2)
TABLE_GROUPS = (8, 40)


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


def chirp_counters() -> dict:
    """The Fourier layer's counters, kept apart from ``KERNELS``' (its
    kernels replace no Pallas kernel): the launches of F1, F3, F4 and F5 by
    direction (s: synthesis, a: analysis) and of F2, and the ``torch.fft``
    calls (each may run several cuFFT kernels)."""
    from ectrans_tpu_torch.ops import fourier as fz

    return {"F4s": fz.sums_synthesis, "F1s": fz.pre_synthesis,
            "F3s": fz.post_synthesis, "F4a": fz.sums_analysis,
            "F1a": fz.pre_analysis, "F3a": fz.post_analysis,
            "F2": fz.chirp_product, "FFT": fz.chirp_fft,
            "F5s": fz.pass_synthesis, "F5a": fz.pass_analysis}


def _chirp_attr(key: str) -> str:
    return "calls" if key == "FFT" else "launches"


def chirp_zero(fc: dict) -> None:
    for k, f in fc.items():
        setattr(f, _chirp_attr(k), 0)


def chirp_counts(fc: dict) -> dict:
    return {k: getattr(f, _chirp_attr(k)) for k, f in fc.items()}


def chirp_want(fused: int, staged: int, syn_calls: int,
               ana_calls: int) -> dict:
    """``chirp_counters``' counts after syn_calls synthesis and ana_calls
    analysis calls of the layer, each normalized, on ``fused`` buckets that
    run F5 and ``staged`` buckets whose pairs run in one chunk: F4 once a
    call, F5 once a fused bucket, F1, F2 and F3 once and the FFT twice a
    staged bucket."""
    both = syn_calls + ana_calls
    return {"F4s": syn_calls, "F1s": staged * syn_calls,
            "F3s": staged * syn_calls, "F4a": ana_calls,
            "F1a": staged * ana_calls, "F3a": staged * ana_calls,
            "F2": staged * both, "FFT": 2 * staged * both,
            "F5s": fused * syn_calls, "F5a": fused * ana_calls}


# an H100 block's opt-in shared memory (bytes): F5's limit where the lines
# are made on the CPU, which has no blocks
H100_BLOCK_SMEM = 227 * 1024


def fits_block(dev: torch.device, nfft: int) -> bool:
    """Whether a bucket of convolution length nfft runs F5 on dev's card
    (``fourier.fuses`` under ``fourier.smem_limit``; an H100's limit on
    the CPU)."""
    from ectrans_tpu_torch.ops import fourier as fz

    limit = fz.smem_limit(dev) if dev.type == "cuda" else H100_BLOCK_SMEM
    return fz.fuses(nfft, limit)


def bucket_split(res, dev: torch.device) -> tuple:
    """(fused, staged): how many buckets of res's tables run F5 on a card
    (``fits_block``) and how many the staged kernels."""
    from ectrans_tpu_torch.ops import fourier as fz

    bt = fz.bucketed_tables(res, dev)
    fused = sum(fits_block(dev, bk.nfft) for bk in bt.buckets)
    return fused, len(bt.buckets) - fused


@contextlib.contextmanager
def patched(obj, attr: str, value):
    """Set obj.attr to value for the duration of a block."""
    old = getattr(obj, attr)
    setattr(obj, attr, value)
    try:
        yield
    finally:
        setattr(obj, attr, old)


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
        if plain_reps:
            t_p += cuda_ms(lambda: plain(*args), plain_reps)
        if spin:
            d, h = spin_ms(lambda: kern(*args), reps)
            t_dev += d
            t_host += h / len(args_list)
    if tol == 0:
        check(exact, f"{key} vs plain: not bit-exact")
    else:
        check(rel <= tol, f"{key} vs plain: {rel:.3e} > {tol:g} relative")
    return dict(max_abs_err=err, rel=rel, exact=exact, ms=t_k,
                plain_ms=t_p if plain_reps else None,
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
    (its table type; K3's and K4's "array" variants, template argument
    DEV, find their groups in a device array), or for K9 and K10 its plane
    count (template argument <P>)."""
    if needle + "ILi3E" in name:
        return "3 planes"
    if needle + "ILi1E" in name:
        return "1 plane"
    kind = ("bf16" if "bfloat16" in name else
            "fp64" if needle + "Id" in name else "fp32")
    return kind + (" array" if "Lb1E" in name else "")

# the kernels whose library line is a yardstick, not the same inputs: one
# torch.bmm on fp32 operands whose limbs and planes were summed beforehand
YARDSTICKS = ("K9", "K10")
# the kernels redesigned for the card: mangled-name needle in build.log, the
# variants compiled, and the kernel whose torch.bmm on the stacked rows is
# the line's yardstick (its own library call, or K7's and K8's for K1 and K2:
# the same outputs at twice the FLOP, a reference only; None: no one call)
REDESIGNED = {"K1": ("k116inv_dense_kernel", ("fp32", "bf16"), "K7"),
              "K2": ("k216dir_dense_kernel", ("fp32", "bf16"), "K8"),
              "K3": ("14k3_pack_kernel", ("fp32", "fp64", "fp32 array",
                                          "fp64 array"), "K3"),
              "K4": ("18k4_tablegen_kernel", ("fp32", "fp64", "bf16",
                                              "fp32 array", "fp64 array",
                                              "bf16 array"), None),
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


def hold_k4(res, dev: torch.device, ngroups: int | None = None) -> dict:
    """K4 at TCO1279: every group in one launch, held against the plain fp64
    recurrence (1e-7 of the table scale; bit identity reported), on fp32
    tables and, at the default groups, on the "bf16" tier's (which must be
    the fp32 table rounded to nearest even, bit for bit); times on the
    table measure (2-call means; plain: 1 call) and behind a spin kernel;
    its bound counts the tables written and the inputs read
    (``k4_input_bytes``) against the fp64-pipe slots of its loop.
    ``ngroups`` past 16 takes the kernel's device-array descriptors."""
    from ectrans_tpu_torch.ops import legendre_tablegen as tg

    groups = res.legendre_groups(ngroups)
    inp = tg._device_inputs(res, dev)
    f32, bf16 = torch.float32, torch.bfloat16
    n = sum((m1 - m0) * J * (res.ndgnh - i0) for m0, m1, i0, J in groups)
    in_bytes = k4_input_bytes(groups, res.ndgnh)
    k = hold("K4", lambda: tg.gen_groups(inp, groups, f32),
             lambda: [tg.gen_group_plain(inp, m0, m1, J, i0, f32)
                      for m0, m1, i0, J in groups],
             [()], tol=1e-7, flop=lambda: n * k4_slots(f32), rate=FP64_INSTR,
             nbytes=lambda args, got: tensor_bytes(got) + in_bytes, spin=True,
             reps=2, plain_reps=0 if ngroups else 1)
    if ngroups is not None:
        k.update(what=f"fp32 tables, {len(groups)} groups, one launch",
                 shapes=[tg.gen_groups_shape(
                     tg.launch_plan(groups, res.ndgnh)[1])])
        return k
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


def hold_k3(res, dev: torch.device, gen: torch.Generator,
            ngroups: int | None = None) -> dict:
    """K3 at TCO1279 with bench.py's 10 output fields (vor, div x2, 6
    scalars), all groups in one launch, bit-exact against the index gather;
    times on the table measure (3-call means) and behind a spin kernel; its
    bound counts each packed value read once and written once (the rows
    past an m's last degree are never read).  ``ngroups`` past 16 takes
    the kernel's device-array descriptors."""
    from ectrans_tpu_torch.ops import pack

    nfld = 2 * NFLD_UV + NFLD_SC
    rows = [torch.randn(m1 - m0, 2 * nfld, J, generator=gen, device=dev)
            for m0, m1, i0, J in res.legendre_groups(ngroups)]
    k = hold("K3", lambda r: pack.packed_from_group_rows(r, res, ngroups),
             lambda r: pack.packed_from_group_rows_plain(r, res, ngroups),
             [(rows,)], tol=0,
             nbytes=lambda args, got: 2 * tensor_bytes(got), spin=True,
             library=(lambda r: k3_library(r, res, ngroups), torch.take))
    k.update(what=f"fp32, {nfld} fields, {len(rows)} groups, one launch, a "
                  f"warp a field row of an m",
             shapes=[pack.packed_from_group_rows_shape(nfld, res.nsmax)],
             moved=("moves", 2 * 4 * nfld * res.nspec2))
    return k


def k3_library(rows: list, res, ngroups: int | None = None) -> tuple:
    """K3's one-call counterpart's operands: the groups' rows concatenated
    into one flat tensor, and the (nfld, nspec2) index of each packed
    value in it (both made before the timing), for one ``torch.take``."""
    from ectrans_tpu_torch.ops import pack

    nfld = rows[0].shape[1] // 2
    f = np.arange(nfld)[:, None]
    idx, off = [], 0
    for r, (m0, _, seg0, seg1) in zip(rows, pack.segments(res, ngroups)):
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
    # K4 past 16 groups (ECTRANS_TPU_LEG_GROUPS): its descriptors in a
    # device array
    out["K4 g40"] = hold_k4(res, dev, TABLE_GROUPS[-1])

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
    out["K3 g40"] = hold_k3(res, dev, gen, TABLE_GROUPS[-1])

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
    print("phase 2 K3 and K4 past 16 groups (ECTRANS_TPU_LEG_GROUPS "
          f"{TABLE_GROUPS[-1]}: descriptors in a device array): " + "; ".join(
              f"{k} {out[k]['what']}: {out[k]['ms']:.3f} ms (16 groups "
              f"{out[k.split()[0]]['ms']:.3f}), device "
              f"{out[k]['spin_ms']:.3f} ms (16 groups "
              f"{out[k.split()[0]]['spin_ms']:.3f}), host "
              f"{out[k]['host_ms'] * 1e3:.0f} us a call, bound "
              f"{out[k]['bound_ms']:.4f} ms ({out[k]['bound_by']}), "
              f"{'bit-exact' if out[k]['exact'] else 'err ' + format(out[k]['rel'], '.2e')}"
              for k in ("K3 g40", "K4 g40")))
    print("phase 2 kernels vs plain (TCO1279 shapes): " + "; ".join(
        f"{k} err {v['max_abs_err']:.3e} ({v['tol']}) {v['ms']:.3f} ms vs "
        + ("plain not timed" if v["plain_ms"] is None
           else f"plain {v['plain_ms']:.3f} ms")
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


def round_trip(res, sp, dtype, engine="dense", precision="highest",
               layer="buckets"):
    """bench.py's round trip; ``layer``: the Fourier layer ("buckets", the
    main path's, or "rows", the per-NLOEN one of phase 13's A/B)."""
    import ectrans_tpu_torch as ett

    kw = dict(dtype=dtype, precision=precision, _engine=engine,
              _fourier=layer)
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
    # one launch; K3 packs the direct transform in one; the Fourier
    # layer's counts are set to 0 here and held to one call a direction
    fc = chirp_counters()
    chirp_zero(fc)
    grid, out, t_first, launches = drive(res, sp, counters,
                                         ("K1", "K2", "K3", "K4"),
                                         reset=False, once=("K3", "K4"))
    fourier = chirp_counts(fc)
    expect_launches(dev, fourier, chirp_want(*bucket_split(res, dev), 1, 1),
                    "round trip's Fourier layer", 4)
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
          f"Fourier layer {fourier}; cuFFT plans cached {torch.backends.cuda.cufft_plan_cache[dev.index].size}")
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
# cuFFT plans cached: the per-NLOEN layer of phase 13 takes 1,280 at
# TCO1279 a field count and direction (the bucketed layer 12)
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


def run_command(argv, tag: str, limit: float, env=None,
                module: bool = True) -> str:
    """A program as its own command (``python -m ...``, or argv itself
    when not ``module``, from the root of the checkout, in ``env`` if
    given), in a process group of its own that is killed whole if it
    outlasts ``limit`` seconds; its lines printed behind ``tag``.  Fails
    unless it exits 0.  Returns its output."""
    import signal

    cmd = [sys.executable, "-m", *argv] if module else list(argv)
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
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


# phase 13: the Fourier layers' A/B on phase 4's tensors, the device busy
# share of phase 4's round trip on each layer, and the IFS-layout driver
FOURIER_REPS = 5
FOURIER_GATE = 100 * EPS32       # of each field's largest |value|
PROGRAM_IFS = ("-g", "TCO1279", "-l", "137", "--npromatr", "8", "-n", "3",
               "--check", "100")


def kernel_spans(prof) -> list:
    """The (start, end) ms of every device activity (kernels, copies,
    sets) a ``torch.profiler`` run recorded."""
    cuda = torch.autograd.DeviceType.CUDA
    spans = []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                spans.append((e.start_ns() / 1e6,
                              (e.start_ns() + e.duration_ns()) / 1e6))
    except AttributeError:
        for e in prof.events():
            if e.device_type == cuda:
                spans.append((e.time_range.start / 1e3,
                              e.time_range.end / 1e3))
    return spans


def union_ms(spans) -> float:
    """The length of the union of intervals (ms)."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def device_profile(dev: torch.device, fn) -> dict:
    """One call of fn() under ``torch.profiler`` (device activities only):
    its wall ms (host clock to synchronize), the summed device ms, the
    union of the device intervals (busy ms) and their count."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    # device activities only where the build records them (a CPU build
    # records host ones, so no device interval)
    acts = ([ProfilerActivity.CUDA]
            if ProfilerActivity.CUDA in supported_activities()
            else [ProfilerActivity.CPU])
    _sync(dev)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        wall = (time.perf_counter() - t0) * 1e3
    spans = kernel_spans(prof)
    return dict(wall_ms=wall, device_ms=sum(b - a for a, b in spans),
                busy_ms=union_ms(spans), n=len(spans))


def device_activities(dev: torch.device, fn) -> list:
    """The names of the device activities (kernels, copies, sets) of one
    call of fn() under ``torch.profiler``; none where the build records no
    device work."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    if ProfilerActivity.CUDA not in supported_activities():
        fn()
        return []
    _sync(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        _sync(dev)
    cuda = torch.autograd.DeviceType.CUDA
    try:
        return [e.name() for e in prof.profiler.kineto_results.events()
                if e.device_type() == cuda]
    except AttributeError:
        return [e.name for e in prof.events() if e.device_type == cuda]


def field_share(got, want, gate: float = FOURIER_GATE) -> float:
    """The largest error of a field against ``want`` as a share of gate *
    that field's largest |value| of want."""
    d = (got.double().cpu() - want.double().cpu()).flatten(1).abs().amax(1)
    s = want.double().cpu().flatten(1).abs().amax(1)
    return float((d / (gate * torch.where(s > 0, s, 1.0))).max())


def profile_note(p: dict) -> str:
    if not p["n"]:
        return "device time not measured (the profiler saw no device work)"
    return (f"device {p['device_ms']:.2f} ms in {p['n']} activities, busy "
            f"{p['busy_ms']:.2f} of {p['wall_ms']:.2f} ms profiled")


def fourier_inputs(dev: torch.device, name: str = "TCO1279"):
    """Phase 4's Fourier tensors: the inverse's synthesis input (26, 2, M,
    ndgl), caught by its fspgl_proc hook, and its output grid (26, ndgl,
    ndlon); with the Resolution and the spectra."""
    import ectrans_tpu_torch as ett

    res = ett.setup(name)
    sp = [x.to(dev) for x in bench_inputs(res.nspec2, res.nsmax)]
    box = {}

    def hook(four):
        box["four"] = four
        return four

    grid = ett.inv_trans(res, *sp, flags=ett.InvFlags(scders=True,
                                                      uvders=True),
                         fspgl_proc=hook)
    return res, sp, box["four"], grid


def fourier_ab(dev: torch.device, res, four, grid) -> list:
    """Phase 13 (a): each direction on each layer, in turns: first call
    (planning), median of FOURIER_REPS, the profiler's device time and the
    peak; the layers within 100 eps(fp32) of each field's max of each
    other and of the per-NLOEN layer in fp64 on the CPU."""
    from ectrans_tpu_torch import transform
    from ectrans_tpu_torch.transform import FOURIER_LAYERS

    calls = {
        "synthesis": lambda layer: transform.synthesis(four, res,
                                                       layer=layer),
        "analysis": lambda layer: transform.analysis(grid, res,
                                                     layer=layer)}
    refs = {"synthesis": lambda: transform.synthesis(
                four.double().cpu(), res, layer="rows"),
            "analysis": lambda: transform.analysis(
                grid.double().cpu(), res, layer="rows")}
    lines = []
    for way, call in calls.items():
        rep, outs = {}, {}
        for layer in FOURIER_LAYERS:
            _sync(dev)
            _reset_peak(dev)
            base = (torch.cuda.memory_allocated(dev) / 2**30
                    if dev.type == "cuda" else 0.0)
            outs[layer], t_first = _timed(dev, lambda: call(layer))
            rep[layer] = dict(first=t_first, peak=_peak(dev) - base,
                              times=[])
        for _ in range(FOURIER_REPS):
            for layer in FOURIER_LAYERS:
                rep[layer]["times"].append(_timed(dev,
                                                  lambda: call(layer))[1])
        for layer in FOURIER_LAYERS:
            rep[layer]["prof"] = device_profile(dev, lambda: call(layer))
        t0 = time.perf_counter()
        ref = refs[way]()
        t_ref = time.perf_counter() - t0
        shares = dict(layers=field_share(outs["buckets"], outs["rows"]),
                      buckets=field_share(outs["buckets"], ref),
                      rows=field_share(outs["rows"], ref))
        check(all(np.isfinite(v) and v <= 1.0 for v in shares.values()),
              f"phase 13 (a) {way}: shares of 100 eps of each field's max "
              f"{shares}")
        for layer in FOURIER_LAYERS:
            r = rep[layer]
            med = statistics.median(r["times"]) * 1e3
            lines.append(
                f"phase 13 (a) {way} on {layer}: first call {r['first']:.3f}"
                f" s; median {med:.2f} ms (min {min(r['times'])*1e3:.2f}, "
                f"max {max(r['times'])*1e3:.2f}, n {FOURIER_REPS}); "
                f"{profile_note(r['prof'])}; peak +{r['peak']:.2f} GiB "
                f"over the inputs")
        lines.append(
            f"phase 13 (a) {way}: buckets vs rows {shares['layers']:.3f}, "
            f"buckets vs fp64 rows (CPU, {t_ref:.1f} s) "
            f"{shares['buckets']:.3f}, rows vs fp64 {shares['rows']:.3f} "
            f"of 100 eps(fp32) of each field's max (at most 1)")
        del outs, ref
    return lines


def tail(out, sp, res) -> str:
    """Each family's error as a share of the 100 eps gate: the largest,
    with the (field, m, n) where it sits, and the median over every
    97th coefficient ((m, n) = (0, 0) of vor/div left out)."""
    eps32 = float(np.finfo(np.float32).eps)
    pm, pn = res.packed_gather_m, res.packed_gather_n
    notes = []
    for name, got, ref in zip(("vor", "div", "scalars"), out, sp):
        d = (got.double() - ref.double()).abs()
        if name != "scalars":
            d[:, :2] = 0.0
        gate = 100 * eps32 * ref.abs().max().item()
        k = int(d.argmax())
        f, i = divmod(k, d.shape[1])
        med = d.flatten()[::97].median().item()
        notes.append(f"{name} {d.max().item() / gate:.3f} at field {f} "
                     f"(m {pm[i]}, n {pn[i]}), median {med / gate:.4f}")
    return "; ".join(notes)


def error_tail(dev: torch.device, res, sp) -> list:
    """Phase 13 (d): where phase 4's round-trip error sits (``tail``), and
    the same for its inverse alone (the fp32 grid through an fp64 direct
    transform) and its direct transform alone (the fp64 inverse's grid
    rounded to fp32, through the fp32 direct transform), all on the
    bucketed layer ("dense"; fp64 in the kernels' fp64 variants)."""
    import ectrans_tpu_torch as ett

    nsc = NFLD_SC
    f64 = torch.float64

    def direct(grid, dtype):
        return ett.dir_trans(res, grid[:NFLD_UV], grid[NFLD_UV:2 * NFLD_UV],
                             grid[2 * NFLD_UV:2 * NFLD_UV + nsc], dtype=dtype)

    grid, out = round_trip(res, sp, torch.float32)
    g64 = ett.inv_trans(res, *[x.double() for x in sp], dtype=f64,
                        flags=ett.InvFlags(scders=True, uvders=True))
    rows = (("round trip", out),
            ("inverse alone (fp32 inverse, fp64 direct)",
             direct(grid.double(), f64)),
            ("direct alone (fp64 inverse rounded to fp32, fp32 direct)",
             direct(g64.float(), torch.float32)))
    return [f"phase 13 (d) {what}: {tail(o, sp, res)}" for what, o in rows]


def busy_shares(dev: torch.device, res, sp) -> list:
    """Phase 13 (b): one steady round trip of phase 4 on each layer under
    the profiler (after a warm one, which plans the layer's lengths):
    the union of the device intervals over the wall time; with the
    median of 3 round trips on each, in turns, and each layer's share of
    the 100 eps gate (``tail``)."""
    from ectrans_tpu_torch.transform import FOURIER_LAYERS

    lines, times = [], {layer: [] for layer in FOURIER_LAYERS}
    for layer in FOURIER_LAYERS:
        (_, out), t_warm = _timed(dev, lambda: round_trip(
            res, sp, torch.float32, layer=layer))
        lines.append(f"phase 13 (b) round trip on {layer}: warm-up "
                     f"{t_warm:.3f} s; share of the 100 eps gate: "
                     f"{tail(out, sp, res)}")
    for _ in range(3):
        for layer in FOURIER_LAYERS:
            times[layer].append(_timed(dev, lambda: round_trip(
                res, sp, torch.float32, layer=layer))[1])
    for layer in FOURIER_LAYERS:
        p = device_profile(dev, lambda: round_trip(res, sp, torch.float32,
                                                   layer=layer))
        med = statistics.median(times[layer]) * 1e3
        busy = (f"device busy share {p['busy_ms'] / p['wall_ms']:.3f} of "
                f"the profiled round trip ({p['busy_ms']:.2f} of "
                f"{p['wall_ms']:.2f} ms; {p['busy_ms'] / med:.3f} of the "
                f"median)" if p["n"] else
                "device busy share not measured (no device work profiled)")
        lines.append(f"phase 13 (b) round trip on {layer}: median {med:.1f}"
                     f" ms (n 3, in turns); {busy}; summed device "
                     f"{p['device_ms']:.2f} ms in {p['n']} activities")
    return lines


# phase 13 (e): the chirp-z kernels F1-F4 at the TCO1279 step's largest
# calls: 83 fields through synthesis (42 pairs), 32 through analysis (16)
CHIRP_STEP_FIELDS = dict(synthesis=83, analysis=32)
CHIRP_TOL = 1e-12        # kernel vs plain stage, fp64 intermediates
CHIRP_ULPS = 2           # kernel vs plain stage, outputs: fp32 ulps


def ulp_share(got, want) -> float:
    """The largest error of a field in units of one fp32 ulp of that
    field's largest |value| (0 where both are 0)."""
    d = (got.double() - want.double()).flatten(1).abs().amax(1).cpu()
    s = want.double().flatten(1).abs().amax(1).cpu().numpy()
    ulp = torch.from_numpy(np.spacing(s.astype(np.float32)).astype(
        np.float64))
    return float((d / torch.where(ulp > 0, ulp, 1.0)).max())


def chirp_bytes(bt, bk, way: str, nfld: int, item: int, M: int) -> dict:
    """Bytes each stage of bucket bk moves for nfld fields of ``item``
    bytes: each input read once, each output written once (F1: the values
    it reads, its table, the pass array; FFT: the forward and the inverse
    FFT, each the array read and written; F2: the array twice and the
    kernel FFT; F3: the points it reads of the array, its table, its
    output rows)."""
    npairs = (nfld + 1) // 2
    nrows, nfft, mb = bk.rows.shape[1], bk.nfft, bk.mb
    arr = npairs * nrows * nfft * 16
    rows = bk.rows[0].cpu().numpy()
    lens = bk.rows[1].cpu().numpy()
    if way == "synthesis":
        me = np.minimum(bt.mkeep.cpu().numpy()[rows], mb)
        read = int(np.where(me >= 0, 2 * me + 1, 0).sum()) * nfld * item
        pre = read + bk.syn_in.numel() * 16 + arr
        post = (npairs * nrows * bk.ndlon * 16 + bk.syn_out.numel() * 16
                + nfld * nrows * bt.ndlon * item)
    else:
        K = min(M, mb + 1)
        pre = int(lens.sum()) * nfld * item + bk.ana_in.numel() * 16 + arr
        post = (npairs * nrows * (2 * K - 1) * 16 + bk.ana_out.numel() * 16
                + nfld * 2 * M * nrows * item)
    return dict(F1=pre, FFT=4 * arr, F2=2 * arr + bk.syn_bh.numel() * 16,
                F3=post)


def fused_bytes(bt, bk, way: str, nfld: int, item: int, M: int) -> int:
    """Bytes F5 moves for bucket bk: F1's and F3's reads and writes of the
    inputs, the tables and the outputs (``chirp_bytes`` without the pass
    array) and the kernel FFT once (the pairs of a row share it)."""
    npairs = (nfld + 1) // 2
    staged = chirp_bytes(bt, bk, way, nfld, item, M)
    arr = npairs * bk.rows.shape[1] * bk.nfft * 16
    if way == "synthesis":
        inner = npairs * bk.rows.shape[1] * bk.ndlon * 16
    else:
        inner = npairs * bk.rows.shape[1] * (2 * min(M, bk.mb + 1) - 1) * 16
    return (staged["F1"] - arr + staged["F3"] - inner
            + bk.syn_bh.numel() * 16)


def fused_flop(bk, nfld: int) -> float:
    """F5's fp64 operations for bucket bk: two FFTs of nfft points a (row,
    pair) at the nominal 5 nfft log2 nfft each, and the kernel FFT's
    complex product (6 nfft)."""
    n = bk.nfft
    return ((nfld + 1) // 2 * bk.rows.shape[1]
            * (10 * n * math.log2(n) + 6 * n))


def chirp_kernels(dev: torch.device, name: str = "TCO1279",
                  fields=CHIRP_STEP_FIELDS) -> list:
    """Phase 13 (e): the chirp-z kernels at the step's shapes, each
    direction.  The staged kernels F1-F4, the yardstick: every kernel
    against its plain stage on the same inputs (fp64 arrays within
    CHIRP_TOL of the largest |value|, outputs within CHIRP_ULPS fp32 ulps
    of each field's), both timed by CUDA events (mean of 3 a bucket, summed
    over the buckets; the two FFTs of each bucket beside them), each
    kernel's bound (its bytes over 3.35 TB/s) and its counts in one staged
    call of the layer (every bucket staged: F1, F2 and F3 launches and two
    ``torch.fft`` calls a bucket, one F4 launch).  F5, the fused pass: its
    output against its plain version, the staged pass on the plain stages
    with the plain sums, bucket by bucket, and against the staged kernels'
    (each within CHIRP_ULPS), timed a bucket beside
    the staged stages' sum, with its shared memory, its bound (bytes and
    fp64 operations) and the fp64 rate it reached; one call of the layer
    launches F4 once and F5 once a bucket that fits (``fourier.fuses``),
    and the staged kernels on the others.  The device activities a
    profiled call of the layer runs."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import _build
    from ectrans_tpu_torch.ops import fourier as fz

    res = ett.setup(name)
    bt = fz.bucketed_tables(res, dev)
    nb = len(bt.buckets)
    nfused = sum(fits_block(dev, bk.nfft) for bk in bt.buckets)
    gen = torch.Generator(device=dev).manual_seed(23)
    inputs = dict(
        synthesis=torch.randn((fields["synthesis"], 2, res.M, res.ndgl),
                              generator=gen, device=dev),
        analysis=torch.randn((fields["analysis"], res.ndgl, res.grid.ndlon),
                             generator=gen, device=dev))
    stages = dict(
        synthesis=(fz.sums_synthesis, fz.sums_synthesis_plain,
                   fz.pre_synthesis, fz.pre_synthesis_plain,
                   fz.post_synthesis, fz.post_synthesis_plain,
                   fz.pass_synthesis, fz.staged_synthesis),
        analysis=(fz.sums_analysis, fz.sums_analysis_plain, fz.pre_analysis,
                  fz.pre_analysis_plain, fz.post_analysis,
                  fz.post_analysis_plain, fz.pass_analysis,
                  fz.staged_analysis))
    lines = []
    for way, x in inputs.items():
        sums, sums_p, pre, pre_p, post, post_p, fused, staged = stages[way]
        nfld, item = x.shape[0], x.element_size()
        npairs = (nfld + 1) // 2
        syn = way == "synthesis"
        d = way[0]
        call = ((lambda: fz.synthesis_bucketed(x, bt)) if syn else
                (lambda: fz.analysis_bucketed(x, bt, res.M)))

        def staged_call():
            with patched(fz, "_SMEM_LIMIT", 0):
                return call()

        fc = chirp_counters()
        runs = {}
        for kind, fn, want in (
                ("fused", call, chirp_want(nfused, nb - nfused, int(syn),
                                           int(not syn))),
                ("staged", staged_call, chirp_want(0, nb, int(syn),
                                                   int(not syn)))):
            fn()
            chirp_zero(fc)
            fn()
            counts = chirp_counts(fc)
            expect_launches(dev, counts, want, f"(e) {way} {kind}", 13)
            _sync(dev)
            acts = device_activities(dev, fn)
            runs[kind] = dict(counts=counts, ms=cuda_ms(fn), acts=len(acts),
                              ffts=sum("fft" in a.lower() for a in acts))
        counts = runs["staged"]["counts"]
        launches = dict(F4=counts["F4" + d], F1=counts["F1" + d],
                        FFT=counts["FFT"], F2=counts["F2"],
                        F3=counts["F3" + d])
        rep = {k: dict(ms=0.0, plain_ms=0.0, nbytes=0, err=0.0)
               for k in launches}
        ss = sums(x, bt)
        if syn:
            kept = int(bt.keep.sum()) * nfld * item
        else:
            kept = int(bt.nloen.sum()) * nfld * item
        rep["F4"].update(
            ms=cuda_ms(lambda: sums(x, bt)),
            plain_ms=cuda_ms(lambda: sums_p(x, bt)), nbytes=kept,
            err=compare("F4", ss.sum(-1), sums_p(x, bt).sum(-1))[0]
            / sums_p(x, bt).abs().max().item())
        out_k = x.new_empty((nfld, res.ndgl, res.grid.ndlon) if syn
                            else (nfld, 2, res.M, res.ndgl))
        out_p = torch.empty_like(out_k)
        out_f = torch.zeros_like(out_k)   # F5 analysis leaves m > mb
        per_bucket = []
        for ib, bk in enumerate(bt.buckets):
            extra = () if syn else (ib,)
            pre_args = (x, bt, bk, *extra, ss, 0, npairs)
            post_args = (bt, bk, *extra, ss)
            bh = bk.syn_bh if syn else bk.ana_bh
            nbytes = chirp_bytes(bt, bk, way, nfld, item, res.M)
            staged_ms = 0.0
            a = pre(*pre_args)
            d_, scale, _ = compare("F1", a, pre_p(*pre_args))
            rep["F1"]["err"] = max(rep["F1"]["err"], d_ / scale)
            t = cuda_ms(lambda: pre(*pre_args))
            rep["F1"]["ms"] += t
            staged_ms += t
            rep["F1"]["plain_ms"] += cuda_ms(lambda: pre_p(*pre_args))
            f = fz.chirp_fft(a)
            t = cuda_ms(lambda: fz.chirp_fft(a))
            rep["FFT"]["ms"] += t
            staged_ms += t
            del a
            g = f.clone()
            fz.chirp_product(g, bh)
            d_, scale, _ = compare("F2", g, f * bh)
            rep["F2"]["err"] = max(rep["F2"]["err"], d_ / scale)
            h = f.clone()            # timed in place: g stays F2's output
            t = cuda_ms(lambda: fz.chirp_product(h, bh))
            rep["F2"]["ms"] += t
            staged_ms += t
            rep["F2"]["plain_ms"] += cuda_ms(lambda: h.mul_(bh))
            del f, h
            b = fz.chirp_fft(g, inverse=True)
            t = cuda_ms(lambda: fz.chirp_fft(g, True))
            rep["FFT"]["ms"] += t
            staged_ms += t
            del g
            t = cuda_ms(lambda: post(b, *post_args, out_k, 0))
            rep["F3"]["ms"] += t
            staged_ms += t
            rep["F3"]["plain_ms"] += cuda_ms(
                lambda: post_p(b, *post_args, out_p, 0))
            del b
            for k, n in nbytes.items():
                rep[k]["nbytes"] += n
            fits = fits_block(dev, bk.nfft)
            whole = fused if fits else staged
            fused_ms = cuda_ms(lambda: whole(x, *post_args, out_f))
            per_bucket.append(dict(
                ib=ib, bk=bk, fused=fits, ms=fused_ms, staged_ms=staged_ms,
                nbytes=fused_bytes(bt, bk, way, nfld, item, res.M),
                flop=fused_flop(bk, nfld)))
        rep["F3"]["err"] = ulp_share(out_k, out_p)
        del out_p
        # F5's plain version: each bucket's staged pass on the plain stages
        out_p = torch.zeros_like(out_k)
        with patched(_build, "on_cpu", lambda t: True):
            ss_p = sums_p(x, bt)
            for ib, bk in enumerate(bt.buckets):
                staged(x, bt, bk, *(() if syn else (ib,)), ss_p, out_p)
        f5_plain = ulp_share(out_f, out_p)
        f5_err = ulp_share(out_f, out_k)
        check(all(rep[k]["err"] <= CHIRP_TOL for k in ("F4", "F1", "F2"))
              and rep["F3"]["err"] <= CHIRP_ULPS
              and max(f5_plain, f5_err) <= CHIRP_ULPS,
              f"phase 13 (e) {way}: kernels vs plain stages "
              f"{ {k: r['err'] for k, r in rep.items()} }, F5 vs the plain "
              f"pipeline {f5_plain}, vs the staged kernels {f5_err}")
        del out_k, out_p, out_f, ss, ss_p
        for k, r in rep.items():
            b = bound(0, r["nbytes"])
            plain = (f"plain {r['plain_ms']:.3f} ms" if r["plain_ms"]
                     else "cuFFT (no plain stage)")
            err = (f"{r['err']:.2f} fp32 ulps of each field's max" if k == "F3"
                   else f"{r['err']:.2e} of the largest |value|")
            count = (f"{launches[k]} torch.fft calls a staged call"
                     if k == "FFT" else f"launches {launches[k]} a staged "
                                        f"call")
            lines.append(
                f"phase 13 (e) {way} {k} ({nfld} fields, {npairs} pairs, "
                f"{nb} buckets): kernel {r['ms']:.3f} ms (CUDA events, mean "
                f"of 3 a bucket, summed); bound {b['bound_ms']:.3f} ms "
                f"({r['nbytes'] / 1e9:.3f} GB at 3.35 TB/s, "
                f"{b['bound_ms'] / max(r['ms'], 1e-9):.1%} of it); {plain}; "
                f"{count}; kernel vs plain {err}")
        f5 = {k: sum(p[k] for p in per_bucket)
              for k in ("ms", "staged_ms", "nbytes", "flop")}
        b = bound(f5["flop"], f5["nbytes"], FP64_FLOPS)
        lines.append(
            f"phase 13 (e) {way} F5 ({nfld} fields, {npairs} pairs, "
            f"{nb} buckets): kernel {f5['ms']:.3f} ms (CUDA events, mean of "
            f"3 a bucket, summed), staged stages {f5['staged_ms']:.3f} ms; "
            f"bound {b['bound_ms']:.3f} ms by {b['bound_by']} (bytes "
            f"{b['bytes_ms']:.3f} ms, {f5['nbytes'] / 1e9:.3f} GB; fp64 "
            f"{b['ops_ms']:.3f} ms, {f5['flop'] / 1e9:.1f} GFLOP at "
            f"{FP64_FLOPS / 1e12:.0f} TFLOP/s; {b['bound_ms'] / max(f5['ms'], 1e-9):.1%} "
            f"of it); launches {runs['fused']['counts']['F5' + d]} a call; "
            f"vs the plain pipeline {f5_plain:.2f}, vs the staged kernels "
            f"{f5_err:.2f} fp32 ulps of each field's max")
        for p in per_bucket:
            bk = p["bk"]
            rate = p["flop"] / max(p["ms"], 1e-9) / 1e9
            lines.append(
                f"phase 13 (e) {way} F5 bucket {p['ib']}: nfft {bk.nfft} "
                f"{'x'.join(map(str, bk.radices))}, "
                f"{bk.rows.shape[1]} rows, shared memory "
                f"{fz.fused_smem_bytes(bk.nfft)} B a block, "
                f"{'fused' if p['fused'] else 'staged in the layer'}"
                f"; {p['ms']:.3f} ms against staged {p['staged_ms']:.3f} ms "
                f"({p['staged_ms'] / max(p['ms'], 1e-9):.2f}x); fp64 "
                f"{rate:.2f} TFLOP/s ({rate * 1e12 / FP64_FLOPS:.1%} of "
                f"{FP64_FLOPS / 1e12:.0f})")
        fu, st = runs["fused"], runs["staged"]
        nk = sum(v for k, v in fu["counts"].items() if k != "FFT")
        nks = sum(v for k, v in st["counts"].items() if k != "FFT")
        lines.append(f"phase 13 (e) {way} layer: {fu['ms']:.3f} ms a call "
                     f"(CUDA events, mean of 3), {nk} launches and "
                     f"{fu['counts']['FFT']} torch.fft calls, {fu['acts']} "
                     f"device activities ({fu['ffts']} cuFFT's); every "
                     f"bucket staged {st['ms']:.3f} ms, {nks} launches and "
                     f"{st['counts']['FFT']} torch.fft calls (5 a bucket "
                     f"+ 1), {st['acts']} device activities ({st['ffts']} "
                     f"cuFFT's)")
    return lines


def phase_fourier(dev: torch.device, counters: dict, name: str = "TCO1279",
                  ifs=PROGRAM_IFS) -> dict:
    """Phase 13: (a) the Fourier layers' A/B on phase 4's tensors, (b) the
    device busy share of phase 4's round trip on each layer, (d) where
    its error sits (printed before (c)), (c) the
    IFS-layout driver at TCO1279 L137 in this process through
    ``main(argv)``: its check OK, K1 and K2 16 times a transform (once an
    m-group), K3 once a direct transform, K4 once.  Returns (c)'s
    launches."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.programs import benchmark_ifs

    t_phase = time.perf_counter()
    _fresh(counters)
    res, sp, four, grid = fourier_inputs(dev, name)
    for line in fourier_ab(dev, res, four, grid):
        print(line)
    del four, grid
    for line in chirp_kernels(dev, name):
        print(line)
    for line in busy_shares(dev, res, sp) + error_tail(dev, res, sp):
        print(line)
    del res, sp
    _fresh(counters)
    fc = chirp_counters()
    chirp_zero(fc)
    args = benchmark_ifs.parse_args(list(ifs))
    ifs_res = ett.setup(args.grid, args.truncation)
    groups = len(ifs_res.legendre_groups())
    t0 = time.perf_counter()
    rep, out = run_program(benchmark_ifs.main,
                           tuple(ifs) + ("--device", dev.type), "13(c)")
    secs = time.perf_counter() - t0
    calls = len(benchmark_ifs.packets(args.nlev, args.npromatr)) * (
        args.niter + 1)
    launches = {k: c.launches for k, c in counters.items() if c.launches}
    fourier = chirp_counts(fc)
    want = {"K1": groups * calls, "K2": groups * calls, "K3": calls,
            "K4": 1}
    check("-> OK" in out, "phase 13 (c): the IFS driver's check failed")
    check(launches == want, f"phase 13 (c) launched {launches}; expected "
                            f"{want}")
    expect_launches(dev, fourier, chirp_want(*bucket_split(ifs_res, dev),
                                             calls, calls),
                    "(c) Fourier layer", 13)
    med = statistics.median(rep["t_rt"]) * 1e3
    print(f"phase 13 (c) benchmark_ifs {args.grid} L{args.nlev} npromatr "
          f"{args.npromatr} fp32: check OK (drift {rep['drift']:.3e}); "
          f"{calls // (args.niter + 1)} packets a direction an iteration; "
          f"first call (the warm-up iteration) {rep['first']:.2f} s; "
          f"round trip median {med:.1f} ms (n {len(rep['t_rt'])}); "
          f"throughput {rep['throughput']:.3e} gridpoints*fields/s; peak "
          f"{_peak(dev):.2f} GiB; launches {launches}; Fourier layer "
          f"{fourier}; {secs:.1f} s")
    _fresh(counters)
    print(f"phase 13 done in {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 14: the ectrans4py and C surfaces (compat4py, capi_bridge and the
# port's C shim) on the card: (a) compat4py at TCO1279 on O1280's KLOEN,
# (b) on phase 10's LAM domain, (c) its host assets at TCO639 through the
# legpol cache, (d) the C API: test_capi.c at O48 and the shim in this
# process at TCO1279
EPS64 = float(np.finfo(np.float64).eps)
# (a)'s round trip: each field's spectral-norm drift, as the drivers'
# fp64 --check 100 holds it over one iteration; its largest coefficient
# error is printed in eps, not gated at 100 of them: the reduced grid's
# own aliasing puts it near 3e4-7e4 eps at n = nsmax (TCO95-TCO319 on the
# CPU's fp64), and plain fp64 sums near 900 eps on the full F160
SURFACE_NORM_GATE = 100 * EPS64
SURFACE_FFT_TOL = 1e-12      # (c)'s 1-D synthesis against numpy's sums
SURFACE_REPS = 3
SURFACES = dict(gauss=("TCO1279", None), lam=LAM_DOMAIN, assets="TCO639",
                capi="TCO1279", capi_limit=300)


def expect_launches(dev: torch.device, got: dict, want: dict,
                    tag: str, phase: int = 14) -> None:
    """A run's launches on the card must be want's (on the CPU the plain
    versions run, which count none)."""
    if dev.type == "cuda":
        check(got == want, f"phase {phase} {tag} launched {got}; expected "
                           f"{want}")


def fa_spectrum(ktrunc: int, seed: int = 0) -> np.ndarray:
    """One field in the FA file order: (ktrunc + 1)^2 values, seeded."""
    return np.random.default_rng(seed).standard_normal((ktrunc + 1) ** 2)


def eps_share(got, want) -> float:
    """max |got - want| in eps(fp64) of want's largest |value|."""
    return float(np.abs(got - want).max() / np.abs(want).max() / EPS64)


def gauss_round_trip(grid, fa, dev):
    """compat4py's sp2gp_gauss4py (LGRADIENT, LREORDER) and gp2sp_gauss4py
    of its grid, on grid's KLOEN: ((PGPT, PGPTM, PGPTL), FA spectrum)."""
    from ectrans_tpu_torch import compat4py as c4

    ks, T, kloen = grid.ndgl, grid.nsmax, np.asarray(grid.nloen)
    pg = c4.sp2gp_gauss4py(ks, T, 10, grid.ngptot, ks, kloen, fa.size, True,
                           True, fa, device=dev)
    return pg, c4.gp2sp_gauss4py(fa.size, ks, T, 10, ks, kloen, grid.ngptot,
                                 True, pg[0], device=dev)


def gauss_module(grid, fa, pgpt, dev):
    """The module path on (a)'s inputs: the packed inv_trans of fa (with
    N-S and E-W derivatives) and dir_trans of pgpt, in FA order, fp64; and
    the Resolution."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import compat4py as c4

    T = grid.nsmax
    res = ett.setup(c4._gauss_grid(grid.ndgl, T, grid.nloen))
    model = c4._reorder_fa_to_model(fa, T, res.nspec2)
    out = ett.inv_trans(res, spscalar=torch.tensor(model[None], device=dev),
                        flags=ett.InvFlags(scders=True), dtype=torch.float64)
    packed = c4._pack_reduced(out, grid.nloen).cpu().numpy()
    rows = c4._unpack_reduced(torch.tensor(pgpt[None], device=dev),
                              grid.nloen, grid.ndlon)
    _, _, spec = ett.dir_trans(res, scalars=rows, dtype=torch.float64)
    back = c4._reorder_model_to_fa(spec[0].cpu().numpy(), T, fa.size)
    return packed, back, res


def surface_gauss(dev: torch.device, counters: dict, name: str,
                  nsmax=None) -> dict:
    """(a): one fp64 field through sp2gp_gauss4py and back through
    gp2sp_gauss4py on the grid's KLOEN and truncation, bit for bit the
    module path's; K1 and K2 16 times (once an m-group), K3 and K4
    once."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import compat4py as c4
    from ectrans_tpu_torch.programs import drift

    grid = ett.make_grid(name, nsmax)
    fa = fa_spectrum(grid.nsmax)
    _zero(counters)
    _reset_peak(dev)
    (pg, back), t_first = _timed(dev, lambda: gauss_round_trip(grid, fa, dev))
    launches = _counts(counters)
    packed, want_back, res = gauss_module(grid, fa, pg[0], dev)
    groups = len(res.legendre_groups())
    expect_launches(dev, launches, {"K1": groups, "K2": groups, "K3": 1,
                                    "K4": 1}, "(a)")
    check(all(np.array_equal(a, b) for a, b in zip(pg, packed)),
          "phase 14 (a): sp2gp_gauss4py differs from the module path")
    check(np.array_equal(back, want_back),
          "phase 14 (a): gp2sp_gauss4py differs from the module path")
    times = [_timed(dev, lambda: gauss_round_trip(grid, fa, dev))[1]
             for _ in range(SURFACE_REPS)]
    peak = _peak(dev)
    T = grid.nsmax
    norm_in, norm_out = (ett.specnorm(res, torch.from_numpy(
        c4._reorder_fa_to_model(x, T, res.nspec2))[None]).numpy()
        for x in (fa, back))
    norm_drift = drift(norm_out, norm_in)
    check(norm_drift <= SURFACE_NORM_GATE,
          f"phase 14 (a): norm drift {norm_drift:.3e} over "
          f"{SURFACE_NORM_GATE:.3e}")
    print(f"phase 14 (a) compat4py {name} (KLOEN of {grid.ndgl} rows, "
          f"KTRUNC {T}) fp64, LGRADIENT and LREORDER: sp2gp_gauss4py and "
          f"the derivatives bit-identical to the module path, gp2sp_gauss4py "
          f"too; round trip: norm drift {norm_drift / EPS64:.2f} eps (at "
          f"most 100), largest coefficient error {eps_share(back, fa):.0f} "
          f"eps of the largest |value| (the reduced grid's aliasing); first "
          f"round trip {t_first:.3f} s (tables by K4); median "
          f"{statistics.median(times) * 1e3:.1f} ms (min "
          f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}, n "
          f"{SURFACE_REPS}); peak {peak:.2f} GiB; launches {launches}")
    return launches


def surface_lam(dev: torch.device, counters: dict, domain: dict) -> None:
    """(b): one fp64 field through sp2gp_lam4py and gp2sp_lam4py
    (LGRADIENT, LREORDER) on the domain, bit for bit inv_trans_lam's and
    dir_trans_lam's; no kernel."""
    from ectrans_tpu_torch import compat4py as c4
    from ectrans_tpu_torch.lam import LamInvFlags, dir_trans_lam, inv_trans_lam

    d = domain
    nx, ny, dx, dy = d["nx"], d["ny"], d["dx"], d["dy"]
    dims = (nx, ny, d["nxux"], d["nyux"], (nx - 1) // 2, (ny - 1) // 2)
    res = c4._lam_res(*dims, dx, dy)
    model = lam_inputs(res, 0, 1)[2][0].double().numpy()
    fa = c4._lam_reorder_model_to_fa(model, res, res.nspec2)
    _zero(counters)
    _reset_peak(dev)
    out, t_inv = _timed(dev, lambda: c4.sp2gp_lam4py(
        *dims, 10, res.nspec2, True, True, dx, dy, fa, device=dev))
    back, t_dir = _timed(dev, lambda: c4.gp2sp_lam4py(
        res.nspec2, *dims, 10, dx, dy, True, out[0], device=dev))
    launched = {k: c.launches for k, c in counters.items() if c.launches}
    check(not launched, f"phase 14 (b) launched {launched}")
    grid = inv_trans_lam(res, spscalar=torch.tensor(model[None], device=dev),
                         flags=LamInvFlags(scders=True), dtype=torch.float64)
    check(all(np.array_equal(a, b.cpu().numpy().ravel())
              for a, b in zip(out, grid)),
          "phase 14 (b): sp2gp_lam4py differs from inv_trans_lam")
    rows = torch.tensor(out[0], device=dev).reshape(1, ny, nx)
    spec = dir_trans_lam(res, scalars=rows, dtype=torch.float64)[2]
    want = c4._lam_reorder_model_to_fa(spec[0].cpu().numpy(), res,
                                       res.nspec2)
    check(np.array_equal(back, want),
          "phase 14 (b): gp2sp_lam4py differs from dir_trans_lam")
    print(f"phase 14 (b) compat4py LAM {nx} x {ny} at dx {dx:g} m, "
          f"truncation {dims[4:]}, fp64: sp2gp_lam4py and gp2sp_lam4py "
          f"bit-identical to inv_trans_lam and dir_trans_lam; round trip "
          f"{eps_share(back, fa):.1f} eps of the largest |value|; "
          f"sp2gp {t_inv:.3f} s, gp2sp {t_dir:.3f} s (first calls); peak "
          f"{_peak(dev):.2f} GiB; no kernel")


def assets_vs_tables(prpnm: np.ndarray, res, fl) -> float:
    """Largest |PRPNM - the tables of ``fl``| (full_legendre's groups, pn[m
    - m0, j, i - i0] = P̄_{m+j}^m(mu_i); PRPNM's rows above i0 must be 0),
    of PRPNM's largest |value|."""
    T = res.nsmax
    starts = np.concatenate([[0], np.cumsum(T + 2 - np.arange(T + 1))])
    worst = 0.0
    for g in fl.groups:
        pn = g.pn.cpu().numpy()
        for m in range(g.m0, g.m1):
            cols = prpnm[:, starts[m]: starts[m + 1]]   # n = T+1 .. m
            card = pn[m - g.m0, : T + 2 - m][::-1].T
            worst = max(worst, float(np.abs(cols[g.i0:] - card).max()),
                        float(np.abs(cols[: g.i0]).max(initial=0.0)))
    return worst / float(np.abs(prpnm).max())


def fft1d_direct(spec: np.ndarray, ktrunc: int, L: int) -> np.ndarray:
    """sp2gp_fft1d4py's synthesis by explicit fp64 cos/sin sums."""
    x = 2 * np.pi * np.arange(L) / L
    k = np.arange(1, ktrunc + 1)[:, None]
    re, im = spec[0: 2 * (ktrunc + 1): 2], spec[1: 2 * (ktrunc + 1): 2]
    return re[0] + 2 * (re[1:, None] * np.cos(k * x)
                        - im[1:, None] * np.sin(k * x)).sum(0)


def surface_assets(dev: torch.device, name: str) -> None:
    """(c): get_legendre_assets with every column, built and then read
    back through a legpol cache of its own, against the card's fp64 tables
    (K4) at 1e-11; sp2gp_fft1d4py on the grid's longest row against
    numpy's sums."""
    import tempfile

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import compat4py as c4

    grid = ett.make_grid(name)
    ks, T, kloen = grid.ndgl, grid.nsmax, np.asarray(grid.nloen)
    ncol = (T + 2) * (T + 3) // 2 - 1
    with tempfile.TemporaryDirectory() as d, environ(
            ECTRANS_TPU_LEGPOL_DIR=d):
        (kn, pgw, prpnm), t_build = _timed(dev, lambda: c4.get_legendre_assets(
            ks, T, ks, ncol, kloen))
        cached = sorted(p for p in os.listdir(d) if p.startswith("legpol_"))
        check(len(cached) == 2, f"phase 14 (c): the cache holds {cached}")
        again, t_read = _timed(dev, lambda: c4.get_legendre_assets(
            ks, T, ks, ncol, kloen))
        check(all(np.array_equal(a, b) for a, b in
                  zip((kn, pgw, prpnm), again)),
              "phase 14 (c): the assets read from the cache differ")
        del again
    res = ett.setup(c4._gauss_grid(ks, T, kloen))
    check(np.array_equal(kn, res.nmen) and np.array_equal(pgw, res.w),
          "phase 14 (c): KNMENG or PGW differ from the Resolution's")
    (fl, t_k4) = _timed(dev, lambda: res.full_legendre(torch.float64, dev))
    worst = assets_vs_tables(prpnm, res, fl)
    res.drop_cached("full_legendre")
    check(worst <= LATLON_TABLE_TOL, f"phase 14 (c): PRPNM {worst:.3e} from "
                                     f"the card's fp64 tables")
    spec = np.random.default_rng(1).standard_normal(2 * (T + 1))
    L = grid.ndlon
    out = c4.sp2gp_fft1d4py(spec.size, T, spec, L, device=dev)
    want = fft1d_direct(spec, T, L)
    fft = float(np.abs(out - want).max() / np.abs(want).max())
    check(fft <= SURFACE_FFT_TOL, f"phase 14 (c): sp2gp_fft1d4py {fft:.3e} "
                                  f"from numpy's sums")
    print(f"phase 14 (c) get_legendre_assets {name}: PRPNM {prpnm.shape} "
          f"({prpnm.nbytes / 2**30:.2f} GiB) built in {t_build:.2f} s "
          f"(cache written), read back bit for bit in {t_read:.2f} s; "
          f"{worst:.2e} of its largest |value| from the card's fp64 tables "
          f"(K4, {t_k4:.2f} s; at most {LATLON_TABLE_TOL:g}); "
          f"sp2gp_fft1d4py T{T} onto {L} points {fft:.2e} from numpy's "
          f"cos/sin sums (at most {SURFACE_FFT_TOL:g})")


def _void(a: np.ndarray) -> int:
    """The address of a's data, for the shim's pointer arguments."""
    return a.ctypes.data


def capi_test_program(dev: torch.device, limit: float) -> float:
    """The unchanged src/capi/test_capi.c linked to the port's shim and run
    on dev: it must exit 0 and print "C API test OK".  Returns seconds."""
    import tempfile

    from ectrans_tpu_torch import capi

    with tempfile.TemporaryDirectory() as d:
        exe = os.path.join(d, "test_capi")
        subprocess.run([capi.cc(), "-O2",
                        os.path.join(ROOT, "src", "capi", "test_capi.c"),
                        "-o", exe] + capi.link_flags() + ["-lm"],
                       check=True, capture_output=True)
        env = dict(capi.bridge_env(dev.type), ECTRANS_TPU_LEGPOL_DIR="")
        t0 = time.perf_counter()
        out = run_command([exe], "14(d)", limit, env=env, module=False)
        secs = time.perf_counter() - t0
    check("C API test OK" in out, "phase 14 (d): test_capi.c printed no OK")
    return secs


def capi_round_trip(lib, h, sp, gp, out):
    """ectrans_tpu_invtrans_full of bench.py's fields with lscalarders and
    luvder_ew into gp, ectrans_tpu_dirtrans_full of its u, v and scalars
    into out; returns invtrans_full's field count."""
    vor, div, sc = sp
    nout = lib.ectrans_tpu_invtrans_full(h, NFLD_UV, NFLD_SC, _void(vor),
                                         _void(div), _void(sc), 1, 1, 0,
                                         _void(gp))
    rc = lib.ectrans_tpu_dirtrans_full(h, NFLD_UV, NFLD_SC, _void(gp),
                                       *map(_void, out))
    check(rc == 0, f"ectrans_tpu_dirtrans_full returned {rc}")
    return nout


def capi_module(res, sp, flags, gp, dev, dtype):
    """The module path on the C API's inputs: the packed inv_trans of sp
    ((vor, div, scalars), None where absent) under flags, and dir_trans of
    gp's first rows (u, v, scalars), each (vor, div, scalars) on the
    host."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import compat4py as c4

    t = [None if x is None else torch.tensor(x, device=dev) for x in sp]
    out = ett.inv_trans(res, *t, flags=flags, dtype=dtype)
    packed = c4._pack_reduced(out, res.grid.nloen).cpu().numpy()
    del out
    nuv, nsc = (0 if x is None else x.shape[0] for x in sp[1:])
    rows = c4._unpack_reduced(torch.tensor(gp[: 2 * nuv + nsc], device=dev),
                              res.grid.nloen, res.grid.ndlon)
    fields = (rows[:nuv], rows[nuv: 2 * nuv], rows[2 * nuv:])
    spec = ett.dir_trans(res, *(x if x.shape[0] else None for x in fields),
                         dtype=dtype)
    return packed, [None if x is None else x.cpu().numpy() for x in spec]


def capi_scalars_f(lib, h, sc, gp, out) -> None:
    for name, a, b in (("invtrans_f", sc, gp), ("dirtrans_f", gp, out)):
        rc = getattr(lib, f"ectrans_tpu_{name}")(h, sc.shape[0], _void(a),
                                                 _void(b))
        check(rc == 0, f"ectrans_tpu_{name} returned {rc}")


def surface_capi(dev: torch.device, counters: dict, name: str,
                 limit: float) -> dict:
    """(d): test_capi.c on dev, then the shim in this process (ctypes, the
    GIL released): ectrans_tpu_setup(name, -1), bench.py's fields through
    invtrans_full and dirtrans_full in fp64, bit for bit the module path's;
    the _f entries on the 6 scalars in fp32, bit for bit the module path's
    and within phase 4's share of the 100 eps gate.  Returns the fp64
    round trip's and the _f pair's launches."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import capi, capi_bridge

    _, t_build = _timed(dev, capi.build)
    t_prog = capi_test_program(dev, limit)
    lib = capi.load()
    with environ(ECTRANS_TPU_CAPI_DEVICE=dev.type):
        h = lib.ectrans_tpu_setup(name.encode(), -1)
    check(h >= 0, f"ectrans_tpu_setup({name!r}) returned {h}")
    res = capi_bridge._res(h).res
    check(capi_bridge._res(h).device.type == dev.type,
          f"the C API's handle is on {capi_bridge._res(h).device}")
    groups = len(res.legendre_groups())
    sp = [x.double().numpy() for x in bench_inputs(res.nspec2, res.nsmax)]
    flags = ett.InvFlags(scders=True, uvders=True)
    nout = ett.num_inv_output_fields(NFLD_UV, NFLD_SC, flags)
    gp = np.zeros((nout, res.grid.ngptot))
    out = [np.zeros_like(x) for x in sp]
    _zero(counters)
    _reset_peak(dev)
    got, t_first = _timed(dev, lambda: capi_round_trip(lib, h, sp, gp, out))
    launches = _counts(counters)
    check(got == nout, f"ectrans_tpu_invtrans_full returned {got}")
    expect_launches(dev, launches, {"K1": groups, "K2": groups, "K3": 1,
                                    "K4": 1}, "(d) fp64")
    times = [_timed(dev, lambda: capi_round_trip(lib, h, sp, gp, out))[1]
             for _ in range(SURFACE_REPS)]
    peak = _peak(dev)
    packed, spec = capi_module(res, sp, flags, gp, dev, torch.float64)
    check(np.array_equal(packed, gp), "phase 14 (d): invtrans_full differs "
                                      "from the module path")
    check(all(np.array_equal(a, b) for a, b in zip(out, spec)),
          "phase 14 (d): dirtrans_full differs from the module path")
    errs = family_errors([torch.from_numpy(x) for x in out],
                         [torch.from_numpy(x) for x in sp])
    worst64 = max(e / m for e, m in errs) / EPS64
    del packed, spec
    # the _f entries: phase 4's scalars in fp32
    sc = sp[2].astype(np.float32)
    gpf = np.zeros((NFLD_SC, res.grid.ngptot), np.float32)
    spf = np.zeros_like(sc)
    _zero(counters)
    _, t_f = _timed(dev, lambda: capi_scalars_f(lib, h, sc, gpf, spf))
    launches_f = _counts(counters)
    expect_launches(dev, launches_f, {"K1": groups, "K2": groups, "K3": 1,
                                      "K4": 1}, "(d) _f")
    packed, spec = capi_module(res, (None, None, sc), ett.InvFlags(), gpf,
                               dev, torch.float32)
    check(np.array_equal(packed, gpf) and np.array_equal(spf, spec[2]),
          "phase 14 (d): the _f entries differ from the module path")
    (e, m), = family_errors([torch.from_numpy(spf)], [torch.from_numpy(sc)])
    share = e / (100 * EPS32 * m)
    check(share <= DENSE_GATE_SHARE,
          f"phase 14 (d): the _f round trip {share:.3f} of the 100 eps gate, "
          f"over the {DENSE_GATE_SHARE} allowed")
    check(lib.ectrans_tpu_release(h) == 0, "ectrans_tpu_release failed")
    print(f"phase 14 (d) C API: shim built in {t_build:.2f} s; test_capi.c "
          f"(O48, unchanged) on the {dev.type}: C API test OK in "
          f"{t_prog:.1f} s; in this process ectrans_tpu_setup({name!r}, -1), "
          f"invtrans_full ({nout} fields) + dirtrans_full fp64 bit-identical "
          f"to the module path, round trip {worst64:.0f} eps of each "
          f"family's largest |value|; first round trip {t_first:.3f} s; "
          f"median {statistics.median(times) * 1e3:.1f} ms (min "
          f"{min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}, n "
          f"{SURFACE_REPS}; the host's buffers included); peak {peak:.2f} "
          f"GiB; launches {launches}; _f entries on the {NFLD_SC} scalars "
          f"bit-identical to the module path, {share:.3f} of the 100 eps "
          f"gate (at most {DENSE_GATE_SHARE}), {t_f:.3f} s, launches "
          f"{launches_f}")
    return {k: launches[k] + launches_f[k] for k in launches}


def phase_surfaces(dev: torch.device, counters: dict,
                   cfg: dict = SURFACES) -> dict:
    """Phase 14: the ectrans4py and C surfaces on dev, (a)-(d) above.
    Returns the launches of (a) and (d)."""
    t_phase = time.perf_counter()
    _fresh(counters)
    launches = surface_gauss(dev, counters, *cfg["gauss"])
    _fresh(counters)
    surface_lam(dev, counters, cfg["lam"])
    _fresh(counters)
    surface_assets(dev, cfg["assets"])
    _fresh(counters)
    for k, n in surface_capi(dev, counters, cfg["capi"],
                             cfg["capi_limit"]).items():
        launches[k] += n
    _fresh(counters)
    print(f"phase 14 done in {time.perf_counter() - t_phase:.1f} s; "
          f"launches of (a) and (d) {launches}")
    return launches


# phase 15: (a)'s fp64 comparison and fp32 build, (b)'s configuration, (c)'s
# group counts (block 32 at TCO1279: 40 groups, past K3's and K4's 16
# by-value groups), (d)'s world
TABLES = dict(fp64="TCO639", fp32="TCO1279", bench="TCO1279",
              groups=TABLE_GROUPS, world=4)
NATIVE_TOL = 1e-12           # (a): native vs numpy, of the largest |value|
HOST_K4_TOL = 1e-7           # (a): tests/test_tablegen.py's budget
TABLES_GATE = 100 * EPS32    # (b)-(d): of each family's largest |value|


def interleave(psym, pasym, m0: int, m1: int, i0: int, J: int) -> np.ndarray:
    """One group's full-n table (gm, J, ig) from host parity tables."""
    kg = J // 2
    pn = np.empty((m1 - m0, J, psym.shape[1] - i0), psym.dtype)
    pn[:, 0::2] = np.swapaxes(psym[m0:m1, i0:, :kg], 1, 2)
    pn[:, 1::2] = np.swapaxes(pasym[m0:m1, i0:, :kg], 1, 2)
    return pn


def host_tables(res, dtype):
    """(psym, pasym, seconds) of the native builder at res's NH nodes."""
    from ectrans_tpu_torch import native

    nh = res.ndgnh
    t0 = time.perf_counter()
    ps, pa, kmax = native.build_legendre_parity(
        res.nsmax, res.mu[:nh], 1, res.nmen[:nh], dtype)
    check(kmax == res.kmax, f"native kmax {kmax} != {res.kmax}")
    return ps, pa, time.perf_counter() - t0


def tables_native(dev: torch.device, cfg: dict) -> None:
    """(a): the native builder's g++ build, its fp64 tables against the
    numpy recurrence's, and its fp32 tables at TCO1279 against K4's."""
    import tempfile

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import legendre, native
    from ectrans_tpu_torch.ops import legendre_tablegen as tg

    # the g++ build timed into a directory of its own: earlier phases' host
    # tables have built the library in use already
    with tempfile.TemporaryDirectory() as tmp, \
            environ(ECTRANS_TPU_NATIVE_DIR=tmp):
        t0 = time.perf_counter()
        native.build()
        t_build = time.perf_counter() - t0
    path = native.build()
    check(native.available(), "native builder unavailable")
    res = ett.setup(cfg["fp64"])
    ps, pa, t_nat = host_tables(res, np.float64)
    nh = res.ndgnh
    t0 = time.perf_counter()
    with environ(ECTRANS_TPU_DISABLE_NATIVE="1"):
        nps, npa, _ = legendre.build_parity_tables(
            res.nsmax, res.mu[:nh], 1, res.nmen[:nh])
    t_np = time.perf_counter() - t0
    scale = max(np.abs(ps).max(), np.abs(pa).max())
    err = max(np.abs(ps - nps).max(), np.abs(pa - npa).max()) / scale
    check(err <= NATIVE_TOL, f"phase 15 (a) native vs numpy {err:.3e} of "
                             f"the largest |value|")
    del ps, pa, nps, npa
    res = ett.setup(cfg["fp32"])
    ps, pa, t32 = host_tables(res, np.float32)
    nbytes = ps.nbytes + pa.nbytes
    inp = tg._device_inputs(res, dev)
    d, scale = 0.0, 0.0
    for m0, m1, i0, J in res.legendre_groups():
        host = torch.from_numpy(interleave(ps, pa, m0, m1, i0, J)).to(dev)
        k4 = tg.gen_group(inp, m0, m1, J, i0, torch.float32)
        d = max(d, (host - k4).abs().max().item())
        scale = max(scale, k4.abs().max().item())
        del host, k4
    del ps, pa
    check(d <= HOST_K4_TOL * scale, f"phase 15 (a) native fp32 vs K4: "
                                    f"{d / scale:.3e} of the largest |value|")
    print(f"phase 15 (a) native Legendre builder: g++ build {t_build:.2f} s "
          f"({path.name}); {cfg['fp64']} fp64 native {t_nat:.2f} s vs numpy "
          f"{t_np:.2f} s, {err:.3e} of the largest |value| (at most "
          f"{NATIVE_TOL:g}); {cfg['fp32']} fp32 tables {nbytes:,} B "
          f"({nbytes / 1e9:.2f} GB) in {t32:.2f} s, against K4's fp32 tables "
          f"{d / scale:.3e} of the largest |value| (at most {HOST_K4_TOL:g})")


def tables_round_trip(dev, counters, res, sp, refs, tag: str, want: dict,
                      env: dict) -> dict:
    """Phase 4's round trip with ``env`` set: the table build (setup)
    timed, the launches (``want``: kernel -> count) checked, the gate share
    held to 1.0 and the outputs to 100 eps of each family's max of phase
    4's; first call, median of 3, peak and the tables' bytes."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.field_layout import FieldLayout

    flags_sizes = FieldLayout.inv(NFLD_UV, NFLD_SC, ett.InvFlags(
        scders=True, uvders=True)).sizes_padded
    with environ(**env):
        _zero(counters)
        _reset_peak(dev)
        fl, t_setup = _timed(dev, lambda: res.full_legendre(torch.float32,
                                                            dev))
        tbytes = tensor_bytes([g.pn for g in fl.groups])
        (grid, out), t_first = _timed(dev, lambda: round_trip(
            res, sp, torch.float32))
        launches = _counts(counters)
        expect_launches(dev, launches, want, f"({tag})", 15)
        check(bool(torch.isfinite(grid).all()), f"phase 15 ({tag}): "
                                                "non-finite grid values")
        err, gate = max(((e, TABLES_GATE * m)
                         for e, m in family_errors(out, sp)),
                        key=lambda x: x[0] / x[1])
        check(err <= gate, f"phase 15 ({tag}) gate {err / gate:.3f} of "
                           "100 eps, over 1.0")
        vs = family_stats(grid, refs[0].numpy(), flags_sizes) + [
            family_stats(o, r.numpy(), [o.shape[0]])[0]
            for o, r in zip(out, refs[1])]
        share = worst_share(vs, TABLES_GATE)
        check(share <= 1.0, f"phase 15 ({tag}) against phase 4: {share:.3f}"
                            " of 100 eps of the family max")
        del grid, out
        times = [_timed(dev, lambda: round_trip(res, sp, torch.float32))[1]
                 * 1e3 for _ in range(3)]
        med, lo, hi = statistics.median(times), min(times), max(times)
        prof = device_profile(dev, lambda: round_trip(res, sp,
                                                      torch.float32))
    res.drop_cached("full_legendre")
    return dict(setup=t_setup, first=t_first, median=med, lo=lo, hi=hi,
                prof=prof,
                peak=_peak(dev), share=err / gate, vs=share,
                exact=all(b for _, _, b in vs), gib=tbytes / 2**30,
                launches=launches)


def tables_line(tag: str, what: str, r: dict, ref_share: float) -> str:
    return (f"phase 15 ({tag}) {what}: launches {r['launches']}; gate "
            f"{r['share']:.4f} of 100 eps (phase 4 {ref_share:.4f}; at most "
            f"1.0); against phase 4 {r['vs']:.3f} of 100 eps of each "
            f"family's max (bit-identical {r['exact']}); setup "
            f"{r['setup']:.2f} s; first round trip {r['first']:.3f} s; median "
            f"{r['median']:.1f} ms (min {r['lo']:.1f}, max {r['hi']:.1f}, n "
            f"3); one steady round trip under the profiler: "
            f"{profile_note(r['prof'])}; peak {r['peak']:.2f} GiB; tables "
            f"{r['gib']:.3f} GiB")


def tables_host(dev, counters, refs, ref_share: float, name: str) -> dict:
    """(b): phase 4's round trip on the host table source (the native
    builder's fp32 tables copied up a group at a time; no K4)."""
    import ectrans_tpu_torch as ett

    res = ett.setup(name)
    sp = [x.to(dev) for x in bench_inputs(res.nspec2, res.nsmax)]
    n = len(res.legendre_groups())
    r = tables_round_trip(dev, counters, res, sp, refs, "b", dict(
        K1=n, K2=n, K3=1, K4=0), dict(ECTRANS_TPU_TABLE_SOURCE="host"))
    print(tables_line("b", f"{name} round trip on the host table source "
                           f"(host tables "
                           f"{np.dtype(res.host_table_dtype).name}, built "
                           "and copied up in the setup)", r, ref_share))
    return r["launches"]


def tables_groups(dev, counters, refs, ref_share: float, name: str,
                  counts: tuple) -> dict:
    """(c): phase 4's round trip at ECTRANS_TPU_LEG_GROUPS = each of
    ``counts`` (K1 and K2 a launch a group, K3 and K4 one each), its tables'
    GiB against the default groups'."""
    import ectrans_tpu_torch as ett

    res = ett.setup(name)
    sp = [x.to(dev) for x in bench_inputs(res.nspec2, res.nsmax)]
    base = 4 * sum((m1 - m0) * J * (res.ndgnh - i0)
                   for m0, m1, i0, J in res.legendre_groups()) / 2**30
    launches = {}
    for ng in counts:
        n = len(res.legendre_groups(ng))
        r = tables_round_trip(dev, counters, res, sp, refs, f"c {ng}",
                              dict(K1=n, K2=n, K3=1, K4=1),
                              dict(ECTRANS_TPU_LEG_GROUPS=str(ng)))
        merge_launches(launches, [r["launches"]])
        print(tables_line("c", f"{name} round trip at ECTRANS_TPU_LEG_GROUPS "
                               f"{ng} ({n} groups)", r, ref_share)
              + f" ({r['gib'] / base:.4f} of the default groups' "
                f"{base:.3f} GiB)")
    return launches


def tables_entry(dev, counters, world: int) -> dict:
    """(d): ``entry()`` on the card against the same step on the CPU (100
    eps of each family's max, K1-K4 launched), then
    ``dryrun_multichip(world)`` on gloo ranks sharing the card."""
    from ectrans_tpu_torch import entry

    step, args = entry.entry(device="cpu")
    want = step(*args)
    step, args = (entry.entry() if dev.type == "cuda"
                  else entry.entry(device=dev))
    check(all(a.device == dev for a in args), f"entry() off {dev}")
    _zero(counters)
    got, t_first = _timed(dev, lambda: step(*args))
    launches = _counts(counters)
    check(dev.type != "cuda" or all(launches.values()),
          f"phase 15 (d) entry() launched {launches}; expected K1-K4")
    share = max((a.cpu().double() - b.double()).abs().max().item()
                / (TABLES_GATE * b.abs().max().item())
                for a, b in zip(got, want))
    check(share <= 1.0, f"phase 15 (d) entry() card vs CPU {share:.3f} of "
                        "100 eps")
    del got
    t0 = time.perf_counter()
    reps = (entry.dryrun_multichip(world) if dev.type == "cuda"
            else entry.dryrun_multichip(world, device=dev))
    t_world = time.perf_counter() - t0
    print(f"phase 15 (d) entry() O48 T47 on the card vs the CPU: "
          f"{share:.3f} of 100 eps of each family's max; first call "
          f"{t_first:.2f} s; launches {launches}; dryrun_multichip({world}) "
          f"on {world} gloo ranks sharing the card: round trip errors "
          f"{max(r['err'] for r in reps):.3e} (O160 T159), "
          f"{max(r['lam_err'] for r in reps):.3e} (LAM 32 x 24), each under "
          f"1e-3, in {t_world:.1f} s")
    return launches


def phase_tables(dev: torch.device, counters: dict, refs, ref_share: float,
                 cfg: dict = TABLES) -> dict:
    """Phase 15: the native builder, the host table source and the group
    knob at TCO1279, and the entry points, (a)-(d) above.  Returns the
    launches of (b), (c) and (d)."""
    t_phase = time.perf_counter()
    _fresh(counters)
    tables_native(dev, cfg)
    _fresh(counters)
    launches = {}
    merge_launches(launches, [tables_host(dev, counters, refs, ref_share,
                                          cfg["bench"])])
    merge_launches(launches, [tables_groups(dev, counters, refs, ref_share,
                                            cfg["bench"], cfg["groups"])])
    _fresh(counters)
    merge_launches(launches, [tables_entry(dev, counters, cfg["world"])])
    _fresh(counters)
    print(f"phase 15 done in {time.perf_counter() - t_phase:.1f} s; "
          f"launches of (b)-(d) {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import ectrans_tpu_torch as ett

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    # the host's Legendre tables are built anew, as before the legpol cache
    # (phase 14 (c) gives the cache a directory of its own)
    os.environ.setdefault("ECTRANS_TPU_LEGPOL_DIR", "")
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
    merge_launches(launches, [phase_fourier(dev, counters)])
    merge_launches(launches, [phase_surfaces(dev, counters)])
    merge_launches(launches, [phase_tables(dev, counters, bench_out,
                                           dense["ratio"])])
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
