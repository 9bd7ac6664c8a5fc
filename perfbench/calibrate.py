"""The readings that a cell's limits are set from, in one process:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 --seconds <s> [--out readings.json]

For each seed of ``--seeds`` the program runs a window of ``--seconds`` at
the cell's own load and its kept steps are compared with the reference, as
a run does; then the control (the reference in float32 with TF32 operands,
in the program's place) does the same for each of ``--control-seeds``.
Prints, for each compared number, the largest reading of the program (the
lower reading) and the smallest of the control (the upper reading).  Not
part of a benchmark run.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(runner, seeds, seconds, ref, sync, harness, steps=None):
    out = {}
    for seed in seeds:
        t0 = time.perf_counter()
        state0 = runner.inputs(seed)
        runner.kept = [None] * len(runner.kept)
        sampler = harness.Sampler(seed, runner.t.kept_steps,
                                  len(runner.packets))
        _, times, _ = runner.loop(state0, sampler, seconds=seconds,
                                  steps=steps, sync=sync)
        del state0
        nums = {k: v for k, (v, _) in harness.check(runner, ref).items()}
        out[seed] = nums
        print(f"seed {seed}: {len(times)} steps, "
              f"{time.perf_counter() - t0:.1f} s, "
              + " ".join(f"{k} {v:.3e}" for k, v in nums.items()),
              file=sys.stderr, flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-steps", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from perfbench import spec

    cell = spec.load(args.workload)
    spec.set_environment(cell.config)
    import torch

    from perfbench import harness

    device = torch.device("cuda", 0)
    sync = lambda: torch.cuda.synchronize(device)  # noqa: E731
    conf, t = cell.config, cell.traffic
    mod = spec.program(conf["program"])
    geo = mod.geometry(conf)
    dtype = getattr(torch, conf["dtype"])
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]

    runner = harness.Runner(t, geo, mod.Program(conf, t), device, dtype)
    warm = runner.inputs(seeds[0])
    for i in range(t.warmup_steps):
        runner.step(warm, i, (0, i % len(runner.packets)))
    del warm
    sync()
    ref = geo.reference(device)
    prog = readings(runner, seeds, args.seconds, ref, sync, harness)
    runner.prog.close()
    runner = None
    torch.cuda.empty_cache()
    runner = harness.Runner(t, geo, harness.Control(geo, t, device), device,
                            dtype)
    ctrl = readings(runner, cseeds, None, ref, sync, harness,
                    steps=args.control_steps)
    names = sorted({k for r in prog.values() for k in r})
    summary = {}
    for k in names:
        lo = max(r[k] for r in prog.values())
        up = min(r[k] for r in ctrl.values())
        summary[k] = dict(lower=lo, upper=up, ratio=up / lo if lo else None,
                          limit=cell.limits.get(k))
        print(f"{k}: lower {lo:.4e} upper {up:.4e} ratio {up / lo:.1f} "
              f"limit {cell.limits.get(k)}", file=sys.stderr)
    out = dict(workload=args.workload, device=torch.cuda.get_device_name(0),
               program=prog, control=ctrl, summary=summary)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(summary))


if __name__ == "__main__":
    sys.path[0] = ROOT
    main()
