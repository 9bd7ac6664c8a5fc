"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``, each number compared
with its limit; the same numbers are the last lines of standard error.
Without a CUDA card, with fewer cards than the cell asks for, or with JAX
or the JAX package loaded once the window has closed, the run exits with a
non-zero code and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: top-level module names that a run may not load
FORBIDDEN = ("jax", "jaxlib", "flax", "ectrans_tpu")


def forbidden_modules(names) -> list:
    """The loaded modules whose top-level name (before the first dot) is,
    as a whole, one of ``FORBIDDEN``."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    from perfbench import spec

    cell = spec.load(args.workload)
    spec.set_environment(cell.config)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {found}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    from perfbench import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), T0,
                         device)
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT          # the checkout's root, not perfbench/
    sys.exit(main())
