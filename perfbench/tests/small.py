"""A cell at O48 T47 for the CPU tests, on one of the benchmark's
traffic shapes and with a benchmark cell's limits."""

import json
import pathlib
import time

import torch

from perfbench import harness, spec, traffic

HERE = pathlib.Path(__file__).resolve().parent.parent
STEP = dict(levels=5, packet_levels=2, vordiv=True, scalars_per_level=2,
            surface_scalars=1, scders=True, uvders=True, grid_update=1.0,
            warmup_steps=1, trace_steps=2, kept_steps=1)
F1 = dict(levels=1, packet_levels=1, vordiv=False, scalars_per_level=1,
          surface_scalars=0, scders=False, uvders=False, grid_update=1.0,
          warmup_steps=1, trace_steps=3, kept_steps=2)


def cell(shape: dict, limits_of: str) -> spec.Cell:
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    conf = dict(program="octahedral", grid="O48", gauss_number=48,
                truncation=47,
                dtype="float32", precision="highest", env={})
    lim = json.loads((HERE / "limits" / f"{limits_of}.json").read_text())
    return spec.Cell(limits_of + "-small", 1, conf,
                     traffic.from_dict("small", shape), lim,
                     [m for m in bench["end_to_end"]
                      if m["name"] in ("step_ms", "setup_s")],
                     bench["per_layer"])


def run(c, seed=987654321987, seconds=0.2, trace=False, program=None,
        say=None):
    return harness.run(c, seed, seconds, trace, time.perf_counter(),
                       torch.device("cpu"), program=program, say=say)
