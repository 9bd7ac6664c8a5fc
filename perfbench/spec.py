"""What a run of one cell needs, found by name: the cell in
``BENCHMARK.json``, its configuration ``perfbench/configs/<config>.json``,
its traffic ``perfbench/traffic/<traffic>.json``, the program that the
configuration names, ``perfbench/programs/<program>.py``, its limits
``perfbench/limits/<cell>.json`` and one reader
``perfbench/metrics/<metric>.py`` for each metric that the cell reports.

Nothing here imports torch: the environment of the program (its cache
directories and the knobs the configuration pins) is set before torch
starts.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import pathlib

from . import traffic as traffic_mod

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"

#: fixed cache directories inside the checkout, so that only the first run
#: of a checkout builds and compiles
CACHE_ENV = {
    "CUDA_CACHE_PATH": CACHE / "cuda",
    "TRITON_CACHE_DIR": CACHE / "triton",
    "TORCH_EXTENSIONS_DIR": CACHE / "torch_extensions",
    "ECTRANS_TPU_NATIVE_DIR": CACHE / "native",
    "ECTRANS_TPU_LEGPOL_DIR": CACHE / "legpol",
}


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: traffic_mod.Traffic
    limits: dict
    end_to_end: list        # the metric entries of BENCHMARK.json
    per_layer: list


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(cell_name: str, bench_file: pathlib.Path = ROOT / "BENCHMARK.json",
         base: pathlib.Path = HERE) -> Cell:
    bench = json.loads(bench_file.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell_name not in cells:
        raise SystemExit(f"perfbench: no workload {cell_name!r} in "
                         f"{bench_file.name}")
    w = cells[cell_name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((ROOT / conf["file"]).read_text())
    return Cell(
        name=cell_name, chips=int(w["chips"]), config=config,
        traffic=traffic_mod.load(w["traffic"], base / "traffic"),
        limits=json.loads((base / "limits" / f"{cell_name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, cell_name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, cell_name)])


def set_environment(config: dict) -> None:
    """The cache directories, and the program's knobs as the
    configuration pins them; any other knob of the program is unset."""
    for k, path in CACHE_ENV.items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[k] = str(path)
    for k in [k for k in os.environ if k.startswith("ECTRANS_TPU_")
              and k not in CACHE_ENV]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})


def _module(kind: str, name: str, base: pathlib.Path):
    path = base / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{kind}." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: pathlib.Path = HERE):
    """The module ``perfbench/metrics/<name>.py``."""
    return _module("metrics", name, base)


def program(name: str, base: pathlib.Path = HERE):
    """The module ``perfbench/programs/<name>.py``: the program under test
    and the geometry it shares with its reference."""
    return _module("programs", name, base)
