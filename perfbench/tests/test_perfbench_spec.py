"""BENCHMARK.json and the files it names hold together: every cell's
configuration, traffic, limits and metric readers are there, and the
entries keep the contract's shapes."""

import json
import pathlib
import re

import pytest

from perfbench import spec

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert (ROOT / BENCH["command"][1]).is_file()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_loads_with_its_files(w):
    assert NAME.match(w["name"]) and 1 <= len(w["why"]) <= 200
    assert w["chips"] in (1, 4)
    cell = spec.load(w["name"])
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]).read)
    nums = {f[0] for p in cell.traffic.packets()
            for f in cell.traffic.families(p)}
    nums |= {"dir.sc"} | ({"dir.vordiv"} if cell.traffic.nuv else set())
    assert nums == set(cell.limits)
    assert all(v > 0 for v in cell.limits.values())


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells
    if "bound" in m:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_configs_are_files_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("perfbench/configs/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
        assert conf["truncation"] == conf["gauss_number"] - 1
        prog = spec.program(conf["program"])
        assert callable(prog.geometry) and callable(prog.Program)
