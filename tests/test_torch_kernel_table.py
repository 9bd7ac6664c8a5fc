"""The port's record of TPU kernels does not drift from the code: every
function under ``ectrans_tpu/`` and ``tools/`` that reaches ``pl.pallas_call``
has a Hopper counterpart in ``chip_smoke.py``'s ``KERNELS`` (matched by
``replaces="file:line"``, the line of its ``def``) and a row in
``PERF.md``'s kernel table marked ported.  ``chip_smoke.py`` is read with
``ast``, not imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def pallas_functions() -> dict:
    """{"file:line": name} of every function that calls pl.pallas_call."""
    found = {}
    for top in ("ectrans_tpu", "tools"):
        for path in sorted((ROOT / top).rglob("*.py")):
            for node in ast.walk(ast.parse(path.read_text())):
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                        and any(isinstance(c, ast.Call)
                                and isinstance(c.func, ast.Attribute)
                                and c.func.attr == "pallas_call"
                                for c in ast.walk(node)):
                    found[f"{path.relative_to(ROOT)}:{node.lineno}"] = \
                        node.name
    return found


def chip_smoke_kernels() -> dict:
    """chip_smoke.py's KERNELS: {"K1": {"name": ..., "replaces": ...}}."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "KERNELS"
                for t in node.targets):
            return {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                          for kw in v.keywords}
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("chip_smoke.py has no KERNELS")


PALLAS = pallas_functions()


def test_the_scan_finds_the_kernels():
    assert len(PALLAS) >= 12
    assert PALLAS["ectrans_tpu/ops/legendre_pallas.py:239"] == \
        "group_inv_dense"
    assert PALLAS["tools/roofline.py:107"] == "pallas_reduce"


@pytest.mark.parametrize("where", sorted(PALLAS))
def test_pallas_kernel_is_ported(where):
    ported = {k: v for k, v in chip_smoke_kernels().items()
              if v["replaces"] == where}
    assert len(ported) == 1, f"{where} ({PALLAS[where]}) has {ported}"
    (key, entry), = ported.items()
    assert entry["route"] in ("cuda", "triton")
    assert (ROOT / entry["source"]).is_file(), entry["source"]
    rows = [line for line in (ROOT / "PERF.md").read_text().splitlines()
            if line.startswith(f"| {key} |") and where in line]
    assert len(rows) == 1 and "ported" in rows[0] \
        and "to port" not in rows[0], f"PERF.md row of {key}: {rows}"


def test_every_entry_replaces_a_pallas_kernel():
    for key, entry in chip_smoke_kernels().items():
        assert entry["replaces"] in PALLAS, (key, entry["replaces"])
