"""chip_smoke.py's bookkeeping, on the CPU: the bound it reports for each
kernel (the larger of the bytes over the memory rate and the operations over
their peak) and its reading of the compiler's register and spill report.
The script itself runs only on a CUDA card."""

import importlib.util
import pathlib

import pytest
import torch

from ectrans_tpu_torch import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bound_takes_the_larger_time(smoke):
    # K7 at TCO1279: 1.186e11 FLOP against 4.24 GB is compute-bound
    b = smoke.bound(2 * 64 * 926_445_600, 4.24e9)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1.7699, rel=1e-4)
    b = smoke.bound(0, 2 * 2**29)          # K11's 512 MiB copy
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(2 * 2**29 / 3.35e12 * 1e3)
    assert smoke.tensor_bytes(torch.zeros(3, 4), (torch.zeros(2,
                              dtype=torch.bfloat16), [torch.zeros(1)])) \
        == 48 + 4 + 4


def test_ptxas_report_reads_registers_and_spills(smoke, tmp_path,
                                                 monkeypatch):
    (tmp_path / "build.log").write_text(
        "ptxas info    : Compiling entry function '_ZN2k7kernAIfEEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _ZN2k7kernAIfEEv\n"
        "    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN5otherEv' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 40 registers, 384 bytes cmem[0]\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert smoke.ptxas_report("k7kernA") == {"_ZN2k7kernAIfEEv": dict(
        stack=8, spill_stores=12, spill_loads=4, registers=168)}


K8_LOG = (
    "ptxas info    : Compiling entry function "
    "'_ZN2k717inv_dense2_kernelIfEEvPKfPKT_Pfiiiii' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 168 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k817dir_dense2_kernelI13__nv_bfloat16EEvPKfPKT_Pfiiiii' for "
    "'sm_90a'\n"
    "    0 bytes stack frame, {spill} bytes spill stores, 0 bytes spill "
    "loads\n"
    "ptxas info    : Used 250 registers, used 16 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k817dir_dense2_kernelIfEEvPKfPKT_Pfiiiii' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 254 registers, used 16 barriers\n")


@pytest.mark.parametrize("spill", [0, 8])
def test_registers_of_k8_refuse_a_spill(smoke, tmp_path, monkeypatch, spill):
    """K8's line reads its two variants' registers, and not K7's, from
    build.log; a spill in either fails the run."""
    (tmp_path / "build.log").write_text(K8_LOG.format(spill=spill))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    needle = smoke.REDESIGNED["K8"][0]
    if spill:
        with pytest.raises(RuntimeError, match="spills"):
            smoke.registers("K8", needle)
    else:
        assert smoke.registers("K8", needle) == {"fp32": 254, "bf16": 250}


DENSE_LOG = (
    "ptxas info    : Compiling entry function "
    "'_ZN2k116inv_dense_kernelI13__nv_bfloat16EEvPKfPKT_PfS7_iiiii' for "
    "'sm_90a'\n"
    "    0 bytes stack frame, {k1} bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 128 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k116inv_dense_kernelIfEEvPKfPKT_PfS6_iiiii' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 138 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k216dir_dense_kernelIfEEvPKfS2_PKT_Pfiiiii' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, {k2} bytes spill loads\n"
    "ptxas info    : Used 254 registers, used 16 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k216dir_dense_kernelI13__nv_bfloat16EEvPKfS3_PKT_Pfiiiii' for "
    "'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 253 registers, used 16 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_116inv_dense_kernelIddLb0EEEvPKT_PKT0_PS0_S6_iii' "
    "for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 90 registers, used 1 barriers\n") + K8_LOG


@pytest.mark.parametrize("key,regs", [("K1", {"fp32": 138, "bf16": 128}),
                                      ("K2", {"fp32": 254, "bf16": 253})])
@pytest.mark.parametrize("spill", [0, 8])
def test_registers_of_k1_k2_refuse_a_spill(smoke, tmp_path, monkeypatch, key,
                                           regs, spill):
    """K1's and K2's lines read their two variants' registers, and not the
    fp64 template's or K7's and K8's, from build.log; a spill in either
    fails the run."""
    log = DENSE_LOG.format(k1=spill if key == "K1" else 0,
                           k2=spill if key == "K2" else 0, spill=0)
    (tmp_path / "build.log").write_text(log)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    needle = smoke.REDESIGNED[key][0]
    if spill:
        with pytest.raises(RuntimeError, match="spills"):
            smoke.registers(key, needle)
    else:
        assert smoke.registers(key, needle) == regs


def test_bench_inputs_zero_the_m0_imaginary_parts_and_the_mean(smoke):
    import ectrans_tpu_torch as ett

    res = ett.setup("O48", 47)
    sp = smoke.bench_inputs(res.nspec2, res.nsmax)
    assert [tuple(x.shape) for x in sp] == [(2, res.nspec2), (2, res.nspec2),
                                           (6, res.nspec2)]
    for x in sp:
        assert x.dtype == torch.float32
        assert not x[:, 1: 2 * (res.nsmax + 1): 2].any() and not x[:, 0].any()
    again = smoke.bench_inputs(res.nspec2, res.nsmax)
    assert all(torch.equal(a, b) for a, b in zip(sp, again))   # seed 0


def test_round_trip_is_inside_the_gate(smoke):
    """The bench round trip at O48/T47 in fp64 sits far inside the 100·eps
    (fp32) gate, and family_errors refuses a malformed output."""
    import numpy as np

    import ectrans_tpu_torch as ett

    res = ett.setup("O48", 47)
    sp = [x.double() for x in smoke.bench_inputs(res.nspec2, res.nsmax)]
    grid, out = smoke.round_trip(res, sp, torch.float64)
    assert tuple(grid.shape) == (26, res.ndgl, res.grid.ndlon)
    gate = 100 * float(np.finfo(np.float32).eps)
    ratios = [e / (gate * m) for e, m in smoke.family_errors(out, sp)]
    assert len(ratios) == 3 and max(ratios) < 1e-3, ratios
    with pytest.raises(RuntimeError, match="shape"):
        smoke.family_errors([out[0][:1], *out[1:]], sp)
    bad = [o.clone() for o in out]
    bad[2][0, 5] = np.nan
    with pytest.raises(RuntimeError, match="non-finite"):
        smoke.family_errors(bad, sp)
