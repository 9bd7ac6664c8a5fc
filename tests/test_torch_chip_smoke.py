"""chip_smoke.py's bookkeeping, on the CPU: the bound it reports for each
kernel (the larger of the bytes over the memory rate and the operations over
their peak) and its reading of the compiler's register and spill report.
The script itself runs only on a CUDA card."""

import importlib.util
import pathlib
import shutil

import numpy as np
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


def test_k4_bound_counts_fp64_issue_slots(smoke):
    """K4's bound: the table's bytes against the fp64-pipe issue slots of
    its loop (5 arithmetic instructions and a conversion at a quarter rate
    an fp32 entry; no conversion for fp64 tables) at 17e12 a second, the
    34 TFLOP/s data-sheet rate that counts an FMA as two operations."""
    n = 926_445_600                                  # TCO1279's entries
    b = smoke.k4_bound(n, 4 * n)
    assert b["slots"] == 9 and b["bound_by"] == "bytes"
    assert b["fp64_ms"] == pytest.approx(n * 9 / 17e12 * 1e3)
    assert b["bytes_ms"] == pytest.approx(4 * n / 3.35e12 * 1e3)
    assert b["bound_ms"] == b["bytes_ms"]
    assert smoke.k4_bound(n, 8 * n, torch.float64)["slots"] == 5
    b16 = smoke.k4_bound(n, 2 * n, torch.bfloat16)
    assert b16["slots"] == 9 and b16["bound_ms"] == pytest.approx(
        max(b16["bytes_ms"], b16["fp64_ms"]))
    assert smoke.k4_bound(n, n // 4)["bound_by"] == "operations"


PACK_TABLEGEN_LOG = (
    # K3 and K4 with their groups by value (Lb0E) and in a device array
    # (Lb1E)
    "ptxas info    : Compiling entry function "
    "'_ZN2k314k3_pack_kernelIfLb0EEEvNS_6Group"
    "sEPKNS_4DescEPT_iix' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 26 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k314k3_pack_kernelIdLb0EEEvNS_6Group"
    "sEPKNS_4DescEPT_iix' for 'sm_90a'\n"
    "    0 bytes stack frame, {k3} bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 30 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k314k3_pack_kernelIfLb1EEEvNS_6Group"
    "sEPKNS_4DescEPT_iix' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 27 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k314k3_pack_kernelIdLb1EEEvNS_6Group"
    "sEPKNS_4DescEPT_iix' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 31 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k418k4_tablegen_kernelIfLb0EEEvPKdS2"
    "_iS2_PKiiS2_NS_6GroupsEPKNS_5GroupE' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 48 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k418k4_tablegen_kernelIdLb0EEEvPKdS2"
    "_iS2_PKiiS2_NS_6GroupsEPKNS_5GroupE' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "{k4} bytes spill loads\n"
    "ptxas info    : Used 56 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k418k4_tablegen_kernelI13__nv_bfloat"
    "16Lb0EEEvPKdS3_iS3_PKiiS3_NS_6GroupsEPKNS_5GroupE' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 50 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k418k4_tablegen_kernelIfLb1EEEvPKdS2"
    "_iS2_PKiiS2_NS_6GroupsEPKNS_5GroupE' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 44 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k418k4_tablegen_kernelIdLb1EEEvPKdS2"
    "_iS2_PKiiS2_NS_6GroupsEPKNS_5GroupE' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 46 registers, 664 bytes cmem[0]\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k418k4_tablegen_kernelI13__nv_bfloat"
    "16Lb1EEEvPKdS3_iS3_PKiiS3_NS_6GroupsEPKNS_5GroupE' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, "
    "0 bytes spill loads\n"
    "ptxas info    : Used 45 registers, 664 bytes cmem[0]\n")


@pytest.mark.parametrize("key,variants,regs", [
    ("K3", 4, {"fp32": 26, "fp64": 30, "fp32 array": 27, "fp64 array": 31}),
    ("K4", 6, {"fp32": 48, "fp64": 56, "bf16": 50, "fp32 array": 44,
               "fp64 array": 46, "bf16 array": 45})])
@pytest.mark.parametrize("spill", [0, 8])
def test_registers_of_k3_k4_refuse_a_spill(smoke, tmp_path, monkeypatch,
                                           key, variants, regs, spill):
    """K3's and K4's lines read their variants' registers (fp32 and fp64;
    and bf16 for K4; each with its groups by value and in a device array)
    from build.log; a spill in any fails the run."""
    log = PACK_TABLEGEN_LOG.format(k3=spill if key == "K3" else 0,
                                   k4=spill if key == "K4" else 0)
    (tmp_path / "build.log").write_text(log + DENSE_LOG.format(k1=0, k2=0,
                                                               spill=0))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    needle = smoke.REDESIGNED[key][0]
    if spill:
        with pytest.raises(RuntimeError, match="spills"):
            smoke.registers(key, needle, variants)
    else:
        assert smoke.registers(key, needle, variants) == regs


class _Event:
    """A CUDA event on the host clock (the lines' arithmetic, on the CPU)."""

    def __init__(self, **kw):
        self.t = 0.0

    def record(self):
        import time

        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


@pytest.fixture
def cpu_card(smoke, tmp_path, monkeypatch):
    """chip_smoke's K3 and K4 holds on the CPU: events on the host clock,
    a launch report and a build.log of K3's and K4's variants."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda *a: None)
    monkeypatch.setattr(_build, "launch_shape", lambda stem, dt, *d: dict(
        blocks=1600, threads=256, smem_bytes=0, blocks_per_sm=8, sms=132,
        waves=1600 / 1056))
    (tmp_path / "build.log").write_text(PACK_TABLEGEN_LOG.format(k3=0, k4=0))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    return torch.device("cpu")


def test_k3_line(smoke, cpu_card, capsys):
    """K3's hold at O48 (10 fields): bit-exact; its bound counts each packed
    value read once and written once, and its line prints the bound with
    both terms and its share, the device and host times, the launch and the
    registers."""
    import ectrans_tpu_torch as ett

    res = ett.setup("O48", 47)
    k = smoke.hold_k3(res, cpu_card, torch.Generator().manual_seed(0))
    assert k["max_abs_err"] == 0.0 and k["tol"] == "bit-exact" and k["exact"]
    assert k["bound_by"] == "bytes" and k["spin_ms"] > 0
    assert k["bound_ms"] == pytest.approx(2 * 10 * res.nspec2 * 4
                                          / 3.35e12 * 1e3)
    smoke.redesign_report("K3", {"K3": k})
    line = capsys.readouterr().out
    assert line.startswith("phase 2 K3 (fp32, 10 fields, 6 groups, one "
                           "launch")
    for part in ("% of it", "operations 0.0000 ms", "moves", "GB/s",
                 "behind a spin kernel", "us a call",
                 "blocks per launch 1600 of 256 threads", "1.52 waves",
                 "registers 26 (fp32) / 30 (fp64) / 27 (fp32 array) / 31 "
                 "(fp64 array), no spills", "bit-exact"):
        assert part in line, part


def test_k4_line(smoke, cpu_card, capsys):
    """K4's hold at O48: one launch's tables against the plain recurrence
    (bit-identical), bf16 the rounded fp32; its bound counts the tables and
    the inputs read, and its line prints both terms of the bound."""
    import ectrans_tpu_torch as ett

    res = ett.setup("O48", 47)
    k = smoke.hold_k4(res, cpu_card)
    groups = res.legendre_groups()
    n = sum((m1 - m0) * J * (res.ndgnh - i0) for m0, m1, i0, J in groups)
    assert k["max_abs_err"] == 0.0 and k["exact"]
    assert k["bytes_ms"] == pytest.approx(
        (4 * n + smoke.k4_input_bytes(groups, res.ndgnh)) / 3.35e12 * 1e3)
    assert k["ops_ms"] == pytest.approx(9 * n / 17e12 * 1e3)
    smoke.redesign_report("K4", {"K4": k})
    line = capsys.readouterr().out
    assert f"{n:,} entries" in line
    for part in ("bound", "bytes", "operations", "9 fp64-pipe slots an "
                 "entry", "bf16 tables", "registers 48 (fp32) / 56 (fp64) / "
                 "50 (bf16) / 44 (fp32 array) / 46 (fp64 array) / 45 (bf16 "
                 "array), no spills", "bit-identical to the plain"):
        assert part in line, part


def test_k4_input_bytes_count_what_its_columns_read(smoke):
    """k4_input_bytes against a mask of every input entry K4's columns read
    at O48: A and B at steps 1 ... J of each m, the seeds at the group's
    latitudes, mu at every latitude a group starts at or after."""
    import numpy as np

    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.ops import legendre_tablegen as tg

    res = ett.setup("O48", 47)
    inp = tg.host_inputs(res)
    read = {k: np.zeros(v.shape, bool) for k, v in inp.items()}
    groups = res.legendre_groups()
    for m0, m1, i0, J in groups:
        for key in ("A", "B"):
            read[key][m0:m1, 1:J + 1] = True
        for key in ("mant", "exp"):
            read[key][m0:m1, i0:] = True
        read["mu"][i0:] = True
    want = sum(int(read[k].sum()) * inp[k].itemsize for k in read)
    assert smoke.k4_input_bytes(groups, res.ndgnh) == want


@pytest.mark.parametrize("key", ["K5", "K6", "K9", "K10"])
def test_library_call_computes_the_kernels_function(smoke, key):
    """K5's and K6's one-call counterparts: one torch.bmm on the operands of
    k5_library / k6_library gives the plain version's two outputs, stacked
    ([north; south] along the rows, [sym; asym] along the batch)."""
    from ectrans_tpu_torch.ops import legendre_grouped as lg

    gen = torch.Generator().manual_seed(0)
    gm, fc2, kg, ig = 3, 4, 5, 7

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64)

    if key == "K5":
        args = (rnd(gm, fc2, kg), rnd(gm, fc2, kg), rnd(gm, ig, kg),
                rnd(gm, ig, kg))
        want = lg.group_inv_plain(*args)
        got = torch.bmm(*smoke.k5_library(*args))
        got = got[:, :fc2], got[:, fc2:]
    elif key == "K6":
        args = (rnd(gm, fc2, ig), rnd(gm, fc2, ig), rnd(gm, ig, kg),
                rnd(gm, ig, kg))
        want = lg.group_dir_plain(*args)
        got = torch.bmm(*smoke.k6_library(*args))
        got = got[:gm], got[gm:]
    else:
        # K9 and K10 on 3 limb planes: the yardstick's fp32 product of the
        # summed limbs and planes gives the plain version's outputs
        from ectrans_tpu_torch.ops import legendre_planes as lpl

        J = 2 * kg
        pt = lpl.split_planes(rnd(gm, ig, J).float(), 3)
        if key == "K9":
            a = lpl._pack_inv_rows(rnd(gm, fc2, J).float(), 3)
            want = lpl.group_inv_planes_plain(a, pt, 3, fc2)
            got = torch.bmm(*smoke.k9_library(a, pt, 3, fc2))
            got = got[:, :fc2], got[:, fc2:]
        else:
            w = lpl._pack_dir_rows(rnd(gm, fc2, ig).float(),
                                   rnd(gm, fc2, ig).float(), 3)
            want = (lpl.group_dir_planes_plain(w, pt, 3, fc2),)
            both = torch.bmm(*smoke.k10_library(w, pt, 3, fc2))
            got = torch.empty_like(want[0])
            got[..., 0::2] = both[:, :fc2, 0::2]
            got[..., 1::2] = both[:, fc2:, 1::2]
            got = (got,)
        for g, w in zip(got, want):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)
        return
    for g, w in zip(got, want):
        assert g.shape == w.shape
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)


GROUPED_LOG = (
    "ptxas info    : Compiling entry function "
    "'_ZN2k518inv_grouped_kernelIfEEvPKfS2_PKT_S5_PfS6_iiii' for 'sm_90a'\n"
    "    0 bytes stack frame, {k5} bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 200 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k518inv_grouped_kernelI13__nv_bfloat16EEvPKfS3_PKT_S6_PfS7_iiii' "
    "for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 190 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k618dir_grouped_kernelIfEEvPKfS2_PKT_S5_PfS6_iiiiii' for "
    "'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, {k6} bytes spill loads\n"
    "ptxas info    : Used 232 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN2k618dir_grouped_kernelI13__nv_bfloat16EEvPKfS3_PKT_S6_PfS7_"
    "iiiiii' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 220 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_118inv_grouped_kernelEPKdS1_S1_S1_PdS2_iii' for "
    "'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 90 registers, used 1 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_118dir_grouped_kernelEPKdS1_S1_S1_PdS2_iii' for "
    "'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
    "ptxas info    : Used 96 registers, used 1 barriers\n")


@pytest.mark.parametrize("key,regs", [("K5", {"fp32": 200, "bf16": 190}),
                                      ("K6", {"fp32": 232, "bf16": 220})])
@pytest.mark.parametrize("spill", [0, 8])
def test_registers_of_k5_k6_refuse_a_spill(smoke, tmp_path, monkeypatch, key,
                                           regs, spill):
    """K5's and K6's lines read their two variants' registers, and not the
    fp64 template's, from build.log; a spill in either fails the run."""
    log = GROUPED_LOG.format(k5=spill if key == "K5" else 0,
                             k6=spill if key == "K6" else 0)
    (tmp_path / "build.log").write_text(log + DENSE_LOG.format(k1=0, k2=0,
                                                               spill=0))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    needle = smoke.REDESIGNED[key][0]
    if spill:
        with pytest.raises(RuntimeError, match="spills"):
            smoke.registers(key, needle)
    else:
        assert smoke.registers(key, needle) == regs


def test_k6_split_counts_the_clusters(smoke):
    """K6's latitude split is its launch's blocks over the unsplit grid's
    (gm x degree tiles x 20-row chunks)."""
    assert smoke.k6_split(dict(blocks=80 * 5), 80, 41) == 5
    assert smoke.k6_split(dict(blocks=80 * 11), 80, 641) == 1
    assert smoke.k6_split(dict(blocks=80 * 2 * 3), 80, 81) == 3


def test_k5_k6_lines(smoke, cpu_card, capsys):
    """K5's and K6's holds at O48 on fp32 and bf16 tables (hold_grouped):
    their bounds count the tables and operands once, the fp32 lines time
    the one-call counterparts, and each line prints the bound with both
    terms, the spin-timed device time, the launch, the registers, the bf16
    variant's numbers; K6's its latitude split per group."""
    import ectrans_tpu_torch as ett

    (_build.BUILD_DIR / "build.log").write_text(
        GROUPED_LOG.format(k5=0, k6=0))
    res = ett.setup("O48", 47)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    out = {}
    for tdt in (torch.float32, torch.bfloat16):
        out.update(smoke.hold_grouped(res, cpu_card, tdt, rnd))
    assert sorted(out) == ["K5", "K5 bf16", "K6", "K6 bf16"]
    gl = res.grouped_legendre(torch.float32, cpu_card)
    tables = sum(2 * g.psym.numel() * 4 for g in gl.groups)
    for key, rows, width in (("K5", 32, "kg"), ("K6", 20, "ig")):
        k = out[key]
        assert k["max_abs_err"] == 0.0 and k["library_ms"] > 0
        assert k["spin_ms"] > 0 and out[key + " bf16"]["library_ms"] is None
        assert k["moved"] == ("table", tables)
        ops = sum(2 * 2 * rows * g.psym.numel() for g in gl.groups)
        assert k["ops_ms"] == pytest.approx(ops / 67e12 * 1e3)
        assert len(k["shapes"]) == len(gl.groups)
        k["note"] = smoke.grouped_note(key, out)
        smoke.redesign_report(key, out)
        line = capsys.readouterr().out
        assert line.startswith(f"phase 2 {key} (fp32, {len(gl.groups)} "
                               f"groups, rows {rows})")
        for part in ("vs torch.bmm", "% of it", "table", "GB/s",
                     "behind a spin kernel", "us a call", "waves",
                     "registers", "no spills", "bf16 tables"):
            assert part in line, (key, part)
        assert ("latitude split per group" in line) == (key == "K6")


PLANES_LOG = "".join(
    "ptxas info    : Compiling entry function "
    f"'_ZN{ns}{kern}ILi{p}EEEvNS_4ArgsE' for 'sm_90a'\n"
    f"    0 bytes stack frame, {{{key}}} bytes spill stores, 0 bytes spill "
    "loads\n"
    f"ptxas info    : Used {regs} registers, used 1 barriers\n"
    for ns, kern, key in (("2k9", "17inv_planes_kernel", "k9"),
                          ("3k10", "17dir_planes_kernel", "k10"))
    for p, regs in ((3, 240), (1, 230)))


@pytest.mark.parametrize("key", ["K9", "K10"])
@pytest.mark.parametrize("spill", [0, 8])
def test_registers_of_k9_k10_refuse_a_spill(smoke, tmp_path, monkeypatch,
                                            key, spill):
    """K9's and K10's lines read their two variants' registers (3 planes and
    1), and not each other's, from build.log; a spill in either fails the
    run."""
    log = PLANES_LOG.format(k9=spill if key == "K9" else 0,
                            k10=spill if key == "K10" else 0)
    (tmp_path / "build.log").write_text(log + GROUPED_LOG.format(k5=0, k6=0))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    needle, variants, _ = smoke.REDESIGNED[key]
    if spill:
        with pytest.raises(RuntimeError, match="spills"):
            smoke.registers(key, needle, len(variants))
    else:
        assert smoke.registers(key, needle, len(variants)) == {
            "3 planes": 240, "1 plane": 230}


def test_k9_k10_lines(smoke, cpu_card, capsys):
    """K9's and K10's holds at O48 at 3 planes and at 1 (hold_planes): their
    bounds count the planes, the packed rows each kernel reads (K9 only the
    x_l half) and the outputs once and (2 fc2 + P - 1) operations an entry,
    the lines time the yardsticks (``yardstick_ms``; ``library_ms`` stays
    None) and print the bound with both terms, the spin-timed device time,
    the launch, the registers and the 1-plane numbers, K10's its latitude
    split; the padding A/B holds padded and contiguous planes to identical
    outputs."""
    import ectrans_tpu_torch as ett

    (_build.BUILD_DIR / "build.log").write_text(
        PLANES_LOG.format(k9=0, k10=0))
    res = ett.setup("O48", 47)
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen)

    out = {}
    for nplanes in (3, 1):
        out.update(smoke.hold_planes(res, cpu_card, nplanes, rnd))
    assert sorted(out) == ["K10", "K10 (1 plane)", "K9", "K9 (1 plane)"]
    for nplanes, tag in ((3, ""), (1, " (1 plane)")):
        ppl = res.planes_legendre(nplanes, cpu_card)
        planes = sum(nplanes * 2 * g.pt[0].numel() for g in ppl.groups)
        # the bytes moved: the planes; K9 the x_l rows of a (gm, 2 P 32,
        # J) and north and south (gm, 32, ig); K10 all of w (gm, 2 P 20,
        # ig) and out (gm, 20, J)
        moved = {"K9": planes, "K10": planes}
        for g in ppl.groups:
            gm, ig = g.m1 - g.m0, g.pt[0].shape[1]
            moved["K9"] += gm * (nplanes * 32 * g.J * 2 + 2 * 32 * ig * 4)
            moved["K10"] += gm * (2 * nplanes * 20 * ig * 2 + 20 * g.J * 4)
        for key, rows in (("K9", 32), ("K10", 20)):
            k = out[key + tag]
            assert k["max_abs_err"] == 0.0 and k["library_ms"] is None
            assert k["yardstick_ms"] > 0
            assert k["bytes_ms"] == pytest.approx(moved[key] / 3.35e12 * 1e3)
            assert k["spin_ms"] > 0 and k["moved"] == ("planes", planes)
            ops = sum((2 * rows + nplanes - 1) * g.pt[0].numel()
                      for g in ppl.groups)
            assert k["ops_ms"] == pytest.approx(ops / 67e12 * 1e3)
            assert k["bytes_ms"] * 3.35e12 / 1e3 > planes
            assert len(k["shapes"]) == len(ppl.groups)
    for key, rows in (("K9", 32), ("K10", 20)):
        out[key]["note"] = smoke.planes_note(key, out)
        smoke.redesign_report(key, out)
        line = capsys.readouterr().out
        assert line.startswith(f"phase 2 {key} (3 planes, "
                               f"{len(res.legendre_groups())} groups, rows "
                               f"{rows})")
        for part in ("vs torch.bmm on the summed limbs and planes",
                     "a yardstick", "% of it", "planes", "GB/s",
                     "behind a spin kernel", "us a call", "waves",
                     "registers 240 (3 planes) / 230 (1 plane), no spills",
                     "; 1 plane "):
            assert part in line, (key, part)
        assert ("latitude split per group" in line) == (key == "K10")
    ab = smoke.planes_padding_ab(res, cpu_card, rnd)
    assert sorted(ab) == ["K10 contiguous", "K10 padded", "K10 rel",
                          "K9 contiguous", "K9 padded", "K9 rel"]
    assert min(ab[k] for k in ab if "rel" not in k) > 0
    assert ab["K9 rel"] == ab["K10 rel"] == 0.0
    smoke.padding_report(ab)
    assert "padded rows" in capsys.readouterr().out


STREAM_LOG = (
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_115k11_copy_kernelEPK6float4PS1_x' for 'sm_90a'\n"
    "    0 bytes stack frame, {k11} bytes spill stores, 0 bytes spill "
    "loads\n"
    "ptxas info    : Used 24 registers, used 0 barriers\n"
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_117k12_reduce_kernelEPK6float4PS1_xix' for 'sm_90a'\n"
    "    0 bytes stack frame, 0 bytes spill stores, {k12} bytes spill "
    "loads\n"
    "ptxas info    : Used 48 registers, used 1 barriers, 32 bytes smem\n"
    "ptxas info    : Compiling entry function "
    "'_ZN12_GLOBAL__N_116k12_final_kernelEPK6float4PS1_ii' for 'sm_90a'\n"
    "    0 bytes stack frame, {fin} bytes spill stores, 0 bytes spill "
    "loads\n"
    "ptxas info    : Used 32 registers, used 1 barriers, 4096 bytes smem\n")


@pytest.mark.parametrize("key,needle,regs", [
    ("K11", "15k11_copy_kernel", 24), ("K12", "17k12_reduce_kernel", 48),
    ("K12 final", "16k12_final_kernel", 32)])
@pytest.mark.parametrize("spill", [0, 8])
def test_registers_of_k11_k12_refuse_a_spill(smoke, tmp_path, monkeypatch,
                                             key, needle, regs, spill):
    """K11's and K12's lines read their kernels' registers (K12's two
    launches apart) from build.log; a spill in any fails the run."""
    log = STREAM_LOG.format(k11=spill if key == "K11" else 0,
                            k12=spill if key == "K12" else 0,
                            fin=spill if key == "K12 final" else 0)
    (tmp_path / "build.log").write_text(log + DENSE_LOG.format(k1=0, k2=0,
                                                               spill=0))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    assert needle == (smoke.K12_FINAL if key == "K12 final"
                      else smoke.REDESIGNED[key][0])
    if spill:
        with pytest.raises(RuntimeError, match="spills"):
            smoke.registers(key, needle, 1)
    else:
        assert smoke.registers(key, needle, 1) == {"fp32": regs}


def test_k11_k12_lines(smoke, cpu_card, capsys, monkeypatch):
    """K11's and K12's holds (hold_streaming) on a small tensor: K11
    bit-exact, K12 within 1e-6; the bounds count x read once (K11: and its
    copy written), both are timed against their one PyTorch call and behind
    a spin kernel, and the lines print the call, the bound, the launch, the
    registers and K12's plan."""
    from ectrans_tpu_torch import roofline

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(roofline, "_sm_count", lambda index: 132)
    (_build.BUILD_DIR / "build.log").write_text(
        STREAM_LOG.format(k11=0, k12=0, fin=0))
    x = torch.randn(512, 512, generator=torch.Generator().manual_seed(0))
    out = smoke.hold_streaming(x)
    k11, k12 = out["K11"], out["K12"]
    assert k11["max_abs_err"] == 0.0 and k11["tol"] == "bit-exact"
    assert k12["rel"] <= 1e-6 and k12["tol"] == "1e-06 rel"
    nbytes = x.numel() * 4
    assert k11["bytes_ms"] == pytest.approx(2 * nbytes / 3.35e12 * 1e3)
    assert k12["bytes_ms"] == pytest.approx((nbytes + 8 * 512 * 4)
                                            / 3.35e12 * 1e3)
    for k in (k11, k12):
        assert k["bound_by"] == "bytes" and k["library_ms"] > 0
        assert k["spin_ms"] > 0 and k["host_ms"] > 0
    for key, call, moved in (("K11", "x.clone()", "read + write"),
                             ("K12", "sum", "reads")):
        smoke.redesign_report(key, out)
        line = capsys.readouterr().out
        assert line.startswith(f"phase 2 {key} (fp32 (512, 512), 1 MiB")
        for part in (f"vs {call}", "in turns", "% of it", f"{moved} ",
                     "behind a spin kernel", "us a call", "waves",
                     "no spills"):
            assert part in line, (key, part)
    assert "64 slices of 1 octets" in line and "second launch" in line



def test_k3_library_call_computes_k3s_function(smoke):
    """K3's one-call counterpart: torch.take on the concatenated group rows
    and the index k3_library makes gives the packed layout, bit for bit."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.ops import pack

    res = ett.setup("O48", 47)
    g = torch.Generator().manual_seed(3)
    rows = [torch.randn(m1 - m0, 2 * 10, J + extra, generator=g)
            for extra, (m0, m1, _, J) in zip(range(9),
                                             res.legendre_groups())]
    flat, idx = smoke.k3_library(rows, res)
    assert idx.shape == (10, res.nspec2) and flat.dim() == 1
    assert torch.equal(torch.take(flat, idx),
                       pack.packed_from_group_rows_plain(rows, res))


def test_phase8_helpers(smoke, cpu_card):
    """Phase 8's helpers on the CPU at O48 through a handle on the CPU: the
    packet comparison (npromatr 4 against the single call), the gate share,
    the cotangents, and the adjoint identity with the "xla" and the "dense"
    forward; each helper flags a wrong result."""
    import ectrans_tpu_torch as ett

    st = ett.SpectralTransform("O48", 47, device=cpu_card)
    res = st.res
    sp = smoke.bench_inputs(res.nspec2, res.nsmax)
    grid, out = smoke.handle_round_trip(st, sp)
    pgrid, pout = smoke.handle_round_trip(st, sp, smoke.NPROMATR)
    assert tuple(grid.shape) == (26, res.ndgl, res.grid.ndlon)
    assert smoke.packet_share([pgrid, *pout], [grid, *out]) <= 0.01
    bad = pgrid.clone()
    bad[3, 5, 7] += 1e-3 * grid.abs().max()
    assert smoke.packet_share([bad, *pout], [grid, *out]) > 1.0
    assert smoke.gate_share(out, sp) < smoke.DENSE_GATE_SHARE
    assert smoke.gate_share(pout, sp) < smoke.DENSE_GATE_SHARE

    y_grid, y_spec = smoke.cotangents(res, grid.shape[0], cpu_card)
    assert y_grid.shape == grid.shape
    assert [tuple(y.shape) for y in y_spec] == [tuple(x.shape) for x in sp]
    assert not any(y[:, 1: 2 * (res.nsmax + 1): 2].any() for y in y_spec)
    flags = ett.InvFlags(scders=True, uvders=True)
    inv_ad = st.inv_trans_adj(y_grid, 2, 6, flags=flags)
    dir_ad = st.dir_trans_adj(*y_spec, nfld_uv=2, nfld_sc=6)
    x_grid = smoke.bench_fields(grid)
    assert [x.shape[0] for x in x_grid] == [2, 2, 6]
    xgrid = ett.inv_trans(res, *sp, flags=flags, _engine="xla")
    xout = ett.dir_trans(res, *x_grid, _engine="xla")
    for fg, fo in ((xgrid, xout), (grid, out)):
        r_inv, r_dir = smoke.handle_identities(sp, x_grid, fg, fo, y_grid,
                                               y_spec, inv_ad, dir_ad)
        assert r_inv < smoke.ADJOINT_TOL and r_dir < smoke.ADJOINT_TOL
    wrong = [1.01 * a for a in inv_ad]
    assert smoke.handle_identities(sp, x_grid, grid, out, y_grid, y_spec,
                                   wrong, dir_ad)[0] > smoke.ADJOINT_TOL
    assert smoke.inner([torch.ones(2), torch.ones(3)],
                       [torch.full((2,), 2.0), torch.ones(3)]) == 7.0


def test_phase8_timing_helpers(smoke, cpu_card, monkeypatch):
    """first_call and median_peak: the result of the first call, its
    seconds, the median of n more calls and the peak memory."""
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda: 2**31)
    calls = []
    result, t = smoke.first_call(lambda: calls.append(1) or "out")
    assert result == "out" and t >= 0 and calls == [1]
    med, peak = smoke.median_peak(lambda: calls.append(1), 3)
    assert len(calls) == 4 and med >= 0 and peak == 2.0


def test_phase9_helpers(smoke):
    """Phase 9's helpers on the CPU at T47 onto a 37 x 36 lat-lon grid
    with poles (every row folds): the sample rows, the host's direct sums
    against inv_trans_latlon in fp64, the field shares, the truncated
    round trip's split, the adjoint identity, and K4's hold at the lat-lon
    nodes; each flags a wrong result."""
    import ectrans_tpu_torch as ett

    res = ett.setup("F24", 47)
    ll = ett.LatLonGrid(37, 36)
    rows = smoke.sample_rows(ll.nlat)
    assert rows[:2] == [0, 1] and rows[-2:] == [35, 36] and 18 in rows
    assert len(rows) >= 8
    assert smoke.sample_rows(721) == [0, 1, 90, 180, 359, 360, 361, 540,
                                      719, 720]
    sp = [x.double() for x in smoke.bench_inputs(res.nspec2, res.nsmax)]
    flags = ett.InvFlags(scders=True, uvders=True)
    grid = ett.inv_trans_latlon(res, ll, *sp, flags=flags,
                                dtype=torch.float64)
    want = smoke.latlon_direct(res, ll, sp, flags, rows)
    assert want.shape == (26, len(rows), 36)
    assert max(smoke.field_shares(grid[:, rows], want, 1.0)) < 1e-12
    bad = grid[:, rows].clone()
    bad[20, 3, 5] += 1e-4 * want[20].abs().max()
    assert max(smoke.field_shares(bad, want, smoke.LATLON_GATE)) > 1.0
    flags_all = ett.InvFlags(vorgp=True, divgp=True, scders=True,
                             uvders=True)
    g_all = ett.inv_trans_latlon(res, ll, *sp, flags=flags_all,
                                 dtype=torch.float64)
    w_all = smoke.latlon_direct(res, ll, sp, flags_all, rows)
    assert max(smoke.field_shares(g_all[:, rows], w_all, 1.0)) < 1e-12

    sc_t = smoke.truncate(sp[2], res, 20)
    assert not sc_t[:, torch.from_numpy(res.packed_gather_n > 20)].any()
    low, high = smoke.truncated_errors(sc_t + 1e-3 * (sp[2] - sc_t), sc_t,
                                       res, 20)
    assert low == 0.0 and 0 < high <= 1e-3

    y = torch.randn(grid.shape, generator=torch.Generator().manual_seed(1))
    assert smoke.latlon_identity(res, ll, [x.float() for x in sp], flags,
                                 y.float()) < smoke.ADJOINT_TOL
    err, scale, same = smoke.hold_k4_latlon(res, ll, torch.device("cpu"))
    assert err == 0.0 and same and scale > 1.0


def test_phase10_helpers(smoke):
    """Phase 10's helpers on the CPU at 64 x 48 (C+I 53 x 37, 1.3 km): the
    inputs' physical-field mask, the closed-form modes against the handle
    in fp64, the round-trip shares (the mean wind against its wind field),
    and the biperiodicization round trip in fp32 against fp64."""
    import ectrans_tpu_torch as ett

    lt = ett.LamTransform(64, 48, nxux=53, nyux=37, dx=1300.0, dy=1300.0,
                          dtype=torch.float64, device="cpu")
    res = lt.res
    vor, div, sc, mu, mv = smoke.lam_inputs(res, 2, 3)
    assert vor.shape == (2, res.nspec2) and sc.shape == (3, res.nspec2)
    assert mu.shape == mv.shape == (2,) and vor.dtype == torch.float32
    kill = torch.from_numpy(((res.packed_m == 0) & (res.packed_c >= 2))
                            | ((res.packed_n == 0) & (res.packed_c % 2 == 1)))
    assert not any(x[:, kill].any() for x in (vor, div, sc))
    assert not vor[:, :4].any() and not div[:, :4].any()
    assert smoke.lam_mode_share(lt, 5, 3) < 1e-12
    assert smoke.lam_mode_fields(res.grid, 5, 3).shape == (3, 4, 48, 64)

    x = [vor, div, sc, mu, mv]
    grid = ett.lam.inv_trans_lam(res, *x)
    u, v = grid[:2], grid[2:4]
    out = ett.lam.dir_trans_lam(res, u, v, grid[4:7])
    share, own = smoke.lam_round_trip_shares(out, x, u, v)
    assert share < 0.1 and own > share
    wrong = list(out)
    wrong[3] = out[3] + 1e-3 * u.abs().max()
    assert smoke.lam_round_trip_shares(wrong, x, u, v)[0] > 1.0

    field = smoke.smooth_ci_field(res.grid)
    assert field.shape == (1, 37, 53) and field.dtype == torch.float64
    ext64, back64 = smoke.biper_round_trip(res, field, torch.float64)
    ext, back = smoke.biper_round_trip(res, field, torch.float32)
    assert ext.dtype == back.dtype == torch.float32
    assert torch.equal(ext64[:, :37, :53], field)
    assert max(smoke.field_shares(back, back64, smoke.LATLON_GATE)) < 1.0


# -- phase 11: the distributed transforms on four ranks sharing the card ----

def test_mesh_rows_cover_the_phase(smoke):
    """The rows (a)-(f), in the order the ranks run them ((e) shares (a)'s
    TCO1279 handle); (b) and (c) on all six meshes, each within the four
    ranks; the full-width configuration."""
    rows = smoke.mesh_rows()
    assert [k for k, _, _ in rows] == ["a", "e", "b", "c", "d", "f"]
    assert smoke.MESH_SHAPES == ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1),
                                 (1, 4))
    for key, _, meshes in rows:
        assert all(w * v <= smoke.MESH_WORLD for w, v in meshes), key
        if key in "bc":
            assert meshes == smoke.MESH_SHAPES
    cfg = smoke.MESH_CONFIG
    assert (cfg["bench"], cfg["latlon"], cfg["small"]) == (
        "TCO1279", (721, 1440), ("O160", 159))
    assert cfg["lam"] == smoke.LAM_DOMAIN and cfg["device"] == "cuda"
    assert smoke.MESH_LIMIT < 1200 / 2
    assert (smoke.MESH_FP64_TOL, smoke.MESH_PAIR_TOL) == (1e-12, 1e-13)


def test_mesh_tolerance_checks(smoke):
    """family_stats per family of a shard, merged over the ranks (largest
    difference, largest value, bit identity), as a share of the gate; an
    empty shard counts nothing."""
    want = torch.arange(12.0).reshape(6, 2)
    got = want.clone()
    got[1, 0] += 0.5        # family 0 (fields 0-1)
    got[5, 1] -= 2.0        # family 2 (fields 3-5)
    stats = smoke.family_stats(got, want.numpy(), [2, 1, 3])
    assert stats == [[0.5, 3.0, False], [0.0, 5.0, True], [2.0, 11.0, False]]
    empty = smoke.family_stats(got[:0], want[:0].numpy(), [0])
    assert empty == [[0.0, 0.0, True]]
    other = [[0.25, 7.0, True], [1.0, 1.0, False], [0.0, 20.0, True]]
    merged = smoke.merge_families([stats, other])
    assert merged == [[0.5, 7.0, False], [1.0, 5.0, False],
                      [2.0, 20.0, False]]
    assert smoke.worst_share(merged, 0.01) == pytest.approx(
        max(0.5 / 0.07, 1.0 / 0.05, 2.0 / 0.2))


def _mesh_reps(smoke, k3=1):
    """Four ranks' phase 11 reports, as mesh_rank writes them, of a run
    that passes (bit-identical shards)."""
    ok = [0.0, 1.0, True]
    reps = []
    for r in range(4):
        a = dict(setup=1.0, first=2.0, median=3.0, peak=4.0, groups=16,
                 launches={"K1": 16, "K2": 16, "K3": k3 if r == 2 else 1,
                           "K4": 1},
                 traffic={"TRMTOL": 2**20, "grid": 2**21},
                 grid=[ok] * 7, spec=[ok] * 3,
                 gate=[[1e-6, 2.0], [1e-6, 2.0], [1e-6, 3.0]], seconds=5.0)
        e = dict(first=1.0, peak=2.0, seconds=1.0, fields=[ok] * 26,
                 launches={"K1": 0, "K2": 0, "K3": 0, "K4": 1})
        b = {f"{w}x{v}": dict(inv=1e-15, dir=2e-15, launches={})
             for w, v in smoke.MESH_SHAPES if r < w * v}
        b["seconds"] = 1.0
        if r == 0:
            b["pairs"] = 1e-15
        c = {key: dict(launches={"K1": 16, "K2": 16, "K3": 1, "K4": 1},
                       grid=[ok] * 9, spec=[ok] * 3)
             for key in [f"{w}x{v}" for w, v in smoke.MESH_SHAPES
                         if r < w * v] + ["2x2 bf16"]}
        c["seconds"] = 1.0
        d = {"seconds": 1.0}
        if r < 2:
            d["1x2"] = dict(inv=0.0, dir=0.0, nout=30)
        f = dict(first_inv=1.0, first_dir=1.0, peak=1.0, launches={},
                 grid=[ok] * 9, spec=[ok] * 5, seconds=1.0)
        reps.append(dict(a=a, e=e, b=b, c=c, d=d, f=f))
    return reps


def test_mesh_report_merges_launches_into_the_kernels_line(smoke, capsys):
    """mesh_report checks every row and returns (a)'s K1-K4 and (e)'s K4
    summed over the ranks, which main adds to the kernels line's launches
    (merge_launches); a rank without its K3 launch fails the phase."""
    added = smoke.mesh_report(_mesh_reps(smoke), 1.0, 2.0, "card")
    assert added == {"K1": 64, "K2": 64, "K3": 4, "K4": 8}
    out = capsys.readouterr().out
    for row in "abcdef":
        assert f"phase 11 ({row})" in out
    launches = {"K1": 144, "K3": 10, "K5": 16}
    assert smoke.merge_launches(launches, [added]) == added
    assert launches == {"K1": 208, "K2": 64, "K3": 14, "K4": 8, "K5": 16}
    with pytest.raises(RuntimeError, match="rank 2 launched"):
        smoke.mesh_report(_mesh_reps(smoke, k3=0), 1.0, 2.0, "card")


def test_phase12_flags_are_the_drivers(smoke):
    """Phase 12's flags parse with the port's drivers: bench.py's field set
    (2 vor/div pairs, 6 scalars, 26 grid fields) at TCO1279, (c) in fp64 at
    -n 2, and phase 10's LAM domain and field count."""
    from ectrans_tpu_torch import InvFlags, num_inv_output_fields
    from ectrans_tpu_torch.programs import benchmark, lam_benchmark

    a = benchmark.parse_args(list(smoke.PROGRAM_BENCH))
    nuv, nsc = a.nlev, a.nfld * a.nlev
    assert (a.grid, a.niter, a.check, nuv, nsc) == ("TCO1279", 5, 100.0,
                                                    2, 6)
    assert num_inv_output_fields(nuv, nsc, InvFlags(
        scders=a.scders, uvders=a.uvders)) == 26
    c = benchmark.parse_args(list(smoke.PROGRAM_BENCH + smoke.PROGRAM_FP64))
    assert (c.dtype, c.niter) == ("float64", 2)
    lam = lam_benchmark.parse_args(list(smoke.PROGRAM_LAM))
    d = smoke.LAM_DOMAIN
    assert (lam.nlon, lam.nlat, lam.nlon_ci, lam.nlat_ci, lam.dx, lam.dy,
            lam.nfld) == (d["nx"], d["ny"], d["nxux"], d["nyux"], d["dx"],
                          d["dy"], smoke.LAM_NSC)


def test_phase12_helpers(smoke, tmp_path, capsys):
    out = ("grid F24\n"
           "inverse transform            avg     2.542 ms  min     2.086  "
           "max     2.998  med     2.540\n"
           "e-direct transform     avg    0.392 ms  min    0.391  max    "
           "0.392  med    0.392\n")
    assert smoke.medians_ms(out) == {"inverse transform": 2.54,
                                     "e-direct transform": 0.392}
    path = tmp_path / "c.sum"
    path.write_text("sc0 fe6c235f0283e1f9 6.77012465262143e+01\n"
                    "sc1 797974293a395259 6.71592684795831e+01\n")
    assert smoke.checksum_norms(str(path)) == [67.7012465262143,
                                               67.1592684795831]

    def failing(argv):
        print("check: ... -> FAIL")
        raise SystemExit(1)

    with pytest.raises(SystemExit):
        smoke.run_program(failing, ["-n", "1"], "12(x)")
    assert "  12(x) | check: ... -> FAIL" in capsys.readouterr().out
    rep, printed = smoke.run_program(lambda argv: (print(argv), 7)[1],
                                     ("-n", "1"), "12(y)")
    assert rep == 7 and printed == "['-n', '1']\n"


def test_run_command_fails_on_exit_code_and_limit(smoke, capsys):
    assert "3\n" in smoke.run_command(("timeit", "-n", "1", "-r", "1",
                                       "print(3)"), "12(z)", 60)
    with pytest.raises(RuntimeError, match="exited 2"):
        smoke.run_command(("json.tool", "/nonexistent/file"), "12(z)", 60)
    with pytest.raises(RuntimeError, match="outlasted its 2 s limit"):
        smoke.run_command(("timeit", "-n", "1", "-r", "1",
                           "import time; time.sleep(30)"), "12(z)", 2)
    assert "12(z) |" in capsys.readouterr().out


def test_phase13_flags_and_packets(smoke):
    """Phase 13 (c): the IFS driver at TCO1279 L137 in packets of 8 levels:
    18 packets a direction an iteration, of (8, 17), (8, 16) and (1, 2)
    (vor/div pairs, scalars)."""
    from ectrans_tpu_torch.programs import benchmark_ifs

    a = benchmark_ifs.parse_args(list(smoke.PROGRAM_IFS))
    assert (a.grid, a.nlev, a.npromatr, a.niter, a.check, a.dtype) == (
        "TCO1279", 137, 8, 3, 100.0, "float32")
    loop = benchmark_ifs.packets(a.nlev, a.npromatr)
    shapes = [(hi - lo, len(sc)) for lo, hi, sc in loop]
    assert len(loop) == 18 and set(shapes) == {(8, 17), (8, 16), (1, 2)}
    assert shapes[0] == (8, 17) and shapes[-1] == (1, 2)
    assert sorted(i for _, _, sc in loop for i in sc) == list(range(275))


def test_phase13_helpers(smoke):
    assert smoke.union_ms([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6)]) == 3.0
    assert smoke.union_ms([]) == 0.0
    want = torch.tensor([[[1.0, -2.0]], [[0.0, 0.0]]])
    got = want + torch.tensor([[[0.0, 2 * smoke.FOURIER_GATE]],
                               [[0.0, 0.0]]])
    # field 0: 2 gate units over a max of 2 -> 1.0; the zero field 0
    assert smoke.field_share(got, want) == pytest.approx(1.0)
    p = smoke.device_profile(torch.device("cpu"), lambda: torch.ones(3) + 1)
    assert p["n"] == 0 and p["wall_ms"] > 0
    assert "not measured" in smoke.profile_note(p)


def test_phase13_ab_busy_and_tail_lines_on_the_cpu(smoke):
    """Phase 13 (a), (b) and (d) at O48 on the CPU: both layers within 100
    eps of each field's max of each other and of fp64, a line each; each
    round trip's error tail well inside the gate."""
    cpu = torch.device("cpu")
    res, sp, four, grid = smoke.fourier_inputs(cpu, "O48")
    assert tuple(four.shape) == (26, 2, res.M, res.ndgl)
    assert tuple(grid.shape) == (26, res.ndgl, res.grid.ndlon)
    lines = smoke.fourier_ab(cpu, res, four, grid)
    assert len(lines) == 6
    assert sum("buckets vs rows" in line for line in lines) == 2
    lines = smoke.busy_shares(cpu, res, sp)
    assert len(lines) == 4 and "not measured" in lines[-1]
    assert all("scalars" in line for line in lines[:2])
    lines = smoke.error_tail(cpu, res, sp)
    assert [line.split(":")[0] for line in lines] == [
        "phase 13 (d) round trip",
        "phase 13 (d) inverse alone (fp32 inverse, fp64 direct)",
        "phase 13 (d) direct alone (fp64 inverse rounded to fp32, fp32 "
        "direct)"]
    shares = [float(w) for line in lines for w in
              line.replace(";", " ").split() if w.startswith("0.")]
    assert shares and max(shares) < 0.65


# phase 14 at O48 and below: (a) on a full F48 grid at T95 (a reduced
# grid's round trip aliases near n = nsmax above the norm gate at this
# size), the LAM on 64 x 48, the assets at TCO47 (O48), the C API at TCO47
SURFACES_SMALL = dict(gauss=("F48", 95),
                      lam=dict(nx=64, ny=48, nxux=53, nyux=37, dx=1300.0,
                               dy=1300.0),
                      assets="TCO47", capi="TCO47", capi_limit=300)


def test_phase14_config(smoke):
    cfg = smoke.SURFACES
    assert cfg["gauss"] == ("TCO1279", None) and cfg["capi"] == "TCO1279"
    assert cfg["assets"] == "TCO639" and cfg["lam"] == smoke.LAM_DOMAIN
    assert smoke.SURFACE_NORM_GATE == 100 * np.finfo(np.float64).eps


def test_phase14_helpers(smoke):
    fa = smoke.fa_spectrum(13)
    assert fa.shape == (14 * 14,)
    assert np.array_equal(fa, smoke.fa_spectrum(13))
    want = np.array([1.0, -0.5])
    assert smoke.eps_share(want + [0.0, 2.0**-40], want) == 2.0**12
    spec = np.random.default_rng(2).standard_normal(12)
    from ectrans_tpu_torch import compat4py as c4
    np.testing.assert_allclose(
        smoke.fft1d_direct(spec, 5, 32),
        c4.sp2gp_fft1d4py(12, 5, spec, 32, device="cpu"), atol=1e-13)
    # the launch check holds on the card only
    smoke.expect_launches(torch.device("cpu"), {"K1": 0}, {"K1": 16}, "(x)")
    with pytest.raises(RuntimeError, match="expected"):
        smoke.expect_launches(torch.device("cuda", 0), {"K1": 0},
                              {"K1": 16}, "(x)")


def test_phase14_assets_against_tables(smoke):
    """assets_vs_tables reads every PRPNM column against the full-n tables
    and sees one changed entry, in a table column or in the rows that must
    be 0."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch import compat4py as c4

    grid = ett.make_grid("TCO47")
    ks, T, kloen = grid.ndgl, grid.nsmax, np.asarray(grid.nloen)
    ncol = (T + 2) * (T + 3) // 2 - 1
    _, _, prpnm = c4.get_legendre_assets(ks, T, ks, ncol, kloen)
    res = ett.setup(c4._gauss_grid(ks, T, kloen))
    fl = res.full_legendre(torch.float64, "cpu")
    assert smoke.assets_vs_tables(prpnm, res, fl) == 0.0
    bad = prpnm.copy()
    bad[-1, ncol // 2] += 1e-9
    assert smoke.assets_vs_tables(bad, res, fl) > 1e-10
    g = fl.groups[-1]
    assert g.i0 > 0
    bad = prpnm.copy()
    bad[0, -1] = 1e-9
    assert smoke.assets_vs_tables(bad, res, fl) > 1e-10


@pytest.mark.skipif(shutil.which("cc") is None and shutil.which("gcc")
                    is None, reason="no C compiler")
def test_phase14_on_the_cpu(smoke, capsys):
    """Phase 14 end to end on the CPU at SURFACES_SMALL: every check but
    the launch counts (the plain versions count none), a line each."""
    out = smoke.phase_surfaces(torch.device("cpu"), smoke.launch_counters(),
                               SURFACES_SMALL)
    assert out == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    lines = capsys.readouterr().out.splitlines()
    heads = [line.split(" ", 3)[2] for line in lines
             if line.startswith("phase 14 (")]
    assert heads == ["(a)", "(b)", "(c)", "(d)"]
    assert any("C API test OK" in line for line in lines)


@pytest.mark.parametrize("ngroups", [24, 48])
def test_k3_k4_holds_past_16_groups(smoke, cpu_card, ngroups):
    """Phase 2's K3 and K4 holds at a group count past their 16 by-value
    groups (O48: 24 groups of 2 m, one group an m): bit-exact, K4's plain
    version not timed."""
    import ectrans_tpu_torch as ett

    res = ett.setup("O48", 47)
    k3 = smoke.hold_k3(res, cpu_card, torch.Generator().manual_seed(0),
                       ngroups)
    assert k3["exact"] and k3["library_ms"] > 0
    k4 = smoke.hold_k4(res, cpu_card, ngroups)
    assert k4["exact"] and k4["plain_ms"] is None
    assert k4["what"] == f"fp32 tables, {ngroups} groups, one launch"


TABLES_SMALL = dict(fp64="O48", fp32="O160", bench="O48", groups=(3, 24),
                    world=2)


def test_phase15_on_the_cpu(smoke, capsys):
    """Phase 15 end to end on the CPU at TABLES_SMALL, against phase 4's
    round trip at O48: every check but the launch counts (the plain
    versions count none), a line each for (a), (b), (c) at each count and
    (d)."""
    import ectrans_tpu_torch as ett

    res = ett.setup("O48", 47)
    sp = smoke.bench_inputs(res.nspec2, res.nsmax)
    grid, out = smoke.round_trip(res, sp, torch.float32)
    got = smoke.phase_tables(torch.device("cpu"), smoke.launch_counters(),
                             (grid, list(out)), 0.5, TABLES_SMALL)
    assert got == {"K1": 0, "K2": 0, "K3": 0, "K4": 0}
    lines = capsys.readouterr().out.splitlines()
    heads = [line.split(" ", 3)[2] for line in lines
             if line.startswith("phase 15 (")]
    assert heads == ["(a)", "(b)", "(c)", "(c)", "(d)"]
    assert "ECTRANS_TPU_LEG_GROUPS 24 (24 groups)" in lines[3]


def test_phase13_chirp_lines_on_the_cpu(smoke, cpu_card):
    """Phase 13 (e) at O48 on the CPU (5 fields through synthesis, 3
    through analysis): each staged stage's line with its bytes and bound,
    F5's line, a line a bucket (nfft, radices, shared memory, fp64 rate)
    and the layer's; the plain stages run for the kernels there, so they
    agree exactly and count no launch."""
    from ectrans_tpu_torch.ops import fourier as fz

    lines = smoke.chirp_kernels(cpu_card, "O48",
                                dict(synthesis=5, analysis=3))
    assert len(lines) == 16
    for way, n in (("synthesis", 5), ("analysis", 3)):
        got = [line for line in lines if line.startswith(
            f"phase 13 (e) {way} ")]
        assert [line.split()[4] for line in got[:6]] == [
            "F4", "F1", "FFT", "F2", "F3", "F5"]
        assert all(f"({n} fields, {(n + 1) // 2} pairs, 1 buckets)" in line
                   for line in got[:6])
        assert "cuFFT (no plain stage)" in got[2]
        assert "0 torch.fft calls a staged call" in got[2]
        assert "launches 0 a call" in got[5]
        assert ("vs the plain pipeline 0.00, vs the staged kernels 0.00 "
                "fp32 ulps") in got[5]
        assert "fp64" in got[5] and "GFLOP at 34 TFLOP/s" in got[5]
        assert got[6].startswith(f"phase 13 (e) {way} F5 bucket 0: nfft ")
        smem = fz.fused_smem_bytes(int(got[6].split()[8]))
        assert f"shared memory {smem} B a block, fused" in got[6]
        assert "0 launches and 0 torch.fft calls, 0 device activities" in (
            got[7])
        assert "every bucket staged" in got[7]


def test_chirp_bytes_count_each_value_once(smoke):
    """Phase 13 (e)'s bytes at O48 (one bucket): F1 synthesis reads each
    kept input once, writes the pass array once; F3 analysis writes every
    (field, part, m, row) once; F2 and each of the two FFTs read and write
    the array."""
    import ectrans_tpu_torch as ett
    from ectrans_tpu_torch.ops import fourier as fz

    res = ett.setup("O48", 47)
    bt = fz.bucketed_tables(res, "cpu")
    (bk,) = bt.buckets
    arr = 2 * bk.rows.shape[1] * bk.nfft * 16
    syn = smoke.chirp_bytes(bt, bk, "synthesis", 3, 4, res.M)
    kept = int(bt.keep.sum()) * 3 * 4
    assert syn["F1"] == kept + bk.syn_in.numel() * 16 + arr
    assert syn["FFT"] == 4 * arr
    assert syn["F2"] == 2 * arr + bk.syn_bh.numel() * 16
    ana = smoke.chirp_bytes(bt, bk, "analysis", 4, 8, res.M)
    assert ana["F3"] == (2 * bk.rows.shape[1] * (2 * bk.mb + 1) * 16
                         + bk.ana_out.numel() * 16
                         + 4 * 2 * res.M * res.ndgl * 8)


def test_chirp_want_counts_fused_and_staged_buckets(smoke):
    """The layer's counts a call: F4 once, F5 once a fused bucket, F1, F2
    and F3 once and two torch.fft calls a staged bucket; at O48 (one
    bucket, nfft 480) the bucket fuses."""
    import ectrans_tpu_torch as ett

    want = smoke.chirp_want(10, 2, 3, 1)
    assert want == {"F4s": 3, "F1s": 6, "F3s": 6, "F4a": 1, "F1a": 2,
                    "F3a": 2, "F2": 8, "FFT": 16, "F5s": 30, "F5a": 10}
    assert set(want) == set(smoke.chirp_counters())
    assert smoke.bucket_split(ett.setup("O48", 47),
                              torch.device("cpu")) == (1, 0)
