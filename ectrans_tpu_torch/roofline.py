"""Streaming-rate probes on one CUDA card, kernels K11 and K12.

Counterpart of ``tools/roofline.py``: what a hand-written kernel reaches in
device-memory bandwidth on this card, and the dense Legendre kernels at the
JAX tool's dense shape beside it, so that the kernels' table rates can be read
against a measured ceiling as well as the data sheet's.

    python -m ectrans_tpu_torch.roofline

Probes, one printed line each (cheapest first), all on fp32 x of shape
(262,144, 512), 512 MiB, as in the JAX probe:

1. ``x + 1``: PyTorch's own streaming rate (read + write GB/s);
2. K11 ``stream_copy``, out = x (``csrc/roofline.cu``): read + write GB/s;
3. K12 ``read_reduce``, out[r, c] = sum over rows i = r (mod 8) of x[i, c],
   (8, 512): read GB/s (the Legendre kernels' table stream is a read);
4. K1 against K7 at the JAX roofline tool's dense shape (gm 80, J 2562,
   ig 1280, fc2 32: TCO1279 group 0's gm and ig, with J twice that group's
   1282) on fp32 and on bf16 tables: ms and table GB/s each;
5. the largest difference of K7 from K1, relative to K1's largest output;
6. K2 against K8 at the same shapes (fc2 32): ms each, and their largest
   relative difference.

The JAX probe's MXU pass-count and tile-size scans have no counterpart:
the port's kernels make one FMA per term and their tiles are compile-time
constants.  Results go to stdout and to ``_build/roofline.json`` beside the
kernel library.  A CPU tensor takes the plain versions (``x.clone()`` and a
reshape-sum), after the same checks; the probes need a CUDA card and refuse
to run without one.
"""

from __future__ import annotations

import functools
import json

import torch

from . import _build

N_ROWS, N_COLS = 512 * 512, 512     # fp32, 512 MiB
OCTET = 8                           # K12's output rows
# K11's launch (csrc/roofline.cu): 16-byte words a block (256 threads, a
# word each)
COPY_CHUNK = 256
# K12's launch: float4 lanes of an octet a block owns (256 threads, four
# each), 16-byte words a ring stage holds (32 KB), blocks an SM
REDUCE_WINDOW = 1024
STAGE_WORDS = 2048
REDUCE_BLOCKS_PER_SM = 1
ALIGN = 16                          # bytes; both kernels move float4
# the JAX roofline tool's dense shape (tools/roofline.py): TCO1279 group 0's
# gm and ig, J 2562 (twice that group's J of 1282)
GROUP0 = dict(gm=80, J=2562, ig=1280, fc2=32)


def _check_stream(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if x.data_ptr() % ALIGN:
        raise ValueError(f"{name} takes a tensor that starts 16-byte "
                         "aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def copy_plan(n: int) -> dict:
    """K11's launch for n fp32 values: ``words`` 16-byte words, ``blocks``
    blocks, block b copying the words [b per, min((b + 1) per, words))."""
    words = n // 4
    return dict(words=words, per=COPY_CHUNK, blocks=-(-words // COPY_CHUNK))


def reduce_plan(rows: int, cols: int, sms: int) -> dict:
    """K12's launch for a (rows, cols) tensor on a card of ``sms`` SMs: the
    octets (8 rows, 2 cols float4 ``lanes``) cut into ``slices`` ranges of
    ``per`` octets, the lanes into ``windows`` of REDUCE_WINDOW; one block a
    (slice, window), REDUCE_BLOCKS_PER_SM an SM; each block loads its
    octets in ring stages of ``ops`` octets (as many as STAGE_WORDS holds
    of a window; the last stage of a slice may hold fewer); ``partial`` the
    shape of the scratch the blocks write (one (8, cols) partial a
    slice)."""
    lanes, octets = 2 * cols, rows // OCTET
    windows = -(-lanes // REDUCE_WINDOW)
    slices = max(1, min(octets, sms * REDUCE_BLOCKS_PER_SM // windows))
    per = -(-octets // slices)
    slices = -(-octets // per)
    return dict(lanes=lanes, octets=octets, windows=windows, slices=slices,
                per=per, ops=STAGE_WORDS // min(REDUCE_WINDOW, lanes),
                partial=(slices, OCTET, cols))


def stream_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K11."""
    return x.clone()


def stream_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy of x (K11; replaces ``tools/roofline.py`` ``pallas_copy``):
    fp32, contiguous, 16-byte aligned, a multiple of 4 values."""
    _check_stream("stream_copy", x)
    if x.numel() % 4:
        raise ValueError(f"stream_copy takes a multiple of 4 values, got "
                         f"{x.numel()}")
    if _build.on_cpu(x):
        return stream_copy_plain(x)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with _build.on_device(x):
        _build.launch("ect_copy", torch.float32, x.data_ptr(), out.data_ptr(),
                      x.numel(), copy_plan(x.numel())["blocks"])
    stream_copy.launches += 1
    return out


stream_copy.launches = 0


def stream_copy_shape(n: int) -> dict:
    """K11's launch for n values on the current CUDA device
    (``_build.launch_shape``)."""
    return _build.launch_shape("ect_copy_shape", None, copy_plan(n)["blocks"])


def read_reduce_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of K12."""
    return x.reshape(-1, OCTET, x.shape[-1]).sum(0)


def read_reduce(x: torch.Tensor) -> torch.Tensor:
    """(rows, cols) -> (8, cols), out[r, c] = sum_{i = r mod 8} x[i, c]
    (K12; replaces ``tools/roofline.py`` ``pallas_reduce``): fp32,
    contiguous, 16-byte aligned, rows a multiple of 8 and cols of 4.
    Deterministic: each block sums its slice's octets in order, a second
    pass adds the slices' partials in a fixed order (``reduce_plan``)."""
    _check_stream("read_reduce", x)
    if x.ndim != 2 or x.shape[0] % OCTET or x.shape[1] % 4 or not x.numel():
        raise ValueError("read_reduce takes a non-empty (rows, cols) tensor "
                         f"with rows % 8 == 0 and cols % 4 == 0, got "
                         f"{tuple(x.shape)}")
    if _build.on_cpu(x):
        return read_reduce_plain(x)
    rows, cols = x.shape
    plan = reduce_plan(rows, cols, _sm_count(x.device.index))
    partial = torch.empty(plan["partial"], dtype=x.dtype, device=x.device)
    out = torch.empty((OCTET, cols), dtype=x.dtype, device=x.device)
    with _build.on_device(x):
        _build.launch("ect_reduce8", torch.float32, x.data_ptr(),
                      partial.data_ptr(), out.data_ptr(), rows, cols,
                      plan["per"], plan["slices"], plan["ops"])
    read_reduce.launches += 1
    return out


read_reduce.launches = 0


def read_reduce_shape(rows: int, cols: int) -> dict:
    """K12's first launch for a (rows, cols) tensor on the current CUDA
    device (``_build.launch_shape``)."""
    plan = reduce_plan(rows, cols, _sm_count(torch.cuda.current_device()))
    return _build.launch_shape("ect_reduce8_shape", None,
                               plan["slices"] * plan["windows"])


def device_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms over reps calls, after one warm-up
    (CUDA events)."""
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


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a - b).abs().max() / b.abs().max()).item()


def run(device: torch.device) -> dict:
    """All probes on ``device``; prints one line per probe and returns the
    results (also written to ``_build/roofline.json``)."""
    from .ops import legendre_dense as ld

    if not torch.cuda.is_available():
        raise RuntimeError("the roofline probes measure a CUDA card; there "
                           "is none")
    results = {"device": torch.cuda.get_device_name(device)}

    def emit(key, value):
        results[key] = value
        print(f"{key}: {value}", flush=True)

    # the JAX probe's data: column index * 1e-3, made on the card
    x = (torch.arange(N_COLS, device=device, dtype=torch.float32) * 1e-3) \
        .expand(N_ROWS, N_COLS).contiguous()
    gb = x.numel() * 4 / 1e9
    emit("torch_addone_gbps_rw", 2 * gb / device_ms(lambda: x + 1) * 1e3)
    emit("k11_copy_gbps_rw", 2 * gb / device_ms(lambda: stream_copy(x)) * 1e3)
    emit("k12_reduce_read_gbps",
         gb / device_ms(lambda: read_reduce(x)) * 1e3)
    del x

    gm, J, ig, fc2 = (GROUP0[k] for k in ("gm", "J", "ig", "fc2"))
    gen = torch.Generator(device=device).manual_seed(0)
    pn = torch.randn(gm, J, ig, generator=gen, device=device)
    dg = torch.randn(gm, fc2, J, generator=gen, device=device)
    d4 = torch.cat([dg, dg * ld._jsgn(J, dg)], dim=1)
    fn = torch.randn(gm, fc2, ig, generator=gen, device=device)
    fs = fn * 0.5
    f4 = torch.cat([fn, fs], dim=1)
    for tag, table in (("f32", pn), ("bf16", pn.to(torch.bfloat16))):
        tab_gb = table.numel() * table.element_size() / 1e9
        for kern, fn_ in (("k1", lambda: ld.group_inv_dense(dg, table)),
                          ("k7", lambda: ld.group_inv_dense2(d4, table))):
            t = device_ms(fn_, reps=5)
            emit(f"{kern}_inv_{tag}_tables", {
                "ms": t, "table_gbps": tab_gb / t * 1e3})
        north, south = ld.group_inv_dense(dg, table)
        o = ld.group_inv_dense2(d4, table)
        emit(f"k7_vs_k1_maxdiff_rel_{tag}",
             max(_rel(o[:, :fc2], north), _rel(o[:, fc2:], south)))
        del north, south, o
        t2 = device_ms(lambda: ld.group_dir_dense(fn, fs, table), reps=5)
        t8 = device_ms(lambda: ld.group_dir_dense2(f4, table), reps=5)
        raw = ld.group_dir_dense2(f4, table)
        emit(f"k2_vs_k8_dir_{tag}_tables", {
            "k2_ms": t2, "k8_ms": t8,
            "maxdiff_rel": _rel(raw[:, :fc2] + raw[:, fc2:] * ld._jsgn(J, raw),
                                ld.group_dir_dense(fn, fs, table))})
        del raw
    _build.BUILD_DIR.mkdir(exist_ok=True)
    (_build.BUILD_DIR / "roofline.json").write_text(
        json.dumps(results, indent=1))
    return results


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    run(torch.device("cuda", torch.cuda.current_device()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
