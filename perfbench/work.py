"""The work of the Fourier and Legendre layers, counted from the
resolution's sizes and a step's calls, and the least time the chip needs
for it.  The counts say what the transforms must read, write and compute,
whatever a kernel does, so a layer's share of its roofline reads the same
work whichever implementation runs it.

* Fourier: each row keeps the modes m <= nmen of that row, so a field has
  2 sum_j (nmen_j + 1) real coefficients, and ngptot grid values.  A call
  reads each of one side once and writes each of the other once.
* Legendre: the table holds P(n, m) for m <= T, m <= n <= T + 1, at the
  northern latitudes where m <= nmen (ndglu(m) of them); the two
  hemispheres come from the same entries by parity.  A call reads the
  table once, its spectra (2 (T + 2 - m) values an m a field) and writes
  its Fourier coefficients (2 x 2 ndglu(m) an m a field), or the reverse;
  it does two multiply-adds of each entry with each field's real and
  imaginary parts: 4 FLOP an entry a field.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

PEAKS = pathlib.Path(__file__).resolve().parent / "peaks.json"


def peaks(kind: str) -> dict:
    table = json.loads(PEAKS.read_text())
    if kind not in table:
        raise KeyError(f"no peaks for {kind!r} in {PEAKS.name}")
    return table[kind]


def ndglu(geo) -> np.ndarray:
    """Northern rows on which each m is kept."""
    nmen = geo.nmen[: geo.gauss_number]
    m = np.arange(geo.truncation + 1)
    return (nmen[None, :] >= m[:, None]).sum(1)


def legendre_fields(direction: str, nuv: int, nsc: int, scders: bool) -> int:
    """Fields through the Legendre layer: u and v, the scalars and, on the
    inverse with derivatives, their N-S derivatives."""
    if direction == "inv":
        return 2 * nuv + nsc * (2 if scders else 1)
    return 2 * nuv + nsc


def fourier_fields(direction: str, nuv: int, nsc: int, scders: bool,
                   uvders: bool) -> int:
    """Grid fields the Fourier layer writes (inverse) or reads (direct)."""
    if direction == "inv":
        return (2 * nuv * (2 if uvders else 1)
                + nsc * (3 if scders else 1))
    return 2 * nuv + nsc


def fourier_bytes(geo, calls, scders: bool, uvders: bool,
                  itemsize: int = 4) -> int:
    coef = 2 * int((geo.nmen + 1).sum())
    per_field = (coef + geo.ngptot) * itemsize
    return sum(fourier_fields(d, nuv, nsc, scders, uvders) * per_field
               for d, nuv, nsc in calls)


def legendre_work(geo, calls, scders: bool, itemsize: int = 4,
                  table_itemsize: int = 4) -> tuple[int, int]:
    """(bytes, FLOP) of the calls."""
    t = geo.truncation
    m = np.arange(t + 1)
    nu = ndglu(geo)
    entries = int(((t + 2 - m) * nu).sum())
    spec = 2 * int((t + 2 - m).sum())
    four = 4 * int(nu.sum())
    nbytes = flop = 0
    for d, nuv, nsc in calls:
        nf = legendre_fields(d, nuv, nsc, scders)
        nbytes += entries * table_itemsize + nf * (spec + four) * itemsize
        flop += 4 * entries * nf
    return nbytes, flop


def least_seconds(nbytes: int, flop: int, peak: dict) -> float:
    return max(nbytes / peak["hbm_bytes_per_s"],
               flop / peak["fp32_flop_per_s"])
