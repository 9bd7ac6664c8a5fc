"""One rank's share of the Fourier and Legendre layers' work on a (w, v)
mesh, counted as ``work.py`` counts the whole globe's, and the card's link
peak (``links.json``).

The share follows the deployment's distribution (ecTrans's SUWAVEDI and
SUMPLATF, as the port deals it), worked out here from the geometry alone:

* fields: the rank at (iw, iv) transforms its v-rank's fields, under the
  default KVSET contiguous blocks of ceil(n / v) fields of each family, so
  rank 0 holds ceil(n / v) of them;
* Fourier: the w-rank's latitude rows: the rows sorted by length (rows
  added to pad the count to a multiple of w * v first, then by row index)
  and dealt round-robin to the w ranks;
* Legendre: the w-rank's m's: contiguous m-groups (up to 16 of at least 8
  m's, ceil(M / count) m's a group), each dealt round-robin to the w ranks
  from its first m; the table entries, spectra and Fourier values of those
  m's at every latitude.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from perfbench import work

LINKS = pathlib.Path(__file__).resolve().parent / "links.json"


def link_peak(kind: str) -> float | None:
    """Bytes a second one card sends over its links, or None."""
    entry = json.loads(LINKS.read_text()).get(kind)
    return None if entry is None else float(entry["link_bytes_per_s"])


def rank_rows(geo, w: int, v: int, iw: int) -> np.ndarray:
    """The grid rows of w-rank iw's latitude slots."""
    ndgl = geo.ndgl
    wv = w * v
    pad = -(-ndgl // wv) * wv
    nloen = geo.nloen
    order = sorted(range(pad), key=lambda r: (nloen[r] if r < ndgl else -1,
                                              r))
    rows = np.asarray(order[iw::w], dtype=np.int64)
    return rows[rows < ndgl]


def rank_ms(geo, w: int, iw: int) -> np.ndarray:
    """The zonal wavenumbers of w-rank iw."""
    M = geo.truncation + 1
    ngroups = max(1, min(16, M // 8))
    bs = -(-M // ngroups)
    out = []
    for m0 in range(0, M, bs):
        out.extend(range(m0 + iw, min(M, m0 + bs), w))
    return np.asarray(out, dtype=np.int64)


def rank_calls(calls, v: int) -> list:
    """Rank 0's part of each call: its v-rank's fields of each family."""
    return [(d, -(-nuv // v), -(-nsc // v)) for d, nuv, nsc in calls]


def fourier_bytes(geo, calls, scders: bool, uvders: bool, itemsize: int,
                  mesh: tuple, iw: int = 0) -> int:
    """Bytes of w-rank iw's Fourier layer in rank 0's fields: each kept
    coefficient and grid value of its rows, read or written once."""
    w, v = mesh
    rows = rank_rows(geo, w, v, iw)
    coef = 2 * int((geo.nmen[rows] + 1).sum())
    per_field = (coef + int(geo.nloen[rows].sum())) * itemsize
    return sum(work.fourier_fields(d, nuv, nsc, scders, uvders) * per_field
               for d, nuv, nsc in rank_calls(calls, v))


def legendre_work(geo, calls, scders: bool, itemsize: int,
                  table_itemsize: int, mesh: tuple,
                  iw: int = 0) -> tuple[int, int]:
    """(bytes, FLOP) of w-rank iw's Legendre layer in rank 0's fields:
    ``work.legendre_work`` over its m's."""
    w, v = mesh
    t = geo.truncation
    m = rank_ms(geo, w, iw)
    nu = work.ndglu(geo)[m]
    entries = int(((t + 2 - m) * nu).sum())
    spec = 2 * int((t + 2 - m).sum())
    four = 4 * int(nu.sum())
    nbytes = flop = 0
    for d, nuv, nsc in rank_calls(calls, v):
        nf = work.legendre_fields(d, nuv, nsc, scders)
        nbytes += entries * table_itemsize + nf * (spec + four) * itemsize
        flop += 4 * entries * nf
    return nbytes, flop
