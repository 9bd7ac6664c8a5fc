"""The Fourier and Legendre work counts against counts by hand at O48
T47."""

import numpy as np

from perfbench import reference, work


def _hand(geo):
    """Entries, spectral values and Fourier values by explicit loops."""
    t, J = geo.truncation, geo.gauss_number
    nmen = geo.nmen
    entries = spec = four = 0
    for m in range(t + 1):
        lats = sum(1 for j in range(J) if nmen[j] >= m)
        for n in range(m, t + 2):
            entries += lats
            spec += 2
        four += 2 * 2 * lats
    coef = sum(2 * (int(nmen[j]) + 1) for j in range(geo.ndgl))
    return entries, spec, four, coef


def test_work_counts_at_o48_t47():
    geo = reference.Geometry(48, 47)
    entries, spec, four, coef = _hand(geo)
    calls = [("inv", 3, 4), ("dir", 3, 4)]
    # inverse: u, v and 4 scalars with their N-S derivatives; direct: 10
    nb, flop = work.legendre_work(geo, calls, scders=True)
    assert flop == 4 * entries * (14 + 10)
    assert nb == 2 * entries * 4 + (14 + 10) * (spec + four) * 4
    fb = work.fourier_bytes(geo, calls, scders=True, uvders=True)
    # inverse writes u, v, 4 scalars, N-S and E-W derivatives: 6 + 12 + 6
    assert fb == (24 + 10) * (coef + geo.ngptot) * 4
    assert geo.ngptot == sum(20 + 4 * i for i in range(48)) * 2
    assert work.ndglu(geo)[0] == 48 and np.all(np.diff(work.ndglu(geo)) <= 0)


def test_least_time_takes_the_larger_term():
    pk = dict(hbm_bytes_per_s=2.0, fp32_flop_per_s=4.0)
    assert work.least_seconds(10, 4, pk) == 5.0
    assert work.least_seconds(2, 40, pk) == 10.0
    assert work.peaks("NVIDIA H100 80GB HBM3")["hbm_bytes_per_s"] == 3.35e12
