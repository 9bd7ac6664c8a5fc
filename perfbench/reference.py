"""The plain reference of the global spectral transforms.

Plain PyTorch, written from the mathematics of ecTrans's transforms and
independent of the program: it imports nothing of ``ectrans_tpu_torch``
and works out again everything the program derives at set-up (the grid,
the Gaussian latitudes and weights, each row's zonal truncation, the
associated Legendre functions and the spectral operators).

Conventions (those of ecTrans, which the program keeps):

* spectra are packed m-major, n ascending from m to the truncation T,
  (re, im) interleaved; a dense tensor (nfld, 2, M, T + 2) holds n up to
  T + 1, the extra degree of the wind spectra;
* P(n, m) is the associated Legendre function normalised to
  sum_j w_j P(n, m)(mu_j)^2 = 1 over the Gaussian weights w (which add up
  to 1), without the Condon-Shortley phase, and is taken as zero on a
  row whose zonal truncation nmen is below m;
* a grid row of L points holds f_k = sum_m c_m Re(F_m e^{2 pi i k m / L}),
  c_0 = 1 and c_m = 2 above, for m <= nmen of the row; the analysis is
  F_m = (1/L) sum_k f_k e^{-2 pi i k m / L};
* the inverse output is ordered u, v, scalars, their N-S derivatives,
  the E-W derivatives of u and v, then those of the scalars.

``Reference(geometry, device, dtype, tf32)`` computes in ``dtype``; the
control of the benchmark is this reference in float32 with each matmul
operand rounded to TF32 (``tf32=True``), which is what a GPU does with
``allow_tf32``, so that the control reads the same on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

EARTH_RADIUS = 6371229.0


def gauss_nodes(ndgl: int) -> tuple[np.ndarray, np.ndarray]:
    """(mu, w): the roots of P_ndgl in descending order and their
    Gauss-Legendre weights halved (they add up to 1), by Newton's method
    from the asymptotic first guess."""
    k = np.arange(1, ndgl + 1, dtype=np.float64)
    x = np.cos(np.pi * (k - 0.25) / (ndgl + 0.5))
    for _ in range(100):
        p0, p1 = np.ones_like(x), x.copy()
        for n in range(2, ndgl + 1):
            p0, p1 = p1, ((2 * n - 1) * x * p1 - (n - 1) * p0) / n
        dp = ndgl * (p0 - x * p1) / (1.0 - x * x)
        dx = p1 / dp
        x = x - dx
        if np.abs(dx).max() < 1e-15:
            break
    p0, p1 = np.ones_like(x), x.copy()
    for n in range(2, ndgl + 1):
        p0, p1 = p1, ((2 * n - 1) * x * p1 - (n - 1) * p0) / n
    dp = ndgl * (p0 - x * p1) / (1.0 - x * x)
    w = 1.0 / ((1.0 - x * x) * dp * dp)
    # the two hemispheres mirror each other exactly
    return 0.5 * (x - x[::-1]), 0.5 * (w + w[::-1])


@dataclasses.dataclass(frozen=True)
class Geometry:
    """An octahedral reduced Gaussian grid O<N> at the cubic truncation
    T = N - 1 (ECMWF's TCo grids)."""

    gauss_number: int
    truncation: int
    radius: float = EARTH_RADIUS

    def __post_init__(self):
        if self.truncation != self.gauss_number - 1:
            raise ValueError("the reference holds the cubic octahedral "
                             "grids, T = N - 1")

    @property
    def ndgl(self) -> int:
        return 2 * self.gauss_number

    @property
    def nloen(self) -> np.ndarray:
        half = 20 + 4 * np.arange(self.gauss_number)
        return np.concatenate([half, half[::-1]])

    @property
    def ndlon(self) -> int:
        return int(self.nloen.max())

    @property
    def ngptot(self) -> int:
        return int(self.nloen.sum())

    @property
    def nspec2(self) -> int:
        t = self.truncation
        return (t + 1) * (t + 2)

    @property
    def gauss(self) -> tuple[np.ndarray, np.ndarray]:
        return _gauss_cached(self.ndgl)

    @property
    def nmen(self) -> np.ndarray:
        """Each row's zonal truncation on the cubic grid: the integer part
        of (L - 1) / (3 - mu^2) less 1, at most T, then made
        non-decreasing from each pole to the equator."""
        mu, _ = self.gauss
        raw = (self.nloen - 1) / (2.0 + (1.0 - mu * mu))
        vals = np.minimum(self.truncation, raw.astype(np.int64) - 1)
        h = self.gauss_number
        north = np.maximum.accumulate(vals[:h])
        south = np.maximum.accumulate(vals[h:][::-1])[::-1]
        return np.minimum(np.concatenate([north, south]), self.truncation)

    def valid_points(self, device) -> torch.Tensor:
        """Flat indices of the grid points of (ndgl, ndlon) that rows hold."""
        idx = np.concatenate([r * self.ndlon + np.arange(L)
                              for r, L in enumerate(self.nloen)])
        return torch.as_tensor(idx, device=device)

    def constrain(self, spec: torch.Tensor) -> None:
        """Sets, in place, what a real field's packed spectra hold as zero:
        the imaginary parts of m = 0, and the global mean."""
        spec[:, 1: 2 * (self.truncation + 1): 2] = 0.0
        spec[:, 0] = 0.0

    def grid_update(self, generator, device, dtype):
        """A seeded grid-point field for the scalars and one for the winds,
        (ndgl, ndlon), zero past each row's length: standard normal values
        times sqrt(ngptot), for the winds also times a cos(latitude) / N,
        so that their direct transforms have coefficients of about 0.7
        (scalars) and 0.4 (vorticity, divergence) at any resolution,
        as the seeded input spectra's are of about 1."""
        r = torch.randn((self.ndgl, self.ndlon), generator=generator,
                        device=device, dtype=torch.float64)
        r.view(-1)[self._pad_points(device)] = 0.0
        r *= math.sqrt(self.ngptot)
        mu, _ = self.gauss
        cos = torch.as_tensor(np.sqrt(1.0 - mu * mu), device=device)
        wind = r * (cos * self.radius / self.gauss_number)[:, None]
        return r.to(dtype), wind.to(dtype)

    def _pad_points(self, device) -> torch.Tensor:
        keep = torch.zeros(self.ndgl * self.ndlon, dtype=torch.bool,
                           device=device)
        keep[self.valid_points(device)] = True
        return (~keep).nonzero().squeeze(1)

    def reference(self, device, dtype=torch.float64,
                  tf32_operands: bool = False) -> "Reference":
        return Reference(self, device, dtype, tf32_operands)


def _gauss_cache():
    cache = {}

    def get(ndgl):
        if ndgl not in cache:
            cache[ndgl] = gauss_nodes(ndgl)
        return cache[ndgl]
    return get


_gauss_cached = _gauss_cache()


def eps(n: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """sqrt((n^2 - m^2) / (4 n^2 - 1)), zero where n <= m."""
    n = n.double()
    m = m.double()
    num = n * n - m * m
    return torch.where(num > 0, torch.sqrt(num.clamp(min=0)
                                           / (4 * n * n - 1).clamp(min=1)),
                       torch.zeros_like(num))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32's 10-bit mantissa, to nearest."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class Reference:
    """The inverse and direct transforms of one geometry in ``dtype`` on
    ``device``; the Legendre functions are built in float64 on the device
    at construction (float64, O(T^2 N) memory) and rounded to ``dtype``."""

    def __init__(self, geo: Geometry, device, dtype=torch.float64,
                 tf32_operands: bool = False):
        self.geo = geo
        self.device = torch.device(device)
        self.dtype = dtype
        self.tf32 = tf32_operands
        t = geo.truncation
        self.M = t + 1
        self.NP = t + 2
        mu, w = geo.gauss
        self.J = geo.gauss_number
        dev = self.device
        self.mu = torch.as_tensor(mu, dtype=torch.float64, device=dev)
        self.w = torch.as_tensor(w, dtype=torch.float64, device=dev)
        self.nmen = torch.as_tensor(geo.nmen, device=dev)
        self.racthe = 1.0 / (torch.sqrt(1.0 - self.mu * self.mu) * geo.radius)
        m = torch.arange(self.M, device=dev)
        n = torch.arange(self.NP + 1, device=dev)
        self.eps = eps(n[None, :], m[:, None])            # (M, NP + 1)
        self.rows = self.NP - m                           # n = m .. T + 1
        self.offsets = torch.cumsum(self.rows * self.J, 0) - self.rows * self.J
        self.table = legendre_table(self.mu[: self.J], self.nmen[: self.J],
                                    t, self.eps).to(dtype)

    # -- the pieces --------------------------------------------------
    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            return tf32(a) @ tf32(b)
        return a @ b

    def leg(self, m: int) -> torch.Tensor:
        """P(n, m) at the northern latitudes, (T + 2 - m, J)."""
        o = int(self.offsets[m])
        return self.table[o: o + int(self.rows[m]) * self.J].view(-1, self.J)

    def to_dense(self, spec: torch.Tensor) -> torch.Tensor:
        """(nfld, nspec2) packed -> (nfld, 2, M, NP) with zeros outside
        m <= n <= T."""
        f = spec.shape[0]
        out = spec.new_zeros((f, 2, self.M, self.NP), dtype=self.dtype)
        x = spec.to(self.dtype)
        o = 0
        for m in range(self.M):
            k = self.NP - 1 - m
            out[:, :, m, m: m + k] = x[:, o: o + 2 * k].reshape(
                f, k, 2).transpose(1, 2)
            o += 2 * k
        return out

    def to_packed(self, dense: torch.Tensor) -> torch.Tensor:
        f = dense.shape[0]
        parts = []
        for m in range(self.M):
            k = self.NP - 1 - m
            parts.append(dense[:, :, m, m: m + k].transpose(1, 2).reshape(
                f, 2 * k))
        return torch.cat(parts, 1)

    def _coef(self, v: torch.Tensor) -> torch.Tensor:
        return v.to(self.dtype)[None, :, :]

    def _valid(self, top: int) -> torch.Tensor:
        m = torch.arange(self.M, device=self.device)[:, None]
        n = torch.arange(self.NP, device=self.device)[None, :]
        return ((n >= m) & (n <= top)).to(self.dtype)

    @staticmethod
    def _down(x):          # y(n) = x(n - 1)
        return torch.nn.functional.pad(x[..., :-1], (1, 0))

    @staticmethod
    def _up(x):            # y(n) = x(n + 1)
        return torch.nn.functional.pad(x[..., 1:], (0, 1))

    @staticmethod
    def _i(x):             # i x on the (re, im) axis 1
        return torch.stack([-x[:, 1], x[:, 0]], 1)

    def winds(self, vor, div):
        """Spectra of u cos(lat) and v cos(lat) times a (n to T + 1)
        from vorticity and divergence, through the stream function and
        the velocity potential."""
        a = self.geo.radius
        dev = self.device
        n = torch.arange(self.NP + 1, device=dev, dtype=torch.float64)
        lapin = torch.where(n > 0, -a * a / (n * (n + 1)).clamp(min=1), 0.0)
        m = torch.arange(self.M, device=dev, dtype=torch.float64)[:, None]
        nn = n[None, : self.NP]
        e = self.eps
        cm = self._coef(m * lapin[None, : self.NP])
        lap_down = torch.cat([lapin[:1] * 0, lapin[: self.NP - 1]])
        cd = self._coef((nn - 1) * e[:, : self.NP] * lap_down[None])
        cu = self._coef((nn + 2) * e[:, 1:] * lapin[None, 1:])
        valid = self._valid(self.NP - 1)
        u = cm * self._i(div) + cd * self._down(vor) - cu * self._up(vor)
        v = cm * self._i(vor) - cd * self._down(div) + cu * self._up(div)
        return u * valid, v * valid

    def ns_derivative(self, x):
        """Spectra of cos^2(lat) dx/dmu (n to T + 1)."""
        dev = self.device
        n = torch.arange(self.NP, device=dev, dtype=torch.float64)[None]
        e = self.eps
        ca = self._coef((n - 1) * e[:, : self.NP])
        cb = self._coef((n + 2) * e[:, 1:])
        return (-ca * self._down(x) + cb * self._up(x)) * self._valid(
            self.NP - 1)

    def vordiv(self, u, v):
        """Vorticity and divergence (n to T) from the direct Legendre
        transform of u / (a cos(lat)) and v / (a cos(lat)) (n to T + 1)."""
        dev = self.device
        n = torch.arange(self.NP, device=dev, dtype=torch.float64)[None]
        m = torch.arange(self.M, device=dev, dtype=torch.float64)[:, None]
        e = self.eps
        p = self._coef(n * e[:, 1:])
        q = self._coef((n + 1) * e[:, : self.NP])
        r = self._coef(m.expand(-1, self.NP))
        valid = self._valid(self.NP - 2)
        z = r * self._i(v) - p * self._up(u) + q * self._down(u)
        d = r * self._i(u) + p * self._up(v) - q * self._down(v)
        return z * valid, d * valid

    def legendre_inv(self, x: torch.Tensor) -> torch.Tensor:
        """(nfld, 2, M, NP) -> Fourier coefficients (nfld, 2, M, ndgl)."""
        f = x.shape[0]
        J, ndgl = self.J, self.geo.ndgl
        out = x.new_zeros((f, 2, self.M, ndgl))
        for m in range(self.M):
            p = self.leg(m)
            k = p.shape[0]
            a = x[:, :, m, m: m + k].reshape(2 * f, k)
            sgn = torch.ones(k, dtype=x.dtype, device=x.device)
            sgn[1::2] = -1
            r = self._mm(torch.cat([a, a * sgn]), p)      # (4 f, J)
            out[:, :, m, :J] = r[: 2 * f].view(f, 2, J)
            out[:, :, m, J:] = r[2 * f:].view(f, 2, J).flip(-1)
        return out

    def legendre_dir(self, four: torch.Tensor) -> torch.Tensor:
        """Fourier coefficients (nfld, 2, M, ndgl) -> (nfld, 2, M, NP)."""
        f = four.shape[0]
        J = self.J
        w = self.w[:J].to(self.dtype)
        out = four.new_zeros((f, 2, self.M, self.NP))
        for m in range(self.M):
            p = self.leg(m)
            k = p.shape[0]
            north = four[:, :, m, :J]
            south = four[:, :, m, J:].flip(-1)
            eo = torch.cat([(north + south) * w, (north - south) * w])
            r = self._mm(p, eo.reshape(4 * f, J).T)          # (k, 4 f)
            r = r.T.reshape(2, f, 2, k)
            row = torch.where(torch.arange(k, device=four.device) % 2 == 0,
                              r[0], r[1])
            out[:, :, m, m: m + k] = row
        return out

    def _row_groups(self):
        """(L, nmen + 1, row indices) for each row length."""
        nloen = self.geo.nloen
        nmen = self.geo.nmen
        out = []
        for L in np.unique(nloen):
            rows = np.nonzero(nloen == L)[0]
            ks = set(int(k) for k in nmen[rows])
            if len(ks) != 1:
                raise ValueError("rows of one length with two truncations")
            out.append((int(L), ks.pop() + 1, rows))
        return out

    def _dft(self, L: int, K: int):
        k = torch.arange(L, device=self.device)
        m = torch.arange(K, device=self.device)
        ang = (torch.outer(m, k) % L).double() * (2 * math.pi / L)
        return torch.cos(ang).to(self.dtype), torch.sin(ang).to(self.dtype)

    def synthesis(self, four: torch.Tensor) -> torch.Tensor:
        """(nfld, 2, M, ndgl) -> grid (nfld, ndgl, ndlon), zero past a
        row's length."""
        f = four.shape[0]
        out = four.new_zeros((f, self.geo.ndgl, self.geo.ndlon))
        for L, K, rows in self._row_groups():
            c, s = self._dft(L, K)
            wm = torch.full((K, 1), 2.0, dtype=self.dtype, device=self.device)
            wm[0] = 1.0
            b = torch.cat([wm * c, -wm * s])               # (2K, L)
            r = torch.as_tensor(rows, device=self.device)
            a = four[:, :, :K][..., r].permute(0, 3, 1, 2).reshape(
                f * len(rows), 2 * K)
            out[:, r, :L] = self._mm(a, b).view(f, len(rows), L)
        return out

    def analysis(self, grid: torch.Tensor) -> torch.Tensor:
        """grid (nfld, ndgl, ndlon) -> (nfld, 2, M, ndgl), zero above a
        row's nmen."""
        f = grid.shape[0]
        out = grid.new_zeros((f, 2, self.M, self.geo.ndgl), dtype=self.dtype)
        g = grid.to(self.dtype)
        for L, K, rows in self._row_groups():
            c, s = self._dft(L, K)
            b = torch.cat([c, -s]).T / L                   # (L, 2K)
            r = torch.as_tensor(rows, device=self.device)
            a = g[:, r, :L].reshape(f * len(rows), L)
            res = self._mm(a, b).view(f, len(rows), 2, K)
            out[:, :, :K, r] = res.permute(0, 2, 3, 1)
        return out

    # -- the transforms ----------------------------------------------
    def inv(self, vor=None, div=None, sc=None, scders=False, uvders=False):
        """Packed spectra -> grid fields (nout, ndgl, ndlon) in ecTrans's
        output order."""
        nuv = 0 if vor is None else vor.shape[0]
        nsc = 0 if sc is None else sc.shape[0]
        parts = []
        if nuv:
            parts += list(self.winds(self.to_dense(vor), self.to_dense(div)))
        if nsc:
            dsc = self.to_dense(sc)
            parts.append(dsc)
            if scders:
                parts.append(self.ns_derivative(dsc))
        four = self.legendre_inv(torch.cat(parts))
        rac = self.racthe.to(self.dtype)
        mval = torch.arange(self.M, device=self.device, dtype=self.dtype)[
            None, :, None]

        def ew(x):
            return torch.stack([-x[:, 1] * mval, x[:, 0] * mval], 1) * rac

        out = []
        i = 0
        uvf = scf = None
        if nuv:
            uvf = four[: 2 * nuv] * rac
            out.append(uvf)
            i = 2 * nuv
        if nsc:
            scf = four[i: i + nsc]
            out.append(scf)
            if scders:
                out.append(four[i + nsc: i + 2 * nsc] * rac)
        if nuv and uvders:
            out.append(ew(uvf))
        if nsc and scders:
            out.append(ew(scf))
        return self.synthesis(torch.cat(out))

    def dir(self, u=None, v=None, sc=None):
        """Grid fields -> packed (vor, div, scalars), None where absent."""
        nuv = 0 if u is None else u.shape[0]
        grids = [x for x in (u, v, sc) if x is not None]
        four = self.analysis(torch.cat(grids))
        if nuv:
            four[: 2 * nuv] *= self.racthe.to(self.dtype)
        dense = self.legendre_dir(four)
        vor = div = scs = None
        if nuv:
            z, d = self.vordiv(dense[:nuv], dense[nuv: 2 * nuv])
            vor, div = self.to_packed(z), self.to_packed(d)
        if sc is not None:
            scs = self.to_packed(dense[2 * nuv:])
        return vor, div, scs


def legendre_table(mu: torch.Tensor, nmen: torch.Tensor, t: int,
                   e: torch.Tensor) -> torch.Tensor:
    """P(n, m)(mu_j) for m <= T, m <= n <= T + 1 at the latitudes mu
    (float64), zero where nmen_j < m, flat in m-major blocks of
    (T + 2 - m, J), by the three-term recurrence in n for all m at once.

    The sectoral seeds P(m, m) = sqrt(2m + 1) prod_{k <= m} sqrt((2k - 1)
    / 2k) cos^m are carried as a mantissa and a power of two, since they
    fall below float64's range near the poles at large m; the power is
    given back as the recurrence grows the values."""
    dev = mu.device
    M, NP, J = t + 1, t + 2, mu.shape[0]
    m = torch.arange(M, device=dev)
    mf = m.double()
    rows = NP - m
    offsets = torch.cumsum(rows * J, 0) - rows * J
    out = torch.zeros(int((rows * J).sum()), dtype=torch.float64, device=dev)
    k = torch.arange(1, M, device=dev, dtype=torch.float64)
    logc = torch.log2(torch.sqrt(1.0 - mu * mu))
    a = 0.5 * torch.log2(2 * mf + 1) + 0.5 * torch.cat([
        torch.zeros(1, dtype=torch.float64, device=dev),
        torch.cumsum(torch.log2((2 * k - 1) / (2 * k)), 0)])
    lg = a[:, None] + mf[:, None] * logc[None, :]          # log2 P(m, m)
    seed_e = torch.where(lg < -200, torch.floor(lg), torch.zeros_like(lg))
    seed = torch.exp2(lg - seed_e)
    keep = (m[:, None] <= nmen[None, :]).double()
    cur = torch.zeros((M, J), dtype=torch.float64, device=dev)
    prev = torch.zeros_like(cur)
    ex = torch.zeros_like(cur)
    lim = 2.0 ** 400
    j = torch.arange(J, device=dev)
    for n in range(NP):
        a_ = min(n, M)                   # m < n advance to degree n
        if a_:
            new = (mu * cur[:a_] - e[:a_, n - 1, None] * prev[:a_]) \
                / e[:a_, n, None]
            prev[:a_] = cur[:a_]
            cur[:a_] = new
        if n < M:                        # m = n starts at its seed
            cur[n] = seed[n]
            prev[n] = 0.0
            ex[n] = seed_e[n]
        big = (cur.abs() > lim) & (ex < 0)
        if bool(big.any()):
            step = torch.where(big, torch.clamp(-ex, max=400.0),
                               torch.zeros_like(ex))
            cur = cur * torch.exp2(-step)
            prev = prev * torch.exp2(-step)
            ex = ex + step
        top = min(n, M - 1) + 1          # degrees m = 0 .. min(n, T)
        vals = cur[:top] * torch.exp2(ex[:top]) * keep[:top]
        idx = (offsets[:top] + (n - m[:top]) * J)[:, None] + j[None, :]
        out[idx.reshape(-1)] = vals.reshape(-1)
    return out
