// Native Legendre-table builder: the host table source's setup kernel.
//
// A copy of ectrans_tpu/native/legendre_builder.cpp (the same code, so the
// two packages build the same tables bit for bit).  The reference computes
// its Legendre matrices in Fortran SULEG/SUPOLF
// (src/trans/cpu/internal/suleg_mod.F90); the one hot host-side kernel of
// the setup is this O(nsmax^2 * nlat) associated-Legendre recurrence, which
// in NumPy takes minutes and tens of GB at TCO1279.
//
// The builder is memory-bound (the arithmetic runs at ~0.5 ns per
// (n, lat) step; the tables are GBs at TCO1279), so the work is laid out to
// touch every output byte exactly once: the recurrence runs n-innermost
// over a small latitude block whose (block x kmax) tile stays
// cache-resident, and each finished output row is flushed with one
// contiguous copy of the valid prefix plus one contiguous zero tail.  No
// global memset, no double writes.
//
// Math (identical to ectrans_tpu_torch/legendre.py):
//   Pbar_n^m = sqrt((2n+1)(n-m)!/(n+m)!) P_n^m, no Condon-Shortley,
//   eps(n,m) = sqrt((n^2-m^2)/(4n^2-1)),
//   eps(n+1,m) Pbar_{n+1}^m = mu Pbar_n^m - eps(n,m) Pbar_{n-1}^m,
// with mantissa/exponent scaling so sectoral seeds below the fp64 underflow
// threshold (high m, polar latitudes) recover exactly (the reference's
// scaled SUPOLF, supolf_mod.F90).
//
// Build: g++ -O3 -fPIC -shared -std=c++17 -funroll-loops
// (ectrans_tpu_torch/native/__init__.py, at first use).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__SSE2__)
#include <xmmintrin.h>
#endif

namespace {
constexpr double kScaleLimit = 0x1p500;      // 2^500
constexpr double kScaleLimitInv = 0x1p-500;  // 2^-500

template <typename T>
void flush_row(T* dst, const double* src, int nvalid, int kmax) {
  for (int k = 0; k < nvalid; ++k) dst[k] = static_cast<T>(src[k]);
  for (int k = nvalid; k < kmax; ++k) dst[k] = static_cast<T>(0);
}

template <typename T>
int build_impl(int nsmax, int nmax, int nlat, const double* mu,
               const int32_t* nmen, int kmax, T* psym, T* pasym) {
  const int M = nsmax + 1;

  std::vector<double> c(nlat), seed_mant(nlat, 1.0);
  std::vector<int64_t> seed_scale(nlat, 0);
  for (int i = 0; i < nlat; ++i) {
    double s = 1.0 - mu[i] * mu[i];
    c[i] = s > 0 ? std::sqrt(s) : 0.0;
  }

  constexpr int BL = 16;
  std::vector<double> en_tab(nmax + 2), enm1_tab(nmax + 2);
  // cache-resident tiles: (BL, kmax) per parity
  std::vector<double> tile_s((size_t)BL * kmax), tile_a((size_t)BL * kmax);

  for (int m = 0; m < M; ++m) {
    if (m > 0) {
      const double r = std::sqrt((2.0 * m - 1.0) / (2.0 * m));
      for (int i = 0; i < nlat; ++i) {
        double v = seed_mant[i] * c[i] * r;
        if (v != 0.0 && std::fabs(v) < kScaleLimitInv) {
          v *= kScaleLimit;
          seed_scale[i] -= 500;
        }
        seed_mant[i] = v;
      }
    }
    const double norm = std::sqrt(2.0 * m + 1.0);
    const double m2 = (double)m * m;
    for (int n = m + 1; n <= nmax; ++n) {
      const double nn = (double)n * n;
      const double nm1 = (double)(n - 1) * (n - 1);
      en_tab[n] = std::sqrt((nn - m2) / (4.0 * nn - 1.0));
      enm1_tab[n] =
          (n - 1 >= m + 1) ? std::sqrt((nm1 - m2) / (4.0 * nm1 - 1.0)) : 0.0;
    }
    // valid coefficient counts at this m (rows beyond stay zero)
    const int ns_valid = (nmax - m) / 2 + 1;
    const int na_valid = (nmax - m >= 1) ? (nmax - m - 1) / 2 + 1 : 0;

    T* ps = psym + (size_t)m * nlat * kmax;
    T* pa = pasym + (size_t)m * nlat * kmax;
    for (int i0 = 0; i0 < nlat; i0 += BL) {
      const int ib = (nlat - i0 < BL) ? (nlat - i0) : BL;
      double pprev[BL], pcur[BL];
      int64_t scale[BL];
      for (int j = 0; j < ib; ++j) {
        pprev[j] = 0.0;
        pcur[j] = seed_mant[i0 + j] * norm;
        scale[j] = seed_scale[i0 + j];
      }
      for (int n = m; n <= nmax; ++n) {
        if (n > m) {
          const double en = en_tab[n], enm1 = enm1_tab[n];
          // divide (not multiply-by-reciprocal): bitwise-matches the NumPy
          // fallback recurrence
          for (int j = 0; j < ib; ++j) {
            const double pnew = (mu[i0 + j] * pcur[j] - enm1 * pprev[j]) / en;
            pprev[j] = pcur[j];
            pcur[j] = pnew;
          }
          if (((n - m) & 7) == 0) {  // periodic renormalisation
            for (int j = 0; j < ib; ++j) {
              if (std::fabs(pcur[j]) > kScaleLimit) {
                pcur[j] *= kScaleLimitInv;
                pprev[j] *= kScaleLimitInv;
                scale[j] += 500;
              }
            }
          }
        }
        const int k = (n - m) >> 1;
        if (k >= kmax) continue;
        double* tile = (((n - m) & 1) == 0) ? tile_s.data() : tile_a.data();
        for (int j = 0; j < ib; ++j) {
          const int64_t sc = scale[j];
          double v;
          if (sc == 0) {
            v = pcur[j];
          } else if (sc < -16000) {
            v = 0.0;
          } else {
            v = std::ldexp(pcur[j], (int)sc);
          }
          tile[(size_t)j * kmax + k] = v;
        }
      }
      // flush: one contiguous pass per output row (valid prefix + zero tail)
      for (int j = 0; j < ib; ++j) {
        const bool masked = (nmen != nullptr) && (m > nmen[i0 + j]);
        T* dst_s = ps + (size_t)(i0 + j) * kmax;
        T* dst_a = pa + (size_t)(i0 + j) * kmax;
        if (masked) {
          std::memset(dst_s, 0, sizeof(T) * kmax);
          std::memset(dst_a, 0, sizeof(T) * kmax);
        } else {
          flush_row(dst_s, tile_s.data() + (size_t)j * kmax, ns_valid, kmax);
          flush_row(dst_a, tile_a.data() + (size_t)j * kmax, na_valid, kmax);
        }
      }
    }
  }
  return 0;
}
}  // namespace

extern "C" {

// psym:  (nsmax+1, nlat, kmax) row-major -- Pbar at n = m + 2k
// pasym: (nsmax+1, nlat, kmax)           -- Pbar at n = m + 1 + 2k
// mu:    (nlat,) sin(latitude), any order (typically NH, north->south)
// nmen:  (nlat,) per-latitude zonal truncation, or NULL; rows with
//        m > nmen[lat] are zeroed (reference NDGLU restriction).
// nmax = nsmax + ntmax_extra (table rows n = m .. nmax).
// Every output element is written (no pre-zeroing needed by the caller).
// Returns 0 on success.
int et_build_legendre_parity(int nsmax, int nmax, int nlat, const double* mu,
                             const int32_t* nmen, int kmax, double* psym,
                             double* pasym) {
  if (nsmax < 0 || nmax < nsmax || nlat <= 0 || kmax <= 0) return 1;
#if defined(__SSE2__)
  // Flush-to-zero + denormals-are-zero: the deep-underflow band (values
  // below 2^-1022, physically zero for the transform) otherwise triggers
  // subnormal microcode assists.
  const unsigned int csr_save = _mm_getcsr();
  _mm_setcsr(csr_save | 0x8040u);
#endif
  int rc = build_impl<double>(nsmax, nmax, nlat, mu, nmen, kmax, psym, pasym);
#if defined(__SSE2__)
  _mm_setcsr(csr_save);
#endif
  return rc;
}

// Same, writing float32 tables directly (halves the dominant memory
// traffic; the recurrence itself stays fp64).
int et_build_legendre_parity_f32(int nsmax, int nmax, int nlat,
                                 const double* mu, const int32_t* nmen,
                                 int kmax, float* psym, float* pasym) {
  if (nsmax < 0 || nmax < nsmax || nlat <= 0 || kmax <= 0) return 1;
#if defined(__SSE2__)
  const unsigned int csr_save = _mm_getcsr();
  _mm_setcsr(csr_save | 0x8040u);
#endif
  int rc = build_impl<float>(nsmax, nmax, nlat, mu, nmen, kmax, psym, pasym);
#if defined(__SSE2__)
  _mm_setcsr(csr_save);
#endif
  return rc;
}

}  // extern "C"
