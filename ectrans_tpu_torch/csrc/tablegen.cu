// Legendre table generator for Hopper (sm_90a): kernel K4.
//
// Replaces ectrans_tpu/ops/legendre_tablegen.py _gen_group (_gen_kernel).
// Writes one m-group of the full-n table
//   out[m - m0, t, i - i0] = Pbar_{m+t}^m(mu_i),  t < J, i0 <= i < i0 + ig,
// by the upward three-term recurrence over n,
//   Pbar_n = A(m, n-m) * mu * Pbar_{n-1} - B(m, n-m) * Pbar_{n-2},
//   A = 1 / eps(n, m),  B = eps(n-1, m) / eps(n, m),
// seeded by the sectoral value Pbar_m^m = mant * 2^E.  cos^m(theta) falls far
// below the fp64 range at polar latitudes for m ~ 1000, so the running pair
// is carried as an fp64 mantissa with an int exponent and rescaled by powers
// of two.  The TPU kernel ran a compensated double-single fp32 chain because
// that chip has no fp64; the H100 has native fp64, so the recurrence runs in
// plain fp64 (no contraction into FMA, so that the plain PyTorch version of
// the same steps gives the same bits).  Emission flushes values below the
// output type's smallest normal to 0.
//
// One thread per (m, latitude); each writes all J rows of its column, so
// every entry of the table is written (the zero padding past n = nsmax+1 and
// for masked seeds m > nmen(lat) carries correctness downstream).  Writes are
// coalesced along latitude.  Bound: the output write (gm * J * ig values per
// group) and fp64 latency of the sequential chain.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr double RS_HI = 0x1p256;
constexpr double RS_LO = 0x1p-256;
constexpr int RS_SHIFT = 256;
constexpr int E_FLUSH = -1400;   // |mantissa| <= 2^257: 2^E_FLUSH * 2^257 < DBL_MIN

template <typename T> __device__ __forceinline__ double tiny();
template <> __device__ __forceinline__ double tiny<float>() { return FLT_MIN; }
template <> __device__ __forceinline__ double tiny<double>() { return DBL_MIN; }

__device__ __forceinline__ double pow2(int e) {   // exact 2^e, |e| <= 1022
  return __longlong_as_double((long long)(e + 1023) << 52);
}

template <typename T>
__device__ __forceinline__ T emit(double p, int E) {
  if (E < E_FLUSH) return T(0);
  const int e1 = E / 2;
  const double v = __dmul_rn(__dmul_rn(p, pow2(e1)), pow2(E - e1));
  return fabs(v) < tiny<T>() ? T(0) : (T)v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
tablegen_kernel(const double* __restrict__ A, const double* __restrict__ B,
                int tc, const double* __restrict__ smant,
                const int* __restrict__ sexp, int ld,
                const double* __restrict__ mu, T* __restrict__ out,
                int m0, int J, int i0, int ig) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= ig) return;
  const int ml = blockIdx.y;
  const int m = m0 + ml;
  const int lat = i0 + i;
  const double x = mu[lat];
  const double* a = A + (size_t)m * tc;
  const double* b = B + (size_t)m * tc;
  double p = smant[(size_t)m * ld + lat];
  int E = sexp[(size_t)m * ld + lat];
  double q = 0.0;
  T* o = out + (size_t)ml * J * ig + i;
  for (int t = 0; t < J; ++t) {
    o[(size_t)t * ig] = emit<T>(p, E);
    double r = __dsub_rn(__dmul_rn(a[t + 1], __dmul_rn(x, p)),
                         __dmul_rn(b[t + 1], q));
    const double mag = fabs(r);
    double fac = 1.0;
    if (mag > RS_HI) {
      fac = RS_LO;
      E += RS_SHIFT;
    } else if (mag < RS_LO && mag > 0.0) {
      fac = RS_HI;
      E -= RS_SHIFT;
    }
    q = __dmul_rn(p, fac);
    p = __dmul_rn(r, fac);
  }
}

template <typename T>
int launch(const void* A, const void* B, int tc, const void* smant,
           const void* sexp, int ld, const void* mu, void* out, int m0, int gm,
           int J, int i0, int ig, void* stream) {
  dim3 grid((ig + THREADS - 1) / THREADS, gm);
  tablegen_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)A, (const double*)B, tc, (const double*)smant,
      (const int*)sexp, ld, (const double*)mu, (T*)out, m0, J, i0, ig);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ect_tablegen_f32(const void* A, const void* B, int tc, const void* smant,
                     const void* sexp, int ld, const void* mu, void* out,
                     int m0, int gm, int J, int i0, int ig, void* stream) {
  return launch<float>(A, B, tc, smant, sexp, ld, mu, out, m0, gm, J, i0, ig,
                       stream);
}

int ect_tablegen_f64(const void* A, const void* B, int tc, const void* smant,
                     const void* sexp, int ld, const void* mu, void* out,
                     int m0, int gm, int J, int i0, int ig, void* stream) {
  return launch<double>(A, B, tc, smant, sexp, ld, mu, out, m0, gm, J, i0, ig,
                        stream);
}

}  // extern "C"
