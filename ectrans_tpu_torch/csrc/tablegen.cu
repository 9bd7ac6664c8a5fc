// Legendre table generator for Hopper (sm_90a): kernel K4.
//
// Replaces ectrans_tpu/ops/legendre_tablegen.py _gen_group (_gen_kernel).
// Writes the full-n tables of m-groups,
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
// One thread per (m, latitude) column writes all J rows of it, so every
// entry of the table is written (the zero padding past n = nsmax+1 and for
// masked seeds m > nmen(lat) carries correctness downstream).  At TCO1279
// that is 926,445,600 entries, 3.71 GB of fp32: the bound is the write
// (1.1 ms at 3.35 TB/s), with the fp64 pipe close behind.  The design:
// - one launch for every group of a table build, the longest chains (J)
//   first; a group's columns are numbered flat over (m, latitude), so a
//   block runs 128 consecutive columns and only a group's last block is
//   ragged.  Up to MAXG = 16 groups their outputs and shapes travel by value
//   in the kernel's parameters (an unrolled scan finds a block's group);
//   past 16 (ECTRANS_TPU_LEG_GROUPS, up to one group an m) the launch first
//   copies them into a device array (32 bytes a group, on the same stream)
//   and each thread finds its block's group by a binary search on the
//   groups' first blocks, ~log2(groups) cached loads before a chain of J
//   steps.  A one-group launch is the same kernel with one descriptor;
// - few fp64 instructions per entry: 3 multiplies and 1 subtraction of the
//   recurrence, 1 multiply by the cached scale 2^E, and the conversion to
//   the output type.  Scaling by a power of two is exact while values stay
//   normal, so the rescaling is tested every K steps on the exponent bits
//   (integer instructions) and the flush below the output's smallest normal
//   is an exponent-bit test too: the entries are those of the recurrence
//   rescaled at every step (gen_group_plain), bit for bit (between tests a
//   value grows by < 2^6 a step, so nothing leaves the normal range);
// - the "bf16" tier's tables are written directly, rounded fp64 -> fp32 ->
//   bf16 as the fp32 table rounded to bf16 would be, so no fp32 copy of a
//   table is made for them.
// Stores are coalesced along latitude (128 B a warp and step in fp32) and
// marked streaming (evict first: the table is read by later kernels, not
// by this one), which took 8 % off the device time against plain stores.

#include <cuda_runtime.h>

#include <vector>

#include "legendre_common.cuh"

namespace k4 {

constexpr int THREADS = 128;
constexpr int MAXG = 16;         // groups passed by value
constexpr int K = 4;             // recurrence steps between rescaling tests
constexpr int RS_SHIFT = 256;
// |mantissa| < 2^370, so 2^E_FLUSH * 2^370 < DBL_MIN
constexpr int E_FLUSH = -1400;
constexpr int E_MIN = -1022;     // exponent of the smallest normal double

struct Group {
  void* out;
  int m0, gm, J, i0, ig, block0;
};

static_assert(sizeof(Group) == 32, "K4's descriptors are 32 bytes");

struct Groups {
  Group g[MAXG];
  int n;
};

__device__ __forceinline__ double pow2(int e) {   // exact 2^e, |e| <= 1022
  return __longlong_as_double((long long)(e + 1023) << 52);
}

// biased exponent field of an fp64 value
__device__ __forceinline__ int exponent_bits(double v) {
  return (__double2hiint(v) >> 20) & 0x7ff;
}

// the emission's scale: 2^E where that is a normal double, else 0; an fp32
// or bf16 entry with E < -1022 is below FLT_MIN (|mantissa| < 2^370), so
// its scaled value 0 flushes to 0, as the value itself would
__device__ __forceinline__ double scale_of(int E) {
  return E >= E_MIN ? pow2(E) : 0.0;
}

__device__ __forceinline__ float emit_f32(double p, double s) {
  const double v = __dmul_rn(p, s);
  const float f = __double2float_rn(v);
  return exponent_bits(v) >= 1023 - 126 ? f : 0.0f;   // |v| >= FLT_MIN
}

template <typename O> __device__ __forceinline__ O emit(double p, double s,
                                                         int E);
template <> __device__ __forceinline__ float emit<float>(double p, double s,
                                                         int) {
  return emit_f32(p, s);
}
template <> __device__ __forceinline__ ect::bf16 emit<ect::bf16>(
    double p, double s, int) {
  return __float2bfloat16_rn(emit_f32(p, s));
}
template <> __device__ __forceinline__ double emit<double>(double p, double s,
                                                           int E) {
  double v;
  if (E >= E_MIN) {
    v = __dmul_rn(p, s);
  } else if (E < E_FLUSH) {
    return 0.0;
  } else {                        // two exact-or-once-rounded scalings
    const int e1 = E / 2;
    v = __dmul_rn(__dmul_rn(p, pow2(e1)), pow2(E - e1));
  }
  return exponent_bits(v) != 0 ? v : 0.0;             // |v| >= DBL_MIN
}

// keep |p| in [2^-256, 2^257) (or 0), scaling p and q alike
__device__ __forceinline__ void rescale(double& p, double& q, int& E,
                                        double& s) {
  const int e = exponent_bits(p);
  if (e > 1023 + RS_SHIFT) {
    p = __dmul_rn(p, 0x1p-256);
    q = __dmul_rn(q, 0x1p-256);
    E += RS_SHIFT;
    s = scale_of(E);
  } else if (e != 0 && e < 1023 - RS_SHIFT) {
    p = __dmul_rn(p, 0x1p256);
    q = __dmul_rn(q, 0x1p256);
    E -= RS_SHIFT;
    s = scale_of(E);
  }
}

// DEV: the groups' descriptors are in ``d`` (gs.n of them, first blocks
// ascending), else in gs
template <typename O, bool DEV>
__global__ void __launch_bounds__(THREADS, 8)
k4_tablegen_kernel(const double* __restrict__ A, const double* __restrict__ B,
                   int tc, const double* __restrict__ smant,
                   const int* __restrict__ sexp, int ld,
                   const double* __restrict__ mu, const Groups gs,
                   const Group* __restrict__ d) {
  // this block's group: the last whose first block is <= blockIdx.x
  Group g;
  if constexpr (DEV) {
    int lo = 0, hi = gs.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(&d[mid].block0) <= (int)blockIdx.x) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    g = d[lo];
  } else {
    // static indices keep the parameters in the constant bank
    g = gs.g[0];
#pragma unroll
    for (int k = 1; k < MAXG; ++k) {
      if (k < gs.n && gs.g[k].block0 <= (int)blockIdx.x) g = gs.g[k];
    }
  }
  const long long col =
      (long long)((int)blockIdx.x - g.block0) * THREADS + threadIdx.x;
  if (col >= (long long)g.gm * g.ig) return;
  const int ml = (int)(col / g.ig);
  const int i = (int)(col - (long long)ml * g.ig);
  const int m = g.m0 + ml;
  const int lat = g.i0 + i;
  const int J = g.J;
  const long long ig = g.ig;
  const double x = mu[lat];
  const double* a = A + (size_t)m * tc + 1;      // a[t] = A(m, t + 1)
  const double* b = B + (size_t)m * tc + 1;
  double p = smant[(size_t)m * ld + lat];
  int E = sexp[(size_t)m * ld + lat];
  double s = scale_of(E);
  double q = 0.0;
  O* o = (O*)g.out + (size_t)ml * J * ig + i;
  int t = 0;
  for (; t + K <= J; t += K) {
#pragma unroll
    for (int u = 0; u < K; ++u) {
      __stcs(o + (t + u) * ig, emit<O>(p, s, E));
      const double r = __dsub_rn(__dmul_rn(__ldg(a + t + u), __dmul_rn(x, p)),
                                 __dmul_rn(__ldg(b + t + u), q));
      q = p;
      p = r;
    }
    rescale(p, q, E, s);
  }
  for (; t < J; ++t) {
    __stcs(o + t * ig, emit<O>(p, s, E));
    const double r = __dsub_rn(__dmul_rn(__ldg(a + t), __dmul_rn(x, p)),
                               __dmul_rn(__ldg(b + t), q));
    q = p;
    p = r;
  }
}

// desc: 6 ints a group, in launch order: m0, gm, J, i0, ig, first block
// (0 for the first group, ascending); past MAXG groups the descriptors go to
// the device buffer ``dev_desc`` (32 bytes a group), else into gs
template <typename O>
int launch(const void* A, const void* B, int tc, const void* smant,
           const void* sexp, int ld, const void* mu, void* const* outs,
           const int* desc, int ngroups, void* dev_desc, int nblocks,
           void* stream) {
  if (ngroups < 1 || desc[5] != 0) return (int)cudaErrorInvalidValue;
  std::vector<Group> h(ngroups);
  for (int k = 0; k < ngroups; ++k) {
    const int* d = desc + 6 * k;
    if (k > 0 && d[5] < h[k - 1].block0) return (int)cudaErrorInvalidValue;
    h[k] = Group{outs[k], d[0], d[1], d[2], d[3], d[4], d[5]};
  }
  const bool dev = ngroups > MAXG;
  if (dev && dev_desc == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Groups gs = {};
  gs.n = ngroups;
  if (dev) {
    // staged from pageable memory before the call returns, ahead of the
    // kernel on the stream
    const cudaError_t rc = cudaMemcpyAsync(
        dev_desc, h.data(), sizeof(Group) * ngroups, cudaMemcpyHostToDevice,
        s);
    if (rc != cudaSuccess) return (int)rc;
  } else {
    for (int k = 0; k < ngroups; ++k) gs.g[k] = h[k];
  }
  if (nblocks == 0) return 0;
  if (dev) {
    k4_tablegen_kernel<O, true><<<nblocks, THREADS, 0, s>>>(
        (const double*)A, (const double*)B, tc, (const double*)smant,
        (const int*)sexp, ld, (const double*)mu, gs, (const Group*)dev_desc);
  } else {
    k4_tablegen_kernel<O, false><<<nblocks, THREADS, 0, s>>>(
        (const double*)A, (const double*)B, tc, (const double*)smant,
        (const int*)sexp, ld, (const double*)mu, gs, nullptr);
  }
  return (int)cudaGetLastError();
}

}  // namespace k4

extern "C" {

#define K4_ENTRY(SUFFIX, O)                                                  \
  int ect_tablegen##SUFFIX(const void* A, const void* B, int tc,             \
                           const void* smant, const void* sexp, int ld,      \
                           const void* mu, void* const* outs,                \
                           const int* desc, int ngroups, void* dev_desc,     \
                           int nblocks, void* stream) {                      \
    return k4::launch<O>(A, B, tc, smant, sexp, ld, mu, outs, desc, ngroups, \
                         dev_desc, nblocks, stream);                         \
  }                                                                          \
  int ect_tablegen_shape##SUFFIX(int nblocks, int* info) {                   \
    return ect::launch_shape(k4::k4_tablegen_kernel<O, false>, dim3(nblocks),\
                             k4::THREADS, 0, info);                          \
  }

K4_ENTRY(_f32, float)
K4_ENTRY(_f64, double)
K4_ENTRY(_bf16, ect::bf16)

}  // extern "C"
