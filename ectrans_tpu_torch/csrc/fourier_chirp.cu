// The Fourier layer's bucketed chirp-z passes for Hopper (sm_90a): kernels
// F1-F4 around torch.fft (ops/fourier.py, synthesis_bucketed and
// analysis_bucketed).
//
// Replaces no Pallas kernel: the JAX package runs these passes as XLA
// element-wise operations around its FFTs.  Added to fuse the pointwise
// stages of each bucket's pass, which the plain PyTorch composition ran as
// some ten separate element-wise round trips through device memory on
// complex128 arrays of up to (pairs, rows, nfft), about 80 % of the layer's
// bytes.  A bucket's pass is five launches: F1 (pre), torch.fft.fft, F2
// (product), torch.fft.ifft, F3 (post); F4 (the RMS sums) is one launch a
// call.
//
// - F1 synthesis (syn_pre_kernel): the Fourier input (nfld, 2, M, nrows),
//   fp32 or fp64, straight into the FFT's input (pairs, rows_b, nfft) in
//   complex128: the keep mask (m <= nmen of the row, no m = 0 imaginary
//   part), the gather of the bucket's rows, the widening, the product with
//   the reciprocal of the field's RMS, the Hermitian pair pack w_m = F_a,m
//   + i F_b,m (slot mb + m) and w_{-m} = conj F_a,m + i conj F_b,m (slot
//   mb - m), the product with syn_in and the zeros up to nfft.  The input
//   has the rows innermost and the FFT the slots, so a block transposes a
//   tile of 32 rows x 32 modes of raw inputs through shared memory (in the
//   input's type: half the bytes in fp32, so more blocks fit an SM): reads
//   are coalesced along the rows and writes along the slots.  A field past
//   nfld (odd counts) is a zero partner.
// - F1 analysis (ana_pre_kernel): the grid (nfld, nrows, ndlon) into the
//   FFT's input: the points j < NLOEN, the widening, the product with the
//   reciprocal of the field's RMS over the bucket, z = f_a + i f_b, the
//   product with ana_in, zeros up to nfft.  Rows and slots are both
//   innermost: no transpose.
// - F2 (product_kernel): the forward FFT's output times the kernel FFT
//   (syn_bh or ana_bh, one row a latitude, shared by every pair, with the
//   inverse FFT's 1/nfft folded in), in place; a thread reads its table
//   entry once and applies it to the block's pairs.
// - F3 synthesis (syn_post_kernel): the first ndlon_b points of each row of
//   the inverse FFT's output times syn_out, the real part to field 2p and
//   the imaginary part to field 2p + 1, times their RMS, rounded once into
//   the output rows (nfld, nrows, ndlon), zeros past ndlon_b included.
// - F3 analysis (ana_post_kernel): slots mb - m and mb + m times ana_out,
//   F_a,m = (Z_m + conj Z_{-m}) / 2 and F_b,m = (Z_m - conj Z_{-m}) / 2i,
//   times the RMS, rounded once into (nfld, 2, M, nrows), zeros from
//   K = min(M, mb + 1) up: the output needs no zero fill of its own.
//   Transposed through shared memory as F1 synthesis, the other way, the
//   values rounded before they enter it.
// - F4 (syn_ss_kernel, ana_ss_kernel): the sums of squares in fp64, NP = 32
//   partial sums a field (synthesis: over the kept inputs; analysis: a
//   field and bucket, over its points j < NLOEN).  Every F1 and F3 block
//   folds the partial sums of its fields with one warp butterfly, which
//   gives each kernel the same bits: sqrt(sum / count), 1 for a zero field.
//   normalize=False passes no sums, and the scale is 1.
//
// Everything is bound by device memory: the passes move complex128 arrays
// of Σ rows x nfft = 12.13 M slots a field pair at TCO1279 (1.84 times the
// grid), and do a few fp64 operations a slot.  Each kernel reads its
// inputs once and writes its outputs once, in fp64 registers between; the
// chirp tables are read once a block of up to PPB = 4 pairs (F2: PPB2 =
// 16).  F1 multiplies by the RMS's reciprocal, made once a block: an fp64
// division a value cost F1 synthesis a fifth of its time on the H100.  The
// products are the plain stages' own operations in the same order, so the
// two differ by the FMA contractions alone.

#include <cuda_runtime.h>

#include "fourier_common.cuh"

namespace fz {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 32;      // rows x modes of a transposed tile
constexpr int PPB = 4;        // field pairs a block (F1, F3)
constexpr int PPB2 = 16;      // field pairs a block (F2)
constexpr int ZW = 256;       // F1 synthesis: zero slots a block's rows get
constexpr int SLOTS = 2048;   // F1 analysis: slots a block
constexpr int KPT = TILE / WARPS;   // rows (modes) a thread of a tile

// sc[i] = the RMS of field f0 + i (its reciprocal with ``inverse``), i <
// nf (at most 2 PPB), a warp a field
__device__ __forceinline__ void block_scales(double* sc, const double* ss,
                                             long long ld, int f0, int nf,
                                             int nfld, double count,
                                             bool inverse) {
  const int warp = threadIdx.x >> 5;
  for (int i = warp; i < nf; i += WARPS) {
    const double s = warp_scale(ss, ld, f0 + i, nfld, count);
    if ((threadIdx.x & 31) == 0) sc[i] = inverse ? 1.0 / s : s;
  }
  __syncthreads();
}

// the block's sum of v, in thread 0
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double part[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += part[w];
  }
  return s;
}

// F4 synthesis: grid (NP, nfld); block g sums the lines c * M + m = g,
// g + NP, ... of its field over the rows that keep them
template <typename T>
__global__ void __launch_bounds__(THREADS)
syn_ss_kernel(const T* __restrict__ x, const int* __restrict__ mkeep,
              double* __restrict__ ss, int M, int nrows) {
  const T* xf = x + (long long)blockIdx.y * 2 * M * nrows;
  double s = 0.0;
  for (int line = blockIdx.x; line < 2 * M; line += NP) {
    if (line == M) continue;               // the m = 0 imaginary part
    const int m = line < M ? line : line - M;
    const T* xl = xf + (long long)line * nrows;
#pragma unroll 4
    for (int r = threadIdx.x; r < nrows; r += THREADS) {
      if (m <= __ldg(mkeep + r)) {
        const double v = (double)xl[r];
        s += v * v;
      }
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0) ss[(long long)blockIdx.y * NP + blockIdx.x] = s;
}

// F4 analysis: grid (nb * NP, nfld); block (b, g) sums the rows g, g + NP,
// ... of bucket b, a warp a row.  rows holds each bucket's (2, nrows_b)
// table (the layer's row, its NLOEN) in bucket order, bucket b's from
// 2 starts[b] on, nrows_b = starts[b + 1] - starts[b]
template <typename T>
__global__ void __launch_bounds__(THREADS)
ana_ss_kernel(const T* __restrict__ g, const int* __restrict__ rows,
              const int* __restrict__ starts, double* __restrict__ ss,
              int nb, int nrows, int ndlon) {
  const int b = blockIdx.x / NP;
  const int part = blockIdx.x - b * NP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = starts[b], nrows_b = starts[b + 1] - s0;
  const int* br = rows + 2LL * s0;
  double s = 0.0;
  for (int r = part + NP * warp; r < nrows_b; r += NP * WARPS) {
    const int L = br[nrows_b + r];
    const T* gr = g + ((long long)blockIdx.y * nrows + br[r]) * ndlon;
#pragma unroll 4
    for (int j = lane; j < L; j += 32) {
      const double v = (double)gr[j];
      s += v * v;
    }
  }
  s = block_sum(s);
  if (threadIdx.x == 0)
    ss[((long long)blockIdx.y * nb + b) * NP + part] = s;
}

// F1 synthesis: grid (row tiles, mode tiles + zero tiles, pair groups)
template <typename T>
__global__ void __launch_bounds__(THREADS)
syn_pre_kernel(const T* __restrict__ x, const int* __restrict__ mkeep,
               const int* __restrict__ rows, const double2* __restrict__ tin,
               const double* __restrict__ ss, double count,
               double2* __restrict__ a, int nfld, int M, int nrows,
               int nrows_b, int mb, int nfft, int p0, int npairs, int nmt) {
  __shared__ T xs[4][TILE][TILE + 1];
  __shared__ double sc[2 * PPB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * TILE;
  const int q0 = blockIdx.z * PPB;
  const int nq = min(PPB, npairs - q0);
  const int P = 2 * mb + 1;
  const long long plane = (long long)nrows_b * nfft;
  if ((int)blockIdx.y >= nmt) {
    // the zeros from slot 2 mb + 1 up
    const int s0 = P + ((int)blockIdx.y - nmt) * ZW;
    const int s1 = min(nfft, s0 + ZW);
    const double2 z = make_double2(0.0, 0.0);
    for (int q = 0; q < nq; ++q) {
      for (int k = warp; k < TILE && r0 + k < nrows_b; k += WARPS) {
        double2* dst = a + (q0 + q) * plane + (long long)(r0 + k) * nfft;
        for (int s = s0 + lane; s < s1; s += 32) dst[s] = z;
      }
    }
    return;
  }
  block_scales(sc, ss, NP, 2 * (p0 + q0), 2 * nq, nfld, count, true);
  const int m0 = blockIdx.y * TILE;
  const int m = m0 + lane;            // the write phase's mode
  double2 tp[KPT], tn[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int r = r0 + warp + WARPS * k;
    tp[k] = tn[k] = make_double2(0.0, 0.0);
    if (r < nrows_b && m <= mb) {
      tp[k] = tin[(long long)r * P + mb + m];
      tn[k] = tin[(long long)r * P + mb - m];
    }
  }
  // the read phase's row: its modes m <= min(nmen, mb) are read
  const int rl = r0 + lane;
  int row = 0, km = -1;
  if (rl < nrows_b) {
    row = rows[rl];
    km = min(mkeep[row], mb);
  }
  const long long fstride = 2LL * M * nrows;
  const long long cstride = (long long)M * nrows;
  for (int q = 0; q < nq; ++q) {
    const int fa = 2 * (p0 + q0 + q);
    const bool hb = fa + 1 < nfld;
    const T* xa = x + fa * fstride + row;
    const T* xb = hb ? xa + fstride : xa;
    // the kept inputs, raw, mode-major in shared memory
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int mi = warp + WARPS * k;
      const int mm = m0 + mi;
      T ar = 0, ai = 0, br = 0, bi = 0;
      if (mm <= km) {
        const long long o = (long long)mm * nrows;
        ar = xa[o];
        if (mm > 0) ai = xa[o + cstride];
        if (hb) {
          br = xb[o];
          if (mm > 0) bi = xb[o + cstride];
        }
      }
      xs[0][mi][lane] = ar;
      xs[1][mi][lane] = ai;
      xs[2][mi][lane] = br;
      xs[3][mi][lane] = bi;
    }
    __syncthreads();
    if (m <= mb) {
      const double ra = sc[2 * q], rb = sc[2 * q + 1];
      double2* dst = a + (q0 + q) * plane + mb;
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const int ri = warp + WARPS * k;
        const int r = r0 + ri;
        if (r < nrows_b) {
          const double ar = (double)xs[0][lane][ri] * ra;
          const double ai = (double)xs[1][lane][ri] * ra;
          const double br = (double)xs[2][lane][ri] * rb;
          const double bi = (double)xs[3][lane][ri] * rb;
          double2* d = dst + (long long)r * nfft;
          d[m] = cmul(make_double2(ar - bi, ai + br), tp[k]);
          if (m > 0) d[-m] = cmul(make_double2(ar + bi, br - ai), tn[k]);
        }
      }
    }
    __syncthreads();
  }
}

// F1 analysis: grid (slot chunks, rows_b, pair groups)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ana_pre_kernel(const T* __restrict__ g, const int* __restrict__ rows,
               const double2* __restrict__ tin, const double* __restrict__ ss,
               long long ssld, double count, double2* __restrict__ a,
               int nfld, int nrows, int ndlon, int nrows_b, int ndlon_b,
               int nfft, int p0, int npairs) {
  __shared__ double sc[2 * PPB];
  const int r = blockIdx.y;
  const int q0 = blockIdx.z * PPB;
  const int nq = min(PPB, npairs - q0);
  block_scales(sc, ss, ssld, 2 * (p0 + q0), 2 * nq, nfld, count, true);
  const int row = rows[r], L = rows[nrows_b + r];
  const long long plane = (long long)nrows_b * nfft;
  double2* dst = a + q0 * plane + (long long)r * nfft;
  const long long fstride = (long long)nrows * ndlon;
  const T* ga = g + (2LL * (p0 + q0) * nrows + row) * ndlon;
  const int s1 = min(nfft, ((int)blockIdx.x + 1) * SLOTS);
  for (int s = blockIdx.x * SLOTS + threadIdx.x; s < s1; s += THREADS) {
    if (s < L) {
      const double2 t = tin[(long long)r * ndlon_b + s];
      double2 v[PPB];
#pragma unroll
      for (int q = 0; q < PPB; ++q) {
        if (q < nq) {
          const int fa = 2 * (p0 + q0 + q);
          v[q].x = (double)ga[2 * q * fstride + s] * sc[2 * q];
          v[q].y = fa + 1 < nfld
                       ? (double)ga[(2 * q + 1) * fstride + s] * sc[2 * q + 1]
                       : 0.0;
        }
      }
#pragma unroll
      for (int q = 0; q < PPB; ++q)
        if (q < nq) dst[q * plane + s] = cmul(v[q], t);
    } else {
      for (int q = 0; q < nq; ++q) dst[q * plane + s] = make_double2(0.0, 0.0);
    }
  }
}

// F2: grid (slot chunks, rows_b, pair groups)
__global__ void __launch_bounds__(THREADS)
product_kernel(double2* __restrict__ a, const double2* __restrict__ bh,
               int nrows_b, int nfft, int npairs) {
  const int s = blockIdx.x * THREADS + threadIdx.x;
  if (s >= nfft) return;
  const int q0 = blockIdx.z * PPB2;
  const int nq = min(PPB2, npairs - q0);
  const long long plane = (long long)nrows_b * nfft;
  const long long at = (long long)blockIdx.y * nfft + s;
  const double2 h = bh[at];
  double2* p = a + q0 * plane + at;
  double2 v[PPB2];
#pragma unroll
  for (int q = 0; q < PPB2; ++q)
    if (q < nq) v[q] = p[q * plane];
#pragma unroll
  for (int q = 0; q < PPB2; ++q)
    if (q < nq) p[q * plane] = cmul(v[q], h);
}

// F3 synthesis: grid (rows_b, pair groups); a block writes its row's
// ndlon points of its fields
template <typename T>
__global__ void __launch_bounds__(THREADS)
syn_post_kernel(const double2* __restrict__ b, const double2* __restrict__ tout,
                const int* __restrict__ rows, const double* __restrict__ ss,
                double count, T* __restrict__ out, int nfld, int nrows,
                int ndlon, int nrows_b, int ndlon_b, int nfft, int p0,
                int npairs) {
  __shared__ double sc[2 * PPB];
  const int r = blockIdx.x;
  const int q0 = blockIdx.y * PPB;
  const int nq = min(PPB, npairs - q0);
  block_scales(sc, ss, NP, 2 * (p0 + q0), 2 * nq, nfld, count, false);
  const long long plane = (long long)nrows_b * nfft;
  const double2* src = b + q0 * plane + (long long)r * nfft;
  const long long fstride = (long long)nrows * ndlon;
  T* o = out + (2LL * (p0 + q0) * nrows + rows[r]) * ndlon;
  for (int j = threadIdx.x; j < ndlon; j += THREADS) {
    double2 v[PPB];
    if (j < ndlon_b) {
      const double2 t = tout[(long long)r * ndlon_b + j];
#pragma unroll
      for (int q = 0; q < PPB; ++q)
        if (q < nq) v[q] = src[q * plane + j];
#pragma unroll
      for (int q = 0; q < PPB; ++q) {
        if (q < nq) {
          const double2 gq = cmul(v[q], t);
          v[q] = make_double2(gq.x * sc[2 * q], gq.y * sc[2 * q + 1]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < PPB; ++q) v[q] = make_double2(0.0, 0.0);
    }
#pragma unroll
    for (int q = 0; q < PPB; ++q) {
      if (q < nq) {
        o[2 * q * fstride + j] = (T)v[q].x;
        if (2 * (p0 + q0 + q) + 1 < nfld) o[(2 * q + 1) * fstride + j] = (T)v[q].y;
      }
    }
  }
}

// F3 analysis: grid (row tiles, mode tiles, pair groups)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ana_post_kernel(const double2* __restrict__ b, const double2* __restrict__ tout,
                const int* __restrict__ rows, const double* __restrict__ ss,
                long long ssld, double count, T* __restrict__ out, int nfld,
                int M, int nrows, int nrows_b, int mb, int K, int nfft,
                int p0, int npairs) {
  __shared__ T fs[4][TILE][TILE + 1];
  __shared__ double sc[2 * PPB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * TILE, m0 = blockIdx.y * TILE;
  const int q0 = blockIdx.z * PPB;
  const int nq = min(PPB, npairs - q0);
  const long long cstride = (long long)M * nrows;
  const long long fstride = 2 * cstride;
  // the write phase's row
  const int rl = r0 + lane;
  const int row = rl < nrows_b ? rows[rl] : 0;
  if (m0 >= K) {
    if (rl < nrows_b) {
      for (int q = 0; q < nq; ++q) {
        const int fa = 2 * (p0 + q0 + q);
        const int nf = fa + 1 < nfld ? 2 : 1;
        for (int mi = warp; mi < TILE && m0 + mi < M; mi += WARPS) {
          T* o = out + fa * fstride + (long long)(m0 + mi) * nrows + row;
          for (int c = 0; c < 2 * nf; ++c) o[(c >> 1) * fstride + (c & 1) * cstride] = (T)0;
        }
      }
    }
    return;
  }
  block_scales(sc, ss, ssld, 2 * (p0 + q0), 2 * nq, nfld, count, false);
  const int P = 2 * mb + 1;
  const int m = m0 + lane;            // the read phase's mode
  double2 tp[KPT], tn[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int r = r0 + warp + WARPS * k;
    tp[k] = tn[k] = make_double2(0.0, 0.0);
    if (r < nrows_b && m < K) {
      tp[k] = tout[(long long)r * P + mb + m];
      tn[k] = tout[(long long)r * P + mb - m];
    }
  }
  const long long plane = (long long)nrows_b * nfft;
  for (int q = 0; q < nq; ++q) {
    const double sa = sc[2 * q], sb = sc[2 * q + 1];
    const double2* src = b + (q0 + q) * plane + mb;
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int ri = warp + WARPS * k;
      const int r = r0 + ri;
      double far = 0.0, fai = 0.0, fbr = 0.0, fbi = 0.0;
      if (r < nrows_b && m < K) {
        const double2 zp = cmul(src[(long long)r * nfft + m], tp[k]);
        const double2 zn = cmul(src[(long long)r * nfft - m], tn[k]);
        far = (zp.x + zn.x) * 0.5 * sa;
        fai = (zp.y - zn.y) * 0.5 * sa;
        fbr = (zp.y + zn.y) * 0.5 * sb;
        fbi = (zn.x - zp.x) * 0.5 * sb;
      }
      fs[0][lane][ri] = (T)far;
      fs[1][lane][ri] = (T)fai;
      fs[2][lane][ri] = (T)fbr;
      fs[3][lane][ri] = (T)fbi;
    }
    __syncthreads();
    if (rl < nrows_b) {
      const int fa = 2 * (p0 + q0 + q);
      const bool hb = fa + 1 < nfld;
      for (int mi = warp; mi < TILE && m0 + mi < M; mi += WARPS) {
        T* o = out + fa * fstride + (long long)(m0 + mi) * nrows + row;
        o[0] = fs[0][mi][lane];
        o[cstride] = fs[1][mi][lane];
        if (hb) {
          o[fstride] = fs[2][mi][lane];
          o[fstride + cstride] = fs[3][mi][lane];
        }
      }
    }
    __syncthreads();
  }
}

inline int groups(int npairs) { return (npairs + PPB - 1) / PPB; }

inline bool empty(dim3 g) { return g.x == 0 || g.y == 0 || g.z == 0; }

}  // namespace fz

// C entries: each launches on the given stream and returns
// cudaGetLastError() (0 also for an empty launch).  Pointers are device
// pointers; ss may be null (normalize=False: every scale 1).
#define FZ_TYPED_ENTRIES(T, SUF)                                              \
  extern "C" int ect_fourier_syn_ss##SUF(const void* x, const void* mkeep,   \
                                         void* ss, int nfld, int M,          \
                                         int nrows, cudaStream_t st) {       \
    const dim3 grid(fz::NP, nfld, 1);                                        \
    if (fz::empty(grid)) return 0;                                           \
    fz::syn_ss_kernel<T><<<grid, fz::THREADS, 0, st>>>(                      \
        (const T*)x, (const int*)mkeep, (double*)ss, M, nrows);              \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int ect_fourier_ana_ss##SUF(const void* g, const void* rows,    \
                                         const void* starts, void* ss,       \
                                         int nfld, int nb, int nrows,        \
                                         int ndlon, cudaStream_t st) {       \
    const dim3 grid(nb * fz::NP, nfld, 1);                                   \
    if (fz::empty(grid)) return 0;                                           \
    fz::ana_ss_kernel<T><<<grid, fz::THREADS, 0, st>>>(                      \
        (const T*)g, (const int*)rows, (const int*)starts, (double*)ss, nb,  \
        nrows, ndlon);                                                       \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int ect_fourier_syn_pre##SUF(                                   \
      const void* x, const void* mkeep, const void* rows, const void* tin,   \
      const void* ss, double count, void* a, int nfld, int M, int nrows,     \
      int nrows_b, int mb, int nfft, int p0, int npairs, cudaStream_t st) {  \
    const int nmt = (mb + fz::TILE) / fz::TILE;                              \
    const int nzt = (nfft - 2 * mb - 1 + fz::ZW - 1) / fz::ZW;               \
    const dim3 grid((nrows_b + fz::TILE - 1) / fz::TILE, nmt + nzt,          \
                    fz::groups(npairs));                                     \
    if (fz::empty(grid)) return 0;                                           \
    fz::syn_pre_kernel<T><<<grid, fz::THREADS, 0, st>>>(                     \
        (const T*)x, (const int*)mkeep, (const int*)rows,                    \
        (const double2*)tin, (const double*)ss, count, (double2*)a, nfld, M, \
        nrows, nrows_b, mb, nfft, p0, npairs, nmt);                          \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int ect_fourier_ana_pre##SUF(                                   \
      const void* g, const void* rows, const void* tin, const void* ss,      \
      long long ssld, double count, void* a, int nfld, int nrows, int ndlon, \
      int nrows_b, int ndlon_b, int nfft, int p0, int npairs,                \
      cudaStream_t st) {                                                     \
    const dim3 grid((nfft + fz::SLOTS - 1) / fz::SLOTS, nrows_b,             \
                    fz::groups(npairs));                                     \
    if (fz::empty(grid)) return 0;                                           \
    fz::ana_pre_kernel<T><<<grid, fz::THREADS, 0, st>>>(                     \
        (const T*)g, (const int*)rows, (const double2*)tin,                  \
        (const double*)ss, ssld, count, (double2*)a, nfld, nrows, ndlon,     \
        nrows_b, ndlon_b, nfft, p0, npairs);                                 \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int ect_fourier_syn_post##SUF(                                  \
      const void* b, const void* tout, const void* rows, const void* ss,     \
      double count, void* out, int nfld, int nrows, int ndlon, int nrows_b,  \
      int ndlon_b, int nfft, int p0, int npairs, cudaStream_t st) {          \
    const dim3 grid(nrows_b, fz::groups(npairs), 1);                         \
    if (fz::empty(grid)) return 0;                                           \
    fz::syn_post_kernel<T><<<grid, fz::THREADS, 0, st>>>(                    \
        (const double2*)b, (const double2*)tout, (const int*)rows,           \
        (const double*)ss, count, (T*)out, nfld, nrows, ndlon, nrows_b,      \
        ndlon_b, nfft, p0, npairs);                                          \
    return (int)cudaGetLastError();                                          \
  }                                                                          \
  extern "C" int ect_fourier_ana_post##SUF(                                  \
      const void* b, const void* tout, const void* rows, const void* ss,     \
      long long ssld, double count, void* out, int nfld, int M, int nrows,   \
      int nrows_b, int mb, int K, int nfft, int p0, int npairs,              \
      cudaStream_t st) {                                                     \
    const dim3 grid((nrows_b + fz::TILE - 1) / fz::TILE,                     \
                    (M + fz::TILE - 1) / fz::TILE, fz::groups(npairs));      \
    if (fz::empty(grid)) return 0;                                           \
    fz::ana_post_kernel<T><<<grid, fz::THREADS, 0, st>>>(                    \
        (const double2*)b, (const double2*)tout, (const int*)rows,           \
        (const double*)ss, ssld, count, (T*)out, nfld, M, nrows, nrows_b,    \
        mb, K, nfft, p0, npairs);                                            \
    return (int)cudaGetLastError();                                          \
  }

FZ_TYPED_ENTRIES(float, _f32)
FZ_TYPED_ENTRIES(double, _f64)

extern "C" int ect_fourier_product(void* a, const void* bh, int nrows_b,
                                   int nfft, int npairs, cudaStream_t st) {
  const dim3 grid((nfft + fz::THREADS - 1) / fz::THREADS, nrows_b,
                  (npairs + fz::PPB2 - 1) / fz::PPB2);
  if (fz::empty(grid)) return 0;
  fz::product_kernel<<<grid, fz::THREADS, 0, st>>>(
      (double2*)a, (const double2*)bh, nrows_b, nfft, npairs);
  return (int)cudaGetLastError();
}
