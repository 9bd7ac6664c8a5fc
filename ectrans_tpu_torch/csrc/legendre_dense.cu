// Dense-row Legendre transforms for Hopper (sm_90a): kernels K1, K2, K8,
// and the fp64 variant of K7.
//
// K1 replaces ectrans_tpu/ops/legendre_pallas.py group_inv_dense
// (_inv_dense_kernel); K2 replaces group_dir_dense (_dir_dense_kernel); K7
// and K8 replace the hemisphere-packed group_inv_dense2 (_inv_dense2_kernel)
// and group_dir_dense2 (_dir_dense2_kernel).  All contract one m-group of
// diagonal-realigned rows against the full-n table pn[m, j, i] =
// Pbar_{m+j}^m(mu_i) of that group (gm, J, ig):
//   K1: north = sum_j d2_j P_j, south = sum_j (-1)^j d2_j P_j, the southern
//       hemisphere from the parity identity Pbar_n^m(-mu) = (-1)^(n-m) Pbar_n^m(mu);
//   K2: out_j = sum_i fn_i P_ji + (-1)^j sum_i fs_i P_ji;
//   K7: out = d4 . pn for caller-stacked rows d4 = [d2 ; d2 sgn] (2 fc2 rows);
//   K8: out_j = sum_i f4_i P_ji for caller-stacked rows f4 = [fn ; fs], the
//       raw dots (the caller combines out[:fc2] + out[fc2:] sgn).
// The fp32 and bf16-table variants of K7 and K8 are kernels of their own,
// register-tiled and pipelined (legendre_dense2.cu, legendre_dense2_dir.cu);
// their fp64 variants, off the benchmark path, are K1's and K2's templates
// without the sign (STACKED), below.
//
// What bounds them: each table element is read once per transform and
// feeds fc2 fused multiply-adds (fc2 = 2 * fields, 20-32 on the benchmark
// path), i.e. fc2/2 FLOP per byte in fp32 -- near the H100's fp32 CUDA-core
// ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  The design therefore
// (a) reads the table exactly once per row chunk, coalesced along latitude
// i, through shared memory, (b) keeps the small coefficient operand in
// shared memory and the sums in registers, and (c) halves the multiply-adds
// by splitting each sum over even and odd j: north = E + O, south = E - O
// (K1), and by pre-combining fn +- fs so each output column takes one sum
// (K2).  The TPU stacked the hemispheres (K7, K8) to fill more rows of its
// 128-row matrix unit; fp64 K8 and K7 are K2 and K1 without the sign
// (STACKED).  Row chunks are the fastest grid axis, so the chunks of one
// table tile run together and the second reads it from L2.
// Arithmetic is plain FMA in the working type (fp32 or fp64), no tensor
// cores: fp32 FMA is the "highest" tier's accuracy contract, and "high" is
// served by it too.  The "bf16" tier reads bf16 tables and rounds the
// operand to bf16 (legendre_common.cuh).  Each staged chunk (16-32 terms) is
// summed in registers and folded into a compensated total, so the rounding
// error grows with the chunk length and not with J or ig.  Pipelining
// (cp.async/TMA) and tensor-core variants of K1, K2 and K8 are left for
// later work.

#include "legendre_common.cuh"

namespace {

using ect::add_compensated;
using ect::bf16;
using ect::operand;
using ect::table_value;

constexpr int NY = 4;              // thread rows of a block
constexpr int RPT = 8;             // coefficient rows per thread
constexpr int ROWS = NY * RPT;     // rows per block; gridDim.x walks the rows
constexpr int TI = 64;             // K1/K7: latitudes per block (threads in x)
constexpr int TJ = 32;             // K1/K7: degrees staged per step (even)
constexpr int DJ = 64;             // K2/K8: degrees per block (threads in x)
constexpr int DI = 32;             // K2/K8: latitudes staged per step
constexpr int THREADS = 256;       // = TI * NY = DJ * NY

// north[m, r, i] = sum_j d2[m, r, j] pn[m, j, i]
// south[m, r, i] = sum_j (-1)^j d2[m, r, j] pn[m, j, i]   (not STACKED)
// Block (row chunk, i-tile, m); thread (tx = latitude, ty = row phase).
template <typename T, typename P, bool STACKED>
__global__ void __launch_bounds__(THREADS)
inv_dense_kernel(const T* __restrict__ d2, const P* __restrict__ pn,
                 T* __restrict__ north, T* __restrict__ south,
                 int fc2, int J, int ig) {
  __shared__ T ds[ROWS][TJ];
  __shared__ T ps[TJ][TI];
  const int r0 = blockIdx.x * ROWS;
  const int i0 = blockIdx.y * TI;
  const int m = blockIdx.z;
  const int tx = threadIdx.x % TI;
  const int ty = threadIdx.x / TI;
  const T* d2m = d2 + (size_t)m * fc2 * J;
  const P* pnm = pn + (size_t)m * J * ig;

  // per-chunk partial sums, folded into compensated running totals
  T ev[RPT], od[RPT], evc[RPT], odc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    ev[r] = T(0); od[r] = T(0); evc[r] = T(0); odc[r] = T(0);
  }

  for (int j0 = 0; j0 < J; j0 += TJ) {
    for (int e = threadIdx.x; e < ROWS * TJ; e += THREADS) {
      const int r = e / TJ, j = e % TJ;
      const int row = r0 + r, jj = j0 + j;
      ds[r][j] = (row < fc2 && jj < J)
                     ? operand<T, P>(d2m[(size_t)row * J + jj]) : T(0);
    }
    for (int e = threadIdx.x; e < TJ * TI; e += THREADS) {
      const int j = e / TI, i = e % TI;
      const int jj = j0 + j, ii = i0 + i;
      ps[j][i] = (jj < J && ii < ig) ? table_value(pnm[(size_t)jj * ig + ii])
                                     : T(0);
    }
    __syncthreads();
    T pe_sum[RPT], po_sum[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { pe_sum[r] = T(0); po_sum[r] = T(0); }
#pragma unroll 4
    for (int j = 0; j < TJ; j += 2) {   // j0 is even: local parity = global
      const T pe = ps[j][tx];
      const T po = ps[j + 1][tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        pe_sum[r] = fma(ds[ty + NY * r][j], pe, pe_sum[r]);
        po_sum[r] = fma(ds[ty + NY * r][j + 1], po, po_sum[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      add_compensated(ev[r], evc[r], pe_sum[r]);
      add_compensated(od[r], odc[r], po_sum[r]);
    }
    __syncthreads();
  }

  const int ii = i0 + tx;
  if (ii >= ig) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = r0 + ty + NY * r;
    if (row < fc2) {
      const size_t o = ((size_t)m * fc2 + row) * ig + ii;
      const T e = ev[r] + evc[r], d = od[r] + odc[r];
      north[o] = e + d;
      if (!STACKED) south[o] = e - d;
    }
  }
}

// out[m, r, j] = sum_i fn[m, r, i] pn[m, j, i] + (-1)^j sum_i fs[m, r, i] pn[m, j, i]
//             = sum_i (fn +- fs)[m, r, i] pn[m, j, i]   (+ for even j);
// STACKED: out[m, r, j] = sum_i fn[m, r, i] pn[m, j, i] (fs is not read).
// Block (row chunk, j-tile, m); thread (tx = degree, ty = row phase).
template <typename T, typename P, bool STACKED>
__global__ void __launch_bounds__(THREADS)
dir_dense_kernel(const T* __restrict__ fn, const T* __restrict__ fs,
                 const P* __restrict__ pn, T* __restrict__ out,
                 int fc2, int J, int ig) {
  // sx[r][0][i] = fn + fs, sx[r][1][i] = fn - fs (STACKED: sx[r][0][i] = fn
  // alone); the +1 pad puts the two halves read by one warp (even and odd j
  // threads) in different banks
  __shared__ T sx[ROWS][2][DI + 1];
  __shared__ T ps[DI][DJ + 1];       // transposed table tile, padded
  const int r0 = blockIdx.x * ROWS;
  const int j0 = blockIdx.y * DJ;
  const int m = blockIdx.z;
  const int tx = threadIdx.x % DJ;
  const int ty = threadIdx.x / DJ;
  const int j = j0 + tx;
  const int par = STACKED ? 0 : (j & 1);
  const T* fnm = fn + (size_t)m * fc2 * ig;
  const T* fsm = STACKED ? nullptr : fs + (size_t)m * fc2 * ig;
  const P* pnm = pn + (size_t)m * J * ig;

  T acc[RPT], accc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) { acc[r] = T(0); accc[r] = T(0); }

  for (int i0 = 0; i0 < ig; i0 += DI) {
    for (int e = threadIdx.x; e < ROWS * DI; e += THREADS) {
      const int r = e / DI, i = e % DI;
      const int row = r0 + r, ii = i0 + i;
      T a = T(0), b = T(0);
      if (row < fc2 && ii < ig) {
        a = operand<T, P>(fnm[(size_t)row * ig + ii]);
        if (!STACKED) b = operand<T, P>(fsm[(size_t)row * ig + ii]);
      }
      sx[r][0][i] = a + b;
      if (!STACKED) sx[r][1][i] = a - b;
    }
    for (int e = threadIdx.x; e < DJ * DI; e += THREADS) {
      const int jl = e / DI, i = e % DI;
      const int jj = j0 + jl, ii = i0 + i;
      ps[i][jl] = (jj < J && ii < ig) ? table_value(pnm[(size_t)jj * ig + ii])
                                      : T(0);
    }
    __syncthreads();
    T part[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) part[r] = T(0);
#pragma unroll 4
    for (int i = 0; i < DI; ++i) {
      const T p = ps[i][tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        part[r] = fma(sx[ty + NY * r][par][i], p, part[r]);
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) add_compensated(acc[r], accc[r], part[r]);
    __syncthreads();
  }

  if (j >= J) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = r0 + ty + NY * r;
    if (row < fc2) out[((size_t)m * fc2 + row) * J + j] = acc[r] + accc[r];
  }
}

template <typename T, typename P, bool STACKED>
int launch_inv(const void* d2, const void* pn, void* north, void* south,
               int gm, int fc2, int J, int ig, void* stream) {
  dim3 grid((fc2 + ROWS - 1) / ROWS, (ig + TI - 1) / TI, gm);
  inv_dense_kernel<T, P, STACKED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)d2, (const P*)pn, (T*)north, (T*)south, fc2, J, ig);
  return (int)cudaGetLastError();
}

template <typename T, typename P, bool STACKED>
int launch_dir(const void* fn, const void* fs, const void* pn, void* out,
               int gm, int fc2, int J, int ig, void* stream) {
  dim3 grid((fc2 + ROWS - 1) / ROWS, (J + DJ - 1) / DJ, gm);
  dir_dense_kernel<T, P, STACKED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)fn, (const T*)fs, (const P*)pn, (T*)out, fc2, J, ig);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries per variant: _f32 and _f64 (the working type throughout) and
// _bf16 (fp32 operands and outputs, bf16 table); K7 and K8 only _f64 here
#define ECT_DENSE_ENTRIES(SUFFIX, T, P)                                       \
  int ect_inv_dense##SUFFIX(const void* d2, const void* pn, void* north,      \
                            void* south, int gm, int fc2, int J, int ig,      \
                            void* stream) {                                   \
    return launch_inv<T, P, false>(d2, pn, north, south, gm, fc2, J, ig,      \
                                   stream);                                   \
  }                                                                           \
  int ect_dir_dense##SUFFIX(const void* fn, const void* fs, const void* pn,   \
                            void* out, int gm, int fc2, int J, int ig,        \
                            void* stream) {                                   \
    return launch_dir<T, P, false>(fn, fs, pn, out, gm, fc2, J, ig, stream);  \
  }

extern "C" {
ECT_DENSE_ENTRIES(_f32, float, float)
ECT_DENSE_ENTRIES(_f64, double, double)
ECT_DENSE_ENTRIES(_bf16, float, bf16)
int ect_inv_dense2_f64(const void* d4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return launch_inv<double, double, true>(d4, pn, out, nullptr, gm, fc4, J,
                                          ig, stream);
}
int ect_dir_dense2_f64(const void* f4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return launch_dir<double, double, true>(f4, nullptr, pn, out, gm, fc4, J,
                                          ig, stream);
}
}  // extern "C"
