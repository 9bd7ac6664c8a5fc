// The fp64 dense-row Legendre transforms for Hopper (sm_90a): the fp64
// variants of kernels K1, K2, K7 and K8, off the benchmark path.
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
// The fp32 and bf16-table variants of all four are pipelined, register-tiled
// kernels of their own: K1 and K7 in legendre_dense2.cu, K2 and K8 in
// legendre_dense2_dir.cu.  This file keeps their first design, in fp64
// alone; fp64 K7 and K8 are K1 and K2 without the sign (STACKED).
//
// What bounds them: each table element is read once per transform and
// feeds fc2 fused multiply-adds; in fp64 the card's 34 TFLOP/s of fp64 FMA
// and 8-byte table entries.  The design (a) reads the table exactly once per
// row chunk, coalesced along latitude i, through shared memory, (b) keeps
// the small coefficient operand in shared memory and the sums in registers,
// and (c) halves the multiply-adds by splitting each sum over even and odd
// j: north = E + O, south = E - O (K1), and by pre-combining fn +- fs so
// each output column takes one sum (K2).  Row chunks are the fastest grid
// axis, so the chunks of one table tile run together and the second reads
// it from L2.  Each staged chunk (16-32 terms) is summed in registers and
// folded into a compensated total (legendre_common.cuh), so the rounding
// error grows with the chunk length and not with J or ig.

#include "legendre_common.cuh"

namespace {

using ect::add_compensated;

typedef double T;                  // operands, table, sums and outputs

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
template <bool STACKED>
__global__ void __launch_bounds__(THREADS)
inv_dense_kernel(const T* __restrict__ d2, const T* __restrict__ pn,
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
  const T* pnm = pn + (size_t)m * J * ig;

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
      ds[r][j] = (row < fc2 && jj < J) ? d2m[(size_t)row * J + jj] : T(0);
    }
    for (int e = threadIdx.x; e < TJ * TI; e += THREADS) {
      const int j = e / TI, i = e % TI;
      const int jj = j0 + j, ii = i0 + i;
      ps[j][i] = (jj < J && ii < ig) ? pnm[(size_t)jj * ig + ii] : T(0);
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
template <bool STACKED>
__global__ void __launch_bounds__(THREADS)
dir_dense_kernel(const T* __restrict__ fn, const T* __restrict__ fs,
                 const T* __restrict__ pn, T* __restrict__ out,
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
  const T* pnm = pn + (size_t)m * J * ig;

  T acc[RPT], accc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) { acc[r] = T(0); accc[r] = T(0); }

  for (int i0 = 0; i0 < ig; i0 += DI) {
    for (int e = threadIdx.x; e < ROWS * DI; e += THREADS) {
      const int r = e / DI, i = e % DI;
      const int row = r0 + r, ii = i0 + i;
      T a = T(0), b = T(0);
      if (row < fc2 && ii < ig) {
        a = fnm[(size_t)row * ig + ii];
        if (!STACKED) b = fsm[(size_t)row * ig + ii];
      }
      sx[r][0][i] = a + b;
      if (!STACKED) sx[r][1][i] = a - b;
    }
    for (int e = threadIdx.x; e < DJ * DI; e += THREADS) {
      const int jl = e / DI, i = e % DI;
      const int jj = j0 + jl, ii = i0 + i;
      ps[i][jl] = (jj < J && ii < ig) ? pnm[(size_t)jj * ig + ii] : T(0);
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

template <bool STACKED>
int launch_inv(const void* d2, const void* pn, void* north, void* south,
               int gm, int fc2, int J, int ig, void* stream) {
  dim3 grid((fc2 + ROWS - 1) / ROWS, (ig + TI - 1) / TI, gm);
  inv_dense_kernel<STACKED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)d2, (const T*)pn, (T*)north, (T*)south, fc2, J, ig);
  return (int)cudaGetLastError();
}

template <bool STACKED>
int launch_dir(const void* fn, const void* fs, const void* pn, void* out,
               int gm, int fc2, int J, int ig, void* stream) {
  dim3 grid((fc2 + ROWS - 1) / ROWS, (J + DJ - 1) / DJ, gm);
  dir_dense_kernel<STACKED><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)fn, (const T*)fs, (const T*)pn, (T*)out, fc2, J, ig);
  return (int)cudaGetLastError();
}

}  // namespace

// C entries: the fp64 variants of K1, K2, K7 and K8
extern "C" {
int ect_inv_dense_f64(const void* d2, const void* pn, void* north,
                      void* south, int gm, int fc2, int J, int ig,
                      void* stream) {
  return launch_inv<false>(d2, pn, north, south, gm, fc2, J, ig, stream);
}
int ect_dir_dense_f64(const void* fn, const void* fs, const void* pn,
                      void* out, int gm, int fc2, int J, int ig,
                      void* stream) {
  return launch_dir<false>(fn, fs, pn, out, gm, fc2, J, ig, stream);
}
int ect_inv_dense2_f64(const void* d4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return launch_inv<true>(d4, pn, out, nullptr, gm, fc4, J, ig, stream);
}
int ect_dir_dense2_f64(const void* f4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return launch_dir<true>(f4, nullptr, pn, out, gm, fc4, J, ig, stream);
}
}  // extern "C"
