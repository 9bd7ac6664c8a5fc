// Parity-split grouped Legendre transforms for Hopper (sm_90a): kernels K5
// and K6 (the "pallas" engine).
//
// K5 replaces ectrans_tpu/ops/legendre_pallas.py group_inv (_inv_kernel);
// K6 replaces group_dir (_dir_kernel).  Both contract one m-group of parity
// coefficients against the symmetric and antisymmetric tables of that group,
// psym[m, i, k] = Pbar_{m+2k}^m(mu_i) and pasym[m, i, k] = Pbar_{m+2k+1}^m(mu_i),
// each (gm, ig, kg) with k contiguous:
//   K5: fs = sym . psym^T, fa = asym . pasym^T; north = fs + fa, south = fs - fa
//       (south NOT latitude-reversed);
//   K6: sym = fsym . psym, asym = fasym . pasym (quadrature already applied).
//
// What bounds them: as K1/K2 (legendre_dense.cu), each table element is read
// once per transform and feeds fc2 fused multiply-adds (fc2 = 2 * fields,
// 20-32 on the benchmark path), close to the H100's fp32 CUDA-core ridge.
// The design reads both tables exactly once per row chunk through shared
// memory, loaded along k (the tables' contiguous axis, 128 bytes per row and
// stage), keeps the coefficient tile in shared memory and the sums in
// registers.  K5's table tile is stored [latitude][k] with a +1 pad so a
// warp reading one k for 32 latitudes hits 32 banks; K6's is [latitude][k],
// read along k by consecutive threads.  Arithmetic is plain FMA in the
// working type (no tensor cores: the "highest" tier's accuracy contract).
// Each staged chunk is summed in registers and folded into a compensated
// total (TwoSum), so the rounding error grows with the chunk length and not
// with kg or ig: one running fp32 sum misses the TCO1279 100*eps round-trip
// gate (see legendre_dense.cu).  Pipelining and tensor-core variants are
// left for later work.

#include <cuda_runtime.h>

namespace {

constexpr int NY = 4;              // thread rows of a block
constexpr int RPT = 8;             // coefficient rows per thread
constexpr int ROWS = NY * RPT;     // rows per block; gridDim.z walks fc2
constexpr int TI = 64;             // K5: latitudes per block (threads in x)
constexpr int DK = 64;             // K6: parity degrees per block (threads in x)
constexpr int THREADS = 256;       // = TI * NY = DK * NY

// 128 bytes of one table row per stage: 32 floats or 16 doubles
template <typename T>
struct Stage {
  static constexpr int K = 128 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void add_compensated(T& sum, T& comp, T x) {
  const T s = sum + x;
  const T bb = s - sum;
  comp += (sum - (s - bb)) + (x - bb);
  sum = s;
}

// north[m, r, i] = sum_k sym[m, r, k] psym[m, i, k] + asym[m, r, k] pasym[m, i, k]
// south[m, r, i] = sum_k sym[m, r, k] psym[m, i, k] - asym[m, r, k] pasym[m, i, k]
// Block (i-tile, m, row chunk); thread (tx = latitude, ty = row phase).
template <typename T>
__global__ void __launch_bounds__(THREADS)
inv_grouped_kernel(const T* __restrict__ sym, const T* __restrict__ asym,
                   const T* __restrict__ psym, const T* __restrict__ pasym,
                   T* __restrict__ north, T* __restrict__ south,
                   int fc2, int kg, int ig) {
  constexpr int TK = Stage<T>::K;
  __shared__ T ss[ROWS][TK];
  __shared__ T sa[ROWS][TK];
  __shared__ T ps[TI][TK + 1];
  __shared__ T pa[TI][TK + 1];
  const int m = blockIdx.y;
  const int i0 = blockIdx.x * TI;
  const int r0 = blockIdx.z * ROWS;
  const int tx = threadIdx.x % TI;
  const int ty = threadIdx.x / TI;
  const T* sm = sym + (size_t)m * fc2 * kg;
  const T* am = asym + (size_t)m * fc2 * kg;
  const T* psm = psym + (size_t)m * ig * kg;
  const T* pam = pasym + (size_t)m * ig * kg;

  T fs[RPT], fa[RPT], fsc[RPT], fac[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    fs[r] = T(0); fa[r] = T(0); fsc[r] = T(0); fac[r] = T(0);
  }

  for (int k0 = 0; k0 < kg; k0 += TK) {
    for (int e = threadIdx.x; e < ROWS * TK; e += THREADS) {
      const int r = e / TK, k = e % TK;
      const int row = r0 + r, kk = k0 + k;
      const bool ok = row < fc2 && kk < kg;
      ss[r][k] = ok ? sm[(size_t)row * kg + kk] : T(0);
      sa[r][k] = ok ? am[(size_t)row * kg + kk] : T(0);
    }
    for (int e = threadIdx.x; e < TI * TK; e += THREADS) {
      const int i = e / TK, k = e % TK;   // consecutive threads along k
      const int ii = i0 + i, kk = k0 + k;
      const bool ok = ii < ig && kk < kg;
      ps[i][k] = ok ? psm[(size_t)ii * kg + kk] : T(0);
      pa[i][k] = ok ? pam[(size_t)ii * kg + kk] : T(0);
    }
    __syncthreads();
    T s_part[RPT], a_part[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { s_part[r] = T(0); a_part[r] = T(0); }
#pragma unroll 4
    for (int k = 0; k < TK; ++k) {
      const T p = ps[tx][k];
      const T q = pa[tx][k];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        s_part[r] = fma(ss[ty + NY * r][k], p, s_part[r]);
        a_part[r] = fma(sa[ty + NY * r][k], q, a_part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      add_compensated(fs[r], fsc[r], s_part[r]);
      add_compensated(fa[r], fac[r], a_part[r]);
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
      const T s = fs[r] + fsc[r], a = fa[r] + fac[r];
      north[o] = s + a;
      south[o] = s - a;
    }
  }
}

// sym[m, r, k] = sum_i fsym[m, r, i] psym[m, i, k]
// asym[m, r, k] = sum_i fasym[m, r, i] pasym[m, i, k]
// Block (k-tile, m, row chunk); thread (tx = degree, ty = row phase).
template <typename T>
__global__ void __launch_bounds__(THREADS)
dir_grouped_kernel(const T* __restrict__ fsym, const T* __restrict__ fasym,
                   const T* __restrict__ psym, const T* __restrict__ pasym,
                   T* __restrict__ sym, T* __restrict__ asym,
                   int fc2, int kg, int ig) {
  constexpr int DI = Stage<T>::K;      // latitudes per stage: 32 or 16
  __shared__ T sx[ROWS][DI];
  __shared__ T ax[ROWS][DI];
  __shared__ T ps[DI][DK];
  __shared__ T pa[DI][DK];
  const int m = blockIdx.y;
  const int k0 = blockIdx.x * DK;
  const int r0 = blockIdx.z * ROWS;
  const int tx = threadIdx.x % DK;
  const int ty = threadIdx.x / DK;
  const int k = k0 + tx;
  const T* fsm = fsym + (size_t)m * fc2 * ig;
  const T* fam = fasym + (size_t)m * fc2 * ig;
  const T* psm = psym + (size_t)m * ig * kg;
  const T* pam = pasym + (size_t)m * ig * kg;

  T s_acc[RPT], a_acc[RPT], s_c[RPT], a_c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    s_acc[r] = T(0); a_acc[r] = T(0); s_c[r] = T(0); a_c[r] = T(0);
  }

  for (int i0 = 0; i0 < ig; i0 += DI) {
    for (int e = threadIdx.x; e < ROWS * DI; e += THREADS) {
      const int r = e / DI, i = e % DI;
      const int row = r0 + r, ii = i0 + i;
      const bool ok = row < fc2 && ii < ig;
      sx[r][i] = ok ? fsm[(size_t)row * ig + ii] : T(0);
      ax[r][i] = ok ? fam[(size_t)row * ig + ii] : T(0);
    }
    for (int e = threadIdx.x; e < DI * DK; e += THREADS) {
      const int i = e / DK, kl = e % DK;  // consecutive threads along k
      const int ii = i0 + i, kk = k0 + kl;
      const bool ok = ii < ig && kk < kg;
      ps[i][kl] = ok ? psm[(size_t)ii * kg + kk] : T(0);
      pa[i][kl] = ok ? pam[(size_t)ii * kg + kk] : T(0);
    }
    __syncthreads();
    T s_part[RPT], a_part[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { s_part[r] = T(0); a_part[r] = T(0); }
#pragma unroll 4
    for (int i = 0; i < DI; ++i) {
      const T p = ps[i][tx];
      const T q = pa[i][tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        s_part[r] = fma(sx[ty + NY * r][i], p, s_part[r]);
        a_part[r] = fma(ax[ty + NY * r][i], q, a_part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      add_compensated(s_acc[r], s_c[r], s_part[r]);
      add_compensated(a_acc[r], a_c[r], a_part[r]);
    }
    __syncthreads();
  }

  if (k >= kg) return;
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    const int row = r0 + ty + NY * r;
    if (row < fc2) {
      const size_t o = ((size_t)m * fc2 + row) * kg + k;
      sym[o] = s_acc[r] + s_c[r];
      asym[o] = a_acc[r] + a_c[r];
    }
  }
}

template <typename T>
int launch_inv(const void* sym, const void* asym, const void* psym,
               const void* pasym, void* north, void* south, int gm, int fc2,
               int kg, int ig, void* stream) {
  dim3 grid((ig + TI - 1) / TI, gm, (fc2 + ROWS - 1) / ROWS);
  inv_grouped_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)sym, (const T*)asym, (const T*)psym, (const T*)pasym,
      (T*)north, (T*)south, fc2, kg, ig);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dir(const void* fsym, const void* fasym, const void* psym,
               const void* pasym, void* sym, void* asym, int gm, int fc2,
               int kg, int ig, void* stream) {
  dim3 grid((kg + DK - 1) / DK, gm, (fc2 + ROWS - 1) / ROWS);
  dir_grouped_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)fsym, (const T*)fasym, (const T*)psym, (const T*)pasym,
      (T*)sym, (T*)asym, fc2, kg, ig);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ect_inv_grouped_f32(const void* sym, const void* asym, const void* psym,
                        const void* pasym, void* north, void* south, int gm,
                        int fc2, int kg, int ig, void* stream) {
  return launch_inv<float>(sym, asym, psym, pasym, north, south, gm, fc2, kg,
                           ig, stream);
}

int ect_inv_grouped_f64(const void* sym, const void* asym, const void* psym,
                        const void* pasym, void* north, void* south, int gm,
                        int fc2, int kg, int ig, void* stream) {
  return launch_inv<double>(sym, asym, psym, pasym, north, south, gm, fc2, kg,
                            ig, stream);
}

int ect_dir_grouped_f32(const void* fsym, const void* fasym, const void* psym,
                        const void* pasym, void* sym, void* asym, int gm,
                        int fc2, int kg, int ig, void* stream) {
  return launch_dir<float>(fsym, fasym, psym, pasym, sym, asym, gm, fc2, kg,
                           ig, stream);
}

int ect_dir_grouped_f64(const void* fsym, const void* fasym, const void* psym,
                        const void* pasym, void* sym, void* asym, int gm,
                        int fc2, int kg, int ig, void* stream) {
  return launch_dir<double>(fsym, fasym, psym, pasym, sym, asym, gm, fc2, kg,
                            ig, stream);
}

}  // extern "C"
