// bf16 limb-plane Legendre transforms for Hopper (sm_90a): kernels K9 and
// K10 (the "planes" engine).
//
// K9 replaces ectrans_tpu/ops/legendre_planes.py group_inv_planes
// (_inv_kernel); K10 replaces group_dir_planes (_dir_kernel).  The table of
// one m-group is stored as P bf16 limb planes (P = 3 for the fp32-accurate
// tiers, 1 for the "bf16" tier) in the transposed layout plane_k[m, i, j]
// = limb k of Pbar_{m+j}^m(mu_i), each (gm, ig, J) with j contiguous.  The
// operands come split into limbs the same way:
//   K9:  a = packed rows [x_0; x_0 sgn; x_1; x_1 sgn; ...] (gm, 2 P fc2, J)
//        north[r, i] = sum_j x[r, j] p[i, j]
//        south[r, i] = sum_j (-1)^j x[r, j] p[i, j]
//   K10: w = packed rows [gn_0; gs_0; gn_1; gs_1; ...] (gm, 2 P fc2, ig)
//        out[r, j] = sum_i (gn + (-1)^j gs)[r, i] p[i, j]
// with x = sum_l x_l, p = sum_k p_k, gn = sum_l gn_l, gs = sum_l gs_l.
//
// Arithmetic: the limbs of a value are summed in fp32 as they are staged,
// then each term is one fp32 FMA.  Three limbs are an exact split of an
// fp32 value (two 8-bit truncations and a remainder of at most 8 bits), so
// the sums are exact and at P = 3 each term is the fp32 product itself; at
// P = 1 it is the product of the two bf16 values, also exact.  The TPU
// kernel instead keeps the limb products with l + k < P, one bf16 MXU pass
// each, and drops the others (2^-24 of the product): kept term by term on
// an H100, that put the TCO1279 round trip at 1.017 of its 100*eps gate,
// while summing the limbs first computes every product and costs one FMA
// per term instead of six.  K9 takes south from the parity of j, as K1
// does (north = E + O, south = E - O over even and odd j), so it reads
// only the x_l rows of its operand: the sign rows hold x_l (-1)^j exactly.
// K10 pre-combines gn +- gs in fp32, as K2 does, so each output column
// takes one sum.  As in K1/K2, each staged chunk is summed in registers and
// folded into a compensated total (TwoSum).
//
// What bounds them: the FMAs are K1's and K2's, one per (row, degree,
// latitude), on 2P bytes of table per element instead of 4, so they sit
// at the fp32 CUDA-core ridge like K1/K2 (P = 3 reads 1.5x their table
// bytes, P = 1 half).  The design reads each plane once per row chunk
// through shared memory, coalesced along j, and keeps the summed operand
// tile in shared memory and the sums in registers; tensor-core (bf16
// mma/wgmma) versions are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NY = 4;              // thread rows of a block
constexpr int RPT = 8;             // output rows per thread
constexpr int ROWS = NY * RPT;     // rows per block; gridDim.z walks fc2
constexpr int TI = 64;             // K9: latitudes per block (threads in x)
constexpr int TJ = 32;             // K9: degrees staged per step (even)
constexpr int DJ = 64;             // K10: degrees per block (threads in x)
constexpr int DI = 32;             // K10: latitudes staged per step
constexpr int THREADS = 256;       // = TI * NY = DJ * NY
constexpr int PMAX = 3;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void add_compensated(float& sum, float& comp,
                                                float x) {
  const float s = sum + x;
  const float bb = s - sum;
  comp += (sum - (s - bb)) + (x - bb);
  sum = s;
}

// Block (i-tile, m, row chunk); thread (tx = latitude, ty = row phase).
template <int P>
__global__ void __launch_bounds__(THREADS)
inv_planes_kernel(const bf16* __restrict__ a, const bf16* __restrict__ p0,
                  const bf16* __restrict__ p1, const bf16* __restrict__ p2,
                  float* __restrict__ north, float* __restrict__ south,
                  int fc2, int J, int ig) {
  __shared__ float xs[ROWS][TJ];       // x = sum_l x_l
  __shared__ float pt[TI][TJ + 1];     // p = sum_k p_k, padded
  const bf16* planes[PMAX] = {p0, p1, p2};
  const int m = blockIdx.y;
  const int i0 = blockIdx.x * TI;
  const int r0 = blockIdx.z * ROWS;
  const int tx = threadIdx.x % TI;
  const int ty = threadIdx.x / TI;
  const bf16* am = a + (size_t)m * (2 * P * fc2) * J;

  float ev[RPT], od[RPT], evc[RPT], odc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    ev[r] = 0.f; od[r] = 0.f; evc[r] = 0.f; odc[r] = 0.f;
  }

  for (int j0 = 0; j0 < J; j0 += TJ) {
    for (int e = threadIdx.x; e < ROWS * TJ; e += THREADS) {
      const int r = e / TJ, j = e % TJ;
      const int row = r0 + r, jj = j0 + j;
      float x = 0.f;
      if (row < fc2 && jj < J) {
        // limb l's rows start at 2 l fc2; the sign rows are not read
#pragma unroll
        for (int l = 0; l < P; ++l)
          x += __bfloat162float(am[(size_t)(2 * l * fc2 + row) * J + jj]);
      }
      xs[r][j] = x;
    }
    for (int e = threadIdx.x; e < TI * TJ; e += THREADS) {
      const int i = e / TJ, j = e % TJ;   // consecutive threads along j
      const int ii = i0 + i, jj = j0 + j;
      float p = 0.f;
      if (ii < ig && jj < J) {
        const size_t o = ((size_t)m * ig + ii) * J + jj;
#pragma unroll
        for (int k = 0; k < P; ++k) p += __bfloat162float(planes[k][o]);
      }
      pt[i][j] = p;
    }
    __syncthreads();
    float e_part[RPT], o_part[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { e_part[r] = 0.f; o_part[r] = 0.f; }
#pragma unroll 4
    for (int j = 0; j < TJ; j += 2) {   // j0 is even: local parity = global
      const float pe = pt[tx][j];
      const float po = pt[tx][j + 1];
#pragma unroll
      for (int r = 0; r < RPT; ++r) {
        e_part[r] = fmaf(xs[ty + NY * r][j], pe, e_part[r]);
        o_part[r] = fmaf(xs[ty + NY * r][j + 1], po, o_part[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      add_compensated(ev[r], evc[r], e_part[r]);
      add_compensated(od[r], odc[r], o_part[r]);
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
      const float e = ev[r] + evc[r], d = od[r] + odc[r];
      north[o] = e + d;
      south[o] = e - d;
    }
  }
}

// Block (j-tile, m, row chunk); thread (tx = degree, ty = row phase).
template <int P>
__global__ void __launch_bounds__(THREADS)
dir_planes_kernel(const bf16* __restrict__ w, const bf16* __restrict__ p0,
                  const bf16* __restrict__ p1, const bf16* __restrict__ p2,
                  float* __restrict__ out, int fc2, int J, int ig) {
  // sx[r][0][i] = gn + gs, sx[r][1][i] = gn - gs; the +1 pad puts the
  // halves read by one warp (even and odd j) in different banks
  __shared__ float sx[ROWS][2][DI + 1];
  __shared__ float pt[DI][DJ];         // p = sum_k p_k
  const bf16* planes[PMAX] = {p0, p1, p2};
  const int m = blockIdx.y;
  const int j0 = blockIdx.x * DJ;
  const int r0 = blockIdx.z * ROWS;
  const int tx = threadIdx.x % DJ;
  const int ty = threadIdx.x / DJ;
  const int j = j0 + tx;
  const int par = j & 1;
  const bf16* wm = w + (size_t)m * (2 * P * fc2) * ig;

  float acc[RPT], accc[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) { acc[r] = 0.f; accc[r] = 0.f; }

  for (int i0 = 0; i0 < ig; i0 += DI) {
    for (int e = threadIdx.x; e < ROWS * DI; e += THREADS) {
      const int r = e / DI, i = e % DI;
      const int row = r0 + r, ii = i0 + i;
      float gn = 0.f, gs = 0.f;
      if (row < fc2 && ii < ig) {
#pragma unroll
        for (int l = 0; l < P; ++l) {
          gn += __bfloat162float(wm[(size_t)(2 * l * fc2 + row) * ig + ii]);
          gs += __bfloat162float(
              wm[(size_t)((2 * l + 1) * fc2 + row) * ig + ii]);
        }
      }
      sx[r][0][i] = gn + gs;
      sx[r][1][i] = gn - gs;
    }
    for (int e = threadIdx.x; e < DI * DJ; e += THREADS) {
      const int i = e / DJ, jl = e % DJ;  // consecutive threads along j
      const int ii = i0 + i, jj = j0 + jl;
      float p = 0.f;
      if (ii < ig && jj < J) {
        const size_t o = ((size_t)m * ig + ii) * J + jj;
#pragma unroll
        for (int k = 0; k < P; ++k) p += __bfloat162float(planes[k][o]);
      }
      pt[i][jl] = p;
    }
    __syncthreads();
    float part[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) part[r] = 0.f;
#pragma unroll 4
    for (int i = 0; i < DI; ++i) {
      const float p = pt[i][tx];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        part[r] = fmaf(sx[ty + NY * r][par][i], p, part[r]);
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

template <int P>
int launch_inv(const void* a, const void* p0, const void* p1, const void* p2,
               void* north, void* south, int gm, int fc2, int J, int ig,
               void* stream) {
  dim3 grid((ig + TI - 1) / TI, gm, (fc2 + ROWS - 1) / ROWS);
  inv_planes_kernel<P><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)a, (const bf16*)p0, (const bf16*)p1, (const bf16*)p2,
      (float*)north, (float*)south, fc2, J, ig);
  return (int)cudaGetLastError();
}

template <int P>
int launch_dir(const void* w, const void* p0, const void* p1, const void* p2,
               void* out, int gm, int fc2, int J, int ig, void* stream) {
  dim3 grid((J + DJ - 1) / DJ, gm, (fc2 + ROWS - 1) / ROWS);
  dir_planes_kernel<P><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)w, (const bf16*)p0, (const bf16*)p1, (const bf16*)p2,
      (float*)out, fc2, J, ig);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// nplanes 1 or 3; the plane pointers past nplanes are not read
int ect_inv_planes(const void* a, const void* p0, const void* p1,
                   const void* p2, void* north, void* south, int nplanes,
                   int gm, int fc2, int J, int ig, void* stream) {
  if (nplanes == 3)
    return launch_inv<3>(a, p0, p1, p2, north, south, gm, fc2, J, ig, stream);
  if (nplanes == 1)
    return launch_inv<1>(a, p0, p1, p2, north, south, gm, fc2, J, ig, stream);
  return (int)cudaErrorInvalidValue;
}

int ect_dir_planes(const void* w, const void* p0, const void* p1,
                   const void* p2, void* out, int nplanes, int gm, int fc2,
                   int J, int ig, void* stream) {
  if (nplanes == 3)
    return launch_dir<3>(w, p0, p1, p2, out, gm, fc2, J, ig, stream);
  if (nplanes == 1)
    return launch_dir<1>(w, p0, p1, p2, out, gm, fc2, J, ig, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
