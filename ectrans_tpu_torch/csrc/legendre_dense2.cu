// K7 for Hopper (sm_90a): the hemisphere-packed inverse Legendre transform,
// fp32 and on bf16 tables.
//
// Replaces ectrans_tpu/ops/legendre_pallas.py group_inv_dense2
// (_inv_dense2_kernel).  One m-group's general product
//   out[m, r, i] = sum_j d4[m, r, j] pn[m, j, i],
// d4 (gm, fc4, J), pn (gm, J, ig), out (gm, fc4, ig), each contiguous; the
// dense engine stacks d4 = [d2 ; d2 sgn], but the kernel does not rely on it.
//
// Bound: 2 fc4 J ig FLOP per group against 4 (J ig + fc4 J + fc4 ig) bytes.
// At TCO1279 (fc4 = 64, sum over the 16 groups of gm J ig = 926,445,600)
// that is 1.186e11 FLOP, 1.77 ms at the data sheet's 67 TFLOP/s of fp32 FMA,
// against 4.24 GB, 1.26 ms at 3.35 TB/s: compute-bound, on CUDA cores (fp32
// FMA is the "highest" tier's accuracy contract).
//
// Design, against what held back the first K7 (K1's template: one latitude
// x 8 rows a thread, one shared load per FMA, the table tile read by two
// 32-row blocks, no overlap of loads and FMAs):
// - a block covers 64 rows x 64 latitudes with 128 threads, so each table
//   tile is read from device memory once (fc4 > 64 puts further 64-row
//   chunks on grid x, next to each other, so they share the tile in L2);
// - each thread holds a register tile of 4 rows x 8 latitudes (two runs of
//   4, 32 apart).  A degree pair costs 4 8-byte loads of the degree chunk
//   and 4 16-byte loads of the table tile for 64 FMAs.  A warp spans 4 row
//   quads x 8 latitude quads, so each table load reads 128 contiguous bytes
//   and each chunk load 4 rows 136 bytes apart: no bank conflicts;
// - a double-buffered ring (2 stages of TJ = 32 degrees: the table tile
//   ps[j][i] and the degree chunk ds[r][j], rows padded to 34 floats) in
//   dynamic shared memory, the next stage filled with cp.async while this
//   one is computed: one __syncthreads a stage;
// - compensated chunk sums, as in every Legendre kernel of the port
//   (legendre_common.cuh): each output sums FOLD = 16 degrees in a register,
//   adds 4 such partials in plain fp32, and folds that into a TwoSum total
//   every 64 degrees.  The error grows with the chain length, so the chains
//   stay as short as K1's; the plain adds of 4 partials cost one rounding
//   each at the partials' scale, and spare 3 of every 4 folds (7 adds an
//   output).  tests/test_torch_k7_sums.py emulates this order and K1's in
//   fp32 and holds K7's error within 1.5x K1's.  One running fp32 sum, or
//   torch.bmm, misses the 100*eps round-trip gate at TCO1279 by 3.3-4.2x
//   (PERF.md).  The totals (sum and compensation, 64 floats an output tile)
//   live in shared memory, the thread's own float4s, touched once a fold:
//   with them in registers the tile spilled at three blocks an SM.
//
// Unaligned rows.  pn rows are ig floats long, and ig % 4 == 0 holds in only
// 4 of the 16 TCO1279 groups; d4 rows are J floats long, J % 4 == 2.  So the
// table tile is copied with 16-byte cp.async when ig % 4 == 0 (and the table
// is 16-byte aligned), with 8-byte copies when ig is even, and with 4-byte
// copies otherwise; the degree chunk with 8-byte copies when J is even (and
// d4 8-byte aligned), else 4-byte ones; both chosen per launch.  Stages
// that reach past fc4, J or ig test each copy and zero-fill what lies
// outside; the others copy untested (the copies: cp_async.cuh, shared with
// K8).  The chunk loop reads nothing past the group's table.  TMA is out: it
// needs 16-byte global strides.  A bf16 table's rows start at 2-byte
// boundaries when ig is odd, and its operand must be rounded to bf16 while
// staged, so the bf16 variant stages both tiles through registers (load,
// convert, store) into the same ring.
//
// Launch shape: 128 threads; shared memory 2 stages x 16,896 bytes + 32,768
// bytes of totals = 66,560 bytes; __launch_bounds__(128, 3): three blocks
// (12 warps) an SM; 168 registers (fp32) and 148 (bf16), no spill (nvcc
// -Xptxas -v, in _build/build.log).  A launch has gm ceil(ig / 64)
// ceil(fc4 / 64) blocks: 640-1,600 at TCO1279, 1.6-4.0 waves of 396.
// The fp64 variant (not on the benchmark path) stays on K1's template in
// legendre_dense.cu.

#include "cp_async.cuh"
#include "legendre_common.cuh"

namespace k7 {

using ect::add_compensated;
using ect::bf16;
using ect::copy_tile;
using ect::copy_vec;
using ect::cp_async_commit;
using ect::cp_async_wait;
using ect::operand;

constexpr int BM = 64;        // rows per block
constexpr int TI = 64;        // latitudes per block
constexpr int RT = 4;         // rows per thread
constexpr int LT = 8;         // latitudes per thread, two runs of 4
constexpr int THREADS = (BM / RT) * (TI / LT);   // 128
constexpr int LRUN = TI / (LT / 4);   // a thread's runs of 4 latitudes apart
constexpr int MINB = 3;       // blocks an SM
constexpr int TJ = 32;        // degrees per stage
constexpr int STAGES = 2;
constexpr int FOLD = 16;      // degrees per chunk partial
constexpr int NCH = 4;        // chunk partials per compensated fold
constexpr int FOLD_STAGES = NCH * FOLD / TJ;
constexpr int DR = TJ + 2;    // floats per ds row
constexpr int PS = TJ * TI;   // table floats per stage
constexpr int STAGE = PS + BM * DR;              // floats per stage
constexpr int NQ = RT * LT / 4;                  // float4s of a thread's tile
constexpr int SMEM = (STAGES * STAGE + 2 * THREADS * RT * LT) * 4;  // bytes
static_assert(THREADS % TJ == 0 && (TJ * TI) % (4 * THREADS) == 0, "");
static_assert(TJ % FOLD == 0 && FOLD % 2 == 0 && FOLD_STAGES >= 1, "");

// one stage, degrees j0 .. j0 + TJ - 1: the degree chunk ds[r][j] =
// d4[row0 + r, j0 + j] (8-byte copies where d4's rows allow, dvec = 2) and
// the table tile ps[j][i] = pn[j0 + j, i0 + i] (16-, 8- or 4-byte copies,
// vec = 4, 2, 1); the bf16-table variant rounds the degree chunk to bf16 and
// widens the table, through registers
template <typename P, bool FULL>
__device__ __forceinline__ void fill_tiles(float* st, const float* d4m,
                                           const P* pnm, int row0, int fc4,
                                           int i0, int j0, int J, int ig,
                                           int dvec, int vec) {
  float* ps = st;
  float* ds = st + PS;
  const float* dsrc = d4m + (size_t)row0 * J + j0;
  const P* psrc = pnm + (size_t)j0 * ig + i0;
  const int nrow = fc4 - row0, ndeg = J - j0, nlat = ig - i0;
  const int t = threadIdx.x;
  if constexpr (!std::is_same<P, float>::value) {
    auto rnd = [](float x) { return operand<float, P>(x); };
    auto wide = [](P x) { return __bfloat162float(x); };
    copy_tile<THREADS, float, 1, BM, TJ, FULL, true>(ds, DR, dsrc, J, nrow,
                                                     ndeg, d4m, rnd, t);
    copy_tile<THREADS, P, 1, TJ, TI, FULL, true>(ps, TI, psrc, ig, ndeg, nlat,
                                                 pnm, wide, t);
  } else {
    auto same = [](float x) { return x; };
    if (dvec == 2) {
      copy_tile<THREADS, float, 2, BM, TJ, FULL, false>(ds, DR, dsrc, J, nrow,
                                                        ndeg, d4m, same, t);
    } else {
      copy_tile<THREADS, float, 1, BM, TJ, FULL, false>(ds, DR, dsrc, J, nrow,
                                                        ndeg, d4m, same, t);
    }
    if (vec == 4) {
      copy_tile<THREADS, float, 4, TJ, TI, FULL, false>(ps, TI, psrc, ig, ndeg,
                                                        nlat, pnm, same, t);
    } else if (vec == 2) {
      copy_tile<THREADS, float, 2, TJ, TI, FULL, false>(ps, TI, psrc, ig, ndeg,
                                                        nlat, pnm, same, t);
    } else {
      copy_tile<THREADS, float, 1, TJ, TI, FULL, false>(ps, TI, psrc, ig, ndeg,
                                                        nlat, pnm, same, t);
    }
  }
}

template <typename P>
__device__ __forceinline__ void fill_stage(float* st, const float* d4m,
                                           const P* pnm, int row0, int fc4,
                                           int i0, int j0, int J, int ig,
                                           int dvec, int vec) {
  if (row0 + BM <= fc4 && j0 + TJ <= J && i0 + TI <= ig) {
    fill_tiles<P, true>(st, d4m, pnm, row0, fc4, i0, j0, J, ig, dvec, vec);
  } else {
    fill_tiles<P, false>(st, d4m, pnm, row0, fc4, i0, j0, J, ig, dvec, vec);
  }
}

// out[m, r, i] = sum_j d4[m, r, j] pn[m, j, i]; block (row chunk, latitude
// tile, m); thread (ty: rows 4 ty .. 4 ty + 3; tx: latitudes 4 tx ..
// 4 tx + 3 and TI/2 + 4 tx .. TI/2 + 4 tx + 3)
template <typename P>
__global__ void __launch_bounds__(THREADS, MINB)
inv_dense2_kernel(const float* __restrict__ d4, const P* __restrict__ pn,
                  float* __restrict__ out, int fc4, int J, int ig, int dvec,
                  int vec) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * BM;
  const int i0 = blockIdx.y * TI;
  const int m = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ty = warp * 4 + lane / 8;
  const int tx = lane % 8;
  const float* d4m = d4 + (size_t)m * fc4 * J;
  const P* pnm = pn + (size_t)m * J * ig;

  // the compensated totals (sum, compensation) live in shared memory, the
  // thread's own float4s, the q-th of each at ts[q * THREADS] and
  // cs[q * THREADS], touched once a fold; held collects NCH chunk
  // partials, FOLD_STAGES stages, between folds
  float held[RT][LT];
  float4* ts = reinterpret_cast<float4*>(smem + STAGES * STAGE) + threadIdx.x;
  float4* cs = ts + NQ * THREADS;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int l = 0; l < LT; ++l) held[r][l] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    ts[q * THREADS] = make_float4(0, 0, 0, 0);
    cs[q * THREADS] = make_float4(0, 0, 0, 0);
  }
  auto fold_held = [&]() {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const float4 t4 = ts[q * THREADS], c4 = cs[q * THREADS];
      float tv[4] = {t4.x, t4.y, t4.z, t4.w};
      float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (4 * q + e) / LT, l = (4 * q + e) % LT;
        add_compensated(tv[e], cv[e], held[r][l]);
        held[r][l] = 0.f;
      }
      ts[q * THREADS] = make_float4(tv[0], tv[1], tv[2], tv[3]);
      cs[q * THREADS] = make_float4(cv[0], cv[1], cv[2], cv[3]);
    }
  };

  const int nstage = (J + TJ - 1) / TJ;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstage) {
      fill_stage<P>(smem + s * STAGE, d4m, pnm, row0, fc4, i0, s * TJ, J, ig,
                    dvec, vec);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nstage; ++c) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage c landed
    __syncthreads();               // everyone's; and stage c - 1 is free
    if (c + STAGES - 1 < nstage) {
      fill_stage<P>(smem + (c + STAGES - 1) % STAGES * STAGE, d4m, pnm, row0,
                    fc4, i0, (c + STAGES - 1) * TJ, J, ig, dvec, vec);
    }
    cp_async_commit();

    const float* ps = smem + c % STAGES * STAGE + 4 * tx;
    const float* ds = smem + c % STAGES * STAGE + PS + 4 * ty * DR;
#pragma unroll
    for (int h = 0; h < TJ; h += FOLD) {
      // the chunk partial over degrees h .. h + FOLD - 1 of this stage
      float part[RT][LT];
#pragma unroll
      for (int q = 0; q < FOLD; q += 2) {
        float2 av[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          av[r] = *reinterpret_cast<const float2*>(ds + r * DR + h + q);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int j = h + q + u;
          float bv[LT];
#pragma unroll
          for (int k = 0; k < LT / 4; ++k) {
            const float4 b =
                *reinterpret_cast<const float4*>(ps + j * TI + k * LRUN);
            bv[4 * k] = b.x; bv[4 * k + 1] = b.y;
            bv[4 * k + 2] = b.z; bv[4 * k + 3] = b.w;
          }
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            const float a = u == 0 ? av[r].x : av[r].y;
#pragma unroll
            for (int l = 0; l < LT; ++l) {
              part[r][l] = q + u == 0 ? a * bv[l]
                                      : fmaf(a, bv[l], part[r][l]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int l = 0; l < LT; ++l) held[r][l] += part[r][l];
      }
    }
    if ((c + 1) % FOLD_STAGES == 0) fold_held();
  }
  if (nstage % FOLD_STAGES != 0) fold_held();
  cp_async_wait<0>();

#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 t4 = ts[q * THREADS], c4 = cs[q * THREADS];
    const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (4 * q + e) / LT, l = (4 * q + e) % LT;
      const int row = row0 + 4 * ty + r;
      const int i = l / 4 * LRUN + 4 * tx + l % 4;
      if (row < fc4 && i0 + i < ig) {
        out[((size_t)m * fc4 + row) * ig + i0 + i] = tv[e] + cv[e];
      }
    }
  }
}

inline dim3 grid_of(int gm, int fc4, int ig) {
  return dim3((fc4 + BM - 1) / BM, (ig + TI - 1) / TI, gm);
}

template <typename P>
int launch(const void* d4, const void* pn, void* out, int gm, int fc4, int J,
           int ig, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      inv_dense2_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  inv_dense2_kernel<P>
      <<<grid_of(gm, fc4, ig), THREADS, SMEM, (cudaStream_t)stream>>>(
          (const float*)d4, (const P*)pn, (float*)out, fc4, J, ig,
          copy_vec(d4, J, 2), copy_vec(pn, ig));
  return (int)cudaGetLastError();
}

template <typename P>
int shape(int gm, int fc4, int ig, int* info) {
  return ect::launch_shape(inv_dense2_kernel<P>, grid_of(gm, fc4, ig), THREADS,
                           SMEM, info);
}

}  // namespace k7

extern "C" {
int ect_inv_dense2_f32(const void* d4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return k7::launch<float>(d4, pn, out, gm, fc4, J, ig, stream);
}
int ect_inv_dense2_bf16(const void* d4, const void* pn, void* out, int gm,
                        int fc4, int J, int ig, void* stream) {
  return k7::launch<ect::bf16>(d4, pn, out, gm, fc4, J, ig, stream);
}
int ect_inv_dense2_shape_f32(int gm, int fc4, int ig, int* info) {
  return k7::shape<float>(gm, fc4, ig, info);
}
int ect_inv_dense2_shape_bf16(int gm, int fc4, int ig, int* info) {
  return k7::shape<ect::bf16>(gm, fc4, ig, info);
}
}  // extern "C"
