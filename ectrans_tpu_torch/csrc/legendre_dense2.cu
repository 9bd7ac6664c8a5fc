// K7 and K1 for Hopper (sm_90a): the hemisphere-packed and the dense-row
// inverse Legendre transforms, fp32 and on bf16 tables, from one pipelined
// kernel body.
//
// K7 replaces ectrans_tpu/ops/legendre_pallas.py group_inv_dense2
// (_inv_dense2_kernel).  One m-group's general product
//   out[m, r, i] = sum_j d4[m, r, j] pn[m, j, i],
// d4 (gm, fc4, J), pn (gm, J, ig), out (gm, fc4, ig), each contiguous; the
// dense engine stacks d4 = [d2 ; d2 sgn], but the kernel does not rely on it.
//
// K1 replaces group_inv_dense (_inv_dense_kernel), the default "dense"
// engine's inverse: rows d2 (gm, fc2, J) and the same table give
//   north = sum_j d2_j P_j,  south = sum_j (-1)^j d2_j P_j  (gm, fc2, ig),
// the southern hemisphere from the parity identity Pbar_n^m(-mu) =
// (-1)^(n-m) Pbar_n^m(mu), south not latitude-reversed.  K1 sums the even
// and the odd degrees apart, E and O, and writes north = E + O and south =
// E - O: half K7's multiply-adds for the same table.
//
// Bounds.  K7: 2 fc4 J ig FLOP per group against 4 (J ig + fc4 J + fc4 ig)
// bytes.  At TCO1279 (fc4 = 64, sum over the 16 groups of gm J ig =
// 926,445,600) that is 1.186e11 FLOP, 1.77 ms at the data sheet's 67 TFLOP/s
// of fp32 FMA, against 4.24 GB, 1.26 ms at 3.35 TB/s: compute-bound, on CUDA
// cores (fp32 FMA is the "highest" tier's accuracy contract).  K1 (fc2 = 32)
// does 2 fc2 J ig = 5.93e10 FLOP, 0.885 ms, against 4.12 GB, 1.231 ms:
// bytes-bound, on the 3.71 GB of fp32 table that both stream.
//
// Design, against what held back the first K7 (K1's template: one latitude
// x 8 rows a thread, one shared load per FMA, the table tile read by two
// 32-row blocks, no overlap of loads and FMAs):
// - a block covers 64 rows x 64 latitudes with 128 threads, so each table
//   tile is read from device memory once (fc4 > 64 puts further 64-row
//   chunks on grid x, next to each other, so they share the tile in L2);
//   K1's block covers 32 coefficient rows x {even, odd} degrees: warps 0-1
//   sum the even degrees of the 32 rows, warps 2-3 the odd ones (fc2 > 32:
//   further 32-row chunks on grid x);
// - each thread holds a register tile of 4 rows x 8 latitudes (two runs of
//   4, 32 apart).  A K7 degree pair costs 4 8-byte loads of the degree chunk
//   and 4 16-byte loads of the table tile for 64 FMAs; a K1 degree of the
//   thread's parity 4 4-byte and 2 16-byte loads for 32 FMAs.  A warp spans
//   4 row quads x 8 latitude quads, so each table load reads 128 contiguous
//   bytes and each chunk load 4 rows 136 bytes apart: no bank conflicts;
// - a double-buffered ring (2 stages of TJ = 32 degrees: the table tile
//   ps[j][i] and the degree chunk ds[r][j], rows padded to 34 floats) in
//   dynamic shared memory, the next stage filled with cp.async while this
//   one is computed: one __syncthreads a stage;
// - compensated chunk sums, as in every Legendre kernel of the port
//   (legendre_common.cuh): each sum adds FOLD = 16 of its terms in a
//   register, adds NCH such partials in plain fp32, and folds that into a
//   TwoSum total (K7: 16 degrees, 2 partials a stage, NCH = 4, a fold every
//   64 terms, 2 stages; K1: the 16 degrees of one parity in a stage, one
//   partial a stage, NCH = 2, a fold every 32 terms of a sum, 2 stages).
//   The error grows with the chain length, so the chains stay as short as
//   the template K1's; the plain adds of partials cost one rounding each at
//   the partials' scale, and spare the folds' 7 adds an output.  K1 folds
//   twice as often as K7 because the bench round trip measured it so: K1 +
//   K2 folding every 64 terms put the default "dense" round trip at 0.669
//   of the 100*eps gate (the template: 0.624), every 32 terms at 0.492, for
//   7 % of K1's time (PERF.md).  tests/test_torch_k7_sums.py emulates these
//   orders and the template K1's in fp32 and holds each within 1.5x the
//   template's.  One running fp32 sum, or torch.bmm, misses the gate at
//   TCO1279 by 3.3-4.2x (PERF.md).  The totals (sum and compensation, 64
//   floats an output tile) live in shared memory, the thread's own float4s,
//   touched once a fold: with them in registers the tile spilled at three
//   blocks an SM.  K1's even and odd threads meet there at the end: thread
//   t < 64 writes north, its partner t + 64 south.
//
// Unaligned rows.  pn rows are ig floats long, and ig % 4 == 0 holds in only
// 4 of the 16 TCO1279 groups; d4 and d2 rows are J floats long, J % 4 == 2.
// So the table tile is copied with 16-byte cp.async when ig % 4 == 0 (and
// the table is 16-byte aligned), with 8-byte copies when ig is even, and
// with 4-byte copies otherwise; the degree chunk with 8-byte copies when J
// is even (and the rows 8-byte aligned), else 4-byte ones; both chosen per
// launch.  Stages that reach past the rows, J or ig test each copy and
// zero-fill what lies outside; the others copy untested (the copies:
// cp_async.cuh, shared with K8 and K2).  The chunk loop reads nothing past
// the group's table.  TMA is out: it needs 16-byte global strides.  A bf16
// table's rows start at 2-byte boundaries when ig is odd, and its operand
// must be rounded to bf16 while staged, so the bf16 variants stage both
// tiles through registers (load, convert, store) into the same ring.
//
// Launch shape: 128 threads; shared memory 2 stages x 16,896 bytes + 32,768
// bytes of totals = 66,560 bytes (K1: its stages hold 32 chunk rows, 2 x
// 12,544 + 32,768 = 57,856 bytes); __launch_bounds__(128, 3): three blocks
// (12 warps) an SM; K7 168 registers (fp32) and 146 (bf16), K1 138 and
// 128, no spill (nvcc -Xptxas -v, in _build/build.log).  A launch has gm
// ceil(ig / 64) ceil(rows / 64) (K7) or ceil(fc2 / 32) (K1) blocks: 640-1,600
// at TCO1279, 1.6-4.0 waves of 396.  Tried for K1 and measured slower or no
// faster (PERF.md): a third stage (149 registers), a 128-register cap, and
// unpadded chunk rows (bank conflicts); four blocks an SM would need both
// of the last two.  The fp64 variants (not on the benchmark path) stay on
// the template in legendre_dense.cu.

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

constexpr int BM = 64;        // rows per block (K1: 32 rows x 2 parities)
constexpr int TI = 64;        // latitudes per block
constexpr int RT = 4;         // rows per thread
constexpr int LT = 8;         // latitudes per thread, two runs of 4
constexpr int THREADS = (BM / RT) * (TI / LT);   // 128
constexpr int LRUN = TI / (LT / 4);   // a thread's runs of 4 latitudes apart
constexpr int MINB = 3;       // blocks an SM
constexpr int TJ = 32;        // degrees per stage
constexpr int FOLD = 16;      // terms per chunk partial
constexpr int DR = TJ + 2;    // floats per ds row
constexpr int PS = TJ * TI;   // table floats per stage
constexpr int NQ = RT * LT / 4;                  // float4s of a thread's tile
static_assert(THREADS % TJ == 0 && (TJ * TI) % (4 * THREADS) == 0, "");
static_assert(TJ % FOLD == 0 && TJ / 2 == FOLD && FOLD % 2 == 0, "");

// the block's rows, folds and ring: K7 (PAR false) or K1 (PAR true), whose
// stages hold the chunk of its 32 rows
template <bool PAR>
struct Ring {
  static constexpr int NR = PAR ? BM / 2 : BM;   // coefficient rows
  static constexpr int NCH = PAR ? 2 : 4;        // partials per fold
  static constexpr int STAGES = 2;
  static constexpr int STAGE = PS + NR * DR;     // floats per stage
  static constexpr int SMEM =
      (STAGES * STAGE + 2 * THREADS * RT * LT) * 4;   // bytes
};

// one stage, degrees j0 .. j0 + TJ - 1: the degree chunk ds[r][j] =
// d[row0 + r, j0 + j] (NR rows; 8-byte copies where d's rows allow, dvec =
// 2) and the table tile ps[j][i] = pn[j0 + j, i0 + i] (16-, 8- or 4-byte
// copies, vec = 4, 2, 1); the bf16-table variant rounds the degree chunk to
// bf16 and widens the table, through registers
template <int NR, typename P, bool FULL>
__device__ __forceinline__ void fill_tiles(float* st, const float* dm,
                                           const P* pnm, int row0, int fc,
                                           int i0, int j0, int J, int ig,
                                           int dvec, int vec) {
  float* ps = st;
  float* ds = st + PS;
  const float* dsrc = dm + (size_t)row0 * J + j0;
  const P* psrc = pnm + (size_t)j0 * ig + i0;
  const int nrow = fc - row0, ndeg = J - j0, nlat = ig - i0;
  const int t = threadIdx.x;
  if constexpr (!std::is_same<P, float>::value) {
    auto rnd = [](float x) { return operand<float, P>(x); };
    auto wide = [](P x) { return __bfloat162float(x); };
    copy_tile<THREADS, float, 1, NR, TJ, FULL, true>(ds, DR, dsrc, J, nrow,
                                                     ndeg, dm, rnd, t);
    copy_tile<THREADS, P, 1, TJ, TI, FULL, true>(ps, TI, psrc, ig, ndeg, nlat,
                                                 pnm, wide, t);
  } else {
    auto same = [](float x) { return x; };
    if (dvec == 2) {
      copy_tile<THREADS, float, 2, NR, TJ, FULL, false>(ds, DR, dsrc, J, nrow,
                                                        ndeg, dm, same, t);
    } else {
      copy_tile<THREADS, float, 1, NR, TJ, FULL, false>(ds, DR, dsrc, J, nrow,
                                                        ndeg, dm, same, t);
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

template <int NR, typename P>
__device__ __forceinline__ void fill_stage(float* st, const float* dm,
                                           const P* pnm, int row0, int fc,
                                           int i0, int j0, int J, int ig,
                                           int dvec, int vec) {
  if (row0 + NR <= fc && j0 + TJ <= J && i0 + TI <= ig) {
    fill_tiles<NR, P, true>(st, dm, pnm, row0, fc, i0, j0, J, ig, dvec, vec);
  } else {
    fill_tiles<NR, P, false>(st, dm, pnm, row0, fc, i0, j0, J, ig, dvec, vec);
  }
}

// K7 (PAR false): out[m, r, i] = sum_j d[m, r, j] pn[m, j, i], rows fc.
// K1 (PAR true): north (out) and south (out2) of rows d (gm, fc, J).
// Block (row chunk, latitude tile, m); thread (ty: rows 4 ty .. 4 ty + 3,
// K1: rows 4 (ty % 8) .., degrees of parity ty / 8; tx: latitudes 4 tx ..
// 4 tx + 3 and TI/2 + 4 tx .. TI/2 + 4 tx + 3)
template <typename P, bool PAR>
__device__ __forceinline__ void inv_body(float* smem, const float* d,
                                         const P* pn, float* out, float* out2,
                                         int fc, int J, int ig, int dvec,
                                         int vec) {
  constexpr int NR = Ring<PAR>::NR;
  constexpr int STAGES = Ring<PAR>::STAGES;
  constexpr int STAGE = Ring<PAR>::STAGE;
  constexpr int RG = NR / RT;                 // row groups of a parity
  // stages per compensated fold: NCH partials of FOLD terms of a sum
  constexpr int FOLD_STAGES = Ring<PAR>::NCH * FOLD / (PAR ? TJ / 2 : TJ);
  const int row0 = blockIdx.x * NR;
  const int i0 = blockIdx.y * TI;
  const int m = blockIdx.z;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int ty = warp * 4 + lane / 8;
  const int tx = lane % 8;
  const int par = PAR ? ty / RG : 0;          // warp-uniform
  const int trow = RT * (PAR ? ty % RG : ty);
  const float* dm = d + (size_t)m * fc * J;
  const P* pnm = pn + (size_t)m * J * ig;

  // the compensated totals (sum, compensation) live in shared memory, the
  // thread's own float4s, the q-th of each at ts[q * THREADS] and
  // cs[q * THREADS], touched once a fold; held collects Ring<PAR>::NCH
  // chunk partials, FOLD_STAGES stages, between folds
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
      fill_stage<NR, P>(smem + s * STAGE, dm, pnm, row0, fc, i0, s * TJ, J,
                        ig, dvec, vec);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nstage; ++c) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage c landed
    __syncthreads();               // everyone's; and stage c - 1 is free
    if (c + STAGES - 1 < nstage) {
      fill_stage<NR, P>(smem + (c + STAGES - 1) % STAGES * STAGE, dm, pnm,
                        row0, fc, i0, (c + STAGES - 1) * TJ, J, ig, dvec, vec);
    }
    cp_async_commit();

    const float* ps = smem + c % STAGES * STAGE + 4 * tx;
    const float* ds = smem + c % STAGES * STAGE + PS + trow * DR;
    if constexpr (PAR) {
      // one partial: the TJ / 2 = FOLD degrees of this thread's parity
      float part[RT][LT];
      const float* pp = ps + par * TI;
      const float* dp = ds + par;
#pragma unroll
      for (int k = 0; k < FOLD; ++k) {
        const int j = 2 * k;
        float bv[LT];
#pragma unroll
        for (int h = 0; h < LT / 4; ++h) {
          const float4 b =
              *reinterpret_cast<const float4*>(pp + j * TI + h * LRUN);
          bv[4 * h] = b.x; bv[4 * h + 1] = b.y;
          bv[4 * h + 2] = b.z; bv[4 * h + 3] = b.w;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float a = dp[r * DR + j];
#pragma unroll
          for (int l = 0; l < LT; ++l) {
            part[r][l] = k == 0 ? a * bv[l] : fmaf(a, bv[l], part[r][l]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int l = 0; l < LT; ++l) held[r][l] += part[r][l];
      }
    } else {
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
    }
    if ((c + 1) % FOLD_STAGES == 0) fold_held();
  }
  if (nstage % FOLD_STAGES != 0) fold_held();
  cp_async_wait<0>();

  // K1: the even (t < THREADS / 2) and odd (t + THREADS / 2) threads of the
  // same rows and latitudes read each other's totals; the even one writes
  // north = E + O, the odd one south = E - O
  const int other = par ? -THREADS / 2 : THREADS / 2;
  float* dst = par ? out2 : out;
  if constexpr (PAR) __syncthreads();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 t4 = ts[q * THREADS], c4 = cs[q * THREADS];
    const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = tv[e] + cv[e];
    if constexpr (PAR) {
      const float4 u4 = ts[q * THREADS + other];
      const float4 w4 = cs[q * THREADS + other];
      const float uv[4] = {u4.x + w4.x, u4.y + w4.y, u4.z + w4.z,
                           u4.w + w4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = par ? uv[e] - v[e] : v[e] + uv[e];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = (4 * q + e) / LT, l = (4 * q + e) % LT;
      const int row = row0 + trow + r;
      const int i = l / 4 * LRUN + 4 * tx + l % 4;
      if (row < fc && i0 + i < ig) {
        dst[((size_t)m * fc + row) * ig + i0 + i] = v[e];
      }
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(THREADS, MINB)
inv_dense2_kernel(const float* __restrict__ d4, const P* __restrict__ pn,
                  float* __restrict__ out, int fc4, int J, int ig, int dvec,
                  int vec) {
  extern __shared__ __align__(16) float smem[];
  inv_body<P, false>(smem, d4, pn, out, nullptr, fc4, J, ig, dvec, vec);
}

template <bool PAR>
dim3 grid_of(int gm, int rows, int ig) {
  constexpr int NR = Ring<PAR>::NR;
  return dim3((rows + NR - 1) / NR, (ig + TI - 1) / TI, gm);
}

// launch K7 (output out) or K1 (north, south): the C entries' common part
template <bool PAR, typename P, typename Kernel, typename... Out>
int launch(Kernel kernel, const void* d, const void* pn, int gm, int rows,
           int J, int ig, void* stream, Out... outs) {
  constexpr int SMEM = Ring<PAR>::SMEM;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid_of<PAR>(gm, rows, ig), THREADS, SMEM,
           (cudaStream_t)stream>>>((const float*)d, (const P*)pn,
                                   static_cast<float*>(outs)..., rows, J, ig,
                                   copy_vec(d, J, 2), copy_vec(pn, ig));
  return (int)cudaGetLastError();
}

template <bool PAR, typename Kernel>
int shape(Kernel kernel, int gm, int rows, int ig, int* info) {
  return ect::launch_shape(kernel, grid_of<PAR>(gm, rows, ig), THREADS,
                           Ring<PAR>::SMEM, info);
}

}  // namespace k7

namespace k1 {

// K1: north and south of rows d2 (gm, fc2, J), K7's body in parity mode
template <typename P>
__global__ void __launch_bounds__(k7::THREADS, k7::MINB)
inv_dense_kernel(const float* __restrict__ d2, const P* __restrict__ pn,
                 float* __restrict__ north, float* __restrict__ south,
                 int fc2, int J, int ig, int dvec, int vec) {
  extern __shared__ __align__(16) float smem[];
  k7::inv_body<P, true>(smem, d2, pn, north, south, fc2, J, ig, dvec, vec);
}

}  // namespace k1

extern "C" {
int ect_inv_dense2_f32(const void* d4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return k7::launch<false, float>(k7::inv_dense2_kernel<float>, d4, pn, gm,
                                  fc4, J, ig, stream, out);
}
int ect_inv_dense2_bf16(const void* d4, const void* pn, void* out, int gm,
                        int fc4, int J, int ig, void* stream) {
  return k7::launch<false, ect::bf16>(k7::inv_dense2_kernel<ect::bf16>, d4,
                                      pn, gm, fc4, J, ig, stream, out);
}
int ect_inv_dense2_shape_f32(int gm, int fc4, int ig, int* info) {
  return k7::shape<false>(k7::inv_dense2_kernel<float>, gm, fc4, ig, info);
}
int ect_inv_dense2_shape_bf16(int gm, int fc4, int ig, int* info) {
  return k7::shape<false>(k7::inv_dense2_kernel<ect::bf16>, gm, fc4, ig,
                          info);
}
int ect_inv_dense_f32(const void* d2, const void* pn, void* north,
                      void* south, int gm, int fc2, int J, int ig,
                      void* stream) {
  return k7::launch<true, float>(k1::inv_dense_kernel<float>, d2, pn, gm,
                                 fc2, J, ig, stream, north, south);
}
int ect_inv_dense_bf16(const void* d2, const void* pn, void* north,
                       void* south, int gm, int fc2, int J, int ig,
                       void* stream) {
  return k7::launch<true, ect::bf16>(k1::inv_dense_kernel<ect::bf16>, d2, pn,
                                     gm, fc2, J, ig, stream, north, south);
}
int ect_inv_dense_shape_f32(int gm, int fc2, int ig, int* info) {
  return k7::shape<true>(k1::inv_dense_kernel<float>, gm, fc2, ig, info);
}
int ect_inv_dense_shape_bf16(int gm, int fc2, int ig, int* info) {
  return k7::shape<true>(k1::inv_dense_kernel<ect::bf16>, gm, fc2, ig, info);
}
}  // extern "C"
