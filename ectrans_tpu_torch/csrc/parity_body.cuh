// The bodies of the parity-split Legendre kernels, shared by the kernels
// that stage their operands differently: K5 and K9 sum along the contiguous
// axis of both operands (inv_form: K8's tile), K6 and K10 along the tables'
// outer axis (dir_form: K7's tile).  K5 and K6 (legendre_grouped.cu) stage
// fp32 or bf16 parity tables straight into the fp32 tiles; K9 and K10
// (legendre_planes.cu) sum bf16 limb planes and split them by parity into
// the same tiles.  Also the latitude split of the dir_form launches among a
// cluster of blocks (grouped::split_for, combine_split, launch).
//
// Summation order, both forms (K1's and K2's): each sum adds FOLD = 16 of
// its terms in an FMA chain, adds a stage's 2 such partials in plain fp32
// and folds that into a compensated total (TwoSum) once a stage; the totals
// stay in registers.

#pragma once

#include <cooperative_groups.h>

#include <cstddef>

#include "legendre_common.cuh"

namespace grouped {

namespace cg = cooperative_groups;

using ect::add_compensated;

constexpr int MAXSPLIT = 8;   // blocks of a cluster (the portable limit)
constexpr int FIXED = 2;      // a block's fixed cost, in stages

// the latitude split of a launch of `blocks` blocks of `nstage` stages each
// on `slots` resident blocks: the S <= MAXSPLIT that minimises rounds x
// (stages a block + FIXED), a larger S taken only where it saves a tenth
inline int split_for(long blocks, int nstage, long slots) {
  int best = 1;
  long best_cost = 0;
  for (int s = 1; s <= MAXSPLIT && s <= nstage; ++s) {
    const long rounds = (s * blocks + slots - 1) / slots;
    const long cost = rounds * ((nstage + s - 1) / s + FIXED);
    if (s == 1 || 10 * cost < 9 * best_cost) {
      best = s;
      best_cost = cost;
    }
  }
  return best;
}

// the split's parts meet in the cluster's first block: each later block's
// totals (its shared memory, read through the cluster) are added to the
// first's by TwoSum, its compensation plainly, in rank order; every thread
// of every block of the cluster calls this, after its last copy landed
template <int THREADS, int R, int C>
__device__ __forceinline__ void combine_split(float* smem, float (&tot)[R][C],
                                              float (&cmp)[R][C], int rank,
                                              int nsplit) {
  constexpr int NQ = R * C / 4;
  static_assert(C % 4 == 0, "a thread's totals move as float4s of a row");
  cg::cluster_group cluster = cg::this_cluster();
  float4* mine = reinterpret_cast<float4*>(smem) + threadIdx.x;
  __syncthreads();   // the block is done with its ring
  if (rank > 0) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int r = 4 * q / C, c = 4 * q % C;
      mine[q * THREADS] = make_float4(tot[r][c], tot[r][c + 1], tot[r][c + 2],
                                      tot[r][c + 3]);
      mine[(NQ + q) * THREADS] = make_float4(cmp[r][c], cmp[r][c + 1],
                                             cmp[r][c + 2], cmp[r][c + 3]);
    }
  }
  cluster.sync();
  if (rank == 0) {
#pragma unroll 1
    for (int s = 1; s < nsplit; ++s) {
      const float4* o = cluster.map_shared_rank(
          reinterpret_cast<float4*>(smem), s) + threadIdx.x;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int r = 4 * q / C, c = 4 * q % C;
        const float4 t4 = o[q * THREADS], c4 = o[(NQ + q) * THREADS];
        const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          add_compensated(tot[r][c + e], cmp[r][c + e], tv[e]);
          cmp[r][c + e] += cv[e];
        }
      }
    }
  }
  cluster.sync();    // the later blocks' shared memory stays until read
}

// launch kernel on grid with clusters of `split` blocks along x (none for
// split 1), `smem` bytes of dynamic shared memory (above the default 48 KB
// only after raising the kernel's limit)
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), dim3 grid, int threads, int smem,
           int split, void* stream, Args... args) {
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace grouped

// K6's and K10's block: 64 threads hold BR rows x DK degrees of each parity,
// warp 0 the first parity, warp 1 the second; thread (ty, tx) a register
// tile of RT rows x KT degrees (rows RT ty .. RT ty + RT - 1; degrees 4 tx ..
// 4 tx + 3 and KRUN + 4 tx .. KRUN + 4 tx + 3).  A stage holds TJ latitudes:
// for each parity the table tile ps[i][k] (TJ x DK) and the operand chunk
// ds[r][i] (BR rows of DR floats), PSTAGE floats, the second parity's after
// the first's.
namespace dir_form {

using ect::add_compensated;

constexpr int BR = 20;        // coefficient rows per block, each parity
constexpr int RT = 5;         // rows per thread
constexpr int DK = 64;        // parity degrees per block
constexpr int KT = 8;         // degrees per thread, two runs of 4
constexpr int KRUN = DK / 2;  // a thread's runs of 4 degrees apart
constexpr int NRG = BR / RT;  // row groups
constexpr int NKG = DK / KT;  // degree groups
constexpr int THREADS = 2 * NRG * NKG;   // 64: a warp a parity
constexpr int TJ = 32;        // latitudes per stage
constexpr int FOLD = 16;      // latitudes per chunk partial
constexpr int DR = TJ + 2;    // floats per operand row
constexpr int PT = TJ * DK;   // table floats per parity and stage
constexpr int PSTAGE = PT + BR * DR;     // floats per parity and stage
constexpr int STAGE = 2 * PSTAGE;        // floats per stage
static_assert(NRG * NKG == 32, "a warp a parity");
static_assert(TJ % FOLD == 0 && FOLD % 2 == 0 && KT == 8, "");
static_assert(2 * RT * KT * THREADS <= STAGE, "a block's totals fit a stage");

// this thread's sums over one stage of its parity, st = the parity's tiles
// (st + PSTAGE * par), added to the compensated totals (tot, cmp)
__device__ __forceinline__ void stage_sums(const float* st, int ty, int tx,
                                           float (&tot)[RT][KT],
                                           float (&cmp)[RT][KT]) {
  const float* ps = st + 4 * tx;
  const float* ds = st + PT + RT * ty * DR;
  float held[RT][KT];   // adds the stage's two chunk partials
#pragma unroll
  for (int h = 0; h < TJ; h += FOLD) {
    // the chunk partial over latitudes h .. h + FOLD - 1 of this stage
    float part[RT][KT];
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
        float bv[KT];
#pragma unroll
        for (int k = 0; k < KT / 4; ++k) {
          const float4 b =
              *reinterpret_cast<const float4*>(ps + j * DK + k * KRUN);
          bv[4 * k] = b.x; bv[4 * k + 1] = b.y;
          bv[4 * k + 2] = b.z; bv[4 * k + 3] = b.w;
        }
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const float a = u == 0 ? av[r].x : av[r].y;
#pragma unroll
          for (int l = 0; l < KT; ++l) {
            part[r][l] = q + u == 0 ? a * bv[l]
                                    : fmaf(a, bv[l], part[r][l]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int l = 0; l < KT; ++l) {
        held[r][l] = h == 0 ? part[r][l] : held[r][l] + part[r][l];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int l = 0; l < KT; ++l) {
      add_compensated(tot[r][l], cmp[r][l], held[r][l]);
    }
  }
}

}  // namespace dir_form

// K5's and K9's block: 128 threads hold BR rows x TI latitudes, warps 0-1
// the first parity's sum s, warps 2-3 the second's a; thread (ty, tx) a
// register tile of RT rows x LT latitudes (rows ty + NRG r, latitudes tx +
// NLG l), read as float4 along the degrees from rows of LD floats.  A stage
// holds DK parity degrees: for each parity the operand chunk xs[r][k] (BR
// rows) and the table tile ps[i][k] (TI rows), PSTAGE floats, the second
// parity's after the first's.  At the end north = s + a, south = s - a.
namespace inv_form {

using ect::add_compensated;

constexpr int BR = 32;        // coefficient rows per block
constexpr int RT = 4;         // rows per thread, NRG apart
constexpr int TI = 64;        // latitudes per block
constexpr int LT = 8;         // latitudes per thread, NLG apart
constexpr int NRG = BR / RT;  // row groups
constexpr int NLG = TI / LT;  // latitude groups
constexpr int PTHREADS = NRG * NLG;      // 64 a parity
constexpr int THREADS = 2 * PTHREADS;    // 128
constexpr int DK = 32;        // parity degrees per stage
constexpr int FOLD = 16;      // degrees per chunk partial
constexpr int LD = DK + 4;    // floats per shared row (16-byte multiple)
constexpr int PSTAGE = (BR + TI) * LD;   // floats per parity and stage
constexpr int STAGE = 2 * PSTAGE;        // floats per stage
constexpr int NQ = RT * LT / 4;          // float4s of a thread's tile
static_assert(NRG % 4 == 0 && NLG == 8, "warps of 4 row x 8 latitude groups");
static_assert(DK % FOLD == 0 && FOLD % 4 == 0, "");
static_assert(LD % 4 == 0 && (LD / 4) % 2 == 1,
              "rows of an odd count of float4s: 8 rows, 8 bank quads");
static_assert(2 * NQ * PTHREADS * 4 <= STAGE,
              "both parities' outputs fit a stage");

// this thread's sums over one stage of its parity, st = the parity's tiles
// (st + PSTAGE * par), added to the compensated totals (tot, cmp)
__device__ __forceinline__ void stage_sums(const float* st, int ty, int tx,
                                           float (&tot)[RT][LT],
                                           float (&cmp)[RT][LT]) {
  const float* xs = st + ty * LD;
  const float* ps = st + BR * LD + tx * LD;
  float held[RT][LT];   // adds the stage's two chunk partials
#pragma unroll
  for (int h = 0; h < DK; h += FOLD) {
    // the chunk partial over degrees h .. h + FOLD - 1 of this stage
    float part[RT][LT];
#pragma unroll
    for (int q = 0; q < FOLD; q += 4) {
      float4 a[RT];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        a[r] = *reinterpret_cast<const float4*>(xs + r * NRG * LD + h + q);
      }
#pragma unroll
      for (int l = 0; l < LT; ++l) {
        const float4 b =
            *reinterpret_cast<const float4*>(ps + l * NLG * LD + h + q);
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float p = q == 0 ? a[r].x * b.x : fmaf(a[r].x, b.x, part[r][l]);
          p = fmaf(a[r].y, b.y, p);
          p = fmaf(a[r].z, b.z, p);
          part[r][l] = fmaf(a[r].w, b.w, p);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int l = 0; l < LT; ++l) {
        held[r][l] = h == 0 ? part[r][l] : held[r][l] + part[r][l];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int l = 0; l < LT; ++l) {
      add_compensated(tot[r][l], cmp[r][l], held[r][l]);
    }
  }
}

// the s (par 0) and a (par 1) threads of the same outputs read each other's
// sums through smem (at least a stage, free: every copy landed); the s
// thread writes north = s + a, the a thread south = s - a, (gm, fc, ig)
__device__ __forceinline__ void store(float* smem, const float (&tot)[RT][LT],
                                      const float (&cmp)[RT][LT], int par,
                                      int pt, int ty, int tx, int m, int row0,
                                      int i0, int fc, int ig, float* north,
                                      float* south) {
  __syncthreads();
  float4* vs = reinterpret_cast<float4*>(smem) + pt;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int r = 4 * q / LT, l = 4 * q % LT;
    vs[(par * NQ + q) * PTHREADS] = make_float4(
        tot[r][l] + cmp[r][l], tot[r][l + 1] + cmp[r][l + 1],
        tot[r][l + 2] + cmp[r][l + 2], tot[r][l + 3] + cmp[r][l + 3]);
  }
  __syncthreads();
  float* dst = par ? south : north;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float4 o4 = vs[((1 - par) * NQ + q) * PTHREADS];
    const float ov[4] = {o4.x, o4.y, o4.z, o4.w};
    const int r = 4 * q / LT, l0 = 4 * q % LT;
    const int row = row0 + ty + NRG * r;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int l = l0 + e;
      const int i = i0 + tx + NLG * l;
      const float v = tot[r][l] + cmp[r][l];
      if (row < fc && i < ig) {
        dst[((size_t)m * fc + row) * ig + i] = par ? ov[e] - v : v + ov[e];
      }
    }
  }
}

}  // namespace inv_form
