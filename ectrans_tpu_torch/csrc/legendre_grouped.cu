// K5 and K6 for Hopper (sm_90a): the parity-split grouped Legendre
// transforms of the "pallas" engine, fp32 and on bf16 tables, each a
// pipelined kernel with K7's staging (K6) or K8's (K5); and their fp64
// variants on the first port's template.
//
// K5 replaces ectrans_tpu/ops/legendre_pallas.py group_inv (_inv_kernel);
// K6 replaces group_dir (_dir_kernel).  Both contract one m-group of parity
// rows against the symmetric and antisymmetric tables of that group,
// psym[m, i, k] = Pbar_{m+2k}^m(mu_i) and pasym[m, i, k] = Pbar_{m+2k+1}^m(mu_i),
// each (gm, ig, kg) with k contiguous:
//   K5: s = sym . psym^T, a = asym . pasym^T; north = s + a, south = s - a
//       (south NOT latitude-reversed): sums along the contiguous k of both
//       operands, outputs along the tables' outer axis i, K8's form
//       (legendre_dense2_dir.cu);
//   K6: sym = fsym . psym, asym = fasym . pasym (quadrature already
//       applied): sums along the tables' outer axis i, outputs along their
//       contiguous k, K7's form (legendre_dense2.cu).
//
// Bounds.  Each table entry is read once and feeds fc2 multiply-adds of its
// parity.  At TCO1279 the 16 groups' tables hold 3.71 GB of fp32 (gm 80; ig
// 1280 -> 474, kg 641 -> 41), so K5 (fc2 = 32) does 5.93e10 FLOP, 0.885 ms
// at the data sheet's 67 TFLOP/s of fp32 FMA, against 4.12 GB, 1.231 ms at
// 3.35 TB/s, and K6 (fc2 = 20) 3.71e10 FLOP, 0.553 ms, against 3.97 GB,
// 1.184 ms: both bytes-bound, on CUDA cores (fp32 FMA is the "highest"
// tier's accuracy contract).
//
// What held back the first kernels (one template for both): 32-row blocks
// (K6: 37.5 % of its FMAs and staging on zero rows at fc2 = 20);
// synchronous staging with two barriers a stage and no copy in flight while
// computing; one shared load of the operand per FMA; K5's [64][33] table
// tile read along k; and K6's few blocks: a group launched gm ceil(kg / 64)
// of them, 880 down to 80, so groups 13-15 put about one block on each of
// the 132 SMs, and each walked its 15-20 stages of latitudes alone.
//
// K6's design (K7's staging and tile, K1's parity split):
// - a block of 64 threads holds the 20 rows of both parities x 64 degrees:
//   warp 0 sums fsym . psym and warp 1 fasym . pasym, each thread a register
//   tile of 5 rows x 8 degrees (two runs of 4, 32 apart), so no row
//   computes zeros at fc2 = 20 (more rows put further 20-row chunks on grid
//   z).  A latitude pair costs 5 8-byte loads of the operand and 4 16-byte
//   loads of the table for 80 FMAs; a warp reads 4 operand rows 170 floats
//   apart (rows padded to 34 floats) and 128 contiguous table bytes: no bank
//   conflicts;
// - a double-buffered ring of stages of 32 latitudes (each parity's table
//   tile ps[i][k], copied as latitude rows of k, and its operand chunk
//   ds[r][i]), the next stage filled with cp.async while this one is
//   computed: one __syncthreads a stage (cp_async.cuh, shared with K1, K2,
//   K7, K8);
// - the latitude split for the late groups: a launch whose blocks would
//   leave SMs idle or walk long rounds alone splits each block's latitude
//   stages among a cluster of S blocks (S <= 8, chosen per launch from the
//   resident slots the occupancy API gives, split_for), which add their
//   compensated totals into the cluster's first block through distributed
//   shared memory, by TwoSum, in rank order: no atomics, the same bits every
//   run.  At TCO1279 this gives groups of 80-160 blocks 4-5 times as many.
// K5's design (K8's staging and tile, K1's combine):
// - a block of 128 threads holds 32 rows x 64 latitudes: warps 0-1 sum
//   s = sym . psym, warps 2-3 a = asym . pasym, each thread a register tile
//   of 4 rows x 8 latitudes (rows ty + 8 r, latitudes tx + 8 l), read as
//   float4 along k from rows padded to 36 floats, so the 4 rows and 8
//   latitudes a warp reads at one k fall in different bank quads: 4 + 8
//   16-byte loads for 128 FMAs; at the end the s and a threads of the same
//   outputs meet through shared memory, as K1's E and O do: the s thread
//   writes north = s + a, the a thread south = s - a;
// - a double-buffered ring of stages of 32 parity degrees (each parity's
//   operand chunk and table tile, row-major as they lie in memory), filled
//   with cp.async: one __syncthreads a stage.  A group's reduction is only
//   kg long (41 in group 15: two stages), so a block is short, and the
//   launch's gm ceil(ig / 64) blocks (640-1,600 at TCO1279) keep 8 warps on
//   every SM, each block's pipeline filling while others compute.
// Summation order, both: compensated chunk sums, as in every Legendre kernel
// of the port (legendre_common.cuh): each sum adds FOLD = 16 of its terms in
// an FMA chain, adds the stage's 2 such partials in plain fp32 and folds
// that into a TwoSum total once a stage (a fold every 32 terms), K1's and
// K2's order (the first kernels: one 32-term chain a stage, folded).
// tests/test_torch_k5_sums.py emulates both orders, with K6's split, and
// holds each within 1.5x the template's error; one running fp32 sum, or
// torch.bmm, misses the TCO1279 100*eps round-trip gate (PERF.md).  The
// totals stay in registers.
//
// Unaligned rows.  kg = (nsmax + 1 - m0) / 2 + 1 is odd in all 16 TCO1279
// groups, so a table row of kg entries after the first would start only
// 4-byte aligned and take 4-byte copies.  Resolution.grouped_legendre
// stores the tables in rows of ldk = kg rounded up to a multiple of 4, the
// extra columns zero (psym and pasym are views of the first kg), and the
// kernels take ldk: each table tile is copied with 16-byte cp.async
// (PERF.md has the A/B of both layouts).  A table copy that reaches past
// kg reads only its entries below kg and zero-fills the rest (copy_tile's
// PADDED), so the padding's values never enter a sum.  Operands and
// outputs keep their rows: K5's operand rows (kg long) and K6's (ig long,
// 8-byte copies where ig is even) take the widest copy their alignment
// allows, chosen per launch (copy_vec).  Stages that reach past the rows, ig or kg test each
// copy and zero-fill what lies outside; the others copy untested.  The
// bf16-table variants round the operand to bf16 and widen the table while
// staging, through registers, into the same ring, as K7's and K8's do; four
// table entries a load where the rows allow (bf16_vec).
//
// Launch shape: K6 64 threads, 43,648 bytes of shared memory,
// __launch_bounds__(64, 4): 4 blocks an SM, 251 registers (fp32) and 255
// (bf16); K5 128 threads, 55,296 bytes, __launch_bounds__(128, 2): 2 blocks
// an SM, 254 and 236 registers; no spill (nvcc -Xptxas -v, in
// _build/build.log; chip_smoke.py fails on a spill).  Tried on the card and
// not kept (PERF.md): the template's one 32-term chain a stage (a little
// faster, but it took the "pallas" round trip markedly closer to its
// 100*eps gate), 5 blocks an SM for K6 and 3 for K5 with K1's order (both
// spill), and K6 without the latitude split (slower).  The fp64 variants
// (not on the benchmark path) stay on the template at the end of this
// file.

#include <cooperative_groups.h>

#include <algorithm>

#include "cp_async.cuh"
#include "legendre_common.cuh"

namespace cg = cooperative_groups;

namespace grouped {

using ect::add_compensated;

constexpr int MAXSPLIT = 8;   // blocks of a cluster (the portable limit)
constexpr int FIXED = 2;      // a block's fixed cost, in stages

// the latitude split of a K6 launch of `blocks` blocks of `nstage` stages
// each on `slots` resident blocks: the S <= MAXSPLIT that minimises rounds x
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

// the widest copy, in entries, of a bf16 table whose rows of ld entries
// start at ptr: 4 (one 8-byte load) where every row is 8-byte aligned
inline int bf16_vec(const void* ptr, int ld) {
  return reinterpret_cast<uintptr_t>(ptr) % 8 == 0 && ld % 4 == 0 ? 4 : 1;
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

namespace k6 {

using ect::add_compensated;
using ect::copy_tile;
using ect::copy_vec;
using ect::cp_async_commit;
using ect::cp_async_wait;
using ect::operand;
using ect::table_value;

constexpr int BR = 20;        // coefficient rows per block, each parity
constexpr int RT = 5;         // rows per thread
constexpr int DK = 64;        // parity degrees per block
constexpr int KT = 8;         // degrees per thread, two runs of 4
constexpr int KRUN = DK / 2;  // a thread's runs of 4 degrees apart
constexpr int NRG = BR / RT;  // row groups
constexpr int NKG = DK / KT;  // degree groups
constexpr int THREADS = 2 * NRG * NKG;   // 64: a warp a parity
constexpr int MINB = 4;       // blocks an SM
constexpr int TJ = 32;        // latitudes per stage
constexpr int FOLD = 16;      // latitudes per chunk partial
constexpr int DR = TJ + 2;    // floats per operand row
constexpr int PT = TJ * DK;   // table floats per parity and stage
constexpr int PSTAGE = PT + BR * DR;     // floats per parity and stage
constexpr int STAGE = 2 * PSTAGE;        // floats per stage
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE * 4;   // bytes
static_assert(NRG * NKG == 32, "a warp a parity");
static_assert(TJ % FOLD == 0 && FOLD % 2 == 0 && KT == 8, "");
static_assert(2 * RT * KT * THREADS <= STAGES * STAGE,
              "a block's totals fit its ring");

// one stage, latitudes i0 .. i0 + TJ - 1, of both parities: the operand
// chunk ds[r][i] = f[row0 + r, i0 + i] (8-byte copies where the rows
// allow, dvec = 2) and the table tile ps[i][k] = p[i0 + i, k0 + k], rows
// ldk apart (16-, 8- or 4-byte copies, vec = 4, 2, 1); the bf16-table
// variant rounds the operand to bf16 and widens the table (vec entries a
// load), through registers
template <typename P, bool FULL>
__device__ __forceinline__ void fill_tiles(float* st, const float* fsm,
                                           const float* fam, const P* psm,
                                           const P* pam, int row0, int fc,
                                           int i0, int k0, int ig, int kg,
                                           int ldk, int dvec, int vec) {
  const int nrow = fc - row0, nlat = ig - i0, ndeg = kg - k0;
  const int t = threadIdx.x;
#pragma unroll
  for (int par = 0; par < 2; ++par) {
    float* ps = st + par * PSTAGE;
    float* ds = ps + PT;
    const float* fm = par ? fam : fsm;
    const P* pm = par ? pam : psm;
    const float* dsrc = fm + (size_t)row0 * ig + i0;
    const P* psrc = pm + (size_t)i0 * ldk + k0;
    if constexpr (!std::is_same<P, float>::value) {
      auto rnd = [](float x) { return operand<float, P>(x); };
      auto wide = [](P x) { return table_value(x); };
      copy_tile<THREADS, float, 1, BR, TJ, FULL, true>(ds, DR, dsrc, ig, nrow,
                                                       nlat, fm, rnd, t);
      if (vec == 4) {
        copy_tile<THREADS, P, 4, TJ, DK, FULL, true, true>(
            ps, DK, psrc, ldk, nlat, ndeg, pm, wide, t);
      } else {
        copy_tile<THREADS, P, 1, TJ, DK, FULL, true, true>(
            ps, DK, psrc, ldk, nlat, ndeg, pm, wide, t);
      }
    } else {
      auto same = [](float x) { return x; };
      if (dvec == 2) {
        copy_tile<THREADS, float, 2, BR, TJ, FULL, false>(ds, DR, dsrc, ig,
                                                          nrow, nlat, fm,
                                                          same, t);
      } else {
        copy_tile<THREADS, float, 1, BR, TJ, FULL, false>(ds, DR, dsrc, ig,
                                                          nrow, nlat, fm,
                                                          same, t);
      }
      if (vec == 4) {
        copy_tile<THREADS, float, 4, TJ, DK, FULL, false, true>(
            ps, DK, psrc, ldk, nlat, ndeg, pm, same, t);
      } else if (vec == 2) {
        copy_tile<THREADS, float, 2, TJ, DK, FULL, false, true>(
            ps, DK, psrc, ldk, nlat, ndeg, pm, same, t);
      } else {
        copy_tile<THREADS, float, 1, TJ, DK, FULL, false, true>(
            ps, DK, psrc, ldk, nlat, ndeg, pm, same, t);
      }
    }
  }
}

template <typename P>
__device__ __forceinline__ void fill_stage(float* st, const float* fsm,
                                           const float* fam, const P* psm,
                                           const P* pam, int row0, int fc,
                                           int i0, int k0, int ig, int kg,
                                           int ldk, int dvec, int vec) {
  if (row0 + BR <= fc && i0 + TJ <= ig && k0 + DK <= kg) {
    fill_tiles<P, true>(st, fsm, fam, psm, pam, row0, fc, i0, k0, ig, kg,
                        ldk, dvec, vec);
  } else {
    fill_tiles<P, false>(st, fsm, fam, psm, pam, row0, fc, i0, k0, ig, kg,
                         ldk, dvec, vec);
  }
}

// sym[m, r, k] = sum_i fsym[m, r, i] psym[m, i, k] (warp 0) and asym from
// fasym, pasym (warp 1); table rows ldk apart.  Block (degree tile x split
// rank, m, row chunk); rank `rank` of the cluster sums stages [c0, c1) of
// the latitudes; thread (ty: rows 5 ty .. 5 ty + 4; tx: degrees 4 tx ..
// 4 tx + 3 and KRUN + 4 tx .. KRUN + 4 tx + 3)
template <typename P>
__device__ __forceinline__ void dir_body(float* smem, const float* fsym,
                                         const float* fasym, const P* psym,
                                         const P* pasym, float* sym,
                                         float* asym, int fc, int kg, int ig,
                                         int ldk, int nsplit, int dvec,
                                         int vec) {
  const int rank = blockIdx.x % nsplit;
  const int k0 = blockIdx.x / nsplit * DK;
  const int m = blockIdx.y;
  const int row0 = blockIdx.z * BR;
  const int par = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = lane / NKG, tx = lane % NKG;
  const size_t fo = (size_t)m * fc * ig, po = (size_t)m * ig * ldk;
  const float* fsm = fsym + fo;
  const float* fam = fasym + fo;
  const P* psm = psym + po;
  const P* pam = pasym + po;
  const int nstage = (ig + TJ - 1) / TJ;
  const int c0 = rank * nstage / nsplit, c1 = (rank + 1) * nstage / nsplit;

  // compensated totals (tot, cmp); held adds a stage's two chunk partials
  float held[RT][KT], tot[RT][KT], cmp[RT][KT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int l = 0; l < KT; ++l) tot[r][l] = cmp[r][l] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (c0 + s < c1) {
      fill_stage<P>(smem + s * STAGE, fsm, fam, psm, pam, row0, fc,
                    (c0 + s) * TJ, k0, ig, kg, ldk, dvec, vec);
    }
    cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage c landed
    __syncthreads();               // everyone's; and stage c - 1 is free
    if (c + STAGES - 1 < c1) {
      fill_stage<P>(smem + (c - c0 + STAGES - 1) % STAGES * STAGE, fsm, fam,
                    psm, pam, row0, fc, (c + STAGES - 1) * TJ, k0, ig, kg,
                    ldk, dvec, vec);
    }
    cp_async_commit();

    const float* st = smem + (c - c0) % STAGES * STAGE + par * PSTAGE;
    const float* ps = st + 4 * tx;
    const float* ds = st + PT + RT * ty * DR;
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
  cp_async_wait<0>();

  if (nsplit > 1) {
    grouped::combine_split<THREADS>(smem, tot, cmp, rank, nsplit);
    if (rank > 0) return;
  }
  float* out = par ? asym : sym;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + RT * ty + r;
#pragma unroll
    for (int l = 0; l < KT; ++l) {
      const int k = k0 + l / 4 * KRUN + 4 * tx + l % 4;
      if (row < fc && k < kg) {
        out[((size_t)m * fc + row) * kg + k] = tot[r][l] + cmp[r][l];
      }
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(THREADS, MINB)
dir_grouped_kernel(const float* __restrict__ fsym,
                   const float* __restrict__ fasym, const P* __restrict__ psym,
                   const P* __restrict__ pasym, float* __restrict__ sym,
                   float* __restrict__ asym, int fc2, int kg, int ig,
                   int ldk, int nsplit, int dvec, int vec) {
  extern __shared__ __align__(16) float smem[];
  dir_body<P>(smem, fsym, fasym, psym, pasym, sym, asym, fc2, kg, ig, ldk,
              nsplit, dvec, vec);
}

inline dim3 grid_of(int gm, int fc2, int kg, int split) {
  return dim3((kg + DK - 1) / DK * split, gm, (fc2 + BR - 1) / BR);
}

// the latitude split of a launch (grouped::split_for on the card's resident
// slots)
template <typename P>
int split_of(int gm, int fc2, int kg, int ig, int* split) {
  long slots = 0;
  const int e = ect::resident_slots<&dir_grouped_kernel<P>>(THREADS, SMEM,
                                                            &slots);
  if (e != 0) return e;
  const dim3 g = grid_of(gm, fc2, kg, 1);
  *split = grouped::split_for((long)g.x * g.y * g.z, (ig + TJ - 1) / TJ,
                              std::max(1L, slots));
  return 0;
}

template <typename P>
int launch(const void* fsym, const void* fasym, const void* psym,
           const void* pasym, void* sym, void* asym, int gm, int fc2, int kg,
           int ig, int ldk, void* stream) {
  int split = 1;
  const int e = split_of<P>(gm, fc2, kg, ig, &split);
  if (e != 0) return e;
  const int dvec = std::min(copy_vec(fsym, ig, 2), copy_vec(fasym, ig, 2));
  const int vec =
      std::is_same<P, float>::value
          ? std::min(copy_vec(psym, ldk), copy_vec(pasym, ldk))
          : std::min(grouped::bf16_vec(psym, ldk),
                     grouped::bf16_vec(pasym, ldk));
  return grouped::launch(dir_grouped_kernel<P>, grid_of(gm, fc2, kg, split),
                         THREADS, SMEM, split, stream, (const float*)fsym,
                         (const float*)fasym, (const P*)psym, (const P*)pasym,
                         (float*)sym, (float*)asym, fc2, kg, ig, ldk, split,
                         dvec, vec);
}

template <typename P>
int shape(int gm, int fc2, int kg, int ig, int* info) {
  int split = 1;
  const int e = split_of<P>(gm, fc2, kg, ig, &split);
  if (e != 0) return e;
  return ect::launch_shape(dir_grouped_kernel<P>, grid_of(gm, fc2, kg, split),
                           THREADS, SMEM, info);
}

}  // namespace k6

namespace k5 {

using ect::add_compensated;
using ect::copy_tile;
using ect::copy_vec;
using ect::cp_async_commit;
using ect::cp_async_wait;
using ect::operand;
using ect::table_value;

constexpr int BR = 32;        // coefficient rows per block
constexpr int RT = 4;         // rows per thread, NRG apart
constexpr int TI = 64;        // latitudes per block
constexpr int LT = 8;         // latitudes per thread, NLG apart
constexpr int NRG = BR / RT;  // row groups
constexpr int NLG = TI / LT;  // latitude groups
constexpr int PTHREADS = NRG * NLG;      // 64 a parity
constexpr int THREADS = 2 * PTHREADS;    // 128
constexpr int MINB = 2;       // blocks an SM
constexpr int DK = 32;        // parity degrees per stage
constexpr int FOLD = 16;      // degrees per chunk partial
constexpr int LD = DK + 4;    // floats per shared row (16-byte multiple)
constexpr int PSTAGE = (BR + TI) * LD;   // floats per parity and stage
constexpr int STAGE = 2 * PSTAGE;        // floats per stage
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE * 4;   // bytes
constexpr int NQ = RT * LT / 4;          // float4s of a thread's tile
static_assert(NRG % 4 == 0 && NLG == 8, "warps of 4 row x 8 latitude groups");
static_assert(DK % FOLD == 0 && FOLD % 4 == 0, "");
static_assert(LD % 4 == 0 && (LD / 4) % 2 == 1,
              "rows of an odd count of float4s: 8 rows, 8 bank quads");
static_assert(2 * NQ * PTHREADS * 4 <= STAGES * STAGE,
              "both parities' outputs fit the ring");

// NR rows of DK floats from rows ld apart into rows LD apart (16-, 8- or
// 4-byte copies: vec = 4, 2, 1); PADDED: the rows reach past ncol
template <int NR, bool FULL, bool PADDED>
__device__ __forceinline__ void copy_rows(float* dst, const float* src,
                                          int ld, int nrow, int ncol,
                                          const float* base, int vec, int t) {
  auto same = [](float x) { return x; };
  if (vec == 4) {
    copy_tile<THREADS, float, 4, NR, DK, FULL, false, PADDED>(
        dst, LD, src, ld, nrow, ncol, base, same, t);
  } else if (vec == 2) {
    copy_tile<THREADS, float, 2, NR, DK, FULL, false, PADDED>(
        dst, LD, src, ld, nrow, ncol, base, same, t);
  } else {
    copy_tile<THREADS, float, 1, NR, DK, FULL, false, PADDED>(
        dst, LD, src, ld, nrow, ncol, base, same, t);
  }
}

// one stage, degrees k0 .. k0 + DK - 1, of both parities: the operand chunk
// xs[r][k] = x[row0 + r, k0 + k] (rows kg long; copies of xvec floats) and
// the table tile ps[i][k] = p[i0 + i, k0 + k] (rows ldk apart; pvec); the
// bf16-table variant rounds the operand to bf16 and widens the table (pvec
// entries a load), through registers
template <typename P, bool FULL>
__device__ __forceinline__ void fill_tiles(float* st, const float* sm,
                                           const float* am, const P* psm,
                                           const P* pam, int row0, int fc,
                                           int i0, int k0, int ig, int kg,
                                           int ldk, int xvec, int pvec) {
  const int nrow = fc - row0, nlat = ig - i0, ndeg = kg - k0;
  const int t = threadIdx.x;
#pragma unroll
  for (int par = 0; par < 2; ++par) {
    float* xs = st + par * PSTAGE;
    float* ps = xs + BR * LD;
    const float* xm = par ? am : sm;
    const P* pm = par ? pam : psm;
    const float* xsrc = xm + (size_t)row0 * kg + k0;
    const P* psrc = pm + (size_t)i0 * ldk + k0;
    if constexpr (!std::is_same<P, float>::value) {
      auto rnd = [](float x) { return operand<float, P>(x); };
      auto wide = [](P x) { return table_value(x); };
      copy_tile<THREADS, float, 1, BR, DK, FULL, true>(xs, LD, xsrc, kg, nrow,
                                                       ndeg, xm, rnd, t);
      if (pvec == 4) {
        copy_tile<THREADS, P, 4, TI, DK, FULL, true, true>(
            ps, LD, psrc, ldk, nlat, ndeg, pm, wide, t);
      } else {
        copy_tile<THREADS, P, 1, TI, DK, FULL, true, true>(
            ps, LD, psrc, ldk, nlat, ndeg, pm, wide, t);
      }
    } else {
      copy_rows<BR, FULL, false>(xs, xsrc, kg, nrow, ndeg, xm, xvec, t);
      copy_rows<TI, FULL, true>(ps, psrc, ldk, nlat, ndeg, pm, pvec, t);
    }
  }
}

template <typename P>
__device__ __forceinline__ void fill_stage(float* st, const float* sm,
                                           const float* am, const P* psm,
                                           const P* pam, int row0, int fc,
                                           int i0, int k0, int ig, int kg,
                                           int ldk, int xvec, int pvec) {
  if (row0 + BR <= fc && i0 + TI <= ig && k0 + DK <= kg) {
    fill_tiles<P, true>(st, sm, am, psm, pam, row0, fc, i0, k0, ig, kg, ldk,
                        xvec, pvec);
  } else {
    fill_tiles<P, false>(st, sm, am, psm, pam, row0, fc, i0, k0, ig, kg, ldk,
                         xvec, pvec);
  }
}

// north[m, r, i] = s + a, south[m, r, i] = s - a, s = sum_k sym[m, r, k]
// psym[m, i, k] (warps 0-1), a = sum_k asym[m, r, k] pasym[m, i, k] (warps
// 2-3); table rows ldk apart.  Block (latitude tile, m, row chunk); thread
// (ty: rows ty + NRG r, r < RT; tx: latitudes tx + NLG l, l < LT)
template <typename P>
__device__ __forceinline__ void inv_body(float* smem, const float* sym,
                                         const float* asym, const P* psym,
                                         const P* pasym, float* north,
                                         float* south, int fc, int kg, int ig,
                                         int ldk, int xvec, int pvec) {
  const int i0 = blockIdx.x * TI;
  const int m = blockIdx.y;
  const int row0 = blockIdx.z * BR;
  const int par = threadIdx.x / PTHREADS, pt = threadIdx.x % PTHREADS;
  const int lane = pt % 32, warp = pt / 32;
  const int ty = warp * 4 + lane / 8;
  const int tx = lane % 8;
  const size_t xo = (size_t)m * fc * kg, po = (size_t)m * ig * ldk;
  const float* sm = sym + xo;
  const float* am = asym + xo;
  const P* psm = psym + po;
  const P* pam = pasym + po;
  const int nstage = (kg + DK - 1) / DK;

  // compensated totals (tot, cmp); held adds a stage's two chunk partials
  float held[RT][LT], tot[RT][LT], cmp[RT][LT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int l = 0; l < LT; ++l) tot[r][l] = cmp[r][l] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nstage) {
      fill_stage<P>(smem + s * STAGE, sm, am, psm, pam, row0, fc, i0, s * DK,
                    ig, kg, ldk, xvec, pvec);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nstage; ++c) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage c landed
    __syncthreads();               // everyone's; and stage c - 1 is free
    if (c + STAGES - 1 < nstage) {
      fill_stage<P>(smem + (c + STAGES - 1) % STAGES * STAGE, sm, am, psm,
                    pam, row0, fc, i0, (c + STAGES - 1) * DK, ig, kg, ldk,
                    xvec, pvec);
    }
    cp_async_commit();

    const float* st = smem + c % STAGES * STAGE + par * PSTAGE;
    const float* xs = st + ty * LD;
    const float* ps = st + BR * LD + tx * LD;
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
  cp_async_wait<0>();

  // the s (par 0) and a (par 1) threads of the same outputs read each
  // other's sums through the ring; the s thread writes north = s + a, the a
  // thread south = s - a
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

template <typename P>
__global__ void __launch_bounds__(THREADS, MINB)
inv_grouped_kernel(const float* __restrict__ sym,
                   const float* __restrict__ asym, const P* __restrict__ psym,
                   const P* __restrict__ pasym, float* __restrict__ north,
                   float* __restrict__ south, int fc2, int kg, int ig,
                   int ldk, int xvec, int pvec) {
  extern __shared__ __align__(16) float smem[];
  inv_body<P>(smem, sym, asym, psym, pasym, north, south, fc2, kg, ig, ldk,
              xvec, pvec);
}

inline dim3 grid_of(int gm, int fc2, int ig) {
  return dim3((ig + TI - 1) / TI, gm, (fc2 + BR - 1) / BR);
}

template <typename P>
int launch(const void* sym, const void* asym, const void* psym,
           const void* pasym, void* north, void* south, int gm, int fc2,
           int kg, int ig, int ldk, void* stream) {
  const int xvec = std::min(copy_vec(sym, kg), copy_vec(asym, kg));
  const int pvec =
      std::is_same<P, float>::value
          ? std::min(copy_vec(psym, ldk), copy_vec(pasym, ldk))
          : std::min(grouped::bf16_vec(psym, ldk),
                     grouped::bf16_vec(pasym, ldk));
  return grouped::launch(inv_grouped_kernel<P>, grid_of(gm, fc2, ig), THREADS,
                         SMEM, 1, stream, (const float*)sym,
                         (const float*)asym, (const P*)psym, (const P*)pasym,
                         (float*)north, (float*)south, fc2, kg, ig, ldk, xvec,
                         pvec);
}

template <typename P>
int shape(int gm, int fc2, int kg, int ig, int* info) {
  return ect::launch_shape(inv_grouped_kernel<P>, grid_of(gm, fc2, ig),
                           THREADS, SMEM, info);
}

}  // namespace k5

// The fp64 variants of K5 and K6: the first port's template (32-row blocks
// of 256 threads, synchronous staging of 128-byte stages, one shared load of
// the operand per FMA, each stage's sum folded into a TwoSum total); table
// rows ldk apart.
namespace {

using ect::add_compensated;

constexpr int NY = 4;              // thread rows of a block
constexpr int RPT = 8;             // coefficient rows per thread
constexpr int ROWS = NY * RPT;     // rows per block; gridDim.z walks fc2
constexpr int TI = 64;             // K5: latitudes per block (threads in x)
constexpr int DK = 64;             // K6: parity degrees per block (threads in x)
constexpr int THREADS = 256;       // = TI * NY = DK * NY
constexpr int TK = 16;             // 128 bytes of one table row per stage

// north/south[m, r, i] = sum_k sym[m, r, k] psym[m, i, k] +- asym[m, r, k]
// pasym[m, i, k].  Block (i-tile, m, row chunk); thread (tx = latitude, ty =
// row phase).
__global__ void __launch_bounds__(THREADS)
inv_grouped_kernel(const double* __restrict__ sym,
                   const double* __restrict__ asym,
                   const double* __restrict__ psym,
                   const double* __restrict__ pasym,
                   double* __restrict__ north, double* __restrict__ south,
                   int fc2, int kg, int ig, int ldk) {
  __shared__ double ss[ROWS][TK];
  __shared__ double sa[ROWS][TK];
  __shared__ double ps[TI][TK + 1];
  __shared__ double pa[TI][TK + 1];
  const int m = blockIdx.y;
  const int i0 = blockIdx.x * TI;
  const int r0 = blockIdx.z * ROWS;
  const int tx = threadIdx.x % TI;
  const int ty = threadIdx.x / TI;
  const double* sm = sym + (size_t)m * fc2 * kg;
  const double* am = asym + (size_t)m * fc2 * kg;
  const double* psm = psym + (size_t)m * ig * ldk;
  const double* pam = pasym + (size_t)m * ig * ldk;

  double fs[RPT], fa[RPT], fsc[RPT], fac[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    fs[r] = 0; fa[r] = 0; fsc[r] = 0; fac[r] = 0;
  }

  for (int k0 = 0; k0 < kg; k0 += TK) {
    for (int e = threadIdx.x; e < ROWS * TK; e += THREADS) {
      const int r = e / TK, k = e % TK;
      const int row = r0 + r, kk = k0 + k;
      const bool ok = row < fc2 && kk < kg;
      ss[r][k] = ok ? sm[(size_t)row * kg + kk] : 0.0;
      sa[r][k] = ok ? am[(size_t)row * kg + kk] : 0.0;
    }
    for (int e = threadIdx.x; e < TI * TK; e += THREADS) {
      const int i = e / TK, k = e % TK;   // consecutive threads along k
      const int ii = i0 + i, kk = k0 + k;
      const bool ok = ii < ig && kk < kg;
      ps[i][k] = ok ? psm[(size_t)ii * ldk + kk] : 0.0;
      pa[i][k] = ok ? pam[(size_t)ii * ldk + kk] : 0.0;
    }
    __syncthreads();
    double s_part[RPT], a_part[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { s_part[r] = 0; a_part[r] = 0; }
#pragma unroll 4
    for (int k = 0; k < TK; ++k) {
      const double p = ps[tx][k];
      const double q = pa[tx][k];
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
      const double s = fs[r] + fsc[r], a = fa[r] + fac[r];
      north[o] = s + a;
      south[o] = s - a;
    }
  }
}

// sym[m, r, k] = sum_i fsym[m, r, i] psym[m, i, k], asym from fasym, pasym.
// Block (k-tile, m, row chunk); thread (tx = degree, ty = row phase).
__global__ void __launch_bounds__(THREADS)
dir_grouped_kernel(const double* __restrict__ fsym,
                   const double* __restrict__ fasym,
                   const double* __restrict__ psym,
                   const double* __restrict__ pasym,
                   double* __restrict__ sym, double* __restrict__ asym,
                   int fc2, int kg, int ig, int ldk) {
  constexpr int DI = TK;               // latitudes per stage
  __shared__ double sx[ROWS][DI];
  __shared__ double ax[ROWS][DI];
  __shared__ double ps[DI][DK];
  __shared__ double pa[DI][DK];
  const int m = blockIdx.y;
  const int k0 = blockIdx.x * DK;
  const int r0 = blockIdx.z * ROWS;
  const int tx = threadIdx.x % DK;
  const int ty = threadIdx.x / DK;
  const int k = k0 + tx;
  const double* fsm = fsym + (size_t)m * fc2 * ig;
  const double* fam = fasym + (size_t)m * fc2 * ig;
  const double* psm = psym + (size_t)m * ig * ldk;
  const double* pam = pasym + (size_t)m * ig * ldk;

  double s_acc[RPT], a_acc[RPT], s_c[RPT], a_c[RPT];
#pragma unroll
  for (int r = 0; r < RPT; ++r) {
    s_acc[r] = 0; a_acc[r] = 0; s_c[r] = 0; a_c[r] = 0;
  }

  for (int i0 = 0; i0 < ig; i0 += DI) {
    for (int e = threadIdx.x; e < ROWS * DI; e += THREADS) {
      const int r = e / DI, i = e % DI;
      const int row = r0 + r, ii = i0 + i;
      const bool ok = row < fc2 && ii < ig;
      sx[r][i] = ok ? fsm[(size_t)row * ig + ii] : 0.0;
      ax[r][i] = ok ? fam[(size_t)row * ig + ii] : 0.0;
    }
    for (int e = threadIdx.x; e < DI * DK; e += THREADS) {
      const int i = e / DK, kl = e % DK;  // consecutive threads along k
      const int ii = i0 + i, kk = k0 + kl;
      const bool ok = ii < ig && kk < kg;
      ps[i][kl] = ok ? psm[(size_t)ii * ldk + kk] : 0.0;
      pa[i][kl] = ok ? pam[(size_t)ii * ldk + kk] : 0.0;
    }
    __syncthreads();
    double s_part[RPT], a_part[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) { s_part[r] = 0; a_part[r] = 0; }
#pragma unroll 4
    for (int i = 0; i < DI; ++i) {
      const double p = ps[i][tx];
      const double q = pa[i][tx];
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

}  // namespace

extern "C" {
int ect_inv_grouped_f32(const void* sym, const void* asym, const void* psym,
                        const void* pasym, void* north, void* south, int gm,
                        int fc2, int kg, int ig, int ldk, void* stream) {
  return k5::launch<float>(sym, asym, psym, pasym, north, south, gm, fc2, kg,
                           ig, ldk, stream);
}
int ect_inv_grouped_bf16(const void* sym, const void* asym, const void* psym,
                         const void* pasym, void* north, void* south, int gm,
                         int fc2, int kg, int ig, int ldk, void* stream) {
  return k5::launch<ect::bf16>(sym, asym, psym, pasym, north, south, gm, fc2,
                               kg, ig, ldk, stream);
}
int ect_inv_grouped_f64(const void* sym, const void* asym, const void* psym,
                        const void* pasym, void* north, void* south, int gm,
                        int fc2, int kg, int ig, int ldk, void* stream) {
  dim3 grid((ig + TI - 1) / TI, gm, (fc2 + ROWS - 1) / ROWS);
  inv_grouped_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)sym, (const double*)asym, (const double*)psym,
      (const double*)pasym, (double*)north, (double*)south, fc2, kg, ig, ldk);
  return (int)cudaGetLastError();
}
int ect_dir_grouped_f32(const void* fsym, const void* fasym, const void* psym,
                        const void* pasym, void* sym, void* asym, int gm,
                        int fc2, int kg, int ig, int ldk, void* stream) {
  return k6::launch<float>(fsym, fasym, psym, pasym, sym, asym, gm, fc2, kg,
                           ig, ldk, stream);
}
int ect_dir_grouped_bf16(const void* fsym, const void* fasym,
                         const void* psym, const void* pasym, void* sym,
                         void* asym, int gm, int fc2, int kg, int ig,
                         int ldk, void* stream) {
  return k6::launch<ect::bf16>(fsym, fasym, psym, pasym, sym, asym, gm, fc2,
                               kg, ig, ldk, stream);
}
int ect_dir_grouped_f64(const void* fsym, const void* fasym, const void* psym,
                        const void* pasym, void* sym, void* asym, int gm,
                        int fc2, int kg, int ig, int ldk, void* stream) {
  dim3 grid((kg + DK - 1) / DK, gm, (fc2 + ROWS - 1) / ROWS);
  dir_grouped_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const double*)fsym, (const double*)fasym, (const double*)psym,
      (const double*)pasym, (double*)sym, (double*)asym, fc2, kg, ig, ldk);
  return (int)cudaGetLastError();
}
int ect_inv_grouped_shape_f32(int gm, int fc2, int kg, int ig, int* info) {
  return k5::shape<float>(gm, fc2, kg, ig, info);
}
int ect_inv_grouped_shape_bf16(int gm, int fc2, int kg, int ig, int* info) {
  return k5::shape<ect::bf16>(gm, fc2, kg, ig, info);
}
int ect_dir_grouped_shape_f32(int gm, int fc2, int kg, int ig, int* info) {
  return k6::shape<float>(gm, fc2, kg, ig, info);
}
int ect_dir_grouped_shape_bf16(int gm, int fc2, int kg, int ig, int* info) {
  return k6::shape<ect::bf16>(gm, fc2, kg, ig, info);
}
}  // extern "C"
