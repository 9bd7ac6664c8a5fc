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
// The stage sums of both bodies, K5's combine and K6's latitude split live in
// parity_body.cuh, where K9 and K10 (legendre_planes.cu) share them.
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

#include <algorithm>

#include "cp_async.cuh"
#include "parity_body.cuh"

namespace grouped {

// the widest copy, in entries, of a bf16 table whose rows of ld entries
// start at ptr: 4 (one 8-byte load) where every row is 8-byte aligned
inline int bf16_vec(const void* ptr, int ld) {
  return reinterpret_cast<uintptr_t>(ptr) % 8 == 0 && ld % 4 == 0 ? 4 : 1;
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

using namespace dir_form;

constexpr int MINB = 4;       // blocks an SM
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE * 4;   // bytes

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

  float tot[RT][KT], cmp[RT][KT];   // compensated totals
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

    stage_sums(smem + (c - c0) % STAGES * STAGE + par * PSTAGE, ty, tx, tot,
               cmp);
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

using namespace inv_form;

constexpr int MINB = 2;       // blocks an SM
constexpr int STAGES = 2;
constexpr int SMEM = STAGES * STAGE * 4;   // bytes

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

  float tot[RT][LT], cmp[RT][LT];   // compensated totals
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

    stage_sums(smem + c % STAGES * STAGE + par * PSTAGE, ty, tx, tot, cmp);
  }
  cp_async_wait<0>();

  inv_form::store(smem, tot, cmp, par, pt, ty, tx, m, row0, i0, fc, ig, north,
                  south);
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
