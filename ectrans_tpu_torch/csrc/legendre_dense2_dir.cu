// K8 and K2 for Hopper (sm_90a): the hemisphere-packed and the dense-row
// direct Legendre transforms, fp32 and on bf16 tables, from one pipelined
// kernel body.
//
// K8 replaces ectrans_tpu/ops/legendre_pallas.py group_dir_dense2
// (_dir_dense2_kernel).  One m-group's general product
//   out[m, r, j] = sum_i f4[m, r, i] pn[m, j, i],
// f4 (gm, fc4, ig), pn (gm, J, ig), out (gm, fc4, J), each contiguous: the
// reduction runs along the table's contiguous axis (K7, legendre_dense2.cu,
// is the same product with the reduction along its outer axis).  The dense
// engine stacks f4 = [fn ; fs] and combines out[:fc2] + out[fc2:] sgn(j),
// but the kernel does not rely on it.
//
// K2 replaces group_dir_dense (_dir_dense_kernel), the default "dense"
// engine's direct transform: weighted north and south rows fn, fs (gm, fc2,
// ig) and the same table give
//   out[m, r, j] = sum_i fn_i P_ji + (-1)^j sum_i fs_i P_ji
//               = sum_i (fn +- fs)[m, r, i] P_ji   (+ for even j),
// so each output takes one sum over s = fn + fs (even degrees) or d = fn -
// fs (odd ones): half K8's multiply-adds for the same table.
//
// Bounds.  K8: 2 fc4 J ig FLOP per group against 4 (J ig + fc4 ig + fc4 J)
// bytes.  At TCO1279 (fc4 = 40, sum over the 16 groups of gm J ig =
// 926,445,600) that is 7.41e10 FLOP, 1.106 ms at the data sheet's 67 TFLOP/s
// of fp32 FMA, against 4.04 GB, 1.205 ms at 3.35 TB/s: the kernel sits on
// the card's ridge, so it must stream the table well and keep the FMA pipes
// busy at once.  K2 (fc2 = 20) does 3.71e10 FLOP, 0.553 ms, against 3.97 GB,
// 1.184 ms: bytes-bound, on the 3.71 GB of fp32 table that both stream.
//
// Design, against what held back the first K8 and K2 (K2's template: 32-row
// blocks, so 64 rows computed for 40 (K2: 32 for 20) and K8's table tiles
// read twice; one shared load per FMA; synchronous transposed staging, no
// overlap):
// - a block holds the bench's 40 rows x 64 degrees (K2: its 20 rows x 128
//   degrees), so each table tile is read from device memory once and no row
//   computes zeros (more rows put further chunks on grid x, next to each
//   other, so they share the tile in L2);
// - a sub-block of 64 threads, each with a register tile of 5 rows x 8
//   degrees (rows ty + NRG r, degrees tx + NDG k: K8 8 row x 8 degree
//   groups, K2 4 x 16, so a K2 thread's degrees share tx's parity and it
//   reads s or d alone).  A step of 4 latitudes costs 5 + 8 16-byte shared
//   loads for 160 FMAs: 1.3 bytes of shared operand per FMA and lane (K7:
//   1.5).  The stage's rows are padded to 36 floats, so the 8 degree rows (4
//   row rows, K2: 4 rows of s and 4 of d) a warp reads at one latitude fall
//   in 8 (4, K2: 8) different bank quads;
// - a double-buffered ring per sub-block of stages of DI = 32 latitudes,
//   each the operand chunk (K8 40 rows of f4, K2 20 of fn and 20 of fs) and
//   the table tile, copied row-major as they lie in memory with cp.async
//   (cp_async.cuh, shared with K7 and K1), the next stage in flight while
//   this one is computed: one barrier a stage, a named one of the
//   sub-block's own (K2: two, with the pass that turns fn, fs into s, d in
//   place, in fp32, once a stage, between them: the template's rounding of
//   fn +- fs, and no extra pass over the operand in device memory);
// - compensated chunk sums, as in every Legendre kernel of the port
//   (legendre_common.cuh): each output sums FOLD = 16 latitudes in a
//   register, adds NCH such partials in plain fp32, and folds that into a
//   TwoSum total: K8 NCH = 4, a fold every 64 latitudes, K7's order; K2 NCH
//   = 2, a fold every stage of 32, as the template K2 folded, because the
//   bench round trip measured it so (K1 + K2 folding every 64 terms: 0.669
//   of the 100*eps gate, every 32: 0.492, for 3 % of K2's time; PERF.md).
//   tests/test_torch_k7_sums.py emulates these orders and the template K2's
//   in fp32 and holds K8's error on the combined rows, and K2's, within
//   1.5x the template's; one running fp32 sum, or torch.bmm, misses the gate
//   at TCO1279 by 3.3-4.2x (PERF.md).  The totals stay in registers: 254 a
//   thread, no spill;
// - the rounds' tail.  A launch of B blocks at 4 an SM runs in
//   ceil(B / (4 SMs)) rounds, and the last round of a group is often nearly
//   empty (K8 group 0: 1,680 blocks, 3.18 rounds of 528).  Where half-length
//   blocks take fewer rounds, a block is 2 sub-blocks of 64 threads that sum
//   the two halves of the latitude stages on rings of their own and add
//   their totals at the end by TwoSum, through shared memory; else 1.
//   Chosen per launch from the occupancy API; the emulation holds both
//   orders.
//
// Unaligned rows.  Operand and pn rows are all ig floats long, and ig % 4 ==
// 0 holds in only 4 of the 16 TCO1279 groups (0, 1, 9, 10).  So each tile is
// copied with 16-byte cp.async when ig % 4 == 0 and its base is 16-byte
// aligned, with 8-byte copies when ig is even (and the base 8-byte aligned),
// and with 4-byte copies otherwise, chosen per launch for the operand and
// the table.  Stages that reach past the rows, J or ig test each copy and
// zero-fill what lies outside; the others copy untested.  The bf16-table
// variants round the operand to bf16 and widen the table while staging, so
// they stage both tiles through registers into the same ring, as K7's does.
//
// Launch shape: 64 or 128 threads, 29,952 (K2: 48,384) bytes of shared
// memory a sub-block; __launch_bounds__(128, 2): 8 warps an SM, 4 blocks of
// 1 sub-block or 2 of 2.  A launch has gm ceil(J / 64) ceil(fc4 / 40) (K2:
// gm ceil(J / 128) ceil(fc2 / 20)) blocks: 160-1,680 (K2: 80-880) at
// TCO1279.  The fp64 variants (not on the benchmark path) stay on the
// template in legendre_dense.cu.

#include <algorithm>
#include <initializer_list>

#include "cp_async.cuh"
#include "legendre_common.cuh"

namespace k8 {

using ect::add_compensated;
using ect::bf16;
using ect::copy_tile;
using ect::copy_vec;
using ect::cp_async_commit;
using ect::cp_async_wait;
using ect::operand;
using ect::table_value;

constexpr int RT = 5;         // rows per thread, NRG apart
constexpr int JT = 8;         // degrees per thread, NDG apart
constexpr int SUB = 64;       // threads of a sub-block
constexpr int NSPLIT = 2;     // at most this many sub-blocks a block
constexpr int THREADS = SUB * NSPLIT;            // at most
constexpr int MINB = 2;       // blocks of THREADS an SM
constexpr int DI = 32;        // latitudes per stage
constexpr int STAGES = 2;
constexpr int FOLD = 16;      // latitudes per chunk partial
constexpr int LD = DI + 4;    // floats per shared row (16-byte multiple)
constexpr int NQ = RT * JT / 4;                  // float4s of a thread's tile
static_assert(DI % FOLD == 0 && FOLD % 4 == 0, "");
static_assert(JT % 4 == 0, "a thread's totals move as float4s of a row");
static_assert(LD % 4 == 0 && (LD / 4) % 2 == 1,
              "rows of an odd count of float4s: 8 rows, 8 bank quads");

// the block's tile: K8 (PAR false) or K2 (PAR true)
template <bool PAR>
struct Tile {
  static constexpr int BM = PAR ? 20 : 40;       // rows per block
  static constexpr int DJ = PAR ? 128 : 64;      // degrees per block
  static constexpr int NRG = BM / RT;            // row groups
  static constexpr int NDG = DJ / JT;            // degree groups
  static constexpr int NCH = PAR ? 2 : 4;        // partials per fold
  static constexpr int FOLD_STAGES = NCH * FOLD / DI;   // stages per fold
  static constexpr int FS = (PAR ? 2 : 1) * BM * LD;   // operand floats
  static constexpr int STAGE = FS + DJ * LD;     // floats per stage
  static constexpr int RING = STAGES * STAGE;    // floats per sub-block
  static constexpr int SMEM = RING * 4;          // bytes per sub-block
  static_assert(NRG * NDG == SUB && NRG % 4 == 0 && NDG % 8 == 0,
                "warps of 4 row x 8 degree groups");
  static_assert(!PAR || NDG % 2 == 0, "a thread's degrees share a parity");
  static_assert(FOLD_STAGES >= 1, "");
  static_assert(2 * NQ * SUB * 4 <= RING, "a sub-block's totals fit its ring");
};

// the named barrier of sub-block sub (0 is __syncthreads')
__device__ __forceinline__ void sub_sync(int sub) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(sub + 1), "n"(SUB) : "memory");
}

// one operand chunk, NR rows of latitudes i0 .. i0 + DI - 1, from rows of
// ig floats at src (the group's first row) to dst (16-, 8- or 4-byte
// copies: fvec = 4, 2, 1), by the sub-block's thread t; the bf16-table
// variant rounds it to bf16, through registers
template <int NR, typename P, bool FULL>
__device__ __forceinline__ void fill_rows(float* dst, const float* fm,
                                          int row0, int fc, int i0, int ig,
                                          int fvec, int t) {
  const float* src = fm + (size_t)row0 * ig + i0;
  const int nrow = fc - row0, nlat = ig - i0;
  if constexpr (!std::is_same<P, float>::value) {
    auto rnd = [](float x) { return operand<float, P>(x); };
    copy_tile<SUB, float, 1, NR, DI, FULL, true>(dst, LD, src, ig, nrow, nlat,
                                                 fm, rnd, t);
  } else {
    auto same = [](float x) { return x; };
    if (fvec == 4) {
      copy_tile<SUB, float, 4, NR, DI, FULL, false>(dst, LD, src, ig, nrow,
                                                    nlat, fm, same, t);
    } else if (fvec == 2) {
      copy_tile<SUB, float, 2, NR, DI, FULL, false>(dst, LD, src, ig, nrow,
                                                    nlat, fm, same, t);
    } else {
      copy_tile<SUB, float, 1, NR, DI, FULL, false>(dst, LD, src, ig, nrow,
                                                    nlat, fm, same, t);
    }
  }
}

// one stage, latitudes i0 .. i0 + DI - 1: the operand chunk fs[r][i] =
// f[row0 + r, i0 + i] (K2: then f2's rows) and the table tile ps[j][i] =
// pn[j0 + j, i0 + i] (copies of fvec, pvec = 4, 2, 1 floats), by the
// sub-block's thread t; the bf16-table variant widens the table through
// registers
template <bool PAR, typename P, bool FULL>
__device__ __forceinline__ void fill_tiles(float* st, const float* fm,
                                           const float* f2m, const P* pnm,
                                           int row0, int fc, int j0, int J,
                                           int i0, int ig, int fvec, int pvec,
                                           int t) {
  using T = Tile<PAR>;
  fill_rows<T::BM, P, FULL>(st, fm, row0, fc, i0, ig, fvec, t);
  if constexpr (PAR) {
    fill_rows<T::BM, P, FULL>(st + T::BM * LD, f2m, row0, fc, i0, ig, fvec,
                              t);
  }
  float* ps = st + T::FS;
  const P* psrc = pnm + (size_t)j0 * ig + i0;
  const int ndeg = J - j0, nlat = ig - i0;
  if constexpr (!std::is_same<P, float>::value) {
    auto wide = [](P x) { return table_value(x); };
    copy_tile<SUB, P, 1, T::DJ, DI, FULL, true>(ps, LD, psrc, ig, ndeg, nlat,
                                                pnm, wide, t);
  } else {
    auto same = [](float x) { return x; };
    if (pvec == 4) {
      copy_tile<SUB, float, 4, T::DJ, DI, FULL, false>(ps, LD, psrc, ig, ndeg,
                                                       nlat, pnm, same, t);
    } else if (pvec == 2) {
      copy_tile<SUB, float, 2, T::DJ, DI, FULL, false>(ps, LD, psrc, ig, ndeg,
                                                       nlat, pnm, same, t);
    } else {
      copy_tile<SUB, float, 1, T::DJ, DI, FULL, false>(ps, LD, psrc, ig, ndeg,
                                                       nlat, pnm, same, t);
    }
  }
}

template <bool PAR, typename P>
__device__ __forceinline__ void fill_stage(float* st, const float* fm,
                                           const float* f2m, const P* pnm,
                                           int row0, int fc, int j0, int J,
                                           int i0, int ig, int fvec, int pvec,
                                           int t) {
  using T = Tile<PAR>;
  if (row0 + T::BM <= fc && j0 + T::DJ <= J && i0 + DI <= ig) {
    fill_tiles<PAR, P, true>(st, fm, f2m, pnm, row0, fc, j0, J, i0, ig, fvec,
                             pvec, t);
  } else {
    fill_tiles<PAR, P, false>(st, fm, f2m, pnm, row0, fc, j0, J, i0, ig,
                              fvec, pvec, t);
  }
}

// K8 (PAR false): out[m, r, j] = sum_i f[m, r, i] pn[m, j, i], rows fc.
// K2 (PAR true): out[m, r, j] = sum_i (f +- f2)[m, r, i] pn[m, j, i], + for
// even j.  Block (row chunk, degree tile, m) of blockDim.x / SUB
// sub-blocks; sub-block sub sums stages [c0, c1) of the latitudes; thread
// (ty: rows ty + NRG r, r < RT; tx: degrees tx + NDG k, k < JT)
template <bool PAR, typename P>
__device__ __forceinline__ void dir_body(float* smem, const float* f,
                                         const float* f2, const P* pn,
                                         float* out, int fc, int J, int ig,
                                         int fvec, int pvec) {
  using T = Tile<PAR>;
  const int row0 = blockIdx.x * T::BM;
  const int j0 = blockIdx.y * T::DJ;
  const int m = blockIdx.z;
  const int nsplit = blockDim.x / SUB;
  const int sub = threadIdx.x / SUB, t = threadIdx.x % SUB;
  const int lane = t % 32, warp = t / 32;
  // K8: the 2 warps split the row groups; K2: the degree groups
  const int ty = (PAR ? 0 : warp * 4) + lane / 8;
  const int tx = (PAR ? warp * 8 : 0) + lane % 8;
  // K2: the operand rows of this thread's degree parity, s or d
  const int par = PAR ? tx % 2 : 0;
  const float* fm = f + (size_t)m * fc * ig;
  const float* f2m = PAR ? f2 + (size_t)m * fc * ig : nullptr;
  const P* pnm = pn + (size_t)m * J * ig;
  float* ring = smem + sub * T::RING;
  const int nstage = (ig + DI - 1) / DI;
  const int c0 = sub * nstage / nsplit, c1 = (sub + 1) * nstage / nsplit;

  // compensated totals (tot, cmp); held collects the chunk partials of
  // T::FOLD_STAGES stages between folds
  float held[RT][JT], tot[RT][JT], cmp[RT][JT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int k = 0; k < JT; ++k) held[r][k] = tot[r][k] = cmp[r][k] = 0.f;
  }
  auto fold_held = [&]() {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
#pragma unroll
      for (int k = 0; k < JT; ++k) {
        add_compensated(tot[r][k], cmp[r][k], held[r][k]);
        held[r][k] = 0.f;
      }
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (c0 + s < c1) {
      fill_stage<PAR, P>(ring + s * T::STAGE, fm, f2m, pnm, row0, fc, j0, J,
                         (c0 + s) * DI, ig, fvec, pvec, t);
    }
    cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage c landed
    sub_sync(sub);                 // everyone's; and stage c - 1 is free
    if (c + STAGES - 1 < c1) {
      fill_stage<PAR, P>(ring + (c - c0 + STAGES - 1) % STAGES * T::STAGE,
                         fm, f2m, pnm, row0, fc, j0, J,
                         (c + STAGES - 1) * DI, ig, fvec, pvec, t);
    }
    cp_async_commit();

    float* st = ring + (c - c0) % STAGES * T::STAGE;
    if constexpr (PAR) {
      // s = fn + fs and d = fn - fs in place of fn and fs, in fp32
      float* fa = st;
      float* fb = st + T::BM * LD;
      for (int e = t; e < T::BM * DI / 4; e += SUB) {
        const int o = e / (DI / 4) * LD + e % (DI / 4) * 4;
        const float4 a = *reinterpret_cast<const float4*>(fa + o);
        const float4 b = *reinterpret_cast<const float4*>(fb + o);
        *reinterpret_cast<float4*>(fa + o) =
            make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
        *reinterpret_cast<float4*>(fb + o) =
            make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
      }
      sub_sync(sub);
    }
    const float* fs = st + par * T::BM * LD + ty * LD;
    const float* ps = st + T::FS + tx * LD;
#pragma unroll
    for (int h = 0; h < DI; h += FOLD) {
      // the chunk partial over latitudes h .. h + FOLD - 1 of this stage
      float part[RT][JT];
#pragma unroll
      for (int q = 0; q < FOLD; q += 4) {
        float4 a[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          a[r] = *reinterpret_cast<const float4*>(fs + r * T::NRG * LD + h +
                                                  q);
        }
#pragma unroll
        for (int k = 0; k < JT; ++k) {
          const float4 b =
              *reinterpret_cast<const float4*>(ps + k * T::NDG * LD + h + q);
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            float p = q == 0 ? a[r].x * b.x : fmaf(a[r].x, b.x, part[r][k]);
            p = fmaf(a[r].y, b.y, p);
            p = fmaf(a[r].z, b.z, p);
            part[r][k] = fmaf(a[r].w, b.w, p);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int k = 0; k < JT; ++k) held[r][k] += part[r][k];
      }
    }
    if ((c - c0 + 1) % T::FOLD_STAGES == 0) fold_held();
  }
  if ((c1 - c0) % T::FOLD_STAGES != 0) fold_held();
  cp_async_wait<0>();

  // the sub-blocks' totals meet in sub-block 0, through the rings: each
  // later total is added to sub-block 0's by TwoSum, its compensation plainly
  __syncthreads();
  if (sub > 0) {
    float4* ts = reinterpret_cast<float4*>(ring) + t;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int r = 4 * q / JT, k = 4 * q % JT;
      ts[q * SUB] = make_float4(tot[r][k], tot[r][k + 1], tot[r][k + 2],
                                tot[r][k + 3]);
      ts[(NQ + q) * SUB] = make_float4(cmp[r][k], cmp[r][k + 1],
                                       cmp[r][k + 2], cmp[r][k + 3]);
    }
  }
  __syncthreads();
  if (sub > 0) return;
#pragma unroll 1
  for (int s = 1; s < nsplit; ++s) {
    const float4* ts = reinterpret_cast<const float4*>(smem + s * T::RING) + t;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int r = 4 * q / JT, k = 4 * q % JT;
      const float4 t4 = ts[q * SUB], c4 = ts[(NQ + q) * SUB];
      const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        add_compensated(tot[r][k + e], cmp[r][k + e], tv[e]);
        cmp[r][k + e] += cv[e];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int k = 0; k < JT; ++k) {
      const int row = row0 + ty + T::NRG * r;
      const int j = j0 + tx + T::NDG * k;
      if (row < fc && j < J) {
        out[((size_t)m * fc + row) * J + j] = tot[r][k] + cmp[r][k];
      }
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(THREADS, MINB)
dir_dense2_kernel(const float* __restrict__ f4, const P* __restrict__ pn,
                  float* __restrict__ out, int fc4, int J, int ig, int fvec,
                  int pvec) {
  extern __shared__ __align__(16) float smem[];
  dir_body<false, P>(smem, f4, nullptr, pn, out, fc4, J, ig, fvec, pvec);
}

template <bool PAR>
dim3 grid_of(int gm, int rows, int J) {
  using T = Tile<PAR>;
  return dim3((rows + T::BM - 1) / T::BM, (J + T::DJ - 1) / T::DJ, gm);
}

// sub-blocks a block for this launch: 2 where the half-length blocks take
// fewer rounds of the card's resident slots (ect::resident_slots) than the
// whole ones (the rounds' tail), else 1; a block of 2 sub-blocks takes the
// slots of 2
template <bool PAR, auto KERNEL>
int split_of(dim3 grid, int* split) {
  long slots = 0;
  *split = 1;
  const int e = ect::resident_slots<KERNEL>(SUB, Tile<PAR>::SMEM, &slots);
  if (e != 0) return e;
  if (slots > 0) {
    const long blocks = (long)grid.x * grid.y * grid.z;
    const long whole = (blocks + slots - 1) / slots;         // rounds
    const long halves = (2L * blocks + slots - 1) / slots;   // half rounds
    if (halves < 2 * whole) *split = NSPLIT;
  }
  return 0;
}

// launch K8 (operands f4) or K2 (fn, fs): the C entries' common part
template <bool PAR, typename P, auto KERNEL, typename... Ops>
int launch(const void* pn, void* out, int gm, int rows, int J, int ig,
           void* stream, Ops... ops) {
  const dim3 grid = grid_of<PAR>(gm, rows, J);
  int split = 1;
  cudaError_t e = (cudaError_t)split_of<PAR, KERNEL>(grid, &split);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(KERNEL,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             split * Tile<PAR>::SMEM);
  }
  if (e != cudaSuccess) return (int)e;
  int fvec = 4;
  for (const void* op : {ops...}) fvec = std::min(fvec, copy_vec(op, ig));
  KERNEL<<<grid, split * SUB, split * Tile<PAR>::SMEM,
           (cudaStream_t)stream>>>(static_cast<const float*>(ops)...,
                                   (const P*)pn, (float*)out, rows, J, ig,
                                   fvec, copy_vec(pn, ig));
  return (int)cudaGetLastError();
}

template <bool PAR, auto KERNEL>
int shape(int gm, int rows, int J, int* info) {
  const dim3 grid = grid_of<PAR>(gm, rows, J);
  int split = 1;
  const int e = split_of<PAR, KERNEL>(grid, &split);
  if (e != 0) return e;
  return ect::launch_shape(KERNEL, grid, split * SUB,
                           split * Tile<PAR>::SMEM, info);
}

}  // namespace k8

namespace k2 {

// K2: rows out_j = sum_i (fn +- fs)_i P_ji, K8's body in parity mode
template <typename P>
__global__ void __launch_bounds__(k8::THREADS, k8::MINB)
dir_dense_kernel(const float* __restrict__ fn, const float* __restrict__ fs,
                 const P* __restrict__ pn, float* __restrict__ out, int fc2,
                 int J, int ig, int fvec, int pvec) {
  extern __shared__ __align__(16) float smem[];
  k8::dir_body<true, P>(smem, fn, fs, pn, out, fc2, J, ig, fvec, pvec);
}

}  // namespace k2

extern "C" {
int ect_dir_dense2_f32(const void* f4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return k8::launch<false, float, &k8::dir_dense2_kernel<float>>(
      pn, out, gm, fc4, J, ig, stream, f4);
}
int ect_dir_dense2_bf16(const void* f4, const void* pn, void* out, int gm,
                        int fc4, int J, int ig, void* stream) {
  return k8::launch<false, ect::bf16, &k8::dir_dense2_kernel<ect::bf16>>(
      pn, out, gm, fc4, J, ig, stream, f4);
}
int ect_dir_dense2_shape_f32(int gm, int fc4, int J, int* info) {
  return k8::shape<false, &k8::dir_dense2_kernel<float>>(gm, fc4, J, info);
}
int ect_dir_dense2_shape_bf16(int gm, int fc4, int J, int* info) {
  return k8::shape<false, &k8::dir_dense2_kernel<ect::bf16>>(gm, fc4, J,
                                                             info);
}
int ect_dir_dense_f32(const void* fn, const void* fs, const void* pn,
                      void* out, int gm, int fc2, int J, int ig,
                      void* stream) {
  return k8::launch<true, float, &k2::dir_dense_kernel<float>>(
      pn, out, gm, fc2, J, ig, stream, fn, fs);
}
int ect_dir_dense_bf16(const void* fn, const void* fs, const void* pn,
                       void* out, int gm, int fc2, int J, int ig,
                       void* stream) {
  return k8::launch<true, ect::bf16, &k2::dir_dense_kernel<ect::bf16>>(
      pn, out, gm, fc2, J, ig, stream, fn, fs);
}
int ect_dir_dense_shape_f32(int gm, int fc2, int J, int* info) {
  return k8::shape<true, &k2::dir_dense_kernel<float>>(gm, fc2, J, info);
}
int ect_dir_dense_shape_bf16(int gm, int fc2, int J, int* info) {
  return k8::shape<true, &k2::dir_dense_kernel<ect::bf16>>(gm, fc2, J, info);
}
}  // extern "C"
