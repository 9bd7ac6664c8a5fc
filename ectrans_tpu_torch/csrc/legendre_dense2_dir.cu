// K8 for Hopper (sm_90a): the hemisphere-packed direct Legendre transform,
// fp32 and on bf16 tables.
//
// Replaces ectrans_tpu/ops/legendre_pallas.py group_dir_dense2
// (_dir_dense2_kernel).  One m-group's general product
//   out[m, r, j] = sum_i f4[m, r, i] pn[m, j, i],
// f4 (gm, fc4, ig), pn (gm, J, ig), out (gm, fc4, J), each contiguous: the
// reduction runs along the table's contiguous axis (K7, legendre_dense2.cu,
// is the same product with the reduction along its outer axis).  The dense
// engine stacks f4 = [fn ; fs] and combines out[:fc2] + out[fc2:] sgn(j),
// but the kernel does not rely on it.
//
// Bound: 2 fc4 J ig FLOP per group against 4 (J ig + fc4 ig + fc4 J)
// bytes.  At TCO1279 (fc4 = 40, sum over the 16 groups of gm J ig =
// 926,445,600) that is 7.41e10 FLOP, 1.106 ms at the data sheet's 67 TFLOP/s
// of fp32 FMA, against 4.04 GB, 1.205 ms at 3.35 TB/s: the kernel sits on
// the card's ridge, so it must stream the table well and keep the FMA pipes
// busy at once.
//
// Design, against what held back the first K8 (K2's template: 32-row blocks,
// so 64 rows computed for 40 and each table tile read twice; one shared load
// per FMA; synchronous transposed staging, no overlap):
// - a block holds the bench's 40 rows x 64 degrees, so each table tile is
//   read from device memory once and feeds 40 FMAs an element (fc4 > 40 puts
//   further 40-row chunks on grid x, next to each other, so they share the
//   tile in L2);
// - a sub-block of 64 threads, each with a register tile of 5 rows x 8
//   degrees (rows ty + 8 r, degrees tx + 8 k).  A step of 4 latitudes costs
//   5 + 8 16-byte shared loads for 160 FMAs: 1.3 bytes of shared operand per
//   FMA and lane (K7: 1.5).  The stage's rows are padded to 36 floats, so the
//   8 degree rows (4 row rows) a warp reads at one latitude fall in 8 (4)
//   different bank quads;
// - a double-buffered ring per sub-block of stages of DI = 32 latitudes,
//   each the f4 chunk (40 rows) and the table tile (64 degrees), both copied
//   row-major as they lie in memory with cp.async (cp_async.cuh, shared with
//   K7), the next stage in flight while this one is computed: one barrier
//   a stage, a named one of the sub-block's own;
// - compensated chunk sums, as in every Legendre kernel of the port
//   (legendre_common.cuh): each output sums FOLD = 16 latitudes in a
//   register, adds 4 such partials in plain fp32, and folds that into a
//   TwoSum total every 64 latitudes, K7's order.  tests/test_torch_k7_sums.py
//   emulates this order and K2's in fp32 and holds K8's error on the
//   combined rows within 1.5x K2's; one running fp32 sum, or torch.bmm,
//   misses the 100*eps round-trip gate at TCO1279 by 3.3-4.2x (PERF.md).
//   The totals stay in registers: 254 a thread, no spill;
// - the rounds' tail.  A launch of B blocks at 4 an SM runs in
//   ceil(B / (4 SMs)) rounds, and the last round of a group is often nearly
//   empty (group 0: 1,680 blocks, 3.18 rounds of 528).  Where half-length
//   blocks take fewer rounds, a block is 2 sub-blocks of 64 threads that sum
//   the two halves of the latitude stages on rings of their own and add
//   their totals at the end by TwoSum, through shared memory (groups 0, 4,
//   5, 9-11, 14 and 15 at TCO1279); else 1.  Chosen per launch from the
//   occupancy API; the emulation holds both orders.
//
// Unaligned rows.  f4 and pn rows are both ig floats long, and ig % 4 == 0
// holds in only 4 of the 16 TCO1279 groups (0, 1, 9, 10).  So each tile is
// copied with 16-byte cp.async when ig % 4 == 0 and its base is 16-byte
// aligned, with 8-byte copies when ig is even (and the base 8-byte aligned),
// and with 4-byte copies otherwise, chosen per launch and per operand.
// Stages that reach past fc4, J or ig test each copy and zero-fill what lies
// outside; the others copy untested.  The bf16-table variant rounds f4 to
// bf16 and widens the table while staging, so it stages both tiles through
// registers into the same ring, as K7's does.
//
// Launch shape: 64 or 128 threads, 29,952 bytes of shared memory a
// sub-block; __launch_bounds__(128, 2): 8 warps an SM, 4 blocks of 1
// sub-block or 2 of 2.  A launch has gm ceil(J / 64) ceil(fc4 / 40) blocks:
// 160-1,680 at TCO1279.  The fp64 variant (not on the benchmark path) stays
// on K2's template in legendre_dense.cu.

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

constexpr int BM = 40;        // rows per block
constexpr int DJ = 64;        // degrees per block
constexpr int RT = 5;         // rows per thread, NRG apart
constexpr int JT = 8;         // degrees per thread, NDG apart
constexpr int NRG = BM / RT;  // row groups
constexpr int NDG = DJ / JT;  // degree groups
constexpr int SUB = NRG * NDG;                   // threads of a sub-block
constexpr int NSPLIT = 2;     // at most this many sub-blocks a block
constexpr int THREADS = SUB * NSPLIT;            // at most
constexpr int MINB = 2;       // blocks of THREADS an SM
constexpr int DI = 32;        // latitudes per stage
constexpr int STAGES = 2;
constexpr int FOLD = 16;      // latitudes per chunk partial
constexpr int NCH = 4;        // chunk partials per compensated fold
constexpr int FOLD_STAGES = NCH * FOLD / DI;
constexpr int LD = DI + 4;    // floats per shared row (16-byte multiple)
constexpr int FS = BM * LD;   // f4 chunk floats per stage
constexpr int STAGE = (BM + DJ) * LD;            // floats per stage
constexpr int RING = STAGES * STAGE;             // floats per sub-block
constexpr int NQ = RT * JT / 4;                  // float4s of a thread's tile
constexpr int SMEM = RING * 4;                   // bytes per sub-block
static_assert(NRG == 8 && NDG == 8, "2 warps of 4 row x 8 degree groups");
static_assert(DI % FOLD == 0 && FOLD % 4 == 0 && FOLD_STAGES >= 1, "");
static_assert(JT % 4 == 0, "a thread's totals move as float4s of a row");
static_assert(LD % 4 == 0 && (LD / 4) % 2 == 1,
              "rows of an odd count of float4s: 8 rows, 8 bank quads");
static_assert(2 * NQ * SUB * 4 <= RING, "a sub-block's totals fit its ring");

// the named barrier of sub-block sub (0 is __syncthreads')
__device__ __forceinline__ void sub_sync(int sub) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(sub + 1), "n"(SUB) : "memory");
}

// one stage, latitudes i0 .. i0 + DI - 1: the f4 chunk fs[r][i] =
// f4[row0 + r, i0 + i] and the table tile ps[j][i] = pn[j0 + j, i0 + i]
// (16-, 8- or 4-byte copies: fvec, pvec = 4, 2, 1), by the sub-block's
// thread t; the bf16-table variant rounds the f4 chunk to bf16 and widens
// the table, through registers
template <typename P, bool FULL>
__device__ __forceinline__ void fill_tiles(float* st, const float* f4m,
                                           const P* pnm, int row0, int fc4,
                                           int j0, int J, int i0, int ig,
                                           int fvec, int pvec, int t) {
  float* fs = st;
  float* ps = st + FS;
  const float* fsrc = f4m + (size_t)row0 * ig + i0;
  const P* psrc = pnm + (size_t)j0 * ig + i0;
  const int nrow = fc4 - row0, ndeg = J - j0, nlat = ig - i0;
  if constexpr (!std::is_same<P, float>::value) {
    auto rnd = [](float x) { return operand<float, P>(x); };
    auto wide = [](P x) { return table_value(x); };
    copy_tile<SUB, float, 1, BM, DI, FULL, true>(fs, LD, fsrc, ig, nrow, nlat,
                                                 f4m, rnd, t);
    copy_tile<SUB, P, 1, DJ, DI, FULL, true>(ps, LD, psrc, ig, ndeg, nlat, pnm,
                                             wide, t);
  } else {
    auto same = [](float x) { return x; };
    if (fvec == 4) {
      copy_tile<SUB, float, 4, BM, DI, FULL, false>(fs, LD, fsrc, ig, nrow,
                                                    nlat, f4m, same, t);
    } else if (fvec == 2) {
      copy_tile<SUB, float, 2, BM, DI, FULL, false>(fs, LD, fsrc, ig, nrow,
                                                    nlat, f4m, same, t);
    } else {
      copy_tile<SUB, float, 1, BM, DI, FULL, false>(fs, LD, fsrc, ig, nrow,
                                                    nlat, f4m, same, t);
    }
    if (pvec == 4) {
      copy_tile<SUB, float, 4, DJ, DI, FULL, false>(ps, LD, psrc, ig, ndeg,
                                                    nlat, pnm, same, t);
    } else if (pvec == 2) {
      copy_tile<SUB, float, 2, DJ, DI, FULL, false>(ps, LD, psrc, ig, ndeg,
                                                    nlat, pnm, same, t);
    } else {
      copy_tile<SUB, float, 1, DJ, DI, FULL, false>(ps, LD, psrc, ig, ndeg,
                                                    nlat, pnm, same, t);
    }
  }
}

template <typename P>
__device__ __forceinline__ void fill_stage(float* st, const float* f4m,
                                           const P* pnm, int row0, int fc4,
                                           int j0, int J, int i0, int ig,
                                           int fvec, int pvec, int t) {
  if (row0 + BM <= fc4 && j0 + DJ <= J && i0 + DI <= ig) {
    fill_tiles<P, true>(st, f4m, pnm, row0, fc4, j0, J, i0, ig, fvec, pvec, t);
  } else {
    fill_tiles<P, false>(st, f4m, pnm, row0, fc4, j0, J, i0, ig, fvec, pvec,
                         t);
  }
}

// out[m, r, j] = sum_i f4[m, r, i] pn[m, j, i]; block (row chunk, degree
// tile, m) of blockDim.x / SUB sub-blocks; sub-block sub sums stages
// [c0, c1) of the latitudes; thread (ty: rows ty + NRG r, r < RT; tx:
// degrees tx + NDG k, k < JT)
template <typename P>
__global__ void __launch_bounds__(THREADS, MINB)
dir_dense2_kernel(const float* __restrict__ f4, const P* __restrict__ pn,
                  float* __restrict__ out, int fc4, int J, int ig, int fvec,
                  int pvec) {
  extern __shared__ __align__(16) float smem[];
  const int row0 = blockIdx.x * BM;
  const int j0 = blockIdx.y * DJ;
  const int m = blockIdx.z;
  const int nsplit = blockDim.x / SUB;
  const int sub = threadIdx.x / SUB, t = threadIdx.x % SUB;
  const int lane = t % 32, warp = t / 32;
  const int ty = warp * 4 + lane / 8;
  const int tx = lane % 8;
  const float* f4m = f4 + (size_t)m * fc4 * ig;
  const P* pnm = pn + (size_t)m * J * ig;
  float* ring = smem + sub * RING;
  const int nstage = (ig + DI - 1) / DI;
  const int c0 = sub * nstage / nsplit, c1 = (sub + 1) * nstage / nsplit;

  // compensated totals (tot, cmp); held collects NCH chunk partials,
  // FOLD_STAGES stages, between folds
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
      fill_stage<P>(ring + s * STAGE, f4m, pnm, row0, fc4, j0, J,
                    (c0 + s) * DI, ig, fvec, pvec, t);
    }
    cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of stage c landed
    sub_sync(sub);                 // everyone's; and stage c - 1 is free
    if (c + STAGES - 1 < c1) {
      fill_stage<P>(ring + (c - c0 + STAGES - 1) % STAGES * STAGE, f4m, pnm,
                    row0, fc4, j0, J, (c + STAGES - 1) * DI, ig, fvec, pvec,
                    t);
    }
    cp_async_commit();

    const float* fs = ring + (c - c0) % STAGES * STAGE + ty * LD;
    const float* ps = ring + (c - c0) % STAGES * STAGE + FS + tx * LD;
#pragma unroll
    for (int h = 0; h < DI; h += FOLD) {
      // the chunk partial over latitudes h .. h + FOLD - 1 of this stage
      float part[RT][JT];
#pragma unroll
      for (int q = 0; q < FOLD; q += 4) {
        float4 a[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          a[r] = *reinterpret_cast<const float4*>(fs + r * NRG * LD + h + q);
        }
#pragma unroll
        for (int k = 0; k < JT; ++k) {
          const float4 b =
              *reinterpret_cast<const float4*>(ps + k * NDG * LD + h + q);
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
    if ((c - c0 + 1) % FOLD_STAGES == 0) fold_held();
  }
  if ((c1 - c0) % FOLD_STAGES != 0) fold_held();
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
    const float4* ts = reinterpret_cast<const float4*>(smem + s * RING) + t;
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
      const int row = row0 + ty + NRG * r;
      const int j = j0 + tx + NDG * k;
      if (row < fc4 && j < J) {
        out[((size_t)m * fc4 + row) * J + j] = tot[r][k] + cmp[r][k];
      }
    }
  }
}

inline dim3 grid_of(int gm, int fc4, int J) {
  return dim3((fc4 + BM - 1) / BM, (J + DJ - 1) / DJ, gm);
}

// sub-blocks a block for this launch: 2 where the half-length blocks take
// fewer rounds of the card's resident slots than the whole ones (the
// rounds' tail), else 1; a block of 2 sub-blocks takes the slots of 2
template <typename P>
int split_of(dim3 grid, int* split) {
  int info[5];
  const int e = ect::launch_shape(dir_dense2_kernel<P>, grid, SUB, SMEM, info);
  const long slots = (long)info[3] * info[4];
  *split = 1;
  if (e == 0 && slots > 0) {
    const long whole = (info[0] + slots - 1) / slots;         // rounds
    const long halves = (2L * info[0] + slots - 1) / slots;   // half rounds
    if (halves < 2 * whole) *split = NSPLIT;
  }
  return e;
}

template <typename P>
int launch(const void* f4, const void* pn, void* out, int gm, int fc4, int J,
           int ig, void* stream) {
  const dim3 grid = grid_of(gm, fc4, J);
  int split = 1;
  cudaError_t e = (cudaError_t)split_of<P>(grid, &split);
  if (e == cudaSuccess) {
    e = cudaFuncSetAttribute(dir_dense2_kernel<P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             split * SMEM);
  }
  if (e != cudaSuccess) return (int)e;
  dir_dense2_kernel<P>
      <<<grid, split * SUB, split * SMEM, (cudaStream_t)stream>>>(
          (const float*)f4, (const P*)pn, (float*)out, fc4, J, ig,
          copy_vec(f4, ig), copy_vec(pn, ig));
  return (int)cudaGetLastError();
}

template <typename P>
int shape(int gm, int fc4, int J, int* info) {
  const dim3 grid = grid_of(gm, fc4, J);
  int split = 1;
  const int e = split_of<P>(grid, &split);
  if (e != 0) return e;
  return ect::launch_shape(dir_dense2_kernel<P>, grid, split * SUB,
                           split * SMEM, info);
}

}  // namespace k8

extern "C" {
int ect_dir_dense2_f32(const void* f4, const void* pn, void* out, int gm,
                       int fc4, int J, int ig, void* stream) {
  return k8::launch<float>(f4, pn, out, gm, fc4, J, ig, stream);
}
int ect_dir_dense2_bf16(const void* f4, const void* pn, void* out, int gm,
                        int fc4, int J, int ig, void* stream) {
  return k8::launch<ect::bf16>(f4, pn, out, gm, fc4, J, ig, stream);
}
int ect_dir_dense2_shape_f32(int gm, int fc4, int J, int* info) {
  return k8::shape<float>(gm, fc4, J, info);
}
int ect_dir_dense2_shape_bf16(int gm, int fc4, int J, int* info) {
  return k8::shape<ect::bf16>(gm, fc4, J, info);
}
}  // extern "C"
