// K9 and K10 for Hopper (sm_90a): the bf16 limb-plane Legendre transforms
// of the "planes" engine, each a pipelined kernel on the parity-split body
// of K5 (K9) or K6 (K10), parity_body.cuh.
//
// K9 replaces ectrans_tpu/ops/legendre_planes.py group_inv_planes
// (_inv_kernel); K10 replaces group_dir_planes (_dir_kernel).  The table of
// one m-group is stored as P bf16 limb planes (P = 3 for the fp32-accurate
// tiers, 1 for the "bf16" tier) in the transposed layout plane_k[m, i, j]
// = limb k of Pbar_{m+j}^m(mu_i), each (gm, ig, J) with j contiguous, rows
// ld entries apart.  The operands come split into limbs the same way:
//   K9:  a = packed rows [x_0; x_0 sgn; x_1; x_1 sgn; ...] (gm, 2 P fc2, J)
//        north[r, i] = sum_j x[r, j] p[i, j] = E + O
//        south[r, i] = sum_j (-1)^j x[r, j] p[i, j] = E - O
//        (E over even j, O over odd j; the sign rows are not read)
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
// per term instead of six.  K10 pre-combines gn +- gs in fp32, as K2 does.
//
// Bounds.  Each table entry is read once (2P bytes) and feeds fc2 FMAs of
// its parity, after P - 1 adds of its planes.  At TCO1279 (926e6 entries,
// fc2 32 inverse, 20 direct) P = 3 reads 5.56 GB of planes: K9 1.85 ms and
// K10 1.77 ms by bytes (operands and outputs included) against 0.91 and
// 0.58 ms of FLOP at 67 TFLOP/s of fp32 FMA; at P = 1 the planes are 1.85
// GB, and K9 is FLOP-bound (0.89 ms), K10 about even (chip_smoke.py prints
// both terms of each bound).
//
// What held back the first kernels (the port's first design, one template
// for both): 256-thread blocks; synchronous scalar 2-byte loads, P of them
// per table entry, summed into the shared tile; two barriers a stage and no
// copy in flight while the block computed; a 1-row x 8 register tile that
// read one shared operand per FMA; and one 32-term chain a stage folded by
// TwoSum.
//
// Design: each kernel stages a stage of raw bf16 rows (the P planes' tiles
// and the operand's limb rows) with 16-byte cp.async into a raw buffer, and
// one pass over it (widen) sums the planes and the limbs in fp32 and splits
// them by parity into the fp32 tiles of K5's or K6's body, which then runs
// unchanged (parity_body.cuh: the same tiles, register tiles and summation
// order, K1's: 16-term FMA chains, a stage's two added in plain fp32 and
// folded by TwoSum every 32 terms).  A raw stage's copies are issued once
// the pass has read the buffer they land in and are in flight while the
// block computes, two barriers a stage (the copies landed; the fp32 tiles
// full); RAWS raw stages are in flight where the blocks an SM keep their
// shared memory (K9, and K10 at 1 plane: 2).  Staging through registers, as
// K5's and K6's bf16-table variants do, would hold 3 planes of 16 bytes for
// every 8 entries on top of bodies at 236-255 registers, and spill.
// - K9 (K5's body): a block of 128 threads holds 32 rows x 64 latitudes;
//   warps 0-1 sum E over even j, warps 2-3 O over odd j, each thread a 4 x
//   8 register tile; stages of 64 degrees of j (32 of each parity); at the
//   end the E thread writes north = E + O and the O thread south = E - O.
// - K10 (K6's body): a block of 64 threads holds 20 rows x 64 degrees of
//   each parity (128 of j); warp 0 sums (gn + gs) . P_even, warp 1
//   (gn - gs) . P_odd, each thread a 5 x 8 register tile, over stages of 32
//   latitudes; each warp writes its parity's columns.  K6's latitude split:
//   a launch whose blocks would leave SMs idle (the late groups: J down to
//   82, 80 blocks) splits each block's latitude stages among a cluster of up
//   to 8 blocks (grouped::split_for on the resident slots), whose totals
//   meet in the first block by TwoSum through distributed shared memory.
//   Its pass gives warp 0 fewer table groups than warp 1, as warp 0 takes
//   the larger share of the operand's groups, which cost about two each.
//
// Rows.  J = 2 kg and kg is odd in all 16 TCO1279 groups, so a plane row of
// J entries starts only 4-byte aligned.  Resolution.planes_legendre stores
// the planes in rows padded with zeros to a multiple of 8 entries (views of
// the first J), so every table row starts 16-byte aligned: the kernels take
// only such planes (the wrappers copy any others into padded rows on the
// card first) and copy each row in NE / 8 16-byte copies.  The operand rows
// (J or ig long) keep their length and land shifted in the raw buffer by
// their offset in their 16-byte chunk (chunk_shift), with one more copy a
// row.  A copy that reaches past the tile's entries reads only those below
// J (or ig) and zero-fills the rest, so the padding never enters a sum; a
// stage whose copies all lie inside copies untested.
//
// Launch shape: K9 128 threads, __launch_bounds__(128, 2), 104,448 bytes of
// shared memory at P = 3 and 53,248 at P = 1, 2 blocks an SM; K10 64
// threads, __launch_bounds__(64, 4), 56,000 and 44,608 bytes, 4 blocks an
// SM; 254 and 255 registers, no spill (nvcc -Xptxas -v, in
// _build/build.log; chip_smoke.py prints them and fails on a spill).  Tried
// on the card and kept (PERF.md): the padded rows, the untested copies of
// the inner stages, the second raw stage, K10's balanced pass.  Tried and
// not kept: a second instantiation of each kernel that read table rows
// shifted as the operand rows (contiguous planes in place, 21-34 % slower
// than padded rows with the aligned kernels).  The register staging of
// K5's bf16 variant was not tried: it would spill.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "cp_async.cuh"
#include "parity_body.cuh"

namespace planes {

using ect::bf16;
using ect::cp_async;
using ect::cp_async_commit;
using ect::cp_async_wait;

constexpr int PMAX = 3;

// the P planes of a launch
struct Planes {
  const bf16* p[PMAX];
};

// the offset, in entries, of p in its 16-byte chunk: a row whose tile starts
// at p lands shifted by it in the raw buffer
__device__ __forceinline__ int chunk_shift(const bf16* p) {
  return (int)(reinterpret_cast<uintptr_t>(p) >> 1 & 7);
}

// Copies NR rows x NE bf16 entries, global rows ld entries apart (src: entry
// (0, 0) of the tile), into shared rows `pitch` words apart, 16 bytes a
// copy: row r lands from its 16-byte chunk on, so its entry e is entry
// chunk_shift(src + r ld) + e of the shared row (0 for ALIGNED rows, which
// take NE / 8 copies; others one more).  Entries at or past ncol and rows at
// or past nrow read nothing and are zero-filled; a tile whose copies all lie
// below them (FULL) copies untested.
template <int THREADS, int NR, int NE, bool ALIGNED, bool FULL>
__device__ __forceinline__ void copy_rows(uint32_t* dst, int pitch,
                                          const bf16* src, size_t ld,
                                          int nrow, int ncol,
                                          const bf16* base) {
  constexpr int PER_ROW = NE / 8 + (ALIGNED ? 0 : 1);
  constexpr int N = NR * PER_ROW;
#pragma unroll
  for (int n0 = 0; n0 < N; n0 += THREADS) {
    const int n = n0 + (int)threadIdx.x;
    if (N % THREADS != 0 && n >= N) break;
    const int r = n / PER_ROW, c = n % PER_ROW;
    const bf16* row = src + r * ld;
    const int e0 = 8 * c - (ALIGNED ? 0 : chunk_shift(row));
    if constexpr (FULL) {
      cp_async<16, false>(dst + r * pitch + 4 * c, row + e0);
    } else {
      const int left = ncol - e0;   // entries of the row from this copy on
      const int nb = r >= nrow || left <= 0 ? 0 : left >= 8 ? 16 : 2 * left;
      cp_async<16, true>(dst + r * pitch + 4 * c, nb > 0 ? row + e0 : base,
                         nb);
    }
  }
}

template <int THREADS, int NR, int NE, bool ALIGNED>
__device__ __forceinline__ void stage_rows(uint32_t* dst, int pitch,
                                           const bf16* src, size_t ld,
                                           int nrow, int ncol,
                                           const bf16* base) {
  // recomputed at every stage, not hoisted out of the stage loop, where the
  // per-copy addresses would hold registers through the FMAs (as copy_tile)
  asm volatile("" : "+l"(src), "+l"(ld));
  if (nrow >= NR && ncol >= NE + (ALIGNED ? 0 : 8)) {
    copy_rows<THREADS, NR, NE, ALIGNED, true>(dst, pitch, src, ld, nrow, ncol,
                                              base);
  } else {
    copy_rows<THREADS, NR, NE, ALIGNED, false>(dst, pitch, src, ld, nrow,
                                               ncol, base);
  }
}

// a bf16 entry of a word of two (hi: the second) as fp32
__device__ __forceinline__ float entry(uint32_t w, bool hi) {
  return __uint_as_float(hi ? w & 0xffff0000u : w << 16);
}

// v[e] += entry o + e of a shared row of bf16 words, e < 8
template <bool ALIGNED>
__device__ __forceinline__ void add8(const uint32_t* row, int o,
                                     float (&v)[8]) {
  if (ALIGNED || (o & 7) == 0) {
    const uint4 a = *reinterpret_cast<const uint4*>(row + (o >> 1));
    const uint32_t w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += entry(w[e / 2], e % 2);
    return;
  }
  const uint32_t* r = row + (o >> 1);
  uint32_t w[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = r[k];
  if (o & 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += entry(w[(e + 1) / 2], (e + 1) % 2);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] += entry(w[e / 2], e % 2);
  }
}

__device__ __forceinline__ void store4(float* dst, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(dst) = make_float4(a, b, c, d);
}

}  // namespace planes

namespace k9 {

using namespace planes;
using namespace inv_form;

constexpr int MINB = 2;       // blocks an SM
constexpr int NE = 2 * DK;    // degrees of j a stage
constexpr int XPITCH = NE / 2 + 4;       // words per raw operand row
constexpr int RAWS = 2;       // raw stages in flight
static_assert(NE % 8 == 0, "");

// words per raw table row (rows start 16-byte aligned)
constexpr int TPITCH = NE / 2;

// words of a raw stage: the planes' tiles, the x_l rows
template <int P>
constexpr int RAW_WORDS = P * TI * TPITCH + P * BR * XPITCH;

// bytes of shared memory: the fp32 stage and the raw stages
template <int P>
constexpr int smem_bytes() {
  return 4 * (STAGE + RAWS * RAW_WORDS<P>);
}

struct Args {
  const bf16* a;
  Planes pl;
  float* north;
  float* south;
  int fc, J, ig, ld;
};

// stage j0 .. j0 + NE - 1: the P planes' tiles (latitudes i0 ..) and the x_l
// rows (row0 ..) of the operand, raw
template <int P>
__device__ __forceinline__ void stage(uint32_t* raw, const Args& g,
                                      const bf16* am, const bf16* const* pm,
                                      int row0, int i0, int j0) {
  uint32_t* rx = raw + P * TI * TPITCH;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    stage_rows<THREADS, TI, NE, true>(
        raw + k * TI * TPITCH, TPITCH, pm[k] + (size_t)i0 * g.ld + j0, g.ld,
        g.ig - i0, g.J - j0, pm[k]);
  }
#pragma unroll
  for (int l = 0; l < P; ++l) {
    // limb l's rows start at 2 l fc; the sign rows are not read
    stage_rows<THREADS, BR, NE, false>(
        rx + l * BR * XPITCH, XPITCH,
        am + (size_t)(2 * l * g.fc + row0) * g.J + j0, g.J, g.fc - row0,
        g.J - j0, am);
  }
}

// one pass over the raw stage: p = sum_k p_k and x = sum_l x_l in fp32,
// even j into the first parity's tiles, odd j into the second's
template <int P>
__device__ __forceinline__ void widen(float* st, const uint32_t* raw,
                                      const Args& g, const bf16* am, int row0,
                                      int j0) {
  const uint32_t* rx = raw + P * TI * TPITCH;
  constexpr int TG = TI * NE / 8, XG = BR * NE / 8;   // groups of 8 entries
  static_assert(TG % THREADS == 0 && XG % THREADS == 0, "");
#pragma unroll
  for (int u = 0; u < TG / THREADS; ++u) {
    const int n = threadIdx.x + u * THREADS;
    const int i = n / (NE / 8), q = n % (NE / 8);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < P; ++k) {
      add8<true>(raw + (k * TI + i) * TPITCH, 8 * q, v);
    }
    float* ps = st + BR * LD + i * LD + 4 * q;
    store4(ps, v[0], v[2], v[4], v[6]);
    store4(ps + PSTAGE, v[1], v[3], v[5], v[7]);
  }
#pragma unroll
  for (int u = 0; u < XG / THREADS; ++u) {
    const int n = threadIdx.x + u * THREADS;
    const int r = n / (NE / 8), q = n % (NE / 8);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < P; ++l) {
      const int s =
          chunk_shift(am + (size_t)(2 * l * g.fc + row0 + r) * g.J + j0);
      add8<false>(rx + (l * BR + r) * XPITCH, s + 8 * q, v);
    }
    float* xs = st + r * LD + 4 * q;
    store4(xs, v[0], v[2], v[4], v[6]);
    store4(xs + PSTAGE, v[1], v[3], v[5], v[7]);
  }
}

// north[m, r, i] = E + O, south[m, r, i] = E - O.  Block (latitude tile, m,
// row chunk); thread (ty: rows ty + NRG r; tx: latitudes tx + NLG l)
template <int P>
__global__ void __launch_bounds__(THREADS, MINB) inv_planes_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + STAGE);
  const int i0 = blockIdx.x * TI;
  const int m = blockIdx.y;
  const int row0 = blockIdx.z * BR;
  const int par = threadIdx.x / PTHREADS, pt = threadIdx.x % PTHREADS;
  const int lane = pt % 32, warp = pt / 32;
  const int ty = warp * 4 + lane / 8;
  const int tx = lane % 8;
  const bf16* am = g.a + (size_t)m * (2 * P * g.fc) * g.J;
  const bf16* pm[P];
#pragma unroll
  for (int k = 0; k < P; ++k) pm[k] = g.pl.p[k] + (size_t)m * g.ig * g.ld;
  const int nstage = (g.J + NE - 1) / NE;

  float tot[RT][LT], cmp[RT][LT];   // compensated totals
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int l = 0; l < LT; ++l) tot[r][l] = cmp[r][l] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < RAWS; ++s) {
    if (s < nstage) {
      stage<P>(raw + s * RAW_WORDS<P>, g, am, pm, row0, i0, s * NE);
    }
    cp_async_commit();
  }
  for (int c = 0; c < nstage; ++c) {
    uint32_t* rc = raw + c % RAWS * RAW_WORDS<P>;
    cp_async_wait<RAWS - 1>();   // this thread's copies of stage c landed
    __syncthreads();      // everyone's; and the fp32 stage is free
    widen<P>(smem, rc, g, am, row0, c * NE);
    __syncthreads();      // the fp32 stage is full; raw stage c free
    if (c + RAWS < nstage) {
      stage<P>(rc, g, am, pm, row0, i0, (c + RAWS) * NE);
    }
    cp_async_commit();
    stage_sums(smem + par * PSTAGE, ty, tx, tot, cmp);
  }
  cp_async_wait<0>();
  store(smem, tot, cmp, par, pt, ty, tx, m, row0, i0, g.fc, g.ig, g.north,
        g.south);
}

inline dim3 grid_of(int gm, int fc2, int ig) {
  return dim3((ig + TI - 1) / TI, gm, (fc2 + BR - 1) / BR);
}

template <int P>
int launch(const Args& g, int gm, void* stream) {
  return grouped::launch(inv_planes_kernel<P>, grid_of(gm, g.fc, g.ig),
                         THREADS, smem_bytes<P>(), 1, stream, g);
}

template <int P>
int shape(int gm, int fc2, int ig, int* info) {
  return ect::launch_shape(inv_planes_kernel<P>, grid_of(gm, fc2, ig),
                           THREADS, smem_bytes<P>(), info);
}

}  // namespace k9

namespace k10 {

using namespace planes;
using namespace dir_form;

constexpr int MINB = 4;       // blocks an SM
constexpr int NE = 2 * DK;    // degrees of j a block
constexpr int XPITCH = TJ / 2 + 4;       // words per raw operand row
// raw stages in flight: 2 where 4 blocks an SM keep their shared memory
template <int P>
constexpr int RAWS = P == 1 ? 2 : 1;

// words per raw table row (rows start 16-byte aligned)
constexpr int TPITCH = NE / 2;

// words of a raw stage: the planes' tiles, the gn_l and gs_l rows
template <int P>
constexpr int RAW_WORDS = P * TJ * TPITCH + 2 * P * BR * XPITCH;

// bytes of shared memory: the fp32 stage and the raw stages
template <int P>
constexpr int smem_bytes() {
  return 4 * (STAGE + RAWS<P> * RAW_WORDS<P>);
}

struct Args {
  const bf16* w;
  Planes pl;
  float* out;
  int fc, J, ig, ld, nsplit;
};

// stage i0 .. i0 + TJ - 1: the P planes' tiles (degrees j0 ..) and the gn_l,
// gs_l rows (row0 ..) of the operand, raw
template <int P>
__device__ __forceinline__ void stage(uint32_t* raw, const Args& g,
                                      const bf16* wm, const bf16* const* pm,
                                      int row0, int i0, int j0) {
  uint32_t* rx = raw + P * TJ * TPITCH;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    stage_rows<THREADS, TJ, NE, true>(
        raw + k * TJ * TPITCH, TPITCH, pm[k] + (size_t)i0 * g.ld + j0, g.ld,
        g.ig - i0, g.J - j0, pm[k]);
  }
#pragma unroll
  for (int h = 0; h < 2 * P; ++h) {   // gn_0, gs_0, gn_1, ...
    stage_rows<THREADS, BR, TJ, false>(
        rx + h * BR * XPITCH, XPITCH,
        wm + (size_t)(h * g.fc + row0) * g.ig + i0, g.ig, g.fc - row0,
        g.ig - i0, wm);
  }
}

// one pass over the raw stage: p = sum_k p_k in fp32, even j into the first
// parity's table tile and odd j into the second's; gn = sum_l gn_l and gs =
// sum_l gs_l, gn + gs into the first parity's operand chunk and gn - gs
// into the second's
template <int P>
__device__ __forceinline__ void widen(float* st, const uint32_t* raw,
                                      const Args& g, const bf16* wm, int row0,
                                      int i0) {
  const uint32_t* rx = raw + P * TJ * TPITCH;
  constexpr int TG = TJ * NE / 8, XG = BR * TJ / 8;   // groups of 8 entries
  // the two warps share the pass evenly, an operand group costing about two
  // table groups: warp 0 widens TW0 passes of table groups and XW0 operand
  // groups, warp 1 the rest
  constexpr int TPASS = TG / 32, TW0 = 7, XW0 = 48;
  static_assert(THREADS == 64 && TG % 32 == 0 && XG - XW0 <= 32, "");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int u = 0; u < TPASS - TW0; ++u) {
    if (warp == 0 && u >= TW0) break;
    const int n = (warp ? 32 * TW0 : 0) + 32 * u + lane;
    const int i = n / (NE / 8), q = n % (NE / 8);
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < P; ++k) {
      add8<true>(raw + (k * TJ + i) * TPITCH, 8 * q, v);
    }
    float* ps = st + i * DK + 4 * q;
    store4(ps, v[0], v[2], v[4], v[6]);
    store4(ps + PSTAGE, v[1], v[3], v[5], v[7]);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int idx = 32 * u + lane;
    if (idx >= (warp ? XG - XW0 : XW0)) break;
    const int n = (warp ? XW0 : 0) + idx;
    const int r = n / (TJ / 8), q = n % (TJ / 8);
    float gn[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float gs[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int l = 0; l < P; ++l) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {   // gn_l, gs_l
        const int h = 2 * l + b;
        const int s =
            chunk_shift(wm + (size_t)(h * g.fc + row0 + r) * g.ig + i0);
        const uint32_t* row = rx + (h * BR + r) * XPITCH;
        if (b == 0) {
          add8<false>(row, s + 8 * q, gn);
        } else {
          add8<false>(row, s + 8 * q, gs);
        }
      }
    }
    // rows of DR floats start 8-byte aligned
    float* ds = st + PT + r * DR + 8 * q;
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
      *reinterpret_cast<float2*>(ds + e) =
          make_float2(gn[e] + gs[e], gn[e + 1] + gs[e + 1]);
      *reinterpret_cast<float2*>(ds + PSTAGE + e) =
          make_float2(gn[e] - gs[e], gn[e + 1] - gs[e + 1]);
    }
  }
}

// out[m, r, j] = sum_i (gn + (-1)^j gs)[m, r, i] p[m, i, j].  Block (degree
// tile x split rank, m, row chunk); rank `rank` of the cluster sums stages
// [c0, c1) of the latitudes; thread (ty: rows RT ty ..; tx: parity degrees
// 4 tx .. and KRUN + 4 tx ..), j = 2 k + par
template <int P>
__global__ void __launch_bounds__(THREADS, MINB) dir_planes_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  uint32_t* raw = reinterpret_cast<uint32_t*>(smem + STAGE);
  const int rank = blockIdx.x % g.nsplit;
  const int j0 = blockIdx.x / g.nsplit * NE;
  const int m = blockIdx.y;
  const int row0 = blockIdx.z * BR;
  const int par = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = lane / NKG, tx = lane % NKG;
  const bf16* wm = g.w + (size_t)m * (2 * P * g.fc) * g.ig;
  const bf16* pm[P];
#pragma unroll
  for (int k = 0; k < P; ++k) pm[k] = g.pl.p[k] + (size_t)m * g.ig * g.ld;
  const int nstage = (g.ig + TJ - 1) / TJ;
  const int c0 = rank * nstage / g.nsplit;
  const int c1 = (rank + 1) * nstage / g.nsplit;

  float tot[RT][KT], cmp[RT][KT];   // compensated totals
#pragma unroll
  for (int r = 0; r < RT; ++r) {
#pragma unroll
    for (int l = 0; l < KT; ++l) tot[r][l] = cmp[r][l] = 0.f;
  }

  constexpr int R = RAWS<P>;
#pragma unroll
  for (int s = 0; s < R; ++s) {
    if (c0 + s < c1) {
      stage<P>(raw + s * RAW_WORDS<P>, g, wm, pm, row0, (c0 + s) * TJ, j0);
    }
    cp_async_commit();
  }
  for (int c = c0; c < c1; ++c) {
    uint32_t* rc = raw + (c - c0) % R * RAW_WORDS<P>;
    cp_async_wait<R - 1>();   // this thread's copies of stage c landed
    __syncthreads();      // everyone's; and the fp32 stage is free
    widen<P>(smem, rc, g, wm, row0, c * TJ);
    __syncthreads();      // the fp32 stage is full; raw stage c free
    if (c + R < c1) {
      stage<P>(rc, g, wm, pm, row0, (c + R) * TJ, j0);
    }
    cp_async_commit();
    stage_sums(smem + par * PSTAGE, ty, tx, tot, cmp);
  }
  cp_async_wait<0>();

  if (g.nsplit > 1) {
    grouped::combine_split<THREADS>(smem, tot, cmp, rank, g.nsplit);
    if (rank > 0) return;
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = row0 + RT * ty + r;
#pragma unroll
    for (int l = 0; l < KT; ++l) {
      const int j = j0 + 2 * (l / 4 * KRUN + 4 * tx + l % 4) + par;
      if (row < g.fc && j < g.J) {
        g.out[((size_t)m * g.fc + row) * g.J + j] = tot[r][l] + cmp[r][l];
      }
    }
  }
}

inline dim3 grid_of(int gm, int fc2, int J, int split) {
  return dim3((J + NE - 1) / NE * split, gm, (fc2 + BR - 1) / BR);
}

// the latitude split of a launch (grouped::split_for on the card's resident
// slots)
template <int P>
int split_of(int gm, int fc2, int J, int ig, int* split) {
  long slots = 0;
  const int e = ect::resident_slots<&dir_planes_kernel<P>>(
      THREADS, smem_bytes<P>(), &slots);
  if (e != 0) return e;
  const dim3 b = grid_of(gm, fc2, J, 1);
  *split = grouped::split_for((long)b.x * b.y * b.z, (ig + TJ - 1) / TJ,
                              std::max(1L, slots));
  return 0;
}

template <int P>
int launch(Args g, int gm, void* stream) {
  const int e = split_of<P>(gm, g.fc, g.J, g.ig, &g.nsplit);
  if (e != 0) return e;
  return grouped::launch(dir_planes_kernel<P>,
                         grid_of(gm, g.fc, g.J, g.nsplit), THREADS,
                         smem_bytes<P>(), g.nsplit, stream, g);
}

template <int P>
int shape(int gm, int fc2, int J, int ig, int* info) {
  int split = 1;
  const int e = split_of<P>(gm, fc2, J, ig, &split);
  if (e != 0) return e;
  return ect::launch_shape(dir_planes_kernel<P>,
                           grid_of(gm, fc2, J, split), THREADS,
                           smem_bytes<P>(), info);
}

}  // namespace k10

namespace {

// every plane starts 16-byte aligned and its rows of ld entries keep it
bool aligned(const void* const* p, int nplanes, int ld) {
  bool ok = ld % 8 == 0;
  for (int k = 0; k < nplanes; ++k) {
    ok = ok && reinterpret_cast<uintptr_t>(p[k]) % 16 == 0;
  }
  return ok;
}

planes::Planes planes_of(const void* p0, const void* p1, const void* p2) {
  return {{(const ect::bf16*)p0, (const ect::bf16*)p1, (const ect::bf16*)p2}};
}

// calls F<P>() for nplanes 1 or 3
template <typename F>
int dispatch(int nplanes, F f) {
  if (nplanes == 3) return f(std::integral_constant<int, 3>());
  if (nplanes == 1) return f(std::integral_constant<int, 1>());
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// nplanes 1 or 3; the plane pointers past nplanes are not read; every plane
// starts 16-byte aligned, its rows ld >= J entries apart and ld a multiple
// of 8 (padded rows; the wrappers pad any others), else cudaErrorInvalidValue
int ect_inv_planes(const void* a, const void* p0, const void* p1,
                   const void* p2, void* north, void* south, int nplanes,
                   int gm, int fc2, int J, int ig, int ld, void* stream) {
  const void* p[3] = {p0, p1, p2};
  if (!aligned(p, nplanes, ld)) return (int)cudaErrorInvalidValue;
  const k9::Args g = {(const ect::bf16*)a, planes_of(p0, p1, p2),
                      (float*)north, (float*)south, fc2, J, ig, ld};
  return dispatch(nplanes, [&](auto P) {
    return k9::launch<decltype(P)::value>(g, gm, stream);
  });
}

int ect_dir_planes(const void* w, const void* p0, const void* p1,
                   const void* p2, void* out, int nplanes, int gm, int fc2,
                   int J, int ig, int ld, void* stream) {
  const void* p[3] = {p0, p1, p2};
  if (!aligned(p, nplanes, ld)) return (int)cudaErrorInvalidValue;
  const k10::Args g = {(const ect::bf16*)w, planes_of(p0, p1, p2),
                       (float*)out, fc2, J, ig, ld, 1};
  return dispatch(nplanes, [&](auto P) {
    return k10::launch<decltype(P)::value>(g, gm, stream);
  });
}

// the launch of K9 or K10 (info as ect::launch_shape); K10's blocks count
// its latitude split's parts
int ect_inv_planes_shape(int nplanes, int gm, int fc2, int J, int ig,
                         int* info) {
  (void)J;
  return dispatch(nplanes, [&](auto P) {
    return k9::shape<decltype(P)::value>(gm, fc2, ig, info);
  });
}

int ect_dir_planes_shape(int nplanes, int gm, int fc2, int J, int ig,
                         int* info) {
  return dispatch(nplanes, [&](auto P) {
    return k10::shape<decltype(P)::value>(gm, fc2, J, ig, info);
  });
}

}  // extern "C"
