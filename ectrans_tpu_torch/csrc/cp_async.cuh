// Staging of row-major tiles into shared memory with cp.async, shared by the
// pipelined dense-row Legendre kernels K1 and K7 (legendre_dense2.cu), K2 and
// K8 (legendre_dense2_dir.cu).
//
// Both stream rows of ig latitudes (a table row, a Fourier row) whose start
// is 16-byte aligned only where ig % 4 == 0, so the copy width V (floats) is
// a template argument, chosen per launch from the alignment; TMA is out, as
// it needs 16-byte global strides.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace ect {

// cp.async of BYTES from global src to shared dst; with ZFILL, only the
// first n bytes are read and the rest zero-filled (n = 0 reads nothing)
template <int BYTES, bool ZFILL>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int n = BYTES) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (ZFILL) {
    if constexpr (BYTES == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(src), "r"(n));
    } else {
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                   "l"(src), "n"(BYTES), "r"(n));
    }
  } else if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copies a tile of NR rows x NC floats, V floats a copy, from global rows of
// length ld (first element src) into shared rows of length dld, with THREADS
// threads (tid the caller's among them): thread tid copies columns ct ..
// ct + V - 1 of rows rt, rt + RSTEP, ... below NR.  By cp.async, or with
// SYNC through registers, each value passed through cvt (one value a copy,
// or four 2-byte values, one 8-byte load).  FULL: the tile lies inside the
// source, nothing is tested; else rows from nrow and columns from ncol on
// are zero-filled, a copy at a time: a copy that starts below ncol is
// whole (ncol % V == 0), or with PADDED (rows whose storage reaches past
// ncol, as rows padded to 16 bytes do) reads only its entries below ncol,
// so what lies past ncol never enters the tile.
template <int THREADS, typename S, int V, int NR, int NC, bool FULL,
          bool SYNC, bool PADDED = false, typename Cvt>
__device__ __forceinline__ void copy_tile(float* dst, int dld, const S* src,
                                          int ld, int nrow, int ncol,
                                          const S* base, Cvt cvt, int tid) {
  constexpr int PER_ROW = NC / V;              // copies per row
  constexpr int RSTEP = THREADS / PER_ROW;     // rows a pass
  constexpr int PASSES = (NR + RSTEP - 1) / RSTEP;
  static_assert(THREADS % PER_ROW == 0, "");
  const int rt = tid / PER_ROW, ct = tid % PER_ROW * V;
  const bool cok = FULL || ct < ncol;
  // this thread's copies take their first nv entries, those below ncol:
  // the bytes a cp.async reads, or the bits kept of four 2-byte values
  const int nv = FULL || !PADDED || ncol - ct >= V ? V : ncol - ct;
  const unsigned keep_lo = nv > 1 ? ~0u : 0xffffu;
  const unsigned keep_hi = nv > 3 ? ~0u : nv > 2 ? 0xffffu : 0u;
  src += (size_t)rt * ld + ct;
  dst += rt * dld + ct;
  // recomputed at every stage, not hoisted out of the stage loop, where the
  // per-copy addresses would hold registers through the FMAs
  size_t step = (size_t)RSTEP * ld;
  asm volatile("" : "+l"(step));
#pragma unroll
  for (int k = 0; k < PASSES; ++k) {
    // a last pass that reaches past NR (NR % RSTEP != 0) copies fewer rows
    if (NR % RSTEP != 0 && k == PASSES - 1 && rt + k * RSTEP >= NR) break;
    const bool ok = FULL || (cok && rt + k * RSTEP < nrow);
    const S* sk = src;
    src += step;
    float* dk = dst + k * RSTEP * dld;
    if constexpr (SYNC && V == 1) {
      *dk = ok ? cvt(*sk) : 0.f;
    } else if constexpr (SYNC) {
      static_assert(V == 4 && sizeof(S) == 2,
                    "one value, or four 2-byte values, a copy through "
                    "registers");
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (ok) {
        uint2 raw = *reinterpret_cast<const uint2*>(sk);
        if constexpr (PADDED && !FULL) {
          raw.x &= keep_lo;
          raw.y &= keep_hi;
        }
        const S* e = reinterpret_cast<const S*>(&raw);
        v = make_float4(cvt(e[0]), cvt(e[1]), cvt(e[2]), cvt(e[3]));
      }
      *reinterpret_cast<float4*>(dk) = v;
    } else if constexpr (FULL) {
      cp_async<4 * V, false>(dk, sk);
    } else {
      cp_async<4 * V, true>(dk, ok ? sk : base, ok ? 4 * nv : 0);
    }
  }
}

// the widest copy (floats) that every row of ld floats from ptr allows: 4
// where each row starts 16-byte aligned, 2 where 8-byte aligned, else 1
inline int copy_vec(const void* ptr, int ld, int widest = 4) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(ptr);
  if (widest >= 4 && a % 16 == 0 && ld % 4 == 0) return 4;
  if (widest >= 2 && a % 8 == 0 && ld % 2 == 0) return 2;
  return 1;
}

}  // namespace ect
