// Packed-layout compaction for Hopper (sm_90a): kernel K3.
//
// Replaces ectrans_tpu/ops/pack_pallas.py _compact_group (_compact_kernel).
// Input: per m-group, c-major, m-major diagonal-realigned rows
// rows[m - m0, c * nfld + f, j] (the direct Legendre kernel's output, after
// UVTVD), j = n - m.  Output: the NASM0 packed layout, per-m contiguous
// blocks of 2 (nsmax + 1 - m) interleaved (re, im) values,
//   out[f, NASM0[m] + 2 j + c] = rows[m - m0, c * nfld + f, j].
//
// It moves bytes and does no arithmetic, so it is bound by device memory:
// one read of the valid part of the rows and one write of the packed array
// (at TCO1279 with 10 fields, ~70 MB and 66 MB: 0.040 ms at 3.35 TB/s).
// The TPU kernel walked output tiles in a sequential grid (scalar-prefetched
// plan, lane roll, one-hot interleave matmul) because that backend has no
// cheap scattered access.  Here:
// - one launch packs every group: the groups' row pointers, first m and row
//   lengths change every call, so nothing is cached on the device.  Up to
//   MAXG = 16 groups they travel by value in the kernel's parameters and a
//   warp finds its group by an unrolled scan of the constant bank; past 16
//   (ECTRANS_TPU_LEG_GROUPS, up to one group an m) the launch first copies
//   them into a device array (16 bytes a group, on the same stream) and a
//   warp finds its group by a binary search on m0 there, ~log2(groups)
//   cached loads once per warp;
// - one warp per (m, field) row: NASM0[m] = m (2 nsmax + 3 - m) in closed
//   form;
// - lane j reads rows c = 0 and c = 1 at j (coalesced, two streams) and
//   stores the pair (re, im) as one 8-byte (fp32) or 16-byte (fp64) store:
//   NASM0[m] and nspec2 are even, so every pair is aligned;
// - each lane keeps U = 8 pairs in flight per pass (6 % faster than 4, 15 %
//   than 2); warps are numbered with m ascending, so the longest rows start
//   first and the rows of a few m near nsmax (1-32 pairs) share a block
//   without a tail of their own.
// The copy is bit-exact.

#include <cuda_runtime.h>

#include <vector>

#include "legendre_common.cuh"

namespace k3 {

constexpr int MAXG = 16;             // groups passed by value
constexpr int WARPS = 8;             // rows (warps) per block
constexpr int THREADS = 32 * WARPS;
constexpr int U = 8;                 // pairs in flight per lane and pass

struct Groups {
  const void* rows[MAXG];
  int m0[MAXG];
  int jrow[MAXG];
  int n;
};

// one group's descriptor in the device array of a launch past MAXG groups
struct Desc {
  const void* rows;
  int m0;
  int jrow;
};
static_assert(sizeof(Desc) == 16, "K3's descriptors are 16 bytes");

template <typename T> struct PairOf;
template <> struct PairOf<float> { typedef float2 type; };
template <> struct PairOf<double> { typedef double2 type; };

// DEV: the groups' descriptors are in ``d`` (g.n of them, m0 ascending),
// else in g
template <typename T, bool DEV>
__global__ void __launch_bounds__(THREADS)
k3_pack_kernel(const Groups g, const Desc* __restrict__ d,
               T* __restrict__ out, int nfld, int nsmax, long long nspec2) {
  typedef typename PairOf<T>::type Pair;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= (nsmax + 1) * nfld) return;
  const int m = row / nfld;
  const int f = row - m * nfld;
  // the group of m: the last group whose first m is <= m
  const void* base;
  int m0, jrow;
  if constexpr (DEV) {
    int lo = 0, hi = g.n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (__ldg(&d[mid].m0) <= m) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    base = d[lo].rows;
    m0 = d[lo].m0;
    jrow = d[lo].jrow;
  } else {
    // static indices, so the parameters stay in the constant bank
    base = g.rows[0];
    m0 = g.m0[0];
    jrow = g.jrow[0];
#pragma unroll
    for (int k = 1; k < MAXG; ++k) {
      if (k < g.n && g.m0[k] <= m) {
        base = g.rows[k];
        m0 = g.m0[k];
        jrow = g.jrow[k];
      }
    }
  }
  const int len = nsmax + 1 - m;
  const T* re = (const T*)base + ((long long)(m - m0) * 2 * nfld + f) * jrow;
  const T* im = re + (long long)nfld * jrow;
  Pair* o = (Pair*)(out + (long long)f * nspec2 +
                    (long long)m * (2 * nsmax + 3 - m));
  for (int j0 = lane; j0 < len; j0 += 32 * U) {
    T a[U], b[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + 32 * u;
      if (j < len) {
        a[u] = re[j];
        b[u] = im[j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + 32 * u;
      if (j < len) {
        Pair p;
        p.x = a[u];
        p.y = b[u];
        o[j] = p;
      }
    }
  }
}

inline dim3 grid_of(int nfld, int nsmax) {
  return dim3((unsigned)(((long long)(nsmax + 1) * nfld + WARPS - 1) / WARPS));
}

template <typename T>
int launch(const void* const* rows, const int* m0, const int* jrow,
           int ngroups, void* desc, void* out, int nfld, int nsmax,
           long long nspec2, void* stream) {
  if (ngroups < 1 || m0[0] != 0) return (int)cudaErrorInvalidValue;
  for (int k = 1; k < ngroups; ++k) {
    if (m0[k] <= m0[k - 1]) return (int)cudaErrorInvalidValue;
  }
  const bool dev = ngroups > MAXG;
  if (dev && desc == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  Groups g = {};
  g.n = ngroups;
  if (dev) {
    // staged from pageable memory before the call returns, ahead of the
    // kernel on the stream
    std::vector<Desc> h(ngroups);
    for (int k = 0; k < ngroups; ++k) h[k] = Desc{rows[k], m0[k], jrow[k]};
    const cudaError_t rc =
        cudaMemcpyAsync(desc, h.data(), sizeof(Desc) * ngroups,
                        cudaMemcpyHostToDevice, s);
    if (rc != cudaSuccess) return (int)rc;
  } else {
    for (int k = 0; k < ngroups; ++k) {
      g.rows[k] = rows[k];
      g.m0[k] = m0[k];
      g.jrow[k] = jrow[k];
    }
  }
  const dim3 grid = grid_of(nfld, nsmax);
  if (grid.x == 0) return 0;
  if (dev) {
    k3_pack_kernel<T, true><<<grid, THREADS, 0, s>>>(
        g, (const Desc*)desc, (T*)out, nfld, nsmax, nspec2);
  } else {
    k3_pack_kernel<T, false><<<grid, THREADS, 0, s>>>(
        g, nullptr, (T*)out, nfld, nsmax, nspec2);
  }
  return (int)cudaGetLastError();
}

}  // namespace k3

extern "C" {

// rows, m0, jrow: host arrays of ngroups entries, one per group, m0
// ascending from 0: the device pointer of its rows, its first m, and its
// rows' length; desc: a device buffer of 16 * ngroups bytes, used (and
// required) past 16 groups
int ect_compact_f32(const void* const* rows, const int* m0, const int* jrow,
                    int ngroups, void* desc, void* out, int nfld, int nsmax,
                    long long nspec2, void* stream) {
  return k3::launch<float>(rows, m0, jrow, ngroups, desc, out, nfld, nsmax,
                           nspec2, stream);
}

int ect_compact_f64(const void* const* rows, const int* m0, const int* jrow,
                    int ngroups, void* desc, void* out, int nfld, int nsmax,
                    long long nspec2, void* stream) {
  return k3::launch<double>(rows, m0, jrow, ngroups, desc, out, nfld, nsmax,
                            nspec2, stream);
}

// K3's launch (ect::launch_shape's info; the fp32 and fp64 variants, and
// both lookups, launch alike)
int ect_compact_shape(int nfld, int nsmax, int* info) {
  return ect::launch_shape(k3::k3_pack_kernel<float, false>,
                           k3::grid_of(nfld, nsmax), k3::THREADS, 0, info);
}

}  // extern "C"
