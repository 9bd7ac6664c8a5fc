// Packed-layout compaction for Hopper (sm_90a): kernel K3.
//
// Replaces ectrans_tpu/ops/pack_pallas.py _compact_group (_compact_kernel).
// Input: one m-group of c-major, m-major diagonal-realigned rows
// rows[m - m0, c * nfld + f, j] (the direct Legendre kernel's output, after
// UVTVD), j = n - m.  Output: the NASM0 packed layout, per-m contiguous
// blocks of 2 (nsmax + 1 - m) interleaved (re, im) values.
//
// It moves bytes and does no arithmetic, so it is bound by device memory:
// one read of the valid part of the rows and one write of the packed array.
// The TPU kernel walked output tiles in a sequential grid (scalar-prefetched
// plan, lane roll, one-hot interleave matmul) because that backend has no
// cheap scattered access; here every packed element is independent, so one
// thread per output element finds its (m, n, c) from its packed offset (a
// binary search over the group's NASM0 offsets) and reads its one value.
// Consecutive threads write consecutive packed positions (coalesced), and
// read alternately from the re and im row of the same m (two streams).
// The copy is bit-exact.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
compact_kernel(const T* __restrict__ rows, const long long* __restrict__ nasm0,
               T* __restrict__ out, int nfld, int jrow, int m0, int m1,
               long long seg0, long long seglen, long long nspec2) {
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (e >= (long long)nfld * seglen) return;
  const int f = (int)(e / seglen);
  const long long pos = seg0 + e % seglen;
  int lo = m0, hi = m1 - 1;            // largest m with nasm0[m] <= pos
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (nasm0[mid] <= pos) lo = mid; else hi = mid - 1;
  }
  const long long off = pos - nasm0[lo];
  const int c = (int)(off & 1);
  const long long j = off >> 1;
  out[(long long)f * nspec2 + pos] =
      rows[((long long)(lo - m0) * 2 * nfld + c * nfld + f) * jrow + j];
}

template <typename T>
int launch(const void* rows, const void* nasm0, void* out, int nfld, int jrow,
           int m0, int m1, long long seg0, long long seglen, long long nspec2,
           void* stream) {
  const long long n = (long long)nfld * seglen;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  compact_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)rows, (const long long*)nasm0, (T*)out, nfld, jrow, m0, m1,
      seg0, seglen, nspec2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int ect_compact_f32(const void* rows, const void* nasm0, void* out, int nfld,
                    int jrow, int m0, int m1, long long seg0, long long seglen,
                    long long nspec2, void* stream) {
  return launch<float>(rows, nasm0, out, nfld, jrow, m0, m1, seg0, seglen,
                       nspec2, stream);
}

int ect_compact_f64(const void* rows, const void* nasm0, void* out, int nfld,
                    int jrow, int m0, int m1, long long seg0, long long seglen,
                    long long nspec2, void* stream) {
  return launch<double>(rows, nasm0, out, nfld, jrow, m0, m1, seg0, seglen,
                        nspec2, stream);
}

}  // extern "C"
