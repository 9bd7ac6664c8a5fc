// Streaming probes for Hopper (sm_90a): kernels K11 and K12.
//
// K11 replaces tools/roofline.py pallas_copy (_copy_kernel): out = x.
// K12 replaces tools/roofline.py pallas_reduce (_reduce_kernel): for x
// (rows, cols), rows a multiple of 8, out (8, cols) with
// out[r, c] = sum_{i = r mod 8} x[i, c].
//
// Both are one pass over device memory and do next to no arithmetic, so they
// measure the rate a hand-written kernel reaches on this card: K11 reads and
// writes every byte, K12 reads every byte and writes 16 KB (the Legendre
// kernels' table stream is a read of this kind).  Each thread moves 16 bytes
// per access (float4), neighbouring threads on neighbouring addresses, in a
// grid-stride loop over a grid that fills every SM.  K12 keeps no sum across
// blocks in flight: each block slice writes its partial sums, and a second
// tiny pass adds the slices in a fixed order, so the result is deterministic
// (no float atomics).  The TPU kernel carried the sum in its output block
// from one sequential grid step to the next, which blocks running in
// parallel cannot do.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 8;   // 2048 threads, the SM's limit

__global__ void __launch_bounds__(THREADS)
copy_kernel(const float4* __restrict__ x, float4* __restrict__ out,
            long long n4) {
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long k = (long long)blockIdx.x * THREADS + threadIdx.x; k < n4;
       k += stride)
    out[k] = x[k];
}

// Lane l of the (8, cols) output in float4 units: row phase l / (cols / 4),
// column group l % (cols / 4).  Eight consecutive rows of x hold exactly the
// lanes float4 of one "octet", in lane order, so x4[q * lanes + l] is lane l
// of octet q.  Slice s (blockIdx.y) sums the octets q = s (mod slices).
__global__ void __launch_bounds__(THREADS)
reduce8_partial_kernel(const float4* __restrict__ x,
                       float4* __restrict__ partial, long long octets,
                       int lanes) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= lanes) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long q = blockIdx.y; q < octets; q += gridDim.y) {
    const float4 v = x[q * lanes + l];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  partial[(size_t)blockIdx.y * lanes + l] = acc;
}

__global__ void __launch_bounds__(THREADS)
reduce8_final_kernel(const float4* __restrict__ partial,
                     float4* __restrict__ out, int slices, int lanes) {
  const int l = blockIdx.x * THREADS + threadIdx.x;
  if (l >= lanes) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < slices; ++s) {
    const float4 v = partial[(size_t)s * lanes + l];
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  out[l] = acc;
}

int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 1;
}

}  // namespace

extern "C" {

// x, out: n fp32 values, n a multiple of 4, 16-byte aligned
int ect_copy_f32(const void* x, void* out, long long n, void* stream) {
  const long long n4 = n / 4;
  long long blocks = (n4 + THREADS - 1) / THREADS;
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  copy_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, n4);
  return (int)cudaGetLastError();
}

// x: (rows, cols) fp32, rows a multiple of 8, cols of 4; partial: slices *
// 8 * cols fp32 of scratch; out: (8, cols)
int ect_reduce8_f32(const void* x, void* partial, void* out, long long rows,
                    int cols, int slices, void* stream) {
  const int lanes = 8 * (cols / 4);
  const long long octets = rows / 8;
  dim3 grid((lanes + THREADS - 1) / THREADS, slices);
  reduce8_partial_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)partial, octets, lanes);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  reduce8_final_kernel<<<(lanes + THREADS - 1) / THREADS, THREADS, 0,
                         (cudaStream_t)stream>>>(
      (const float4*)partial, (float4*)out, slices, lanes);
  return (int)cudaGetLastError();
}

}  // extern "C"
