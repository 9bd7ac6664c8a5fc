// Streaming probes for Hopper (sm_90a): kernels K11 and K12.
//
// K11 replaces tools/roofline.py pallas_copy (_copy_kernel): out = x.
// K12 replaces tools/roofline.py pallas_reduce (_reduce_kernel): for x
// (rows, cols), rows a multiple of 8, out (8, cols) with
// out[r, c] = sum_{i = r mod 8} x[i, c].
//
// Both are one pass over device memory and do next to no arithmetic, so the
// bytes bound them (K11 reads and writes every byte, K12 reads every byte and
// writes 16 KB; the Legendre kernels' table stream is a read of K12's kind),
// and they measure the rate a hand-written kernel reaches on this card.
//
// K11: one 16-byte word a thread, a streaming load (__ldcs) and a
// streaming store (__stcs), on a grid sized from the tensor (256 words, 4 KB,
// a block).  The block scheduler hands out the blocks in address order, so
// the whole card sweeps the tensor front to back.  Every design with more in
// flight measured slower on an H100 (PERF.md): a persistent grid, whether
// each block strides over the tensor or owns a contiguous range, with 1-8
// loads in flight a thread or a cp.async.bulk ring of 32 KB stages, reached
// 2.55-2.88 TB/s of read + write, chunks of 4 loads a thread 2.97, this 3.01.
//
// K12: a persistent grid of one block an SM.  Block (s, w) owns the float4
// lanes [w * WINDOW, ...) of the octets [s * per, (s + 1) * per) (an octet is
// 8 consecutive rows: 2 * cols lanes, contiguous).  One thread streams them
// through a ring of STAGES shared-memory stages of ``ops`` octets (at most
// STAGE bytes; the wrapper's plan picks ``ops``) with cp.async.bulk, each
// stage completing on its own mbarrier (complete_tx);
// each of the block's 256 threads adds 4 float4 lanes of every octet, in
// octet order, into 16 fp32 accumulators, and refills a stage once every
// thread has read it.  Each block writes one partial; a second launch adds
// the partials of each lane in a fixed order (8 warps sum a contiguous
// eighth of the slices each, then warp 0 adds the eighths in order), so the
// result is deterministic (no float atomics).  The TPU kernel carried the sum
// in its output block from one sequential grid step to the next, which
// blocks running in parallel cannot do.
//
// The C entries refuse pointers that are not 16-byte aligned and a launch
// geometry that does not cover the tensor exactly once (the wrappers in
// roofline.py compute it: copy_plan, reduce_plan).

#include <cuda_runtime.h>

#include <cstdint>

#include "legendre_common.cuh"

namespace {

constexpr int COPY_THREADS = 256;          // K11's words a block

constexpr int THREADS = 256;               // K12's threads a block
constexpr int LANES_PER_THREAD = 4;        // float4 accumulators a thread
constexpr int WINDOW = THREADS * LANES_PER_THREAD;   // lanes a block owns
constexpr int STAGES = 4;                  // ring stages
constexpr int STAGE = 32768;               // bytes a stage at most
constexpr int STAGE_WORDS = STAGE / 16;
constexpr int FINAL_WARPS = 8;             // second pass: warps a block

__global__ void __launch_bounds__(COPY_THREADS)
k11_copy_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                long long n4) {
  const long long k = (long long)blockIdx.x * COPY_THREADS + threadIdx.x;
  if (k < n4) __stcs(out + k, __ldcs(x + k));
}

__device__ __forceinline__ void add4(float4& a, const float4& v) {
  a.x += v.x;
  a.y += v.y;
  a.z += v.z;
  a.w += v.w;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}

// the one arrival of a stage's phase, and the bytes its copies will bring
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra WAIT;\n"
      "DONE:\n\t}" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global src
// to shared dst, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// Grid (slices, windows) of THREADS threads; per octets a slice, ops octets
// a ring stage.  partial: (slices, lanes) float4.
__global__ void __launch_bounds__(THREADS)
k12_reduce_kernel(const float4* __restrict__ x, float4* __restrict__ partial,
                  long long octets, int lanes, long long per, int ops) {
  extern __shared__ __align__(128) float4 ring[];
  __shared__ __align__(8) uint64_t full[STAGES];
  const int t = threadIdx.x;
  const int w0 = blockIdx.y * WINDOW;
  const int wl = min(WINDOW, lanes - w0);                 // this window's lanes
  const long long q0 = (long long)blockIdx.x * per;
  const int nq = (int)min(per, octets - q0);              // octets to add
  const int nst = (nq + ops - 1) / ops;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // stage k: octets q0 + k ops ...; one copy when the window is the whole
  // octet (consecutive octets are contiguous), else one an octet
  auto load = [&](int k) {
    const int s = k % STAGES;
    const int n = min(ops, nq - k * ops);
    const long long q = q0 + (long long)k * ops;
    mbar_expect(&full[s], (unsigned)(n * wl * 16));
    if (wl == lanes) {
      bulk_load(ring + s * STAGE_WORDS, x + q * lanes, (unsigned)(n * wl * 16),
                &full[s]);
    } else {
      for (int o = 0; o < n; ++o)
        bulk_load(ring + s * STAGE_WORDS + o * wl, x + (q + o) * lanes + w0,
                  (unsigned)(wl * 16), &full[s]);
    }
  };
  if (t == 0)
    for (int k = 0; k < min(STAGES, nst); ++k) load(k);
  float4 acc[LANES_PER_THREAD];
#pragma unroll
  for (int j = 0; j < LANES_PER_THREAD; ++j)
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < nst; ++k) {
    const int s = k % STAGES;
    mbar_wait(&full[s], (k / STAGES) & 1);
    const int n = min(ops, nq - k * ops);
    const float4* st = ring + s * STAGE_WORDS;
    for (int o = 0; o < n; ++o) {
#pragma unroll
      for (int j = 0; j < LANES_PER_THREAD; ++j) {
        const int l = t + j * THREADS;
        if (l < wl) add4(acc[j], st[o * wl + l]);
      }
    }
    __syncthreads();            // every thread has read stage s
    if (t == 0 && k + STAGES < nst) load(k + STAGES);
  }
#pragma unroll
  for (int j = 0; j < LANES_PER_THREAD; ++j) {
    const int l = t + j * THREADS;
    if (l < wl) partial[(size_t)blockIdx.x * lanes + w0 + l] = acc[j];
  }
}

// out[l] = sum over the slices of partial[s, l]: warp w adds the slices
// [w * chunk, (w + 1) * chunk) in order, then warp 0 adds the warps' sums in
// order.  Grid: ceil(lanes / 32) blocks of 32 * FINAL_WARPS threads.
__global__ void __launch_bounds__(32 * FINAL_WARPS)
k12_final_kernel(const float4* __restrict__ partial, float4* __restrict__ out,
                 int slices, int lanes) {
  __shared__ float4 part[FINAL_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int l = blockIdx.x * 32 + lane;
  const int chunk = (slices + FINAL_WARPS - 1) / FINAL_WARPS;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (l < lanes)
    for (int s = w * chunk; s < min(slices, (w + 1) * chunk); ++s)
      add4(acc, partial[(size_t)s * lanes + l]);
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0 && l < lanes) {
    float4 r = part[0][lane];
    for (int i = 1; i < FINAL_WARPS; ++i) add4(r, part[i][lane]);
    out[l] = r;
  }
}

bool aligned(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// x, out: n fp32 values, n a multiple of 4, 16-byte aligned; blocks: the
// blocks of COPY_THREADS words that cover n / 4 words
int ect_copy_f32(const void* x, void* out, long long n, int blocks,
                 void* stream) {
  const long long n4 = n / 4;
  if (!aligned(x) || !aligned(out)) return (int)cudaErrorMisalignedAddress;
  if (n % 4 || n4 < 1 || blocks < 1 ||
      (long long)blocks * COPY_THREADS < n4 ||
      (long long)(blocks - 1) * COPY_THREADS >= n4)
    return (int)cudaErrorInvalidValue;
  k11_copy_kernel<<<blocks, COPY_THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, n4);
  return (int)cudaGetLastError();
}

// x: (rows, cols) fp32, rows a multiple of 8, cols of 4; slices of per
// octets that cover rows / 8 octets, ops octets a ring stage (as many as a
// stage holds of a window); partial: slices * 8 * cols fp32 of scratch;
// out: (8, cols); all 16-byte aligned
int ect_reduce8_f32(const void* x, void* partial, void* out, long long rows,
                    int cols, long long per, int slices, int ops,
                    void* stream) {
  const long long octets = rows / 8;
  const int lanes = 2 * cols;
  if (!aligned(x) || !aligned(partial) || !aligned(out))
    return (int)cudaErrorMisalignedAddress;
  if (rows % 8 || octets < 1 || cols % 4 || cols < 4 || per < 1 ||
      slices < 1 || (long long)slices * per < octets ||
      (long long)(slices - 1) * per >= octets || ops < 1 ||
      (long long)ops * (lanes < WINDOW ? lanes : WINDOW) > STAGE_WORDS)
    return (int)cudaErrorInvalidValue;
  // the ring's dynamic shared memory, above the 48 KB default
  int rc = (int)cudaFuncSetAttribute(
      k12_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      STAGES * STAGE);
  if (rc != 0) return rc;
  const dim3 grid(slices, (lanes + WINDOW - 1) / WINDOW);
  k12_reduce_kernel<<<grid, THREADS, STAGES * STAGE, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)partial, octets, lanes, per, ops);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  k12_final_kernel<<<(lanes + 31) / 32, 32 * FINAL_WARPS, 0,
                     (cudaStream_t)stream>>>((const float4*)partial,
                                             (float4*)out, slices, lanes);
  return (int)cudaGetLastError();
}

// launch shapes (ect::launch_shape's info): K11 for ``blocks`` chunks,
// K12's first launch for ``blocks`` = slices x windows
int ect_copy_shape(int blocks, int* info) {
  return ect::launch_shape(k11_copy_kernel, dim3(blocks), COPY_THREADS, 0,
                           info);
}

int ect_reduce8_shape(int blocks, int* info) {
  return ect::launch_shape(k12_reduce_kernel, dim3(blocks), THREADS,
                           STAGES * STAGE, info);
}

}  // extern "C"
