// Arithmetic shared by the dense-row (K1, K2, K7, K8) and parity-split (K5,
// K6) Legendre kernels: compensated chunk sums; the operand and table
// types of each variant; the launch report of the pipelined K7 and K8, and
// the resident slots that K2's, K6's and K8's splits are sized from.
//
// A kernel variant is a pair (T, P): T the arithmetic and operand type
// (float or double), P the table's storage type.  P = T is the "highest"
// arithmetic.  P = bf16 (with T = float) is the "bf16" tier: the table is
// stored in bfloat16, and each operand entry is rounded to bf16 as it is
// staged, so every product of two bf16 values is exact in fp32 (the TPU
// kernels' single-pass mode "bf16", legendre_pallas.py _dot); the sums are
// the same compensated fp32 sums as at "highest".

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <type_traits>

namespace ect {

typedef __nv_bfloat16 bf16;

// sum += x with the rounding error of the addition kept in comp (Knuth's
// TwoSum): the sums run over up to ~1300 terms, and a single running fp32
// sum loses ~sqrt(n) times more than per-chunk sums folded in this way,
// which the 100*eps round-trip gate at TCO1279 does not allow
template <typename T>
__device__ __forceinline__ void add_compensated(T& sum, T& comp, T x) {
  const T s = sum + x;
  const T bb = s - sum;
  comp += (sum - (s - bb)) + (x - bb);
  sum = s;
}

// a table entry in the arithmetic type
__device__ __forceinline__ float table_value(float p) { return p; }
__device__ __forceinline__ double table_value(double p) { return p; }
__device__ __forceinline__ float table_value(bf16 p) {
  return __bfloat162float(p);
}

// an operand entry as it enters the products of a (T, P) variant
template <typename T, typename P>
__device__ __forceinline__ T operand(T x) {
  if constexpr (std::is_same<P, bf16>::value) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// info[0..4] = blocks per launch, threads per block, dynamic shared bytes,
// resident blocks per SM (occupancy API), SMs of the current device
template <typename Kernel>
inline int launch_shape(Kernel kernel, dim3 grid, int threads, int smem,
                        int* info) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0, dev = 0, sms = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  info[0] = (int)(grid.x * grid.y * grid.z);
  info[1] = threads;
  info[2] = smem;
  info[3] = per_sm;
  info[4] = sms;
  return (int)e;
}

// resident blocks of KERNEL on the card (blocks an SM x SMs) at `threads`
// threads and `smem` bytes of dynamic shared memory, for the launches that
// size a split from it (K2, K6, K8): asked of the occupancy API once per
// kernel, on the device of its first launch, since asked at every launch it
// costs host time on the main path
template <auto KERNEL>
inline int resident_slots(int threads, int smem, long* slots) {
  static std::atomic<long> cached{0};
  *slots = cached.load(std::memory_order_relaxed);
  if (*slots > 0) return 0;
  int info[5];
  const int e = launch_shape(KERNEL, dim3(1), threads, smem, info);
  if (e != 0) return e;
  *slots = (long)info[3] * info[4];
  cached.store(*slots, std::memory_order_relaxed);
  return 0;
}

}  // namespace ect
