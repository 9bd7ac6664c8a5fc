// What the Fourier layer's kernels share (fourier_chirp.cu, fourier_fused.cu):
// the complex fp64 product and a field's RMS from F4's partial sums.
#pragma once

#include <cuda_runtime.h>

namespace fz {

constexpr int NP = 32;        // partial sums of squares a field (and bucket)

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// field f's RMS from its NP partial sums at ss[f * ld]: one warp
__device__ __forceinline__ double warp_scale(const double* ss, long long ld,
                                             int f, int nfld, double count) {
  if (ss == nullptr || f >= nfld) return 1.0;
  double v = ss[(long long)f * ld + (threadIdx.x & 31)];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const double r = sqrt(v / count);
  return r > 0.0 ? r : 1.0;
}

}  // namespace fz
