// The Fourier layer's fused chirp-z pass for Hopper (sm_90a): F5, one kernel
// for a bucket's whole Bluestein pass (ops/fourier.py, pass_synthesis and
// pass_analysis), where F1, torch.fft.fft, F2, torch.fft.ifft and F3 of
// fourier_chirp.cu took five launches.
//
// Replaces no Pallas kernel: the JAX package runs these passes as XLA
// element-wise operations around its FFTs.  Added because the staged pass
// moves a complex128 (pairs, rows, nfft) array through device memory about
// eight times (F1 writes it, each FFT reads and writes it, F2 reads and
// writes it, F3 reads it), while the bytes the pass needs are its fp32 or
// fp64 inputs and outputs and the kernel FFTs.  Every nfft of TCO1279 (at
// most 7,776 points, 143 KB padded) fits one block's shared memory, so a
// block holds one (row, pair)'s nfft points there from F1 to F3 and nothing
// of the pass array crosses device memory.
//
// A block, one row and one field pair (blocks of a row's pairs adjacent, so
// that they find the row's tables in L2):
// - F1 on load, as fourier_chirp.cu's F1: zeros, then the pair's inputs
//   read straight from x (synthesis: masked, widened, times the reciprocal
//   of the RMS, Hermitian pair pack, times syn_in; a thread takes a mode's
//   two slots) or g (analysis: the points j < NLOEN, times the reciprocal of
//   the RMS, z = f_a + i f_b, times ana_in), each slot s written at the
//   position place[s] that the forward FFT's digit reversal gives it;
// - the forward FFT, in place, mixed-radix decimation in time over the
//   plan's radices (2 to 12: fp64 butterflies in registers, a pass a radix
//   through shared memory), which leaves the spectrum in natural order; its
//   last pass multiplies by the row's kernel FFT (F2) before it stores;
// - the inverse FFT, decimation in frequency over the radices in reverse
//   order, natural order in, output point j left at position place[j];
// - F3 on store, as fourier_chirp.cu's F3: times syn_out (ana_out),
//   unpacked, times the RMS, rounded once into the output; synthesis
//   writes zeros past the bucket's ndlon, analysis writes the modes m <
//   min(M, mb + 1) alone (a block writes a row's modes nrows apart, a
//   sector each: ops/fourier.py fills the output with zeros once a call,
//   which costs less than the zeros written that way).
// F1's and F3's loops issue the loads of U steps before they use them: the
// block's warps are few, and these loads come from L2.
//
// Twiddles are fp64 from a host table made in float64 (ops/fourier.py,
// twiddle_table): W^l, l < 64, then W^(64 h), so W^e is one product of a
// fine and a coarse entry, held in shared memory beside the row; a
// butterfly's R - 1 twiddles are the powers of its first.  The row is padded
// by one element every 8, so that the first pass's contiguous butterflies
// (L = 1; radix 8, 4 or 2 first where nfft is even, fft_radices) do not fall
// on one bank.  What bounds it: the passes' shared-memory round trips and
// fp64 butterflies, with as many warps an SM as registers (114 a thread) and
// shared memory allow (one 512-thread block for nfft above about 6,400);
// device memory carries the inputs, the outputs and the row's tables.
//
// launch_fused opts in to more than 48 KB of dynamic shared memory and
// takes the block size that keeps the most threads on an SM.  A block's
// dynamic shared memory is the padded row, the twiddles and the pair's two
// RMS; the caller gives its bytes (ops/fourier.py, fused_smem_bytes) and
// runs a bucket here only when they fit the card's block, else the staged
// kernels.

#include <cuda_runtime.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <utility>

#include "fourier_common.cuh"

namespace fz {

constexpr int FT = 512;       // threads a block, at most
constexpr int FINE = 64;      // fine twiddles W^l, l < FINE; coarse W^(FINE h)
constexpr int U = 4;          // F1, F3: loop steps whose loads fly together

// position i of the padded row: one element of padding every 8
__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

__device__ __forceinline__ double2 cadd(double2 a, double2 b) {
  return make_double2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ double2 csub(double2 a, double2 b) {
  return make_double2(a.x - b.x, a.y - b.y);
}

// cos and sin of 2 pi m / R, 0 < 2 m < R, correctly rounded (R in 3, 5, 6,
// 7, 8, 9, 10, 12; constant once the butterflies are unrolled)
__device__ __forceinline__ double2 kcs(int R, int m) {
  constexpr double C3 = 0.8660254037844386, C5 = 0.30901699437494745;
  constexpr double C5b = 0.8090169943749475, S5 = 0.9510565162951535;
  constexpr double S5b = 0.5877852522924731;
  if (R == 3) return make_double2(-0.5, C3);
  if (R == 6) return make_double2(m == 1 ? 0.5 : -0.5, C3);
  if (R == 10)
    return m == 1   ? make_double2(C5b, S5b)
           : m == 2 ? make_double2(C5, S5)
           : m == 3 ? make_double2(-C5, S5)
                    : make_double2(-C5b, S5b);
  if (R == 12)
    return m == 1   ? make_double2(C3, 0.5)
           : m == 2 ? make_double2(0.5, C3)
           : m == 4 ? make_double2(-0.5, C3)
                    : make_double2(-C3, 0.5);
  if (R == 5)
    return m == 1 ? make_double2(C5, S5) : make_double2(-C5b, S5b);
  if (R == 7)
    return m == 1   ? make_double2(0.6234898018587335, 0.7818314824680298)
           : m == 2 ? make_double2(-0.2225209339563144, 0.9749279121818236)
                    : make_double2(-0.9009688679024191, 0.4338837391175581);
  if (R == 8)
    return m == 1 ? make_double2(0.7071067811865476, 0.7071067811865476)
                  : make_double2(-0.7071067811865476, 0.7071067811865476);
  return m == 1   ? make_double2(0.766044443118978, 0.6427876096865394)
         : m == 2 ? make_double2(0.17364817766693036, 0.984807753012208)
         : m == 3 ? make_double2(-0.5, 0.8660254037844386)
                  : make_double2(-0.9396926207859084, 0.3420201433256687);
}

// cos and sin of 2 pi m / R, any 0 < m < R
__device__ __forceinline__ double2 kcs_any(int R, int m) {
  if (2 * m < R) return kcs(R, m);
  const double2 c = kcs(R, R - m);
  return make_double2(c.x, -c.y);
}

// v times W_R^m, W_R = e^(-2 pi i / R) (INV: its conjugate)
template <int R, bool INV>
__device__ __forceinline__ double2 rot(double2 v, int m) {
  m %= R;
  if (m == 0) return v;
  if (2 * m == R) return make_double2(-v.x, -v.y);
  if (4 * m == R)
    return INV ? make_double2(-v.y, v.x) : make_double2(v.y, -v.x);
  if (4 * m == 3 * R)
    return INV ? make_double2(v.y, -v.x) : make_double2(-v.y, v.x);
  const double2 cs = kcs_any(R, m);
  const double s = INV ? cs.y : -cs.y;
  return make_double2(v.x * cs.x - v.y * s, v.x * s + v.y * cs.x);
}

template <int R, bool INV>
struct Dft;

// an odd prime R: X_k = v_0 + sum_r (v_r + v_{R-r}) cos - i (v_r - v_{R-r})
// sin (forward), X_{R-k} the same with + i
template <int R, bool INV>
__device__ __forceinline__ void dft_odd(double2* v) {
  constexpr int H = (R - 1) / 2;
  double2 sp[H], sm[H];
#pragma unroll
  for (int r = 1; r <= H; ++r) {
    sp[r - 1] = cadd(v[r], v[R - r]);
    sm[r - 1] = csub(v[r], v[R - r]);
  }
  const double2 x0 = v[0];
  double2 sum = x0;
#pragma unroll
  for (int r = 0; r < H; ++r) sum = cadd(sum, sp[r]);
#pragma unroll
  for (int k = 1; k <= H; ++k) {
    double2 a = x0, b = make_double2(0.0, 0.0);
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const double2 cs = kcs_any(R, (r * k) % R);
      a.x += sp[r - 1].x * cs.x;
      a.y += sp[r - 1].y * cs.x;
      b.x += sm[r - 1].x * cs.y;
      b.y += sm[r - 1].y * cs.y;
    }
    if (INV) {
      v[k] = make_double2(a.x - b.y, a.y + b.x);
      v[R - k] = make_double2(a.x + b.y, a.y - b.x);
    } else {
      v[k] = make_double2(a.x + b.y, a.y - b.x);
      v[R - k] = make_double2(a.x - b.y, a.y + b.x);
    }
  }
  v[0] = sum;
}

// R = A B by Cooley-Tukey in registers: n = B n1 + n2, k = k1 + A k2
template <int A, int B, bool INV>
__device__ __forceinline__ void dft_composite(double2* v) {
  constexpr int R = A * B;
  double2 t[R];
#pragma unroll
  for (int n2 = 0; n2 < B; ++n2) {
    double2 y[A];
#pragma unroll
    for (int n1 = 0; n1 < A; ++n1) y[n1] = v[B * n1 + n2];
    Dft<A, INV>::run(y);
#pragma unroll
    for (int k1 = 0; k1 < A; ++k1) t[n2 * A + k1] = rot<R, INV>(y[k1], n2 * k1);
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    double2 z[B];
#pragma unroll
    for (int n2 = 0; n2 < B; ++n2) z[n2] = t[n2 * A + k1];
    Dft<B, INV>::run(z);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = z[k2];
  }
}

template <int R, bool INV>
struct Dft {
  static __device__ __forceinline__ void run(double2* v) { dft_odd<R, INV>(v); }
};

template <bool INV>
struct Dft<2, INV> {
  static __device__ __forceinline__ void run(double2* v) {
    const double2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
  }
};

template <bool INV>
struct Dft<4, INV> {
  static __device__ __forceinline__ void run(double2* v) {
    dft_composite<2, 2, INV>(v);
  }
};

template <bool INV>
struct Dft<6, INV> {
  static __device__ __forceinline__ void run(double2* v) {
    dft_composite<2, 3, INV>(v);
  }
};

template <bool INV>
struct Dft<10, INV> {
  static __device__ __forceinline__ void run(double2* v) {
    dft_composite<2, 5, INV>(v);
  }
};

template <bool INV>
struct Dft<12, INV> {
  static __device__ __forceinline__ void run(double2* v) {
    dft_composite<4, 3, INV>(v);
  }
};

template <bool INV>
struct Dft<8, INV> {
  static __device__ __forceinline__ void run(double2* v) {
    dft_composite<2, 4, INV>(v);
  }
};

template <bool INV>
struct Dft<9, INV> {
  static __device__ __forceinline__ void run(double2* v) {
    dft_composite<3, 3, INV>(v);
  }
};

// W_N^e (INV: its conjugate) from the fine and coarse tables
template <bool INV>
__device__ __forceinline__ double2 twiddle(const double2* tw, int e) {
  const double2 w = cmul(tw[FINE + (e >> 6)], tw[e & (FINE - 1)]);
  return INV ? make_double2(w.x, -w.y) : w;
}

// the butterflies' R - 1 twiddles W^(e r), r = 1 .. R - 1, applied to v
template <int R, bool INV>
__device__ __forceinline__ void spin(double2* v, const double2* tw, int e) {
  const double2 w1 = twiddle<INV>(tw, e);
  double2 w = w1;
#pragma unroll
  for (int r = 1; r < R; ++r) {
    v[r] = cmul(v[r], w);
    if (r + 1 < R) w = cmul(w, w1);
  }
}

// a decimation-in-time pass of radix R over blocks of L R: the butterfly
// (b, j) takes positions b L R + j + r L, its inputs times W_N^(j r N / LR);
// bh (the last forward pass): the outputs, in natural order, times it
template <int R, bool INV>
__device__ __forceinline__ void dit_pass(double2* a, const double2* tw, int N,
                                         int L, const double2* __restrict__ bh) {
  const int Ls = L * R, nbf = N / R, step = N / Ls;
  for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
    const int b = t / L, j = t - b * L;
    const int base = b * Ls + j;
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = a[pad(base + r * L)];
    if (L > 1) spin<R, INV>(v, tw, j * step);
    Dft<R, INV>::run(v);
    if (bh != nullptr) {
#pragma unroll
      for (int q = 0; q < R; ++q) v[q] = cmul(v[q], __ldg(bh + base + q * L));
    }
#pragma unroll
    for (int q = 0; q < R; ++q) a[pad(base + q * L)] = v[q];
  }
  __syncthreads();
}

// a decimation-in-frequency pass of radix R over blocks of Ls: the
// butterfly (b, j) takes positions b Ls + j + r Ls / R, its outputs times
// W_N^(j q N / Ls)
template <int R, bool INV>
__device__ __forceinline__ void dif_pass(double2* a, const double2* tw, int N,
                                         int Ls) {
  const int L = Ls / R, nbf = N / R, step = N / Ls;
  for (int t = threadIdx.x; t < nbf; t += blockDim.x) {
    const int b = t / L, j = t - b * L;
    const int base = b * Ls + j;
    double2 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = a[pad(base + r * L)];
    Dft<R, INV>::run(v);
    if (L > 1) spin<R, INV>(v, tw, j * step);
#pragma unroll
    for (int q = 0; q < R; ++q) a[pad(base + q * L)] = v[q];
  }
  __syncthreads();
}

// the plan's radices, 4 bits each from the lowest, in decimation-in-time
// order
__device__ __forceinline__ int radix(unsigned long long plan, int p) {
  return (int)((plan >> (4 * p)) & 15);
}

// digit-reversed in, natural out, times bh
__device__ void forward_fft(double2* a, const double2* tw, int N,
                            unsigned long long plan, int npass,
                            const double2* __restrict__ bh) {
  int L = 1;
  for (int p = 0; p < npass; ++p) {
    const int R = radix(plan, p);
    const double2* h = p + 1 == npass ? bh : nullptr;
    switch (R) {
      case 2: dit_pass<2, false>(a, tw, N, L, h); break;
      case 3: dit_pass<3, false>(a, tw, N, L, h); break;
      case 4: dit_pass<4, false>(a, tw, N, L, h); break;
      case 5: dit_pass<5, false>(a, tw, N, L, h); break;
      case 6: dit_pass<6, false>(a, tw, N, L, h); break;
      case 7: dit_pass<7, false>(a, tw, N, L, h); break;
      case 8: dit_pass<8, false>(a, tw, N, L, h); break;
      case 9: dit_pass<9, false>(a, tw, N, L, h); break;
      case 10: dit_pass<10, false>(a, tw, N, L, h); break;
      default: dit_pass<12, false>(a, tw, N, L, h); break;
    }
    L *= R;
  }
}

// natural in, digit-reversed out, unnormalized
__device__ void inverse_fft(double2* a, const double2* tw, int N,
                            unsigned long long plan, int npass) {
  int Ls = N;
  for (int p = npass - 1; p >= 0; --p) {
    const int R = radix(plan, p);
    switch (R) {
      case 2: dif_pass<2, true>(a, tw, N, Ls); break;
      case 3: dif_pass<3, true>(a, tw, N, Ls); break;
      case 4: dif_pass<4, true>(a, tw, N, Ls); break;
      case 5: dif_pass<5, true>(a, tw, N, Ls); break;
      case 6: dif_pass<6, true>(a, tw, N, Ls); break;
      case 7: dif_pass<7, true>(a, tw, N, Ls); break;
      case 8: dif_pass<8, true>(a, tw, N, Ls); break;
      case 9: dif_pass<9, true>(a, tw, N, Ls); break;
      case 10: dif_pass<10, true>(a, tw, N, Ls); break;
      default: dif_pass<12, true>(a, tw, N, Ls); break;
    }
    Ls /= R;
  }
}

__host__ __device__ __forceinline__ int twiddles(int nfft) {
  return FINE + (nfft + FINE - 1) / FINE;
}


// the padded row to zeros
__device__ __forceinline__ void zero_row(double2* a, int nfft) {
  for (int i = threadIdx.x; i < pad(nfft); i += blockDim.x)
    a[i] = make_double2(0.0, 0.0);
  __syncthreads();
}

// the twiddles to shared memory, and the pair's RMS (warps 0 and 1) to sc
__device__ __forceinline__ void block_setup(double2* tw, double* sc,
                                            const double2* __restrict__ twg,
                                            int nfft, const double* ss,
                                            long long ld, int fa, int nfld,
                                            double count) {
  for (int i = threadIdx.x; i < twiddles(nfft); i += blockDim.x) tw[i] = twg[i];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const double s = warp_scale(ss, ld, fa + warp, nfld, count);
    if ((threadIdx.x & 31) == 0) sc[warp] = s;
  }
  __syncthreads();
}

// F5 synthesis: grid (rows_b * npairs); block r * npairs + q
template <typename T>
__global__ void __launch_bounds__(FT)
fused_syn_kernel(const T* __restrict__ x, const int* __restrict__ mkeep,
                 const int* __restrict__ rows, const double2* __restrict__ tin,
                 const double2* __restrict__ bh,
                 const double2* __restrict__ tout,
                 const double2* __restrict__ twg,
                 const short* __restrict__ place, const double* __restrict__ ss,
                 double count, T* __restrict__ out, int nfld, int M, int nrows,
                 int ndlon, int nrows_b, int ndlon_b, int mb, int nfft,
                 unsigned long long plan, int npass, int npairs) {
  extern __shared__ double2 sm[];
  double2* a = sm;
  double2* tw = sm + pad(nfft);
  double* sc = (double*)(tw + twiddles(nfft));
  const int r = blockIdx.x / npairs;
  const int fa = 2 * (blockIdx.x - r * npairs);
  const bool hb = fa + 1 < nfld;
  const int row = rows[r];
  const int P = 2 * mb + 1;
  block_setup(tw, sc, twg, nfft, ss, NP, fa, nfld, count);
  // F1: zeros, then mode m <= min(nmen, mb) at its two slots mb + m and
  // mb - m, each input read once
  {
    zero_row(a, nfft);
    const double ra = 1.0 / sc[0], rb = 1.0 / sc[1];
    const int km = min(mkeep[row], mb);
    const long long fstride = 2LL * M * nrows;
    const long long cstride = (long long)M * nrows;
    const T* xa = x + fa * fstride + row;
    const T* xb = hb ? xa + fstride : xa;
    const double2* ti = tin + (long long)r * P + mb;
    for (int m0 = threadIdx.x; m0 <= km; m0 += U * blockDim.x) {
      double2 wp[U], wn[U];
      int pp[U], pn[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int m = m0 + u * blockDim.x;
        pp[u] = pn[u] = -1;
        if (m <= km) {
          const long long o = (long long)m * nrows;
          const double ar = (double)xa[o] * ra;
          const double ai = m > 0 ? (double)xa[o + cstride] * ra : 0.0;
          double br = 0.0, bi = 0.0;
          if (hb) {
            br = (double)xb[o] * rb;
            if (m > 0) bi = (double)xb[o + cstride] * rb;
          }
          wp[u] = cmul(make_double2(ar - bi, ai + br), ti[m]);
          wn[u] = cmul(make_double2(ar + bi, br - ai), ti[-m]);
          pp[u] = place[mb + m];
          if (m > 0) pn[u] = place[mb - m];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (pp[u] >= 0) a[pad(pp[u])] = wp[u];
        if (pn[u] >= 0) a[pad(pn[u])] = wn[u];
      }
    }
  }
  __syncthreads();
  forward_fft(a, tw, nfft, plan, npass, bh + (long long)r * nfft);
  inverse_fft(a, tw, nfft, plan, npass);
  // F3
  const double sa = sc[0], sb = sc[1];
  T* oa = out + ((long long)fa * nrows + row) * ndlon;
  T* ob = oa + (long long)nrows * ndlon;
  const double2* to = tout + (long long)r * ndlon_b;
  for (int j0 = threadIdx.x; j0 < ndlon; j0 += U * blockDim.x) {
    double2 t[U];
    int p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * blockDim.x;
      p[u] = -1;
      if (j < ndlon_b) {
        p[u] = place[j];
        t[u] = to[j];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u * blockDim.x;
      double vx = 0.0, vy = 0.0;
      if (p[u] >= 0) {
        const double2 g = cmul(a[pad(p[u])], t[u]);
        vx = g.x * sa;
        vy = g.y * sb;
      }
      if (j < ndlon) {
        oa[j] = (T)vx;
        if (hb) ob[j] = (T)vy;
      }
    }
  }
}

// F5 analysis: grid (rows_b * npairs); block r * npairs + q
template <typename T>
__global__ void __launch_bounds__(FT)
fused_ana_kernel(const T* __restrict__ g, const int* __restrict__ rows,
                 const double2* __restrict__ tin,
                 const double2* __restrict__ bh,
                 const double2* __restrict__ tout,
                 const double2* __restrict__ twg,
                 const short* __restrict__ place, const double* __restrict__ ss,
                 long long ssld, double count, T* __restrict__ out, int nfld,
                 int M, int nrows, int ndlon, int nrows_b, int ndlon_b, int mb,
                 int K, int nfft, unsigned long long plan, int npass,
                 int npairs) {
  extern __shared__ double2 sm[];
  double2* a = sm;
  double2* tw = sm + pad(nfft);
  double* sc = (double*)(tw + twiddles(nfft));
  const int r = blockIdx.x / npairs;
  const int fa = 2 * (blockIdx.x - r * npairs);
  const bool hb = fa + 1 < nfld;
  const int row = rows[r], L = rows[nrows_b + r];
  block_setup(tw, sc, twg, nfft, ss, ssld, fa, nfld, count);
  // F1: zeros, then the points j < NLOEN
  {
    zero_row(a, nfft);
    const double ra = 1.0 / sc[0], rb = 1.0 / sc[1];
    const T* ga = g + ((long long)fa * nrows + row) * ndlon;
    const T* gb = hb ? ga + (long long)nrows * ndlon : ga;
    const double2* ti = tin + (long long)r * ndlon_b;
    for (int j0 = threadIdx.x; j0 < L; j0 += U * blockDim.x) {
      double2 w[U];
      int p[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = j0 + u * blockDim.x;
        p[u] = -1;
        if (j < L) {
          const double2 v = make_double2((double)ga[j] * ra,
                                         hb ? (double)gb[j] * rb : 0.0);
          w[u] = cmul(v, ti[j]);
          p[u] = place[j];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (p[u] >= 0) a[pad(p[u])] = w[u];
    }
  }
  __syncthreads();
  forward_fft(a, tw, nfft, plan, npass, bh + (long long)r * nfft);
  inverse_fft(a, tw, nfft, plan, npass);
  // F3
  const double sa = sc[0], sb = sc[1];
  const int P = 2 * mb + 1;
  const double2* to = tout + (long long)r * P;
  const long long cstride = (long long)M * nrows;
  const long long fstride = 2 * cstride;
  T* o = out + fa * fstride + row;
  for (int m0 = threadIdx.x; m0 < K; m0 += U * blockDim.x) {
    double2 tp[U], tn[U];
    int pp[U], pn[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * blockDim.x;
      pp[u] = -1;
      if (m < K) {
        pp[u] = place[mb + m];
        pn[u] = place[mb - m];
        tp[u] = to[mb + m];
        tn[u] = to[mb - m];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int m = m0 + u * blockDim.x;
      double far = 0.0, fai = 0.0, fbr = 0.0, fbi = 0.0;
      if (pp[u] >= 0) {
        const double2 zp = cmul(a[pad(pp[u])], tp[u]);
        const double2 zn = cmul(a[pad(pn[u])], tn[u]);
        far = (zp.x + zn.x) * 0.5 * sa;
        fai = (zp.y - zn.y) * 0.5 * sa;
        fbr = (zp.y + zn.y) * 0.5 * sb;
        fbi = (zn.x - zp.x) * 0.5 * sb;
      }
      if (m < K) {
        T* om = o + (long long)m * nrows;
        om[0] = (T)far;
        om[cstride] = (T)fai;
        if (hb) {
          om[fstride] = (T)fbr;
          om[fstride + cstride] = (T)fbi;
        }
      }
    }
  }
}

// A launch of kernel over nblk blocks for rows of nfft points, with smem
// bytes of dynamic shared memory a block: opt in to
// all the dynamic shared memory a block may use on the card (one setting a
// kernel, whatever nfft), and take the block size that keeps the most
// threads on an SM (occupancy API: registers and shared memory), from 128
// (64 for the shortest rows) to FT threads and at most nfft / 4, the
// smallest of equals (more blocks an SM); found once a kernel, card and
// nfft.
template <typename... P, typename... A>
inline int launch_fused(void (*kernel)(P...), long long nblk, int nfft,
                        size_t smem, cudaStream_t st, A... args) {
  if (nblk == 0) return 0;
  static std::mutex lock;
  static std::map<std::pair<int, int>, int> chosen;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  int threads = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    const auto hit = chosen.find({dev, nfft});
    if (hit != chosen.end()) {
      threads = hit->second;
    } else {
      int optin = 0;
      rc = cudaDeviceGetAttribute(&optin,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (rc != cudaSuccess) return (int)rc;
      if (smem > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
      rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (rc != cudaSuccess) return (int)rc;
      const int cap = std::max(64, std::min(FT, (nfft / 4 + 31) / 32 * 32));
      int most = 0;
      for (int t = std::min(128, cap); t <= cap; t += 32) {
        int blocks = 0;
        rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, t,
                                                           smem);
        if (rc != cudaSuccess) return (int)rc;
        if (blocks * t > most) {
          most = blocks * t;
          threads = t;
        }
      }
      if (most == 0) return (int)cudaErrorInvalidConfiguration;
      chosen[{dev, nfft}] = threads;
    }
  }
  kernel<<<(unsigned)nblk, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace fz

// C entries: each launches on the given stream and returns
// cudaGetLastError() (0 also for an empty launch).  Pointers are device
// pointers; ss may be null (normalize=False: every scale 1).  plan: the
// radices, 4 bits each from the lowest, npass of them; smem: a block's
// dynamic shared memory in bytes.
#define FZ_FUSED_ENTRIES(T, SUF)                                              \
  extern "C" int ect_fourier_syn_fused##SUF(                                 \
      const void* x, const void* mkeep, const void* rows, const void* tin,   \
      const void* bh, const void* tout, const void* tw, const void* place,   \
      const void* ss, double count, void* out, int nfld, int M, int nrows,   \
      int ndlon, int nrows_b, int ndlon_b, int mb, int nfft, long long smem, \
      long long plan, int npass, int npairs, cudaStream_t st) {              \
    return fz::launch_fused(                                                 \
        fz::fused_syn_kernel<T>, (long long)nrows_b * npairs, nfft,          \
        (size_t)smem, st,                                                    \
        (const T*)x, (const int*)mkeep, (const int*)rows,                    \
        (const double2*)tin, (const double2*)bh, (const double2*)tout,       \
        (const double2*)tw, (const short*)place, (const double*)ss, count,    \
        (T*)out, nfld, M, nrows, ndlon, nrows_b, ndlon_b, mb, nfft,          \
        (unsigned long long)plan, npass, npairs);                            \
  }                                                                          \
  extern "C" int ect_fourier_ana_fused##SUF(                                 \
      const void* g, const void* rows, const void* tin, const void* bh,      \
      const void* tout, const void* tw, const void* place, const void* ss,   \
      long long ssld, double count, void* out, int nfld, int M, int nrows,   \
      int ndlon, int nrows_b, int ndlon_b, int mb, int K, int nfft,          \
      long long smem, long long plan, int npass, int npairs,                 \
      cudaStream_t st) {                                                     \
    return fz::launch_fused(                                                 \
        fz::fused_ana_kernel<T>, (long long)nrows_b * npairs, nfft,          \
        (size_t)smem, st,                                                    \
        (const T*)g, (const int*)rows, (const double2*)tin,                  \
        (const double2*)bh, (const double2*)tout, (const double2*)tw,        \
        (const short*)place, (const double*)ss, ssld, count, (T*)out, nfld,   \
        M, nrows, ndlon, nrows_b, ndlon_b, mb, K, nfft,                      \
        (unsigned long long)plan, npass, npairs);                            \
  }

FZ_FUSED_ENTRIES(float, _f32)
FZ_FUSED_ENTRIES(double, _f64)
