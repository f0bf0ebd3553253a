// The complex arithmetic and R-point DFTs of the port's hand-written FFTs,
// shared by csrc/verify_marker.cu and csrc/correlate_os.cu.
//
// Every operation is rounded once (the kernels build with -fmad=false and
// call the __f*_rn intrinsics), so a numpy transliteration in f32 gives the
// same bits: a complex product is (a.x b.x - a.y b.y, a.x b.y + a.y b.x),
// each product rounded; the radix 2 and 4 DFTs are exact adds and
// subtracts; any other radix R is the R-point DFT
// y_s = x_0 + sum_{r >= 1} x_r W[(r s mod R) step] in r order, W a table of
// the transform's roots exp(-2 pi i t / L) and step = L / R
// (chip_smoke.np_stockham).

#pragma once

#include <cuda_runtime.h>

namespace apd_fft {

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
__device__ __forceinline__ float2 conjugate(float2 a) { return make_float2(a.x, -a.y); }

// The R-point DFT of x, each output handed to emit(s, y_s) as soon as it is
// formed: exact for R = 2 and 4, else y_s = x_0 + sum_{r >= 1} x_r
// W[(r s mod R) step] in r order.
template <int R, class Emit>
__device__ __forceinline__ void dft_emit(const float2 (&x)[R], const float2* __restrict__ W,
                                         int step, Emit emit) {
  if constexpr (R == 2) {
    emit(0, cadd(x[0], x[1]));
    emit(1, csub(x[0], x[1]));
  } else if constexpr (R == 4) {
    const float2 t0 = cadd(x[0], x[2]), t1 = csub(x[0], x[2]);
    const float2 t2 = cadd(x[1], x[3]), t3 = csub(x[1], x[3]);
    emit(0, cadd(t0, t2));
    emit(2, csub(t0, t2));
    emit(1, make_float2(__fadd_rn(t1.x, t3.y), __fsub_rn(t1.y, t3.x)));  // t1 - i t3
    emit(3, make_float2(__fsub_rn(t1.x, t3.y), __fadd_rn(t1.y, t3.x)));  // t1 + i t3
  } else {
#pragma unroll
    for (int s = 0; s < R; ++s) {
      float2 acc = x[0];
#pragma unroll
      for (int r = 1; r < R; ++r) acc = cadd(acc, cmul(x[r], W[((r * s) % R) * step]));
      emit(s, acc);
    }
  }
}

// The R-point DFT of x into y.
template <int R>
__device__ __forceinline__ void dft(const float2 (&x)[R], float2 (&y)[R],
                                    const float2* __restrict__ W, int step) {
  dft_emit<R>(x, W, step, [&](int s, float2 v) { y[s] = v; });
}

}  // namespace apd_fft
