// The overlap-save correlation's second half, for sm_90a: the bank product,
// the inverse transform and the kept samples' magnitude, one kernel.
//
// Replaces the XLA program of the JAX package's overlap-save branch of
// audio_pattern_detector_tpu/ops/correlate.py::_correlate_raw (:159, the
// branch at :176-190), reached from bank_correlate (:212) and
// bank_correlate_abs (:231). It was never a Pallas kernel: XLA computes the
// product seg_spec[None] * bank[:, None], jnp.fft.irfft, the slice and abs,
// where the port wrote the (B, G, ns, N/2 + 1) product and the (B, G, ns, N)
// inverse transform to device memory and read both back.
//
// For a section batch (B, ns segment spectra of N / 2 + 1 bins each), a
// group's G conjugate clip spectra and the class geometry (N = fft_len,
// step, off = out_offset, L = full_len):
//   out[b, g, k] = |y_{b,g,s}[t]|  for k + off = s step + t, 0 <= t < step,
//   y_{b,g,s} = irfft_N(seg[b, s] * bank[g])  ("backward" scaling, 1 / N).
//
// Design. One CTA a transform (b, g, s), its N / 2 complex values in
// shared memory (128 KB at N = 32,768, by the opt-in attribute):
//   * it reads the two spectra (they stay in L2: a row's segment spectra
//     and a group's bank are a few MB) and forms the product P = seg * bank
//     as it loads, two bins (k, N/2 - k) a thread;
//   * it folds the Hermitian half spectrum into an N/2-point complex one,
//     the C2R form of the separation pass of csrc/verify_marker.cu: with
//     w = exp(-2 pi i / N), u = conj P[k] and v = P[N/2 - k],
//     A[k] = E - i w^k D, E = u + v, D = u - v (k < N/2); the forward
//     transform of A is N conj(z), z[j] = y[2j] + i y[2j + 1];
//   * it runs that forward transform in place as Stockham passes over the
//     shared buffer (radix-4 passes while four more points fit, then one
//     radix 2 where N/2 is not a power of 4; pass with radix R after p
//     points: butterfly i reads x_r = buf[i + r N/(2R)], k = i mod p,
//     x_r *= W[r k N / (2 p R)], W = exp(-2 pi i / (N/2)), the exact
//     R-point DFT of csrc/fft_common.cuh, writes buf[(i - k) R + k + s p]);
//     each thread holds its 16 values in registers across a barrier, so
//     one buffer suffices; two radix-4 passes in a row run in registers
//     between one pair of barriers (pass_pair4: their butterflies fall
//     into groups of 16 values that only feed each other), and each pass
//     reads its twiddles from a table of its own, contiguous in k (the
//     same f32 values as W's), so N = 32,768 is four exchanges of the
//     buffer;
//   * it writes only |y[t]| / N for the t < step whose output index falls in
//     [0, L), coalesced (the buffer's values are z[t / 2], conj z up to
//     sign). Nothing else goes to device memory.
// The buffer's values sit at swizzled places (sw), which moves no bit of
// the arithmetic.
// Each transform is computed alone and the same way at any index, so a
// row's bits do not depend on the round's width, its index or G.
//
// Arithmetic order. Built with -fmad=false: every product and sum is
// rounded once (csrc/fft_common.cuh); P = cmul(seg, bank); A = (E.x + t.y,
// E.y - t.x) with t = cmul(w^k, D); the output is fabsf(y) * (1 / N), exact
// scaling. chip_smoke.np_correlate_os transliterates it. The values are not
// cuFFT's bits: the plain version (ops/correlate_os.py) keeps cuFFT.
//
// Bound: the output, B G L floats written once (1.02 GB for a 16-row
// flagship round's group, 0.31 ms at 3.35 TB/s), beside the spectra read
// once; the transforms' 2.5 N log2 N operations over the f32 rate are below
// it. A CTA takes the whole buffer, so one CTA an SM runs at N = 32,768, and
// each exchange of the buffer (the fold, four for the passes, the write) is
// a barrier the CTA's warps wait at with nothing else resident: the kernel
// is latency-bound, at about a sixth of its byte bound on the 16-row round
// (PERF.md section 7 splits a CTA's cycles by step).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fft_common.cuh"

namespace {

using namespace apd_fft;

constexpr int kPerThread = 16;                         // complex values a thread holds in a pass
constexpr int kMaxHalf = 16384;                        // N / 2 at N = 32,768
constexpr int kMaxThreads = kMaxHalf / kPerThread;     // 1,024
constexpr int kMaxPasses = 7;                          // log4(kMaxHalf), or 6 fours and a 2

struct Args {
  const float2* seg;        // (B, ns, H + 1)
  const float2* bank;       // (G, H + 1)
  const float2* post;       // (H + 1,) exp(-2 pi i k / N)
  const float2* pass_tw[kMaxPasses];  // pass q's (p, R - 1) twiddles W[r k stride]
  float* out;               // (B, G, L)
  long long L;
  int G, ns, half, step, off;
  float inv_n;
};

// Where logical value idx of the buffer lives: its low 4 bits XORed with
// the next 4, so that 32 threads writing values 16 apart (the first pass
// pair) hit 16 bank pairs, not one; a bijection of [0, H), and contiguous
// runs stay conflict-free.
__device__ __forceinline__ int sw(int idx) { return idx ^ ((idx >> 4) & 15); }

// One in-place Stockham pass of radix R (2 or 4) over the H-point buffer:
// every thread loads its butterflies' inputs, the block meets at a barrier,
// then each thread writes its outputs.
template <int R>
__device__ __forceinline__ void pass(float2* buf, int H, int p, const float2* __restrict__ tw) {
  constexpr int kB = kPerThread / R;  // butterflies a thread holds
  const int T = H / R;
  const int threads = blockDim.x;
  float2 x[kB][R];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int i = threadIdx.x + j * threads;
    if (i < T) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[j][r] = buf[sw(i + r * T)];
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int i = threadIdx.x + j * threads;
    if (i < T) {
      const int k = i & (p - 1);
#pragma unroll
      for (int r = 1; r < R; ++r) x[j][r] = cmul(x[j][r], tw[k * (R - 1) + r - 1]);
      const int dst = (i - k) * R + k;
      dft_emit<R>(x[j], nullptr, 0, [&](int s, float2 v) { buf[sw(dst + s * p)] = v; });
    }
  }
  __syncthreads();
}

// Two radix-4 passes, after p and after 4p points, in registers: the same
// operations as two pass<4> calls. Thread g takes group (j, k0) = (g / p,
// g mod p): the first pass's butterflies (j + r' H / (16 p)) p + k0, r' < 4
// (one twiddle set, k = k0), whose outputs s are the inputs r' of the
// second pass's butterfly j 4p + s p + k0, which writes buf[(4 j + s') 4p +
// s p + k0]. Sixteen values a thread, one barrier pair for two passes.
__device__ __forceinline__ void pass_pair4(float2* buf, int H, int p,
                                           const float2* __restrict__ tw1,
                                           const float2* __restrict__ tw2) {
  const int T = H / 4;
  const int J = H / (16 * p);
  const int g = threadIdx.x;
  const bool active = g < H / 16;
  const int j = g / p;
  const int k0 = g & (p - 1);
  float2 x[4][4];
  if (active) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int i = (j + rr * J) * p + k0;
#pragma unroll
      for (int r = 0; r < 4; ++r) x[rr][r] = buf[sw(i + r * T)];
    }
  }
  __syncthreads();
  if (active) {
    float2 w[4];
#pragma unroll
    for (int r = 1; r < 4; ++r) w[r] = tw1[k0 * 3 + r - 1];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int r = 1; r < 4; ++r) x[rr][r] = cmul(x[rr][r], w[r]);
      float2 y[4];
      dft<4>(x[rr], y, nullptr, 0);
#pragma unroll
      for (int s = 0; s < 4; ++s) x[rr][s] = y[s];
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = s * p + k0;
      float2 z[4];
      z[0] = x[0][s];
#pragma unroll
      for (int rr = 1; rr < 4; ++rr) z[rr] = cmul(x[rr][s], tw2[k * 3 + rr - 1]);
      const int dst = j * 16 * p + k;
      dft_emit<4>(z, nullptr, 0, [&](int s2, float2 v) { buf[sw(dst + s2 * 4 * p)] = v; });
    }
  }
  __syncthreads();
}

// A[k] from u = conj P[k] and v = P[H - k].
__device__ __forceinline__ float2 fold(float2 pk, float2 pm, float2 w) {
  const float2 u = conjugate(pk);
  const float2 e = cadd(u, pm);
  const float2 t = cmul(w, csub(u, pm));
  return make_float2(__fadd_rn(e.x, t.y), __fsub_rn(e.y, t.x));
}

__global__ void __launch_bounds__(kMaxThreads, 1)
    correlate_os_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float2 buf[];
  const int H = a.half;
  const long long cta = blockIdx.x;
  const int s = static_cast<int>(cta % a.ns);
  const long long bg = cta / a.ns;  // b G + g
  const int g = static_cast<int>(bg % a.G);
  const long long b = bg / a.G;
  // The kept samples t in [t_lo, t_hi): output index s step + t - off in [0, L).
  const long long lo = static_cast<long long>(s) * a.step - a.off;
  const long long t_lo = lo < 0 ? -lo : 0;
  const long long t_hi = a.L - lo < a.step ? a.L - lo : a.step;
  if (t_hi <= t_lo) return;  // the whole CTA: no sample of this transform is kept

  const float2* __restrict__ seg = a.seg + (b * a.ns + s) * (H + 1);
  const float2* __restrict__ bank = a.bank + static_cast<long long>(g) * (H + 1);
  const int half = H / 2;
#pragma unroll 4
  for (int k = threadIdx.x; k < half; k += blockDim.x) {
    const int m = H - k;
    const float2 pk = cmul(seg[k], bank[k]);
    const float2 pm = cmul(seg[m], bank[m]);
    buf[sw(k)] = fold(pk, pm, a.post[k]);
    if (k > 0) buf[sw(m)] = fold(pm, pk, a.post[m]);
  }
  if (threadIdx.x == 0) {  // k = H / 2, its own partner
    const float2 pk = cmul(seg[half], bank[half]);
    buf[sw(half)] = fold(pk, pk, a.post[half]);
  }
  __syncthreads();

  // The radix-4 passes two at a time, then the one 4 or 2 left over.
  int p = 1, q = 0;
  for (; 16 * p <= H; p *= 16, q += 2) pass_pair4(buf, H, p, a.pass_tw[q], a.pass_tw[q + 1]);
  if (4 * p <= H) {
    pass<4>(buf, H, p, a.pass_tw[q++]);
    p *= 4;
  }
  if (2 * p <= H) pass<2>(buf, H, p, a.pass_tw[q]);

  const float* y = reinterpret_cast<const float*>(buf);
  float* out = a.out + bg * a.L + lo;
  for (int t = static_cast<int>(t_lo) + threadIdx.x; t < t_hi; t += blockDim.x)
    out[t] = __fmul_rn(fabsf(y[2 * sw(t >> 1) + (t & 1)]), a.inv_n);
}

}  // namespace

// C interface for ctypes. seg (B, ns, n / 2 + 1) and bank (G, n / 2 + 1)
// complex64, contiguous; tables f32 on the device, complex values
// interleaved: the n / 2 + 1 separation twiddles exp(-2 pi i k / n), then
// for each pass q of the plan (radix R after p points: 4s while 4p <= n / 2,
// then a 2 where 2p <= n / 2) its p (R - 1) twiddles W[r k n / (2 p R)] at
// k (R - 1) + r - 1 (ops/correlate_os.py builds them); out (B, G, L) f32.
// n a power of two from 4 to 32,768; 1 <= step <= n; ns step >= L + off.
// All on the current device. Returns the CUDA error code of the launch
// (0 on success).
extern "C" int apd_correlate_os(const void* seg, long long B, int ns, const void* bank, int G,
                                int n, int step, int off, long long L, const float* tables,
                                float* out, void* stream) {
  if (B <= 0 || G <= 0 || L <= 0) return 0;
  const int H = n / 2;
  if (n < 4 || n > 2 * kMaxHalf || (n & (n - 1)) != 0 || ns < 1 || step < 1 || step > n ||
      off < 0 || static_cast<long long>(ns) * step < L + off || B * G * ns >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.post = reinterpret_cast<const float2*>(tables);
  const float2* tw = a.post + H + 1;
  for (int p = 1, q = 0; p < H; ++q) {
    const int R = 4 * p <= H ? 4 : 2;
    a.pass_tw[q] = tw;
    tw += p * (R - 1);
    p *= R;
  }
  a.seg = static_cast<const float2*>(seg);
  a.bank = static_cast<const float2*>(bank);
  a.out = out;
  a.L = L;
  a.G = G;
  a.ns = ns;
  a.half = H;
  a.step = step;
  a.off = off;
  a.inv_n = 1.0f / static_cast<float>(n);
  const int threads = H / kPerThread < 32 ? 32 : H / kPerThread;
  const size_t smem = static_cast<size_t>(H) * sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(correlate_os_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  correlate_os_kernel<<<static_cast<unsigned>(B * G * ns), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
