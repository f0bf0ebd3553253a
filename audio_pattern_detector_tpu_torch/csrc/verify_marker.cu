// The marker-tone verifier, whole, for sm_90a: the spectra of live lanes
// and the decisions on them, in one kernel.
//
// Replaces the XLA program of the JAX package's marker verifier,
// audio_pattern_detector_tpu/ops/verify.py::verify_marker (ops/verify.py:324,
// its rfft at :349-352 and :377-386). It was never a Pallas kernel: XLA fuses
// the window gather, the Hann products, the FFTs and the decisions into the
// class step's program, where the port ran torch's rfft over every lane's
// three windows and frames, live or dead, and then the decisions.
//
// For each lane (r, k) of (R, K), row r against clip g = r % G (rows are
// round-major, R = B * G; row r reads section r / G):
//   * the 3m-sample window [lag - m, lag + 2m) of the section, lag = pos -
//     (m - 1), its start clamped as the plain version pads the section by
//     m + 8 zeros a side; the left flank, the match and the right flank are
//     its thirds, each multiplied by hann_whole, and the match's F frames of
//     wl samples (starts f * hop) by hann_frame;
//   * the magnitude rfft of each (3 x Fw and F x Ff bins);
//   * purity of each window: band energy over energy (power = magnitude
//     squared), 0 where the energy is not positive; freq_ok: |f - dom| <=
//     0.05 max(|f|, dom) for f the match window's argmax frequency (argmax on
//     the magnitude, the first maximum);
//   * per frame: its argmax frequency, purity and energy; locked = |f - dom|
//     <= lock_hz; active = energy > 0 & locked & purity >= 0.55;
//   * frame_count (frames with energy), active_count, the longest run of
//     active frames, the mean purity of the active frames, and the ratio
//     active_count / frame_count (each 0 without frames);
//   * accept = alive & freq_ok & purity_match >= t0 & ratio >= t1 &
//     longest >= t2 & mean_purity >= t3 & min flank purity <= t4 & max flank
//     purity <= t5, the clip's six thresholds.
//
// Design. Only accept leaves the kernel (and, for a test, the magnitudes
// through an optional probe pointer the card's paths never pass). Live
// lanes are compacted by rank (live_lanes.cuh) and shared out evenly over
// the CTAs; a dead lane writes accept = 0 and nothing else. A live lane is
// one CTA's work, in its work area: the raw window (cp.async copies, zero
// where the padded section is), then two buffers the transforms ping-pong
// between. Shared memory holds the work area where it fits (the wrapper's
// layout, ops/marker_fft.py); a longer clip's work area is a slot of a
// global workspace, one slot per CTA. The per-frame results (2 floats a
// frame) stay in shared memory up to kMaxFrames frames; a clip with more
// (past 51 s at 8 or 16 kHz) keeps them in its slot too. The transforms
// (the plan's tables read from device memory, where they stay in L2):
//   * a real window of even length n is a complex transform of n / 2 points
//     of its (even, odd) sample pairs, then a separation pass
//     X[k] = (E - i w^k O) / 2, E = Z[k] + conj Z[N - k], O = Z[k] -
//     conj Z[N - k], w = exp(-2 pi i / n); an odd length is a complex
//     transform of n points with a zero imaginary part;
//   * a complex transform is a Stockham autosort FFT, one pass a radix of
//     the plan (pass with radix R after p points: butterfly i of N / R reads
//     x_r = in[i + r N / R], k = i mod p, multiplies x_r by W[r k N / (p R)],
//     takes the R-point DFT and writes out[(i - k) R + k + s p]); radix 2 and
//     4 butterflies are exact add/sub, others the R-point DFT y_s = x_0 +
//     sum_{r >= 1} x_r W[(r s mod R) N / R] in r order;
//   * a length with a prime factor past 31 is Bluestein's: a = z * chirp
//     padded to M, A = FFT_M(a), D = conj(A * S) with S the chirp spectrum
//     over M, Z[k] = chirp[k] * conj(FFT_M(D)[k]).
// The transforms of a batch (the three whole windows, or a batch of frames)
// run as one set of passes, the block's threads over every butterfly.
// Then the decisions: a window's sums and argmax as block reductions, a
// frame's as a warp's, then one thread folds the frames in order.
//
// Arithmetic order. Built with -fmad=false: a complex product is (a.x b.x -
// a.y b.y, a.x b.y + a.y b.x), each product rounded; a magnitude is
// sqrt(re^2 + im^2) rounded once; the powers are magnitude squared, the
// purities and the ratio IEEE divisions. Sums: thread t adds bins t, t +
// kThreads, ... (a frame's lane l adds bins l, l + 32, ...), then xor-shuffle
// folds with offsets 16, 8, 4, 2, 1 (across warps, the kThreads / 32 warp
// sums padded with zeros to 32); the active frames' purities add in frame
// order. chip_smoke.np_marker_fft and np_marker_decisions transliterate it.
// The spectra are not cuFFT's bits: the decisions compare sums with
// thresholds, and the accept bits are held equal to the plain version's.
//
// Bound: a lane must read its window (3m x 4 B) and its clip's masks, and
// the transforms' flops (about 5 n log2 n each) over the card's f32 rate; a
// launch's bound is those of its live lanes. A lane's chain of passes and
// barriers makes a launch with few live lanes latency-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fft_common.cuh"
#include "live_lanes.cuh"

namespace {

using namespace apd_fft;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRadices = 24;  // ops/marker_fft.py MAX_RADICES
constexpr int kMaxPrime = 31;    // ops/marker_fft.py MAX_PRIME
constexpr int kMaxFrames = 4096;  // frames in shared memory, ops/marker_fft.py MAX_FRAMES
constexpr int kPad = 8;           // the plain version's WINDOW_PAD

// One real transform's plan (ops/marker_fft.py PlanDesc); offsets in floats
// into the launch's table, -1 where the plan has no such table.
struct RealPlan {
  int n, half, size, bluestein, nrad;
  int rad[kMaxRadices];
  int off_twiddles, off_post, off_chirp, off_chirp_spectrum;
};

struct ArgMax {
  float v;
  int i;
};

// The better of two (value, index) pairs: the larger value, ties (and two
// NaN-free equal values) to the lower index: torch.argmax's first maximum.
__device__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ ArgMax warp_argmax(ArgMax a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = better(a, o);
  }
  return a;
}

template <int N>
__device__ void warp_sum(float (&v)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[n] = __fadd_rn(v[n], __shfl_xor_sync(0xffffffffu, v[n], off));
  }
}

// Block-wide sums of N values and one argmax; every thread returns them.
template <int N>
__device__ ArgMax block_reduce(float (&v)[N], ArgMax a, float* red, ArgMax* red_arg) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_sum<N>(v);
  a = warp_argmax(a);
  if (lane == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) red[n * 32 + warp] = v[n];
    red_arg[warp] = a;
  }
  __syncthreads();
  if (warp == 0) {
    float s[N];
#pragma unroll
    for (int n = 0; n < N; ++n) s[n] = lane < kWarps ? red[n * 32 + lane] : 0.0f;
    warp_sum<N>(s);
    ArgMax b = lane < kWarps ? red_arg[lane] : ArgMax{-INFINITY, 0x7fffffff};
    b = warp_argmax(b);
    if (lane == 0) {
#pragma unroll
      for (int n = 0; n < N; ++n) red[n * 32] = s[n];
      red_arg[0] = b;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = red[n * 32];
  a = red_arg[0];
  __syncthreads();
  return a;
}

__device__ float purity(float band_energy, float energy) {
  return energy > 0.0f ? __fdiv_rn(band_energy, fmaxf(energy, 1e-38f)) : 0.0f;
}

// One Stockham pass of radix R over `batch` transforms of L points.
template <int R>
__device__ void stockham_pass(const float2* __restrict__ in, float2* __restrict__ out, int L,
                              int p, int batch, const float2* __restrict__ W) {
  const int T = L / R;
  const int stride = L / (p * R);
  const int total = batch * T;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int b = idx / T;
    const int i = idx - b * T;
    const int k = i % p;
    const float2* src = in + static_cast<long long>(b) * L + i;
    float2 x[R], y[R];
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = src[r * T];
#pragma unroll
    for (int r = 1; r < R; ++r) x[r] = cmul(x[r], W[r * k * stride]);
    dft<R>(x, y, W, T);
    float2* dst = out + static_cast<long long>(b) * L + (i - k) * R + k;
#pragma unroll
    for (int s = 0; s < R; ++s) dst[s * p] = y[s];
  }
}

// The same pass for an odd prime radix up to kMaxPrime known at run time.
__device__ void stockham_pass_prime(int R, const float2* __restrict__ in, float2* __restrict__ out,
                                    int L, int p, int batch, const float2* __restrict__ W) {
  const int T = L / R;
  const int stride = L / (p * R);
  const int total = batch * T;
  for (int idx = threadIdx.x; idx < total; idx += kThreads) {
    const int b = idx / T;
    const int i = idx - b * T;
    const int k = i % p;
    const float2* src = in + static_cast<long long>(b) * L + i;
    float2 x[kMaxPrime];
    for (int r = 0; r < R; ++r) x[r] = src[r * T];
    for (int r = 1; r < R; ++r) x[r] = cmul(x[r], W[r * k * stride]);
    float2* dst = out + static_cast<long long>(b) * L + (i - k) * R + k;
    for (int s = 0; s < R; ++s) {
      float2 acc = x[0];
      for (int r = 1; r < R; ++r) acc = cadd(acc, cmul(x[r], W[((r * s) % R) * T]));
      dst[s * p] = acc;
    }
  }
}

// The plan's passes over `batch` transforms of L points, ping-ponging
// between a and b; returns the buffer that holds the result.
__device__ float2* stockham(const RealPlan& P, int L, float2* a, float2* b, int batch,
                            const float2* __restrict__ W) {
  int p = 1;
  for (int s = 0; s < P.nrad; ++s) {
    const int R = P.rad[s];
    switch (R) {
      case 2: stockham_pass<2>(a, b, L, p, batch, W); break;
      case 3: stockham_pass<3>(a, b, L, p, batch, W); break;
      case 4: stockham_pass<4>(a, b, L, p, batch, W); break;
      case 5: stockham_pass<5>(a, b, L, p, batch, W); break;
      case 7: stockham_pass<7>(a, b, L, p, batch, W); break;
      case 8: stockham_pass<8>(a, b, L, p, batch, W); break;
      default: stockham_pass_prime(R, a, b, L, p, batch, W); break;
    }
    __syncthreads();
    float2* t = a;
    a = b;
    b = t;
    p *= R;
  }
  return a;
}

// The magnitude rfft of `batch` real windows: sample t of window j is
// src(j, t) * hann[t]. Returns the magnitudes, batch x (n / 2 + 1) floats,
// in whichever of bufA / bufB they end in (the other is scratch).
template <class Src>
__device__ float* rfft_magnitudes(const RealPlan& P, const float* __restrict__ tables,
                                  const float* __restrict__ hann, int batch, Src src,
                                  float* bufA, float* bufB) {
  const int N = P.size;
  const int L = P.bluestein ? P.bluestein : N;
  const float2* W = reinterpret_cast<const float2*>(tables + P.off_twiddles);
  const float2* chirp =
      P.bluestein ? reinterpret_cast<const float2*>(tables + P.off_chirp) : nullptr;
  float2* a = reinterpret_cast<float2*>(bufA);
  float2* b = reinterpret_cast<float2*>(bufB);
  for (int idx = threadIdx.x; idx < batch * L; idx += kThreads) {
    const int j = idx / L;
    const int t = idx - j * L;
    float2 z = make_float2(0.0f, 0.0f);
    if (t < N) {
      if (P.half) {
        z = make_float2(__fmul_rn(src(j, 2 * t), hann[2 * t]),
                        __fmul_rn(src(j, 2 * t + 1), hann[2 * t + 1]));
      } else {
        z = make_float2(__fmul_rn(src(j, t), hann[t]), 0.0f);
      }
      if (P.bluestein) z = cmul(z, chirp[t]);
    }
    a[idx] = z;
  }
  __syncthreads();
  float2* z = stockham(P, L, a, b, batch, W);
  float2* o = z == a ? b : a;
  if (P.bluestein) {
    const float2* spec = reinterpret_cast<const float2*>(tables + P.off_chirp_spectrum);
    for (int idx = threadIdx.x; idx < batch * L; idx += kThreads)
      z[idx] = conjugate(cmul(z[idx], spec[idx % L]));
    __syncthreads();
    float2* e = stockham(P, L, z, o, batch, W);
    o = e == z ? o : z;
    for (int idx = threadIdx.x; idx < batch * N; idx += kThreads) {
      const int j = idx / N;
      const int k = idx - j * N;
      o[static_cast<long long>(j) * L + k] =
          cmul(chirp[k], conjugate(e[static_cast<long long>(j) * L + k]));
    }
    __syncthreads();
    z = o;
    o = e;
  }
  const int bins = P.n / 2 + 1;
  float* mag = reinterpret_cast<float*>(o);
  const float2* post =
      P.half ? reinterpret_cast<const float2*>(tables + P.off_post) : nullptr;
  for (int idx = threadIdx.x; idx < batch * bins; idx += kThreads) {
    const int j = idx / bins;
    const int k = idx - j * bins;
    const float2* zj = z + static_cast<long long>(j) * L;
    float2 X;
    if (P.half) {
      const float2 u = zj[k % N];
      const float2 v = conjugate(zj[(N - k) % N]);
      const float2 e = cadd(u, v);
      const float2 t = cmul(post[k], csub(u, v));
      X = make_float2(__fmul_rn(__fadd_rn(e.x, t.y), 0.5f), __fmul_rn(__fsub_rn(e.y, t.x), 0.5f));
    } else {
      X = zj[k];
    }
    mag[idx] = __fsqrt_rn(__fadd_rn(__fmul_rn(X.x, X.x), __fmul_rn(X.y, X.y)));
  }
  __syncthreads();
  return mag;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 4 : 0));
}

struct Args {
  const float* section;  // (B, S)
  long long S;
  const long long* pos;
  const unsigned char* alive;
  long long n_lanes;
  int K, G, m, hop, n_frames;
  int window, whole_batch, frame_batch, buffer;  // the layout (ops/marker_fft.py), in floats
  int on_chip;                                   // the work area in shared memory
  int frames_on_chip;                            // the per-frame results in shared memory
  float* workspace;  // else a slot a CTA: window + 2 buffer floats, then the frames' 2 a frame
  RealPlan whole, frame;
  const float* tables;
  const float* hann_whole;
  const float* hann_frame;
  const float* freqs_whole;
  const unsigned char* band_whole;
  const float* dom_freq;
  const float* lock_hz;
  const float* freqs_frame;
  const unsigned char* band_frame;
  const float* thresholds;
  unsigned char* accept;
  float* probe;  // null, or per lane the 3 Fw whole and F Ff frame magnitudes
};

__global__ void __launch_bounds__(kThreads)
    verify_marker_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2 * 32];
  __shared__ ArgMax red_arg[32];
  __shared__ unsigned short list[kThreads * live_lanes::kPerThread];
  __shared__ int scan[32];
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;
  const int m = a.m;
  const int fw = m / 2 + 1;
  const int ff = a.frame.n / 2 + 1;
  const long long slot = a.window + 2LL * a.buffer + (a.frames_on_chip ? 0 : 2LL * a.n_frames);
  float* work = a.on_chip ? smem + 2 * a.n_frames
                          : a.workspace + static_cast<long long>(blockIdx.x) * slot;
  // Per frame: purity, then active (1, 0, or -1 without energy).
  float* frame_out = a.frames_on_chip ? smem : work + a.window + 2LL * a.buffer;
  float* win = work;
  float* bufA = work + a.window;
  float* bufB = bufA + a.buffer;

  auto dead = [&](long long lane) { a.accept[lane] = 0; };
  auto live = [&](long long lane) {
    const long long row = lane / a.K;
    const int g = static_cast<int>(row % a.G);
    const float dom = a.dom_freq[g];
    // The window [lag - m, lag + 2m) of the section zero-padded by m + kPad
    // a side, its start clamped into the padded section.
    const float* sec = a.section + (row / a.G) * a.S;
    long long start = a.pos[lane] - (m - 1) + kPad;
    const long long upper = a.S + 2LL * (m + kPad) - 3LL * m;
    start = start < 0 ? 0 : start;  // torch.clamp's order: the lower bound, then the upper
    start = start > upper ? upper : start;
    const long long base = start - (m + kPad);  // section index of the window's first sample
    if (a.on_chip) {
      for (int t = tid; t < 3 * m; t += kThreads) {
        const long long idx = base + t;
        const bool in = idx >= 0 && idx < a.S;
        cp_async4(win + t, in ? sec + idx : sec, in);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
      for (int t = tid; t < 3 * m; t += kThreads) {
        const long long idx = base + t;
        win[t] = idx >= 0 && idx < a.S ? sec[idx] : 0.0f;
      }
    }
    __syncthreads();
    float* probe = a.probe ? a.probe + lane * (3LL * fw + static_cast<long long>(a.n_frames) * ff)
                           : nullptr;

    // The frames, frame_batch at a time: one warp a frame.
    const unsigned char* fband = a.band_frame + static_cast<long long>(g) * ff;
    for (int f0 = 0; f0 < a.n_frames; f0 += a.frame_batch) {
      const int nf = min(a.frame_batch, a.n_frames - f0);
      const float* match = win + m;
      const int hop = a.hop;
      const float* mag = rfft_magnitudes(
          a.frame, a.tables, a.hann_frame, nf,
          [=](int j, int t) { return match[(f0 + j) * hop + t]; }, bufA, bufB);
      if (probe)
        for (int i = tid; i < nf * ff; i += kThreads) probe[3LL * fw + f0 * ff + i] = mag[i];
      const float lock = a.lock_hz[g];
      for (int f = warp; f < nf; f += kWarps) {
        float fs[2] = {0.0f, 0.0f};
        ArgMax fb{-INFINITY, 0x7fffffff};
        for (int i = lane_id; i < ff; i += 32) {
          const float x = mag[f * ff + i];
          const float p = __fmul_rn(x, x);
          fs[0] = __fadd_rn(fs[0], p);
          fs[1] = __fadd_rn(fs[1], fband[i] ? p : 0.0f);
          fb = better(fb, ArgMax{x, i});
        }
        warp_sum<2>(fs);
        fb = warp_argmax(fb);
        if (lane_id == 0) {
          const bool nonzero = fs[0] > 0.0f;
          const float pur = purity(fs[1], fs[0]);
          const bool locked = fabsf(__fsub_rn(a.freqs_frame[fb.i], dom)) <= lock;
          frame_out[2 * (f0 + f)] = pur;
          frame_out[2 * (f0 + f) + 1] = nonzero ? (locked && pur >= 0.55f ? 1.0f : 0.0f) : -1.0f;
        }
      }
      __syncthreads();  // the buffers are rewritten by the next batch
    }

    // The three whole windows, whole_batch at a time: energy and band
    // energy of each, and the match window's argmax.
    const unsigned char* band = a.band_whole + static_cast<long long>(g) * fw;
    float energy[3], band_energy[3];
    int match_arg = 0;
    for (int w0 = 0; w0 < 3; w0 += a.whole_batch) {
      const int nw = min(a.whole_batch, 3 - w0);
      const float* mag = rfft_magnitudes(
          a.whole, a.tables, a.hann_whole, nw,
          [=](int j, int t) { return win[(w0 + j) * m + t]; }, bufA, bufB);
      if (probe)
        for (int i = tid; i < nw * fw; i += kThreads) probe[w0 * fw + i] = mag[i];
      for (int j = 0; j < nw; ++j) {
        const int s = w0 + j;
        float sums[2] = {0.0f, 0.0f};
        ArgMax best{-INFINITY, 0x7fffffff};
        for (int i = tid; i < fw; i += kThreads) {
          const float x = mag[j * fw + i];
          const float p = __fmul_rn(x, x);
          sums[0] = __fadd_rn(sums[0], p);
          sums[1] = __fadd_rn(sums[1], band[i] ? p : 0.0f);
          if (s == 1) best = better(best, ArgMax{x, i});
        }
        best = block_reduce<2>(sums, best, red, red_arg);
        energy[s] = sums[0];
        band_energy[s] = sums[1];
        if (s == 1) match_arg = best.i;
      }
    }

    if (tid == 0) {
      int frame_count = 0, active_count = 0, run = 0, longest = 0;
      float pur_sum = 0.0f;
      for (int f = 0; f < a.n_frames; ++f) {
        const float act = frame_out[2 * f + 1];
        frame_count += act >= 0.0f;
        if (act > 0.0f) {
          ++active_count;
          pur_sum = __fadd_rn(pur_sum, frame_out[2 * f]);
          longest = max(longest, ++run);
        } else {
          run = 0;
        }
      }
      const float mean_purity =
          active_count > 0 ? __fdiv_rn(pur_sum, static_cast<float>(active_count)) : 0.0f;
      const float ratio = frame_count > 0 ? __fdiv_rn(static_cast<float>(active_count),
                                                      static_cast<float>(frame_count))
                                          : 0.0f;
      const float left = purity(band_energy[0], energy[0]);
      const float match = purity(band_energy[1], energy[1]);
      const float right = purity(band_energy[2], energy[2]);
      const float detected = a.freqs_whole[match_arg];
      const bool freq_ok =
          fabsf(__fsub_rn(detected, dom)) <= __fmul_rn(0.05f, fmaxf(fabsf(detected), dom));
      const float* t = a.thresholds + static_cast<long long>(g) * 6;
      a.accept[lane] = freq_ok && match >= t[0] && ratio >= t[1] &&
                       static_cast<float>(longest) >= t[2] && mean_purity >= t[3] &&
                       fminf(left, right) <= t[4] && fmaxf(left, right) <= t[5];
    }
    __syncthreads();  // the work area and frame_out are rewritten by the next lane
  };
  live_lanes::for_each_live<kThreads>(a.alive, a.n_lanes, static_cast<int>(blockIdx.x),
                                      static_cast<int>(gridDim.x), list, scan, dead, live);
}

}  // namespace

// C interface for ctypes. section (B, S) f32; pos (R, K) int64, alive (R, K)
// bool; whole / frame point to host RealPlan descriptors (ops/marker_fft.py
// PlanDesc; frame unused when n_frames = 0); tables the plans' f32 tables on
// the device; the layout's window (3m rounded up to 4) and buffer (floats,
// multiples of 4), whole_batch, frame_batch, on_chip and frames_on_chip;
// workspace null (on_chip) or grid slots of window + 2 buffer floats (and
// 2 n_frames more without frames_on_chip), and then grid > 0 is the
// launch's CTAs; hann_whole (m,), hann_frame (wl,),
// freqs_whole (Fw,), band_whole (G, Fw), dom_freq and lock_hz (G,),
// freqs_frame (Ff,), band_frame (G, Ff), thresholds (G, 6); accept (R, K)
// bool out; probe null or (R, K, 3 Fw + F Ff) f32 out. All contiguous on
// the current device. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int apd_verify_marker(const float* section, long long B, long long S,
                                 const long long* pos, const unsigned char* alive, long long R,
                                 int K, int G, int m, int hop, int n_frames, const void* whole,
                                 const void* frame, const float* tables, int window,
                                 int whole_batch, int frame_batch, int buffer, int on_chip,
                                 int frames_on_chip, float* workspace,
                                 int grid, const float* hann_whole, const float* hann_frame,
                                 const float* freqs_whole, const unsigned char* band_whole,
                                 const float* dom_freq, const float* lock_hz,
                                 const float* freqs_frame, const unsigned char* band_frame,
                                 const float* thresholds, unsigned char* accept, float* probe,
                                 void* stream) {
  const long long n_lanes = R * K;
  if (n_lanes <= 0) return 0;
  if (G <= 0 || B <= 0 || R % G != 0 || (R / G) != B || m < 2 || n_frames < 0 ||
      (frames_on_chip && n_frames > kMaxFrames) || (on_chip && !frames_on_chip) ||
      n_lanes >= (1LL << 31) || window < 3 * m || window % 4 != 0 ||
      buffer % 4 != 0 || whole_batch < 1 || frame_batch < 0 ||
      (n_frames > 0 && frame_batch < 1) || (!on_chip && (workspace == nullptr || grid <= 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.section = section;
  a.S = S;
  a.pos = pos;
  a.alive = alive;
  a.n_lanes = n_lanes;
  a.K = K;
  a.G = G;
  a.m = m;
  a.hop = hop;
  a.n_frames = n_frames;
  a.window = window;
  a.whole_batch = whole_batch;
  a.frame_batch = frame_batch;
  a.buffer = buffer;
  a.on_chip = on_chip;
  a.frames_on_chip = frames_on_chip;
  a.workspace = workspace;
  a.whole = *static_cast<const RealPlan*>(whole);
  a.frame = n_frames > 0 ? *static_cast<const RealPlan*>(frame) : a.whole;
  a.tables = tables;
  a.hann_whole = hann_whole;
  a.hann_frame = hann_frame;
  a.freqs_whole = freqs_whole;
  a.band_whole = band_whole;
  a.dom_freq = dom_freq;
  a.lock_hz = lock_hz;
  a.freqs_frame = freqs_frame;
  a.band_frame = band_frame;
  a.thresholds = thresholds;
  a.accept = accept;
  a.probe = probe;
  if (a.whole.nrad > kMaxRadices || a.frame.nrad > kMaxRadices)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (static_cast<size_t>(on_chip ? window + 2LL * buffer : 0) +
                       (frames_on_chip ? 2LL * n_frames : 0)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(verify_marker_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (on_chip) {
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, verify_marker_kernel,
                                                             kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const long long cap = static_cast<long long>(per_sm) * sms;
    grid = static_cast<int>(n_lanes < cap ? n_lanes : cap);
  }
  verify_marker_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
