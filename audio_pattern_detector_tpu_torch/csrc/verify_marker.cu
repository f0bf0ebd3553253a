// The marker-tone verifier's decisions after the spectra, for sm_90a.
//
// Replaces the XLA program of the JAX package's marker verifier after its
// transforms, audio_pattern_detector_tpu/ops/verify.py::verify_marker
// (ops/verify.py:324; the spectra at :345-352 stay torch.fft, or the
// DFT-GEMM's matrix product under APD_MARKER_GEMM, as XLA's FFT stays outside
// any Pallas kernel). It was never a Pallas kernel: XLA fuses the decisions
// into the class step's program, where the port ran them as about 30 eager
// torch ops over every lane's (3, Fw) and (F, Ff) spectra, live or dead.
//
// For each lane (r, k) of (R, K), row r against clip g = r % G (rows are
// round-major), from the whole-window spectra whole (R, K, 3, Fw) of the
// left flank, the match and the right flank, and the frame spectra frames
// (R, K, F, Ff) of the match (absent when F = 0). Each input is a magnitude
// (the FFT path: the power is x * x, bitwise torch's spec * spec) or already
// a power (the GEMM path: the power is x itself); argmax runs on the input
// as given, the first maximum, which keeps the plain version's rule of
// taking the argmax on the magnitude:
//   * purity of each window: band energy over energy, 0 where the energy is
//     not positive; freq_ok: |f - dom| <= 0.05 max(|f|, dom) for f the match
//     window's argmax frequency;
//   * per frame: its argmax frequency, purity and energy; locked = |f - dom|
//     <= lock_hz; active = energy > 0 & locked & purity >= 0.55;
//   * frame_count (frames with energy), active_count, the longest run of
//     active frames, the mean purity of the active frames, and the ratio
//     active_count / frame_count (each 0 without frames);
//   * accept = alive & freq_ok & purity_match >= t0 & ratio >= t1 &
//     longest >= t2 & mean_purity >= t3 & min flank purity <= t4 & max flank
//     purity <= t5, the clip's six thresholds.
//
// Design. Only accept leaves the kernel. A dead lane writes accept = 0 and
// does nothing else. A CTA takes lanes in a grid-stride loop; a live lane is
// one CTA's work: the three windows' sums and the match window's argmax as
// block reductions, each frame a warp's (its sums and argmax as warp
// reductions), then one thread folds the frames in order. No (R, K, 3, m)
// array is allocated here (the spectra themselves are the transforms').
//
// Arithmetic order. Built with -fmad=false; the powers are x * x rounded
// once, the purities and the ratio IEEE divisions. Sums differ from torch's
// in order only: thread t adds bins t, t + kThreads, ... (a frame's lane l
// adds bins l, l + 32, ...), then xor-shuffle folds with offsets 16, 8, 4,
// 2, 1 (across warps, the kThreads / 32 warp sums padded with zeros to 32);
// the active frames' purities add in frame order. The decisions compare
// those sums with thresholds, so a sum within rounding of a threshold could
// decide otherwise than torch's; the accept bits are held bitwise equal.
//
// Bound: the bytes a lane must read are its spectra ((3 Fw + F Ff) x 4 B)
// and its clip's band masks; a launch's bound is those of its live lanes
// over the memory rate. A lane's chain of reductions makes a launch with
// few live lanes latency-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrid = 1024;

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

__global__ void __launch_bounds__(kThreads)
verify_marker_kernel(const float* __restrict__ whole, int whole_is_magnitude, int Fw,
                     const float* __restrict__ frames, int frames_is_magnitude, int F, int Ff,
                     const unsigned char* __restrict__ alive, long long n_lanes, int K, int G,
                     const float* __restrict__ freqs_whole,
                     const unsigned char* __restrict__ band_whole,
                     const float* __restrict__ dom_freq, const float* __restrict__ lock_hz,
                     const float* __restrict__ freqs_frame,
                     const unsigned char* __restrict__ band_frame,
                     const float* __restrict__ thresholds, unsigned char* __restrict__ accept) {
  extern __shared__ float frame_out[];  // per frame: purity, then active (1 or 0)
  __shared__ float red[6 * 32];
  __shared__ ArgMax red_arg[32];
  const int tid = threadIdx.x;
  const int lane_id = tid & 31;
  const int warp = tid >> 5;

  for (long long lane = blockIdx.x; lane < n_lanes; lane += gridDim.x) {
    if (!alive[lane]) {  // uniform: every thread reads the same byte
      if (tid == 0) accept[lane] = 0;
      continue;
    }
    const int g = static_cast<int>((lane / K) % G);
    const float dom = dom_freq[g];

    // The three whole windows: energy and band energy of each, and the
    // match window's argmax.
    const float* wl = whole + lane * 3LL * Fw;
    const unsigned char* band = band_whole + static_cast<long long>(g) * Fw;
    float sums[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // energy, band energy per window
    ArgMax best{-INFINITY, 0x7fffffff};
    for (int i = tid; i < Fw; i += kThreads) {
      const bool in_band = band[i] != 0;
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        const float x = wl[s * Fw + i];
        const float p = whole_is_magnitude ? __fmul_rn(x, x) : x;
        sums[2 * s] = __fadd_rn(sums[2 * s], p);
        sums[2 * s + 1] = __fadd_rn(sums[2 * s + 1], in_band ? p : 0.0f);
        if (s == 1) best = better(best, ArgMax{x, i});
      }
    }
    best = block_reduce<6>(sums, best, red, red_arg);

    // The frames: one warp a frame.
    if (F > 0) {
      const float* fl = frames + lane * static_cast<long long>(F) * Ff;
      const unsigned char* fband = band_frame + static_cast<long long>(g) * Ff;
      const float lock = lock_hz[g];
      for (int f = warp; f < F; f += kWarps) {
        float fs[2] = {0.0f, 0.0f};
        ArgMax fb{-INFINITY, 0x7fffffff};
        for (int i = lane_id; i < Ff; i += 32) {
          const float x = fl[static_cast<long long>(f) * Ff + i];
          const float p = frames_is_magnitude ? __fmul_rn(x, x) : x;
          fs[0] = __fadd_rn(fs[0], p);
          fs[1] = __fadd_rn(fs[1], fband[i] ? p : 0.0f);
          fb = better(fb, ArgMax{x, i});
        }
        warp_sum<2>(fs);
        fb = warp_argmax(fb);
        if (lane_id == 0) {
          const bool nonzero = fs[0] > 0.0f;
          const float pur = purity(fs[1], fs[0]);
          const bool locked = fabsf(__fsub_rn(freqs_frame[fb.i], dom)) <= lock;
          frame_out[2 * f] = pur;
          frame_out[2 * f + 1] = nonzero ? (locked && pur >= 0.55f ? 1.0f : 0.0f) : -1.0f;
        }
      }
      __syncthreads();
    }

    if (tid == 0) {
      int frame_count = 0, active_count = 0, run = 0, longest = 0;
      float pur_sum = 0.0f;
      for (int f = 0; f < F; ++f) {
        const float a = frame_out[2 * f + 1];
        frame_count += a >= 0.0f;
        if (a > 0.0f) {
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
      const float left = purity(sums[1], sums[0]);
      const float match = purity(sums[3], sums[2]);
      const float right = purity(sums[5], sums[4]);
      const float detected = freqs_whole[best.i];
      const bool freq_ok =
          fabsf(__fsub_rn(detected, dom)) <= __fmul_rn(0.05f, fmaxf(fabsf(detected), dom));
      const float* t = thresholds + static_cast<long long>(g) * 6;
      accept[lane] = freq_ok && match >= t[0] && ratio >= t[1] &&
                     static_cast<float>(longest) >= t[2] && mean_purity >= t[3] &&
                     fminf(left, right) <= t[4] && fmaxf(left, right) <= t[5];
    }
    __syncthreads();  // frame_out is rewritten by the next lane
  }
}

}  // namespace

// C interface for ctypes. whole (R, K, 3, Fw) f32; frames (R, K, F, Ff) f32
// or null when F = 0; *_is_magnitude 1 for |rfft| (power = x * x), 0 for a
// power spectrum; alive (R, K) bool; freqs_whole (Fw,) f32, band_whole
// (G, Fw) bool, dom_freq and lock_hz (G,) f32, freqs_frame (Ff,) f32,
// band_frame (G, Ff) bool, thresholds (G, 6) f32; accept (R, K) bool out.
// All contiguous on the current device. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int apd_verify_marker(const float* whole, int whole_is_magnitude, int Fw,
                                 const float* frames, int frames_is_magnitude, int F, int Ff,
                                 const unsigned char* alive, long long R, int K, int G,
                                 const float* freqs_whole, const unsigned char* band_whole,
                                 const float* dom_freq, const float* lock_hz,
                                 const float* freqs_frame, const unsigned char* band_frame,
                                 const float* thresholds, unsigned char* accept, void* stream) {
  const long long n_lanes = R * K;
  if (n_lanes <= 0) return 0;
  if (G <= 0 || Fw <= 0 || F < 0 || (F > 0 && (Ff <= 0 || frames == nullptr)) || R % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(F) * 2 * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = n_lanes < kMaxGrid ? static_cast<int>(n_lanes) : kMaxGrid;
  verify_marker_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      whole, whole_is_magnitude, Fw, frames, frames_is_magnitude, F, Ff, alive, n_lanes, K, G,
      freqs_whole, band_whole, dom_freq, lock_hz, freqs_frame, band_frame, thresholds, accept);
  return static_cast<int>(cudaGetLastError());
}
