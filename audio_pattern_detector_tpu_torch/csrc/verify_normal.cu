// The normal (and short-clip) verifier of Step 2, for sm_90a.
//
// Replaces the XLA program of the JAX package's normal verifier,
// audio_pattern_detector_tpu/ops/verify.py::verify_normal (ops/verify.py:154,
// with _pearson_batched at :64). It was never a Pallas kernel: XLA fuses the
// window gather, the renormalisation, the partition MSEs, the window-max
// resample and the Pearson r into the class step's program, where the port
// ran them as eager torch ops over (R, K, lc) arrays of every lane, live or
// dead (the gather index, the windows, their mask, the normalised copy and
// the differences: gigabytes for a 16-row round).
//
// For each lane (r, k) of (R, K), row r against clip g = r % G (rows are
// round-major, R = B * G):
//   * the window of lc = 2m - 1 samples at idx = start - front + i, with
//     front = PAD + m - 1 and start = clamp(pos - (m - 1) + front, 0,
//     L + front + PAD + m - lc); a sample is zero at idx < 0, idx >= L or
//     idx >= the row's valid length;
//   * divided by denom[r] when a normaliser is given, then by
//     max(window max, 1e-38);
//   * mse[p] = sum over the partition's ps samples of (w - clip)^2 / ps for
//     the 10 partitions against corr_clip_partitions[g]; sim = the mean of
//     the 10, or, for a clip of at least half a second, the smaller of that
//     and the mean of partitions 4 and 5;
//   * the window maxima of ds_n bins [win_lo + seg_a[b], win_lo + seg_b[b] +
//     2^k_level): the plain version's max(f[seg_a], f[seg_b]) over a
//     2^k_level sliding maximum, which is the same maximum because every
//     bin is at least 2^k_level and at most 2^(k_level + 1) wide;
//   * r = the Pearson r of those maxima against ds_clip[g], 0 where either
//     side has no variance;
//   * accept = alive & sim <= sim_limit & r >= r_threshold.
//
// Design. Only a lane's accept bit reaches the class step's payload, so a
// dead lane writes accept = 0 (sim and r NaN) and does nothing else: the
// work and the bytes scale with live lanes. A CTA takes lanes in a
// grid-stride loop, and a live lane is one CTA's work; no (R, K, lc) array
// exists. The window is read from device memory (it sits in L2 after its
// first read) in three passes, so its length is not bounded by shared
// memory (lc = 159,999 samples for a 10 s clip at 8 kHz): the window maximum,
// then the partition sums, then the bin maxima into shared memory (ds_n
// floats). Dividing is monotone, so the window maximum and each bin maximum
// are taken on the raw samples and divided once, bit for bit the maxima of
// the divided samples.
//
// Arithmetic order. Element values are bitwise the plain version's: built
// with -fmad=false, IEEE division (__fdiv_rn), first by denom and then by
// the clamped maximum, as the plain version divides. Sums differ from
// torch's in order only: thread t of the CTA's kThreads adds the terms
// t, t + kThreads, t + 2 kThreads, ... in turn; each warp folds its 32
// partial sums by xor shuffles with offsets 16, 8, 4, 2, 1; the kThreads / 32
// warp sums, padded with zeros to 32, are folded the same way. mse[p] is the
// partition's sum over ps, sim_whole the ten mse[p] added in order over 10,
// sim_mid (mse[4] + mse[5]) / 2; the Pearson means are the sums over ds_n.
// tests/test_torch_verify_kernels.py transliterates this order in numpy.
//
// Bound: the bytes a lane must read are its window (lc x 4 B) and its clip's
// constants (10 ps + ds_n floats, shared by the clip's lanes); a launch's
// bound is those of its live lanes over the memory rate. The passes re-read
// the window from L2, and a lane's reductions are a chain of barriers, so a
// launch with few live lanes is latency-bound.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;  // the plain version's _PAD
constexpr int kParts = 10;
constexpr int kMaxGrid = 1024;

// Block-wide sums of N values at once, in the order the header states;
// every thread returns the sums. red holds N x 32 floats.
template <int N>
__device__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[n] = __fadd_rn(v[n], __shfl_xor_sync(0xffffffffu, v[n], off));
    if (lane == 0) red[n * 32 + warp] = v[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float s = lane < kWarps ? red[n * 32 + lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      if (lane == 0) red[n * 32] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = red[n * 32];
  __syncthreads();  // red is reused by the next reduction
}

__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float s = lane < kWarps ? red[lane] : -INFINITY;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = fmaxf(s, __shfl_xor_sync(0xffffffffu, s, off));
    if (lane == 0) red[0] = s;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

struct Window {
  const float* row;  // the row's first sample
  long long base;    // idx of the window's first sample
  long long hi;      // samples at idx >= hi read as zero: min(L, valid length)

  __device__ float raw(long long i) const {
    const long long idx = base + i;
    return (idx >= 0 && idx < hi) ? row[idx] : 0.0f;
  }
};

__global__ void __launch_bounds__(kThreads)
verify_normal_kernel(const float* __restrict__ corr, long long L,
                     const int* __restrict__ valid_lens, long long valid_len,
                     const float* __restrict__ denom, const long long* __restrict__ pos,
                     const unsigned char* __restrict__ alive, long long n_lanes, int K, int G,
                     int m, int lc, int ps, const float* __restrict__ clip_parts,
                     const float* __restrict__ ds_clip, const long long* __restrict__ seg_a,
                     const long long* __restrict__ seg_b, int win_lo, int ds_n, int k_level,
                     int is_short, float sim_limit, float r_threshold,
                     unsigned char* __restrict__ accept, float* __restrict__ sim_out,
                     float* __restrict__ r_out) {
  extern __shared__ float xs[];  // the ds_n bin maxima of the current lane
  __shared__ float red[kParts * 32];
  const int tid = threadIdx.x;
  const long long front = kPad + m - 1;
  const long long upper = L + front + kPad + m - lc;

  for (long long lane = blockIdx.x; lane < n_lanes; lane += gridDim.x) {
    if (!alive[lane]) {  // uniform: every thread reads the same byte
      if (tid == 0) {
        accept[lane] = 0;
        sim_out[lane] = __int_as_float(0x7fc00000);  // NaN: not computed
        r_out[lane] = __int_as_float(0x7fc00000);
      }
      continue;
    }
    const long long row = lane / K;
    const int g = static_cast<int>(row % G);
    long long start = pos[lane] - (m - 1) + front;
    start = start < 0 ? 0 : (start > upper ? upper : start);
    const long long lim = valid_lens ? static_cast<long long>(valid_lens[row]) : valid_len;
    const Window w{corr + row * L, start - front, lim < L ? lim : L};
    const float dn = denom ? denom[row] : 1.0f;

    // Pass 1: the window maximum, on the raw samples.
    float mx = -INFINITY;
    for (int i = tid; i < lc; i += kThreads) mx = fmaxf(mx, w.raw(i));
    mx = block_max(mx, red);
    const float smax = fmaxf(denom ? __fdiv_rn(mx, dn) : mx, 1e-38f);

    // Pass 2: the ten partition sums of squared differences.
    float acc[kParts];
    const float* clip = clip_parts + static_cast<long long>(g) * kParts * ps;
#pragma unroll
    for (int p = 0; p < kParts; ++p) {
      float s = 0.0f;
      for (int j = tid; j < ps; j += kThreads) {
        const float raw = w.raw(static_cast<long long>(p) * ps + j);
        const float v = denom ? __fdiv_rn(__fdiv_rn(raw, dn), smax) : __fdiv_rn(raw, smax);
        const float d = __fsub_rn(v, clip[static_cast<long long>(p) * ps + j]);
        s = __fadd_rn(s, __fmul_rn(d, d));
      }
      acc[p] = s;
    }
    block_sum<kParts>(acc, red);

    // Pass 3: the bin maxima of the centre window, into shared memory.
    for (int b = tid; b < ds_n; b += kThreads) {
      const long long lo = win_lo + seg_a[b];
      const long long hi = win_lo + seg_b[b] + (1LL << k_level);
      float bm = -INFINITY;
      for (long long i = lo; i < hi; ++i) bm = fmaxf(bm, w.raw(i));
      xs[b] = denom ? __fdiv_rn(__fdiv_rn(bm, dn), smax) : __fdiv_rn(bm, smax);
    }
    __syncthreads();

    // Pass 4: the Pearson r against the clip's downsampled window.
    const float* y = ds_clip + static_cast<long long>(g) * ds_n;
    float sums[2] = {0.0f, 0.0f};
    for (int b = tid; b < ds_n; b += kThreads) {
      sums[0] = __fadd_rn(sums[0], xs[b]);
      sums[1] = __fadd_rn(sums[1], y[b]);
    }
    block_sum<2>(sums, red);
    const float mean_x = __fdiv_rn(sums[0], static_cast<float>(ds_n));
    const float mean_y = __fdiv_rn(sums[1], static_cast<float>(ds_n));
    float mom[3] = {0.0f, 0.0f, 0.0f};  // cov, sxx, syy
    for (int b = tid; b < ds_n; b += kThreads) {
      const float dx = __fsub_rn(xs[b], mean_x);
      const float dy = __fsub_rn(y[b], mean_y);
      mom[0] = __fadd_rn(mom[0], __fmul_rn(dx, dy));
      mom[1] = __fadd_rn(mom[1], __fmul_rn(dx, dx));
      mom[2] = __fadd_rn(mom[2], __fmul_rn(dy, dy));
    }
    block_sum<3>(mom, red);  // its barriers also order the xs reads before the next lane's writes

    if (tid == 0) {
      float whole = 0.0f;
      float mse[kParts];
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        mse[p] = __fdiv_rn(acc[p], static_cast<float>(ps));
        whole = __fadd_rn(whole, mse[p]);
      }
      whole = __fdiv_rn(whole, static_cast<float>(kParts));
      const float mid = __fdiv_rn(__fadd_rn(mse[4], mse[5]), 2.0f);
      const float sim = is_short ? whole : fminf(whole, mid);
      const float den = __fsqrt_rn(__fmul_rn(mom[1], mom[2]));
      const float r = den > 0.0f ? __fdiv_rn(mom[0], fmaxf(den, 1e-38f)) : 0.0f;
      accept[lane] = (sim <= sim_limit) && (r >= r_threshold);
      sim_out[lane] = sim;
      r_out[lane] = r;
    }
  }
}

}  // namespace

// C interface for ctypes. corr (R, L) f32; valid_lens (R,) int32 or null
// (then valid_len, an int, bounds every row); denom (R,) f32 or null (no
// normaliser); pos (R, K) int64 and alive (R, K) bool; clip_parts (G, 10,
// ps) f32, ds_clip (G, ds_n) f32, seg_a and seg_b (ds_n,) int64; outputs
// accept (R, K) bool, sim and r (R, K) f32. All contiguous on the current
// device. Returns the CUDA error code of the launch (0 on success).
extern "C" int apd_verify_normal(const float* corr, long long R, long long L,
                                 const int* valid_lens, long long valid_len, const float* denom,
                                 const long long* pos, const unsigned char* alive, int K, int G,
                                 int m, int ps, const float* clip_parts, const float* ds_clip,
                                 const long long* seg_a, const long long* seg_b, int win_lo,
                                 int ds_n, int k_level, int is_short, float sim_limit,
                                 float r_threshold, unsigned char* accept, float* sim, float* r,
                                 void* stream) {
  const long long n_lanes = R * K;
  if (n_lanes <= 0) return 0;
  if (G <= 0 || ds_n <= 0 || ps <= 0 || m <= 0 || R % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(ds_n) * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int lc = 2 * m - 1;
  const int grid = n_lanes < kMaxGrid ? static_cast<int>(n_lanes) : kMaxGrid;
  verify_normal_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      corr, L, valid_lens, valid_len, denom, pos, alive, n_lanes, K, G, m, lc, ps, clip_parts,
      ds_clip, seg_a, seg_b, win_lo, ds_n, k_level, is_short, sim_limit, r_threshold, accept, sim,
      r);
  return static_cast<int>(cudaGetLastError());
}
