// The block-wise greedy survivors of the lean detection tier, for sm_90a.
//
// Replaces the XLA program of the JAX package's lean greedy,
// audio_pattern_detector_tpu/ops/peaks.py::greedy_survivors_from_blocks
// (ops/peaks.py:459-567) with the window gather of
// models/bank.py::_lean_group_packed_pallas (gather_scored,
// models/bank.py:1418-1455). It was never a Pallas kernel: XLA compiles the
// rounds into the class step's program, where the port ran each round as a
// while-node pass of about 70 small kernels over every row of the group.
//
// Per row g, from the candidate scan's block maxima bmax (raw |corr|) and
// the row's normaliser denom:
//   bwork[b] = q >= hm ? q : -inf, q = bmax[g, b] / denom[g];
// then up to r_max rounds, each the plain version's round_step
// (ops/peaks.py::greedy_survivors_from_blocks):
//   1. bi = argmax(bwork), ties to the lower block; bh = bwork[bi];
//   2. the window of W = 516 samples at clamp(bi*512 - 2, 0, max(L - W, 0)),
//      as quotients corr/denom rounded as IEEE division, -inf at and past
//      the row's valid length (zero past L, as the plain version's pad);
//   3. the candidates of block bi in it: plateau-midpoint runs of length 1-3
//      with window-local neighbours (-inf past the window), c > 0, finite
//      and >= hm; a lane within min_distance of a kept lane is suppressed;
//   4. j = argmax of those, ties to the lower lane; h their max; the round
//      keeps (p = start + j, h) when bh > -inf and h == bh, and else refuses;
//   5. blocks wholly inside [p - (m - 1), p + (m - 1)] drop to -inf, then
//      the block of the lo edge and then that of the hi edge become
//      min(bwork, their recomputed suppressed maximum).
// A row stops when its bwork is all -inf or at its first refused round: in
// either case the plain version's later rounds change nothing (a refused
// round leaves the state as it was, so it repeats). overflow[g] is any
// bwork > -inf at the end. pos holds the kept positions in round order and
// 2^30 past them, height the kept heights and -inf past them.
//
// Design: one CTA a row, so a group is one launch and each row's rounds end
// with its own candidates. bwork (ceil(L/512) floats: 3.9 KB for a 60 s
// section at 8 kHz) and the kept lanes live in dynamic shared memory, sized
// from ceil(L/512) and r_max; the wrapper refuses what passes 227 KB. A
// round reads at most three windows of 516 samples (its block and its two
// edge blocks) from device memory into shared memory, and every argmax is a
// block reduction on (value, index) pairs ordered by value, then lower
// index, which is torch.argmax's first maximum.
//
// Bound: the bytes a row must move are its bmax row, the windows its rounds
// read and its outputs: a few KB a row, microseconds for a group. Each
// round is a chain of dependent block reductions (a barrier each), so the
// kernel is latency-bound; a candidate-free row exits after its first
// argmax.
//
// Built with -fmad=false; the quotients use __fdiv_rn, never a fast
// division, so they equal torch's f32 division bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;
constexpr int kW = kBlock + 4;  // the block and a 2-sample halo a side
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr long long kSentinel = 1LL << 30;  // ops/peaks.py::SURVIVOR_POS_SENTINEL
// Dynamic shared memory a launch may take: the 227 KB (232,448 bytes) a
// block may use on sm_90, less the kernel's static shared memory.
constexpr int kMaxSmem = 232448 - 4096;

struct ArgMax {
  float v;
  int i;
};

// The first maximum: the larger value, and of equal values the lower index.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

// The CTA's first maximum of every thread's ``a``, on every thread.
__device__ ArgMax block_argmax(ArgMax a, ArgMax* red, ArgMax* out) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = better(a, o);
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = a;
  __syncthreads();
  if (threadIdx.x == 0) {
    ArgMax r = red[0];
    for (int w = 1; w < kWarps; ++w) r = better(r, red[w]);
    *out = r;
  }
  __syncthreads();
  return *out;
}

struct Row {
  const float* corr;  // the row's L samples
  long long L;
  long long lim;  // valid length
  float denom, hm;
  long long m;
  int r_max;
  const long long* kept_pos;  // shared, r_max lanes
};

__device__ __forceinline__ long long window_start(long long b, long long L) {
  const long long hi = L - kW > 0 ? L - kW : 0;
  const long long s = b * kBlock - 2;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

// Block b's suppressed candidates in its window: (max, window lane of the
// first maximum). ``xq`` is the shared window; every thread returns the
// same pair.
__device__ ArgMax masked_window(const Row& row, long long b, float* xq, ArgMax* red, ArgMax* out) {
  const long long start = window_start(b, row.L);
  for (int i = threadIdx.x; i < kW; i += kThreads) {
    const long long c = start + i;
    const float x = c < row.L ? row.corr[c] : 0.0f;
    xq[i] = c < row.lim ? __fdiv_rn(x, row.denom) : -INFINITY;
  }
  __syncthreads();
  const long long b_lo = b * kBlock;
  ArgMax best = {-INFINITY, 0x7fffffff};
  for (int i = threadIdx.x; i < kW; i += kThreads) {
    const long long c = start + i;
    float v = -INFINITY;
    const float x = xq[i];
    if (c >= b_lo && c < b_lo + kBlock && c > 0 && isfinite(x) && x >= row.hm) {
      const float xm1 = i >= 1 ? xq[i - 1] : -INFINITY;
      const float xm2 = i >= 2 ? xq[i - 2] : -INFINITY;
      const float xp1 = i + 1 < kW ? xq[i + 1] : -INFINITY;
      const float xp2 = i + 2 < kW ? xq[i + 2] : -INFINITY;
      const bool fin_p1 = isfinite(xp1), fin_p2 = isfinite(xp2);
      const bool len1 = xm1 < x && xp1 < x && fin_p1;
      const bool len2 = xm1 < x && xp1 == x && xp2 < x && fin_p2;
      const bool len3 = xm2 < x && xm1 == x && xp1 == x && xp2 < x && fin_p2 && c > 1;
      if (len1 || len2 || len3) {
        v = x;
        for (int k = 0; k < row.r_max; ++k) {
          const long long d = c - row.kept_pos[k];
          if ((d < 0 ? -d : d) < row.m) {
            v = -INFINITY;
            break;
          }
        }
      }
    }
    best = better(best, ArgMax{v, i});
  }
  return block_argmax(best, red, out);
}

__global__ void __launch_bounds__(kThreads)
lean_greedy_kernel(const float* __restrict__ corr, const int* __restrict__ valid_lens,
                   int valid_len, int L, const float* __restrict__ bmax, int nb,
                   const float* __restrict__ denom, float hm, int min_distance, int r_max,
                   long long* __restrict__ pos_out, float* __restrict__ height_out,
                   unsigned char* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* kept_pos = reinterpret_cast<long long*>(smem);
  float* kept_h = reinterpret_cast<float*>(kept_pos + r_max);
  float* bwork = kept_h + r_max;
  __shared__ float xq[kW];
  __shared__ ArgMax red[kWarps];
  __shared__ ArgMax out;

  const int g = blockIdx.x;
  Row row;
  row.corr = corr + static_cast<long long>(g) * L;
  row.L = L;
  row.lim = valid_lens ? valid_lens[g] : valid_len;
  row.denom = denom[g];
  row.hm = hm;
  row.m = min_distance;
  row.r_max = r_max;
  row.kept_pos = kept_pos;

  for (int k = threadIdx.x; k < r_max; k += kThreads) {
    kept_pos[k] = kSentinel;
    kept_h[k] = -INFINITY;
  }
  const float* brow = bmax + static_cast<long long>(g) * nb;
  for (int b = threadIdx.x; b < nb; b += kThreads) {
    const float q = __fdiv_rn(brow[b], row.denom);
    bwork[b] = q >= hm ? q : -INFINITY;
  }
  __syncthreads();

  for (int r = 0; r < r_max; ++r) {
    ArgMax best = {-INFINITY, 0x7fffffff};
    for (int b = threadIdx.x; b < nb; b += kThreads) best = better(best, ArgMax{bwork[b], b});
    const ArgMax seed = block_argmax(best, red, &out);
    if (!(seed.v > -INFINITY)) break;  // exhausted
    const ArgMax got = masked_window(row, seed.i, xq, red, &out);
    if (!(got.v == seed.v)) break;  // refused: the round would repeat unchanged
    const long long p = window_start(seed.i, row.L) + got.i;
    if (threadIdx.x == 0) {
      kept_pos[r] = p;
      kept_h[r] = got.v;
    }
    const long long lo = p - (row.m - 1), hi = p + (row.m - 1);
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      const long long b0 = static_cast<long long>(b) * kBlock;
      if (b0 >= lo && b0 + kBlock - 1 <= hi) bwork[b] = -INFINITY;
    }
    __syncthreads();
    for (int e = 0; e < 2; ++e) {
      const long long edge = e == 0 ? lo : hi;
      const long long be = edge < 0 ? 0 : (edge / kBlock < nb - 1 ? edge / kBlock : nb - 1);
      const ArgMax mv = masked_window(row, be, xq, red, &out);
      if (threadIdx.x == 0) bwork[be] = fminf(bwork[be], mv.v);
      __syncthreads();
    }
  }

  bool any = false;
  for (int b = threadIdx.x; b < nb; b += kThreads) any |= bwork[b] > -INFINITY;
  any = __syncthreads_or(any);
  const long long o = static_cast<long long>(g) * r_max;
  for (int k = threadIdx.x; k < r_max; k += kThreads) {
    pos_out[o + k] = kept_pos[k];
    height_out[o + k] = kept_h[k];
  }
  if (threadIdx.x == 0) overflow[g] = any;
}

}  // namespace

// C interface for ctypes. corr is (G, L) f32, bmax (G, nb) f32 with nb =
// ceil(L / 512), denom (G,) f32, pos (G, r_max) int64, height (G, r_max)
// f32, overflow (G,) bool bytes, all contiguous on the current device.
// ``valid_lens`` is a (G,) int32 device array or null (then ``valid_len``
// holds for every row). Returns the CUDA error code of the launch (0 on
// success); shared memory past 227 KB returns cudaErrorInvalidValue.
extern "C" int apd_lean_greedy(const float* corr, const int* valid_lens, int G, int L,
                               int valid_len, const float* bmax, int nb, const float* denom,
                               float hm, int min_distance, int r_max, long long* pos,
                               float* height, unsigned char* overflow, void* stream) {
  if (G <= 0) return 0;
  const size_t smem = static_cast<size_t>(r_max) * (sizeof(long long) + sizeof(float)) +
                      static_cast<size_t>(nb) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(lean_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  lean_greedy_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      corr, valid_lens, valid_len, L, bmax, nb, denom, hm, min_distance, r_max, pos, height,
      overflow);
  return static_cast<int>(cudaGetLastError());
}
