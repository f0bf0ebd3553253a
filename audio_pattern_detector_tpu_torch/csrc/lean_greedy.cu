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
//      and >= hm; a lane within min_distance of a kept slot is suppressed
//      (an unfilled slot holds the sentinel 2^30, which suppresses too when
//      min_distance reaches it);
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
// with its own candidates. bwork, a maximum per 32 blocks of it (31 entries
// for a 61 s section at 8 kHz) and the kept slots live in dynamic shared
// memory, sized from ceil(L/512) and r_max; the wrapper refuses what passes
// 227 KB. A round:
//   - its seed is one warp's shuffle reduction of the per-32-block maxima,
//     made by every warp alike, so no barrier hands it out;
//   - p lies in block bi, so each edge p -/+ (m - 1) falls in one of two
//     consecutive blocks, known from bi alone. The seed window and the
//     windows of those (at most four) edge blocks are copied together with
//     cp.async (a window shared by two blocks is copied once: m < 512, or
//     a short row) and the round waits on device memory once; each thread
//     turns the samples it copied into quotients in place;
//   - the seed's candidates, then both edges' candidates, are two block
//     reductions; the suppression test reads only the slots filled so far
//     (and the sentinel while a slot is unfilled);
//   - the blocks the round changes lie between its two edge blocks, so only
//     the per-32-block maxima of that span are refreshed, a warp each.
// So a round meets four barriers (the windows, the two reductions, the
// refresh) and one wait on device memory. Every argmax orders (value,
// index) pairs by value, then lower index: torch.argmax's first maximum. A
// candidate-free row exits after its first seed.
//
// Bound: the bytes a row must move are its bmax row, the windows its rounds
// read and its outputs: a few KB a row, microseconds for a group. Each
// round is a chain of dependent steps, so the kernel is latency-bound.
//
// Built with -fmad=false; the quotients use __fdiv_rn, never a fast
// division, so they equal torch's f32 division bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;
constexpr int kW = kBlock + 4;  // the block and a 2-sample halo a side
constexpr int kSlots = 5;       // the seed window and four edge windows
constexpr int kGroup = 32;      // blocks under one entry of the second level
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kSentinel = 1LL << 30;  // ops/peaks.py::SURVIVOR_POS_SENTINEL
// Dynamic shared memory a launch may take: the 227 KB (232,448 bytes) a
// block may use on sm_90, less the kernel's static shared memory (the five
// windows, 10.3 KB, and the reductions).
constexpr int kMaxSmem = 232448 - 12288;

struct ArgMax {
  float v;
  int i;
};

// The first maximum: the larger value, and of equal values the lower index.
__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax a) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = better(a, o);
  }
  return a;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ long long window_start(long long b, long long L) {
  const long long hi = L - kW > 0 ? L - kW : 0;
  const long long s = b * kBlock - 2;
  return s < 0 ? 0 : (s > hi ? hi : s);
}

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

struct Row {
  float hm;
  long long m;
  int r_max;
  const long long* kept_pos;  // shared, the slots filled so far
};

// Window lane i of ``xq`` (a window at ``start``) as a candidate of block
// b: its quotient, or -inf where it is none or lies within m of one of the
// ``filled`` slots, of ``extra`` (when ``has_extra``: the round's kept
// position, not yet read from its slot) or of an unfilled slot's sentinel.
__device__ __forceinline__ float candidate(const Row& row, const float* xq, long long start,
                                           int i, long long b, int filled, bool has_extra,
                                           long long extra) {
  const long long c = start + i;
  const float x = xq[i];
  const long long b_lo = b * kBlock;
  if (!(c >= b_lo && c < b_lo + kBlock && c > 0 && isfinite(x) && x >= row.hm)) return -INFINITY;
  const float xm1 = i >= 1 ? xq[i - 1] : -INFINITY;
  const float xm2 = i >= 2 ? xq[i - 2] : -INFINITY;
  const float xp1 = i + 1 < kW ? xq[i + 1] : -INFINITY;
  const float xp2 = i + 2 < kW ? xq[i + 2] : -INFINITY;
  const bool fin_p1 = isfinite(xp1), fin_p2 = isfinite(xp2);
  const bool len1 = xm1 < x && xp1 < x && fin_p1;
  const bool len2 = xm1 < x && xp1 == x && xp2 < x && fin_p2;
  const bool len3 = xm2 < x && xm1 == x && xp1 == x && xp2 < x && fin_p2 && c > 1;
  if (!(len1 || len2 || len3)) return -INFINITY;
  auto near = [&](long long q) {
    const long long d = c - q;
    return (d < 0 ? -d : d) < row.m;
  };
  if (filled + has_extra < row.r_max && near(kSentinel)) return -INFINITY;
  if (has_extra && near(extra)) return -INFINITY;
  for (int k = 0; k < filled; ++k)
    if (near(row.kept_pos[k])) return -INFINITY;
  return x;
}

__global__ void __launch_bounds__(kThreads)
lean_greedy_kernel(const float* __restrict__ corr, const int* __restrict__ valid_lens,
                   int valid_len, int L, const float* __restrict__ bmax, int nb,
                   const float* __restrict__ denom, float hm, int min_distance, int r_max,
                   long long* __restrict__ pos_out, float* __restrict__ height_out,
                   unsigned char* __restrict__ overflow) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int ng = (nb + kGroup - 1) / kGroup;
  long long* kept_pos = reinterpret_cast<long long*>(smem);
  float* kept_h = reinterpret_cast<float*>(kept_pos + r_max);
  float* bwork = kept_h + r_max;
  float* gmax_v = bwork + nb;
  int* gmax_i = reinterpret_cast<int*>(gmax_v + ng);
  __shared__ float win[kSlots][kW];
  __shared__ ArgMax red_seed[kWarps];
  __shared__ float red_edge[kWarps][2];

  const int g = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* crow = corr + static_cast<long long>(g) * L;
  const long long lim = valid_lens ? valid_lens[g] : valid_len;
  const float dn = denom[g];
  Row row;
  row.hm = hm;
  row.m = min_distance;
  row.r_max = r_max;
  row.kept_pos = kept_pos;

  for (int k = t; k < r_max; k += kThreads) {
    kept_pos[k] = kSentinel;
    kept_h[k] = -INFINITY;
  }
  const float* brow = bmax + static_cast<long long>(g) * nb;
  for (int b = t; b < nb; b += kThreads) {
    const float q = __fdiv_rn(brow[b], dn);
    bwork[b] = q >= hm ? q : -INFINITY;
  }
  __syncthreads();
  // The second level: the first maximum of each 32 blocks, a warp a group.
  // With ``apply``, ``refresh`` first applies a round's drop (the blocks
  // wholly inside [lo, hi]) and its edge minima to the groups' blocks.
  auto refresh = [&](int g_first, int g_last, long long lo, long long hi, int be_lo,
                     int be_hi, float m_lo, float m_hi, bool apply) {
    for (int q = g_first + warp; q <= g_last; q += kWarps) {
      const int b = q * kGroup + lane;
      float v = -INFINITY;
      if (b < nb) {
        v = bwork[b];
        if (apply) {
          const long long b0 = static_cast<long long>(b) * kBlock;
          if (b0 >= lo && b0 + kBlock - 1 <= hi) v = -INFINITY;
          if (b == be_lo) v = fminf(v, m_lo);
          if (b == be_hi) v = fminf(v, m_hi);
          bwork[b] = v;
        }
      }
      const ArgMax r = warp_argmax(ArgMax{v, b});
      if (lane == 0) {
        gmax_v[q] = r.v;
        gmax_i[q] = r.i;
      }
    }
  };
  refresh(0, ng - 1, 0, -1, -1, -1, 0.0f, 0.0f, false);
  __syncthreads();

  auto clamp_block = [&](long long b) {
    return static_cast<int>(b < 0 ? 0 : (b > nb - 1 ? nb - 1 : b));
  };
  for (int r = 0; r < r_max; ++r) {
    // The seed, on every warp alike.
    ArgMax seed = {-INFINITY, 0x7fffffff};
    for (int q = lane; q < ng; q += 32) seed = better(seed, ArgMax{gmax_v[q], gmax_i[q]});
    seed = warp_argmax(seed);
    if (!(seed.v > -INFINITY)) break;  // exhausted
    const long long bi = seed.i;

    // The windows: the seed's, and those of the two candidate blocks of
    // each edge; one copy of each distinct start.
    const long long m1 = row.m - 1;
    const long long a_lo = floor_div(bi * kBlock - m1, kBlock);
    const long long a_hi = floor_div(bi * kBlock + m1, kBlock);
    const int blocks[kSlots] = {static_cast<int>(bi), clamp_block(a_lo), clamp_block(a_lo + 1),
                                clamp_block(a_hi), clamp_block(a_hi + 1)};
    long long starts[kSlots];
    int n_slots = 0;
    for (int s = 0; s < kSlots; ++s) {
      const long long st = window_start(blocks[s], L);
      bool seen = false;
      for (int u = 0; u < n_slots; ++u) seen |= starts[u] == st;
      if (!seen) starts[n_slots++] = st;
    }
    for (int idx = t; idx < n_slots * kW; idx += kThreads) {
      const int s = idx / kW, i = idx - s * kW;
      const long long c = starts[s] + i;
      if (c < L && c < lim) cp_async4(&win[s][i], crow + c);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    for (int idx = t; idx < n_slots * kW; idx += kThreads) {
      const int s = idx / kW, i = idx - s * kW;
      const long long c = starts[s] + i;
      win[s][i] = c < lim ? __fdiv_rn(c < L ? win[s][i] : 0.0f, dn) : -INFINITY;
    }
    __syncthreads();
    auto slot_of = [&](int b) {
      const long long st = window_start(b, L);
      int s = 0;
      while (starts[s] != st) ++s;
      return s;
    };

    // The seed block's suppressed candidates.
    const int ws = slot_of(static_cast<int>(bi));
    ArgMax best = {-INFINITY, 0x7fffffff};
    for (int i = t; i < kW; i += kThreads)
      best = better(best, ArgMax{candidate(row, win[ws], starts[ws], i, bi, r, false, 0), i});
    best = warp_argmax(best);
    if (lane == 0) red_seed[warp] = best;
    __syncthreads();
    ArgMax got = red_seed[0];
    for (int w = 1; w < kWarps; ++w) got = better(got, red_seed[w]);
    if (!(got.v == seed.v)) break;  // refused: the round would repeat unchanged
    const long long p = starts[ws] + got.i;
    if (t == 0) {
      kept_pos[r] = p;
      kept_h[r] = got.v;
    }

    // Both edge blocks' suppressed maxima, with p kept.
    const long long lo = p - m1, hi = p + m1;
    const int be_lo = clamp_block(floor_div(lo, kBlock));
    const int be_hi = clamp_block(floor_div(hi, kBlock));
    const int w_lo = slot_of(be_lo), w_hi = slot_of(be_hi);
    float m_lo = -INFINITY, m_hi = -INFINITY;
    for (int i = t; i < kW; i += kThreads) {
      m_lo = fmaxf(m_lo, candidate(row, win[w_lo], starts[w_lo], i, be_lo, r, true, p));
      m_hi = fmaxf(m_hi, candidate(row, win[w_hi], starts[w_hi], i, be_hi, r, true, p));
    }
    for (int off = 16; off > 0; off >>= 1) {
      m_lo = fmaxf(m_lo, __shfl_xor_sync(0xffffffffu, m_lo, off));
      m_hi = fmaxf(m_hi, __shfl_xor_sync(0xffffffffu, m_hi, off));
    }
    if (lane == 0) {
      red_edge[warp][0] = m_lo;
      red_edge[warp][1] = m_hi;
    }
    __syncthreads();
    for (int w = 0; w < kWarps; ++w) {
      m_lo = fmaxf(m_lo, red_edge[w][0]);
      m_hi = fmaxf(m_hi, red_edge[w][1]);
    }

    // The blocks the round changes lie in [min edge, max edge].
    const int b_first = min(be_lo, be_hi), b_last = max(be_lo, be_hi);
    refresh(b_first / kGroup, b_last / kGroup, lo, hi, be_lo, be_hi, m_lo, m_hi, true);
    __syncthreads();
  }

  __syncthreads();
  const long long o = static_cast<long long>(g) * r_max;
  for (int k = t; k < r_max; k += kThreads) {
    pos_out[o + k] = kept_pos[k];
    height_out[o + k] = kept_h[k];
  }
  if (warp == 0) {
    bool any = false;
    for (int q = lane; q < ng; q += 32) any |= gmax_v[q] > -INFINITY;
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) overflow[g] = any;
  }
}

}  // namespace

// Dynamic shared memory of a launch: the kept slots, bwork and its second
// level (a value and a block index per 32 blocks).
static size_t lean_smem(int nb, int r_max) {
  const size_t ng = (static_cast<size_t>(nb) + kGroup - 1) / kGroup;
  return static_cast<size_t>(r_max) * (sizeof(long long) + sizeof(float)) +
         static_cast<size_t>(nb) * sizeof(float) + ng * (sizeof(float) + sizeof(int));
}

// C interface for ctypes. corr is (G, L) f32, bmax (G, nb) f32 with nb =
// ceil(L / 512), denom (G,) f32, pos (G, r_max) int64, height (G, r_max)
// f32, overflow (G,) bool bytes, all contiguous on the current device.
// ``valid_lens`` is a (G,) int32 device array or null (then ``valid_len``
// holds for every row). Returns the CUDA error code of the launch (0 on
// success); shared memory past what a block may take returns
// cudaErrorInvalidValue.
extern "C" int apd_lean_greedy(const float* corr, const int* valid_lens, int G, int L,
                               int valid_len, const float* bmax, int nb, const float* denom,
                               float hm, int min_distance, int r_max, long long* pos,
                               float* height, unsigned char* overflow, void* stream) {
  if (G <= 0) return 0;
  const size_t smem = lean_smem(nb, r_max);
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
