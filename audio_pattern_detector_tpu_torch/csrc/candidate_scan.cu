// Single-pass candidate scan of the lean detection tier, for sm_90a.
//
// Replaces the Pallas TPU kernel
// audio_pattern_detector_tpu/ops/pallas_peaks.py::candidate_scan
// (body _scan_kernel, shift helper _flat_roll). It computes the same five
// outputs from one read of each |correlation| row:
//   * samples at or past the row's valid length are -inf;
//   * cand: plateau-midpoint local maxima for runs of length 1-3
//     (ops/peaks.py::plateau_run_mask), excluding index 0;
//   * bmax[g, b]: max of cand values in 512-sample block b, -inf if none;
//   * count[g]: cand samples at or above thr_min[g];
//   * plateau[g]: an equal-value run of length >= 4 at or above thr_min[g];
//   * omax[g]: max finite sample (floor 0);
//   * near[g]: a sample at or above thr_min[g] whose strictly-unequal
//     finite neighbour within 2 samples lies inside 8 ulp relative.
// The valid length is one scalar for every row, or one per row
// (``valid_lens``, nullable).
//
// Bound: device-memory bandwidth. Each f32 sample is read once and only
// (G, L/512) block maxima and four (G,) stats are written: 63.5 MB read
// for a flagship group (32 x 495,999), 19 us at 3.35 TB/s. Evaluating the
// candidate test on every sample costs more issue time than that (about
// 17 instructions a sample), so the design evaluates it only where it can
// change an output, and it overlaps loads with the scan. Its time depends
// on the share of samples at or above the threshold: the main path's
// thresholds are lower bounds of a detection's height, which few samples
// reach, and a caller that reads neither count, plateau nor near passes
// +inf, which none reaches.
//   * Persistent CTAs: about one wave (the occupancy limit times the SM
//     count), each walking a contiguous range of (row, 4096-sample tile)
//     items in row-major order.
//   * A ring of kStages shared-memory stages, each filled by one 1-D TMA
//     bulk copy (cp.async.bulk) that completes on the stage's mbarrier, so
//     the next tile streams in while the current one is scanned; with two
//     stages five CTAs fit on an SM, ten tiles in all. Rows of
//     odd length start off 16-byte alignment, so each tile's copy window is
//     aligned down to 16 bytes in the flat (G * L) buffer and the offset
//     (2-5 samples) is carried as an index; the window holds the tile, its
//     -2 / +3 halo and the slack. A window is clipped to the 16-byte chunks
//     that hold corr; what it misses lies outside every row and is masked.
//   * Fast path, every sample: one conflict-free shared load (lane l of a
//     warp reads samples l, l + 32, ... of the warp's 512-sample block),
//     a running max and an "at or above the threshold" test. The block's
//     candidate max equals the block max M when any sample equal to M is a
//     candidate, so only those samples run the candidate test; a block
//     whose max is not a candidate (a plateau of 4 or more, or a slope
//     across the block's edge) reruns the test on every sample. Samples at
//     or above the threshold run the count, plateau and near tests one at
//     a time. omax is the max of the block maxima (floor 0).
//   * A warp covers exactly one 512-sample block, so a block maximum is one
//     warp reduction and one store. Per-row stats stay in registers across
//     a CTA's tiles and leave with one atomic each per row the CTA touches,
//     into outputs the wrapper zeroes before the launch (plateau and near
//     are plain stores of 1). Tiles at a row's start or valid end mask
//     their window to -inf in shared memory first; interior tiles skip
//     that.
//   * A tile wholly at or past its row's valid length holds no candidate
//     and no finite sample: it is not copied, its block maxima are written
//     as -inf and its stage of the ring stays idle for that turn (each
//     thread keeps the stages' mbarrier phases in a register, since a
//     skipped turn completes none). A batched round's short and idle rows
//     then cost their valid tiles only.
// Every reduction is a max, an or or an integer sum, so the outputs are
// bitwise deterministic and bitwise equal to the plain version.
//
// Built with -fmad=false; the near-collapse test also rounds explicitly
// (__fsub_rn, __fmul_rn) so |x - n| <= 2^-20 * x matches the plain f32
// version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 512;                   // stage-1 block width
constexpr int kThreads = 256;                 // 8 warps, one block each
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kBlock * kWarps;        // 4096 samples per item
constexpr int kPerLane = kBlock / 32;         // 16 samples a lane per tile
constexpr int kWin = kTile + 8;               // tile, halo and alignment slack
constexpr int kStages = 2;
constexpr size_t kSmemBytes = sizeof(float) * kWin * kStages;
constexpr float kNearTol = 8.0f * 1.1920928955078125e-07f;  // 8 ulp at 1.0

static_assert((kWin * sizeof(float)) % 16 == 0, "stages stay 16-byte aligned");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)));
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// One 1-D TMA copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) into shared memory, completing on ``bar``.
__device__ __forceinline__ void tma_load(float* dst, const float* src, unsigned bytes,
                                         unsigned long long* bar) {
  // Generic-proxy writes to this stage (the -inf mask) come before the copy.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ bool pair_near(float x, float n, float tol) {
  return (n != x) && (n != -INFINITY) && (fabsf(__fsub_rn(x, n)) <= tol);
}

// ops/peaks.py::plateau_run_mask at shared index q, row index i: runs of
// length 1-3, never index 0, no length-3 run at index 1. A -inf x fails
// every comparison, so the finiteness of x needs no test of its own.
__device__ __forceinline__ bool is_cand(const float* __restrict__ s, int q, long long i) {
  const float x = s[q], xm2 = s[q - 2], xm1 = s[q - 1], xp1 = s[q + 1], xp2 = s[q + 2];
  const bool l1 = xm1 < x;
  const bool len3 = (xm1 == x) && (xm2 < x) && (i > 1);
  const bool c = (l1 && (xp1 < x) && (xp1 != -INFINITY)) ||
                 ((xp1 == x) && (xp2 < x) && (xp2 != -INFINITY) && (l1 || len3));
  return c && i > 0;
}

// One tile from its stage ``s`` (sample j of the tile at s[d + j]): each
// warp scans its 512-sample block, writes the block maximum and folds the
// row stats into the lane's registers.
__device__ __forceinline__ void scan_tile(const float* __restrict__ s, int d, long long t0,
                                          float thr, float* __restrict__ bmax_out, bool store,
                                          float& om, int& cnt, int& flags) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int q0 = d + warp * kBlock + lane;  // this lane's sample m is at q0 + 32 m
  const long long i0 = t0 + warp * kBlock + lane;
  // The samples are not kept in registers past this loop (occupancy):
  // the lane's max and the bits of its samples equal to it are.
  float lmx = -INFINITY;
  unsigned bits = 0;    // bit m: sample m is at or above the threshold
  unsigned at_lmx = 0;  // bit m: sample m equals lmx
#pragma unroll
  for (int m = 0; m < kPerLane; ++m) {
    const float x = s[q0 + 32 * m];
    bits |= (x >= thr && x != -INFINITY ? 1u : 0u) << m;
    at_lmx = x > lmx ? 1u << m : (x == lmx ? at_lmx | 1u << m : at_lmx);
    lmx = fmaxf(lmx, x);
  }
  float mx = lmx;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  om = fmaxf(om, mx);
  // The lane's samples at or above the threshold, one at a time.
  unsigned above = bits;
  while (above) {
    const int m = __ffs(above) - 1;
    above &= above - 1;
    const int q = q0 + 32 * m;
    const float x = s[q];
    cnt += is_cand(s, q, i0 + 32 * m) ? 1 : 0;
    if ((x == s[q + 1]) && (s[q + 1] == s[q + 2]) && (s[q + 2] == s[q + 3])) flags |= 1;
    const float tol = __fmul_rn(kNearTol, x);
    if (pair_near(x, s[q - 2], tol) || pair_near(x, s[q - 1], tol) ||
        pair_near(x, s[q + 1], tol) || pair_near(x, s[q + 2], tol))
      flags |= 2;
  }
  float bm = -INFINITY;
  if (mx != -INFINITY) {
    // Is any sample equal to the block max a candidate?
    unsigned at_max = lmx == mx ? at_lmx : 0u;
    bool hit = false;
    while (at_max && !hit) {
      const int m = __ffs(at_max) - 1;
      at_max &= at_max - 1;
      hit = is_cand(s, q0 + 32 * m, i0 + 32 * m);
    }
    if (__any_sync(0xffffffffu, hit)) {
      bm = mx;
    } else {
      // The block max is no candidate: the candidate max of the block.
#pragma unroll
      for (int m = 0; m < kPerLane; ++m)
        if (is_cand(s, q0 + 32 * m, i0 + 32 * m)) bm = fmaxf(bm, s[q0 + 32 * m]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) bm = fmaxf(bm, __shfl_xor_sync(0xffffffffu, bm, off));
    }
  }
  if (lane == 0 && store) *bmax_out = bm;
}

__global__ void __launch_bounds__(kThreads)
candidate_scan_kernel(const float* __restrict__ base, int off0, const float* __restrict__ thr_min,
                      const int* __restrict__ valid_lens, int valid_len, int G, int L,
                      int tiles_per_row, int nb, float* __restrict__ bmax,
                      int* __restrict__ count, int* __restrict__ omax_bits,
                      unsigned char* __restrict__ plateau, unsigned char* __restrict__ near) {
  extern __shared__ __align__(16) float ring[];
  __shared__ __align__(8) unsigned long long full[kStages];
  __shared__ int warp_count[kWarps];
  __shared__ float warp_omax[kWarps];
  __shared__ int warp_flags[kWarps];

  const long long n_items = static_cast<long long>(G) * tiles_per_row;
  const long long i0 = n_items * blockIdx.x / gridDim.x;
  const long long i1 = n_items * (blockIdx.x + 1) / gridDim.x;
  const int n = static_cast<int>(i1 - i0);
  // Floats of the 16-byte-aligned buffer that hold corr: [off0, off0 + G*L);
  // the 16-byte chunks that hold any of them: [0, chunk_hi).
  const long long flat_lo = off0, flat_hi = off0 + static_cast<long long>(G) * L;
  const long long chunk_hi = (flat_hi + 3) & ~3LL;

  // First float of the item's copy window (aligned down to 16 bytes, with
  // 2-5 samples of left halo) and the offset of the tile's sample 0 in it.
  auto window = [&](long long item, long long& a0, int& d) {
    const long long g = item / tiles_per_row, t = item % tiles_per_row;
    const long long first = flat_lo + g * L + t * kTile;
    a0 = (first - 2) & ~3LL;
    d = static_cast<int>(first - a0);
  };
  // The row's valid length, clamped to [0, L].
  auto row_limit = [&](long long g) -> long long {
    const int v = valid_lens != nullptr ? valid_lens[g] : valid_len;
    return v < 0 ? 0 : (v < L ? v : L);
  };
  // No sample of the item's tile is valid. (Its left halo may be, but a
  // halo sample only serves as a neighbour of the tile's own samples.)
  auto past_end = [&](long long item) -> bool {
    return (item % tiles_per_row) * kTile >= row_limit(item / tiles_per_row);
  };
  auto issue = [&](long long item, int stage) {
    if (past_end(item)) return;
    long long a0;
    int d;
    window(item, a0, d);
    const long long c0 = a0 > 0 ? a0 : 0;
    const long long c1 = a0 + kWin < chunk_hi ? a0 + kWin : chunk_hi;
    tma_load(ring + stage * kWin + (c0 - a0), base + c0,
             static_cast<unsigned>((c1 - c0) * sizeof(float)), &full[stage]);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < kStages - 1 && s < n; ++s) issue(i0 + s, s);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  int cur_g = -1;
  unsigned phases = 0;  // bit s: the parity of stage s's next completed copy
  float om = 0.0f;
  int cnt = 0, flags = 0;

  // The row stats of the CTA so far into the outputs. The first barrier
  // keeps thread 0's reads of the previous flush ahead of this one's
  // writes, whatever ran in between.
  auto flush = [&]() {
    __syncthreads();
    cnt = __reduce_add_sync(0xffffffffu, cnt);
    flags = static_cast<int>(__reduce_or_sync(0xffffffffu, static_cast<unsigned>(flags)));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) om = fmaxf(om, __shfl_xor_sync(0xffffffffu, om, off));
    if (lane == 0) {
      warp_count[warp] = cnt;
      warp_omax[warp] = om;
      warp_flags[warp] = flags;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int c = 0, f = 0;
      float o = 0.0f;
      for (int w = 0; w < kWarps; ++w) {
        c += warp_count[w];
        o = fmaxf(o, warp_omax[w]);
        f |= warp_flags[w];
      }
      if (c) atomicAdd(count + cur_g, c);
      // o >= +0.0, so its bit pattern orders like the float.
      if (o > 0.0f) atomicMax(omax_bits + cur_g, __float_as_int(o));
      if (f & 1) plateau[cur_g] = 1;
      if (f & 2) near[cur_g] = 1;
    }
    cnt = 0;
    om = 0.0f;
    flags = 0;
  };

  for (int k = 0; k < n; ++k) {
    // Every thread is done with item k-1, so its stage may be refilled;
    // the barriers are initialised before any thread waits on one.
    __syncthreads();
    if (threadIdx.x == 0 && k + kStages - 1 < n)
      issue(i0 + k + kStages - 1, (k + kStages - 1) % kStages);

    const long long item = i0 + k;
    const int g = static_cast<int>(item / tiles_per_row);
    const int t = static_cast<int>(item % tiles_per_row);
    if (g != cur_g) {
      if (cur_g >= 0) flush();
      cur_g = g;
    }
    const int blk = t * kWarps + warp;
    if (past_end(item)) {
      if (lane == 0 && blk < nb) bmax[static_cast<long long>(g) * nb + blk] = -INFINITY;
      continue;
    }
    const int stage = k % kStages;
    mbar_wait(&full[stage], (phases >> stage) & 1u);
    phases ^= 1u << stage;
    long long a0;
    int d;
    window(item, a0, d);
    float* s = ring + stage * kWin;
    const long long lim = row_limit(g);
    const long long t0 = static_cast<long long>(t) * kTile;
    if (t == 0 || t0 + kTile + 3 > lim) {
      // Row start or valid end: everything outside [0, lim) reads -inf.
      for (int p = threadIdx.x; p < kWin; p += kThreads) {
        const long long i = t0 + p - d;
        if (i < 0 || i >= lim) s[p] = -INFINITY;
      }
      __syncthreads();
    }
    scan_tile(s, d, t0, thr_min[g], bmax + static_cast<long long>(g) * nb + blk, blk < nb, om,
              cnt, flags);
  }
  if (cur_g >= 0) flush();
}

}  // namespace

// C interface for ctypes. bmax is (G, nb) with nb = ceil(L / 512); count
// (int32), omax (f32, as its int32 bits), plateau and near (bool bytes)
// are (G,) and zero before the launch. ``valid_lens`` is a (G,) int32
// device array or null (then ``valid_len`` holds for every row). Returns
// the CUDA error code of the launch (0 on success).
extern "C" int apd_candidate_scan(const float* corr, const float* thr_min,
                                  const int* valid_lens, int G, int L, int valid_len,
                                  float* bmax, int nb, int* count, int* omax_bits,
                                  unsigned char* plateau, unsigned char* near, void* stream) {
  if (G <= 0 || L <= 0) return 0;
  // Per device: the SM count and how many CTAs fit on one SM.
  static int sms[64], per_sm[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (per_sm[dev] == 0) {
    err = cudaFuncSetAttribute(candidate_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], candidate_scan_kernel,
                                                          kThreads, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm[dev] < 1) per_sm[dev] = 1;
  }
  const int tiles_per_row = (L + kTile - 1) / kTile;
  const long long n_items = static_cast<long long>(G) * tiles_per_row;
  const long long wave = static_cast<long long>(sms[dev]) * per_sm[dev];
  const int grid = static_cast<int>(n_items < wave ? n_items : wave);
  const uintptr_t p = reinterpret_cast<uintptr_t>(corr);
  const float* base = reinterpret_cast<const float*>(p & ~static_cast<uintptr_t>(15));
  const int off0 = static_cast<int>((p & 15) / sizeof(float));
  candidate_scan_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      base, off0, thr_min, valid_lens, valid_len, G, L, tiles_per_row, nb, bmax, count, omax_bits,
      plateau, near);
  return static_cast<int>(cudaGetLastError());
}
