// The lane greedy of the full detection tier, for sm_90a.
//
// Replaces the XLA program of the JAX package's greedy distance filter,
// audio_pattern_detector_tpu/ops/peaks.py::greedy_distance_filter (its
// lax.while_loop forms _greedy_distance_sequential and
// _greedy_distance_parallel, ops/peaks.py:254-340). It was never a Pallas
// kernel: XLA compiles the loop into the class step's program, where the
// port ran it as a while node of 8 small kernels a pass, one pass a lane.
//
// Per row g of (G, K) lanes sorted by priority (height descending, ties to
// the lower position), keep[g, i] is set when lane i is alive and no kept
// lane j < i of the row lies within min_distance of it (|pos_i - pos_j| <
// min_distance): scipy's distance filter. That is the unique fixed point of
// the JAX parallel recurrence, and, for rows whose alive lanes are a prefix
// (every caller's: the lanes come height-sorted from a top-k), the JAX
// sequential loop's result. Dead lanes are never kept and never suppress,
// whatever their positions hold. Positions are taken as int32 (the plain
// version's width), distances in 64 bits.
//
// Design: one CTA a row, in shared memory, in five steps.
//   1. The row's alive lanes are compacted in lane order (a block scan of
//      each thread's count over a contiguous chunk of lanes); compact index
//      c keeps the priority order. Each gets a key, its position less the
//      row's smallest alive position, as uint32.
//   2. The keys are sorted with their compact indices by a stable LSD radix
//      sort, 4 bits a pass, only as many passes as the row's span of
//      positions needs (19 bits, 5 passes, for a 496 k-sample row; none
//      when every alive lane sits at one position). Each thread counts the
//      digits of a contiguous chunk into its own column of a (16, threads)
//      table of 16-bit counts; a block scan of the table in digit-major
//      order gives every (digit, thread) its first output slot, so equal
//      digits keep their order.
//   3. A lane's neighbours (the lanes within min_distance of it) are then
//      one range [lo, hi) of the sorted order, found for each sorted slot by
//      two binary searches of a fixed number of steps (so a warp's lanes do
//      not diverge).
//   4. One warp walks the compact lanes in priority order, 32 at a time:
//      it ballots the chunk's "still open" flags, and its lowest open lane
//      that has a neighbour at all is kept; the warp clears, 64 slots of
//      its neighbour range a step, the open flags of its neighbours of
//      higher index (in shared memory for later chunks, in the ballot word
//      for this one, reduced across the warp only when one lies there),
//      then goes on from that lane. Open lanes without a neighbour cost
//      nothing. No CTA-wide barrier is met during the walk.
//   5. The CTA writes keep, lane by lane.
// The row's positions and alive flags are read from device memory with
// coalesced loads into shared memory first (the alive flags a second time
// while the walk runs), and keep goes out with coalesced stores.
// A kept lane's neighbours are swept once; since kept lanes lie at least
// min_distance apart, a lane is the neighbour of at most two kept lanes, so
// the walk's sweeps total at most twice the alive lanes, plus a ballot a
// chunk. Every alive lane at one position, or all within min_distance of
// each other, is one kept lane and one sweep of the row; min_distance 0
// has no neighbours and only ballots.
//
// Shared memory: per lane two keys (4 + 4 bytes), two compact indices (2 +
// 2), an open flag (1), with the neighbour ranges written over the key
// buffer the sort did not end in; plus the 8 KB count table. So 13 bytes a
// lane and 8 KB: K = 16,384 takes 221,184 bytes, and the wrapper refuses a
// K past 17,171, where the 227 KB a block may have runs out. Rows are
// independent, so a group is one launch and a row's walk ends with its own
// lanes. One CTA a row at any K: a small K's CTA is small, so up to eight
// rows share an SM and their walks overlap there.
//
// Bound: the bytes (positions and alive flags read once, keep written once)
// are microseconds for a group. A row is latency-bound: the walk is serial
// in its chunks and kept lanes, and each chunk's ballot and each sweep step
// is a short chain of dependent shared-memory reads and warp votes (about
// 120 SM cycles each on an H100; scripts/probe_greedy_steps.py times the
// steps), with the sort and the range searches before it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "live_lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 4;
constexpr int kDigits = 1 << kDigitBits;
constexpr int kCountBytes = kDigits * kThreads * static_cast<int>(sizeof(unsigned short));
constexpr int kLaneBytes = 13;  // two keys, two compact indices, an open flag
// Dynamic shared memory a launch may take: the 227 KB (232,448 bytes) a
// block may use on sm_90, less room for the kernel's static shared memory.
constexpr int kMaxSmem = 232448 - 1024;

__global__ void __launch_bounds__(kThreads)
lane_greedy_kernel(const long long* __restrict__ pos, const unsigned char* __restrict__ alive,
                   int K, int min_distance, unsigned char* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned short* counts = reinterpret_cast<unsigned short*>(smem);  // [digit][thread]
  unsigned* key0 = reinterpret_cast<unsigned*>(smem + kCountBytes);
  unsigned* key1 = key0 + K;
  unsigned short* val0 = reinterpret_cast<unsigned short*>(key1 + K);
  unsigned short* val1 = val0 + K;
  unsigned char* open = reinterpret_cast<unsigned char*>(val1 + K);
  __shared__ int scan[32];
  __shared__ int red_min[kWarps], red_max[kWarps];

  const long long row = static_cast<long long>(blockIdx.x) * K;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 1. The row staged in shared memory with coalesced loads: alive flags
  // in ``open``, alive lanes' positions in key1. Then each thread's chunk of
  // lanes (an odd number of them, so that the threads' chunks fall in
  // different banks): its alive count and position range.
  for (int i = t; i < K; i += kThreads) {
    const bool a = alive[row + i] != 0;
    open[i] = a;
    if (a) key1[i] = static_cast<unsigned>(static_cast<int>(pos[row + i]));  // int32
  }
  __syncthreads();
  const int ek = ((K + kThreads - 1) / kThreads) | 1;
  const int l0 = min(K, t * ek), l1 = min(K, l0 + ek);
  int cnt = 0, pmin = INT_MAX, pmax = INT_MIN;
  for (int i = l0; i < l1; ++i) {
    if (open[i]) {
      const int p = static_cast<int>(key1[i]);
      ++cnt;
      pmin = min(pmin, p);
      pmax = max(pmax, p);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    pmin = min(pmin, __shfl_xor_sync(0xffffffffu, pmin, off));
    pmax = max(pmax, __shfl_xor_sync(0xffffffffu, pmax, off));
  }
  if (lane == 0) {
    red_min[warp] = pmin;
    red_max[warp] = pmax;
  }
  int n;
  const int c0 = live_lanes::block_exclusive_scan<kThreads>(cnt, scan, &n);
  if (n == 0) {
    for (int i = t; i < K; i += kThreads) keep[row + i] = 0;
    return;  // uniform: n is the row's
  }
  for (int w = 0; w < kWarps; ++w) {
    pmin = min(pmin, red_min[w]);
    pmax = max(pmax, red_max[w]);
  }
  for (int i = l0, c = c0; i < l1; ++i) {
    if (open[i]) {
      key0[c] = static_cast<unsigned>(static_cast<long long>(static_cast<int>(key1[i])) - pmin);
      val0[c] = static_cast<unsigned short>(c);
      ++c;
    }
  }
  __syncthreads();
  for (int c = t; c < n; c += kThreads) open[c] = 1;  // now by compact lane

  // 2. Stable LSD radix sort of (key, compact index), 4 bits a pass.
  const unsigned span = static_cast<unsigned>(static_cast<long long>(pmax) - pmin);
  const int bits = span ? 32 - __clz(span) : 0;
  const int e = ((n + kThreads - 1) / kThreads) | 1;
  const int s0 = min(n, t * e), s1 = min(n, s0 + e);
  unsigned *kin = key0, *kout = key1;
  unsigned short *vin = val0, *vout = val1;
  unsigned short* col = counts + t;  // this thread's column: col[d * kThreads]
  for (int shift = 0; shift < bits; shift += kDigitBits) {
    for (int d = 0; d < kDigits; ++d) col[d * kThreads] = 0;
    for (int s = s0; s < s1; ++s) ++col[((kin[s] >> shift) & (kDigits - 1)) * kThreads];
    __syncthreads();
    unsigned short* mine = counts + t * kDigits;  // entries [16 t, 16 t + 16) in scan order
    int sum = 0;
    for (int q = 0; q < kDigits; ++q) sum += mine[q];
    int total;
    int run = live_lanes::block_exclusive_scan<kThreads>(sum, scan, &total);
    for (int q = 0; q < kDigits; ++q) {
      const int v = mine[q];
      mine[q] = static_cast<unsigned short>(run);
      run += v;
    }
    __syncthreads();
    for (int s = s0; s < s1; ++s) {
      const unsigned k = kin[s];
      unsigned short* slot = col + ((k >> shift) & (kDigits - 1)) * kThreads;
      const int o = *slot;
      *slot = static_cast<unsigned short>(o + 1);
      kout[o] = k;
      vout[o] = vin[s];
    }
    __syncthreads();
    unsigned* kt = kin;
    kin = kout;
    kout = kt;
    unsigned short* vt = vin;
    vin = vout;
    vout = vt;
  }

  // 3. Each lane's neighbour range [lo, hi) of the sorted order, indexed by
  // compact lane, in the key buffer the sort did not end in: the sorted
  // slots strided over the threads, each a pair of fixed-count searches.
  const unsigned* skey = kin;
  const unsigned short* sval = vin;
  unsigned* range = kout;
  const long long m1 = static_cast<long long>(min_distance) - 1;
  int steps = 0;
  while ((1 << steps) <= n) ++steps;
  for (int s = t; s < n; s += kThreads) {
    const long long k = skey[s];
    int lo = 0, hi = 0;
    for (int b = steps - 1; b >= 0; --b) {  // fixed-count searches: no divergence
      const int nl = lo + (1 << b), nh = hi + (1 << b);
      if (nl <= n && static_cast<long long>(skey[nl - 1]) < k - m1) lo = nl;
      if (nh <= n && static_cast<long long>(skey[nh - 1]) <= k + m1) hi = nh;
    }
    range[sval[s]] = static_cast<unsigned>(lo) | static_cast<unsigned>(hi) << 16;
  }
  __syncthreads();

  // 4. The walk, on warp 0, in priority order, while the other warps stage
  // the alive flags again (in the compact-index buffer the sort left free).
  unsigned short* stage = vout;
  if (warp == 0) {
    for (int base = 0; base < n; base += 32) {
      const int c = base + lane;
      bool o = false;
      int rlo = 0, rhi = 0;
      if (c < n) {
        o = open[c] != 0;
        const unsigned r = range[c];
        rlo = static_cast<int>(r & 0xffffu);
        rhi = static_cast<int>(r >> 16);
      }
      unsigned word = __ballot_sync(0xffffffffu, o);
      const unsigned sweepers = __ballot_sync(0xffffffffu, o && rhi > rlo + 1);
      unsigned todo = word & sweepers;
      while (todo) {
        const int b = __ffs(todo) - 1;
        const int i = base + b;  // kept
        const int blo = __shfl_sync(0xffffffffu, rlo, b);
        const int bhi = __shfl_sync(0xffffffffu, rhi, b);
        unsigned cleared = 0;
        for (int q = blo; q < bhi; q += 64) {
          unsigned bit = 0;
          const int qa = q + lane, qb = q + 32 + lane;
          const int ja = qa < bhi ? sval[qa] : -1;
          const int jb = qb < bhi ? sval[qb] : -1;
          if (ja > i) {
            if (ja < base + 32) bit |= 1u << (ja - base);
            else open[ja] = 0;
          }
          if (jb > i) {
            if (jb < base + 32) bit |= 1u << (jb - base);
            else open[jb] = 0;
          }
          if (__ballot_sync(0xffffffffu, bit != 0)) cleared |= __reduce_or_sync(0xffffffffu, bit);
        }
        word &= ~cleared;
        todo = word & sweepers & (b == 31 ? 0u : ~0u << (b + 1));
      }
      if (c < n) open[c] = static_cast<unsigned char>((word >> lane) & 1u);
      __syncwarp();
    }
  } else {
    for (int i = t - 32; i < K; i += kThreads - 32) stage[i] = alive[row + i] != 0;
  }
  __syncthreads();

  // 5. keep, lane by lane: each thread's chunk in place, then written out
  // with coalesced stores.
  for (int i = l0, c = c0; i < l1; ++i) stage[i] = stage[i] ? open[c++] : 0;
  __syncthreads();
  for (int i = t; i < K; i += kThreads) keep[row + i] = static_cast<unsigned char>(stage[i]);
}

}  // namespace

// C interface for ctypes. pos is (G, K) int64, alive and keep (G, K) bool
// bytes, all contiguous on the current device. Returns the CUDA error code
// of the launch (0 on success); a K whose lanes do not fit in shared memory
// (K > 17,171) returns cudaErrorInvalidValue.
extern "C" int apd_lane_greedy(const long long* pos, const unsigned char* alive, int G, int K,
                               int min_distance, unsigned char* keep, void* stream) {
  if (G <= 0 || K <= 0) return 0;
  const size_t smem = static_cast<size_t>(kCountBytes) + static_cast<size_t>(K) * kLaneBytes;
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  static bool ready[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(lane_greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready[dev] = true;
  }
  lane_greedy_kernel<<<G, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, alive, K, min_distance, keep);
  return static_cast<int>(cudaGetLastError());
}
