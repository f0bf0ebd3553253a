// Live-lane compaction for the marker verifier (csrc/verify_marker.cu), for
// sm_90a. Its block scan also orders the lane greedy's compaction and radix
// sort (csrc/lane_greedy.cu).
//
// A verifier's lanes (R, K) come with an alive flag each; only live lanes
// are computed, and the work is shared out by rank among live lanes, so
// that CTAs share the live lanes evenly wherever they sit: the live lane of
// rank q goes to worker q mod workers. The flags are read in tiles of
// kPerThread bytes a thread; a block-wide exclusive scan of the tile's
// counts gives each live lane its rank, and the worker's lanes of a tile
// are listed in rank order. A tile's dead lanes are left to the worker the
// tile number names (tile mod workers), which writes their outputs.

#pragma once

#include <cuda_runtime.h>

namespace live_lanes {

constexpr int kPerThread = 16;

// Inclusive warp scan, then the warps' totals scanned by warp 0. Returns
// the exclusive prefix of v over the block; *total the block's sum. scan
// holds 32 ints. Every thread of the block calls it.
template <int kThreads>
__device__ int block_exclusive_scan(int v, int* scan, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? scan[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += n;
    }
    scan[lane] = s;
  }
  __syncthreads();
  const int base = warp ? scan[warp - 1] : 0;
  *total = scan[kThreads / 32 - 1];
  __syncthreads();  // scan is rewritten by the next call
  return base + incl - v;
}

// Calls dead(lane) for the dead lanes of the tiles this worker owns, and
// live(lane) for the live lanes of rank worker mod workers, in rank order.
// live is called by every thread of the block with the same lane (it may
// hold barriers). list holds kThreads * kPerThread offsets, scan 32 ints.
// Ranks are ints: the wrappers keep a launch's lanes below 2^31.
template <int kThreads, class Dead, class Live>
__device__ void for_each_live(const unsigned char* __restrict__ alive, long long n_lanes,
                              int worker, int workers, unsigned short* list, int* scan,
                              Dead dead, Live live) {
  constexpr int kTile = kThreads * kPerThread;
  int running = 0;  // live lanes in the tiles before this one
  int t = 0;
  for (long long tile0 = 0; tile0 < n_lanes; tile0 += kTile, ++t) {
    const long long first = tile0 + static_cast<long long>(threadIdx.x) * kPerThread;
    unsigned char flags[kPerThread];
    int v = 0;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      flags[q] = first + q < n_lanes ? alive[first + q] != 0 : 0;
      v += flags[q];
    }
    int total;
    int rank = running + block_exclusive_scan<kThreads>(v, scan, &total);
    // The worker's ranks are mine0, mine0 + workers, ...: the first at or
    // after `running`, and this thread's first at or after its own.
    const int mine0 = running + ((worker - running % workers) + workers) % workers;
    int next = rank + ((worker - rank % workers) + workers) % workers;
    const bool owner = t % workers == worker;
#pragma unroll
    for (int q = 0; q < kPerThread; ++q) {
      if (first + q >= n_lanes) break;
      if (flags[q]) {
        if (rank == next) {
          list[(rank - mine0) / workers] = static_cast<unsigned short>(first + q - tile0);
          next += workers;
        }
        ++rank;
      } else if (owner) {
        dead(first + q);
      }
    }
    __syncthreads();
    const int end = running + total;
    const int n = mine0 < end ? (end - mine0 + workers - 1) / workers : 0;
    for (int i = 0; i < n; ++i) live(tile0 + list[i]);
    running = end;
    __syncthreads();  // list is rewritten by the next tile
  }
}

}  // namespace live_lanes
