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
// whatever their positions hold.
//
// Design: one CTA a row. The row's positions (as int32, the plain
// version's width) and its kept flags live in shared memory: 5 bytes a
// lane, 80 KB at K = 16,384, so the dynamic shared memory is sized from K
// and the wrapper refuses a K past the 227 KB a block may have. The CTA
// walks its lanes in priority order up to its own last alive lane; for each
// lane still kept it clears, in parallel, the kept flag of every later lane
// within min_distance, then meets one barrier. A suppressed lane costs no
// sweep and no barrier. Rows are independent, so a group is one launch and
// a row's walk ends with its own candidates, where the while node's passes
// ran to the bank-wide alive count and touched every row each pass.
//
// Bound: the work is O(kept lanes x alive lanes) compares a row, issued in
// shared memory; the bytes (positions and alive flags read once, keep
// written once) are microseconds. The walk is serial in its kept lanes, so
// it is latency-bound: one barrier a kept lane. A design that sorts a row's
// lanes by position and visits only neighbours would cut the sweeps to
// the few lanes within min_distance; that is left for later.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory a launch may take: the 227 KB (232,448 bytes) a
// block may use on sm_90, less room for the kernel's static shared memory.
constexpr int kMaxSmem = 232448 - 1024;

__global__ void __launch_bounds__(kThreads)
lane_greedy_kernel(const long long* __restrict__ pos, const unsigned char* __restrict__ alive,
                   int K, int min_distance, unsigned char* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* spos = reinterpret_cast<int*>(smem);
  unsigned char* kept = smem + static_cast<size_t>(K) * sizeof(int);
  __shared__ int n_row;

  const long long row = static_cast<long long>(blockIdx.x) * K;
  if (threadIdx.x == 0) n_row = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const unsigned char a = alive[row + i] != 0;
    spos[i] = static_cast<int>(pos[row + i]);  // the plain version's int32
    kept[i] = a;
    if (a) last = i + 1;
  }
  if (last) atomicMax(&n_row, last);
  __syncthreads();

  const int n = n_row;
  for (int i = 0; i < n; ++i) {
    if (!kept[i]) continue;  // uniform: every thread reads the same flag
    const long long p = spos[i];
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads) {
      const long long d = static_cast<long long>(spos[j]) - p;
      if (kept[j] && (d < 0 ? -d : d) < min_distance) kept[j] = 0;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < K; i += kThreads) keep[row + i] = kept[i];
}

}  // namespace

// C interface for ctypes. pos is (G, K) int64, alive and keep (G, K) bool
// bytes, all contiguous on the current device. Returns the CUDA error code
// of the launch (0 on success); a K whose lanes do not fit in shared memory
// (K > 46,284) returns cudaErrorInvalidValue.
extern "C" int apd_lane_greedy(const long long* pos, const unsigned char* alive, int G, int K,
                               int min_distance, unsigned char* keep, void* stream) {
  if (G <= 0 || K <= 0) return 0;
  const size_t smem = (static_cast<size_t>(K) * (sizeof(int) + 1) + 15) & ~static_cast<size_t>(15);
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
