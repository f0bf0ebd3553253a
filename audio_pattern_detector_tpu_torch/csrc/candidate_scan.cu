// Single-pass candidate scan of the lean detection tier, for sm_90a.
//
// Replaces the Pallas TPU kernel
// audio_pattern_detector_tpu/ops/pallas_peaks.py::candidate_scan
// (body _scan_kernel, shift helper _flat_roll). It computes the same five
// outputs from one read of each |correlation| row:
//   * samples at or past valid_len are -inf;
//   * cand: plateau-midpoint local maxima for runs of length 1-3
//     (ops/peaks.py::plateau_run_mask), excluding index 0;
//   * bmax[g, b]: max of cand values in 512-sample block b, -inf if none;
//   * count[g]: cand samples at or above thr_min[g];
//   * plateau[g]: an equal-value run of length >= 4 at or above thr_min[g];
//   * omax[g]: max finite sample (floor 0);
//   * near[g]: a sample at or above thr_min[g] whose strictly-unequal
//     finite neighbour within 2 samples lies inside 8 ulp relative.
//
// Bound: device-memory bandwidth. The kernel reads each f32 sample once
// (plus a 6-sample halo per 4096-sample tile) and writes only (G, L/512)
// block maxima and four (G,) stats: about 63 MB read per flagship group
// (32 x 495,999). Design: one CTA per (row, 4096-sample tile) stages the
// tile and its +-3 halo in shared memory, so the shifted neighbours are
// shared-memory reads instead of the TPU kernel's rolls and carries; each
// thread keeps its samples' stats in registers, a warp-shuffle and
// shared-memory reduction folds them per CTA, and per-row stats cross
// CTAs with one integer atomic each. Every reduction is a max, an or or
// an integer sum, so the outputs are bitwise deterministic.
//
// Built with -fmad=false; the near-collapse test also rounds explicitly
// (__fsub_rn, __fmul_rn) so |x - n| <= 2^-20 * x matches the plain f32
// version bit for bit.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 512;                        // stage-1 block width
constexpr int kTile = 4096;                        // samples per CTA
constexpr int kThreads = 256;
constexpr int kPerThread = kTile / kThreads;       // 16
constexpr int kBlocksPerTile = kTile / kBlock;     // 8
constexpr int kHalo = 3;                           // x[i-2] .. x[i+3]
constexpr int kWarps = kThreads / 32;
constexpr float kNearTol = 8.0f * 1.1920928955078125e-07f;  // 8 ulp at 1.0

static_assert(kThreads * 2 == kBlock, "each thread's sample pair k, k+1 shares a block");

__device__ __forceinline__ bool pair_near(float x, float n, float tol) {
  return (n != x) && (n != -INFINITY) && (fabsf(__fsub_rn(x, n)) <= tol);
}

__global__ void __launch_bounds__(kThreads)
candidate_scan_kernel(const float* __restrict__ corr, const float* __restrict__ thr_min,
                      int L, int valid_len, int nb, float* __restrict__ bmax,
                      int* __restrict__ count, float* __restrict__ omax,
                      int* __restrict__ plateau, int* __restrict__ near) {
  __shared__ float tile[kTile + 2 * kHalo];
  __shared__ float warp_bmax[kWarps][kBlocksPerTile];
  __shared__ int warp_count[kWarps];
  __shared__ float warp_omax[kWarps];
  __shared__ int warp_flags[kWarps];

  const int g = blockIdx.y;
  const long long base = static_cast<long long>(blockIdx.x) * kTile;
  const float* row = corr + static_cast<long long>(g) * L;
  const long long lim = valid_len < L ? valid_len : L;

  for (int i = threadIdx.x; i < kTile + 2 * kHalo; i += kThreads) {
    const long long idx = base - kHalo + i;
    tile[i] = (idx >= 0 && idx < lim) ? row[idx] : -INFINITY;
  }
  __syncthreads();

  const float thr = thr_min[g];
  float bm[kBlocksPerTile];
#pragma unroll
  for (int b = 0; b < kBlocksPerTile; ++b) bm[b] = -INFINITY;
  int cnt = 0;
  bool quad_any = false;
  bool near_any = false;
  float om = 0.0f;

#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int i = threadIdx.x + k * kThreads;
    const long long idx = base + i;
    const float* p = tile + kHalo + i;
    const float x = p[0];
    const float xm2 = p[-2], xm1 = p[-1], xp1 = p[1], xp2 = p[2], xp3 = p[3];
    const bool finite = x != -INFINITY;
    const bool fin_p1 = xp1 != -INFINITY;
    const bool fin_p2 = xp2 != -INFINITY;
    // ops/peaks.py::plateau_run_mask, runs of length 1, 2 and 3.
    const bool len1 = (xm1 < x) && (xp1 < x) && fin_p1;
    const bool len2 = (xm1 < x) && (xp1 == x) && (xp2 < x) && fin_p2;
    const bool len3 = (xm2 < x) && (xm1 == x) && (xp1 == x) && (xp2 < x) && fin_p2 && (idx > 1);
    const bool cand = (len1 || len2 || len3) && (idx > 0) && finite;
    const bool above = x >= thr;
    if (cand) bm[k / 2] = fmaxf(bm[k / 2], x);
    cnt += (cand && above) ? 1 : 0;
    quad_any |= (x == xp1) && (xp1 == xp2) && (xp2 == xp3) && above && finite;
    if (finite) om = fmaxf(om, x);
    if (above && finite) {
      const float tol = __fmul_rn(kNearTol, x);
      near_any |= pair_near(x, xm2, tol) || pair_near(x, xm1, tol) ||
                  pair_near(x, xp1, tol) || pair_near(x, xp2, tol);
    }
  }

  const unsigned full = 0xffffffffu;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int b = 0; b < kBlocksPerTile; ++b) bm[b] = fmaxf(bm[b], __shfl_xor_sync(full, bm[b], off));
    cnt += __shfl_xor_sync(full, cnt, off);
    om = fmaxf(om, __shfl_xor_sync(full, om, off));
  }
  const int flags = (__any_sync(full, quad_any) ? 1 : 0) | (__any_sync(full, near_any) ? 2 : 0);
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int b = 0; b < kBlocksPerTile; ++b) warp_bmax[warp][b] = bm[b];
    warp_count[warp] = cnt;
    warp_omax[warp] = om;
    warp_flags[warp] = flags;
  }
  __syncthreads();

  if (threadIdx.x < kBlocksPerTile) {
    const int b = threadIdx.x;
    const long long blk = static_cast<long long>(blockIdx.x) * kBlocksPerTile + b;
    if (blk < nb) {
      float v = warp_bmax[0][b];
      for (int w = 1; w < kWarps; ++w) v = fmaxf(v, warp_bmax[w][b]);
      bmax[static_cast<long long>(g) * nb + blk] = v;
    }
  }
  if (threadIdx.x == 0) {
    int c = 0, f = 0;
    float o = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      c += warp_count[w];
      o = fmaxf(o, warp_omax[w]);
      f |= warp_flags[w];
    }
    if (c) atomicAdd(count + g, c);
    // o >= +0.0, so its bit pattern orders like the float.
    if (o > 0.0f) atomicMax(reinterpret_cast<int*>(omax + g), __float_as_int(o));
    if (f & 1) atomicOr(plateau + g, 1);
    if (f & 2) atomicOr(near + g, 1);
  }
}

}  // namespace

// C interface for ctypes. count, omax, plateau and near must be zeroed by
// the caller; bmax is (G, nb) with nb = ceil(L / 512). Returns the CUDA
// error code of the launch (0 on success).
extern "C" int apd_candidate_scan(const float* corr, const float* thr_min, int G, int L,
                                  int valid_len, float* bmax, int nb, int* count,
                                  float* omax, int* plateau, int* near, void* stream) {
  if (G <= 0 || L <= 0) return 0;
  const dim3 grid((L + kTile - 1) / kTile, G);
  candidate_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      corr, thr_min, L, valid_len, nb, bmax, count, omax, plateau, near);
  return static_cast<int>(cudaGetLastError());
}
