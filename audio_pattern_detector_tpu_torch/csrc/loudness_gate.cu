// BS.1770 gating of the class step's K-weighted rows (ops/loudness.py),
// for sm_90a.
//
// It replaces no Pallas kernel: it is the tail of the JAX package's
// integrated_loudness_device (audio_pattern_detector_tpu/ops/loudness.py:143),
// from the K-weighted signal to LUFS, which XLA compiles into the class
// step. Written by hand so that every sum is a fixed tree set by the row's
// length and the block geometry alone: a row's LUFS is then the same in
// every round it can ride in (its width, the schedule, eager or captured,
// the row's index), and equal bit for bit to the plain version,
// ops/loudness.py::loudness_gate_reference, which computes the same trees
// with element-wise adds.
//
// The trees. The row is cut into pieces at every block start and end (at
// 8 and 16 kHz the 100 ms quarter blocks). A lane fold sums n values as
// (K, 128) chunks: each of the 128 columns folded over the chunks in
// order, lane l holding columns 4l .. 4l + 3, its four sums added as
// (s0 + s1) + (s2 + s3), then the 32 lanes halved pairwise (lane i plus
// lane i + h, h = 16, 8, 4, 2, 1). A piece's sum is the lane fold of its
// squares (zero at and past the piece's end and the row's length); a
// block's sum is its pieces folded in order; the whole row's sum (the
// short form) and the two gates' sums are lane folds of the pieces and of
// the blocks.
//
// One CTA a row, 1,024 threads:
//   1. a warp a piece, 8 chunks of 16 bytes a lane in flight (float4 loads
//      where the piece starts on a 16-byte boundary, else 4 scalar loads
//      of the same samples);
//   2. a thread a block: its sum, mean square over its clamped width,
//      loudness and absolute gate;
//   3. warp 0: the lane folds of the pieces and of the gated blocks, the
//      relative gate and the LUFS.
// Bound: bytes, each row's S f32 samples read once (B x S x 4 bytes); the
// tables and the workspace (pieces and blocks, a few KB a row) stay in L2.
// A CTA reads its row at what one SM's load slots sustain, so a round of B
// rows runs on B SMs.
//
// No multiply-add is contracted: the arithmetic is __fmul_rn, __fadd_rn and
// __fdiv_rn (and the library builds with -fmad=false). log10f is the one
// math function; torch's log10 on a card calls the same.
//
// apd_loudness_gate(...) returns the CUDA error code of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // chunks a lane loads before it adds
constexpr unsigned kFull = 0xffffffffu;
constexpr float kOffset = -0.691f;  // LUFS_OFFSET
constexpr float kAbsGate = -70.0f;  // ABSOLUTE_GATE_LUFS
constexpr float kFloor = 1e-38f;    // the clamp before a block's log10

__device__ __forceinline__ float lufs(float ms) {
  return __fadd_rn(kOffset, __fmul_rn(10.0f, log10f(ms)));
}

// torch.clamp_min: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v < lo ? lo : v; }

// Lane 0's result of halving the 32 lanes pairwise, broadcast to the warp.
__device__ __forceinline__ float halve(float r) {
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) r = __fadd_rn(r, __shfl_down_sync(kFull, r, h));
  return __shfl_sync(kFull, r, 0);
}

__device__ __forceinline__ float quad(const float s[4]) {
  return __fadd_rn(__fadd_rn(s[0], s[1]), __fadd_rn(s[2], s[3]));
}

// The lane fold of value(j), j in [0, n) (zero past n), on a whole warp.
template <typename Value>
__device__ __forceinline__ float lane_fold(long long n, int lane, Value value) {
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long base = 4LL * lane; base < n; base += 128) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[c] = __fadd_rn(s[c], base + c < n ? value(base + c) : 0.0f);
  }
  return halve(quad(s));
}

struct Args {
  const float* filtered;  // (B, S), rows row_stride floats apart
  long long S, row_stride;
  const int* n_valid;             // (B,)
  const long long* piece_bounds;  // (P + 1,)
  int P, K;                       // pieces, 128-sample chunks of the widest
  const long long* block_lo;      // (nblk,) each
  const long long* block_end;
  const long long* block_thr;
  const long long* block_first;
  const long long* block_pieces;
  int nblk;
  long long short_threshold;
  float* workspace;  // (B, P + 2 nblk): piece sums, gated blocks' ms, their loudness
  float* out;        // (B,)
};

__global__ void __launch_bounds__(kThreads) loudness_gate_kernel(const __grid_constant__ Args a) {
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = a.filtered + row * a.row_stride;
  const long long nv = a.n_valid[row];
  const long long lim = nv < a.S ? nv : a.S;
  float* pieces = a.workspace + row * (a.P + 2LL * a.nblk);
  float* block_ms = pieces + a.P;
  float* block_loud = block_ms + a.nblk;
  const bool row_aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;

  // 1. Piece sums, a warp a piece.
  for (int p = warp; p < a.P; p += kWarps) {
    const long long lo = a.piece_bounds[p];
    long long end = a.piece_bounds[p + 1];
    end = end < lim ? end : lim;
    const bool vec = row_aligned && (lo & 3) == 0;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int t0 = 0; t0 < a.K; t0 += kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = lo + 128LL * (t0 + u) + 4 * lane;
        if (t0 + u >= a.K || i >= end) {
          v[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        } else if (vec && i + 3 < end) {
          v[u] = *reinterpret_cast<const float4*>(x + i);
        } else {
          v[u] = make_float4(i < end ? x[i] : 0.0f, i + 1 < end ? x[i + 1] : 0.0f,
                             i + 2 < end ? x[i + 2] : 0.0f, i + 3 < end ? x[i + 3] : 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[0] = __fadd_rn(s[0], __fmul_rn(v[u].x, v[u].x));
        s[1] = __fadd_rn(s[1], __fmul_rn(v[u].y, v[u].y));
        s[2] = __fadd_rn(s[2], __fmul_rn(v[u].z, v[u].z));
        s[3] = __fadd_rn(s[3], __fmul_rn(v[u].w, v[u].w));
      }
    }
    const float sum = halve(quad(s));
    if (lane == 0) pieces[p] = sum;
  }
  __syncthreads();

  // 2. Blocks, a thread a block: the absolute gate's survivors keep their
  // mean square and loudness, the others 0 and -inf.
  for (int j = tid; j < a.nblk; j += kThreads) {
    const long long first = a.block_first[j];
    float sum = pieces[first];
    for (long long t = 1; t < a.block_pieces[j]; ++t) sum = __fadd_rn(sum, pieces[first + t]);
    const long long lo = a.block_lo[j];
    long long hi = a.block_end[j];
    hi = hi < nv ? hi : nv;
    const bool valid = a.block_thr[j] <= nv && lo < hi && sum > 0.0f;
    const float width = static_cast<float>(hi - lo);
    const float ms = __fdiv_rn(sum, width < 1.0f ? 1.0f : width);
    const float loud = lufs(clamp_min(ms, kFloor));
    const bool gated = valid && loud >= kAbsGate;
    block_ms[j] = gated ? ms : 0.0f;
    block_loud[j] = gated ? loud : -INFINITY;
  }
  __syncthreads();

  // 3. The whole row and the two gates, on warp 0.
  if (warp != 0) return;
  const float total = lane_fold(a.P, lane, [&](long long j) { return pieces[j]; });
  const float abs_sum = lane_fold(a.nblk, lane, [&](long long j) { return block_ms[j]; });
  int abs_count = 0;
  for (int j = lane; j < a.nblk; j += 32) abs_count += block_loud[j] >= kAbsGate;
  abs_count = __reduce_add_sync(kFull, abs_count);
  const float z_avg = __fdiv_rn(abs_sum, static_cast<float>(abs_count > 1 ? abs_count : 1));
  const float gamma_r = __fsub_rn(lufs(clamp_min(z_avg, kFloor)), 10.0f);
  auto relative = [&](long long j) {
    return block_loud[j] >= kAbsGate && block_loud[j] > gamma_r;
  };
  const float rel_sum =
      lane_fold(a.nblk, lane, [&](long long j) { return relative(j) ? block_ms[j] : 0.0f; });
  int rel_count = 0;
  for (int j = lane; j < a.nblk; j += 32) rel_count += relative(j);
  rel_count = __reduce_add_sync(kFull, rel_count);
  if (lane != 0) return;

  const float ms_short = __fdiv_rn(total, static_cast<float>(nv > 1 ? nv : 1));
  const float lufs_short = ms_short > 0.0f ? lufs(ms_short) : -INFINITY;
  const float short_form = lufs_short >= kAbsGate ? lufs_short : -INFINITY;
  const float z_final = __fdiv_rn(rel_sum, static_cast<float>(rel_count > 1 ? rel_count : 1));
  const float gated_lufs = lufs(clamp_min(z_final, kFloor));
  const float gated = abs_count > 0 && rel_count > 0 ? gated_lufs : -INFINITY;
  a.out[row] = nv < a.short_threshold ? short_form : gated;
}

}  // namespace

// C interface for ctypes. filtered: B rows of S f32 samples, row_stride
// floats apart, each row contiguous; n_valid (B,) int32; piece_bounds
// (P + 1,), block_lo / block_end / block_thr / block_first / block_pieces
// (nblk,) int64 (ops/loudness.py LoudnessConsts); K the 128-sample chunks
// of the widest piece; workspace B x (P + 2 nblk) f32; out (B,) f32. All on
// the current device. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int apd_loudness_gate(const float* filtered, long long B, long long S,
                                 long long row_stride, const int* n_valid,
                                 const long long* piece_bounds, int P, int K,
                                 const long long* block_lo, const long long* block_end,
                                 const long long* block_thr, const long long* block_first,
                                 const long long* block_pieces, int nblk,
                                 long long short_threshold, float* workspace, float* out,
                                 void* stream) {
  if (B <= 0) return 0;
  if (B >= (1LL << 31) || S < 1 || row_stride < 0 || P < 1 || K < 1 || nblk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.filtered = filtered;
  a.S = S;
  a.row_stride = row_stride;
  a.n_valid = n_valid;
  a.piece_bounds = piece_bounds;
  a.P = P;
  a.K = K;
  a.block_lo = block_lo;
  a.block_end = block_end;
  a.block_thr = block_thr;
  a.block_first = block_first;
  a.block_pieces = block_pieces;
  a.nblk = nblk;
  a.short_threshold = short_threshold;
  a.workspace = workspace;
  a.out = out;
  loudness_gate_kernel<<<static_cast<unsigned>(B), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
