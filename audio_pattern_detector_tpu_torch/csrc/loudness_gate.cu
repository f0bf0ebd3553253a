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
// Which CTA computes which tree. A row's P pieces are spread over
// ceil(P / 8) CTAs of 256 threads (about 77 at 8 kHz and 61 s), a warp a
// piece, 8 chunks of 16 bytes a lane in flight (float4 loads where the
// piece starts on a 16-byte boundary, else 4 scalar loads of the same
// samples); the grid is those CTAs for each of the B rows, so how a row is
// split depends on P alone, never on B. Each CTA writes its piece sums to
// the workspace, fences, and takes a ticket of its row (an atomic add).
// The ticket only picks which CTA finishes the row: the last to arrive,
// which then reads every piece sum through L2 and computes the rest of the
// row's trees alone:
//   1. a row under the short form's threshold: warp 0 folds the pieces;
//   2. else a thread a block: its sum, mean square over its clamped width,
//      loudness and absolute gate; then warp 0: the lane folds of the gated
//      blocks, the relative gate and the LUFS.
// No sum goes through an atomic or depends on the order in which CTAs
// finish. apd_loudness_gate zeroes the tickets on the stream before the
// launch (a memset, no kernel), so every call and every replay starts
// clean; nothing resets them after.
// Bound: bytes, each row's valid samples read once (B x S x 4 bytes at
// most); the piece sums, a few KB a row, stay in L2. One row fills 77 SMs
// instead of one, so the row's time is the launch, one round trip of its
// loads and the finisher's short chain.
//
// No multiply-add is contracted: the arithmetic is __fmul_rn, __fadd_rn and
// __fdiv_rn (and the library builds with -fmad=false). log10f is the one
// math function; torch's log10 on a card calls the same.
//
// apd_loudness_gate(...) returns the CUDA error code of the memset or the
// launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPiecesPerCta = kWarps;  // a warp a piece (ops/loudness.py GATE_PIECES_PER_CTA)
constexpr int kUnroll = 8;             // chunks a lane loads before it adds
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
  int ctas_per_row;               // ceil(P / kPiecesPerCta)
  const long long* block_lo;      // (nblk,) each
  const long long* block_end;
  const long long* block_thr;
  const long long* block_first;
  const long long* block_pieces;
  int nblk;
  long long short_threshold;
  float* workspace;   // (B, P + 2 nblk): piece sums, gated blocks' ms, their loudness
  unsigned* tickets;  // (B,) zero before the launch
  float* out;         // (B,)
};

// The sum of one piece's squares, on a whole warp (lane 0's is the sum).
__device__ __forceinline__ float piece_sum(const Args& a, const float* x, bool row_aligned,
                                           long long lim, int p, int lane) {
  const long long lo = __ldg(a.piece_bounds + p);
  long long end = __ldg(a.piece_bounds + p + 1);
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
  return halve(quad(s));
}

__global__ void __launch_bounds__(kThreads, 4) loudness_gate_kernel(const __grid_constant__ Args a) {
  __shared__ bool finisher;
  const long long row = blockIdx.x / a.ctas_per_row;
  const int cta = static_cast<int>(blockIdx.x - row * a.ctas_per_row);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* x = a.filtered + row * a.row_stride;
  const long long nv = a.n_valid[row];
  const long long lim = nv < a.S ? nv : a.S;
  float* pieces = a.workspace + row * (a.P + 2LL * a.nblk);

  // This CTA's pieces, a warp a piece; each written sum fenced before the
  // ticket is taken.
  const int p = cta * kPiecesPerCta + warp;
  if (p < a.P) {
    const bool row_aligned = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const float sum = piece_sum(a, x, row_aligned, lim, p, lane);
    if (lane == 0) {
      pieces[p] = sum;
      __threadfence();
    }
  }
  __syncthreads();
  if (tid == 0) {
    finisher = atomicAdd(&a.tickets[row], 1u) == static_cast<unsigned>(a.ctas_per_row - 1);
  }
  __syncthreads();
  if (!finisher) return;
  __threadfence();

  // The row's last CTA: every piece sum is written. Read them through L2.
  float* block_ms = pieces + a.P;
  float* block_loud = block_ms + a.nblk;
  auto piece_at = [&](long long j) { return __ldcg(pieces + j); };

  if (nv < a.short_threshold) {  // the short form: one block over the whole row
    if (warp != 0) return;
    const float total = lane_fold(a.P, lane, piece_at);
    if (lane != 0) return;
    const float ms_short = __fdiv_rn(total, static_cast<float>(nv > 1 ? nv : 1));
    const float lufs_short = ms_short > 0.0f ? lufs(ms_short) : -INFINITY;
    a.out[row] = lufs_short >= kAbsGate ? lufs_short : -INFINITY;
    return;
  }

  // Blocks, a thread a block: the absolute gate's survivors keep their
  // mean square and loudness, the others 0 and -inf. The tables are read
  // only (__ldg), so a thread's blocks' loads can be issued together.
#pragma unroll 4
  for (int j = tid; j < a.nblk; j += kThreads) {
    const long long first = __ldg(a.block_first + j);
    const long long count = __ldg(a.block_pieces + j);
    const long long lo = __ldg(a.block_lo + j);
    long long hi = __ldg(a.block_end + j);
    const long long thr = __ldg(a.block_thr + j);
    float sum = piece_at(first);
    for (long long t = 1; t < count; ++t) sum = __fadd_rn(sum, piece_at(first + t));
    hi = hi < nv ? hi : nv;
    const bool valid = thr <= nv && lo < hi && sum > 0.0f;
    const float width = static_cast<float>(hi - lo);
    const float ms = __fdiv_rn(sum, width < 1.0f ? 1.0f : width);
    const float loud = lufs(clamp_min(ms, kFloor));
    const bool gated = valid && loud >= kAbsGate;
    block_ms[j] = gated ? ms : 0.0f;
    block_loud[j] = gated ? loud : -INFINITY;
  }
  __syncthreads();

  // The two gates, on warp 0.
  if (warp != 0) return;
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

  const float z_final = __fdiv_rn(rel_sum, static_cast<float>(rel_count > 1 ? rel_count : 1));
  const float gated_lufs = lufs(clamp_min(z_final, kFloor));
  a.out[row] = abs_count > 0 && rel_count > 0 ? gated_lufs : -INFINITY;
}

}  // namespace

// C interface for ctypes. filtered: B rows of S f32 samples, row_stride
// floats apart, each row contiguous; n_valid (B,) int32; piece_bounds
// (P + 1,), block_lo / block_end / block_thr / block_first / block_pieces
// (nblk,) int64 (ops/loudness.py LoudnessConsts); K the 128-sample chunks
// of the widest piece; ctas_per_row ceil(P / 8) (ops/loudness.py
// gate_ctas_per_row; any other value is refused); workspace B x (P + 2 nblk)
// f32; tickets (B,) 32-bit, zeroed here on the stream; out (B,) f32. All on
// the current device. Returns the CUDA error code of the memset or the
// launch (0 on success).
extern "C" int apd_loudness_gate(const float* filtered, long long B, long long S,
                                 long long row_stride, const int* n_valid,
                                 const long long* piece_bounds, int P, int K, int ctas_per_row,
                                 const long long* block_lo, const long long* block_end,
                                 const long long* block_thr, const long long* block_first,
                                 const long long* block_pieces, int nblk,
                                 long long short_threshold, float* workspace, unsigned* tickets,
                                 float* out, void* stream) {
  if (B <= 0) return 0;
  if (S < 1 || row_stride < 0 || P < 1 || K < 1 || nblk < 1 ||
      ctas_per_row != (P + kPiecesPerCta - 1) / kPiecesPerCta ||
      B * ctas_per_row >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t zeroed = cudaMemsetAsync(tickets, 0, B * sizeof(unsigned), s);
  if (zeroed != cudaSuccess) return static_cast<int>(zeroed);
  Args a;
  a.filtered = filtered;
  a.S = S;
  a.row_stride = row_stride;
  a.n_valid = n_valid;
  a.piece_bounds = piece_bounds;
  a.P = P;
  a.K = K;
  a.ctas_per_row = ctas_per_row;
  a.block_lo = block_lo;
  a.block_end = block_end;
  a.block_thr = block_thr;
  a.block_first = block_first;
  a.block_pieces = block_pieces;
  a.nblk = nblk;
  a.short_threshold = short_threshold;
  a.workspace = workspace;
  a.tickets = tickets;
  a.out = out;
  loudness_gate_kernel<<<static_cast<unsigned>(B * ctas_per_row), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}
