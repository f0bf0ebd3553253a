// The overlap-save correlation's second half, for sm_90a: the bank product,
// the inverse transform and the kept samples' magnitude, one kernel.
//
// Replaces the XLA program of the JAX package's overlap-save branch of
// audio_pattern_detector_tpu/ops/correlate.py::_correlate_raw (:159, the
// branch at :176-190), reached from bank_correlate (:212) and
// bank_correlate_abs (:231). It was never a Pallas kernel: XLA computes the
// product seg_spec[None] * bank[:, None], jnp.fft.irfft, the slice and abs,
// where the port wrote the (B, G, ns, N/2 + 1) product and the (B, G, ns, N)
// inverse transform to device memory and read both back.
//
// For a section batch (B, ns segment spectra of N / 2 + 1 bins each), a
// group's G conjugate clip spectra and the class geometry (N = fft_len,
// step, off = out_offset, L = full_len):
//   out[b, g, k] = |y_{b,g,s}[t]|  for k + off = s step + t, 0 <= t < step,
//   y_{b,g,s} = irfft_N(seg[b, s] * bank[g])  ("backward" scaling, 1 / N).
//
// Arithmetic. A transform (b, g, s) is computed alone, the same way at any
// index, so a row's bits do not depend on the round's width, its index or
// G. With H = N / 2, w = exp(-2 pi i / N), P = seg * bank, u = conj P[k] and
// v = P[H - k], the Hermitian half spectrum folds into the H-point complex
// spectrum A[k] = E - i w^k D, E = u + v, D = u - v (the C2R form of the
// separation pass of csrc/verify_marker.cu), whose forward transform is
// N conj(z), z[j] = y[2j] + i y[2j + 1]. That transform is Stockham passes
// (radix 4 while four more points fit, then one radix 2 where H is not a
// power of 4; pass with radix R after p points: butterfly i reads x_r =
// buf[i + r H/R], k = i mod p, x_r *= W[r k H / (p R)], W = exp(-2 pi i /
// H), the exact R-point DFT of csrc/fft_common.cuh, writes buf[(i - k) R + k
// + s p]). Built with -fmad=false: every product and sum is rounded once;
// A = (E.x + t.y, E.y - t.x) with t = cmul(w^k, D); the output is fabsf(y)
// * (1 / N), exact scaling. chip_smoke.np_correlate_os transliterates it.
// The values are not cuFFT's bits: the plain version (ops/correlate_os.py)
// keeps cuFFT.
//
// Design: C CTAs a transform (ops/correlate_os.py::cluster_size), each
// holding H / C of its complex values in shared memory (at most 16,384,
// 128 KB), 16 a thread across a pass, 1,024 threads a CTA at most. Up to
// N = 32,768 one CTA holds the whole transform (C = 1, a plain launch of
// the kernel instance without cluster code; its fold keeps two bins a
// thread in flight); past it a thread-block cluster of C = H / 16,384 CTAs
// of 128 KB (2 at 65,536 points, 4 at 131,072, 8 at 262,144) shares one
// over distributed shared memory. Which CTA holds a value follows the pass:
//   * the fold: CTA r takes the pairs (k, H - k) of a contiguous range of
//     k, so the spectra's loads are coalesced and each bin is read once, and
//     stores A[k] into the shared memory of CTA k mod C (the first pass's
//     layout below); a warp's stores go to one CTA at consecutive places;
//   * the passes before the exchange: CTA r holds the values whose
//     butterfly index j = i / p is r modulo C, so all of a butterfly's
//     inputs and outputs are its own. Each CTA then runs exactly the
//     one-CTA passes on its H / C values (its own j = i / p / C), with
//     __syncthreads between them, the twiddles those of the same k;
//   * the exchange: the last pass whose butterfly index still has log2 C
//     bits reads its own values and writes each output into the CTA that
//     holds it afterwards, between two cluster barriers: after it CTA r
//     holds the values whose index has bits [a, a + log2 C) equal to r, a
//     the log2 of the next pass's p less log2 C, bits of k that stay put in
//     every later pass;
//   * the passes after it: again all local, the one-CTA passes on H / C
//     values with p / C for p and the twiddles of the k that the rank's bits
//     complete;
//   * the write: CTA r holds runs of 2^(a + 1) consecutive output floats,
//     laid end to end in its buffer, and writes |y[t]| / N for the kept t
//     (output index s step + t - off in [0, L)) of its runs, consecutive
//     threads at consecutive t.
// A cluster's CTAs share one transform, so the early return of a transform
// with nothing kept is uniform over the cluster; no CTA reads or writes a
// partner's shared memory after the exchange's second barrier, so none
// waits for the others before it exits. Two radix-4 passes in a row run in
// registers between one pair of barriers (pass_pair4: their butterflies
// fall into groups of 16 values that only feed each other), and each pass
// reads its twiddles from a table of its own, contiguous in k (the same
// f32 values as W's). The buffer's values sit at swizzled places (sw), which
// moves no bit of the arithmetic: every cluster size gives the one-CTA
// form's bits.
//
// Bound: the output, B G L floats written once (1.02 GB for a 16-row
// flagship round's group, 0.31 ms at 3.35 TB/s), beside the spectra read
// once; the transforms' 2.5 N log2 N operations over the f32 rate are below
// it. A cluster moves each transform's values through distributed shared
// memory twice (the fold's stores and the exchange, (C - 1) / C of them
// each), traffic that costs about what device memory would at these
// sizes: on the main path's rounds and steps at N = 32,768 clusters of 2
// and 4 CTAs measured slower than one CTA a transform, so that length keeps
// it (PERF.md section 6); past it the fewest CTAs that hold a transform
// cross the least, and on launches of hundreds of transforms (a bank of
// long clips, a round of rows) read faster than more CTAs of 64 KB.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fft_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace apd_fft;

constexpr int kPerThread = 16;                      // complex values a thread holds in a pass
constexpr int kMaxLocal = 16384;                    // complex values a CTA holds (128 KB)
constexpr int kMaxCluster = 8;                      // the portable cluster size
constexpr int kMaxHalf = kMaxLocal * kMaxCluster;   // N / 2 at N = 262,144
constexpr int kMaxPasses = 9;                       // 8 fours and a 2 at N / 2 = 131,072

struct Args {
  const float2* seg;        // (B, ns, H + 1)
  const float2* bank;       // (G, H + 1)
  const float2* post;       // (H + 1,) exp(-2 pi i k / N)
  const float2* pass_tw[kMaxPasses];  // pass q's (p, R - 1) twiddles W[r k stride]
  float* out;               // (B, G, L)
  long long L;
  int G, ns, half, step, off;
  float inv_n;
  int cluster, log_cluster;  // C and log2 C
  int exchange;              // the stage (a pass pair counts one) whose writes cross CTAs
  int run_shift;             // a: after the exchange CTA r holds the indices whose
                             // bits [a, a + log2 C) are r
};

// Where local value idx of a CTA's buffer lives: its low 4 bits XORed with
// the next 4, so that 32 threads writing values 16 apart (the first pass
// pair) hit 16 bank pairs, not one; a bijection of [0, H / C), and
// contiguous runs stay conflict-free.
__device__ __forceinline__ int sw(int idx) { return idx ^ ((idx >> 4) & 15); }

// A stage's place in the cluster's passes: before the exchange (or one CTA
// a transform) the CTA's own values with the pass's own p and k; the
// exchange, whose writes go to the CTA that holds each value next; after
// it, the CTA's own values again with p / C and the rank's bits in k.
enum Kind { kOwn, kExchange, kAfter };

// How one stage of the CTA's passes indexes: its own buffer of hl values
// with pl for the pass's p; after the exchange the twiddles' k has the
// rank's log2 C bits put in at bit a of the local k; at the exchange, where
// each output goes (the cluster's constants from the launch's parameters,
// the rank from its special register).
struct Stage {
  const Args& a;
  int hl;  // complex values in the CTA's buffer
  int pl;  // the pass's p in the CTA's own indexing
  int p;   // the pass's p
  template <int K>
  __device__ __forceinline__ int k_of(int kl) const {
    if constexpr (K != kAfter) {
      return kl;
    } else {
      const int r = static_cast<int>(cg::this_cluster().block_rank());
      const int low = kl & ((1 << a.run_shift) - 1);
      return low | (r << a.run_shift) | ((kl >> a.run_shift) << (a.run_shift + a.log_cluster));
    }
  }
};

// buf[idx] = v in the shared memory of CTA `to` of the cluster (distributed
// shared memory, 32-bit addresses), or in the CTA's own where `to` is its
// rank r.
__device__ __forceinline__ void store_to(float2* buf, int idx, int to, int r, float2 v) {
  if (to == r) {
    buf[idx] = v;
    return;
  }
  const unsigned own = static_cast<unsigned>(__cvta_generic_to_shared(buf + idx));
  unsigned remote;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(own), "r"(to));
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(remote), "f"(v.x), "f"(v.y)
               : "memory");
}

// Store output v of a butterfly whose local index is dst (j its local
// butterfly block, width = R p the block's span): in the CTA's own buffer,
// or at the exchange in the CTA that holds global index g afterwards.
template <int K>
__device__ __forceinline__ void put(float2* buf, const Stage& st, int dst, int j, int width,
                                    float2 v) {
  if constexpr (K != kExchange) {
    buf[sw(dst)] = v;
  } else {
    const Args& a = st.a;
    const int r = static_cast<int>(cg::this_cluster().block_rank());
    const int g = dst + (j * (a.cluster - 1) + r) * width;
    const int loc =
        (g & ((1 << a.run_shift) - 1)) | ((g >> (a.run_shift + a.log_cluster)) << a.run_shift);
    store_to(buf, sw(loc), (g >> a.run_shift) & (a.cluster - 1), r, v);
  }
}

template <int K>
__device__ __forceinline__ void stage_sync() {
  if constexpr (K == kExchange)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// One in-place Stockham pass of radix R (2 or 4) over the CTA's buffer:
// every thread loads its butterflies' inputs, the block (at the exchange
// the cluster) meets at a barrier, then each thread writes its outputs.
template <int R, int K>
__device__ __forceinline__ void pass(float2* buf, const Stage& st, const float2* __restrict__ tw) {
  constexpr int kB = kPerThread / R;  // butterflies a thread holds
  const int T = st.hl / R;
  const int threads = blockDim.x;
  float2 x[kB][R];
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int i = threadIdx.x + j * threads;
    if (i < T) {
#pragma unroll
      for (int r = 0; r < R; ++r) x[j][r] = buf[sw(i + r * T)];
    }
  }
  stage_sync<K>();
#pragma unroll
  for (int j = 0; j < kB; ++j) {
    const int i = threadIdx.x + j * threads;
    if (i < T) {
      const int kl = i & (st.pl - 1);
      const int k = st.k_of<K>(kl);
#pragma unroll
      for (int r = 1; r < R; ++r) x[j][r] = cmul(x[j][r], tw[k * (R - 1) + r - 1]);
      const int dst = (i - kl) * R + kl;
      const int blk = i / st.pl;
      dft_emit<R>(x[j], nullptr, 0, [&](int s, float2 v) {
        put<K>(buf, st, dst + s * st.pl, blk, R * st.p, v);
      });
    }
  }
  stage_sync<K>();
}

// Two radix-4 passes, after p and after 4p points, in registers: the same
// operations as two pass<4> calls. Thread g takes group (j, k0) = (g / p,
// g mod p) (local p and indices): the first pass's butterflies (j + r'
// H / (16 p)) p + k0, r' < 4 (one twiddle set), whose outputs s are the
// inputs r' of the second pass's butterfly j 4p + s p + k0, which writes
// buf[(4 j + s') 4p + s p + k0]. Sixteen values a thread, one barrier pair
// for two passes.
template <int K>
__device__ __forceinline__ void pass_pair4(float2* buf, const Stage& st,
                                           const float2* __restrict__ tw1,
                                           const float2* __restrict__ tw2) {
  const int pl = st.pl;
  const int T = st.hl / 4;
  const int J = st.hl / (16 * pl);
  const int g = threadIdx.x;
  const bool active = g < st.hl / 16;
  const int j = g / pl;
  const int k0l = g & (pl - 1);
  float2 x[4][4];
  if (active) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int i = (j + rr * J) * pl + k0l;
#pragma unroll
      for (int r = 0; r < 4; ++r) x[rr][r] = buf[sw(i + r * T)];
    }
  }
  stage_sync<K>();
  if (active) {
    const int k0 = st.k_of<K>(k0l);
    float2 w[4];
#pragma unroll
    for (int r = 1; r < 4; ++r) w[r] = tw1[k0 * 3 + r - 1];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
      for (int r = 1; r < 4; ++r) x[rr][r] = cmul(x[rr][r], w[r]);
      float2 y[4];
      dft<4>(x[rr], y, nullptr, 0);
#pragma unroll
      for (int s = 0; s < 4; ++s) x[rr][s] = y[s];
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int k = s * st.p + k0;
      float2 z[4];
      z[0] = x[0][s];
#pragma unroll
      for (int rr = 1; rr < 4; ++rr) z[rr] = cmul(x[rr][s], tw2[k * 3 + rr - 1]);
      const int dst = j * 16 * pl + s * pl + k0l;
      dft_emit<4>(z, nullptr, 0, [&](int s2, float2 v) {
        put<K>(buf, st, dst + s2 * 4 * pl, j, 16 * st.p, v);
      });
    }
  }
  stage_sync<K>();
}

// Stage `stage` of the passes (a pass pair counts one), after p points:
// run(kind) with st set for it, kind the stage's place as an
// std::integral_constant<int, Kind>: the CTA's own before the exchange and
// in the one-CTA form, the exchange, the CTA's own with p / C after it.
template <bool kCluster, class F>
__device__ __forceinline__ void run_stage(const Args& a, Stage& st, int stage, int p, F run) {
  st.p = st.pl = p;
  if (!kCluster || stage < a.exchange) {
    run(std::integral_constant<int, kOwn>{});
  } else if constexpr (kCluster) {
    if (stage == a.exchange) {
      run(std::integral_constant<int, kExchange>{});
    } else {
      st.pl = p >> a.log_cluster;
      run(std::integral_constant<int, kAfter>{});
    }
  }
}

// A[k] from u = conj P[k] and v = P[H - k].
__device__ __forceinline__ float2 fold(float2 pk, float2 pm, float2 w) {
  const float2 u = conjugate(pk);
  const float2 e = cadd(u, pm);
  const float2 t = cmul(w, csub(u, pm));
  return make_float2(__fadd_rn(e.x, t.y), __fsub_rn(e.y, t.x));
}

// The one-CTA fold: A[k] and A[H - k] for k < H / 2, two bins a thread in
// flight, their spectra and twiddles all loaded before either is used (2 %
// less time on the 16-row round than the loop unrolled by 4, PERF.md
// section 6).
__device__ __forceinline__ void fold_one_cta(float2* buf, const float2* __restrict__ seg,
                                             const float2* __restrict__ bank,
                                             const float2* __restrict__ post, int H, int half) {
  constexpr int Bt = 2;
  for (int k0 = threadIdx.x; k0 < half; k0 += Bt * blockDim.x) {
    float2 sk[Bt], bk[Bt], sm[Bt], bm[Bt], wk[Bt], wm[Bt];
#pragma unroll
    for (int i = 0; i < Bt; ++i) {
      const int k = k0 + i * blockDim.x;
      if (k < half) {
        sk[i] = seg[k];
        bk[i] = bank[k];
        sm[i] = seg[H - k];
        bm[i] = bank[H - k];
        wk[i] = post[k];
        wm[i] = post[H - k];
      }
    }
#pragma unroll
    for (int i = 0; i < Bt; ++i) {
      const int k = k0 + i * blockDim.x;
      if (k < half) {
        const float2 pk = cmul(sk[i], bk[i]);
        const float2 pm = cmul(sm[i], bm[i]);
        buf[sw(k)] = fold(pk, pm, wk[i]);
        if (k > 0) buf[sw(H - k)] = fold(pm, pk, wm[i]);
      }
    }
  }
}

// The first of CTA r's local output floats whose float index in the
// transform is t or later: CTA r holds the runs of 2^ls floats whose run
// index is r modulo 2^c, the run lengths laid end to end.
__device__ __forceinline__ int first_local(int t, int r, int ls, int c) {
  const int q = t >> ls, qq = q >> c, qr = q & ((1 << c) - 1);
  if (qr == r) return (qq << ls) + (t & ((1 << ls) - 1));
  return (qr < r ? qq : qq + 1) << ls;
}

// kCluster false: one CTA a transform (C = 1), with no cluster code. Both
// instances take launch bounds of 1,024 threads, 64 registers a thread.
template <bool kCluster>
__global__ void __launch_bounds__(1024, 1) correlate_os_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float2 buf[];
  const int H = a.half;
  const int C = kCluster ? a.cluster : 1;
  const int hl = H >> a.log_cluster;
  const long long cl = blockIdx.x >> a.log_cluster;  // the transform
  int rank = 0;
  if constexpr (kCluster) rank = static_cast<int>(cg::this_cluster().block_rank());
  const int s = static_cast<int>(cl % a.ns);
  const long long bg = cl / a.ns;  // b G + g
  const int g = static_cast<int>(bg % a.G);
  const long long b = bg / a.G;
  // The kept samples t in [t_lo, t_hi): output index s step + t - off in [0, L).
  const long long lo = static_cast<long long>(s) * a.step - a.off;
  const long long t_lo = lo < 0 ? -lo : 0;
  const long long t_hi = a.L - lo < a.step ? a.L - lo : a.step;
  if (t_hi <= t_lo) return;  // the whole cluster: no sample of this transform is kept

  const float2* __restrict__ seg = a.seg + (b * a.ns + s) * (H + 1);
  const float2* __restrict__ bank = a.bank + static_cast<long long>(g) * (H + 1);
  const int half = H / 2;
  if constexpr (!kCluster) {
    fold_one_cta(buf, seg, bank, a.post, H, half);
    if (threadIdx.x == 0) {  // k = H / 2, its own partner
      const float2 pk = cmul(seg[half], bank[half]);
      buf[sw(half)] = fold(pk, pk, a.post[half]);
    }
    __syncthreads();
  } else {
    // CTA r folds the pairs (k, H - k) of k in [r per, (r + 1) per) and
    // stores A[k] in CTA k mod C at k / C. In each span of 32 C pairs round
    // i = (e mod span) / 32 and lane l = e mod 32 take k = start + l C + i,
    // so a warp's stores go to one CTA at consecutive places.
    cg::cluster_group cluster = cg::this_cluster();
    const int per = half >> a.log_cluster;
    const int span = 32 << a.log_cluster;
    const bool spans = (per & (span - 1)) == 0;
    cluster.sync();  // every CTA of the cluster has started
#pragma unroll 4
    for (int e = threadIdx.x; e < per; e += blockDim.x) {
      const int w = e & (span - 1);
      const int k = rank * per + (spans ? (e - w) + ((w & 31) << a.log_cluster) + (w >> 5) : e);
      const int m = H - k;
      const float2 pk = cmul(seg[k], bank[k]);
      const float2 pm = cmul(seg[m], bank[m]);
      store_to(buf, sw(k >> a.log_cluster), k & (C - 1), rank, fold(pk, pm, a.post[k]));
      if (k > 0)
        store_to(buf, sw(m >> a.log_cluster), m & (C - 1), rank, fold(pm, pk, a.post[m]));
    }
    if (rank == C - 1 && threadIdx.x == 0) {
      const float2 pk = cmul(seg[half], bank[half]);
      store_to(buf, sw(half >> a.log_cluster), half & (C - 1), rank, fold(pk, pk, a.post[half]));
    }
    cluster.sync();
  }

  // The radix-4 passes two at a time, then the one 4 or 2 left over; each
  // stage local before the exchange, the exchange, local after it.
  Stage st{a, hl, 1, 1};
  int p = 1, q = 0, stage = 0;
  for (; 16 * p <= H; p *= 16, q += 2, ++stage) {
    run_stage<kCluster>(a, st, stage, p, [&](auto k) {
      pass_pair4<decltype(k)::value>(buf, st, a.pass_tw[q], a.pass_tw[q + 1]);
    });
  }
  if (4 * p <= H) {
    run_stage<kCluster>(a, st, stage, p,
                        [&](auto k) { pass<4, decltype(k)::value>(buf, st, a.pass_tw[q]); });
    ++q;
    p *= 4;
    ++stage;
  }
  if (2 * p <= H) {
    run_stage<kCluster>(a, st, stage, p,
                        [&](auto k) { pass<2, decltype(k)::value>(buf, st, a.pass_tw[q]); });
  }

  // CTA r's output floats: its local float index lf, from the first with
  // float index t >= t_lo to the first with t >= t_hi, is t's runs of
  // 2^(a + 1) floats (bits [a + 1, a + 1 + log2 C) of t are r) laid end to
  // end; one run, the whole transform, where C = 1. Consecutive lf are
  // consecutive t within a run, so both the reads and the stores are
  // contiguous. t < step <= N fits an int.
  const float* y = reinterpret_cast<const float*>(buf);
  float* out = a.out + bg * a.L + lo;
  if constexpr (!kCluster) {
    for (int t = static_cast<int>(t_lo) + threadIdx.x; t < t_hi; t += blockDim.x)
      out[t] = __fmul_rn(fabsf(y[2 * sw(t >> 1) + (t & 1)]), a.inv_n);
    return;
  }
  const int ls = a.run_shift + 1, c = a.log_cluster;
  const int lf_hi = first_local(static_cast<int>(t_hi), rank, ls, c);
  for (int lf = first_local(static_cast<int>(t_lo), rank, ls, c) + threadIdx.x; lf < lf_hi;
       lf += blockDim.x) {
    const int t = (lf & ((1 << ls) - 1)) + ((((lf >> ls) << c) + rank) << ls);
    out[t] = __fmul_rn(fabsf(y[2 * sw(lf >> 1) + (lf & 1)]), a.inv_n);
  }
}

// The stage whose writes cross CTAs (a pass pair counts one) and the bit a
// that the rank occupies after it, for N / 2 = 2^h over 2^c CTAs: the last
// stage whose butterfly index j = i / p keeps c bits (h - d - lp of them, d
// the stage's log2 radix), with the next stage's lp at least c; a is that
// lp less c. Returns false where no stage qualifies.
bool cluster_plan(int h, int c, int* exchange, int* run_shift) {
  int lp_of[kMaxPasses + 1], d_of[kMaxPasses];
  int n = 0, lp = 0;
  for (; lp + 4 <= h; lp += 4) lp_of[n] = lp, d_of[n++] = 4;
  if (lp + 2 <= h) lp_of[n] = lp, d_of[n++] = 2, lp += 2;
  if (lp + 1 <= h) lp_of[n] = lp, d_of[n++] = 1, lp += 1;
  lp_of[n] = h;
  if (c == 0) {
    *exchange = n;  // no stage: every one is the CTA's own
    *run_shift = h;
    return true;
  }
  for (int s = n - 1; s >= 0; --s) {
    if (h - d_of[s] - lp_of[s] >= c && lp_of[s + 1] >= c) {
      *exchange = s;
      *run_shift = lp_of[s + 1] - c;
      return true;
    }
  }
  return false;
}

// The CTAs a transform of H = N / 2 complex values takes
// (ops/correlate_os.py::cluster_size): one up to kMaxLocal values, then
// H / kMaxLocal of kMaxLocal each.
int cluster_of(int H) { return H > kMaxLocal ? H / kMaxLocal : 1; }

template <bool kCluster>
int launch(const Args& a, long long ctas, int threads, size_t smem, cudaStream_t stream) {
  // Whether the card fits a cluster of C (checked once per C, before its
  // first launch: a cluster's CTAs always hold kMaxLocal values).
  static bool fits[kMaxCluster + 1];
  auto kernel = correlate_os_kernel<kCluster>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(ctas));
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;  // one CTA a transform: a plain launch
  if (kCluster && !fits[a.cluster]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    fits[a.cluster] = true;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCluster>
int residency(int cluster, int threads, size_t smem, int* ctas_per_sm, int* clusters) {
  auto kernel = correlate_os_kernel<kCluster>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(cluster) * 1024u);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}

}  // namespace

// C interface for ctypes. seg (B, ns, n / 2 + 1) and bank (G, n / 2 + 1)
// complex64, contiguous; tables f32 on the device, complex values
// interleaved: the n / 2 + 1 separation twiddles exp(-2 pi i k / n), then
// for each pass q of the plan (radix R after p points: 4s while 4p <= n / 2,
// then a 2 where 2p <= n / 2) its p (R - 1) twiddles W[r k n / (2 p R)] at
// k (R - 1) + r - 1 (ops/correlate_os.py builds them); out (B, G, L) f32.
// n a power of two from 4 to 262,144, whose transform takes cluster_of(n /
// 2) CTAs; 1 <= step <= n; ns step >= L + off. All on the current device.
// Returns the CUDA error code of the launch (0 on success;
// cudaErrorInvalidConfiguration where the card fits no such cluster).
extern "C" int apd_correlate_os(const void* seg, long long B, int ns, const void* bank, int G,
                                int n, int step, int off, long long L, const float* tables,
                                float* out, void* stream) {
  if (B <= 0 || G <= 0 || L <= 0) return 0;
  const int H = n / 2;
  const int cluster = cluster_of(H);
  int log_c = 0;
  while ((1 << log_c) < cluster) ++log_c;
  int h = 0;
  while ((1 << h) < H) ++h;
  Args a;
  if (n < 4 || n > 2 * kMaxHalf || (n & (n - 1)) != 0 || ns < 1 || step < 1 || step > n ||
      off < 0 ||
      static_cast<long long>(ns) * step < L + off ||
      B * G * ns * cluster >= (1LL << 31) || !cluster_plan(h, log_c, &a.exchange, &a.run_shift))
    return static_cast<int>(cudaErrorInvalidValue);
  a.post = reinterpret_cast<const float2*>(tables);
  const float2* tw = a.post + H + 1;
  for (int p = 1, q = 0; p < H; ++q) {
    const int R = 4 * p <= H ? 4 : 2;
    a.pass_tw[q] = tw;
    tw += p * (R - 1);
    p *= R;
  }
  a.seg = static_cast<const float2*>(seg);
  a.bank = static_cast<const float2*>(bank);
  a.out = out;
  a.L = L;
  a.G = G;
  a.ns = ns;
  a.half = H;
  a.step = step;
  a.off = off;
  a.inv_n = 1.0f / static_cast<float>(n);
  a.cluster = cluster;
  a.log_cluster = log_c;
  const int local = H >> log_c;
  const int threads = local / kPerThread < 32 ? 32 : local / kPerThread;
  const size_t smem = static_cast<size_t>(local) * sizeof(float2);
  const long long ctas = B * G * ns * cluster;
  auto s = static_cast<cudaStream_t>(stream);
  return cluster == 1 ? launch<false>(a, ctas, threads, smem, s)
                      : launch<true>(a, ctas, threads, smem, s);
}

// How many CTAs of a launch of n points fit an SM at once, and how many of
// its clusters the card holds at once (the CUDA occupancy calculator's),
// into ctas_per_sm and clusters. Returns the CUDA error code
// (cudaErrorInvalidValue for a length the kernel does not take).
extern "C" int apd_correlate_os_residency(int n, int* ctas_per_sm, int* clusters) {
  if (n < 4 || n > 2 * kMaxHalf || (n & (n - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cluster = cluster_of(n / 2);
  const int local = n / 2 / cluster;
  const int threads = local / kPerThread < 32 ? 32 : local / kPerThread;
  const size_t smem = static_cast<size_t>(local) * sizeof(float2);
  return cluster == 1 ? residency<false>(cluster, threads, smem, ctas_per_sm, clusters)
                      : residency<true>(cluster, threads, smem, ctas_per_sm, clusters);
}
