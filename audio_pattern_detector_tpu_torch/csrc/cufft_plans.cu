// cuFFT plans that the port holds itself (ops/cufft_plans.py), for sm_90a.
//
// The class step's real transforms (the bank correlation's and the
// K-weighting's rfft and irfft) run on a card through these plans rather
// than through torch.fft. A captured CUDA graph replays a plan's kernels,
// and those kernels read device memory that the plan owns: torch's plans
// live in its cuFFT plan cache, which any caller can clear or evict, and a
// replay after that reads freed memory. A plan made here lives until the
// port destroys it, and the port never destroys one that a graph replays.
// No Pallas kernel is replaced: the JAX package's jnp.fft is XLA's FFT.
//
// apd_fft_plan(inverse, n, batch, &handle, &work_bytes) makes a plan of
// `batch` real transforms of n points along contiguous rows:
//   * forward (inverse 0), R2C: row b's n f32 samples at b * n, its
//     n / 2 + 1 complex64 bins at b * (n / 2 + 1);
//   * inverse (inverse 1), C2R: the other way; unnormalised, as cuFFT
//     computes it (the caller scales by 1 / n), and it overwrites its input.
// The plan allocates no work area; apd_fft_exec(handle, inverse, in, out,
// work, stream) gives it `work` (work_bytes, from the caller's allocator,
// so a capture takes it from the graph's pool) and enqueues the transform
// on `stream`. apd_fft_destroy(handle) frees the plan.
//
// Each returns 0 on success, else a cufftResult value.

#include <cuda_runtime.h>
#include <cufft.h>

#include <mutex>

namespace {

// A plan's stream and work area are state of the plan: set them and
// enqueue under one lock, so two threads never interleave on one plan.
std::mutex exec_mutex;

}  // namespace

extern "C" int apd_fft_plan(int inverse, long long n, long long batch, long long* handle,
                            unsigned long long* work_bytes) {
  if (n < 1 || batch < 1) return static_cast<int>(CUFFT_INVALID_VALUE);
  cufftHandle plan;
  cufftResult r = cufftCreate(&plan);
  if (r != CUFFT_SUCCESS) return static_cast<int>(r);
  long long size = n;
  long long bins = n / 2 + 1;
  size_t work = 0;
  if ((r = cufftSetAutoAllocation(plan, 0)) == CUFFT_SUCCESS) {
    r = inverse ? cufftMakePlanMany64(plan, 1, &size, &bins, 1, bins, &size, 1, n, CUFFT_C2R,
                                      batch, &work)
                : cufftMakePlanMany64(plan, 1, &size, &size, 1, n, &bins, 1, bins, CUFFT_R2C,
                                      batch, &work);
  }
  if (r != CUFFT_SUCCESS) {
    cufftDestroy(plan);
    return static_cast<int>(r);
  }
  *handle = static_cast<long long>(plan);
  *work_bytes = work;
  return 0;
}

extern "C" int apd_fft_exec(long long handle, int inverse, void* in, void* out, void* work,
                            void* stream) {
  const cufftHandle plan = static_cast<cufftHandle>(handle);
  std::lock_guard<std::mutex> lock(exec_mutex);
  cufftResult r = cufftSetStream(plan, static_cast<cudaStream_t>(stream));
  if (r == CUFFT_SUCCESS) r = cufftSetWorkArea(plan, work);
  if (r != CUFFT_SUCCESS) return static_cast<int>(r);
  r = inverse ? cufftExecC2R(plan, static_cast<cufftComplex*>(in), static_cast<cufftReal*>(out))
              : cufftExecR2C(plan, static_cast<cufftReal*>(in), static_cast<cufftComplex*>(out));
  return static_cast<int>(r);
}

extern "C" int apd_fft_destroy(long long handle) {
  return static_cast<int>(cufftDestroy(static_cast<cufftHandle>(handle)));
}
