// CUDA conditional (if) nodes inside a stream capture, for sm_90a.
//
// The counterpart of the JAX lean tail's lax.cond(jnp.any(valive), verify,
// zeros) (audio_pattern_detector_tpu/models/bank.py:1306-1330) in a
// captured class step (models/captured.py). No Pallas kernel is replaced;
// this is graph plumbing, as lax.cond is program structure in XLA.
//
// apd_graph_if_begin(capture, pred, body) runs while ``capture`` records a
// graph (a torch.cuda.graph capture). It
//   1. creates a conditional handle in the graph being captured;
//   2. enqueues on ``capture`` a one-thread kernel that sets the handle from
//      the bool at ``pred`` (device memory) when the graph runs;
//   3. adds an if-node after it, with a body graph of its own;
//   4. makes the if-node the point that later work on ``capture`` follows;
//   5. starts a capture of ``body`` (another stream, idle) into the body
//      graph.
// Work enqueued on ``body`` until apd_graph_if_end(body) is the if-node's
// body: at replay it runs only when *pred is true. A body may hold kernel,
// memset, device memcpy, child-graph and conditional nodes.
//
// Both return a cudaError_t value; 0 is success.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_handle(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

}  // namespace

extern "C" int apd_graph_if_begin(void* capture, const void* pred, void* body) {
  cudaStream_t stream = static_cast<cudaStream_t>(capture);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive) return static_cast<int>(cudaErrorStreamCaptureUnmatched);

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  set_if_handle<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  // The if-node follows everything captured so far, the handle's kernel last.
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body), params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      cudaStreamCaptureModeRelaxed));
}

extern "C" int apd_graph_if_end(void* body) {
  cudaGraph_t graph = nullptr;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}
