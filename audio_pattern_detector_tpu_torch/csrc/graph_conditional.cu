// CUDA conditional nodes (if and while) inside a stream capture, for sm_90a.
//
// The counterparts of the JAX class step's device-side control flow in a
// captured class step (models/captured.py):
//   * the lean tail's lax.cond(jnp.any(valive), verify, zeros)
//     (audio_pattern_detector_tpu/models/bank.py:1306-1330) and the two-tier
//     verify's lax.cond (models/bank.py:111-133, as two if-nodes on pred and
//     ~pred) are if-nodes;
//   * the greedy distance filters' lax.while_loop (ops/peaks.py:282, :323)
//     is a while node.
// No Pallas kernel is replaced; this is graph plumbing, as lax.cond and
// lax.while_loop are program structure in XLA.
//
// apd_graph_if_begin(capture, pred, body) and apd_graph_while_begin(capture,
// pred, body) run while ``capture`` records a graph (a torch.cuda.graph
// capture). Each
//   1. creates a conditional handle in the graph being captured;
//   2. enqueues on ``capture`` a one-thread kernel that sets the handle from
//      the bool at ``pred`` (device memory) when the graph runs;
//   3. adds an if-node or a while node after it, with a body graph of its
//      own;
//   4. makes the node the point that later work on ``capture`` follows;
//   5. starts a capture of ``body`` (another stream, idle) into the body
//      graph.
// Work enqueued on ``body`` until the matching apd_graph_if_end(body) or
// apd_graph_while_end(body) is the node's body. An if-node's body runs once
// when *pred is true. A while node's body runs while *pred is true: the
// handle is set before the node (so a false pred runs no body) and again by
// the same kernel, enqueued by apd_graph_while_end as the body's last node,
// from the *pred that the body has rewritten. A body may hold kernel,
// memset, device memcpy, child-graph and conditional nodes.
//
// Each returns a cudaError_t value; 0 is success.

#include <cuda_runtime.h>

#include <vector>

namespace {

__global__ void set_handle(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

struct OpenLoop {
  cudaStream_t body;
  cudaGraphConditionalHandle handle;
  const bool* pred;
};

// While nodes whose body is being captured, innermost last.
thread_local std::vector<OpenLoop> open_loops;

cudaError_t begin_node(cudaStream_t stream, const bool* pred, cudaStream_t body,
                       cudaGraphConditionalNodeType type, cudaGraphConditionalHandle* out) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, nullptr, nullptr);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_handle<<<1, 1, 0, stream>>>(handle, pred);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // The node follows everything captured so far, the handle's kernel last.
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  *out = handle;
  return cudaStreamBeginCaptureToGraph(body, params.conditional.phGraph_out[0], nullptr, nullptr,
                                       0, cudaStreamCaptureModeRelaxed);
}

}  // namespace

extern "C" int apd_graph_if_begin(void* capture, const void* pred, void* body) {
  cudaGraphConditionalHandle handle;
  return static_cast<int>(begin_node(static_cast<cudaStream_t>(capture),
                                     static_cast<const bool*>(pred),
                                     static_cast<cudaStream_t>(body), cudaGraphCondTypeIf,
                                     &handle));
}

extern "C" int apd_graph_if_end(void* body) {
  cudaGraph_t graph = nullptr;
  return static_cast<int>(cudaStreamEndCapture(static_cast<cudaStream_t>(body), &graph));
}

extern "C" int apd_graph_while_begin(void* capture, const void* pred, void* body) {
  OpenLoop loop{static_cast<cudaStream_t>(body), 0, static_cast<const bool*>(pred)};
  cudaError_t err = begin_node(static_cast<cudaStream_t>(capture), loop.pred, loop.body,
                               cudaGraphCondTypeWhile, &loop.handle);
  if (err == cudaSuccess) open_loops.push_back(loop);
  return static_cast<int>(err);
}

extern "C" int apd_graph_while_end(void* body) {
  cudaStream_t stream = static_cast<cudaStream_t>(body);
  if (open_loops.empty() || open_loops.back().body != stream) {
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  }
  OpenLoop loop = open_loops.back();
  open_loops.pop_back();
  set_handle<<<1, 1, 0, stream>>>(loop.handle, loop.pred);
  cudaError_t launched = cudaGetLastError();
  cudaGraph_t graph = nullptr;
  cudaError_t ended = cudaStreamEndCapture(stream, &graph);
  return static_cast<int>(launched != cudaSuccess ? launched : ended);
}
