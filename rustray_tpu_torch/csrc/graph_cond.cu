// Conditional CUDA graph nodes for the captured chunk program: the port of
// the JAX package's four device-side skips of all-dead work, the
// ``jax.lax.cond``s of rustray_tpu/render/wavefront.py:383 (a dead
// wavefront level), rustray_tpu/ops/traverse.py:331 (a traversal with no
// live ray) and rustray_tpu/ops/octet_trace.py:306 and :361 (an octet
// fallback with no ray over its slots, an octet slice with no live ray).
//
// While a stream captures a CUDA graph, rr_if_begin appends to the graph
//   1. set_if, a one-thread kernel that reads the gate's 0-dim bool
//      predicate (``mask.any()``, computed on the device just before),
//      hands it to the IF node's handle and adds it to the graph's run
//      count of this gate (runs[site], int64), and
//   2. an IF node after it, whose body graph the caller's body stream then
//      captures (cudaStreamBeginCaptureToGraph) until rr_if_end.
// The capturing stream continues after the node, so the work captured
// after the gate reads what the body wrote.  Inside a body the body stream
// is itself capturing, so gates nest: the handle is created in the graph
// the calling stream captures into (the body of the enclosing node).
//
// set_if calls device runtime API (cudaGraphSetConditional), which is why
// this is CUDA C++.  It costs one launch of one thread per gate and replay;
// what it saves is the body's work whenever the predicate is false.
//
// Plain C interface, loaded with ctypes (rustray_tpu_torch/graphs.py);
// every function returns its cudaError_t.
#include <cuda_runtime.h>

namespace {

__global__ void set_if(cudaGraphConditionalHandle handle, const bool* pred,
                       long long* runs) {
  const unsigned int live = *pred ? 1u : 0u;
  cudaGraphSetConditional(handle, live);
  *runs += live;
}

}  // namespace

extern "C" {

int rr_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return err;
  return cudaDriverGetVersion(driver);
}

// a stream of its own for the bodies of one nesting depth (never the
// capturing stream nor one of torch's pooled streams)
int rr_stream_create(void** stream) {
  return cudaStreamCreateWithFlags(reinterpret_cast<cudaStream_t*>(stream),
                                   cudaStreamNonBlocking);
}

int rr_if_begin(void* stream_ptr, void* body_ptr, const void* pred,
                void* runs, long long site) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorIllegalState;

  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0,
                                         cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  set_if<<<1, 1, 0, stream>>>(handle, static_cast<const bool*>(pred),
                              static_cast<long long*>(runs) + site);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  // the node goes after set_if (the stream's dependencies now)
  err = cudaStreamGetCaptureInfo(stream, &status, nullptr, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_ptr), params.conditional.phGraph_out[0],
      nullptr, nullptr, 0, cudaStreamCaptureModeRelaxed);
}

int rr_if_end(void* body_ptr) {
  cudaGraph_t body;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_ptr), &body);
}

}  // extern "C"
