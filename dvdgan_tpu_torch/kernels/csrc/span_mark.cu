// The span marker: a one-thread kernel that does nothing but stand on the
// device's timeline. `utils/profiling.py:span` launches one where a span
// begins and one where it ends while the current stream is being captured
// into a CUDA graph, so that the graph's replays carry the span's bounds:
// a profiler ties every replayed kernel to the one graph launch, and a host
// range opened during the capture is not replayed. The kernel is declared
// extern "C", so a trace shows it under its plain name, dvdgan_span_mark.

#include <cuda_runtime.h>

extern "C" __global__ void dvdgan_span_mark(int id) { (void)id; }

// Plain C interface, loaded with ctypes.
extern "C" {

// ONE launch of the marker on `stream` (a cudaStream_t); `id` is the mark's
// place in the capture's list of marks (`MultiStep.marks`). Returns the CUDA
// error code of the launch (0 = launched).
int dvdgan_span_mark_launch(int device, int id, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  dvdgan_span_mark<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(id);
  return static_cast<int>(cudaGetLastError());
}

const char* dvdgan_span_mark_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
