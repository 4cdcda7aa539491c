// Device spans: a one-thread stamp kernel that times the phases of a
// training step on the device, eagerly and inside a CUDA graph alike.
//
// Replaces no TPU kernel.  It was added because a captured step is one
// cudaGraphLaunch on the host and thousands of kernels on the device, and
// nothing ties those kernels to the phase of the step they belong to.  A
// mark in the step's body (utils/profiling.py::Spans.mark) launches one
// stamp on the current stream; a capture records it as a node of the graph,
// between the kernels of the phases it bounds, and every replay runs it.
//
// buf is int64 [1 + spans]: buf[0] holds the last stamp's %globaltimer
// (nanoseconds; 0 before the first), buf[1 + i] the nanoseconds of span i.
// A stamp that closes span i (i >= 0) adds now - buf[0] to buf[1 + i] when
// there was a stamp before it, and sets buf[0] = now; a stamp with i < 0
// only sets buf[0] (a restart).  Consecutive stamps run in stream order, so
// one thread, no atomics.  Bound: the launch itself, a few microseconds of
// the stream (no operations, 24 bytes).
//
// spans_timer_tick reads %globaltimer in a loop and writes the smallest
// nonzero step between consecutive reads: the clock's resolution.
//
// Plain C interface, loaded with ctypes.  The entry points launch on the
// given stream, do not synchronise, allocate nothing, and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void span_stamp(long long* buf, int closing) {
  const long long now = global_timer();
  const long long last = buf[0];
  if (closing >= 0 && last != 0) buf[1 + closing] += now - last;
  buf[0] = now;
}

__global__ void timer_tick(long long* out, int reads) {
  long long prev = global_timer(), least = 0;
  for (int i = 0; i < reads; ++i) {
    const long long t = global_timer();
    if (t != prev) {
      if (least == 0 || t - prev < least) least = t - prev;
      prev = t;
    }
  }
  out[0] = least;
}

}  // namespace

extern "C" {

// buf int64 [1 + spans] on the stream's device; closing < spans.
int spans_stamp(void* buf, int closing, void* stream) {
  span_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(buf),
                                                             closing);
  return static_cast<int>(cudaGetLastError());
}

// out int64 [1]; reads >= 1.
int spans_timer_tick(void* out, int reads, void* stream) {
  if (reads < 1) return cudaErrorInvalidValue;
  timer_tick<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<long long*>(out),
                                                             reads);
  return static_cast<int>(cudaGetLastError());
}

const char* spans_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
