// Device-side marks: empty kernels, one for each name, that a profiler's
// device trace shows where and when they ran.  A CUDA graph captures a mark
// with the kernels around it and runs it on every replay, so a replayed
// step carries the bracket of a mechanism (ops/trace_marks.py) where it
// opens no host span.  Each launch is one block of one thread that does
// nothing: about two microseconds of the device a mark.
//
// The names follow ops/trace_marks.py:MARKS, in its order.

#include <cuda_runtime.h>

extern "C" __global__ void epipolar_pooled_forward_begin() {}
extern "C" __global__ void epipolar_pooled_forward_end() {}
extern "C" __global__ void epipolar_pooled_backward_begin() {}
extern "C" __global__ void epipolar_pooled_backward_end() {}
extern "C" __global__ void hourglass_fusion_forward_begin() {}
extern "C" __global__ void hourglass_fusion_forward_end() {}
extern "C" __global__ void hourglass_fusion_backward_begin() {}
extern "C" __global__ void hourglass_fusion_backward_end() {}

// Launch mark `which` (an index into MARKS) on `stream`; returns the CUDA
// error of the launch, 0 on success.
extern "C" int trace_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: epipolar_pooled_forward_begin<<<1, 1, 0, s>>>(); break;
    case 1: epipolar_pooled_forward_end<<<1, 1, 0, s>>>(); break;
    case 2: epipolar_pooled_backward_begin<<<1, 1, 0, s>>>(); break;
    case 3: epipolar_pooled_backward_end<<<1, 1, 0, s>>>(); break;
    case 4: hourglass_fusion_forward_begin<<<1, 1, 0, s>>>(); break;
    case 5: hourglass_fusion_forward_end<<<1, 1, 0, s>>>(); break;
    case 6: hourglass_fusion_backward_begin<<<1, 1, 0, s>>>(); break;
    case 7: hourglass_fusion_backward_end<<<1, 1, 0, s>>>(); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trace_mark_count() { return 8; }
