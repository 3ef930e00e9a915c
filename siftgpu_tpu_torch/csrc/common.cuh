// Shared by every kernel library of siftgpu_tpu_torch (one .cu per library).
// Each library exports plain-C launch functions that take device pointers
// and a cudaStream_t, launch on that stream and return cudaGetLastError();
// the Python wrapper raises on a non-zero code, naming it with
// sift_cuda_error_string.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* sift_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

static inline unsigned int sift_ceil_div(long long n, long long d) {
  return static_cast<unsigned int>((n + d - 1) / d);
}
