// Shared by every kernel library of the port: each .cu builds into its own
// shared object with a plain C interface (kernels/_build.py).
#pragma once
#include <cuda_runtime.h>

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
