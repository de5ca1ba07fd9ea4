// Shared by every kernel library of the port: each .cu file builds into
// its own shared library with a plain C interface (see kernels/_build.py),
// and each exports this helper so the Python wrapper can name an error.
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
