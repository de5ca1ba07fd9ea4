// Shared by every kernel library of the port: each .cu file builds into
// its own shared library with a plain C interface (see kernels/_build.py),
// and each exports this helper so the Python wrapper can name an error.
// Codes from 10000 up are a TMA tensor map that cuTensorMapEncodeTiled
// refused (10000 + its CUresult; 10000 alone: the entry point is missing).
#pragma once
#include <cuda_runtime.h>

extern "C" const char* repro_error_string(int err) {
  if (err >= 10000)
    return "cuTensorMapEncodeTiled could not encode a TMA tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
