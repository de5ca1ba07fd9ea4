// K3 — ELL sparse matrix-vector product, the PageRank local gather.
//
// Replaces: src/repro/kernels/ell_spmv.py, ell_spmv (the Pallas kernel
// _spmv_kernel).  y[r] = sum_j vals[r,j] * x[cols[r,j]], f32 accumulation.
//
// What bounds it on the H100: bytes.  Each of the R*W lanes reads one
// value, one column index and one gathered x entry for two flops; the
// floor is (R*W*(sizeof(val)+4) + N*sizeof(x) + R*4) bytes over 3.35 TB/s.
// The x gathers are random, so the real cost is set by how much of x the
// 50 MB L2 holds (all of it at scale 20: k*(L_max+1) f32 is ~7 MB).
//
// Design: the port feeds it a row-split ELL (each destination's in-edges
// split over ceil(indeg/W) rows of a fixed width W), so no row is padded
// to the hub's in-degree.  One thread per row walks its W lanes in order;
// W is small (chosen from the in-degree distribution), so a row is one or
// two 32-byte sectors and neighbouring threads read neighbouring rows.
#include <cuda_bf16.h>
#include "common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void ell_spmv_kernel(const T* __restrict__ vals,
                                const int* __restrict__ cols,
                                const T* __restrict__ x, float* __restrict__ y,
                                int R, int W) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const size_t base = (size_t)r * W;
  float acc = 0.0f;
  for (int j = 0; j < W; ++j)
    acc = __fadd_rn(acc, __fmul_rn(to_f32(vals[base + j]),
                                   to_f32(x[cols[base + j]])));
  y[r] = acc;
}

template <typename T>
int launch(const T* vals, const int* cols, const T* x, float* y, int R, int W,
           cudaStream_t stream) {
  if (R > 0) {
    const int threads = 256;
    ell_spmv_kernel<T><<<(R + threads - 1) / threads, threads, 0, stream>>>(
        vals, cols, x, y, R, W);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int k3_ell_spmv_f32(const float* vals, const int* cols,
                               const float* x, float* y, int R, int W,
                               cudaStream_t stream) {
  return launch(vals, cols, x, y, R, W, stream);
}

extern "C" int k3_ell_spmv_bf16(const __nv_bfloat16* vals, const int* cols,
                                const __nv_bfloat16* x, float* y, int R,
                                int W, cudaStream_t stream) {
  return launch(vals, cols, x, y, R, W, stream);
}
