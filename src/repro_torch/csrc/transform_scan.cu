// T — the partition transformation scan (paper Alg. 1).
//
// Replaces: src/repro/core/transform.py, transform_jax — a lax.scan of
// _transform_step over every edge.  The reference has no Pallas kernel for
// it; on a GPU a host loop over 6.4 M edges would take minutes, so the
// port walks the stream in one kernel.
//
// What bounds it on the H100: latency.  Each edge reads the loads the
// previous edge wrote (the balance cap makes the choice depend on them),
// so the stream is one dependent chain of shared-memory reads, compares
// and increments, a few tens of cycles per edge; the bytes moved (16 per
// edge) would take microseconds.
//
// Design: everything that does not depend on the loads — the gathers of
// the endpoints' partitions, degrees and divided marks, and the
// same-partition / mirror / degree choice of Alg. 1 lines 15-22 — is
// computed beforehand, vectorized, as one "normal" choice per edge (-1
// for padding lanes).  The kernel keeps the (k,) int32 load table in
// shared memory.  All 256 threads stage the next chunk of (pu, pv, normal)
// into shared memory with coalesced loads, one thread walks the chunk in
// order, and all threads write the chunk's choices back.  The cap test
// compares the loads converted to f32 with lmax rounded to f32, as the
// JAX jit path does; the least-loaded fallback takes the first index.
#include "common.cuh"

namespace {

constexpr int kChunk = 2048;
constexpr int kThreads = 256;

__global__ void transform_scan_kernel(const int* __restrict__ pu,
                                      const int* __restrict__ pv,
                                      const int* __restrict__ normal, int E,
                                      int k, float lmax,
                                      int* __restrict__ out) {
  extern __shared__ int sm[];
  int* loads = sm;
  int* cu = loads + k;
  int* cv = cu + kChunk;
  int* cn = cv + kChunk;
  int* co = cn + kChunk;
  for (int i = threadIdx.x; i < k; i += blockDim.x) loads[i] = 0;
  for (int base = 0; base < E; base += kChunk) {
    const int n = min(kChunk, E - base);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      cu[i] = pu[base + i];
      cv[i] = pv[base + i];
      cn[i] = normal[base + i];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n; ++i) {
        const int nm = cn[i];
        if (nm < 0) {  // padding lane: partition 0, no load
          co[i] = 0;
          continue;
        }
        const int a = cu[i], b = cv[i];
        const bool full_u = (float)loads[a] >= lmax;
        const bool full_v = (float)loads[b] >= lmax;
        int p = nm;
        if (full_u || full_v) {
          if (!full_u) {
            p = a;
          } else if (!full_v) {
            p = b;
          } else {
            p = 0;
            int lo = loads[0];
            for (int q = 1; q < k; ++q)
              if (loads[q] < lo) {
                lo = loads[q];
                p = q;
              }
          }
        }
        co[i] = p;
        loads[p] += 1;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) out[base + i] = co[i];
    __syncthreads();
  }
}

}  // namespace

extern "C" int t_transform_scan(const int* pu, const int* pv,
                                const int* normal, int* out, int E, int k,
                                float lmax, cudaStream_t stream) {
  const size_t smem = sizeof(int) * ((size_t)k + 4 * kChunk);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        transform_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (E > 0)
    transform_scan_kernel<<<1, kThreads, smem, stream>>>(pu, pv, normal, E, k,
                                                         lmax, out);
  return (int)cudaGetLastError();
}
