// K2 over a batch's rows, its affinity built from the cluster CSR.
//
// Replaces: src/repro/kernels/game_bestresponse.py, game_bestresponse
// (the Pallas kernel _br_kernel) together with the dense affinity scatter
// that feeds it every batch (src/repro/core/game.py, jax_game_rounds).
//
// For every row i in [row0, row1) of the symmetrized cross-edge CSR
// (rowptr, col; each cross edge in both endpoints' rows):
//   aff[p]    = #{j in row i : assign[col[j]] == p}
//   cost(p)   = (lam/k)*s_i*(loads_p - s_i*[p == cur_i] + s_i)
//             + 0.5*(row_tot_i - aff[p])
//   best, cost = the first-index argmin and the min over p < k,
//   cost_cur  = ((lam/k)*s_i)*loads[cur_i] + 0.5*(row_tot_i - aff[cur_i]),
// the last in the game's own order (core/game.py), which rounds unlike the
// lane-cur cost.  The counts are integers, exact in any order, so the
// shared histogram equals the dense f32 scatter bit for bit; every float
// operation is a rounded intrinsic in the reference's order (no FMA
// contraction), as in csrc/game_bestresponse.cu.
//
// What bounds it on the H100: bytes — each row's CSR slice, one 4-byte
// gather of assign per entry, the row's scalars; a few integer ops per
// entry and ~8 flops per (row, partition).
//
// Design: a CTA of 8 warps takes 8 consecutive rows.  A row of up to
// kLong entries is counted by its own warp into its own k-bin shared
// histogram; a longer row (the web graph's cluster graph has rows of up to
// ~2·10^5 entries, its in-degree hub) is counted by all 8 warps of its CTA
// into that row's histogram, one long row after another.  Each warp merges
// lanes that hit the same partition (__match_any_sync) and one lane adds
// the group's count, since a row's neighbours mostly sit on a few
// partitions; four gathers are in flight per lane.  Then each warp sweeps
// its row's k lanes, each lane keeping its first minimum, and reduces
// (cost, index) pairs with first-index ties, as jnp.argmin does.
#include "common.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kRows = 8;                  // rows (= warps) per CTA
constexpr int kThreads = 32 * kRows;
constexpr int kUnroll = 4;
constexpr int kLong = 32 * kUnroll * 8;   // longer rows take the whole CTA
constexpr unsigned kFull = 0xffffffffu;

// Count assign[col[j]] for j = lo + first, lo + first + stride, ... < hi
// into hist; `first` and `stride` are multiples of 32 plus the lane.
__device__ __forceinline__ void count(int* hist, const int* __restrict__ col,
                                      const int* __restrict__ assign, int lo,
                                      int hi, int first, int stride,
                                      int lane) {
  for (int base = lo + first; base - lane < hi; base += stride * kUnroll) {
    int part[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * stride;
      part[u] = j < hi ? assign[col[j]] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const unsigned peers = __match_any_sync(kFull, part[u]);
      if (part[u] >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[part[u]], __popc(peers));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    game_bestresponse_csr_kernel(const int* __restrict__ rowptr,
                                 const int* __restrict__ col,
                                 const int* __restrict__ assign,
                                 const float* __restrict__ sizes,
                                 const float* __restrict__ row_tot,
                                 const float* __restrict__ loads,
                                 const float* __restrict__ lam, int row0,
                                 int n, int k, int* __restrict__ best_out,
                                 float* __restrict__ cost_out,
                                 float* __restrict__ cur_out) {
  extern __shared__ int hist_all[];         // kRows x k bins
  __shared__ int lo_s[kRows], hi_s[kRows];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x * kRows + warp;  // this warp's row in the range
  const bool valid = r < n;
  const int row = row0 + r;
  for (int i = tid; i < kRows * k; i += kThreads) hist_all[i] = 0;
  if (lane == 0) {
    lo_s[warp] = valid ? rowptr[row] : 0;
    hi_s[warp] = valid ? rowptr[row + 1] : 0;
  }
  float s = 0.0f, rt = 0.0f;
  int c = 0;
  if (valid) {
    s = sizes[row];
    rt = row_tot[row];
    c = assign[row];
  }
  __syncthreads();
  int* hist = hist_all + warp * k;
  if (hi_s[warp] - lo_s[warp] <= kLong)
    count(hist, col, assign, lo_s[warp], hi_s[warp], lane, 32, lane);
  for (int w = 0; w < kRows; ++w)
    if (hi_s[w] - lo_s[w] > kLong)
      count(hist_all + w * k, col, assign, lo_s[w], hi_s[w], tid, kThreads,
            lane);
  __syncthreads();
  if (!valid) return;

  const float a = __fdiv_rn(lam[0], (float)k);
  const float as = __fmul_rn(a, s);
  float best_c = kBig;
  int best_p = k;
  for (int p = lane; p < k; p += 32) {
    const float own = (p == c) ? 1.0f : 0.0f;
    const float lex = __fsub_rn(loads[p], __fmul_rn(s, own));
    const float c1 = __fmul_rn(as, __fadd_rn(lex, s));
    const float c2 = __fmul_rn(0.5f, __fsub_rn(rt, (float)hist[p]));
    const float cost = __fadd_rn(c1, c2);
    if (cost < best_c || best_p == k) {
      best_c = cost;
      best_p = p;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(kFull, best_c, off);
    const int op = __shfl_down_sync(kFull, best_p, off);
    if (oc < best_c || (oc == best_c && op < best_p)) {
      best_c = oc;
      best_p = op;
    }
  }
  if (lane == 0) {
    best_out[r] = best_p;
    cost_out[r] = best_c;
    cur_out[r] = __fadd_rn(__fmul_rn(as, loads[c]),
                           __fmul_rn(0.5f, __fsub_rn(rt, (float)hist[c])));
  }
}

}  // namespace

// Rows row0 .. row0 + n - 1; outputs hold n values; 0 < k <=
// kernels/game_bestresponse.py CSR_MAX_K.
extern "C" int k2_game_bestresponse_csr(
    const int* rowptr, const int* col, const int* assign, const float* sizes,
    const float* row_tot, const float* loads, const float* lam, int* best,
    float* cost, float* cost_cur, int row0, int n, int k,
    cudaStream_t stream) {
  const size_t smem = sizeof(int) * kRows * (size_t)k;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        game_bestresponse_csr_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0)
    game_bestresponse_csr_kernel<<<(n + kRows - 1) / kRows, kThreads, smem,
                                   stream>>>(rowptr, col, assign, sizes,
                                             row_tot, loads, lam, row0, n, k,
                                             best, cost, cost_cur);
  return (int)cudaGetLastError();
}
