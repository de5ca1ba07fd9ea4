// K2 — the cluster-partitioning game's best-response sweep.
//
// Replaces: src/repro/kernels/game_bestresponse.py, game_bestresponse
// (the Pallas kernel _br_kernel).
//
// Per cluster row i over kpad partition lanes p:
//   cost(i,p) = (lam/k)*s_i*(loads_p - s_i*[p == cur_i] + s_i)
//             + 0.5*(row_tot_i - aff[i,p]),   lanes p >= k cost 3e38,
// and the row's first-index argmin and min cost.
//
// What bounds it on the H100: bytes.  Each row reads its k real lanes of
// aff once (lanes p >= k are never read) and does ~8 flops per lane, far
// below the 20 flop/byte line of f32 outside the tensor cores, so the
// floor is M*k*4 bytes over 3.35 TB/s.  The game passes kpad = k.
//
// Design: one warp per row.  Lane l walks p = l, l+32, ... so a warp's
// loads of a row are coalesced; each lane keeps its first minimum
// (strictly smaller wins, p ascending), then a shuffle reduction over
// (cost, index) pairs keeps the smaller cost and, on a tie, the smaller
// index — jnp.argmin's first-index rule.  Every operation is the
// rounded intrinsic in the reference's order (no FMA contraction), so
// the kernel is bit-identical to the plain PyTorch version.
#include "common.cuh"

namespace {

constexpr float kBig = 3.0e38f;
constexpr int kRowsPerBlock = 8;

__global__ void game_bestresponse_kernel(
    const float* __restrict__ aff, const float* __restrict__ sizes,
    const float* __restrict__ row_tot, const int* __restrict__ cur,
    const float* __restrict__ loads, const float* __restrict__ lam, int M,
    int kpad, int k, int* __restrict__ best_out,
    float* __restrict__ cost_out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= M) return;
  const float a = __fdiv_rn(lam[0], (float)k);
  const float s = sizes[row];
  const float rt = row_tot[row];
  const int c = cur[row];
  const float as = __fmul_rn(a, s);
  const float* arow = aff + (size_t)row * kpad;

  float best_c = kBig;
  int best_p = kpad;
  for (int p = lane; p < kpad; p += 32) {
    float cost = kBig;
    if (p < k) {
      const float own = (p == c) ? 1.0f : 0.0f;
      const float lex = __fsub_rn(loads[p], __fmul_rn(s, own));
      const float c1 = __fmul_rn(as, __fadd_rn(lex, s));
      const float c2 = __fmul_rn(0.5f, __fsub_rn(rt, arow[p]));
      cost = __fadd_rn(c1, c2);
    }
    if (cost < best_c || best_p == kpad) {
      best_c = cost;
      best_p = p;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, best_c, off);
    const int op = __shfl_down_sync(0xffffffffu, best_p, off);
    if (oc < best_c || (oc == best_c && op < best_p)) {
      best_c = oc;
      best_p = op;
    }
  }
  if (lane == 0) {
    best_out[row] = best_p;
    cost_out[row] = best_c;
  }
}

}  // namespace

extern "C" int k2_game_bestresponse(const float* aff, const float* sizes,
                                    const float* row_tot, const int* cur,
                                    const float* loads, const float* lam,
                                    int* best, float* cost, int M, int kpad,
                                    int k, cudaStream_t stream) {
  if (M > 0) {
    const int grid = (M + kRowsPerBlock - 1) / kRowsPerBlock;
    game_bestresponse_kernel<<<grid, 32 * kRowsPerBlock, 0, stream>>>(
        aff, sizes, row_tot, cur, loads, lam, M, kpad, k, best, cost);
  }
  return (int)cudaGetLastError();
}
