// G — one Gauss–Seidel best-response sweep of the cluster game (Alg. 3).
//
// Replaces: src/repro/core/game.py, jax_game_rounds_gs — the lax.scan of
// cluster_step over every cluster.  The reference has no Pallas kernel
// for it.  For rows i = 0 .. n-1 in order, against the live loads:
//   cost[p] = (lam/k)*s_i*(loads[p] - s_i*[p == cur_i] + s_i)
//           + 0.5*(rt_i - aff[i][p])                       p < k
//   best    = the first-index argmin
//   move    = cost[best] + 1e-6 + 1e-5*|cost[cur_i]| < cost[cur_i]
//   a move: loads[cur_i] -= s_i, loads[best] += s_i, assign[i] = best.
// Every float operation is a rounded intrinsic in the reference's order
// (no FMA contraction), so the sweep equals the reference's step bit for
// bit; kernels/game_gs.py game_gs_plain is the same step as tensor code.
// k is a C int and (float)k is exact; lam comes as a device value.
//
// What bounds it on the H100: the dependent chain through the loads.  A
// cluster's choice reads the loads its predecessor wrote, so the clusters
// go one after another: per cluster the cost (a few dependent flops), a
// 5-level shuffle argmin, the move test and the update.  The rows'
// bytes (aff, sizes, row totals, assignments) do not depend on the chain.
//
// Design: one CTA.  Warp 0 owns the k lanes, ceil(k/32) a lane, with the
// loads in registers (T's warp-walk pattern, csrc/transform_scan.cu), and
// walks the clusters; the argmin is a butterfly of (cost, lane) pairs that
// keeps the lower lane on ties.  Warps 1..7 stage the next tile of rows
// (aff rows at a 32-lane stride, sizes, row totals, current partitions)
// into the other half of a two-tile ring in shared memory while warp 0
// walks this one, as K1's pass stages its blocks
// (csrc/cluster_scatter.cu); one barrier a tile.  Pad rows past n (no
// size, no row total: cost 0 everywhere, never move) are not walked.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStagers = kThreads - 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;

struct Tile {
  float* aff;   // rows x kp
  float* sz;    // rows
  float* rt;    // rows
  int* cur;     // rows
};

__device__ __forceinline__ Tile tile_at(float* smem, int slot, int rows,
                                        int kp) {
  float* base = smem + (size_t)slot * rows * (kp + 3);
  Tile t;
  t.aff = base;
  t.sz = base + (size_t)rows * kp;
  t.rt = t.sz + rows;
  t.cur = (int*)(t.rt + rows);
  return t;
}

// warps 1..7: rows r0 .. r0 + cnt - 1 into a tile, four loads in flight
__device__ void stage(Tile t, const float* __restrict__ aff,
                      const float* __restrict__ sizes,
                      const float* __restrict__ row_tot,
                      const int* assign, long long r0, int cnt, int k,
                      int kp, int sid) {
  const int total = cnt * k;
  for (int i0 = sid; i0 < total; i0 += 4 * kStagers) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kStagers;
      v[u] = i < total ? aff[r0 * k + i] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * kStagers;
      if (i < total) t.aff[(i / k) * kp + i % k] = v[u];
    }
  }
  for (int r = sid; r < cnt; r += kStagers) {
    t.sz[r] = sizes[r0 + r];
    t.rt[r] = row_tot[r0 + r];
    t.cur[r] = assign[r0 + r];
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    game_gs_kernel(const float* __restrict__ aff,
                   const float* __restrict__ sizes,
                   const float* __restrict__ row_tot,
                   const float* __restrict__ lam, int* assign, float* loads,
                   int* moved, int n, int k, int rows) {
  extern __shared__ __align__(16) float smem[];
  constexpr int kp = 32 * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntiles = (n + rows - 1) / rows;
  float ld[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int p = q * 32 + lane;
    ld[q] = (warp == 0 && p < k) ? loads[p] : 0.0f;
  }
  const float a = __fdiv_rn(lam[0], (float)k);
  int count = 0;

  if (warp > 0)
    stage(tile_at(smem, 0, rows, kp), aff, sizes, row_tot, assign, 0,
          min(rows, n), k, kp, tid - 32);
  __syncthreads();
  for (int t = 0; t < ntiles; ++t) {
    const long long r0 = (long long)t * rows;
    const int cnt = (int)min((long long)rows, n - r0);
    if (warp > 0) {
      if (t + 1 < ntiles)
        stage(tile_at(smem, (t + 1) & 1, rows, kp), aff, sizes, row_tot,
              assign, r0 + rows, (int)min((long long)rows, n - r0 - rows),
              k, kp, tid - 32);
    } else {
      const Tile tl = tile_at(smem, t & 1, rows, kp);
      for (int r = 0; r < cnt; ++r) {
        const float* row = tl.aff + (size_t)r * kp;
        const float s = tl.sz[r], rt = tl.rt[r];
        const int cur = tl.cur[r];
        const float as = __fmul_rn(a, s);
        float bc = kBig, cc = 0.0f;
        int bp = k;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const int p = q * 32 + lane;
          const float own = (p == cur) ? 1.0f : 0.0f;
          const float lex = __fsub_rn(ld[q], __fmul_rn(s, own));
          const float c1 = __fmul_rn(as, __fadd_rn(lex, s));
          const float c2 = __fmul_rn(0.5f, __fsub_rn(rt, row[p]));
          const float c = __fadd_rn(c1, c2);
          if (p < k && (c < bc || bp == k)) {   // ascending p: first index
            bc = c;
            bp = p;
          }
          cc = (p == cur) ? c : cc;
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float oc = __shfl_xor_sync(kFull, bc, off);
          const int op = __shfl_xor_sync(kFull, bp, off);
          if (oc < bc || (oc == bc && op < bp)) {
            bc = oc;
            bp = op;
          }
        }
        cc = __shfl_sync(kFull, cc, cur & 31);
        const bool move =
            __fadd_rn(__fadd_rn(bc, 1e-6f), __fmul_rn(1e-5f, fabsf(cc))) < cc;
        if (move) {
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int p = q * 32 + lane;
            ld[q] = (p == cur) ? __fsub_rn(ld[q], s) : ld[q];
            ld[q] = (p == bp) ? __fadd_rn(ld[q], s) : ld[q];
          }
          if (lane == 0) assign[r0 + r] = bp;
          ++count;
        }
      }
    }
    __syncthreads();
  }
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int p = q * 32 + lane;
      if (p < k) loads[p] = ld[q];
    }
    if (lane == 0) *moved = count;
  }
}

// rows a tile: two tiles of rows x (kp + 3) words within 96 KB
int tile_rows(int kp) {
  const int rows = (96 * 1024) / (2 * 4 * (kp + 3));
  return rows < 1 ? 1 : (rows > 128 ? 128 : rows);
}

template <int R>
int launch(const float* aff, const float* sizes, const float* row_tot,
           const float* lam, int* assign, float* loads, int* moved, int n,
           int k, cudaStream_t stream) {
  const int kp = 32 * R, rows = tile_rows(kp);
  const size_t smem = 2 * sizeof(float) * (size_t)rows * (kp + 3);
  cudaError_t e = cudaFuncSetAttribute(
      game_gs_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  game_gs_kernel<R><<<1, kThreads, smem, stream>>>(
      aff, sizes, row_tot, lam, assign, loads, moved, n, k, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// aff (>= n rows) x k f32, row-major; 0 < k <= kernels/game_gs.py MAX_K;
// assign and loads are updated in place; moved is one int32.
extern "C" int g_game_gs(const float* aff, const float* sizes,
                         const float* row_tot, const float* lam, int* assign,
                         float* loads, int* moved, int n, int k,
                         cudaStream_t stream) {
  if (n <= 0) return (int)cudaMemsetAsync(moved, 0, sizeof(int), stream);
  if (k <= 32)
    return launch<1>(aff, sizes, row_tot, lam, assign, loads, moved, n, k,
                     stream);
  if (k <= 64)
    return launch<2>(aff, sizes, row_tot, lam, assign, loads, moved, n, k,
                     stream);
  if (k <= 128)
    return launch<4>(aff, sizes, row_tot, lam, assign, loads, moved, n, k,
                     stream);
  if (k <= 256)
    return launch<8>(aff, sizes, row_tot, lam, assign, loads, moved, n, k,
                     stream);
  if (k <= 512)
    return launch<16>(aff, sizes, row_tot, lam, assign, loads, moved, n, k,
                      stream);
  return launch<32>(aff, sizes, row_tot, lam, assign, loads, moved, n, k,
                    stream);
}
