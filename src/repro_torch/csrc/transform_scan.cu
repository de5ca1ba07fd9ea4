// T — the partition transformation scan (paper Alg. 1), chunk-parallel.
//
// Replaces: src/repro/core/transform.py, transform_jax — a lax.scan of
// _transform_step over every edge.  The reference has no Pallas kernel for
// it.  Everything that does not depend on the loads (each edge's endpoint
// partitions a, b and its Alg. 1 lines 15-22 "normal" choice, -1 on
// padding lanes) is computed beforehand, vectorized; this kernel decides
// the rest against the running (k,) load table:
//   full(p)  <=>  (float)loads[p] >= lmax (f32, as the JAX jit path);
//   the loads start from loads0 when it is given (the window assignment
//   of a resident partition: src/repro/core/transform.py transform_np's
//   loads=), else from 0;
//   normal < 0: partition 0, no load;  neither endpoint full: normal;
//   exactly one full: the other one;  both full: the first-index
//   least-loaded partition;  the chosen partition's load += 1.
//
// What bounds it on the H100: a dependent chain, but only through the
// full set F.  Loads only grow, so F only grows, and at most k times in a
// launch.  While F is fixed, an edge's choice depends on F alone unless
// both endpoints are full; only those "both-full" edges read the running
// loads.  So the walk is split into chunks of kChunk edges and each chunk
// takes the cheapest of three tiers that is exact:
//   parallel  all 512 threads choose each edge from F, build the chunk's
//             histogram in per-warp bins and reduce it.  If no edge is
//             both-full and no partition outside F reaches lmax at
//             loads + hist, no edge could have seen a newly full partition:
//             the choices are final and the loads add the histogram.
//   frozen    both-full edges but no fill predicted by the histogram: warp
//             0 walks the chunk with F fixed, 32 edges a step, the loads
//             in shared memory: the edges before the step's next
//             both-full one add their choices with shared atomics, then
//             the both-full edge takes the first-index least-loaded
//             partition.  That is the lowest bit of S, the mask of the
//             partitions at the least load (struct Least): one redux.sync
//             for the least load and a ballot per word when it is rebuilt,
//             so no packed (load, index) key and no bit budget; a +1 to a
//             partition in S (found with one redux.or per word) clears its
//             bit, and S is rebuilt only when it empties.  If a partition
//             outside F is full at the chunk's end, a fill happened inside
//             it: restore the chunk's starting loads and redo it exactly.
//   exact     a partition fills inside the chunk: warp 0 walks it from the
//             chunk's starting loads, 32 edges a step.  The lanes choose
//             their edges from the current F in parallel and add them; if
//             no edge of the step is both-full and no partition crossed
//             lmax, the step stands, else it is taken back and walked edge
//             by edge, setting F's bit in shared memory where a load
//             crosses lmax.  The speculation agrees with the exact walk up
//             to the first crossing, so every exact chunk really fills a
//             partition: at most k of them (and at most k steps walked
//             for a crossing).
// Chunks are staged with cp.async into a two-slot ring, so chunk i+1
// loads while chunk i is decided.  The kernel also counts its tiers
// (chunks per tier, edges walked, both-full edges) into `stats`, so a run
// can say where the time went; kernels/transform_scan.py emulates the
// same tiers on the host.  Seeded loads change none of this: F starts as
// the partitions full at loads0 and still only grows.
#include "common.cuh"

namespace {

constexpr int kChunk = 4096;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoLoad = -2;   // co[] codes: a padding lane ...
constexpr int kBoth = -1;     // ... and a both-full edge of the chunk

// stats[] slots (int64), mirrored by kernels/transform_scan.py TIER_KEYS
enum { kParallel, kFrozen, kExact, kRedone, kFrozenEdges, kExactEdges,
       kBothEdges, kStats };
constexpr int kStatsPad = 8;  // keeps the ring 16-byte aligned

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// one chunk of the three input streams into ring slot `dst` (3 x kChunk)
__device__ void stage(int* dst, const int* __restrict__ pu,
                      const int* __restrict__ pv,
                      const int* __restrict__ normal, long long base, int n) {
  const int n4 = n & ~3;
  const int* src[3] = {pu + base, pv + base, normal + base};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    for (int i = threadIdx.x * 4; i < n4; i += kThreads * 4)
      cp_async16(dst + s * kChunk + i, src[s] + i);
    for (int i = n4 + threadIdx.x; i < n; i += kThreads)
      cp_async4(dst + s * kChunk + i, src[s] + i);
  }
}

__device__ __forceinline__ bool is_full(int load, float lmax) {
  return (float)load >= lmax;
}

// Warp 0's mask of the partitions at the least load, S (every lane holds
// the same words; bit l of word q is partition l + 32q), over the loads in
// shared memory.  take() returns the first-index argmin, the lowest set
// bit, for the caller to +1, and clears it; added() clears the bits of
// partitions that other edges just moved off the least load.  An empty S
// means the least load changed: the next take() rebuilds it.
template <int R>
struct Least {
  unsigned S[R];
  bool fresh;

  __device__ __forceinline__ void rebuild(const int* loads, int k, int lane) {
    unsigned lo = 0xffffffffu;
#pragma unroll
    for (int q = 0; q < R; ++q)
      lo = min(lo, lane + 32 * q < k ? (unsigned)loads[lane + 32 * q]
                                     : 0xffffffffu);
    const unsigned m = __reduce_min_sync(kFull, lo);
#pragma unroll
    for (int q = 0; q < R; ++q)
      S[q] = __ballot_sync(kFull, lane + 32 * q < k &&
                                      (unsigned)loads[lane + 32 * q] == m);
    fresh = true;
  }

  __device__ __forceinline__ int take(const int* loads, int k, int lane) {
    if (!fresh) rebuild(loads, k, lane);
    int p = 0;
#pragma unroll
    for (int q = R - 1; q >= 0; --q)
      p = S[q] ? 32 * q + __ffs(S[q]) - 1 : p;
    unsigned any = 0;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      S[q] &= q == (p >> 5) ? ~(1u << (p & 31)) : 0xffffffffu;
      any |= S[q];
    }
    fresh = any != 0;
    return p;
  }

  // every lane with `mine` adds 1 to partition p (p >= 0); only a +1 to
  // a partition in S costs the reductions that clear its bit
  __device__ __forceinline__ void added(int p, bool mine) {
    // p's bit of S, as an OR over the words: selecting the word S[p >> 5]
    // instead makes the compiler index S dynamically, in local memory
    unsigned bit = 0;
#pragma unroll
    for (int q = 0; q < R; ++q)
      bit |= (unsigned)((p >> 5) == q) & (S[q] >> (p & 31));
    const bool hit = fresh && mine && (bit & 1u);
    if (!__any_sync(kFull, hit)) return;
    unsigned any = 0;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      S[q] &= ~__reduce_or_sync(
          kFull, hit && (p >> 5) == q ? 1u << (p & 31) : 0u);
      any |= S[q];
    }
    fresh = any != 0;
  }
};

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    transform_scan_kernel(const int* __restrict__ pu,
                          const int* __restrict__ pv,
                          const int* __restrict__ normal,
                          const int* __restrict__ loads0, long long E, int k,
                          float lmax, int* __restrict__ out,
                          long long* __restrict__ stats) {
  extern __shared__ __align__(16) long long cnt[];   // kStats, then:
  int* ring = (int*)(cnt + kStatsPad);    // 2 slots x (pu, pv, normal)
  int* co = ring + 6 * kChunk;            // per-edge choice / code
  int* loads = co + kChunk;               // k
  int* l0 = loads + k;                    // k: the loads a redo starts from
  int* whist = l0 + k;                    // kWarps x k
  unsigned* fw = (unsigned*)(whist + kWarps * k);   // F bitmask, 32 x R bits
  int* nboth = (int*)(fw + R);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int p = tid; p < k; p += kThreads) loads[p] = loads0 ? loads0[p] : 0;
  for (int i = tid; i < kWarps * k; i += kThreads) whist[i] = 0;
  if (tid < kStats) cnt[tid] = 0;
  if (tid == 0) *nboth = 0;
  __syncthreads();
  // F from the starting loads (lmax <= 0 makes every partition full)
  for (int q = warp; q < R; q += kWarps) {
    const int p = q * 32 + lane;
    const unsigned f = __ballot_sync(kFull, p < k && is_full(loads[p], lmax));
    if (lane == 0) fw[q] = f;
  }
  const long long n_chunks = (E + kChunk - 1) / kChunk;
  stage(ring, pu, pv, normal, 0, (int)min((long long)kChunk, E));
  cp_async_commit();

  for (long long c = 0; c < n_chunks; ++c) {
    const long long base = c * kChunk;
    const int n = (int)min((long long)kChunk, E - base);
    if (c + 1 < n_chunks)
      stage(ring + ((c + 1) & 1) * 3 * kChunk, pu, pv, normal,
            base + kChunk, (int)min((long long)kChunk, E - base - kChunk));
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int* cu = ring + (c & 1) * 3 * kChunk;
    const int* cv = cu + kChunk;
    const int* cn = cv + kChunk;

    // -------- speculate with F frozen: choices, per-warp histogram
    int both = 0;
    for (int i0 = warp * 32; i0 < n; i0 += kThreads) {
      const int i = i0 + lane;
      int code = kNoLoad;
      if (i < n && cn[i] >= 0) {
        const int a = cu[i], b = cv[i];
        const bool fu = (fw[a >> 5] >> (a & 31)) & 1u;
        const bool fv = (fw[b >> 5] >> (b & 31)) & 1u;
        code = !fu ? (fv ? a : cn[i]) : (!fv ? b : kBoth);
        if (code >= 0) atomicAdd(&whist[warp * k + code], 1);
      }
      co[i] = code;            // up to the next multiple of 32: a walk step
      both += __popc(__ballot_sync(kFull, code == kBoth));
    }
    if (lane == 0 && both) atomicAdd(nboth, both);
    __syncthreads();

    // -------- reduce the histogram into row 0; does any partition fill?
    int fill = 0;
    for (int p = tid; p < k; p += kThreads) {
      int h = whist[p];
      for (int w = 1; w < kWarps; ++w) {
        h += whist[w * k + p];
        whist[w * k + p] = 0;
      }
      whist[p] = h;
      const bool in_f = (fw[p >> 5] >> (p & 31)) & 1u;
      fill |= !in_f && is_full(loads[p] + h, lmax);
    }
    fill = __syncthreads_or(fill);
    const int nb = *nboth;

    if (!fill && nb == 0) {
      // -------- parallel tier: every choice is final
      for (int p = tid; p < k; p += kThreads) loads[p] += whist[p];
      if (tid == 0) cnt[kParallel] += 1;
    } else if (warp == 0) {
      for (int p = lane; p < k; p += 32) l0[p] = loads[p];
      __syncwarp();
      Least<R> least{{}, false};
      bool exact = fill;
      if (!exact) {
        // -------- frozen tier: F fixed; each step adds the choices up to
        // its next both-full edge, which then takes the argmin
        for (int g = 0; g < n; g += 32) {
          const int code = co[g + lane];
          unsigned both = __ballot_sync(kFull, code == kBoth);
          int from = 0;
          for (;;) {
            const int to = both ? __ffs(both) - 1 : 32;
            const bool mine = lane >= from && lane < to && code >= 0;
            if (mine) atomicAdd(&loads[code], 1);
            least.added(code, mine);
            __syncwarp();
            if (to == 32) break;
            const int p = least.take(loads, k, lane);
            if (lane == 0) {
              atomicAdd(&loads[p], 1);
              co[g + to] = p;
            }
            __syncwarp();
            both &= both - 1;
            from = to + 1;
          }
        }
        bool grew = false;
        for (int p = lane; p < k; p += 32)
          grew |= !((fw[p >> 5] >> (p & 31)) & 1u) && is_full(loads[p], lmax);
        exact = __any_sync(kFull, grew);
        if (lane == 0) {
          cnt[kFrozen] += !exact;
          cnt[kRedone] += exact;
          cnt[kFrozenEdges] += n;
        }
        if (exact) {
          for (int p = lane; p < k; p += 32) loads[p] = l0[p];
          least.fresh = false;
          __syncwarp();
        }
      }
      if (exact) {
        // -------- exact tier: 32 edges a step from the current F; a step
        // with a both-full edge or a crossing is walked edge by edge
        for (int g = 0; g < n; g += 32) {
          const int e = g + lane;
          const int nm = e < n ? cn[e] : -1;
          const int a = e < n ? cu[e] : 0, b = e < n ? cv[e] : 0;
          int code = kNoLoad;
          if (nm >= 0) {
            const bool fu = (fw[a >> 5] >> (a & 31)) & 1u;
            const bool fv = (fw[b >> 5] >> (b & 31)) & 1u;
            code = !fu ? (fv ? a : nm) : (!fv ? b : kBoth);
          }
          if (!__any_sync(kFull, code == kBoth)) {
            if (code >= 0) atomicAdd(&loads[code], 1);
            __syncwarp();
            bool cross = false;
            for (int p = lane; p < k; p += 32)
              cross |= !((fw[p >> 5] >> (p & 31)) & 1u) &&
                       is_full(loads[p], lmax);
            if (!__any_sync(kFull, cross)) {
              least.added(code, code >= 0);
              if (e < n) co[e] = max(code, 0);
              continue;
            }
            if (code >= 0) atomicSub(&loads[code], 1);
            __syncwarp();
          }
          int mine = 0;
          for (int j = 0; j < min(32, n - g); ++j) {
            const int nj = __shfl_sync(kFull, nm, j);
            const int aj = __shfl_sync(kFull, a, j);
            const int bj = __shfl_sync(kFull, b, j);
            int p = 0;
            if (nj >= 0) {
              const bool fu = (fw[aj >> 5] >> (aj & 31)) & 1u;
              const bool fv = (fw[bj >> 5] >> (bj & 31)) & 1u;
              if (fu && fv) {
                p = least.take(loads, k, lane);
              } else {
                p = !fu ? (fv ? aj : nj) : bj;
                least.added(p, lane == 0);
              }
              if (lane == 0) {
                const int now = ++loads[p];
                if (is_full(now, lmax) && !is_full(now - 1, lmax))
                  fw[p >> 5] |= 1u << (p & 31);
              }
              __syncwarp();
            }
            mine = lane == j ? p : mine;
          }
          if (e < n) co[e] = mine;
        }
        if (lane == 0) {
          cnt[kExact] += 1;
          cnt[kExactEdges] += n;
        }
      }
    }
    __syncthreads();

    // -------- write the chunk's choices; refresh F after a walk
    for (int i = tid; i < n; i += kThreads) out[base + i] = max(co[i], 0);
    for (int p = tid; p < k; p += kThreads) whist[p] = 0;
    if (tid == 0) {   // every thread has read nb by the barrier above
      cnt[kBothEdges] += nb;
      *nboth = 0;
    }
    if (fill || nb) {
      for (int q = warp; q < R; q += kWarps) {
        const int p = q * 32 + lane;
        const unsigned f =
            __ballot_sync(kFull, p < k && is_full(loads[p], lmax));
        if (lane == 0) fw[q] = f;
      }
    }
    __syncthreads();
  }
  if (tid < kStats) stats[tid] = cnt[tid];
}

template <int R>
int launch(const int* pu, const int* pv, const int* normal,
           const int* loads0, int* out, long long* stats, long long E, int k,
           float lmax, cudaStream_t stream) {
  const size_t smem = sizeof(long long) * kStatsPad +
                      sizeof(int) * (7 * (size_t)kChunk + 2 * (size_t)k +
                                     (size_t)kWarps * k + R + 1);
  cudaError_t e = cudaFuncSetAttribute(
      transform_scan_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  transform_scan_kernel<R><<<1, kThreads, smem, stream>>>(
      pu, pv, normal, loads0, E, k, lmax, out, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// k <= 1024 (kernels/transform_scan.py MAX_K); pu, pv and normal 16-byte
// aligned; loads0 is null (zero loads) or k non-negative counts whose sum
// with E fits int32; stats has kStats int64 slots.
extern "C" int t_transform_scan(const int* pu, const int* pv,
                                const int* normal, const int* loads0,
                                int* out, long long* stats, int E, int k,
                                float lmax, cudaStream_t stream) {
  if (E <= 0) return 0;
  if (k <= 64)
    return launch<2>(pu, pv, normal, loads0, out, stats, E, k, lmax, stream);
  if (k <= 256)
    return launch<8>(pu, pv, normal, loads0, out, stats, E, k, lmax, stream);
  return launch<32>(pu, pv, normal, loads0, out, stats, E, k, lmax, stream);
}
