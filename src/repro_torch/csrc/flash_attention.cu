// K4 — flash attention (causal or not, GQA), the prefill attention of the
// LM stack and the cross-attention of the encoder-decoder's decode.
//
// Replaces: src/repro/kernels/flash_attention.py:70, flash_attention (the
// Pallas kernel _flash_kernel).  o[b,h] = softmax(q[b,h]·k[b,h/g]^T·scale
// + mask)·v[b,h/g] with g = Hq/Hkv, by online softmax: f32 running max m,
// sum l and accumulator acc; masked scores are -1e30, l is clamped at
// 1e-20, and the output is written in q's dtype.  q and k rows have DQK
// elements, v and o rows DV: DQK = DV in 32, 64, 128, 160 (GQA; 160 is
// pixtral's head), or the MLA pair DQK 192 (nope 128 + rope 64), DV 128
// (the reference computes that attention with chunked_attention, the
// plain form of the same kernel).
//
// What bounds it on the H100: tensor-core operations.  At the serving
// prefill shape (B=4, Hq=28, Hkv=4, S=2048, D=128, causal) the unmasked
// (q, k) pairs need 4·D FLOP each, about 1.2e11 FLOP, 0.12 ms at the
// 989 TFLOP/s bf16 dense peak, while q, k, v and o are 134 MB, 0.04 ms at
// 3.35 TB/s.  Only wgmma reaches the tensor cores' rate on Hopper, and it
// needs its operands in shared memory ahead of time.
//
// bf16 design (Hopper: TMA, mbarriers, wgmma, setmaxnreg).  The TPU grid
// walks the KV blocks in order with m, l, acc in VMEM scratch; here one
// CTA of 384 threads owns a 128-row q tile of one (b, h) and loops over the
// KV tiles (128 rows; 64 at DV 160) itself, so the softmax state never
// leaves registers:
// - warp 8 is the producer: its warpgroup (warps 8-11) gives registers up
//   (setmaxnreg.dec; the pool that setmaxnreg.inc draws from is only what
//   the CTA's own warps released), and one lane loads the Q tile once and
//   K, V tiles into a ring of STAGES shared-memory stages with TMA
//   (cp.async.bulk.tensor), each completing on its stage's "full"
//   mbarrier; a stage is refilled once the 8 consumer warps have arrived
//   on its "empty" mbarrier;
// - warps 0-7 are two consumer warpgroups (setmaxnreg.inc) of 64 q rows
//   each.  Per KV tile: S = Q·K^T on wgmma m64n128k16 with both operands
//   in shared memory (K-major); the f32 scores are scaled, masked and
//   turned into p by the online softmax in registers; p is rounded to bf16
//   and the accumulator fragments of S become the A fragments of P in
//   registers (the two layouts coincide); O += P·V on wgmma m64nDk16 with
//   A from registers and V from shared memory as an MN-major operand (the
//   descriptor's transpose bit), so V is never transposed.  The two
//   warpgroups run independently, so one's softmax can overlap the
//   other's products; a warpgroup's own softmax does not overlap its
//   products (each waits for its wgmma group before going on).
// - TMA writes each tile with the 128-byte swizzle in panels of 64
//   head-dim columns (with the 64-byte swizzle in panels of 32 for D = 32
//   and 160, which are no whole number of 64-column panels), and the
//   wgmma descriptors name the same swizzle; rows past Sq / Skv are
//   zero-filled by TMA, KV rows past Skv are masked, q rows past Sq are
//   not stored.
// - The loop ends at the diagonal when causal (the TPU kernel's skip of
//   fully masked blocks); the grid runs the tiles with the most KV tiles
//   first over all heads (the tile index is the slowest grid dimension).
// - GQA: the KV head is h / g (any g); K/V are never expanded.  The tensor
//   maps describe the (B, S, H, D) activations through their strides, as
//   dims (D, S, H, B), so the model's transposed views are read in place.
// The scale multiplies the f32 scores (the TPU kernel scales q in f32
// before the product: the two differ by rounding only); p is rounded to
// bf16 before P·V (the TPU kernel keeps it in f32) while l sums the f32 p.
//
// Training: where the caller passes an lse buffer (f32, (B, Hq, Sq),
// contiguous), each kernel's epilogue also writes the row's log-sum-exp of
// the scaled scores, m + log(l) in natural units, from the final running
// max and sum (the bf16 kernel's m is in log2 units: (m + log2 l)·ln 2).
// The backward (flash_attention_bwd.cu in bf16, tensor code in
// kernels/flash_attention.py in f32; the TPU kernel has no backward)
// recomputes p = exp(s·scale − lse) from it.  The serving
// path passes a null pointer and runs the instantiation without the
// write (the LSE template flag), the kernel as it was; the main loop is the
// same in both.
//
// f32 inputs take a plain FMA path with no TF32 (kept exact enough for
// the 2e-3 prefill-vs-decode check): a CTA of 4 warps owns 16 q rows, one
// lane per KV column for the scores and one lane per output column for P·V.
//
// At DQK 192, DV 128 (MLA) the same bf16 design walks three 64-column
// panels in Q·K^T (12 k16 steps, not 8) and keeps P·V and the accumulator
// at 128 columns; K and V stages have their own sizes (48 and 32 KB), so
// Q and a two-stage ring fill 208 KB, one CTA an SM as at D = 128.
//
// At DQK = DV = 160 (no whole number of 64-column panels) every tile is
// stored as five 32-column panels with the 64-byte swizzle, as D = 32's
// one panel is: Q·K^T walks 10 k16 steps over them, and P·V is one
// m64n128k16 over the first four panels (the MN-major descriptor's LBO
// steps from one 32-column panel to the next, as it steps 64-column
// panels under the 128-byte swizzle) plus one m64n32k16 over the fifth
// into accumulator columns 128-159.  The accumulator grows to 80 f32 a
// thread; ptxas allocates the consumers' registers within the launch's
// 168 a thread (setmaxnreg moves only the physical pool), where 80 + 64
// scores of a 128-row KV tile spilled, so the KV tiles are 64 rows here
// (Q·K^T on m64n64k16, 32 scores a thread; p is rounded against the
// running max of a 64-row tile).  Q (40 KB) and two stages of K and V
// (20 KB each) fill 120 KB.
#include "common.cuh"
#include "hopper.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

// ------------------------------------------------------------------- bf16

constexpr int BQ = 128;       // q rows per CTA: two warpgroups of 64
// two consumer warpgroups and a producer warpgroup, of which one warp
// issues the loads and all four hand their registers to the consumers:
// 128 x (168 - 24) registers released = 256 x (240 - 168) taken
constexpr int THREADS = 384;
constexpr int CONSUMER_WARPS = 8;
constexpr int STAGES = 2;     // the K/V ring

template <int DQK, int DV>
struct Tiles {
  static constexpr int PW = panel_width(DQK);
  static_assert(panel_width(DV) == PW, "q/k and v tiles share one swizzle");
  static constexpr int ROWB = 2 * PW;           // bytes of one panel row
  static constexpr int KPP = PW / 16;           // k16 steps per panel
  static constexpr int LAYOUT = PW == 64 ? 1 : 2;  // wgmma: B128 / B64
  // KV rows a tile: 128, or 64 at DV 160, whose accumulator leaves no
  // room for 64 scores a thread (see the note above)
  static constexpr int BKV = DV > 128 ? 64 : 128;
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int K_BYTES = BKV * DQK * 2;
  static constexpr int V_BYTES = BKV * DV * 2;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * (K_BYTES + V_BYTES);
  // + 1024: the base is rounded up to the swizzle atom's alignment
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
  // one CTA an SM: at (192, 128) Q 48 KB + 2 x (48 + 32) KB = 208 KB
  static_assert(SMEM <= 227 * 1024, "above a block's shared memory");
};

template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tmq,
                  const __grid_constant__ CUtensorMap tmk,
                  const __grid_constant__ CUtensorMap tmv,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                  int group, int Sq, int Skv, int causal, float scale,
                  Layout lo) {
  using T = Tiles<DQK, DV>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;             // + stage * K_BYTES
  const uint32_t sV = sK + STAGES * T::K_BYTES;    // + stage * V_BYTES
  const uint32_t q_full = sQ + T::BAR_OFF;
  // k_full[s] = q_full + 8 (1 + s), v_full[s] = q_full + 8 (1 + STAGES + s),
  // empty[s] = q_full + 8 (1 + 2 STAGES + s)
  auto k_full = [&](int s) { return q_full + 8u * (1 + s); };
  auto v_full = [&](int s) { return q_full + 8u * (1 + STAGES + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;  // longest tiles first
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  const int n_kv = (kv_end + T::BKV - 1) / T::BKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (warp == CONSUMER_WARPS && lane == 0) {
      const int hk = h / group;
      // each barrier expects exactly the bytes of its own boxes (rows past
      // S are zero-filled and still counted); a wrong count never completes
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int p = 0; p < DQK / T::PW; ++p)
        tma_load(sQ + p * BQ * T::ROWB, &tmq, q_full, p * T::PW, q0, h, b);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(k_full(s), T::K_BYTES);
#pragma unroll
        for (int p = 0; p < DQK / T::PW; ++p)
          tma_load(sK + s * T::K_BYTES + p * T::BKV * T::ROWB, &tmk,
                   k_full(s), p * T::PW, i * T::BKV, hk, b);
        mbar_expect_tx(v_full(s), T::V_BYTES);
#pragma unroll
        for (int p = 0; p < DV / T::PW; ++p)
          tma_load(sV + s * T::V_BYTES + p * T::BKV * T::ROWB, &tmv,
                   v_full(s), p * T::PW, i * T::BKV, hk, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = warp >> 2;
    const int row0 = q0 + wg * 64 + (warp & 3) * 16;  // this warp's rows
    const int ra = row0 + (lane >> 2);                // rows ra and ra + 8
    const float scale2 = scale * LOG2E;  // scores in log2 units: exp2 below
    const uint32_t qa = sQ + wg * 64 * T::ROWB;  // this warpgroup's Q rows

    float acc[DV / 2];  // O: 64 x DV over the warpgroup's 128 threads
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF};  // rows ra and ra + 8, log2 units
    float l[2] = {0.f, 0.f};          // this lane's share of the row sums

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % STAGES;
      const uint32_t ph = (i / STAGES) & 1;
      const int kv0 = i * T::BKV;

      // S = Q·K^T (64 x BKV), both operands K-major in shared memory, over
      // the DQK / PW panels (3 at DQK 192, 5 at 160)
      float sc[T::BKV / 2];
      mbar_wait(k_full(s), ph);
      const uint32_t kb = sK + s * T::K_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t koff = (kk % T::KPP) * 32;
        const uint64_t da = make_desc(
            qa + (kk / T::KPP) * BQ * T::ROWB + koff, 16, 8 * T::ROWB,
            T::LAYOUT);
        const uint64_t db = make_desc(
            kb + (kk / T::KPP) * T::BKV * T::ROWB + koff, 16, 8 * T::ROWB,
            T::LAYOUT);
        wgmma_ss<T::BKV>(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(sc);

      // online softmax on the accumulator fragments: element 4n + e is
      // row ra + 8 (e >> 1), column kv0 + 8n + 2 (lane & 3) + (e & 1)
      const bool edge =
          kv0 + T::BKV > Skv || (causal && kv0 + T::BKV - 1 > row0);
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < T::BKV / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e] * scale2;
          if (edge) {
            const int col = kv0 + n * 8 + 2 * (lane & 3) + (e & 1);
            const int row = ra + (e >> 1) * 8;
            if (col >= Skv || (causal && col > row)) x = NEG_INF;
          }
          sc[4 * n + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      // P's A fragments: columns 16kk.. of rows ra, ra + 8 are accumulator
      // chunks 2kk and 2kk + 1, packed to bf16 pairs
      uint32_t pa[T::BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < T::BKV / 16; ++kk) {
        float p[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          p[j] = exp2f(sc[8 * kk + j] - m[(j >> 1) & 1]);
          l[(j >> 1) & 1] += p[j];
        }
        pa[kk][0] = pack_bf16(p[0], p[1]);
        pa[kk][1] = pack_bf16(p[2], p[3]);
        pa[kk][2] = pack_bf16(p[4], p[5]);
        pa[kk][3] = pack_bf16(p[6], p[7]);
      }
#pragma unroll
      for (int n = 0; n < DV / 8; ++n) {
        acc[4 * n + 0] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }

      // O += P·V: V (BKV x DV) is the MN-major B operand; LBO steps from
      // one panel to the next, SBO from 8 KV rows to the next
      mbar_wait(v_full(s), ph);
      const uint32_t vb = sV + s * T::V_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < T::BKV / 16; ++kk) {
        const uint64_t db = make_desc(vb + kk * 16 * T::ROWB,
                                      T::BKV * T::ROWB, 8 * T::ROWB,
                                      T::LAYOUT);
        wgmma_rs<DV, T::BKV>(acc, pa[kk], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc);
      reg_fence(pa);
      if (lane == 0) mbar_arrive(empty(s));  // this warp is done with s
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-20f);
    }
    __nv_bfloat16* ob = o + (size_t)b * lo.sb + (size_t)h * lo.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + r * 8;
      if (row >= Sq) continue;
      // the row's log-sum-exp of the scaled scores (natural log), for the
      // backward: m is in log2 units, and every lane of the quad holds the
      // row's m and l
      if constexpr (LSE) {
        if ((lane & 3) == 0)
          lse[((size_t)b * gridDim.x + h) * Sq + row] =
              (m[r] + log2f(fmaxf(l[r], 1e-20f))) * LN2;
      }
      __nv_bfloat16* orow = ob + (size_t)row * lo.ss + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < DV / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8) =
            pack_bf16(acc[4 * n + 2 * r] * inv[r],
                      acc[4 * n + 2 * r + 1] * inv[r]);
    }
  }
}

// -------------------------------------------------------------------- f32

// the f32 tile sizes: q rows a CTA, KV rows a step (one per lane)
constexpr int F32_BQ = 16, F32_BKV = 32;

// shared memory of the f32 kernel: Q, K (rows padded by one), V; dynamic,
// since at (192, 128) it is 53,376 bytes, above the 48 KB of a static array
template <int DQK, int DV>
constexpr int f32_smem() {
  return 4 * (F32_BQ * DQK + F32_BKV * (DQK + 1) + F32_BKV * DV);
}

template <int DQK, int DV, bool LSE>
__global__ void __launch_bounds__(128)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int group, int Sq, int Skv,
                 int causal, float scale,
                 Layout lq, Layout lk, Layout lv, Layout lo) {
  constexpr int BQ = F32_BQ, BKV = F32_BKV, RW = BQ / 4, DL = DV / 32;
  extern __shared__ __align__(16) float smem_f32[];
  float* sQ = smem_f32;                 // BQ x DQK
  float* sK = sQ + BQ * DQK;            // BKV x (DQK + 1): lane j reads row j
  float* sV = sK + BKV * (DQK + 1);     // BKV x DV

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = q + (size_t)b * lq.sb + (size_t)h * lq.sh;
  const float* kb = k + (size_t)b * lk.sb + (size_t)hk * lk.sh;
  const float* vb = v + (size_t)b * lv.sb + (size_t)hk * lv.sh;

  for (int i = threadIdx.x; i < BQ * DQK; i += blockDim.x) {
    const int r = tile * BQ + i / DQK;
    // q scaled in f32 before the product, as the TPU kernel does
    sQ[i] = r < Sq ? qb[(size_t)r * lq.ss + i % DQK] * scale : 0.f;
  }

  float acc[RW][DL], m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[r][i] = 0.f;
  }

  const int kv_end = causal ? min(Skv, tile * BQ + BQ) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();
    for (int i = threadIdx.x; i < BKV * DQK; i += blockDim.x) {
      const int r = i / DQK, c = i % DQK;
      sK[r * (DQK + 1) + c] =
          kv0 + r < Skv ? kb[(size_t)(kv0 + r) * lk.ss + c] : 0.f;
    }
    for (int i = threadIdx.x; i < BKV * DV; i += blockDim.x) {
      const int r = i / DV, c = i % DV;
      sV[i] = kv0 + r < Skv ? vb[(size_t)(kv0 + r) * lv.ss + c] : 0.f;
    }
    __syncthreads();

    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float* kr = sK + lane * (DQK + 1);
    const float* qr = sQ + warp * RW * DQK;
    for (int d = 0; d < DQK; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = fmaf(qr[r * DQK + d], kd, s[r]);
    }
    const int col = kv0 + lane;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      const int row = tile * BQ + warp * RW + r;
      if (col >= Skv || (causal && col > row)) s[r] = NEG_INF;
      float mx = s[r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float p = expf(s[r] - m_new);
      float ps = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
      float pv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) pv[i] = 0.f;
      for (int j = 0; j < BKV; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DL; ++i)
          pv[i] = fmaf(pj, sV[j * DV + lane + 32 * i], pv[i]);
      }
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[r][i] = fmaf(acc[r][i], alpha, pv[i]);
    }
  }

  float* ob = o + (size_t)b * lo.sb + (size_t)h * lo.sh;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const int row = tile * BQ + warp * RW + r;
    if (row >= Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    if constexpr (LSE) {
      if (lane == 0)                    // every lane holds the row's m, l
        lse[((size_t)b * gridDim.y + h) * Sq + row] =
            m[r] + logf(fmaxf(l[r], 1e-20f));
    }
#pragma unroll
    for (int i = 0; i < DL; ++i)
      ob[(size_t)row * lo.ss + lane + 32 * i] = acc[r][i] * inv;
  }
}

// --------------------------------------------------------------- launches

// one instantiation of the bf16 kernel: with the log-sum-exp output or
// without it (the serving path's, the kernel as it was before training)
template <int DQK, int DV, bool LSE>
int run_bf16(dim3 grid, const CUtensorMap& mq, const CUtensorMap& mk,
             const CUtensorMap& mv, __nv_bfloat16* o, float* lse, int group,
             int Sq, int Skv, int causal, float scale, Layout lo,
             cudaStream_t stream) {
  constexpr int smem = Tiles<DQK, DV>::SMEM;
  static bool sized = false;  // above 48 KB shared memory must be asked for
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_bf16_kernel<DQK, DV, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  flash_bf16_kernel<DQK, DV, LSE><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, o, lse, group, Sq, Skv, causal, scale, lo);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B,
                int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
                Layout lq, Layout lk, Layout lv, Layout lo,
                cudaStream_t stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  CUtensorMap mq, mk, mv;
  constexpr int ROWS = Tiles<DQK, DV>::BKV;
  int err = encode<DQK, BQ>(&mq, q, B, Hq, Sq, lq);
  if (err == 0) err = encode<DQK, ROWS>(&mk, k, B, Hkv, Skv, lk);
  if (err == 0) err = encode<DV, ROWS>(&mv, v, B, Hkv, Skv, lv);
  if (err != 0) return err;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  return lse != nullptr
             ? run_bf16<DQK, DV, true>(grid, mq, mk, mv, o, lse, Hq / Hkv, Sq,
                                       Skv, causal, scale, lo, stream)
             : run_bf16<DQK, DV, false>(grid, mq, mk, mv, o, lse, Hq / Hkv,
                                        Sq, Skv, causal, scale, lo, stream);
}

template <int DQK, int DV, bool LSE>
int run_f32(dim3 grid, const float* q, const float* k, const float* v,
            float* o, float* lse, int group, int Sq, int Skv, int causal,
            float scale, Layout lq, Layout lk, Layout lv, Layout lo,
            cudaStream_t stream) {
  constexpr int smem = f32_smem<DQK, DV>();
  static bool sized = false;
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_f32_kernel<DQK, DV, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  flash_f32_kernel<DQK, DV, LSE><<<grid, 128, smem, stream>>>(
      q, k, v, o, lse, group, Sq, Skv, causal, scale, lq, lk, lv, lo);
  return (int)cudaGetLastError();
}

template <int DQK, int DV>
int launch_f32(const float* q, const float* k, const float* v, float* o,
               float* lse, int B, int Hq, int Hkv, int Sq, int Skv, int causal,
               float scale, Layout lq, Layout lk, Layout lv, Layout lo,
               cudaStream_t stream) {
  if (B <= 0 || Hq <= 0 || Sq <= 0) return (int)cudaGetLastError();
  const dim3 grid((Sq + F32_BQ - 1) / F32_BQ, Hq, B);
  return lse != nullptr
             ? run_f32<DQK, DV, true>(grid, q, k, v, o, lse, Hq / Hkv, Sq,
                                      Skv, causal, scale, lq, lk, lv, lo,
                                      stream)
             : run_f32<DQK, DV, false>(grid, q, k, v, o, lse, Hq / Hkv, Sq,
                                       Skv, causal, scale, lq, lk, lv, lo,
                                       stream);
}

// the (DQK, DV) pairs K4 is built for: GQA's 32, 64, 128, 160 and MLA's
// (192, 128); f(Dim<DQK>, Dim<DV>) launches one of them
template <class F>
int dispatch_dims(int D, int Dv, F&& f) {
  if (D == 32 && Dv == 32) return f(Dim<32>{}, Dim<32>{});
  if (D == 64 && Dv == 64) return f(Dim<64>{}, Dim<64>{});
  if (D == 128 && Dv == 128) return f(Dim<128>{}, Dim<128>{});
  if (D == 160 && Dv == 160) return f(Dim<160>{}, Dim<160>{});
  if (D == 192 && Dv == 128) return f(Dim<192>{}, Dim<128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

#define K4_ENTRY(NAME, T, LAUNCH)                                            \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* o, float* lse,  \
                      int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv,\
                      int causal, float scale, int qsb, int qsh, int qss,    \
                      int ksb, int ksh, int kss, int vsb, int vsh, int vss,  \
                      int osb, int osh, int oss, cudaStream_t stream) {      \
    const Layout lq{qsb, qsh, qss}, lk{ksb, ksh, kss}, lv{vsb, vsh, vss},    \
        lo{osb, osh, oss};                                                   \
    return dispatch_dims(D, Dv, [&](auto dqk, auto dv) {                     \
      return LAUNCH<decltype(dqk)::value, decltype(dv)::value>(              \
          q, k, v, o, lse, B, Hq, Hkv, Sq, Skv, causal, scale, lq, lk, lv,   \
          lo, stream);                                                       \
    });                                                                      \
  }

K4_ENTRY(k4_flash_attention_bf16, __nv_bfloat16, launch_bf16)
K4_ENTRY(k4_flash_attention_f32, float, launch_f32)
