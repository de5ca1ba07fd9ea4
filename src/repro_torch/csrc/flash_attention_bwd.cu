// K4's backward — the gradient of flash attention (causal or not, GQA) with
// respect to q, k and v, in bf16, for training.
//
// Replaces no TPU kernel: the Pallas kernel (src/repro/kernels/
// flash_attention.py:70) has no backward, and the reference differentiates
// chunked_attention (src/repro/models/attention.py:62) by autodiff.  This
// computes what kernels/flash_attention.py's flash_attention_backward_plain
// computes, given the forward's output o and the rows' log-sum-exp lse
// (natural log, f32 (B, Hq, Sq)) and the output's gradient dO:
//   P  = exp(S·scale − lse)            S = Q·K^T
//   dV = P^T·dO                        dP = dO·V^T
//   dS = P ∘ (dP − rowsum(dO ∘ O))
//   dQ = scale·dS·K                    dK = scale·dS^T·Q
// with the q heads of a GQA group summed into their KV head's dK and dV.
// P and dS are rounded to bf16 before the products that read them (the
// plain version's round_dtype=torch.bfloat16 does the same); every sum is
// f32; dq, dk, dv are written in bf16.
//
// What bounds it on the H100: tensor-core operations.  At stablelm-1.6b's
// training shape (B 8, H 32, S 2048, D 64, causal) the five products need
// 10·D FLOP a unmasked (q, k) pair, 3.4e11 FLOP, 0.35 ms at 989 TFLOP/s,
// while q, k, v, o, dO, lse and the three gradients are 0.54 GB, 0.16 ms.
//
// Design.  Three launches on the caller's stream:
// 1. prep: one warp a q row reads O and dO once and writes
//    delta = rowsum(dO ∘ O) and lse·log2(e), f32, into a scratch buffer of
//    (B·Hq, 2, Sq_pad) (Sq_pad: Sq rounded up to 128; pad rows are 0), so
//    the main kernels take both by aligned bulk copies or plain loads.
// 2. dkdv: one CTA owns one (b, KV head, 128-row KV tile), walks every q
//    tile (BQ rows, 64 or 32: see Head dims) of its group's g heads (from
//    the diagonal when causal) and keeps dK and dV in registers across
//    all of them: no atomics, no second pass.  Its 256 threads are two warpgroups of 64 KV rows each;
//    thread 0 also loads: the K and V tiles once, then Q and dO tiles with
//    TMA and the tiles' lse/delta with bulk copies into a ring of STAGES
//    (mbarrier full/empty pairs, as the forward's ring), refilling a stage
//    one step after every warp has left it.  The products are transposed
//    so that P and dS come out in the layout of an A operand: S^T = K·Q^T
//    and dP^T = V·dO^T on wgmma with both operands K-major in shared
//    memory; P^T and dS^T are formed on the accumulator fragments (lse and
//    delta run along their columns, so they are read from the stage in
//    shared memory), packed to bf16 and fed from registers to
//    dV += P^T·dO and dK += dS^T·Q, with dO and Q as MN-major B operands
//    (the descriptor's transpose bit): the coincidence of the accumulator
//    and A-fragment layouts that the forward's P·V uses.
// 3. dq: one CTA owns one (b, q head, 128-row q tile), keeps Q and dO in
//    shared memory and walks KV tiles of QBKV rows (to the diagonal when
//    causal): warps 0-7 are two consumer warpgroups of 64 q rows, warp 8
//    loads the K/V ring.  S = Q·K^T and dP = dO·V^T, P and dS on the
//    fragments (lse and delta are per row here: two of each a thread, from
//    the scratch buffer), and dQ += dS·K with dS from registers and K as
//    the MN-major operand.  This recomputes S and dP (7 products in all
//    against the 5 the bound counts) instead of adding dQ into an f32
//    accumulator from the dkdv CTAs: those would be B·Hq·Sq·D·(KV tiles a
//    row) f32 atomics, about 2.9e8 at stablelm's shape, plus a zeroing pass
//    and a conversion pass; here every gradient is written once, in bf16,
//    in a fixed order.
// Registers: ptxas budgets a 288-thread block as if it had 384 threads
// (168 a thread) whatever setmaxnreg says (see flash_attention.cu), so the
// dkdv kernel, whose warpgroups hold dK and dV (64 x D f32 each) beside
// the S^T and dP^T tiles (64 x BQ), runs 256 threads and no producer warp:
// 231 registers a thread at D = 128, no spills.  The dq kernel (dQ and two
// 64 x QBKV tiles) fits in 168 with its producer warp.  The grids run the
// longest CTAs first: KV tile 0 sees every q tile; the last q tile sees
// every KV tile.
//
// Head dims: (32, 32), (64, 64), (128, 128) with 64-row q steps in dkdv
// and 64-row KV steps in dq; (160, 160) (pixtral) and (192, 128) (MLA)
// with 32-row steps in both.  At those pairs dK and dV alone take
// DQK/2 + DV/2 = 160 registers a thread, which leaves no room for two
// 64 x 64 tiles (64 more) within 255; 64 x 32 tiles take 32, and the dq
// kernel's dQ (96 at D 192) beside two 64 x 32 tiles stays within its
// 168.  The narrower steps halve each wgmma's N (32) and double the
// steps, so they cost time, not bytes: the tiles are read from L2.
#include "common.cuh"
#include "hopper.cuh"  // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

constexpr int THREADS = 288;       // dq: warps 0-7 consume, warp 8 loads
constexpr int DKDV_THREADS = 256;  // dkdv: two warpgroups, thread 0 loads
constexpr int CONSUMER_WARPS = 8;
constexpr int PAD = 128;           // Sq_pad: Sq rounded up to this

template <int DQK, int DV>
struct Bwd {
  // 32-row steps where dK and dV take 160 registers (see the header)
  static constexpr int STEP = DQK + DV > 256 ? 32 : 64;
  static constexpr int PW = panel_width(DQK);
  static_assert(panel_width(DV) == PW, "q/k and v tiles share one swizzle");
  static constexpr int ROWB = 2 * PW;             // bytes of one panel row
  static constexpr int KPP = PW / 16;             // k16 steps per panel
  static constexpr int LAYOUT = PW == 64 ? 1 : 2;  // wgmma: B128 / B64

  // dkdv: 128 KV rows a CTA, BQ q rows a step, a ring of STAGES steps
  static constexpr int KV_ROWS = 128;
  static constexpr int BQ = STEP;
  static constexpr int STAGES = 4;
  static constexpr int K_BYTES = KV_ROWS * DQK * 2;
  static constexpr int V_BYTES = KV_ROWS * DV * 2;
  static constexpr int Q_BYTES = BQ * DQK * 2;
  static constexpr int DO_BYTES = BQ * DV * 2;
  static constexpr int STAT_BYTES = 2 * BQ * 4;   // lse·log2(e), delta
  // sK | sV | sQ[STAGES] | sDO[STAGES] | stats[STAGES] | barriers; every
  // tile starts on a 1024-byte boundary (the swizzle atom)
  static constexpr int Q_OFF = K_BYTES + V_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * Q_BYTES;
  static constexpr int STAT_OFF = DO_OFF + STAGES * DO_BYTES;
  static constexpr int BAR_OFF = STAT_OFF + STAGES * STAT_BYTES;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(SMEM <= 227 * 1024, "above a block's shared memory");

  // dq: 128 q rows a CTA (a warpgroup each 64), QBKV KV rows a step
  static constexpr int QROWS = 128;
  static constexpr int QBKV = STEP;
  static constexpr int QSTAGES = 2;
  static constexpr int QQ_BYTES = QROWS * DQK * 2;
  static constexpr int QDO_BYTES = QROWS * DV * 2;
  static constexpr int QK_BYTES = QBKV * DQK * 2;
  static constexpr int QV_BYTES = QBKV * DV * 2;
  static constexpr int QK_OFF = QQ_BYTES + QDO_BYTES;
  static constexpr int QV_OFF = QK_OFF + QSTAGES * QK_BYTES;
  static constexpr int QBAR_OFF = QV_OFF + QSTAGES * QV_BYTES;
  static constexpr int QSMEM = QBAR_OFF + 8 * (1 + 2 * QSTAGES) + 1024;
  static_assert(QSMEM <= 227 * 1024, "above a block's shared memory");
};

// ------------------------------------------------------------------ prep

// one warp a row of (B·Hq, Sq_pad): stats[bh][0][i] = lse·log2(e),
// stats[bh][1][i] = Σ dO∘O (f32), zero on pad rows
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const __nv_bfloat16* __restrict__ o,
                const __nv_bfloat16* __restrict__ dO,
                const float* __restrict__ lse, float* __restrict__ stats,
                int Hq, int Sq, int Sq_pad, int Dv, int rows, Layout lo,
                Layout ld) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= rows) return;
  const int bh = r / Sq_pad, i = r % Sq_pad, b = bh / Hq, h = bh % Hq;
  float acc = 0.f;
  if (i < Sq) {
    const __nv_bfloat16* orow =
        o + (size_t)b * lo.sb + (size_t)h * lo.sh + (size_t)i * lo.ss;
    const __nv_bfloat16* drow =
        dO + (size_t)b * ld.sb + (size_t)h * ld.sh + (size_t)i * ld.ss;
    for (int c = 2 * lane; c < Dv; c += 64) {
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(orow + c));
      const float2 d = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(drow + c));
      acc = fmaf(a.x, d.x, fmaf(a.y, d.y, acc));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    float* s = stats + (size_t)bh * 2 * Sq_pad + i;
    s[0] = i < Sq ? lse[(size_t)bh * Sq + i] * LOG2E : 0.f;
    s[Sq_pad] = acc;
  }
}

// ------------------------------------------------------------------ dkdv

template <int DQK, int DV>
__global__ void __launch_bounds__(DKDV_THREADS, 1)
bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tmq,
                const __grid_constant__ CUtensorMap tmk,
                const __grid_constant__ CUtensorMap tmv,
                const __grid_constant__ CUtensorMap tmdo,
                const float* __restrict__ stats, __nv_bfloat16* __restrict__ dk,
                __nv_bfloat16* __restrict__ dv, int group, int Sq, int Skv,
                int Sq_pad, int causal, float scale, Layout lk, Layout lv) {
  using T = Bwd<DQK, DV>;
  constexpr int BQ = T::BQ, STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t sK = base, sV = base + T::K_BYTES;
  const uint32_t sQ = base + T::Q_OFF, sDO = base + T::DO_OFF;
  const uint32_t kv_full = base + T::BAR_OFF;
  auto full = [&](int s) { return kv_full + 8u * (1 + s); };
  auto empty = [&](int s) { return kv_full + 8u * (1 + STAGES + s); };

  const int hk = blockIdx.x, b = blockIdx.y, kv0 = blockIdx.z * T::KV_ROWS;
  const int Hq = gridDim.x * group;
  const int n_qt = (Sq + BQ - 1) / BQ;
  // causal: q tiles that lie wholly before the KV tile see none of it
  const int qt0 = causal ? min(kv0 / BQ, n_qt) : 0;
  const int per_head = n_qt - qt0, n_steps = group * per_head;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 also loads: the K and V tiles once, the first STAGES steps,
  // then each step's stage again once every warp is done with it
  auto issue = [&](int i) {          // step i's tiles into stage i % STAGES
    const int s = i % STAGES;
    const int h = hk * group + i / per_head;
    const int q0 = (qt0 + i % per_head) * BQ;
    mbar_expect_tx(full(s), T::Q_BYTES + T::DO_BYTES + T::STAT_BYTES);
#pragma unroll
    for (int p = 0; p < DQK / T::PW; ++p)
      tma_load(sQ + s * T::Q_BYTES + p * BQ * T::ROWB, &tmq, full(s),
               p * T::PW, q0, h, b);
#pragma unroll
    for (int p = 0; p < DV / T::PW; ++p)
      tma_load(sDO + s * T::DO_BYTES + p * BQ * T::ROWB, &tmdo, full(s),
               p * T::PW, q0, h, b);
    const float* st = stats + ((size_t)b * Hq + h) * 2 * Sq_pad + q0;
    const uint32_t dst = base + T::STAT_OFF + s * T::STAT_BYTES;
    bulk_load(dst, st, BQ * 4, full(s));
    bulk_load(dst + BQ * 4, st + Sq_pad, BQ * 4, full(s));
  };
  if (threadIdx.x == 0 && n_steps > 0) {
    mbar_expect_tx(kv_full, T::K_BYTES + T::V_BYTES);
#pragma unroll
    for (int p = 0; p < DQK / T::PW; ++p)
      tma_load(sK + p * T::KV_ROWS * T::ROWB, &tmk, kv_full, p * T::PW, kv0,
               hk, b);
#pragma unroll
    for (int p = 0; p < DV / T::PW; ++p)
      tma_load(sV + p * T::KV_ROWS * T::ROWB, &tmv, kv_full, p * T::PW, kv0,
               hk, b);
    for (int i = 0; i < min(STAGES, n_steps); ++i) issue(i);
  }

  // ------------------------------------------------ both warpgroups consume
  const int wg = warp >> 2;
  const int kv_w = kv0 + wg * 64;                 // this warpgroup's rows
  const int kr = kv_w + (warp & 3) * 16 + (lane >> 2);  // rows kr, kr + 8
  const float scale2 = scale * LOG2E;
  const uint32_t ka = sK + wg * 64 * T::ROWB;     // A rows of S^T
  const uint32_t va = sV + wg * 64 * T::ROWB;     // A rows of dP^T

  float acc_k[DQK / 2], acc_v[DV / 2];
#pragma unroll
  for (int i = 0; i < DQK / 2; ++i) acc_k[i] = 0.f;
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc_v[i] = 0.f;

  if (n_steps > 0) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_steps; ++i) {
    const int s = i % STAGES;
    const int q0 = (qt0 + i % per_head) * BQ;
    mbar_wait(full(s), (i / STAGES) & 1);
    // causal: a q tile that ends before this warpgroup's first KV row
    // sees none of its rows (uniform over the warpgroup)
    if (!(causal && q0 + BQ - 1 < kv_w)) {
      const uint32_t qs = sQ + s * T::Q_BYTES, ds = sDO + s * T::DO_BYTES;
      const float* lse2 = reinterpret_cast<const float*>(
          base_ptr + T::STAT_OFF + s * T::STAT_BYTES);
      const float* delta = lse2 + BQ;

      // S^T = K·Q^T and dP^T = V·dO^T (64 x BQ), both operands K-major
      float st[BQ / 2], dpt[BQ / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk) {
        const uint32_t koff = (kk % T::KPP) * 32;
        const uint64_t da =
            make_desc(ka + (kk / T::KPP) * T::KV_ROWS * T::ROWB + koff, 16,
                      8 * T::ROWB, T::LAYOUT);
        const uint64_t db = make_desc(
            qs + (kk / T::KPP) * BQ * T::ROWB + koff, 16, 8 * T::ROWB,
            T::LAYOUT);
        wgmma_ss<BQ>(st, da, db, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < DV / 16; ++kk) {
        const uint32_t koff = (kk % T::KPP) * 32;
        const uint64_t da =
            make_desc(va + (kk / T::KPP) * T::KV_ROWS * T::ROWB + koff, 16,
                      8 * T::ROWB, T::LAYOUT);
        const uint64_t db = make_desc(
            ds + (kk / T::KPP) * BQ * T::ROWB + koff, 16, 8 * T::ROWB,
            T::LAYOUT);
        wgmma_ss<BQ>(dpt, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(st);
      reg_fence(dpt);

      // P^T and dS^T on the fragments: element 4n + e is KV row
      // kr + 8 (e >> 1), q column q0 + 8n + 2 (lane & 3) + (e & 1)
      const bool edge = q0 + BQ > Sq || (causal && kv_w + 63 > q0);
      uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        float p[8], d[8];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int c = 8 * (2 * kk + half) + 2 * (lane & 3);
          const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
          const float2 dl = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = 4 * half + e, idx = 8 * kk + j;
            float x = exp2f(fmaf(st[idx], scale2, (e & 1) ? -l2.y : -l2.x));
            if (edge) {
              const int col = q0 + c + (e & 1);
              const int row = kr + 8 * (e >> 1);
              if (col >= Sq || (causal && row > col)) x = 0.f;
            }
            p[j] = x;
            d[j] = x * (dpt[idx] - ((e & 1) ? dl.y : dl.x));
          }
        }
        pa[kk][0] = pack_bf16(p[0], p[1]);
        pa[kk][1] = pack_bf16(p[2], p[3]);
        pa[kk][2] = pack_bf16(p[4], p[5]);
        pa[kk][3] = pack_bf16(p[6], p[7]);
        dsa[kk][0] = pack_bf16(d[0], d[1]);
        dsa[kk][1] = pack_bf16(d[2], d[3]);
        dsa[kk][2] = pack_bf16(d[4], d[5]);
        dsa[kk][3] = pack_bf16(d[6], d[7]);
      }

      // dV += P^T·dO, dK += dS^T·Q: dO and Q (BQ x D) are MN-major B
      // operands; LBO steps a panel, SBO 8 q rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs<DV, BQ>(acc_v, pa[kk],
                         make_desc(ds + kk * 16 * T::ROWB, BQ * T::ROWB,
                                   8 * T::ROWB, T::LAYOUT));
        wgmma_rs<DQK, BQ>(acc_k, dsa[kk],
                          make_desc(qs + kk * 16 * T::ROWB, BQ * T::ROWB,
                                    8 * T::ROWB, T::LAYOUT));
      }
      wgmma_commit();
      wgmma_wait_all();
      reg_fence(acc_v);
      reg_fence(acc_k);
      reg_fence(pa);
      reg_fence(dsa);
    }
    if (lane == 0) mbar_arrive(empty(s));  // this warp is done with s
    // refill the previous step's stage once every warp has left it (one
    // step of slack between the warpgroups), STAGES - 1 steps ahead
    if (threadIdx.x == 0 && i >= 1 && i - 1 + STAGES < n_steps) {
      mbar_wait(empty((i - 1) % STAGES), ((i - 1) / STAGES) & 1);
      issue(i - 1 + STAGES);
    }
    __syncwarp();
  }

  // rows past Skv are not stored; a KV tile no q row sees writes zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = kr + 8 * r;
    if (row >= Skv) continue;
    __nv_bfloat16* vrow = dv + (size_t)b * lv.sb + (size_t)hk * lv.sh +
                          (size_t)row * lv.ss + 2 * (lane & 3);
    __nv_bfloat16* krow = dk + (size_t)b * lk.sb + (size_t)hk * lk.sh +
                          (size_t)row * lk.ss + 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<uint32_t*>(vrow + n * 8) =
          pack_bf16(acc_v[4 * n + 2 * r], acc_v[4 * n + 2 * r + 1]);
#pragma unroll
    for (int n = 0; n < DQK / 8; ++n)
      *reinterpret_cast<uint32_t*>(krow + n * 8) =
          pack_bf16(acc_k[4 * n + 2 * r] * scale,
                    acc_k[4 * n + 2 * r + 1] * scale);
  }
}

// -------------------------------------------------------------------- dq

template <int DQK, int DV>
__global__ void __launch_bounds__(THREADS, 1)
bwd_dq_kernel(const __grid_constant__ CUtensorMap tmq,
              const __grid_constant__ CUtensorMap tmk,
              const __grid_constant__ CUtensorMap tmv,
              const __grid_constant__ CUtensorMap tmdo,
              const float* __restrict__ stats, __nv_bfloat16* __restrict__ dq,
              int group, int Sq, int Skv, int Sq_pad, int causal, float scale,
              Layout lq) {
  using T = Bwd<DQK, DV>;
  constexpr int BKV = T::QBKV, STAGES = T::QSTAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sDO = sQ + T::QQ_BYTES;
  const uint32_t sK = sQ + T::QK_OFF, sV = sQ + T::QV_OFF;
  const uint32_t q_full = sQ + T::QBAR_OFF;
  auto full = [&](int s) { return q_full + 8u * (1 + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + STAGES + s); };

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * T::QROWS;  // longest first
  const int kv_end = causal ? min(Skv, q0 + T::QROWS) : Skv;
  const int n_kv = (kv_end + BKV - 1) / BKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // ---------------------------------------------------------- producer
    if (lane == 0) {
      const int hk = h / group;
      mbar_expect_tx(q_full, T::QQ_BYTES + T::QDO_BYTES);
#pragma unroll
      for (int p = 0; p < DQK / T::PW; ++p)
        tma_load(sQ + p * T::QROWS * T::ROWB, &tmq, q_full, p * T::PW, q0, h,
                 b);
#pragma unroll
      for (int p = 0; p < DV / T::PW; ++p)
        tma_load(sDO + p * T::QROWS * T::ROWB, &tmdo, q_full, p * T::PW, q0,
                 h, b);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(full(s), T::QK_BYTES + T::QV_BYTES);
#pragma unroll
        for (int p = 0; p < DQK / T::PW; ++p)
          tma_load(sK + s * T::QK_BYTES + p * BKV * T::ROWB, &tmk, full(s),
                   p * T::PW, i * BKV, hk, b);
#pragma unroll
        for (int p = 0; p < DV / T::PW; ++p)
          tma_load(sV + s * T::QV_BYTES + p * BKV * T::ROWB, &tmv, full(s),
                   p * T::PW, i * BKV, hk, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int wg = warp >> 2;
    const int row0 = q0 + wg * 64 + (warp & 3) * 16;  // this warp's rows
    const int ra = row0 + (lane >> 2);                // rows ra and ra + 8
    const int wg_last = q0 + wg * 64 + 63;            // the warpgroup's last
    const float scale2 = scale * LOG2E;
    const uint32_t qa = sQ + wg * 64 * T::ROWB;       // A rows of S
    const uint32_t da_do = sDO + wg * 64 * T::ROWB;   // A rows of dP
    const float* st = stats + ((size_t)b * gridDim.x + h) * 2 * Sq_pad;
    float lse2[2], delta[2];                          // pad rows read 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = st[ra + 8 * r];
      delta[r] = st[Sq_pad + ra + 8 * r];
    }

    float acc[DQK / 2];
#pragma unroll
    for (int i = 0; i < DQK / 2; ++i) acc[i] = 0.f;

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_kv; ++i) {
      const int s = i % STAGES;
      const int kv0 = i * BKV;
      mbar_wait(full(s), (i / STAGES) & 1);
      // causal: a KV tile that starts past this warpgroup's last row is
      // wholly masked for it
      if (!(causal && kv0 > wg_last)) {
        const uint32_t kb = sK + s * T::QK_BYTES, vb = sV + s * T::QV_BYTES;
        float sc[BKV / 2], dp[BKV / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DQK / 16; ++kk) {
          const uint32_t koff = (kk % T::KPP) * 32;
          const uint64_t da =
              make_desc(qa + (kk / T::KPP) * T::QROWS * T::ROWB + koff, 16,
                        8 * T::ROWB, T::LAYOUT);
          const uint64_t db = make_desc(kb + (kk / T::KPP) * BKV * T::ROWB +
                                            koff,
                                        16, 8 * T::ROWB, T::LAYOUT);
          wgmma_ss<BKV>(sc, da, db, kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < DV / 16; ++kk) {
          const uint32_t koff = (kk % T::KPP) * 32;
          const uint64_t da =
              make_desc(da_do + (kk / T::KPP) * T::QROWS * T::ROWB + koff, 16,
                        8 * T::ROWB, T::LAYOUT);
          const uint64_t db = make_desc(vb + (kk / T::KPP) * BKV * T::ROWB +
                                            koff,
                                        16, 8 * T::ROWB, T::LAYOUT);
          wgmma_ss<BKV>(dp, da, db, kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        reg_fence(dp);

        // P and dS on the fragments: element 4n + e is q row
        // ra + 8 (e >> 1), KV column kv0 + 8n + 2 (lane & 3) + (e & 1)
        const bool edge =
            kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > row0);
        uint32_t dsa[BKV / 16][4];
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          float d[8];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int idx = 8 * kk + j, r = (j >> 1) & 1;
            float x = exp2f(fmaf(sc[idx], scale2, -lse2[r]));
            if (edge) {
              const int col = kv0 + 8 * (idx >> 2) + 2 * (lane & 3) + (j & 1);
              if (col >= Skv || (causal && col > ra + 8 * r)) x = 0.f;
            }
            d[j] = x * (dp[idx] - delta[r]);
          }
          dsa[kk][0] = pack_bf16(d[0], d[1]);
          dsa[kk][1] = pack_bf16(d[2], d[3]);
          dsa[kk][2] = pack_bf16(d[4], d[5]);
          dsa[kk][3] = pack_bf16(d[6], d[7]);
        }

        // dQ += dS·K: K (BKV x DQK) is the MN-major B operand
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk)
          wgmma_rs<DQK, BKV>(acc, dsa[kk],
                             make_desc(kb + kk * 16 * T::ROWB, BKV * T::ROWB,
                                       8 * T::ROWB, T::LAYOUT));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc);
        reg_fence(dsa);
      }
      if (lane == 0) mbar_arrive(empty(s));
    }

    __nv_bfloat16* qrow0 = dq + (size_t)b * lq.sb + (size_t)h * lq.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = ra + 8 * r;
      if (row >= Sq) continue;
      __nv_bfloat16* qrow = qrow0 + (size_t)row * lq.ss + 2 * (lane & 3);
#pragma unroll
      for (int n = 0; n < DQK / 8; ++n)
        *reinterpret_cast<uint32_t*>(qrow + n * 8) = pack_bf16(
            acc[4 * n + 2 * r] * scale, acc[4 * n + 2 * r + 1] * scale);
    }
  }
}

// --------------------------------------------------------------- launches

template <class K>
cudaError_t size_smem(K kernel, int smem) {
  // above 48 KB shared memory must be asked for, once per instantiation
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

template <int DQK, int DV>
int launch_bwd(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, const __nv_bfloat16* o,
               const __nv_bfloat16* dO, const float* lse, __nv_bfloat16* dq,
               __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats, int B,
               int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
               const Layout* l, cudaStream_t stream) {
  using T = Bwd<DQK, DV>;
  // l: q, k, v, o, dO, dq, dk, dv
  if (B <= 0 || Hq <= 0 || Sq <= 0 || Skv <= 0)
    return (int)cudaGetLastError();
  static bool sized = false;
  if (!sized) {
    cudaError_t e = size_smem(bwd_dkdv_kernel<DQK, DV>, T::SMEM);
    if (e == cudaSuccess) e = size_smem(bwd_dq_kernel<DQK, DV>, T::QSMEM);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int Sq_pad = (Sq + PAD - 1) / PAD * PAD;
  const int rows = B * Hq * Sq_pad;
  bwd_prep_kernel<<<(rows + 7) / 8, 256, 0, stream>>>(
      o, dO, lse, stats, Hq, Sq, Sq_pad, DV, rows, l[3], l[4]);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;

  CUtensorMap mq, mk, mv, mdo;
  err = encode<DQK, T::BQ>(&mq, q, B, Hq, Sq, l[0]);
  if (err == 0) err = encode<DQK, T::KV_ROWS>(&mk, k, B, Hkv, Skv, l[1]);
  if (err == 0) err = encode<DV, T::KV_ROWS>(&mv, v, B, Hkv, Skv, l[2]);
  if (err == 0) err = encode<DV, T::BQ>(&mdo, dO, B, Hq, Sq, l[4]);
  if (err != 0) return err;
  const dim3 kv_grid(Hkv, B, (Skv + T::KV_ROWS - 1) / T::KV_ROWS);
  bwd_dkdv_kernel<DQK, DV><<<kv_grid, DKDV_THREADS, T::SMEM, stream>>>(
      mq, mk, mv, mdo, stats, dk, dv, Hq / Hkv, Sq, Skv, Sq_pad, causal,
      scale, l[6], l[7]);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  err = encode<DQK, T::QROWS>(&mq, q, B, Hq, Sq, l[0]);
  if (err == 0) err = encode<DQK, T::QBKV>(&mk, k, B, Hkv, Skv, l[1]);
  if (err == 0) err = encode<DV, T::QBKV>(&mv, v, B, Hkv, Skv, l[2]);
  if (err == 0) err = encode<DV, T::QROWS>(&mdo, dO, B, Hq, Sq, l[4]);
  if (err != 0) return err;
  const dim3 q_grid(Hq, B, (Sq + T::QROWS - 1) / T::QROWS);
  bwd_dq_kernel<DQK, DV><<<q_grid, THREADS, T::QSMEM, stream>>>(
      mq, mk, mv, mdo, stats, dq, Hq / Hkv, Sq, Skv, Sq_pad, causal, scale,
      l[5]);
  return (int)cudaGetLastError();
}

// the (DQK, DV) pairs the backward is built for
template <class F>
int dispatch_bwd_dims(int D, int Dv, F&& f) {
  if (D == 32 && Dv == 32) return f(Dim<32>{}, Dim<32>{});
  if (D == 64 && Dv == 64) return f(Dim<64>{}, Dim<64>{});
  if (D == 128 && Dv == 128) return f(Dim<128>{}, Dim<128>{});
  if (D == 160 && Dv == 160) return f(Dim<160>{}, Dim<160>{});
  if (D == 192 && Dv == 128) return f(Dim<192>{}, Dim<128>{});
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: three element strides (batch, head, sequence) each of q, k, v,
// o, dO, dq, dk, dv, in that order
extern "C" int k4_flash_attention_bwd_bf16(
    const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
    const __nv_bfloat16* o, const __nv_bfloat16* dO, const float* lse,
    __nv_bfloat16* dq, __nv_bfloat16* dk, __nv_bfloat16* dv, float* stats,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, int Dv, int causal,
    float scale, int q0, int q1, int q2, int k0, int k1, int k2, int v0,
    int v1, int v2, int o0, int o1, int o2, int d0, int d1, int d2, int dq0,
    int dq1, int dq2, int dk0, int dk1, int dk2, int dv0, int dv1, int dv2,
    cudaStream_t stream) {
  const Layout l[8] = {{q0, q1, q2},    {k0, k1, k2},    {v0, v1, v2},
                       {o0, o1, o2},    {d0, d1, d2},    {dq0, dq1, dq2},
                       {dk0, dk1, dk2}, {dv0, dv1, dv2}};
  return dispatch_bwd_dims(D, Dv, [&](auto dqk, auto dvv) {
    return launch_bwd<decltype(dqk)::value, decltype(dvv)::value>(
        q, k, v, o, dO, lse, dq, dk, dv, stats, B, Hq, Hkv, Sq, Skv, causal,
        scale, l, stream);
  });
}
