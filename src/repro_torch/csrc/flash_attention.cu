// K4 — flash attention (causal or not, GQA), the prefill attention of the
// LM stack.
//
// Replaces: src/repro/kernels/flash_attention.py:70, flash_attention (the
// Pallas kernel _flash_kernel).  o[b,h] = softmax(q[b,h]·k[b,h/g]^T·scale
// + mask)·v[b,h/g] with g = Hq/Hkv, by online softmax: f32 running max m,
// sum l and accumulator acc; masked scores are -1e30, l is clamped at
// 1e-20, and the output is written in q's dtype.
//
// What bounds it on the H100: tensor-core operations.  At the serving
// prefill shape (B=4, Hq=28, Hkv=4, S=2048, D=128, causal) the unmasked
// (q, k) pairs need 4·D FLOP each, about 1.2e11 FLOP, 0.12 ms at the
// 989 TFLOP/s bf16 dense peak, while q, k, v and o are 134 MB, 0.04 ms at
// 3.35 TB/s.
//
// Design.  The TPU grid walks the KV blocks in order with m, l, acc in VMEM
// scratch; here one CTA of 4 warps owns one (b, h, 64-row q tile) and loops
// over the KV tiles itself, so the softmax state never leaves registers.
// K and V tiles (64 rows) are staged in shared memory, rows padded by 16
// bytes so the fragment reads hit 32 distinct banks.  The loop ends at the
// diagonal when causal (the TPU kernel's skip of fully masked blocks), and
// the CTAs with the most tiles start first.  GQA: the CTA reads KV head
// h / g (any g, not only powers of two); K/V are never expanded in device
// memory.  Any Sq and Skv: rows past Sq are computed on zeros and not
// stored, KV rows past Skv are zero-filled and masked.
//
// bf16 inputs: each warp owns 16 q rows and runs mma.sync m16n8k16 (bf16 in,
// f32 accumulate) for S = Q·K^T and O += P·V; V fragments come from
// ldmatrix.trans.  The scale is applied to the f32 scores (the TPU kernel
// scales q in f32 before the product, so the two differ by rounding only),
// and p is rounded to bf16 before P·V (the TPU kernel keeps it in f32); l
// sums the f32 p.  f32 inputs take a plain FMA path with no TF32: a CTA of
// 4 warps owns 16 q rows, one lane per KV column for the scores and one
// lane per output column for P·V.
//
// q, k, v, o are addressed by element strides (batch, head, sequence; the
// head dim is contiguous), so the model's (B, S, H, D) activations are read
// in place.  Later: wgmma, TMA and a producer warp (cuda_guide.md).
#include <cuda_bf16.h>
#include <stdint.h>
#include "common.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Layout {
  int sb, sh, ss;  // element strides of batch, head, sequence
};

// ------------------------------------------------------------------- bf16

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// two bf16 of row `row`, columns c and c+1 (0 past the last row)
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              int row, int rows, int ss,
                                              int c) {
  if (row >= rows) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + (size_t)row * ss + c);
}

template <int D>
__global__ void __launch_bounds__(128)
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, int group, int Sq, int Skv,
                  int causal, float scale, Layout lq, Layout lk, Layout lv,
                  Layout lo) {
  constexpr int BQ = 64, BKV = 64, LD = D + 8, NT = BKV / 8, DT = D / 8;
  __shared__ __align__(16) __nv_bfloat16 sK[BKV * LD];
  __shared__ __align__(16) __nv_bfloat16 sV[BKV * LD];

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = tile * BQ + warp * 16;  // this warp's first q row
  const __nv_bfloat16* qb = q + (size_t)b * lq.sb + (size_t)h * lq.sh;
  const __nv_bfloat16* kb = k + (size_t)b * lk.sb + (size_t)hk * lk.sh;
  const __nv_bfloat16* vb = v + (size_t)b * lv.sb + (size_t)hk * lv.sh;
  const float scale2 = scale * LOG2E;  // scores in log2 units: exp2 below

  uint32_t qf[D / 16][4];  // A fragments of this warp's 16 q rows
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qb, row0 + g, Sq, lq.ss, c);
    qf[kk][1] = load_pair(qb, row0 + g + 8, Sq, lq.ss, c);
    qf[kk][2] = load_pair(qb, row0 + g, Sq, lq.ss, c + 8);
    qf[kk][3] = load_pair(qb, row0 + g + 8, Sq, lq.ss, c + 8);
  }

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF};  // rows g and g + 8, log2 units
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums

  const int kv_end = causal ? min(Skv, tile * BQ + BQ) : Skv;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < BKV * D / 8; i += blockDim.x) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
      if (kv0 + r < Skv) {
        kx = *reinterpret_cast<const uint4*>(kb + (size_t)(kv0 + r) * lk.ss + c);
        vx = *reinterpret_cast<const uint4*>(vb + (size_t)(kv0 + r) * lv.ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * LD + c) = kx;
      *reinterpret_cast<uint4*>(sV + r * LD + c) = vx;
    }
    __syncthreads();

    // S = Q·K^T: 16 rows x 64 columns, B[k][n] = K[n][k] read as pairs
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = sK + (n * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma_bf16(s[n], qf[kk], b0, b1);
      }
    }

    const bool edge = kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > row0);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (edge) {
          const int col = kv0 + n * 8 + 2 * t + (e & 1);
          const int row = row0 + g + (e >> 1) * 8;
          if (col >= Skv || (causal && col > row)) x = NEG_INF;
        }
        s[n][e] = x;
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
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P·V: P's C fragments are A fragments once packed to bf16; V's B
    // fragments (k = kv, n = d) come transposed out of row-major sV
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane >> 3;
      const __nv_bfloat16* vr =
          sV + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < DT; n += 2) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vr + n * 8);
        mma_bf16(acc[n], pa, vf[0], vf[1]);
        mma_bf16(acc[n + 1], pa, vf[2], vf[3]);
      }
    }
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
    const int row = row0 + g + r * 8;
    if (row >= Sq) continue;
    __nv_bfloat16* orow = ob + (size_t)row * lo.ss + 2 * t;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack_bf16(acc[n][2 * r] * inv[r], acc[n][2 * r + 1] * inv[r]);
  }
}

// -------------------------------------------------------------------- f32

template <int D>
__global__ void __launch_bounds__(128)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int group, int Sq, int Skv, int causal, float scale,
                 Layout lq, Layout lk, Layout lv, Layout lo) {
  constexpr int BQ = 16, BKV = 32, RW = BQ / 4, DL = D / 32;
  __shared__ float sQ[BQ * D];
  __shared__ float sK[BKV * (D + 1)];  // +1: lane j reads row j, no conflict
  __shared__ float sV[BKV * D];

  const int tile = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qb = q + (size_t)b * lq.sb + (size_t)h * lq.sh;
  const float* kb = k + (size_t)b * lk.sb + (size_t)hk * lk.sh;
  const float* vb = v + (size_t)b * lv.sb + (size_t)hk * lv.sh;

  for (int i = threadIdx.x; i < BQ * D; i += blockDim.x) {
    const int r = tile * BQ + i / D;
    // q scaled in f32 before the product, as the TPU kernel does
    sQ[i] = r < Sq ? qb[(size_t)r * lq.ss + i % D] * scale : 0.f;
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
    for (int i = threadIdx.x; i < BKV * D; i += blockDim.x) {
      const int r = i / D, c = i % D;
      const bool in = kv0 + r < Skv;
      sK[r * (D + 1) + c] = in ? kb[(size_t)(kv0 + r) * lk.ss + c] : 0.f;
      sV[i] = in ? vb[(size_t)(kv0 + r) * lv.ss + c] : 0.f;
    }
    __syncthreads();

    float s[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) s[r] = 0.f;
    const float* kr = sK + lane * (D + 1);
    const float* qr = sQ + warp * RW * D;
    for (int d = 0; d < D; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int r = 0; r < RW; ++r) s[r] = fmaf(qr[r * D + d], kd, s[r]);
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
          pv[i] = fmaf(pj, sV[j * D + lane + 32 * i], pv[i]);
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
#pragma unroll
    for (int i = 0; i < DL; ++i)
      ob[(size_t)row * lo.ss + lane + 32 * i] = acc[r][i] * inv;
  }
}

template <typename T, int BQ, typename Kernel>
int launch(Kernel kernel, const T* q, const T* k, const T* v, T* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int causal, float scale,
           Layout lq, Layout lk, Layout lv, Layout lo, cudaStream_t stream) {
  if (B > 0 && Hq > 0 && Sq > 0) {
    dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
    kernel<<<grid, 128, 0, stream>>>(q, k, v, o, Hq / Hkv, Sq, Skv, causal,
                                     scale, lq, lk, lv, lo);
  }
  return (int)cudaGetLastError();
}

}  // namespace

#define K4_ENTRY(NAME, T, KERNEL, BQ)                                        \
  extern "C" int NAME(const T* q, const T* k, const T* v, T* o, int B,       \
                      int Hq, int Hkv, int Sq, int Skv, int D, int causal,   \
                      float scale, int qsb, int qsh, int qss, int ksb,       \
                      int ksh, int kss, int vsb, int vsh, int vss, int osb,  \
                      int osh, int oss, cudaStream_t stream) {               \
    const Layout lq{qsb, qsh, qss}, lk{ksb, ksh, kss}, lv{vsb, vsh, vss},    \
        lo{osb, osh, oss};                                                   \
    switch (D) {                                                             \
      case 32:                                                               \
        return launch<T, BQ>(KERNEL<32>, q, k, v, o, B, Hq, Hkv, Sq, Skv,    \
                             causal, scale, lq, lk, lv, lo, stream);         \
      case 64:                                                               \
        return launch<T, BQ>(KERNEL<64>, q, k, v, o, B, Hq, Hkv, Sq, Skv,    \
                             causal, scale, lq, lk, lv, lo, stream);         \
      case 128:                                                              \
        return launch<T, BQ>(KERNEL<128>, q, k, v, o, B, Hq, Hkv, Sq, Skv,   \
                             causal, scale, lq, lk, lv, lo, stream);         \
      default:                                                               \
        return (int)cudaErrorInvalidValue;                                   \
    }                                                                        \
  }

K4_ENTRY(k4_flash_attention_bf16, __nv_bfloat16, flash_bf16_kernel, 64)
K4_ENTRY(k4_flash_attention_f32, float, flash_f32_kernel, 16)
