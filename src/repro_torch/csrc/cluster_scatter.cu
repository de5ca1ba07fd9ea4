// K1 — one block of the streaming-clustering scan (paper Alg. 2).
//
// Replaces: src/repro/kernels/cluster_scatter.py, cluster_scatter (the
// Pallas kernel _cluster_kernel; per-edge math edge_decisions).
//
// What bounds it on the H100: latency.  The 128 edges of a block form one
// dependent chain (each edge reads the table entries the previous edge
// wrote), so the work is a few hundred integer operations in series; the
// 5 KB table is far below any bandwidth limit.  The per-block launch and
// the host-side localization around it cost more than the kernel itself.
//
// Design: one CTA per block.  Its threads copy the block's edge rows and
// the fused table
// (buf: [0,2B) vertex -> local cluster slot, [2B,4B) streamed degree,
// [4B,10B) cluster volumes) into shared memory, one thread runs the edges
// in order with every read-modify-write in shared memory (the fused
// scatter of the reference becomes eight shared-memory updates), and the
// threads copy the table back.  The decision math is a line-by-line copy
// of edge_decisions; float semantics follow JAX exactly: integer volumes
// and degrees are compared with vmax after conversion to f32 (jnp's
// int32-vs-f32 promotion) and the split threshold is an IEEE f32 multiply
// and divide (no fast math).
#include "common.cuh"

namespace {

__device__ __forceinline__ int sel(int p, int a0, int a1, int a2, int a3) {
  return p == 0 ? a0 : (p == 1 ? a1 : (p == 2 ? a2 : a3));
}

__device__ __forceinline__ void bump(int p, int x, int& a0, int& a1, int& a2,
                                     int& a3) {
  a0 += (p == 0) ? x : 0;
  a1 += (p == 1) ? x : 0;
  a2 += (p == 2) ? x : 0;
  a3 += (p == 3) ? x : 0;
}

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void cluster_scatter_kernel(const int* __restrict__ ints,
                                       const int* buf_in, const int* scal_in,
                                       int* buf_out, int* scal_out,
                                       int* __restrict__ packed_out, int B,
                                       float vmax, int allow_split,
                                       float sdf) {
  extern __shared__ int buf[];
  int* rows = buf + 10 * B;  // the block's (lu, lv, live) rows
  const int n = 10 * B;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = buf_in[i];
  for (int i = threadIdx.x; i < 3 * B; i += blockDim.x) rows[i] = ints[i];
  __syncthreads();

  if (threadIdx.x == 0) {
    int nid = scal_in[0];
    const int nid0 = scal_in[1];
    int seen_v = scal_in[2];
    int seen_deg = scal_in[3];
    const int scrap = 6 * B - 1;
    for (int e = 0; e < B; ++e) {
      const int lu = rows[3 * e];
      const int lv = rows[3 * e + 1];
      const bool live = rows[3 * e + 2] != 0;
      const int cu0 = buf[lu];
      const int cv0 = buf[lv];
      const int d0 = buf[2 * B + lu];
      const int d1 = buf[2 * B + lv];
      const int vg0 = buf[4 * B + clip(cu0, 0, scrap)];
      const int vg1 = buf[4 * B + clip(cv0, 0, scrap)];

      // ---- edge_decisions (kernels/cluster_scatter.py) ----
      const int du = d0 + 1, dv = d1 + 1;
      const float duf = (float)du, dvf = (float)dv;
      const bool preu = cu0 >= 0, prev = cv0 >= 0;
      const int id0 = preu ? cu0 : 2 * B + (nid - nid0);
      nid += (live && !preu) ? 1 : 0;
      const int id1 = prev ? cv0 : 2 * B + (nid - nid0);
      nid += (live && !prev) ? 1 : 0;
      const bool same = id0 == id1;
      seen_v += ((live && !preu) ? 1 : 0) + ((live && !prev) ? 1 : 0);
      seen_deg += live ? 2 : 0;
      float dthr = 0.0f;
      if (sdf > 0.0f)
        dthr = __fdiv_rn(__fmul_rn(sdf, (float)seen_deg),
                         (float)(seen_v > 1 ? seen_v : 1));

      int v0 = preu ? vg0 : 0;
      int v1 = (prev && !same) ? vg1 : 0;
      int v2 = 0, v3 = 0;
      const int i0 = v0, i1 = v1;
      const int lvflag = live ? 1 : 0;
      int pu = 0;
      int pv = same ? 0 : 1;
      bump(pu, lvflag, v0, v1, v2, v3);
      bump(pv, lvflag, v0, v1, v2, v3);

      bool fire1 = false, fire2 = false, t1_is_u = false;
      int id2 = scrap, id3 = scrap;
      if (allow_split) {
        const bool x_is_u = du >= dv;
        t1_is_u = same ? x_is_u : true;
        const int pt1 = t1_is_u ? pu : pv;
        const int dt1 = t1_is_u ? du : dv;
        fire1 = live && ((float)sel(pt1, v0, v1, v2, v3) >= vmax) &&
                ((t1_is_u ? duf : dvf) >= dthr);
        const int f1 = fire1 ? 1 : 0;
        bump(pt1, -dt1 * f1, v0, v1, v2, v3);
        v2 += dt1 * f1;
        pu = (fire1 && t1_is_u) ? 2 : pu;
        pv = (fire1 && !t1_is_u) ? 2 : pv;
        id2 = 2 * B + (nid - nid0);
        nid += f1;
        fire2 = live && !same && ((float)sel(pv, v0, v1, v2, v3) >= vmax) &&
                (dvf >= dthr);
        const int f2 = fire2 ? 1 : 0;
        bump(pv, -dv * f2, v0, v1, v2, v3);
        v3 += dv * f2;
        id3 = 2 * B + (nid - nid0);
        nid += f2;
        pv = fire2 ? 3 : pv;
      }

      // migration (lines 20-26) with the post-guard
      const int vu_cur = sel(pu, v0, v1, v2, v3);
      const int vv_cur = sel(pv, v0, v1, v2, v3);
      const bool both_room = live && (pu != pv) && ((float)vu_cur < vmax) &&
                             ((float)vv_cur < vmax);
      const bool u_moves =
          both_room && (vu_cur <= vv_cur) && ((float)(vv_cur + du) < vmax);
      const bool v_moves =
          both_room && (vu_cur > vv_cur) && ((float)(vu_cur + dv) < vmax);
      const int mu = u_moves ? 1 : 0, mv = v_moves ? 1 : 0;
      bump(pu, -du * mu + dv * mv, v0, v1, v2, v3);
      bump(pv, du * mu - dv * mv, v0, v1, v2, v3);
      const int pu2 = u_moves ? pv : pu;
      const int pv2 = v_moves ? pu : pv;
      pu = pu2;
      pv = pv2;

      const int newu = live ? sel(pu, id0, id1, id2, id3) : cu0;
      const int newv = live ? sel(pv, id0, id1, id2, id3) : cv0;
      const int vid0 = clip(live ? id0 : scrap, 0, scrap);
      const int vid1 = clip(same ? scrap : id1, 0, scrap);
      const int vid2 = clip(fire1 ? id2 : scrap, 0, scrap);
      const int vid3 = clip(fire2 ? id3 : scrap, 0, scrap);
      const bool fire_u = fire1 && t1_is_u;
      const bool fire_v = (fire1 && !t1_is_u) || fire2;
      // ---- end of edge_decisions ----

      // the fused scatter, lane by lane; lane 0 is guarded against
      // lu == lv (dead self-loop lanes alias the two vertex slots and
      // lane 1 carries the whole pointer update)
      buf[lu] += (lu != lv) ? newu - cu0 : 0;
      buf[lv] += newv - cv0;
      buf[2 * B + lu] += lvflag;
      buf[2 * B + lv] += lvflag;
      buf[4 * B + vid0] += v0 - i0;
      buf[4 * B + vid1] += v1 - i1;
      buf[4 * B + vid2] += v2;
      buf[4 * B + vid3] += v3;
      packed_out[e] = (fire_u ? 1 : 0) + 2 * (fire_v ? 1 : 0);
    }
    scal_out[0] = nid;
    scal_out[1] = nid0;
    scal_out[2] = seen_v;
    scal_out[3] = seen_deg;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf_out[i] = buf[i];
}

}  // namespace

// buf_out may alias buf_in and scal_out may alias scal_in: every read of
// the inputs happens before the first write of the outputs.
extern "C" int k1_cluster_scatter(const int* ints, const int* buf_in,
                                  const int* scal_in, int* buf_out,
                                  int* scal_out, int* packed_out, int B,
                                  float vmax, int allow_split, float sdf,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(int) * 13 * (size_t)B;
  cluster_scatter_kernel<<<1, 128, smem, stream>>>(
      ints, buf_in, scal_in, buf_out, scal_out, packed_out, B, vmax,
      allow_split, sdf);
  return (int)cudaGetLastError();
}
