// K1 — the streaming-clustering scan (paper Alg. 2): one persistent pass
// over the whole stream, and the one-block kernel it grew from.
//
// Replaces: src/repro/kernels/cluster_scatter.py, cluster_scatter (the
// Pallas kernel _cluster_kernel; per-edge math edge_decisions), and the
// per-block localize / write-back around it in
// src/repro/core/clustering.py, _block_step.
//
// What bounds it on the H100: latency.  The edges of the stream form one
// dependent chain (each edge reads the table entries the previous edge
// wrote, each block reads the global state the previous block wrote), so
// the work is a few hundred integer operations in series per edge; the
// bytes (the stream's localized rows and the clu/deg/vol tables) are far
// below any bandwidth limit.
//
// Design.  k1_cluster_pass is one CTA of 256 threads that walks the
// blocks of B = 128 edges in order, so no block waits on a launch or on
// the host.  Per block, as _block_step does:
//   1. each thread takes one of the block's 2B local vertex slots and
//      gathers its current cluster (the key; _BIG_ID when the slot is a
//      pad or the vertex is unallocated) and its streamed degree;
//   2. each thread ranks its key among the 2B keys (a count over the keys
//      in shared memory): the number of keys strictly below it is the
//      searchsorted-left slot of its cluster (duplicates stay, a vertex's
//      slot is its cluster's first occurrence), and that count plus the
//      equal keys before it is the key's place in the sorted table ucl;
//   3. the fused table buf ([0,2B) vertex slot -> local cluster slot,
//      [2B,4B) streamed degree, [4B,10B) cluster volumes, the volumes of
//      the present clusters gathered at their sorted places) is built in
//      shared memory;
//   4. one thread runs the edges in order (walk_block, shared with the
//      one-block kernel) while the other warps load the next block's rows;
//   5. every thread writes back its vertex slot's cluster (a present
//      cluster's global id, or the id a fresh slot was created under) and
//      degree, and the nonzero volume deltas are added to vol with integer
//      atomics (duplicate ids of an overflowed run land on the scrap id
//      cap - 1; integer sums do not depend on the order).
// __syncthreads() between the phases makes each block's writes visible
// to the next block's gathers.
//
// The decision math in walk_block is a line-by-line copy of
// edge_decisions; float semantics follow JAX exactly: integer volumes and
// degrees are compared with vmax after conversion to f32 (jnp's
// int32-vs-f32 promotion) and the split threshold is an IEEE f32 multiply
// and divide (no fast math).
#include "common.cuh"

namespace {

constexpr int BIG_ID = 0x7fffffff;  // _BIG_ID: an empty cluster slot

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

// The B edges of one block in order over the fused table `buf` (10B
// entries) in shared memory; `rows` holds the block's (lu, lv, live)
// rows.  Run by one thread.  nid0 is the block's first fresh id.
__device__ void walk_block(int* buf, const int* rows, int B, int nid0,
                           int& nid, int& seen_v, int& seen_deg, float vmax,
                           int allow_split, float sdf, int* packed_out) {
  const int scrap = 6 * B - 1;
  int nlu = rows[0], nlv = rows[1], nlive = rows[2];
  for (int e = 0; e < B; ++e) {
    const int lu = nlu, lv = nlv;
    const bool live = nlive != 0;
    if (e + 1 < B) {  // the rows never change: read the next one early
      nlu = rows[3 * e + 3];
      nlv = rows[3 * e + 4];
      nlive = rows[3 * e + 5];
    }
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
}

// ------------------------------------------------------------ one block

__global__ void cluster_scatter_kernel(const int* __restrict__ ints,
                                       const int* buf_in, const int* scal_in,
                                       int* buf_out, int* scal_out,
                                       int* __restrict__ packed_out, int B,
                                       float vmax, int allow_split,
                                       float sdf) {
  extern __shared__ int smem[];
  int* buf = smem;
  int* rows = smem + 10 * B;  // the block's (lu, lv, live) rows
  const int n = 10 * B;
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[i] = buf_in[i];
  for (int i = threadIdx.x; i < 3 * B; i += blockDim.x) rows[i] = ints[i];
  __syncthreads();

  if (threadIdx.x == 0) {
    int nid = scal_in[0];
    const int nid0 = scal_in[1];
    int seen_v = scal_in[2];
    int seen_deg = scal_in[3];
    walk_block(buf, rows, B, nid0, nid, seen_v, seen_deg, vmax, allow_split,
               sdf, packed_out);
    scal_out[0] = nid;
    scal_out[1] = nid0;
    scal_out[2] = seen_v;
    scal_out[3] = seen_deg;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf_out[i] = buf[i];
}

// ---------------------------------------------------------- whole pass

constexpr int PB = 128;          // edges per block
constexpr int PT = 2 * PB;       // threads: one per local vertex slot

__global__ void __launch_bounds__(PT)
cluster_pass_kernel(const int* __restrict__ ints, const int* __restrict__ uvg,
                    int* clu, int* deg, int* vol, int* scal,
                    int* __restrict__ packed, int nb, int V, int cap,
                    float vmax, int allow_split, float sdf) {
  __shared__ int buf[10 * PB];
  __shared__ int rows[2][3 * PB];  // this block's rows and the next one's
  __shared__ int verts[2][PT];     // global vertex of each local slot
  __shared__ __align__(16) int keys[PT];
  __shared__ int ucl[PT];          // the keys sorted
  __shared__ int lvol0[PT];        // present clusters' volumes at start
  __shared__ int nid0_s;
  const int t = threadIdx.x;
  const int scrap = cap - 1;

  int nid = 0, seen_v = 0, seen_deg = 0;  // thread 0's carried scalars
  if (t == 0) {
    nid = scal[0];
    seen_v = scal[2];
    seen_deg = scal[3];
  }
  for (int i = t; i < 3 * PB; i += PT) rows[0][i] = ints[i];
  verts[0][t] = uvg[t];
  __syncthreads();

  for (int b = 0; b < nb; ++b) {
    const int cur = b & 1;
    // 1. this slot's current cluster (the key) and streamed degree
    const int g = verts[cur][t];
    const int gr = g < V ? g : V - 1;  // pad slots (g == V) read V - 1
    const int cid = clu[gr];
    const bool valid = g < V && cid >= 0;
    const int key = valid ? cid : BIG_ID;
    const int d0 = deg[gr];
    keys[t] = key;
    __syncthreads();

    // 2. rank: keys strictly below (searchsorted-left) and equal before
    int less = 0, eq_before = 0;
    const int4* k4 = reinterpret_cast<const int4*>(keys);
#pragma unroll 4
    for (int j = 0; j < PT / 4; ++j) {
      const int4 k = k4[j];
      less += (k.x < key) + (k.y < key) + (k.z < key) + (k.w < key);
      eq_before += (k.x == key && 4 * j < t) + (k.y == key && 4 * j + 1 < t) +
                   (k.z == key && 4 * j + 2 < t) +
                   (k.w == key && 4 * j + 3 < t);
    }
    const int pos = less + eq_before;

    // 3. the fused table
    const int lv0 = key < BIG_ID ? vol[key < scrap ? key : scrap] : 0;
    ucl[pos] = key;
    lvol0[pos] = lv0;
    buf[t] = valid ? less : -1;
    buf[2 * PB + t] = d0;
    buf[4 * PB + pos] = lv0;
    buf[6 * PB + t] = 0;
    buf[8 * PB + t] = 0;
    __syncthreads();

    // 4. the walk on thread 0; warps 1.. load the next block's rows
    if (t == 0) {
      const int first = nid;  // nid0 := nid
      nid0_s = first;
      walk_block(buf, rows[cur], PB, first, nid, seen_v, seen_deg, vmax,
                 allow_split, sdf, packed + (size_t)b * PB);
    } else if (t >= 32 && b + 1 < nb) {
      const int* nxt = ints + (size_t)(b + 1) * 3 * PB;
      for (int i = t - 32; i < 3 * PB; i += PT - 32) rows[cur ^ 1][i] = nxt[i];
      for (int i = t - 32; i < PT; i += PT - 32)
        verts[cur ^ 1][i] = uvg[(size_t)(b + 1) * PT + i];
    }
    __syncthreads();

    // 5. write back: vertex slot -> global cluster id and degree, then
    //    the volume deltas
    const int nid0 = nid0_s;
    const int lclu = buf[t];
    int newclu = -1;
    if (lclu >= 0) {
      const int j = lclu < 6 * PB - 1 ? lclu : 6 * PB - 1;
      newclu = j < PT ? ucl[j] : nid0 + (j - PT);
    }
    clu[g] = newclu;  // pad slots write the extra slot V
    deg[g] = buf[2 * PB + t];
    for (int j = t; j < 6 * PB; j += PT) {
      const int dvol = buf[4 * PB + j] - (j < PT ? lvol0[j] : 0);
      if (dvol == 0) continue;
      const int id = j < PT ? (ucl[j] < BIG_ID ? ucl[j] : scrap)
                            : nid0 + (j - PT);
      atomicAdd(vol + clip(id, 0, scrap), dvol);
    }
    __syncthreads();
  }
  if (t == 0) {
    scal[0] = nid;
    scal[1] = nid0_s;
    scal[2] = seen_v;
    scal[3] = seen_deg;
  }
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

// The whole clustering pass over nb blocks of 128 edges: ints (nb, 128, 3)
// and uvg (nb, 256) from the batched localization; clu and deg (V + 1,
// the extra slot V absorbs the pad slots' writes), vol (cap) and scal
// (nid, nid0, seen_v, seen_deg) are updated in place; packed (nb * 128)
// gets fire_u + 2 * fire_v per edge.
extern "C" int k1_cluster_pass(const int* ints, const int* uvg, int* clu,
                               int* deg, int* vol, int* scal, int* packed,
                               int nb, int V, int cap, float vmax,
                               int allow_split, float sdf,
                               cudaStream_t stream) {
  if (nb > 0)
    cluster_pass_kernel<<<1, PT, 0, stream>>>(ints, uvg, clu, deg, vol, scal,
                                              packed, nb, V, cap, vmax,
                                              allow_split, sdf);
  return (int)cudaGetLastError();
}
