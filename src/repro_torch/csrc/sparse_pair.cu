// Packed-sparse (packed-CSR) SimGNN pair-score megakernel for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparse_pair.py
// (sparse_pair_score, body _kernel): per packed tile, both sides' GCN stack
// aggregated from the host-built A' ELLPACK planes + COO overflow list,
// segment Att pooling over the P pair slots, NTN, FCN and sigmoid; only the
// [T, P] scores reach global memory.
//
// What bounds it on this card: the work is small (about 1.5 M FMA and 5 KB
// of input a tile at SimGNN-AIDS widths), so the float32 FMA rate bounds it
// at a few microseconds a request; in practice the latency of one tile's
// chain of dependent, barrier-separated stages does (about 71 k SM cycles
// a CTA at a served 256-pair request on an H100, tools/sparse_pair_stages.py:
// the two products 36%, the three aggregations 20%, the head 15%, the
// pooling 11%).
// The design shortens that chain:
//   * one tile per 2-CTA cluster, one side per CTA (rank 0 the lhs, rank 1
//     the rhs): a 104-tile request runs 208 CTAs, two resident an SM, and
//     the two sides run at once. After both have pooled, each CTA copies
//     its peer's embeddings of the live pair slots through distributed
//     shared memory and scores its half of them;
//   * overflow edges bucketed by receiver in the kernel (one warp, match
//     and ballot) while the other warps run the W1 row gather: each
//     (node, feature) output walks its own row's COO slots instead of
//     scanning all E_ov of them;
//   * register-tiled float32 products for layers >= 1: a thread owns 4 or
//     2 rows x 4 columns, float4 loads of H (shared) and W (global, read
//     through the read-only cache), TM x 4 independent FMA chains;
//   * the aggregation reads four feature columns a task as float4, two
//     tasks a thread and two ELL planes at a time;
//   * the pooling computes only the slots the head reads (and those of
//     masked-in nodes, whose Att weights need them);
//   * the NTN's K bilinear slices of each live slot spread over the warps,
//     two a warp side by side, then the FCN and the sigmoid on one warp a
//     slot, reading the NTN V and b and the FCN from a shared-memory copy.
// The shared-memory layout comes from the Python plan,
// kernels/sparse_pair.py sparse_pair_plan.
//
// Arithmetic: every output is computed by the same float32 operations in
// the same order as the one-CTA kernel this design replaced, so the scores
// are the same bits. HW[i, j] is an fmaf chain over k = 0..fin-1 from 0,
// then + b[j] (simgnn_common.cuh dense_transform); the first layer is the
// W1 row gather of label_transform; H[i, j] = relu(acc + ov) * mask[i],
// acc the ELL chain (plane 0 a product, planes 1..D-1 fmaf), ov an fmaf
// chain from +0 over the row's COO slots in ascending slot order
// (csr_aggregate); every pooled output is segment_att_pool's chain over
// all NB nodes, so a NaN in one segment still reaches every mean; each
// NTN slice and the FCN are ntn_fcn_warp's loops. Slots whose receiver is
// not a row of the tile are dropped, as csr_aggregate never matches them.
// Pad slots (receiver 0, sender 0, weight 0) stay in row 0's list, since
// fmaf(0, hw[0, j], ov) carries a NaN or inf of hw[0, j] into the sum.
// Only a zero-weight slot that repeats the slot before it in its row
// (same sender, same weight bits) is dropped: g(ov) = fmaf(±0, x, ov) is
// ov + (±0 or NaN), exact, and g(g(ov)) = g(ov) for every x and ov (NaN,
// ±inf and signed zeros included), so a run of identical pad slots adds
// the same bits as one of them.
#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "simgnn_common.cuh"

namespace cg = cooperative_groups;

#define SP_FULL 0xffffffffu

// Stage clocks, compiled in only by tools/sparse_pair_stages.py (which
// defines SPARSE_PAIR_STAGES): thread 0 of each CTA records clock64() as
// stage k ends, into SP_STAGES slots a CTA of a buffer the tool hands
// sparse_pair_stage_buffer (slot 30: the SM, 31: the global timer at the
// start).
#define SP_STAGES 32
#ifdef SPARSE_PAIR_STAGES
__device__ long long* sp_stage_buf;
extern "C" int sparse_pair_stage_buffer(long long* buf) {
  return (int)cudaMemcpyToSymbol(sp_stage_buf, &buf, sizeof(buf));
}
#define SP_STAGE(k)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0)                                                \
      sp_stage_buf[blockIdx.x * SP_STAGES + (k)] = clock64();            \
  } while (0)
#else
#define SP_STAGE(k) \
  do {              \
  } while (0)
#endif

struct SparseSide {
  const int16_t* nbr;     // [T, NB*D] ELL senders (plane-major)
  const float* nw;        // [T, NB*D] A' weights (0 at pad slots)
  const int16_t* ovs;     // [T, E_ov] COO overflow senders
  const int16_t* ovr;     // [T, E_ov] COO overflow receivers
  const float* ovw;       // [T, E_ov] overflow weights
  const int32_t* labels;  // [T, NB]
  const float* mask;      // [T, NB]
  const int32_t* seg;     // [T, NB] pair slot of each node
};

extern "C" int sparse_side_size(void) { return (int)sizeof(SparseSide); }

// Launch layout, filled by the Python plan. Offsets are in 4-byte words
// from the start of dynamic shared memory, each a multiple of 4; the int
// buffers share the same space. The pooling and head buffers (mean .. head)
// may lie inside HW, which is dead once the last aggregation has read it.
struct SparseLayout {
  int ldh;                                   // HW and H row stride (floats)
  int hw_off, h_off;                         // [ru4(NB)][ldh] each
  int mean_off, c_off, att_off, hg_off, hgp_off;   // pooling, own + peer hg
  int head_off;                              // [warps][2 * MAX_HEAD]
  int nw_off, ovw_off, mask_off, pm_off;     // staged float planes
  int nbr_off, ovs_off, ovr_off, list_off;   // staged int planes, COO lists
  int rowoff_off, rowcnt_off, rowlast_off, labels_off, seg_off;
  int live_off;                              // [P + 1]: live slots, count
  int need_off, segs_off;                    // [P], [P + 1]: pooled slots
  int headw_off;                             // NTN V, b and the FCN
  int smem_floats;
};

extern "C" int sparse_layout_size(void) { return (int)sizeof(SparseLayout); }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Columns j..j+3 of a global row of n floats: one 16-byte load when VEC
// (n a multiple of 4, the row 16-byte aligned), else guarded scalar loads
// (columns >= n read as 0).
template <bool VEC>
__device__ __forceinline__ float4 ldg4(const float* __restrict__ row, int j,
                                       int n) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(row + j));
  return make_float4(j < n ? __ldg(row + j) : 0.0f,
                     j + 1 < n ? __ldg(row + j + 1) : 0.0f,
                     j + 2 < n ? __ldg(row + j + 2) : 0.0f,
                     j + 3 < n ? __ldg(row + j + 3) : 0.0f);
}

// hw[i, j] = sum_k h[i, k] w[k, j] + b[j] for i < M, j < ru4(N): each
// element an fmaf chain over k = 0..K-1 in order from 0, then + b[j], as
// dense_transform. A thread owns TM rows (rg, rg + rgs, ...) x 4 columns;
// rows up to ru4(M) of h are read (the plan allots them), lda and ldo are
// multiples of 4.
template <int TM, bool VEC>
__device__ __forceinline__ void gemm_tiles(const float* h, int lda,
                                           const float* __restrict__ w,
                                           const float* __restrict__ b,
                                           int M, int N, int K, float* hw,
                                           int ldo) {
  const int cgs = (N + 3) >> 2;
  const int rgs = (M + TM - 1) / TM;
  for (int t = threadIdx.x; t < rgs * cgs; t += blockDim.x) {
    const int rg = t / cgs, j = (t - rg * cgs) << 2;
    const float* ar[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) ar[r] = h + (rg + r * rgs) * lda;
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= K; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = lds4(ar[r] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv = ldg4<VEC>(w + (size_t)(k + q) * N, j, N);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float x = lane4(av[r], q);
          acc[r][0] = fmaf(x, bv.x, acc[r][0]);
          acc[r][1] = fmaf(x, bv.y, acc[r][1]);
          acc[r][2] = fmaf(x, bv.z, acc[r][2]);
          acc[r][3] = fmaf(x, bv.w, acc[r][3]);
        }
      }
    }
    for (; k < K; ++k) {
      const float4 bv = ldg4<VEC>(w + (size_t)k * N, j, N);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float x = ar[r][k];
        acc[r][0] = fmaf(x, bv.x, acc[r][0]);
        acc[r][1] = fmaf(x, bv.y, acc[r][1]);
        acc[r][2] = fmaf(x, bv.z, acc[r][2]);
        acc[r][3] = fmaf(x, bv.w, acc[r][3]);
      }
    }
    const float4 bv = ldg4<VEC>(b, j, N);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = rg + r * rgs;
      if (i < M)
        *reinterpret_cast<float4*>(hw + i * ldo + j) = make_float4(
            acc[r][0] + bv.x, acc[r][1] + bv.y, acc[r][2] + bv.z,
            acc[r][3] + bv.w);
    }
  }
  __syncthreads();
}

// Four-row tiles unless that leaves threads of the block without one.
template <bool VEC>
__device__ __forceinline__ void gemm(const float* h, int lda,
                                     const float* __restrict__ w,
                                     const float* __restrict__ b, int M,
                                     int N, int K, float* hw, int ldo) {
  if ((M + 3) / 4 * ((N + 3) >> 2) >= (int)blockDim.x)
    gemm_tiles<4, VEC>(h, lda, w, b, M, N, K, hw, ldo);
  else
    gemm_tiles<2, VEC>(h, lda, w, b, M, N, K, hw, ldo);
}

// label_transform, four columns a thread and four tasks' loads in flight,
// on threads tid, tid + step, ...: hw[i, j] = w[labels[i], j] + b[j] for
// j < ru4(f) (0 past f unless VEC).
template <bool VEC>
__device__ __forceinline__ void label_gather(const int* labels, int nb,
                                             const float* __restrict__ w,
                                             const float* __restrict__ b,
                                             int f, float* hw, int ldh,
                                             int tid, int step) {
  const int cgs = (f + 3) >> 2, n = nb * cgs;
  for (int base = tid; base < n; base += 4 * step) {
    float4 v[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * step;
      if (idx < n) {
        const int i = idx / cgs, j = (idx - i * cgs) << 2;
        v[u] = ldg4<VEC>(w + (size_t)labels[i] * f, j, f);
        bv[u] = ldg4<VEC>(b, j, f);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * step;
      if (idx < n) {
        const int i = idx / cgs, j = (idx - i * cgs) << 2;
        *reinterpret_cast<float4*>(hw + i * ldh + j) =
            make_float4(v[u].x + bv[u].x, v[u].y + bv[u].y, v[u].z + bv[u].z,
                        v[u].w + bv[u].w);
      }
    }
  }
}

// csr_aggregate with the overflow slots bucketed by receiver: h[i, j] =
// relu(acc + ov) * mask[i] for j < f, four columns a task, two tasks a
// thread side by side. hw rows are read as float4 (ldh a multiple of 4);
// h is written with row stride ldo.
__device__ __forceinline__ void aggregate(
    const float* hw, int ldh, int nb, int f, int d, const int* nbr,
    const float* nw, const int* rowoff, const int* rowcnt, const int* list,
    const int* ovs, const float* ovw, const float* mask, float* h, int ldo) {
  const int cgs = (f + 3) >> 2, total = nb * cgs, step = blockDim.x;
  for (int t0 = threadIdx.x; t0 < total; t0 += 2 * step) {
    const bool two = t0 + step < total;
    const int t1 = two ? t0 + step : t0;
    const int ia = t0 / cgs, ja = (t0 - ia * cgs) << 2;
    const int ib = t1 / cgs, jb = (t1 - ib * cgs) << 2;
    float4 xa = lds4(hw + nbr[ia] * ldh + ja), xb = lds4(hw + nbr[ib] * ldh + jb);
    float wa = nw[ia], wb = nw[ib];
    float4 a = make_float4(__fmul_rn(wa, xa.x), __fmul_rn(wa, xa.y),
                           __fmul_rn(wa, xa.z), __fmul_rn(wa, xa.w));
    float4 b = make_float4(__fmul_rn(wb, xb.x), __fmul_rn(wb, xb.y),
                           __fmul_rn(wb, xb.z), __fmul_rn(wb, xb.w));
    for (int k = 1; k < d; k += 2) {        // two planes' loads in flight
      const bool pair = k + 1 < d;
      const int sa = k * nb + ia, sb = k * nb + ib;
      const int sa2 = pair ? sa + nb : sa, sb2 = pair ? sb + nb : sb;
      xa = lds4(hw + nbr[sa] * ldh + ja);
      xb = lds4(hw + nbr[sb] * ldh + jb);
      const float4 ya = lds4(hw + nbr[sa2] * ldh + ja);
      const float4 yb = lds4(hw + nbr[sb2] * ldh + jb);
      wa = nw[sa];
      wb = nw[sb];
      a.x = fmaf(wa, xa.x, a.x); a.y = fmaf(wa, xa.y, a.y);
      a.z = fmaf(wa, xa.z, a.z); a.w = fmaf(wa, xa.w, a.w);
      b.x = fmaf(wb, xb.x, b.x); b.y = fmaf(wb, xb.y, b.y);
      b.z = fmaf(wb, xb.z, b.z); b.w = fmaf(wb, xb.w, b.w);
      if (pair) {
        wa = nw[sa2];
        wb = nw[sb2];
        a.x = fmaf(wa, ya.x, a.x); a.y = fmaf(wa, ya.y, a.y);
        a.z = fmaf(wa, ya.z, a.z); a.w = fmaf(wa, ya.w, a.w);
        b.x = fmaf(wb, yb.x, b.x); b.y = fmaf(wb, yb.y, b.y);
        b.z = fmaf(wb, yb.z, b.z); b.w = fmaf(wb, yb.w, b.w);
      }
    }
    float4 oa = make_float4(0.0f, 0.0f, 0.0f, 0.0f), ob = oa;
    const int* ra = list + rowoff[ia];
    const int* rb = list + rowoff[ib];
    const int na = rowcnt[ia], nbk = rowcnt[ib];
    for (int k = 0; k < max(na, nbk); ++k) {
      if (k < na) {
        const int e = ra[k];
        const float4 x = lds4(hw + ovs[e] * ldh + ja);
        const float w = ovw[e];
        oa.x = fmaf(w, x.x, oa.x); oa.y = fmaf(w, x.y, oa.y);
        oa.z = fmaf(w, x.z, oa.z); oa.w = fmaf(w, x.w, oa.w);
      }
      if (k < nbk) {
        const int e = rb[k];
        const float4 x = lds4(hw + ovs[e] * ldh + jb);
        const float w = ovw[e];
        ob.x = fmaf(w, x.x, ob.x); ob.y = fmaf(w, x.y, ob.y);
        ob.z = fmaf(w, x.z, ob.z); ob.w = fmaf(w, x.w, ob.w);
      }
    }
    const float ma = mask[ia];
    float* o = h + ia * ldo + ja;
    o[0] = simgnn_relu(a.x + oa.x) * ma;
    if (ja + 1 < f) o[1] = simgnn_relu(a.y + oa.y) * ma;
    if (ja + 2 < f) o[2] = simgnn_relu(a.z + oa.z) * ma;
    if (ja + 3 < f) o[3] = simgnn_relu(a.w + oa.w) * ma;
    if (two) {
      const float mb = mask[ib];
      o = h + ib * ldo + jb;
      o[0] = simgnn_relu(b.x + ob.x) * mb;
      if (jb + 1 < f) o[1] = simgnn_relu(b.y + ob.y) * mb;
      if (jb + 2 < f) o[2] = simgnn_relu(b.z + ob.z) * mb;
      if (jb + 3 < f) o[3] = simgnn_relu(b.w + ob.w) * mb;
    }
  }
  __syncthreads();
}

// Whether slot e, a zero-weight slot, repeats slot `pred` (same sender,
// same weight bits): the slot before it in its row, or -1.
__device__ __forceinline__ bool repeats(const int* ovs, const float* ovw,
                                        int e, int pred) {
  return pred >= 0 && ovw[e] == 0.0f && ovs[e] == ovs[pred] &&
         __float_as_uint(ovw[e]) == __float_as_uint(ovw[pred]);
}

// One warp: the COO slots of each row i < nb, in ascending slot order, at
// list[rowoff[i] .. rowoff[i] + rowcnt[i]), less each zero-weight slot
// that repeats the slot before it in its row (see the head of this file).
// Two passes over 32-slot chunks (count, then place), each slot's
// predecessor in its row found by match_any within the chunk or in
// rowlast [nb] across chunks. kernels/sparse_pair.py overflow_buckets is
// the same function on the host.
__device__ __forceinline__ void bucket_overflow(const int* ovs,
                                                const int* ovr,
                                                const float* ovw, int e_ov,
                                                int nb, int* rowoff,
                                                int* rowcnt, int* rowlast,
                                                int* list) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = lane; i < nb; i += 32) {
      if (pass == 0) rowcnt[i] = 0;
      rowlast[i] = -1;
    }
    __syncwarp();
    for (int base = 0; base < e_ov; base += 32) {
      const int e = base + lane;
      const int r = e < e_ov ? ovr[e] : -1;
      const bool ok = (unsigned)r < (unsigned)nb;
      const unsigned peers = __match_any_sync(SP_FULL, ok ? r : -1);
      const unsigned lower = peers & below;
      const int pred = !ok ? -1 : lower ? base + 31 - __clz(lower) : rowlast[r];
      const bool keep = ok && !repeats(ovs, ovw, e, pred);
      const unsigned kept = peers & __ballot_sync(SP_FULL, keep);
      if (pass == 1 && keep)
        list[rowoff[r] + rowcnt[r] + __popc(kept & below)] = e;
      __syncwarp();
      if (keep && lane == __ffs(kept) - 1) rowcnt[r] += __popc(kept);
      if (ok && lane == 31 - __clz(peers)) rowlast[r] = e;
      __syncwarp();
    }
    if (pass == 1) break;
    int carry = 0;                                     // exclusive scan
    for (int base = 0; base < nb; base += 32) {
      const int i = base + lane;
      const int c = i < nb ? rowcnt[i] : 0;
      int v = c;
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(SP_FULL, v, o);
        if (lane >= o) v += y;
      }
      if (i < nb) {
        rowoff[i] = carry + v - c;
        rowcnt[i] = 0;
      }
      carry += __shfl_sync(SP_FULL, v, 31);
    }
    __syncwarp();
  }
}

// One warp: the pair slots the pooling computes, ascending, into segs
// (count at segs[p]): the live ones and every slot a masked-in node
// belongs to (the Att weights of all such nodes need their slot's context).
// The head reads only live slots, and no other slot's pooled value reaches
// them.
__device__ __forceinline__ void pooled_slots(const float* pm,
                                             const float* mask,
                                             const int* seg, int nb, int p,
                                             int* need, int* segs) {
  const int lane = threadIdx.x & 31;
  for (int q = lane; q < p; q += 32) need[q] = pm[q] != 0.0f;
  __syncwarp();
  for (int k = lane; k < nb; k += 32)
    if (mask[k] != 0.0f && (unsigned)seg[k] < (unsigned)p) need[seg[k]] = 1;
  __syncwarp();
  int cnt = 0;
  for (int base = 0; base < p; base += 32) {
    const int q = base + lane;
    const bool in = q < p && need[q];
    const unsigned bal = __ballot_sync(SP_FULL, in);
    if (in) segs[cnt + __popc(bal & ((1u << lane) - 1u))] = q;
    cnt += __popc(bal);
  }
  if (lane == 0) segs[p] = cnt;
}

// segment_att_pool (simgnn_common.cuh) for the slots in segs (n_seg of
// them), every output's chain in the same order over all n nodes, for h
// [n, f] with row stride ld (odd, so the Att stage's lanes, one a node,
// read distinct banks); outputs land at their slot's rows of mean, c and
// hg.
__device__ __forceinline__ void pool_segments(const float* h, int ld, int n,
                                              int f,
                                              const float* mask,
                                              const int* seg, const int* segs,
                                              int n_seg,
                                              const float* __restrict__ att_w,
                                              float* mean, float* c,
                                              float* att, float* hg) {
  const int total = n_seg * f, step = blockDim.x;
  for (int i = threadIdx.x; i < total; i += step) {
    const int a = i / f, j = i - a * f, q = segs[a];
    float sum = 0.0f, cnt = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float s = seg[k] == q ? mask[k] : 0.0f;
      sum = fmaf(s, h[k * ld + j], sum);
      cnt += s;
    }
    mean[q * f + j] = sum / fmaxf(cnt, 1.0f);
  }
  __syncthreads();
  SP_STAGE(21);
  for (int i = threadIdx.x; i < total; i += step) {
    const int a = i / f, g = i - a * f, q = segs[a];
    const float* m = mean + q * f;
    float acc = 0.0f;
    int j = 0;
    for (; j + 8 <= f; j += 8) {
      float w[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) w[u] = __ldg(att_w + (j + u) * f + g);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = fmaf(m[j + u], w[u], acc);
    }
    for (; j < f; ++j) acc = fmaf(m[j], __ldg(att_w + j * f + g), acc);
    c[q * f + g] = tanhf(acc);
  }
  __syncthreads();
  SP_STAGE(22);
  for (int k = threadIdx.x; k < n; k += step) {
    float a = 0.0f;
    if (mask[k] != 0.0f) {
      const float* cq = c + seg[k] * f;
      const float* hk = h + k * ld;
      float dot = 0.0f;
#pragma unroll 4
      for (int j = 0; j < f; ++j) dot = fmaf(hk[j], cq[j], dot);
      a = simgnn_sigmoid(dot) * mask[k];
    }
    att[k] = a;
  }
  __syncthreads();
  SP_STAGE(23);
  for (int i = threadIdx.x; i < total; i += step) {
    const int a = i / f, j = i - a * f, q = segs[a];
    float sum = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float s = seg[k] == q ? mask[k] : 0.0f;
      sum = fmaf(s, att[k] * h[k * ld + j], sum);
    }
    hg[q * f + j] = sum;
  }
  __syncthreads();
}

// The head's small weights, copied to shared memory by cp.async on one
// warp (waited for before the pooling): NTN V [K, 2F], b [K], then each
// FCN layer's W and b, each padded to a multiple of 4 floats (the layout
// head_weights reads).
__device__ __forceinline__ void stage_head(const SimgnnParams& P, int F,
                                           float* dst) {
  const int lane = threadIdx.x & 31;
  auto copy = [&](const float* src, int n) {
    copy_async(dst, src, n, lane, 32);
    dst += (n + 3) & ~3;
  };
  copy(P.ntn_v, P.ntn_k * 2 * F);
  copy(P.ntn_b, P.ntn_k);
  for (int l = 0; l < P.n_fcn; ++l) {
    copy(P.fcn_w[l], P.fcn_dims[l] * P.fcn_dims[l + 1]);
    copy(P.fcn_b[l], P.fcn_dims[l + 1]);
  }
}

// Where the head reads NTN V and b and the FCN: the copy stage_head makes
// in shared memory at s.
struct HeadWeights {
  const float* v;
  const float* b;
  const float* fw[SIMGNN_MAX_FCN];
  const float* fb[SIMGNN_MAX_FCN];
};

__device__ __forceinline__ HeadWeights head_weights(const SimgnnParams& P,
                                                    int F, const float* s) {
  HeadWeights H;
  auto take = [&](int n) {
    const float* at = s;
    s += (n + 3) & ~3;
    return at;
  };
  H.v = take(P.ntn_k * 2 * F);
  H.b = take(P.ntn_k);
  for (int l = 0; l < P.n_fcn; ++l) {
    H.fw[l] = take(P.fcn_dims[l] * P.fcn_dims[l + 1]);
    H.fb[l] = take(P.fcn_dims[l + 1]);
  }
  return H;
}

// N slices of ntn_fcn_warp's NTN on one warp, side by side: slice ks[n]
// of the pair (h1[n], h2[n]) by the same loops and butterfly, W read 8
// rows at a time; out[n] = relu(bil + lin + b[k]) on every lane.
template <int N>
__device__ __forceinline__ void ntn_slices(const float* const* h1,
                                           const float* const* h2,
                                           const int* ks,
                                           const SimgnnParams& P,
                                           const HeadWeights& H, float* out) {
  const int lane = threadIdx.x & 31;
  const int F = P.gcn_dims[P.n_gcn];
  float bil[N], lin[N];
#pragma unroll
  for (int n = 0; n < N; ++n) bil[n] = lin[n] = 0.0f;
  for (int g = lane; g < F; g += 32) {
    float t[N];
#pragma unroll
    for (int n = 0; n < N; ++n) t[n] = 0.0f;
    int i = 0;
    for (; i + 8 <= F; i += 8) {
      float wv[N][8];
#pragma unroll
      for (int n = 0; n < N; ++n)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          wv[n][u] = __ldg(P.ntn_w + ((size_t)ks[n] * F + i + u) * F + g);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int n = 0; n < N; ++n) t[n] = fmaf(h1[n][i + u], wv[n][u], t[n]);
    }
    for (; i < F; ++i)
#pragma unroll
      for (int n = 0; n < N; ++n)
        t[n] = fmaf(h1[n][i], __ldg(P.ntn_w + ((size_t)ks[n] * F + i) * F + g),
                    t[n]);
#pragma unroll
    for (int n = 0; n < N; ++n) bil[n] = fmaf(t[n], h2[n][g], bil[n]);
  }
  for (int j = lane; j < 2 * F; j += 32)
#pragma unroll
    for (int n = 0; n < N; ++n)
      lin[n] = fmaf(j < F ? h1[n][j] : h2[n][j - F], H.v[ks[n] * 2 * F + j],
                    lin[n]);
#pragma unroll
  for (int n = 0; n < N; ++n) {
    bil[n] = warp_sum(bil[n]);
    lin[n] = warp_sum(lin[n]);
    out[n] = simgnn_relu(bil[n] + lin[n] + H.b[ks[n]]);
  }
}

// ntn_fcn_warp's FCN and sigmoid on one warp (W read 8 rows at a time):
// buf holds the K NTN outputs and SIMGNN_MAX_HEAD more floats of scratch.
// Returns the score on every lane.
__device__ __forceinline__ float fcn_warp(float* buf, const SimgnnParams& P,
                                          const HeadWeights& H) {
  const int lane = threadIdx.x & 31;
  float* cur = buf;
  float* nxt = buf + SIMGNN_MAX_HEAD;
  for (int l = 0; l < P.n_fcn; ++l) {
    const int din = P.fcn_dims[l], dout = P.fcn_dims[l + 1];
    const float* w = H.fw[l];
    for (int o = lane; o < dout; o += 32) {
      float acc = 0.0f;
      int i = 0;
      for (; i + 8 <= din; i += 8) {
        float wv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) wv[u] = w[(i + u) * dout + o];
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = fmaf(cur[i + u], wv[u], acc);
      }
      for (; i < din; ++i) acc = fmaf(cur[i], w[i * dout + o], acc);
      acc += H.fb[l][o];
      nxt[o] = (l + 1 < P.n_fcn) ? simgnn_relu(acc) : acc;
    }
    __syncwarp();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
  const float s = simgnn_sigmoid(cur[0]);
  __syncwarp();
  return s;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(2, 1, 1)
__launch_bounds__(SIMGNN_THREADS, 2)
sparse_pair_kernel(SparseSide s1, SparseSide s2,
                   const float* __restrict__ pmask, float* __restrict__ out,
                   int nb, int d, int e_ov, int p, SimgnnParams P,
                   SparseLayout L, unsigned vec_w) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* ismem = reinterpret_cast<int*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long t = blockIdx.x >> 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int F = P.gcn_dims[P.n_gcn], E = nb * d;
  float* pm = smem + L.pm_off;
#ifdef SPARSE_PAIR_STAGES
  if (threadIdx.x == 0) {
    unsigned sm;
    long long g;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    sp_stage_buf[blockIdx.x * SP_STAGES + 30] = sm;
    sp_stage_buf[blockIdx.x * SP_STAGES + 31] = g;
  }
#endif
  SP_STAGE(0);
  int* live = ismem + L.live_off;

  // This side's planes, loaded while warp 0 reads the pair mask; a CTA
  // stages at most one element of each plane a thread at a time.
  const SparseSide S = rank ? s2 : s1;
  float* hw = smem + L.hw_off;
  float* h = smem + L.h_off;
  float* nw = smem + L.nw_off;
  float* ovw = smem + L.ovw_off;
  float* mask = smem + L.mask_off;
  int* nbr = ismem + L.nbr_off;
  int* ovs = ismem + L.ovs_off;
  int* ovr = ismem + L.ovr_off;
  int* list = ismem + L.list_off;
  int* rowoff = ismem + L.rowoff_off;
  int* rowcnt = ismem + L.rowcnt_off;
  int* segs = ismem + L.segs_off;
  int* labels = ismem + L.labels_off;
  int* seg = ismem + L.seg_off;
  const int i0 = threadIdx.x;
  int nbr0 = 0, ovs0 = 0, ovr0 = 0, lab0 = 0, seg0 = 0;
  float nw0 = 0.0f, ovw0 = 0.0f, mask0 = 0.0f;
  if (i0 < E) {
    nbr0 = S.nbr[t * E + i0];
    nw0 = S.nw[t * E + i0];
  }
  if (i0 < e_ov) {
    ovs0 = S.ovs[t * e_ov + i0];
    ovr0 = S.ovr[t * e_ov + i0];
    ovw0 = S.ovw[t * e_ov + i0];
  }
  if (i0 < nb) {
    lab0 = S.labels[t * nb + i0];
    mask0 = S.mask[t * nb + i0];
    seg0 = S.seg[t * nb + i0];
  }

  // Live pair slots in ascending order. Both CTAs of the cluster read the
  // same pair mask, so they agree on a pad tile and leave together, before
  // any cluster barrier.
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < p; base += 32) {
      const int q = base + lane;
      const float v = q < p ? pmask[t * p + q] : 0.0f;
      if (q < p) pm[q] = v;
      const bool lv = q < p && v != 0.0f;
      const unsigned bal = __ballot_sync(SP_FULL, lv);
      if (lv) live[cnt + __popc(bal & ((1u << lane) - 1u))] = q;
      cnt += __popc(bal);
    }
    if (lane == 0) live[p] = cnt;
  }
  __syncthreads();
  const int n_live = live[p];
  SP_STAGE(1);
  if (n_live == 0) {                    // pad tile: exact zeros
    if (rank == 0)
      for (int q = threadIdx.x; q < p; q += blockDim.x) out[t * p + q] = 0.0f;
    return;
  }

  if (i0 < E) {
    nbr[i0] = nbr0;
    nw[i0] = nw0;
  }
  if (i0 < e_ov) {
    ovs[i0] = ovs0;
    ovr[i0] = ovr0;
    ovw[i0] = ovw0;
  }
  if (i0 < nb) {
    labels[i0] = lab0;
    mask[i0] = mask0;
    seg[i0] = seg0;
  }
  for (int i = i0 + blockDim.x; i < E; i += blockDim.x) {
    nbr[i] = S.nbr[t * E + i];
    nw[i] = S.nw[t * E + i];
  }
  for (int i = i0 + blockDim.x; i < e_ov; i += blockDim.x) {
    ovs[i] = S.ovs[t * e_ov + i];
    ovr[i] = S.ovr[t * e_ov + i];
    ovw[i] = S.ovw[t * e_ov + i];
  }
  for (int i = i0 + blockDim.x; i < nb; i += blockDim.x) {
    labels[i] = S.labels[t * nb + i];
    mask[i] = S.mask[t * nb + i];
    seg[i] = S.seg[t * nb + i];
  }
  __syncthreads();
  SP_STAGE(2);

  // Warp 0 buckets the overflow slots; warp 1 lists the pooled ones and
  // stages the head's weights (waited for before the pooling); the others
  // run layer 0 (label_transform).
  const int ldh = L.ldh, f1 = P.gcn_dims[1];
  if (warp == 0) {
    bucket_overflow(ovs, ovr, ovw, e_ov, nb, rowoff, rowcnt,
                    ismem + L.rowlast_off, list);
    SP_STAGE(3);
  } else if (warp == 1) {
    pooled_slots(pm, mask, seg, nb, p, ismem + L.need_off, segs);
    stage_head(P, F, smem + L.headw_off);
  } else if (vec_w & 1u) {
    label_gather<true>(labels, nb, P.gcn_w[0], P.gcn_b[0], f1, hw, ldh,
                       threadIdx.x - 64, blockDim.x - 64);
  } else {
    label_gather<false>(labels, nb, P.gcn_w[0], P.gcn_b[0], f1, hw, ldh,
                        threadIdx.x - 64, blockDim.x - 64);
  }
  __syncthreads();
  SP_STAGE(4);
  for (int l = 0; l < P.n_gcn; ++l) {
    const int fin = P.gcn_dims[l], fout = P.gcn_dims[l + 1];
    if (l > 0) {
      if ((vec_w >> l) & 1u)
        gemm<true>(h, ldh, P.gcn_w[l], P.gcn_b[l], nb, fout, fin, hw, ldh);
      else
        gemm<false>(h, ldh, P.gcn_w[l], P.gcn_b[l], nb, fout, fin, hw, ldh);
    }
    SP_STAGE(5 + 2 * l);
    // the last layer's H is written with an odd row stride for the pooling
    aggregate(hw, ldh, nb, fout, d, nbr, nw, rowoff, rowcnt, list, ovs, ovw,
              mask, h, l + 1 == P.n_gcn ? (fout | 1) : ldh);
    SP_STAGE(6 + 2 * l);
  }
  float* hg = smem + L.hg_off;
  // the head's weights have landed (the pooling's barriers publish them)
  cp_async_wait_all();
  pool_segments(h, F | 1, nb, F, mask, seg, segs, segs[p], P.att_w,
                smem + L.mean_off, smem + L.c_off, smem + L.att_off, hg);
  SP_STAGE(24);

  // Both sides pooled: copy the peer's embeddings of the live slots, then
  // tell the peer this CTA is done with its shared memory (it waits for
  // that before it leaves).
  cluster.sync();
  SP_STAGE(25);
  float* hgp = smem + L.hgp_off;
  const float* peer = cluster.map_shared_rank(hg, rank ^ 1u);
  for (int i = threadIdx.x; i < n_live * F; i += blockDim.x) {
    const int r = live[i / F] * F + i % F;
    hgp[r] = peer[r];
  }
  cluster_arrive();
  __syncthreads();
  SP_STAGE(26);

  // Rank r scores the live slots live[r], live[r + 2], ...; rank 0 writes
  // the zeros of the pad slots.
  const float* h1 = rank ? hgp : hg;
  const float* h2 = rank ? hg : hgp;
  if (rank == 0)
    for (int q = threadIdx.x; q < p; q += blockDim.x)
      if (!(pm[q] != 0.0f)) out[t * p + q] = 0.0f;
  float* head = smem + L.head_off;
  const HeadWeights H = head_weights(P, F, smem + L.headw_off);
  const int K = P.ntn_k, mine = (n_live + 1 - (int)rank) / 2;
  for (int base = 0; base < mine; base += SIMGNN_WARPS) {
    const int m = min(SIMGNN_WARPS, mine - base), items = m * K;
    // (slot, slice) items, two a warp side by side
    for (int it = warp; it < items; it += 2 * SIMGNN_WARPS) {
      const int it2 = min(it + SIMGNN_WARPS, items - 1);
      int jj[2], ks[2];
      const float* a[2];
      const float* b[2];
      for (int n = 0; n < 2; ++n) {
        const int x = n ? it2 : it;
        jj[n] = x / K;
        ks[n] = x - jj[n] * K;
        const int q = live[2 * (base + jj[n]) + rank];
        a[n] = h1 + q * F;
        b[n] = h2 + q * F;
      }
      float v[2];
      ntn_slices<2>(a, b, ks, P, H, v);
      if (lane == 0) {
        head[jj[0] * 2 * SIMGNN_MAX_HEAD + ks[0]] = v[0];
        head[jj[1] * 2 * SIMGNN_MAX_HEAD + ks[1]] = v[1];
      }
    }
    __syncthreads();
    if (base == 0) SP_STAGE(27);
    if (warp < m) {
      const int q = live[2 * (base + warp) + rank];
      const float s =
          fcn_warp(head + warp * 2 * SIMGNN_MAX_HEAD, P, H) * pm[q];
      if (lane == 0) out[t * p + q] = s;
    }
    __syncthreads();
  }
  SP_STAGE(28);
  cluster_wait();
  SP_STAGE(29);
}

// Clusters of the kernel the current device holds at once with this
// dynamic shared memory (what the plan's one wave counts on).
extern "C" int sparse_pair_max_clusters(int smem_bytes, int* clusters) {
  cudaError_t err = simgnn_set_smem(sparse_pair_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(SIMGNN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  return (int)cudaOccupancyMaxActiveClusters(clusters, sparse_pair_kernel,
                                              &cfg);
}

// The entry point of the one-CTA kernel, with the plan's layout as a last
// argument: grid 2T (one 2-CTA cluster a tile), SIMGNN_THREADS threads.
extern "C" int sparse_pair_score_launch(const SparseSide* s1,
                                        const SparseSide* s2,
                                        const float* pmask, float* out, int T,
                                        int nb, int d, int e_ov, int p,
                                        const SimgnnParams* P, void* stream,
                                        const SparseLayout* L) {
  if (T < 1 || nb < 1 || d < 1 || e_ov < 0 || p < 1 || L->ldh % 4 != 0 ||
      L->ldh < P->f_max)
    return (int)cudaErrorInvalidValue;
  unsigned vec_w = 0;           // bit l: W_l and b_l take float4 loads
  for (int l = 0; l < P->n_gcn; ++l)
    if (P->gcn_dims[l + 1] % 4 == 0 && ((uintptr_t)P->gcn_w[l] & 15) == 0 &&
        ((uintptr_t)P->gcn_b[l] & 15) == 0)
      vec_w |= 1u << l;
  const size_t smem = (size_t)L->smem_floats * 4;
  cudaError_t err = simgnn_set_smem(sparse_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  sparse_pair_kernel<<<2 * T, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      *s1, *s2, pmask, out, nb, d, e_ov, p, *P, *L, vec_w);
  return (int)cudaGetLastError();
}
