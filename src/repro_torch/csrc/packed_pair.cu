// Packed-dense SimGNN pair-score megakernel for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/packed_pair.py
// (packed_pair_score, body _kernel): per packed tile, both sides' raw
// block-diagonal [NB, NB] adjacency normalized in the kernel to
// D^-1/2 (A + I) D^-1/2 under the node mask, the GCN stack with dense
// aggregation A'·(HW) and a first-layer W1 row gather from int labels,
// segment Att pooling over the P pair slots, NTN, FCN and sigmoid; only the
// [T, P] scores reach global memory.
//
// What bounds it on this card: the float32 FMA rate in principle (a tile
// holds about 2.4 graphs of about 26 nodes at SimGNN-AIDS widths, about
// 4.3 M multiply-adds of per-graph work and 33 KB of input a tile), in
// practice the latency of one tile side's chain of dependent,
// barrier-separated stages. The cluster route shortens that chain:
//   * one tile per 2-CTA cluster, one side per CTA (rank 0 the lhs, rank 1
//     the rhs): a 105-tile request runs 210 CTAs, two resident an SM, and
//     the two sides run at once. After both have pooled, each CTA copies
//     its peer's embeddings of the live pair slots through distributed
//     shared memory and scores its half of them;
//   * loops to the live rows (below): nr = min(NB, ru4(n_eff + 1)) rows;
//   * each row's own columns: while A' is formed, one warp a row finds the
//     first and last column whose entry is not ±0 (ballots), and a thread's
//     row tile chains A'·HW over the union of its rows' ranges instead of
//     all NB columns (a tile's graphs are diagonal blocks, so the range is
//     about a graph wide);
//   * register-tiled float32 products: a thread owns TM (4 or 2) rows x 4
//     columns, float4 operands, TM x 4 independent FMA chains; A' and H
//     rows are padded to 4 mod 32 floats; each layer's W (l >= 1) is read
//     from a shared copy staged by cp.async while the layer before runs,
//     where the plan finds room without costing a CTA an SM, else as
//     float4 through the read-only cache;
//   * the degree pass skips each row's ±0 columns, one row a lane spread
//     over all warps, beside the ballots;
//   * the pooling computes only the slots the head reads (and those of
//     masked-in nodes, whose Att weights need them);
//   * the NTN's K slices of each live slot spread over the warps, two a
//     warp, then the FCN and the sigmoid on one warp a slot; the NTN W, V
//     and b and the FCN are read from a shared copy, staged by cp.async into
//     the layer buffers once the last aggregation is done with them, while
//     the pooling runs.
// The shared-memory layout comes from the Python plan,
// kernels/packed_pair.py packed_pair_plan. NB whose buffers fit no cluster
// layout take the single route: the one-CTA-per-tile kernel this design
// replaced, unchanged.
//
// Arithmetic: every output is computed by the same float32 operations in
// the same order as the single route (simgnn_common.cuh normalize_block,
// label_transform, dense_transform, dense_aggregate, segment_att_pool,
// ntn_fcn_warp), so the scores are the same bits. A'[i, j] = ((adj +
// [i == j]) * (mask[i] * mask[j])) * inv[i] * inv[j]; HW[i, j] an fmaf
// chain over k = 0..fin-1 from 0, then + b[j]; H[i, j] = relu(fmaf chain
// over nodes k in order from 0) * mask[i]; every pooled output is
// segment_att_pool's chain over all NB nodes; each NTN slice and the FCN
// are ntn_fcn_warp's loops. Why the shortened loops keep the bits:
//   * a term fmaf(±0, x, acc) is acc whenever x is finite, because acc
//     starts at +0 and is never -0 (an exact zero sum rounds to +0). So a
//     chain over k in [first, last] of a row equals the chain over all
//     columns when every HW[k, j] the skipped terms read is finite. Each
//     layer computes "every HW entry of the rows the chains may read is
//     finite" (__syncthreads_or over the product's outputs); when it is
//     not, that layer runs the full chain. The degree sums skip ±0 columns
//     the same way (deg += ±0 leaves deg as it is). The ranges come from
//     the A' the kernel forms, never from seg, so any adjacency keeps the
//     bits;
//   * live rows (as csrc/fused_pair.cu): a row k is null when mask[k] and
//     the raw A' row and column k are all zero. With mask[k] == 0 every
//     entry of row and column k is ±0 or NaN, and the normalization keeps
//     each ±0 a zero and each NaN a NaN, so the raw and the normalized A'
//     have the same null rows. The rows n_eff..NB-1 (n_eff = 1 + the last
//     non-null row) are null and all add the same term to every node-
//     ordered chain once their HW rows are equivalent: from layer 1 on,
//     HW[k] = H[k] W + b of an H row that is +0 or NaN in each column alike
//     (relu of a chain of ±0 terms, times mask ±0). So the chains run over
//     nr rows, one null row standing for all. Layer 0's HW rows are W1
//     row gathers by label, which differ between null rows, so the gather
//     covers all NB rows and layer 0's finite test with them: when some row
//     is not finite, layer 0 runs the full chain over all NB rows. The
//     pooling reads row nr - 1 (null when nr < NB) for the nodes past nr.
#include <cooperative_groups.h>

#include "async_copy.cuh"
#include "simgnn_common.cuh"

namespace cg = cooperative_groups;

#define PP_FULL 0xffffffffu

// Stage clocks, compiled in only by tools/packed_pair_stages.py (which
// defines PACKED_PAIR_STAGES): thread 0 of each cluster-route CTA records
// clock64() as stage k ends, into PP_STAGES slots a CTA of a buffer the
// tool hands packed_pair_stage_buffer (slot 30: the SM, 31: the global
// timer at the start).
#define PP_STAGES 32
#ifdef PACKED_PAIR_STAGES
__device__ long long* pp_stage_buf;
extern "C" int packed_pair_stage_buffer(long long* buf) {
  return (int)cudaMemcpyToSymbol(pp_stage_buf, &buf, sizeof(buf));
}
#define PP_STAGE(k)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0)                                                \
      pp_stage_buf[blockIdx.x * PP_STAGES + (k)] = clock64();            \
  } while (0)
#else
#define PP_STAGE(k) \
  do {              \
  } while (0)
#endif

struct PackedSide {
  const float* adj;       // [T, NB, NB] raw block-diagonal adjacency
  const int32_t* labels;  // [T, NB]
  const float* mask;      // [T, NB]
  const int32_t* seg;     // [T, NB]
};

extern "C" int packed_side_size(void) { return (int)sizeof(PackedSide); }

// ------------------------------------------------------- the single route

static size_t packed_smem_bytes(int nb, int p, const SimgnnParams& P) {
  const int F = P.gcn_dims[P.n_gcn];
  const size_t floats = (size_t)nb * nb                // A'
                        + 2 * (size_t)nb * P.f_max     // HW, H
                        + 4 * (size_t)p * F            // hg (2 sides), mean, c
                        + 3 * (size_t)nb               // att, mask, inv
                        + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD;
  return (floats + 2 * (size_t)nb) * 4;                // + labels, seg
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
packed_pair_kernel(PackedSide s1, PackedSide s2, const float* __restrict__ pmask,
                   float* __restrict__ out, int nb, int p, SimgnnParams P) {
  extern __shared__ float smem[];
  __shared__ int any_live;
  const long t = blockIdx.x;
  const int F = P.gcn_dims[P.n_gcn];
  const float* pm = pmask + t * p;
  if (threadIdx.x == 0) {
    int live = 0;
    for (int q = 0; q < p; ++q) live |= pm[q] != 0.0f;
    any_live = live;
  }
  __syncthreads();
  if (!any_live) {                      // pad tile: exact zeros
    for (int q = threadIdx.x; q < p; q += blockDim.x) out[t * p + q] = 0.0f;
    return;
  }
  float* a = smem;
  float* hw = a + (size_t)nb * nb;
  float* h = hw + (size_t)nb * P.f_max;
  float* hg = h + (size_t)nb * P.f_max;     // [2, p, F]
  float* mean = hg + 2 * p * F;
  float* c = mean + p * F;
  float* att = c + p * F;
  float* mask = att + nb;
  float* inv = mask + nb;
  float* head = inv + nb;
  int* labels = (int*)(head + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD);
  int* seg = labels + nb;

  for (int side = 0; side < 2; ++side) {
    const PackedSide& S = side ? s2 : s1;
    for (int i = threadIdx.x; i < nb; i += blockDim.x) {
      labels[i] = S.labels[t * nb + i];
      mask[i] = S.mask[t * nb + i];
      seg[i] = S.seg[t * nb + i];
    }
    __syncthreads();
    normalize_block(S.adj + t * nb * nb, mask, nb, a, inv);
    gcn_stack(P, nb, labels, nullptr, hw, h,
              [&](const float* x, int f, float* y) {
                dense_aggregate(a, x, nb, f, mask, y);
              });
    segment_att_pool(h, nb, F, mask, seg, p, P.att_w, mean, c, att,
                     hg + side * p * F);
  }
  const int warp = threadIdx.x >> 5;
  for (int q = warp; q < p; q += SIMGNN_WARPS) {
    float s = 0.0f;
    if (pm[q] != 0.0f)
      s = ntn_fcn_warp(hg + q * F, hg + (p + q) * F, P,
                       head + warp * 2 * SIMGNN_MAX_HEAD) * pm[q];
    if ((threadIdx.x & 31) == 0) out[t * p + q] = s;
  }
}

static int packed_pair_single_launch(const PackedSide* s1, const PackedSide* s2,
                                     const float* pmask, float* out, int T,
                                     int nb, int p, const SimgnnParams* P,
                                     void* stream) {
  const size_t smem = packed_smem_bytes(nb, p, *P);
  cudaError_t err = simgnn_set_smem(packed_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  packed_pair_kernel<<<T, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      *s1, *s2, pmask, out, nb, p, *P);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the cluster route

// Launch layout, filled by the Python plan. Offsets are in 4-byte words
// from the start of dynamic shared memory, each a multiple of 4; the int
// buffers share the same space. H, A' and HW lie in this order; once the
// last aggregation is done, everything past the last layer's H (odd row
// stride F | 1) up to the end of HW is dead, and the head's weights (and
// the pooling buffers, where they fit too) may lie there.
struct PackedLayout {
  int route;                                 // 0: single, 1: cluster
  int lda, ldh;                              // A' and HW / H row strides
  int h_off, a_off, hw_off;                  // [ru4(NB)][ld] each
  int mask_off, inv_off, pm_off;             // [NB], [NB], [P]
  int labels_off, seg_off, first_off, last_off;    // int [NB] each
  int live_off, need_off, segs_off, neff_off;      // [P + 1], [P], [P + 1], [1]
  int mean_off, c_off, att_off, hg_off, hgp_off;   // pooling, own + peer hg
  int head_off;                              // [warps][2 * MAX_HEAD]
  int w_off, w_stage;                        // staged W_l, layers l in mask
  int headw_off;                             // NTN W, V, b and the FCN
  int smem_floats;
};

extern "C" int packed_layout_size(void) { return (int)sizeof(PackedLayout); }

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Whether any of the first n (<= 4) lanes of v is not finite.
__device__ __forceinline__ bool nonfinite4(const float4& v, int n) {
  return !isfinite(v.x) || (n > 1 && !isfinite(v.y)) ||
         (n > 2 && !isfinite(v.z)) || (n > 3 && !isfinite(v.w));
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

// W_l [fin][fout] from global into shared [fin][ru4(fout)] by cp.async
// (16-byte copies when vec); the pad columns are left as they are: they
// only feed HW and H pad columns, which no later stage reads.
__device__ __forceinline__ void stage_w(float* dst, const float* __restrict__ w,
                                        int fin, int fout, bool vec) {
  const int ld = (fout + 3) & ~3;
  if (vec) {
    const int q = fout >> 2;
    for (int idx = threadIdx.x; idx < fin * q; idx += blockDim.x) {
      const int k = idx / q, c = (idx - k * q) << 2;
      cp_async16(dst + k * ld + c, w + (size_t)k * fout + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < fin * fout; idx += blockDim.x) {
      const int k = idx / fout, c = idx - k * fout;
      cp_async4(dst + k * ld + c, w + idx);
    }
  }
  cp_async_commit();
}

// label_transform for all nb rows, four columns a task: hw[i, j] =
// w[labels[i], j] + b[j] for j < ru4(f) (0 past f unless VEC). Returns,
// on every thread, whether some value of a column < f is not finite.
template <bool VEC>
__device__ __forceinline__ bool label_gather(const int* labels, int nb,
                                             const float* __restrict__ w,
                                             const float* __restrict__ b,
                                             int f, float* hw, int ldh) {
  const int cgs = (f + 3) >> 2, n = nb * cgs, step = blockDim.x;
  bool bad = false;
  for (int base = threadIdx.x; base < n; base += 4 * step) {
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
        const float4 o = make_float4(v[u].x + bv[u].x, v[u].y + bv[u].y,
                                     v[u].z + bv[u].z, v[u].w + bv[u].w);
        *reinterpret_cast<float4*>(hw + i * ldh + j) = o;
        bad |= nonfinite4(o, min(4, f - j));
      }
    }
  }
  return __syncthreads_or(bad);
}

// hw[i, :] = x[i, :] W + b for i < M (dense_transform's chains: fmaf over
// k = 0..K-1 from 0, then + b[j]), W read from its staged shared copy
// ([K][ru4(N)]) when SHARED, else from global memory (float4 when VEC). A
// thread owns TM rows (rg, rg + rgs, ...) x 4 columns; rows up to ru4(M)
// of x are read (the plan allots them). Returns, on every thread, whether
// some output of a column < N is not finite.
template <int TM, bool SHARED, bool VEC>
__device__ __forceinline__ bool transform_tiles(const float* x, int ldx,
                                                const float* w,
                                                const float* __restrict__ b,
                                                int M, int N, int K, float* hw,
                                                int ldo) {
  const int cgs = (N + 3) >> 2, ldw = (N + 3) & ~3;
  const int rgs = (M + TM - 1) / TM;
  bool bad = false;
  for (int t = threadIdx.x; t < rgs * cgs; t += blockDim.x) {
    const int rg = t / cgs, j = (t - rg * cgs) << 2;
    const float* xr[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) xr[r] = x + (rg + r * rgs) * ldx;
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    auto wrow = [&](int k) -> float4 {
      if (SHARED) return lds4(w + k * ldw + j);
      return ldg4<VEC>(w + (size_t)k * N, j, N);
    };
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= K; k += 4) {
      float4 xv[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) xv[r] = lds4(xr[r] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 wv = wrow(k + q);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float e = lane4(xv[r], q);
          acc[r][0] = fmaf(e, wv.x, acc[r][0]);
          acc[r][1] = fmaf(e, wv.y, acc[r][1]);
          acc[r][2] = fmaf(e, wv.z, acc[r][2]);
          acc[r][3] = fmaf(e, wv.w, acc[r][3]);
        }
      }
    }
    for (; k < K; ++k) {
      const float4 wv = wrow(k);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float e = xr[r][k];
        acc[r][0] = fmaf(e, wv.x, acc[r][0]);
        acc[r][1] = fmaf(e, wv.y, acc[r][1]);
        acc[r][2] = fmaf(e, wv.z, acc[r][2]);
        acc[r][3] = fmaf(e, wv.w, acc[r][3]);
      }
    }
    const float4 bv = ldg4<VEC>(b, j, N);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = rg + r * rgs;
      if (i < M) {
        const float4 o = make_float4(acc[r][0] + bv.x, acc[r][1] + bv.y,
                                     acc[r][2] + bv.z, acc[r][3] + bv.w);
        *reinterpret_cast<float4*>(hw + i * ldo + j) = o;
        bad |= nonfinite4(o, min(4, N - j));
      }
    }
  }
  return __syncthreads_or(bad);
}

// Four-row tiles unless that leaves threads of the block without one.
template <bool SHARED, bool VEC>
__device__ __forceinline__ bool transform(const float* x, int ldx,
                                          const float* w,
                                          const float* __restrict__ b, int M,
                                          int N, int K, float* hw, int ldo) {
  if ((M + 3) / 4 * ((N + 3) >> 2) >= (int)blockDim.x)
    return transform_tiles<4, SHARED, VEC>(x, ldx, w, b, M, N, K, hw, ldo);
  return transform_tiles<2, SHARED, VEC>(x, ldx, w, b, M, N, K, hw, ldo);
}

// h[i, j] = relu(sum_k a[i, k] hw[k, j]) * mask[i] for i < M, j < N: the
// fmaf chain over k in order from 0 (dense_aggregate). A thread owns TM
// consecutive rows x 4 columns. With `ranged` (every HW entry the chains
// may read is finite) it chains over k from the first of its rows' first
// nonzero columns (rounded down to a multiple of 4) to the last of their
// last ones, else over k < kfull. h is written with row stride ldo (float4
// stores when it is a multiple of 4; pad columns then hold values no stage
// reads).
template <int TM>
__device__ __forceinline__ void aggregate_tiles(
    const float* a, int lda, const float* hw, int ldh, const int* first,
    const int* last, bool ranged, int kfull, int M, int N,
    const float* mask, float* h, int ldo) {
  const int cgs = (N + 3) >> 2, rgs = (M + TM - 1) / TM;
  for (int t = threadIdx.x; t < rgs * cgs; t += blockDim.x) {
    const int rg = t / cgs, j = (t - rg * cgs) << 2, r0 = rg * TM;
    int kb = 0, ke = kfull;
    if (ranged) {
      kb = kfull;
      ke = 0;
#pragma unroll
      for (int r = 0; r < TM; ++r)
        if (r0 + r < M) {
          kb = min(kb, first[r0 + r]);
          ke = max(ke, last[r0 + r] + 1);
        }
      kb &= ~3;
    }
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    const float* ar = a + r0 * lda;
    int k = kb;
#pragma unroll 2
    for (; k + 4 <= ke; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = lds4(ar + r * lda + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv = lds4(hw + (k + q) * ldh + j);
#pragma unroll
        for (int r = 0; r < TM; ++r) {
          const float e = lane4(av[r], q);
          acc[r][0] = fmaf(e, bv.x, acc[r][0]);
          acc[r][1] = fmaf(e, bv.y, acc[r][1]);
          acc[r][2] = fmaf(e, bv.z, acc[r][2]);
          acc[r][3] = fmaf(e, bv.w, acc[r][3]);
        }
      }
    }
    for (; k < ke; ++k) {
      const float4 bv = lds4(hw + k * ldh + j);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float e = ar[r * lda + k];
        acc[r][0] = fmaf(e, bv.x, acc[r][0]);
        acc[r][1] = fmaf(e, bv.y, acc[r][1]);
        acc[r][2] = fmaf(e, bv.z, acc[r][2]);
        acc[r][3] = fmaf(e, bv.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = r0 + r;
      if (i >= M) continue;
      const float mi = mask[i];
      const float4 o = make_float4(
          simgnn_relu(acc[r][0]) * mi, simgnn_relu(acc[r][1]) * mi,
          simgnn_relu(acc[r][2]) * mi, simgnn_relu(acc[r][3]) * mi);
      float* dst = h + i * ldo + j;
      if ((ldo & 3) == 0) {
        *reinterpret_cast<float4*>(dst) = o;
      } else {
        dst[0] = o.x;
        if (j + 1 < N) dst[1] = o.y;
        if (j + 2 < N) dst[2] = o.z;
        if (j + 3 < N) dst[3] = o.w;
      }
    }
  }
  __syncthreads();
}

// Four-row tiles unless that leaves threads of the block without one.
__device__ __forceinline__ void aggregate(const float* a, int lda,
                                          const float* hw, int ldh,
                                          const int* first, const int* last,
                                          bool ranged, int kfull, int M, int N,
                                          const float* mask, float* h,
                                          int ldo) {
  if ((M + 3) / 4 * ((N + 3) >> 2) >= (int)blockDim.x)
    aggregate_tiles<4>(a, lda, hw, ldh, first, last, ranged, kfull, M, N,
                       mask, h, ldo);
  else
    aggregate_tiles<2>(a, lda, hw, ldh, first, last, ranged, kfull, M, N,
                       mask, h, ldo);
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
    const unsigned bal = __ballot_sync(PP_FULL, in);
    if (in) segs[cnt + __popc(bal & ((1u << lane) - 1u))] = q;
    cnt += __popc(bal);
  }
  if (lane == 0) segs[p] = cnt;
}

// segment_att_pool (simgnn_common.cuh) for the slots in segs (n_seg of
// them), every output's chain in the same order over all n nodes, for h
// [nr][ld] (ld odd, so the Att stage's lanes, one a node, read distinct
// banks); node k >= nr reads row nr - 1, a null row standing for all of
// them. Outputs land at their slot's rows of mean, c and hg.
__device__ __forceinline__ void pool_segments(const float* h, int ld, int n,
                                              int nr, int f,
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
      sum = fmaf(s, h[min(k, nr - 1) * ld + j], sum);
      cnt += s;
    }
    mean[q * f + j] = sum / fmaxf(cnt, 1.0f);
  }
  __syncthreads();
  PP_STAGE(21);
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
  PP_STAGE(22);
  for (int k = threadIdx.x; k < n; k += step) {
    float a = 0.0f;
    if (mask[k] != 0.0f) {
      const float* cq = c + seg[k] * f;
      const float* hk = h + min(k, nr - 1) * ld;
      float dot = 0.0f;
#pragma unroll 4
      for (int j = 0; j < f; ++j) dot = fmaf(hk[j], cq[j], dot);
      a = simgnn_sigmoid(dot) * mask[k];
    }
    att[k] = a;
  }
  __syncthreads();
  PP_STAGE(23);
  for (int i = threadIdx.x; i < total; i += step) {
    const int a = i / f, j = i - a * f, q = segs[a];
    float sum = 0.0f;
#pragma unroll 4
    for (int k = 0; k < n; ++k) {
      const float s = seg[k] == q ? mask[k] : 0.0f;
      sum = fmaf(s, att[k] * h[min(k, nr - 1) * ld + j], sum);
    }
    hg[q * f + j] = sum;
  }
  __syncthreads();
}

// The head's weights, copied to shared memory by cp.async on every thread:
// NTN W [K, F, F], V [K, 2F], b [K], then each FCN layer's W and b, each
// padded to a multiple of 4 floats (the layout head_weights reads).
__device__ __forceinline__ void stage_head(const SimgnnParams& P, int F,
                                           float* dst) {
  auto copy = [&](const float* src, int n) {
    copy_async(dst, src, n, threadIdx.x, blockDim.x);
    dst += (n + 3) & ~3;
  };
  copy(P.ntn_w, P.ntn_k * F * F);
  copy(P.ntn_v, P.ntn_k * 2 * F);
  copy(P.ntn_b, P.ntn_k);
  for (int l = 0; l < P.n_fcn; ++l) {
    copy(P.fcn_w[l], P.fcn_dims[l] * P.fcn_dims[l + 1]);
    copy(P.fcn_b[l], P.fcn_dims[l + 1]);
  }
  cp_async_commit();
}

// Where the head reads its weights: the copy stage_head makes at s (the
// FCN layers' W and b follow one another from fcn on).
struct HeadWeights {
  const float* w;
  const float* v;
  const float* b;
  const float* fcn;
};

__device__ __forceinline__ HeadWeights head_weights(const SimgnnParams& P,
                                                    int F, const float* s) {
  HeadWeights H;
  auto take = [&](int n) {
    const float* at = s;
    s += (n + 3) & ~3;
    return at;
  };
  H.w = take(P.ntn_k * F * F);
  H.v = take(P.ntn_k * 2 * F);
  H.b = take(P.ntn_k);
  H.fcn = s;
  return H;
}

// Two slices of ntn_fcn_warp's NTN on one warp, side by side: slice ks[n]
// of the pair (h1[n], h2[n]) by the same loops and butterfly, W read 8
// rows at a time from its shared copy; out[n] = relu(bil + lin + b[k]) on
// every lane.
__device__ __forceinline__ void ntn_slices(const float* const* h1,
                                           const float* const* h2,
                                           const int* ks, int F,
                                           const HeadWeights& H, float* out) {
  const int lane = threadIdx.x & 31;
  float bil[2] = {0.0f, 0.0f}, lin[2] = {0.0f, 0.0f};
  for (int g = lane; g < F; g += 32) {
    float t[2] = {0.0f, 0.0f};
    int i = 0;
    for (; i + 8 <= F; i += 8) {
      float wv[2][8];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int u = 0; u < 8; ++u)
          wv[n][u] = H.w[(ks[n] * F + i + u) * F + g];
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int n = 0; n < 2; ++n) t[n] = fmaf(h1[n][i + u], wv[n][u], t[n]);
    }
    for (; i < F; ++i)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        t[n] = fmaf(h1[n][i], H.w[(ks[n] * F + i) * F + g], t[n]);
#pragma unroll
    for (int n = 0; n < 2; ++n) bil[n] = fmaf(t[n], h2[n][g], bil[n]);
  }
  for (int j = lane; j < 2 * F; j += 32)
#pragma unroll
    for (int n = 0; n < 2; ++n)
      lin[n] = fmaf(j < F ? h1[n][j] : h2[n][j - F], H.v[ks[n] * 2 * F + j],
                    lin[n]);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
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
  const float* w = H.fcn;
  for (int l = 0; l < P.n_fcn; ++l) {
    const int din = P.fcn_dims[l], dout = P.fcn_dims[l + 1];
    const float* b = w + ((din * dout + 3) & ~3);
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
      acc += b[o];
      nxt[o] = (l + 1 < P.n_fcn) ? simgnn_relu(acc) : acc;
    }
    __syncwarp();
    float* tmp = cur; cur = nxt; nxt = tmp;
    w = b + ((dout + 3) & ~3);
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
packed_pair_cluster_kernel(PackedSide s1, PackedSide s2,
                           const float* __restrict__ pmask,
                           float* __restrict__ out, int nb, int p,
                           SimgnnParams P, PackedLayout L, unsigned vec_w,
                           int vec_a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  int* ismem = reinterpret_cast<int*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long t = blockIdx.x >> 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int F = P.gcn_dims[P.n_gcn], l_last = P.n_gcn - 1;
  const int lda = L.lda, ldh = L.ldh;
  const PackedSide S = rank ? s2 : s1;
  float* pm = smem + L.pm_off;
  float* mask = smem + L.mask_off;
  float* inv = smem + L.inv_off;
  float* a = smem + L.a_off;
  float* hw = smem + L.hw_off;
  float* h = smem + L.h_off;
  float* ws = smem + max(L.w_off, 0);   // used only when w_stage is set
  int* labels = ismem + L.labels_off;
  int* seg = ismem + L.seg_off;
  int* first = ismem + L.first_off;
  int* last = ismem + L.last_off;
  int* live = ismem + L.live_off;
  int* segs = ismem + L.segs_off;
  int* neff = ismem + L.neff_off;
#ifdef PACKED_PAIR_STAGES
  if (threadIdx.x == 0) {
    unsigned sm;
    long long g;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    pp_stage_buf[blockIdx.x * PP_STAGES + 30] = sm;
    pp_stage_buf[blockIdx.x * PP_STAGES + 31] = g;
  }
#endif
  PP_STAGE(0);

  // A thread's first four float4 of the raw adjacency (the whole tile at
  // NB 64), loaded before anything waits. Then the live pair slots in
  // ascending order (warp 0) while the others load this side's labels,
  // mask and segments. Both CTAs of the cluster read the same pair mask, so
  // they agree on a pad tile and leave together, before any cluster
  // barrier.
  const float* __restrict__ adj = S.adj + t * nb * nb;
  const float4* __restrict__ adj4 = reinterpret_cast<const float4*>(adj);
  const int n4 = vec_a ? nb * (nb >> 2) : 0;
  float4 pre[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int idx = threadIdx.x + u * blockDim.x;
    if (idx < n4) pre[u] = __ldg(adj4 + idx);
  }
  if (warp == 0) {
    int cnt = 0;
    for (int base = 0; base < p; base += 32) {
      const int q = base + lane;
      const float v = q < p ? pmask[t * p + q] : 0.0f;
      if (q < p) pm[q] = v;
      const bool lv = q < p && v != 0.0f;
      const unsigned bal = __ballot_sync(PP_FULL, lv);
      if (lv) live[cnt + __popc(bal & ((1u << lane) - 1u))] = q;
      cnt += __popc(bal);
    }
    if (lane == 0) {
      live[p] = cnt;
      *neff = 0;
    }
  } else {
    for (int i = threadIdx.x - 32; i < nb; i += blockDim.x - 32) {
      labels[i] = S.labels[t * nb + i];
      mask[i] = S.mask[t * nb + i];
      seg[i] = S.seg[t * nb + i];
    }
  }
  __syncthreads();
  const int n_live = live[p];
  PP_STAGE(1);
  if (n_live == 0) {                    // pad tile: exact zeros
    if (rank == 0)
      for (int q = threadIdx.x; q < p; q += blockDim.x) out[t * p + q] = 0.0f;
    return;
  }
  if (L.w_stage & 2u)                   // W_1, waited for before layer 1
    stage_w(ws, P.gcn_w[1], P.gcn_dims[1], P.gcn_dims[2], (vec_w >> 1) & 1u);

  // The raw A' of all NB rows, and layer 0's W1 row gather of all NB rows
  // with its finite test.
  if (vec_a) {
    const int q = nb >> 2;
    auto raw4 = [&](int idx, const float4& x4) {
      const int i = idx / q, j = (idx - i * q) << 2;
      const float mi = mask[i];
      float4 o;
      o.x = (x4.x + (i == j ? 1.0f : 0.0f)) * (mi * mask[j]);
      o.y = (x4.y + (i == j + 1 ? 1.0f : 0.0f)) * (mi * mask[j + 1]);
      o.z = (x4.z + (i == j + 2 ? 1.0f : 0.0f)) * (mi * mask[j + 2]);
      o.w = (x4.w + (i == j + 3 ? 1.0f : 0.0f)) * (mi * mask[j + 3]);
      *reinterpret_cast<float4*>(a + i * lda + j) = o;
    };
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = threadIdx.x + u * blockDim.x;
      if (idx < n4) raw4(idx, pre[u]);
    }
#pragma unroll 4
    for (int idx = threadIdx.x + 4 * blockDim.x; idx < n4; idx += blockDim.x)
      raw4(idx, __ldg(adj4 + idx));
  } else {
    for (int idx = threadIdx.x; idx < nb * nb; idx += blockDim.x) {
      const int i = idx / nb, j = idx - i * nb;
      a[i * lda + j] = (__ldg(adj + idx) + (i == j ? 1.0f : 0.0f)) *
                       (mask[i] * mask[j]);
    }
  }
  const int f1 = P.gcn_dims[1];
  const bool bad0 =
      (vec_w & 1u)
          ? label_gather<true>(labels, nb, P.gcn_w[0], P.gcn_b[0], f1, hw, ldh)
          : label_gather<false>(labels, nb, P.gcn_w[0], P.gcn_b[0], f1, hw,
                                ldh);
  PP_STAGE(2);

  // Warp w takes rows w, w + 8, ...: for each, the first and last column
  // whose raw entry is not ±0 (NaN included) by ballots, then lane r sums
  // the degree of the warp's r-th row over that range and the live rows
  // are found.
  for (int base = warp; base < nb; base += 32 * SIMGNN_WARPS) {
    int mine = -1, fi = 0, la = -1;
    for (int r0 = 0; r0 < 32 && base + r0 * SIMGNN_WARPS < nb; r0 += 4) {
      int f0[4], l0[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        f0[u] = nb;
        l0[u] = -1;
      }
      for (int c0 = 0; c0 < nb; c0 += 32) {     // four rows' loads in flight
        const int c = c0 + lane;
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = base + (r0 + u) * SIMGNN_WARPS;
          v[u] = i < nb && c < nb ? a[i * lda + c] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const unsigned bal = __ballot_sync(PP_FULL, v[u] != 0.0f);
          if (bal) {
            if (f0[u] == nb) f0[u] = c0 + __ffs(bal) - 1;
            l0[u] = c0 + 31 - __clz(bal);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (lane == r0 + u && base + (r0 + u) * SIMGNN_WARPS < nb) {
          mine = base + (r0 + u) * SIMGNN_WARPS;
          fi = f0[u];
          la = l0[u];
        }
    }
    int v = 0;
    if (mine >= 0) {
      first[mine] = fi;
      last[mine] = la;
      const float* ar = a + mine * lda;
      float deg = 0.0f;
      for (int k = fi; k <= la; ++k) deg += ar[k];
      inv[mine] = deg > 0.0f ? 1.0f / sqrtf(fmaxf(deg, 1e-12f)) : 0.0f;
      if (mask[mine] != 0.0f || la >= 0) v = max(mine, la) + 1;
    }
    v = __reduce_max_sync(PP_FULL, v);
    if (lane == 0 && v > 0) atomicMax(neff, v);
  }
  __syncthreads();
  PP_STAGE(3);
  const int nr = min(nb, (*neff + 4) & ~3);

  // A' normalized in place for the live rows, over all NB columns; warp 0
  // first lists the pooled slots.
  if (warp == 0)
    pooled_slots(pm, mask, seg, nb, p, ismem + L.need_off, segs);
  if (vec_a) {
    const int q = nb >> 2;
    for (int idx = threadIdx.x; idx < nr * q; idx += blockDim.x) {
      const int i = idx / q, j = (idx - i * q) << 2;
      float4* ai = reinterpret_cast<float4*>(a + i * lda + j);
      float4 o = *ai;
      const float ii = inv[i];
      o.x = o.x * ii * inv[j];
      o.y = o.y * ii * inv[j + 1];
      o.z = o.z * ii * inv[j + 2];
      o.w = o.w * ii * inv[j + 3];
      *ai = o;
    }
  } else {
    for (int idx = threadIdx.x; idx < nr * nb; idx += blockDim.x) {
      const int i = idx / nb, j = idx - i * nb;
      a[i * lda + j] = a[i * lda + j] * inv[i] * inv[j];
    }
  }
  __syncthreads();
  PP_STAGE(4);

  // The GCN stack over the live rows. Layer 0 chains over all NB rows when
  // its gather found a value that is not finite; the layers after it over
  // nr rows when theirs did.
  bool ranged = !bad0;
  for (int l = 0; l <= l_last; ++l) {
    const int fin = P.gcn_dims[l], fout = P.gcn_dims[l + 1];
    if (l > 0) {
      const bool staged = (L.w_stage >> l) & 1u, vec = (vec_w >> l) & 1u;
      if (staged) {
        cp_async_wait_all();
        __syncthreads();
      }
      bool bad;
      if (staged)
        bad = vec ? transform<true, true>(h, ldh, ws, P.gcn_b[l], nr, fout,
                                          fin, hw, ldh)
                  : transform<true, false>(h, ldh, ws, P.gcn_b[l], nr, fout,
                                           fin, hw, ldh);
      else
        bad = vec ? transform<false, true>(h, ldh, P.gcn_w[l], P.gcn_b[l], nr,
                                           fout, fin, hw, ldh)
                  : transform<false, false>(h, ldh, P.gcn_w[l], P.gcn_b[l],
                                            nr, fout, fin, hw, ldh);
      ranged = !bad;
      PP_STAGE(5 + 2 * l);
      if (l < l_last && ((L.w_stage >> (l + 1)) & 1u))
        stage_w(ws, P.gcn_w[l + 1], fout, P.gcn_dims[l + 2],
                (vec_w >> (l + 1)) & 1u);
    }
    // the last layer's H is written with an odd row stride for the pooling
    aggregate(a, lda, hw, ldh, first, last, ranged, l == 0 ? nb : nr, nr,
              fout, mask, h, l == l_last ? (fout | 1) : ldh);
    PP_STAGE(6 + 2 * l);
  }

  // The head's weights into the dead layer buffers while the pooling runs
  // (waited for before the head), where this CTA scores a slot.
  const int mine = (n_live + 1 - (int)rank) / 2;
  if (mine > 0) stage_head(P, F, smem + L.headw_off);
  float* hg = smem + L.hg_off;
  pool_segments(h, F | 1, nb, nr, F, mask, seg, segs, segs[p], P.att_w,
                smem + L.mean_off, smem + L.c_off, smem + L.att_off, hg);
  PP_STAGE(24);

  // Both sides pooled: copy the peer's embeddings of the live slots, then
  // tell the peer this CTA is done with its shared memory (it waits for
  // that before it leaves).
  cluster.sync();
  PP_STAGE(25);
  float* hgp = smem + L.hgp_off;
  const float* peer = cluster.map_shared_rank(hg, rank ^ 1u);
  for (int i = threadIdx.x; i < n_live * F; i += blockDim.x) {
    const int r = live[i / F] * F + i % F;
    hgp[r] = peer[r];
  }
  cluster_arrive();
  cp_async_wait_all();
  __syncthreads();
  PP_STAGE(26);

  // Rank r scores the live slots live[r], live[r + 2], ...; rank 0 writes
  // the zeros of the pad slots.
  const float* h1 = rank ? hgp : hg;
  const float* h2 = rank ? hg : hgp;
  if (rank == 0)
    for (int q = threadIdx.x; q < p; q += blockDim.x)
      if (!(pm[q] != 0.0f)) out[t * p + q] = 0.0f;
  float* head = smem + L.head_off;
  const HeadWeights H = head_weights(P, F, smem + L.headw_off);
  const int K = P.ntn_k;
  for (int base = 0; base < mine; base += SIMGNN_WARPS) {
    const int m = min(SIMGNN_WARPS, mine - base), items = m * K;
    // (slot, slice) items, two a warp side by side
    for (int it = warp; it < items; it += 2 * SIMGNN_WARPS) {
      const int it2 = min(it + SIMGNN_WARPS, items - 1);
      int jj[2], ks[2];
      const float* x1[2];
      const float* x2[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int x = n ? it2 : it;
        jj[n] = x / K;
        ks[n] = x - jj[n] * K;
        const int q = live[2 * (base + jj[n]) + rank];
        x1[n] = h1 + q * F;
        x2[n] = h2 + q * F;
      }
      float v[2];
      ntn_slices(x1, x2, ks, F, H, v);
      if (lane == 0) {
        head[jj[0] * 2 * SIMGNN_MAX_HEAD + ks[0]] = v[0];
        head[jj[1] * 2 * SIMGNN_MAX_HEAD + ks[1]] = v[1];
      }
    }
    __syncthreads();
    if (base == 0) PP_STAGE(27);
    if (warp < m) {
      const int q = live[2 * (base + warp) + rank];
      const float s =
          fcn_warp(head + warp * 2 * SIMGNN_MAX_HEAD, P, H) * pm[q];
      if (lane == 0) out[t * p + q] = s;
    }
    __syncthreads();
  }
  PP_STAGE(28);
  cluster_wait();
  PP_STAGE(29);
}

// Clusters of the cluster-route kernel the current device holds at once
// with this dynamic shared memory (what the plan's one wave counts on).
extern "C" int packed_pair_max_clusters(int smem_bytes, int* clusters) {
  cudaError_t err = simgnn_set_smem(packed_pair_cluster_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2, 1, 1);
  cfg.blockDim = dim3(SIMGNN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                              packed_pair_cluster_kernel, &cfg);
}

// The entry point, with the plan's layout as a last argument: on the
// cluster route grid 2T (one 2-CTA cluster a tile), on the single route
// grid T (one CTA a tile), SIMGNN_THREADS threads either way.
extern "C" int packed_pair_score_launch(const PackedSide* s1,
                                        const PackedSide* s2,
                                        const float* pmask, float* out, int T,
                                        int nb, int p, const SimgnnParams* P,
                                        void* stream, const PackedLayout* L) {
  if (T < 1 || nb < 1 || p < 1) return (int)cudaErrorInvalidValue;
  if (L->route == 0)
    return packed_pair_single_launch(s1, s2, pmask, out, T, nb, p, P, stream);
  const int ru4nb = (nb + 3) & ~3;
  if (L->route != 1 || L->ldh % 4 != 0 || L->ldh < ((P->f_max + 3) & ~3) ||
      L->lda % 4 != 0 || L->lda < ru4nb ||
      (L->w_stage & 1u) || (L->w_stage >> P->n_gcn))
    return (int)cudaErrorInvalidValue;
  unsigned vec_w = 0;           // bit l: W_l and b_l take float4 loads
  for (int l = 0; l < P->n_gcn; ++l)
    if (P->gcn_dims[l + 1] % 4 == 0 && ((uintptr_t)P->gcn_w[l] & 15) == 0 &&
        ((uintptr_t)P->gcn_b[l] & 15) == 0)
      vec_w |= 1u << l;
  // raw adjacency rows as float4 when NB is a multiple of 4 and both
  // sides' adjacency 16-byte aligned
  const int vec_a = nb % 4 == 0 && ((uintptr_t)s1->adj & 15) == 0 &&
                    ((uintptr_t)s2->adj & 15) == 0;
  const size_t smem = (size_t)L->smem_floats * 4;
  cudaError_t err = simgnn_set_smem(packed_pair_cluster_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  packed_pair_cluster_kernel<<<2 * T, SIMGNN_THREADS, smem,
                               (cudaStream_t)stream>>>(
      *s1, *s2, pmask, out, nb, p, *P, *L, vec_w, vec_a);
  return (int)cudaGetLastError();
}
