// Bucketed SimGNN pair-score megakernel for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_pair.py
// (fused_pair_score, body _kernel): per padded graph pair, both sides'
// in-kernel normalization D^-1/2 (A + I) D^-1/2, the GCN stack on dense
// one-hot features with dense aggregation, per-graph Att pooling, NTN, FCN
// and sigmoid; only the [B] scores reach global memory.
//
// What bounds it on this card: the float32 FMA rate in principle (about
// 1.4 M MAC and 16 KB of input a pair at bucket 32), in practice the
// latency of one pair's chain of dependent stages. The cluster route
// shortens that chain:
//   * one pair per CTA cluster of 2 cs CTAs (cs = 1, 2 or 4, from the
//     plan): ranks 0..cs-1 run the lhs graph, cs..2cs-1 the rhs, so the two
//     sides run at once, and a side's node rows are split in blocks of
//     ru4(ceil(nr / cs)) rows over its cs CTAs;
//   * loops to the live rows (below): nr = min(n, ru4(n_eff + 1)) rows, not
//     the bucket's n;
//   * each CTA forms A' for its own rows from the raw adjacency, with the
//     degrees of every row exchanged through distributed shared memory, and
//     computes HW for its own rows; after a cluster barrier it copies the
//     side's other HW row blocks from its peers' shared memory into a
//     window buffer (in windows of rows when the plan cannot hold all nr)
//     and aggregates its own rows; a split arrive / wait keeps a CTA from
//     overwriting its HW rows before its peers have copied them;
//   * register-tiled float32 products: a thread owns TM (4 or 2) rows x 4
//     columns, float4 operands, TM x 4 independent FMA chains; A' and H
//     rows are padded to 4 mod 32 floats so a quarter-warp's row loads fall
//     on distinct banks; each layer's W is copied into shared memory by
//     cp.async while the layer before runs (where the plan finds room
//     without costing a CTA an SM), else read as float4 through the
//     read-only cache;
//   * rank 0 of each side gathers the side's H and pools it; rank cs
//     stores the rhs embedding into rank 0's shared memory, and after one
//     more cluster barrier the other CTAs leave while rank 0 runs the NTN's
//     K slices over its warps, two a warp, then the FCN and the sigmoid on
//     one warp.
// The shared-memory layout comes from the Python plan,
// kernels/fused_pair.py fused_pair_plan. Widths whose buffers fit no
// cluster (at AIDS widths the oversize bucket 512) take the single route:
// the one-CTA-per-pair kernel this design replaced, unchanged (A', H and
// HW in shared memory up to the opt-in limit, else in a per-pair global
// scratch buffer).
//
// Arithmetic: every output is computed by the same float32 operations in
// the same order as the single route (simgnn_common.cuh normalize_block,
// dense_transform, dense_aggregate, segment_att_pool, ntn_fcn_warp), so
// the scores are the same bits whatever cs and the window. A'[i, j] =
// ((adj + [i == j]) * (mask[i] * mask[j])) * inv[i] * inv[j], each degree a
// sequential sum over all n columns; HW[i, j] an fmaf chain over k =
// 0..fin-1 from 0, then + b[j]; H[i, j] = relu(fmaf chain over nodes k in
// order) * mask[i], the chain carried across windows through the H buffer
// (a float32 store and load are exact); the pooling and the head keep
// their chains.
//
// Live rows (as csrc/fused_gcn.cu): a row k is null when mask[k],
// feats[k, :], A'[k, :] and A'[:, k] are all zero. Nullness is decided on
// the A' the kernel forms: with mask[k] == 0 every entry of row and column
// k is ±0 or NaN (a NaN or inf in the raw adjacency times 0), and the
// normalization keeps each ±0 a zero and each NaN a NaN, so the raw and
// the normalized A' have the same null rows. All null rows hold the same
// values (in each column a zero or a NaN), so each adds the same term to
// every node-ordered chain: a zero product, which leaves the accumulator
// as it is (it starts at +0 and is never -0), or a NaN. So the chains over
// all n rows equal the chains over the first n_eff + 1 rows, n_eff = 1 +
// the last non-null row, one null row standing for all of them, with the
// same bits for any input, NaN and inf included. The degree sums skip
// only null columns, whose entries are ±0.
#include <cooperative_groups.h>

#include "simgnn_common.cuh"

namespace cg = cooperative_groups;

#define FP_FULL 0xffffffffu
#define FP_MAX_CS 4           // CTAs a side (cluster of 8)

// Stage clocks, compiled in only by tools/fused_pair_stages.py (which
// defines FUSED_PAIR_STAGES): thread 0 of each cluster-route CTA records
// clock64() as stage k ends, into FP_STAGES slots a CTA of a buffer the
// tool hands fused_pair_stage_buffer (slot 46: the SM, 47: the global
// timer at the start).
#define FP_STAGES 48
#ifdef FUSED_PAIR_STAGES
__device__ long long* fp_stage_buf;
extern "C" int fused_pair_stage_buffer(long long* buf) {
  return (int)cudaMemcpyToSymbol(fp_stage_buf, &buf, sizeof(buf));
}
#define FP_STAGE(k)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0)                                                \
      fp_stage_buf[blockIdx.x * FP_STAGES + (k)] = clock64();            \
  } while (0)
#else
#define FP_STAGE(k) \
  do {              \
  } while (0)
#endif

struct FusedSide {
  const float* adj;     // [B, N, N] raw adjacency
  const float* feats;   // [B, N, F0] one-hot node features
  const float* mask;    // [B, N]
};

extern "C" int fused_side_size(void) { return (int)sizeof(FusedSide); }

// ------------------------------------------------------- the single route

// A', HW and H of one pair: the part that moves to global scratch.
__host__ __device__ static inline size_t fused_big_floats(int n,
                                                          const SimgnnParams& P) {
  return (size_t)n * n + 2 * (size_t)n * P.f_max;
}

static size_t fused_small_floats(int n, const SimgnnParams& P) {
  const int F = P.gcn_dims[P.n_gcn];
  return 4 * (size_t)F + 3 * (size_t)n + SIMGNN_WARPS * 2 * SIMGNN_MAX_HEAD;
}

// Floats of global scratch each pair needs on the single route: 0 when A',
// H and HW fit in the block's shared memory.
extern "C" long long fused_pair_scratch_floats(int n, const SimgnnParams* P) {
  const size_t all = (fused_big_floats(n, *P) + fused_small_floats(n, *P)) * 4;
  return all <= (size_t)simgnn_smem_optin() ? 0 : (long long)fused_big_floats(n, *P);
}

__global__ void __launch_bounds__(SIMGNN_THREADS)
fused_pair_kernel(FusedSide s1, FusedSide s2, float* __restrict__ out, int n,
                  int f0, float* scratch, SimgnnParams P) {
  extern __shared__ float smem[];
  const long b = blockIdx.x;
  const int F = P.gcn_dims[P.n_gcn];
  float* big = scratch ? scratch + b * fused_big_floats(n, P) : smem;
  float* a = big;
  float* hw = a + (size_t)n * n;
  float* h = hw + (size_t)n * P.f_max;
  float* small = scratch ? smem : big + fused_big_floats(n, P);
  float* hg = small;                    // [2, F]
  float* mean = hg + 2 * F;
  float* c = mean + F;
  float* att = c + F;
  float* mask = att + n;
  float* inv = mask + n;
  float* head = inv + n;

  for (int side = 0; side < 2; ++side) {
    const FusedSide& S = side ? s2 : s1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) mask[i] = S.mask[b * n + i];
    __syncthreads();
    normalize_block(S.adj + b * n * n, mask, n, a, inv);
    gcn_stack(P, n, nullptr, S.feats + b * n * f0, hw, h,
              [&](const float* x, int f, float* y) {
                dense_aggregate(a, x, n, f, mask, y);
              });
    segment_att_pool(h, n, F, mask, nullptr, 1, P.att_w, mean, c, att,
                     hg + side * F);
  }
  if (threadIdx.x < 32) {
    const float s = ntn_fcn_warp(hg, hg + F, P, head);
    if (threadIdx.x == 0) out[b] = s;
  }
}

extern "C" int fused_pair_score_launch(const FusedSide* s1, const FusedSide* s2,
                                       float* out, int B, int n, int f0,
                                       float* scratch, const SimgnnParams* P,
                                       void* stream) {
  size_t floats = fused_small_floats(n, *P);
  if (scratch == nullptr) floats += fused_big_floats(n, *P);
  const size_t smem = floats * 4;
  cudaError_t err = simgnn_set_smem(fused_pair_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_pair_kernel<<<B, SIMGNN_THREADS, smem, (cudaStream_t)stream>>>(
      *s1, *s2, out, n, f0, scratch, *P);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ the cluster route

// Launch layout, filled by the Python plan. Offsets and counts are in
// floats from the start of dynamic shared memory, each offset and row
// stride a multiple of 4. x holds a CTA's feats rows (stride ldf) and
// later its H rows (stride ldh); pool may lie inside win, which is dead
// once the last aggregation has read it.
struct FusedLayout {
  int n, f0, cs, rbp;              // bucket, labels, CTAs a side, rows a CTA
  int lda, ldf, ldh, ldp, wr;      // A', feats, HW/H, pooled-H strides; window rows
  int a_off, x_off, hwo_off, win_off, pool_off;
  int mask_off, inv_off, att_off, mean_off, c_off, hg_off, hgp_off, head_off;
  int int_off;
  int w_off;                       // W_l staged [f_l][ru4(f_l+1)], or -1
  int smem_floats;
};

extern "C" int fused_layout_size(void) { return (int)sizeof(FusedLayout); }

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// W_l [fin][fout] from global into shared [fin][ru4(fout)], asynchronously
// (16-byte copies when VEC); the pad columns are left as they are: they
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

// Rows of a block when `rows` rows are split over cs CTAs: ru4(ceil(rows /
// cs)) (kernels/fused_pair.py row_blocks).
__device__ __forceinline__ int block_rows(int rows, int cs) {
  return ((rows + cs - 1) / cs + 3) & ~3;
}

// C[i, j] = sum_k A[i, k] B[k, j] for i < M, j < N: each element an fmaf
// chain over k = 0..K-1 in order, from 0 or (ACC) from C's stored value,
// handed to epi(i, j, acc) as a float4 of columns j..j+3 (those >= N are
// padding the caller may store). B is a global row-major [K, N] matrix
// (GLOBAL: read through the read-only cache, float4 when VEC) or a shared
// [K][ldb] buffer. A thread owns TM rows (rg, rg + rgs, ...) x 4 columns;
// rows up to ru4(M) of A are read (the plan allots them).
template <int TM, bool GLOBAL, bool VEC, bool ACC, class Epi>
__device__ __forceinline__ void gemm_tiles(const float* A, int lda,
                                           const float* B, int ldb,
                                           const float* C, int ldc, int M,
                                           int N, int K, Epi epi) {
  const int cgs = (N + 3) >> 2;
  const int rgs = (M + TM - 1) / TM;
  for (int t = threadIdx.x; t < rgs * cgs; t += blockDim.x) {
    const int rg = t / cgs, j = (t - rg * cgs) << 2;
    const float* ar[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) ar[r] = A + (rg + r * rgs) * lda;
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      float4 c0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (ACC && rg + r * rgs < M) c0 = lds4(C + (rg + r * rgs) * ldc + j);
      acc[r][0] = c0.x;
      acc[r][1] = c0.y;
      acc[r][2] = c0.z;
      acc[r][3] = c0.w;
    }
    auto brow = [&](int k) -> float4 {
      if (GLOBAL) return ldg4<VEC>(B + (size_t)k * N, j, N);
      return lds4(B + k * ldb + j);
    };
    int k = 0;
#pragma unroll 2
    for (; k + 4 <= K; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = lds4(ar[r] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv = brow(k + q);
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
      const float4 bv = brow(k);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const float x = ar[r][k];
        acc[r][0] = fmaf(x, bv.x, acc[r][0]);
        acc[r][1] = fmaf(x, bv.y, acc[r][1]);
        acc[r][2] = fmaf(x, bv.z, acc[r][2]);
        acc[r][3] = fmaf(x, bv.w, acc[r][3]);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int i = rg + r * rgs;
      if (i < M)
        epi(i, j, make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]));
    }
  }
  __syncthreads();
}

// Four-row tiles unless that leaves more than half the block without one.
template <bool GLOBAL, bool VEC, bool ACC, class Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, const float* B,
                                     int ldb, const float* C, int ldc, int M,
                                     int N, int K, Epi epi) {
  if (M <= 0) {
    __syncthreads();
    return;
  }
  if (2 * ((M + 3) / 4) * ((N + 3) >> 2) >= (int)blockDim.x)
    gemm_tiles<4, GLOBAL, VEC, ACC>(A, lda, B, ldb, C, ldc, M, N, K, epi);
  else
    gemm_tiles<2, GLOBAL, VEC, ACC>(A, lda, B, ldb, C, ldc, M, N, K, epi);
}

// hw[i, :] = x[i, :] W + b for a CTA's rows (dense_transform's chains),
// W read from its staged shared copy ws (row stride ru4(fout)) or, when ws
// is null, from global memory.
template <bool VEC>
__device__ __forceinline__ void transform(const float* x, int ldx,
                                          const float* __restrict__ w,
                                          const float* ws,
                                          const float* __restrict__ b,
                                          int rows, int fin, int fout,
                                          float* hw, int ldh) {
  auto epi = [&](int i, int j, float4 acc) {
    const float4 bv = ldg4<VEC>(b, j, fout);
    *reinterpret_cast<float4*>(hw + i * ldh + j) = make_float4(
        acc.x + bv.x, acc.y + bv.y, acc.z + bv.z, acc.w + bv.w);
  };
  if (ws != nullptr)
    gemm<false, true, false>(x, ldx, ws, (fout + 3) & ~3, nullptr, 0, rows,
                             fout, fin, epi);
  else
    gemm<true, VEC, false>(x, ldx, w, 0, nullptr, 0, rows, fout, fin, epi);
}

// NTN slices k0 and k1 of ntn_fcn_warp on one warp, side by side: the same
// loops, butterfly and relu(bil + lin + b[k]), W read 8 rows at a time;
// out[0], out[1] on every lane.
__device__ __forceinline__ void ntn_slices(const float* h1, const float* h2,
                                           int k0, int k1,
                                           const SimgnnParams& P,
                                           float* out) {
  const int lane = threadIdx.x & 31;
  const int F = P.gcn_dims[P.n_gcn];
  const float* wk[2] = {P.ntn_w + (size_t)k0 * F * F,
                        P.ntn_w + (size_t)k1 * F * F};
  float bil[2] = {0.0f, 0.0f}, lin[2] = {0.0f, 0.0f};
  for (int g = lane; g < F; g += 32) {
    float t[2] = {0.0f, 0.0f};
    int i = 0;
    for (; i + 16 <= F; i += 16) {
      float wv[2][16];
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int u = 0; u < 16; ++u) wv[s][u] = __ldg(wk[s] + (i + u) * F + g);
#pragma unroll
      for (int u = 0; u < 16; ++u)
#pragma unroll
        for (int s = 0; s < 2; ++s) t[s] = fmaf(h1[i + u], wv[s][u], t[s]);
    }
    for (; i < F; ++i)
#pragma unroll
      for (int s = 0; s < 2; ++s)
        t[s] = fmaf(h1[i], __ldg(wk[s] + i * F + g), t[s]);
#pragma unroll
    for (int s = 0; s < 2; ++s) bil[s] = fmaf(t[s], h2[g], bil[s]);
  }
  const int ks[2] = {k0, k1};
  for (int j = lane; j < 2 * F; j += 32)
#pragma unroll
    for (int s = 0; s < 2; ++s)
      lin[s] = fmaf(j < F ? h1[j] : h2[j - F],
                    __ldg(P.ntn_v + (size_t)ks[s] * 2 * F + j), lin[s]);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    bil[s] = warp_sum(bil[s]);
    lin[s] = warp_sum(lin[s]);
    out[s] = simgnn_relu(bil[s] + lin[s] + __ldg(P.ntn_b + ks[s]));
  }
}

// ntn_fcn_warp's FCN and sigmoid on one warp: buf holds the K NTN outputs
// and SIMGNN_MAX_HEAD more floats of scratch. Returns the score on every
// lane.
__device__ __forceinline__ float fcn_warp(float* buf, const SimgnnParams& P) {
  const int lane = threadIdx.x & 31;
  float* cur = buf;
  float* nxt = buf + SIMGNN_MAX_HEAD;
  for (int l = 0; l < P.n_fcn; ++l) {
    const int din = P.fcn_dims[l], dout = P.fcn_dims[l + 1];
    const float* w = P.fcn_w[l];
    for (int o = lane; o < dout; o += 32) {
      float acc = 0.0f;
      int i = 0;
      for (; i + 8 <= din; i += 8) {
        float wv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) wv[u] = __ldg(w + (i + u) * dout + o);
#pragma unroll
        for (int u = 0; u < 8; ++u) acc = fmaf(cur[i + u], wv[u], acc);
      }
      for (; i < din; ++i) acc = fmaf(cur[i], __ldg(w + i * dout + o), acc);
      acc += __ldg(P.fcn_b[l] + o);
      nxt[o] = (l + 1 < P.n_fcn) ? simgnn_relu(acc) : acc;
    }
    __syncwarp();
    float* tmp = cur; cur = nxt; nxt = tmp;
  }
  const float s = simgnn_sigmoid(cur[0]);
  __syncwarp();
  return s;
}

// Att pooling of one side's gathered H [nr][ldp] (segment_att_pool with
// one segment, over the live rows) into hg [F].
__device__ __forceinline__ void pool_side(const float* h, int ldp, int nr,
                                          int F, const float* mask,
                                          const float* __restrict__ att_w,
                                          float* mean, float* c, float* att,
                                          float* hg) {
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    float sum = 0.0f, cnt = 0.0f;
    for (int k = 0; k < nr; ++k) {
      const float s = mask[k];
      sum = fmaf(s, h[k * ldp + j], sum);
      cnt += s;
    }
    mean[j] = sum / fmaxf(cnt, 1.0f);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < F; g += blockDim.x) {
    float acc = 0.0f;
    int j = 0;
    for (; j + 8 <= F; j += 8) {
      float wv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) wv[u] = __ldg(att_w + (j + u) * F + g);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc = fmaf(mean[j + u], wv[u], acc);
    }
    for (; j < F; ++j) acc = fmaf(mean[j], __ldg(att_w + j * F + g), acc);
    c[g] = tanhf(acc);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nr; k += blockDim.x) {
    float v = 0.0f;
    if (mask[k] != 0.0f) {
      const float* hk = h + k * ldp;
      float dot = 0.0f;
      for (int j = 0; j < F; ++j) dot = fmaf(hk[j], c[j], dot);
      v = simgnn_sigmoid(dot) * mask[k];
    }
    att[k] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    float sum = 0.0f;
    for (int k = 0; k < nr; ++k) sum = fmaf(mask[k], att[k] * h[k * ldp + j], sum);
    hg[j] = sum;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(SIMGNN_THREADS, 2)
fused_pair_cluster_kernel(FusedSide s1, FusedSide s2, float* __restrict__ out,
                          SimgnnParams P, FusedLayout L, unsigned vec_w,
                          int vec_a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int cs = L.cs, side = (int)rank / cs, part = (int)rank - side * cs;
  const long b = blockIdx.x / (2 * cs);
  const int n = L.n, f0 = L.f0, F = P.gcn_dims[P.n_gcn];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const FusedSide S = side ? s2 : s1;
  const float* __restrict__ adj = S.adj + b * n * n;
  const float* __restrict__ feats = S.feats + b * n * f0;
  float* mask = smem + L.mask_off;
  float* inv = smem + L.inv_off;
  float* a = smem + L.a_off;
  float* x = smem + L.x_off;
  float* hwo = smem + L.hwo_off;
  float* win = smem + L.win_off;
  int* slot = reinterpret_cast<int*>(smem + L.int_off);
  const int lda = L.lda, ldh = L.ldh;
#ifdef FUSED_PAIR_STAGES
  if (threadIdx.x == 0) {
    unsigned sm;
    long long g;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g));
    fp_stage_buf[blockIdx.x * FP_STAGES + 46] = sm;
    fp_stage_buf[blockIdx.x * FP_STAGES + 47] = g;
  }
#endif
  FP_STAGE(0);
  float* ws = L.w_off >= 0 ? smem + L.w_off : nullptr;
  if (ws) stage_w(ws, P.gcn_w[0], f0, P.gcn_dims[1], vec_w & 1u);

  for (int i = threadIdx.x; i < n; i += blockDim.x) mask[i] = S.mask[b * n + i];
  if (threadIdx.x == 0) *slot = 0;
  __syncthreads();

  // Static rows [s0, s0 + srows) of the bucket: the raw A' rows, their
  // degrees over all n columns, and this block's share of the live-row
  // scan.
  const int s0 = min(n, part * L.rbp), srows = min(n, s0 + L.rbp) - s0;
  int v = 0;
  if (vec_a) {
    const int q = n >> 2;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < srows * q; idx += blockDim.x) {
      const int r = idx / q, j = (idx - r * q) << 2, i = s0 + r;
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(
          adj + (size_t)i * n + j));
      const float mi = mask[i];
      float4 o;
      o.x = (x4.x + (i == j ? 1.0f : 0.0f)) * (mi * mask[j]);
      o.y = (x4.y + (i == j + 1 ? 1.0f : 0.0f)) * (mi * mask[j + 1]);
      o.z = (x4.z + (i == j + 2 ? 1.0f : 0.0f)) * (mi * mask[j + 2]);
      o.w = (x4.w + (i == j + 3 ? 1.0f : 0.0f)) * (mi * mask[j + 3]);
      *reinterpret_cast<float4*>(a + r * lda + j) = o;
      const int last = o.w != 0.0f   ? j + 3
                       : o.z != 0.0f ? j + 2
                       : o.y != 0.0f ? j + 1
                       : o.x != 0.0f ? j
                                     : -1;
      if (last >= 0) v = max(v, max(i, last) + 1);
    }
  } else {
    for (int idx = threadIdx.x; idx < srows * n; idx += blockDim.x) {
      const int r = idx / n, j = idx - r * n, i = s0 + r;
      const float raw = (__ldg(adj + (size_t)i * n + j) + (i == j ? 1.0f : 0.0f)) *
                        (mask[i] * mask[j]);
      a[r * lda + j] = raw;
      if (raw != 0.0f) v = max(v, max(i, j) + 1);
    }
  }
  for (int idx = threadIdx.x; idx < srows * f0; idx += blockDim.x)
    if (__ldg(feats + (size_t)s0 * f0 + idx) != 0.0f) v = max(v, s0 + idx / f0 + 1);
  for (int i = s0 + threadIdx.x; i < s0 + srows; i += blockDim.x)
    if (mask[i] != 0.0f) v = max(v, i + 1);
  v = __reduce_max_sync(FP_FULL, v);
  if (lane == 0 && v > 0) atomicMax(slot, v);
  __syncthreads();
  FP_STAGE(1);
  for (int r = threadIdx.x; r < srows; r += blockDim.x) {
    const float* ar = a + r * lda;
    float deg = 0.0f;
    for (int k = 0; k < n; ++k) deg += ar[k];
    inv[s0 + r] = deg > 0.0f ? 1.0f / sqrtf(fmaxf(deg, 1e-12f)) : 0.0f;
  }

  // Exchange the side's degrees and live rows. Rank side * cs + p owns
  // the side's row block p.
  const int rank0 = side * cs;
  int live;
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
    live = 0;
    for (int p = 0; p < cs; ++p)
      live = max(live, *cluster.map_shared_rank(slot, rank0 + p));
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int p = i / L.rbp;
      if (p != part) inv[i] = *cluster.map_shared_rank(inv + i, rank0 + p);
    }
  } else {
    __syncthreads();
    live = *slot;
  }
  __syncthreads();
  FP_STAGE(2);
  const int nr = min(n, (live + 4) & ~3);
  const int rb = block_rows(nr, cs);
  const int r0 = min(nr, part * rb), rows = min(nr, r0 + rb) - r0;

  // This CTA's rows: normalized A' over the nr live columns, feats.
  if (vec_a) {                 // nr is then a multiple of 4 as n is
    const int q = nr >> 2;
#pragma unroll 4
    for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
      const int r = idx / q, j = (idx - r * q) << 2, i = r0 + r;
      const float4 x4 = __ldg(reinterpret_cast<const float4*>(
          adj + (size_t)i * n + j));
      const float mi = mask[i], ii = inv[i];
      float4 o;
      o.x = (x4.x + (i == j ? 1.0f : 0.0f)) * (mi * mask[j]) * ii * inv[j];
      o.y = (x4.y + (i == j + 1 ? 1.0f : 0.0f)) * (mi * mask[j + 1]) * ii *
            inv[j + 1];
      o.z = (x4.z + (i == j + 2 ? 1.0f : 0.0f)) * (mi * mask[j + 2]) * ii *
            inv[j + 2];
      o.w = (x4.w + (i == j + 3 ? 1.0f : 0.0f)) * (mi * mask[j + 3]) * ii *
            inv[j + 3];
      *reinterpret_cast<float4*>(a + r * lda + j) = o;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * nr; idx += blockDim.x) {
      const int r = idx / nr, j = idx - r * nr, i = r0 + r;
      const float raw = (__ldg(adj + (size_t)i * n + j) + (i == j ? 1.0f : 0.0f)) *
                        (mask[i] * mask[j]);
      a[r * lda + j] = raw * inv[i] * inv[j];
    }
  }
  for (int idx = threadIdx.x; idx < rows * f0; idx += blockDim.x) {
    const int r = idx / f0, k = idx - r * f0;
    x[r * L.ldf + k] = __ldg(feats + (size_t)(r0 + r) * f0 + k);
  }
  cp_async_wait_all();        // W_0
  __syncthreads();
  FP_STAGE(3);

  int ldx = L.ldf;
  for (int l = 0; l < P.n_gcn; ++l) {
    const int fin = P.gcn_dims[l], fout = P.gcn_dims[l + 1];
    // the peers have copied this CTA's HW rows of the layer before
    if (l > 0 && cs > 1) cluster_wait();
    if (l > 0 && ws) {          // W_l, staged while layer l - 1 ran
      cp_async_wait_all();
      __syncthreads();
    }
    if ((vec_w >> l) & 1u)
      transform<true>(x, ldx, P.gcn_w[l], ws, P.gcn_b[l], rows, fin, fout,
                      hwo, ldh);
    else
      transform<false>(x, ldx, P.gcn_w[l], ws, P.gcn_b[l], rows, fin, fout,
                       hwo, ldh);
    if (ws && l + 1 < P.n_gcn)
      stage_w(ws, P.gcn_w[l + 1], fout, P.gcn_dims[l + 2],
              (vec_w >> (l + 1)) & 1u);
    FP_STAGE(4 + 4 * l);
    if (cs > 1) {
      cluster_arrive();
      cluster_wait();
    }
    FP_STAGE(5 + 4 * l);
    const int q4 = (fout + 3) >> 2;
    for (int w0 = 0; w0 < nr; w0 += L.wr) {
      const int w1 = min(nr, w0 + L.wr);
#pragma unroll 4
      for (int idx = threadIdx.x; idx < (w1 - w0) * q4; idx += blockDim.x) {
        const int r = idx / q4, col = (idx - r * q4) << 2, i = w0 + r;
        const int p = i / rb;
        *reinterpret_cast<float4*>(win + r * ldh + col) = lds4(
            cluster.map_shared_rank(hwo + (i - p * rb) * ldh + col, rank0 + p));
      }
      __syncthreads();
      if (w1 == nr) FP_STAGE(6 + 4 * l);
      const bool first = w0 == 0, last = w1 == nr;
      auto epi = [&](int i, int j, float4 acc) {
        float4 o = acc;
        if (last) {
          const float mi = mask[r0 + i];
          o = make_float4(simgnn_relu(acc.x) * mi, simgnn_relu(acc.y) * mi,
                          simgnn_relu(acc.z) * mi, simgnn_relu(acc.w) * mi);
        }
        *reinterpret_cast<float4*>(x + i * ldh + j) = o;
      };
      if (first)
        gemm<false, true, false>(a + w0, lda, win, ldh, x, ldh, rows, fout,
                                 w1 - w0, epi);
      else
        gemm<false, true, true>(a + w0, lda, win, ldh, x, ldh, rows, fout,
                                w1 - w0, epi);
    }
    // done with the peers' HW; this CTA's H rows are final
    if (cs > 1) cluster_arrive();
    FP_STAGE(7 + 4 * l);
    ldx = ldh;
  }
  if (cs > 1) cluster_wait();
  FP_STAGE(36);

  // Rank 0 of each side gathers the side's H (four columns a load) and
  // pools it; rank cs stores the rhs embedding into rank 0's hgp. After
  // the barrier no CTA touches another's shared memory: rank 0 scores the
  // pair, the others leave.
  float* hg = smem + L.hg_off;
  float* hgp = smem + L.hgp_off;
  if (part == 0) {
    float* ph = smem + L.pool_off;
    const int q4 = (F + 3) >> 2;
    for (int idx = threadIdx.x; idx < nr * q4; idx += blockDim.x) {
      const int i = idx / q4, j = (idx - i * q4) << 2, p = i / rb;
      const float4 h4 = lds4(
          cluster.map_shared_rank(x + (i - p * rb) * ldh + j, rank0 + p));
      float* o = ph + i * L.ldp + j;
      o[0] = h4.x;
      if (j + 1 < F) o[1] = h4.y;
      if (j + 2 < F) o[2] = h4.z;
      if (j + 3 < F) o[3] = h4.w;
    }
    __syncthreads();
    FP_STAGE(37);
    pool_side(ph, L.ldp, nr, F, mask, P.att_w, smem + L.mean_off,
              smem + L.c_off, smem + L.att_off, side ? hg : hgp);
    if (side == 1) {
      float* dst = cluster.map_shared_rank(hgp, 0) + F;
      for (int j = threadIdx.x; j < F; j += blockDim.x) dst[j] = hg[j];
    }
    FP_STAGE(38);
  }
  cluster_arrive();
  cluster_wait();
  FP_STAGE(39);
  if (rank != 0) {
    FP_STAGE(43);
    return;
  }

  // hgp holds both embeddings: [0, F) the lhs (this CTA's), [F, 2F) the rhs.
  float* head = smem + L.head_off;
  // slices k and k + 8 on warp k (k < 8), then 16.. on the same terms
  for (int k = warp; k < P.ntn_k; k += 2 * SIMGNN_WARPS) {
    const int k1 = min(k + SIMGNN_WARPS, P.ntn_k - 1);
    float s2[2];
    ntn_slices(hgp, hgp + F, k, k1, P, s2);
    if (lane == 0) {
      head[k] = s2[0];
      head[k1] = s2[1];
    }
  }
  __syncthreads();
  FP_STAGE(41);
  if (warp == 0) {
    const float s2 = fcn_warp(head, P);
    if (lane == 0) out[b] = s2;
  }
  FP_STAGE(42);
  FP_STAGE(43);
}

// Clusters of `cluster` CTAs the current device holds at once with this
// dynamic shared memory (what the plan's one wave counts on).
extern "C" int fused_pair_max_clusters(int cluster, int smem_bytes,
                                       int* clusters) {
  cudaError_t err = simgnn_set_smem(fused_pair_cluster_kernel, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(SIMGNN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(clusters,
                                              fused_pair_cluster_kernel, &cfg);
}

// The cluster route: grid 2 cs B CTAs in clusters of 2 cs, SIMGNN_THREADS
// threads, the plan's layout.
extern "C" int fused_pair_cluster_launch(const FusedSide* s1,
                                         const FusedSide* s2, float* out,
                                         int B, const SimgnnParams* P,
                                         const FusedLayout* L, void* stream) {
  const int cs = L->cs;
  if (B < 1 || (cs != 1 && cs != 2 && cs != FP_MAX_CS) || L->ldh % 4 != 0 ||
      L->ldh < P->f_max || L->wr < 4 || L->wr % 4 != 0 || L->rbp % 4 != 0 ||
      L->rbp * cs < L->n || P->gcn_dims[0] != L->f0)
    return (int)cudaErrorInvalidValue;
  unsigned vec_w = 0;           // bit l: W_l and b_l take float4 loads
  for (int l = 0; l < P->n_gcn; ++l)
    if (P->gcn_dims[l + 1] % 4 == 0 && ((uintptr_t)P->gcn_w[l] & 15) == 0 &&
        ((uintptr_t)P->gcn_b[l] & 15) == 0)
      vec_w |= 1u << l;
  const size_t smem = (size_t)L->smem_floats * 4;
  cudaError_t err = simgnn_set_smem(fused_pair_cluster_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2 * cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(2 * cs * B, 1, 1);
  cfg.blockDim = dim3(SIMGNN_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // raw adjacency rows as float4 when n is a multiple of 4 and both sides'
  // adjacency 16-byte aligned
  const int vec_a = L->n % 4 == 0 && ((uintptr_t)s1->adj & 15) == 0 &&
                    ((uintptr_t)s2->adj & 15) == 0;
  err = cudaLaunchKernelEx(&cfg, fused_pair_cluster_kernel, *s1, *s2, out, *P,
                           *L, vec_w, vec_a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
