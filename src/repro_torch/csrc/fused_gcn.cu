// Fused GCN stack + Att pooling (graph embeddings) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_gcn.py
// (fused_gcn_att, body _kernel): per padded graph, every GCN layer
// H' = relu(A' (H W + b)) * mask on the pre-normalised A', then the Att
// pooling of paper Eq. 3; only the [B, F] embeddings reach global memory.
//
// What bounds it on this card: the float32 FMA rate (about 1.4 MFLOP a
// graph at AIDS widths, 128/64/32 on 29 labels), so the design keeps the
// FMA pipes fed:
//   * persistent CTAs: the grid is what the SMs hold at once, and each CTA
//     walks graphs blockIdx.x, blockIdx.x + gridDim.x, ...;
//   * the whole weight set (every layer's W and b and the Att W, as one
//     padded image the wrapper builds) is copied into shared memory once a
//     CTA, so no product reads a weight from global memory;
//   * the next graph's A', feats and mask are staged by cp.async while the
//     current graph computes (two input buffers; HW and H single);
//   * register-tiled products: a thread owns a tile of TM rows x 4 columns
//     (TM 4 or 2, chosen per product from its shape), loads float4
//     operands, and runs TM x 4 independent FMA chains; shared rows are
//     padded by 4 floats (4 mod 32 at the served widths) and a tile's rows
//     are strided by the row-group count, so a quarter-warp's loads fall
//     on distinct banks;
//   * loops stop after the graph's live rows (below).
// The layout of every buffer (offsets, strides, which buffers live in
// shared memory) comes from the Python plan, kernels/fused_gcn.py
// fused_gcn_plan. Where A', feats, HW and H do not fit beside the weights
// in the block's shared memory (the oversize buckets 128 and 256 at AIDS
// widths), they live in a per-CTA slot of a global scratch buffer (the
// scratch route; same layout, same arithmetic), and where the weights do
// not fit either they are read from the image in global memory.
//
// Arithmetic (the embedding cache's contract): every output element is
// owned by one thread and summed in the order of simgnn_common.cuh's
// dense_transform, dense_aggregate and segment_att_pool. HW[i,j] is an
// fmaf chain over k = 0..fin-1 from 0, then + b[j]; H[i,j] is relu(fmaf
// chain over nodes k in order) * mask[i]; the pooling keeps
// segment_att_pool's order and its full-precision tanhf/expf.
// So a graph's embedding is the same bits whatever its batch companions and
// whatever bucket it is padded to.
//
// Live rows: a row k is null when mask[k], feats[k, :], A'[k, :] and
// A'[:, k] are all zero. All null rows hold the same values (in each
// column a zero or a NaN), so each adds the same term to every
// node-ordered chain: a zero product, which leaves the accumulator as it is
// (it starts at +0 and is never -0), or a NaN. So the chains over all n rows
// equal the chains over the first n_eff + 1 rows, n_eff = 1 + the last
// non-null row, one null row standing for all of them: the loops run to
// nr = min(n, ru4(n_eff + 1)) with the same bits for any input, NaN and inf
// weights included.
#include "simgnn_common.cuh"

// Launch layout, filled by the Python plan. All counts are floats; every
// offset and stride is a multiple of 4. a/f/hw/h live in shared memory on
// the shared route and in the CTA's scratch slot on the scratch route; the
// mask and the pooling buffers always in shared memory; the weight image at
// shared offset 0 when weights_in_smem.
struct GcnLayout {
  int n, f0, np, lda, ldf, ldh;           // bucket, labels, rows, strides
  int n_gcn, att_off, ldatt, w_floats;    // layers, Att W in the image
  int dims[SIMGNN_MAX_GCN + 1];           // f0 .. f_L
  int ldw[SIMGNN_MAX_GCN];                // W_l and b_l row stride
  int w_off[SIMGNN_MAX_GCN];              // W_l [f_l][ldw] in the image
  int b_off[SIMGNN_MAX_GCN];              // b_l [ldw] in the image
  int weights_in_smem, stages;            // stages: input buffers, 1 or 2
  int a_off[2], f_off[2], m_off[2];       // A' [np][lda], feats [np][ldf], mask
  int hw_off, h_off;                      // HW, H [np][ldh]
  int mean_off, c_off, att_s_off, neff_off;
  int smem_floats, slot_floats;
};

extern "C" int fused_gcn_layout_size(void) { return (int)sizeof(GcnLayout); }

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

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// rows x cols floats from global (row stride sld) to shared memory (row
// stride dld), asynchronously: 16-byte copies when vec (cols, sld and the
// source a multiple of 4 floats / 16 bytes), else 4-byte copies.
__device__ __forceinline__ void stage_rows(float* dst, int dld,
                                           const float* src, int sld,
                                           int rows, int cols, bool vec) {
  if (vec) {
    const int q = cols >> 2;
    for (int idx = threadIdx.x; idx < rows * q; idx += blockDim.x) {
      const int i = idx / q, c = (idx - i * q) << 2;
      cp_async16(dst + i * dld + c, src + (size_t)i * sld + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
      const int i = idx / cols, c = idx - i * cols;
      cp_async4(dst + i * dld + c, src + (size_t)i * sld + c);
    }
  }
}

// The same copy, synchronous, to any memory (the scratch route).
__device__ __forceinline__ void copy_rows(float* dst, int dld,
                                          const float* src, int sld,
                                          int rows, int cols) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int i = idx / cols, c = idx - i * cols;
    dst[i * dld + c] = __ldg(src + (size_t)i * sld + c);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// C[i, j] = sum_k A[i, k] B[k, j] for i < M, j < N, each element an fmaf
// chain over k = 0..K-1 in order from 0, handed to epi(i, j, acc) as a
// float4 of columns j..j+3 (those >= N are padding the caller may store).
// A thread owns TM rows (rg, rg + rgs, ...) x 4 columns. Rows up to ru4(M)
// and columns up to ru4(N) are read, so A holds ru4(M) rows and
// ldb >= ru4(N); A, B and both strides are multiples of 4 floats.
template <int TM, class Epi>
__device__ __forceinline__ void gemm_tiles(const float* A, int lda,
                                           const float* B, int ldb, int M,
                                           int N, int K, Epi epi) {
  const int cgs = (N + 3) >> 2;
  const int rgs = (M + TM - 1) / TM;
  for (int t = threadIdx.x; t < rgs * cgs; t += blockDim.x) {
    const int rg = t / cgs, j = (t - rg * cgs) << 2;
    const float* ar[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) ar[r] = A + (rg + r * rgs) * lda;
    const float* bc = B + j;
    float acc[TM][4];
#pragma unroll
    for (int r = 0; r < TM; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    int k = 0;
    for (; k + 4 <= K; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int r = 0; r < TM; ++r) av[r] = ld4(ar[r] + k);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 bv = ld4(bc + (k + q) * ldb);
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
      const float4 bv = ld4(bc + k * ldb);
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

// Tile height of a product: 4 rows (fewest loads per FMA) unless that
// leaves more than half the block without a tile, then 2. One graph's
// products are small (tens of rows), and a block's idle threads are what
// the other resident CTA's graph fills.
__device__ __forceinline__ int tile_rows(int M, int N) {
  const int tiles4 = (M + 3) / 4 * ((N + 3) >> 2);
  return 2 * tiles4 < (int)blockDim.x ? 2 : 4;
}

template <class Epi>
__device__ __forceinline__ void gemm(const float* A, int lda, const float* B,
                                     int ldb, int M, int N, int K, Epi epi) {
  if (tile_rows(M, N) == 4)
    gemm_tiles<4>(A, lda, B, ldb, M, N, K, epi);
  else
    gemm_tiles<2>(A, lda, B, ldb, M, N, K, epi);
}

// 1 + the last non-null row of a staged graph (0 when every row is null),
// reading A' and feats four floats at a time.
__device__ __forceinline__ int live_rows(const float* a, int lda,
                                         const float* f, int ldf,
                                         const float* m, int n, int f0,
                                         int* slot) {
  int v = 0;
  const int qa = (n + 3) >> 2, qf = (f0 + 3) >> 2;
  for (int idx = threadIdx.x; idx < n * qa; idx += blockDim.x) {
    const int i = idx / qa, c = (idx - i * qa) << 2;
    const float4 x = ld4(a + i * lda + c);
    const int last = (c + 3 < n && x.w != 0.0f)   ? c + 3
                     : (c + 2 < n && x.z != 0.0f) ? c + 2
                     : (c + 1 < n && x.y != 0.0f) ? c + 1
                     : x.x != 0.0f                ? c
                                                  : -1;
    if (last >= 0) v = max(v, max(i, last) + 1);
  }
  for (int idx = threadIdx.x; idx < n * qf; idx += blockDim.x) {
    const int i = idx / qf, c = (idx - i * qf) << 2;
    const float4 x = ld4(f + i * ldf + c);
    if (x.x != 0.0f || (c + 1 < f0 && x.y != 0.0f) ||
        (c + 2 < f0 && x.z != 0.0f) || (c + 3 < f0 && x.w != 0.0f))
      v = max(v, i + 1);
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    if (m[i] != 0.0f) v = max(v, i + 1);
  v = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v > 0) atomicMax(slot, v);
  __syncthreads();
  return *slot;
}

// One graph, staged: the GCN stack over its first nr rows, then the Att
// pooling into out [F].
__device__ __forceinline__ void embed_graph(const GcnLayout& L,
                                            const float* W, const float* a,
                                            const float* f, const float* m,
                                            float* hw, float* h, float* smem,
                                            int nr, float* out) {
  const float* x = f;
  int ldx = L.ldf;
  for (int l = 0; l < L.n_gcn; ++l) {
    const int fin = L.dims[l], fout = L.dims[l + 1];
    const float* b = W + L.b_off[l];
    gemm(x, ldx, W + L.w_off[l], L.ldw[l], nr, fout, fin,
         [&](int i, int j, float4 acc) {
           const float4 bv = ld4(b + j);
           *reinterpret_cast<float4*>(hw + i * L.ldh + j) = make_float4(
               acc.x + bv.x, acc.y + bv.y, acc.z + bv.z, acc.w + bv.w);
         });
    gemm(a, L.lda, hw, L.ldh, nr, fout, nr,
         [&](int i, int j, float4 acc) {
           const float mi = m[i];
           *reinterpret_cast<float4*>(h + i * L.ldh + j) = make_float4(
               simgnn_relu(acc.x) * mi, simgnn_relu(acc.y) * mi,
               simgnn_relu(acc.z) * mi, simgnn_relu(acc.w) * mi);
         });
    x = h;
    ldx = L.ldh;
  }
  // Att pooling: segment_att_pool with one segment, over the live rows.
  const int F = L.dims[L.n_gcn], ldh = L.ldh;
  float* mean = smem + L.mean_off;
  float* c = smem + L.c_off;
  float* att = smem + L.att_s_off;
  const float* aw = W + L.att_off;
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    float sum = 0.0f, cnt = 0.0f;
    for (int k = 0; k < nr; ++k) {
      const float s = m[k];
      sum = fmaf(s, h[k * ldh + j], sum);
      cnt += s;
    }
    mean[j] = sum / fmaxf(cnt, 1.0f);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < F; g += blockDim.x) {
    float acc = 0.0f;
    for (int j = 0; j < F; ++j) acc = fmaf(mean[j], aw[j * L.ldatt + g], acc);
    c[g] = tanhf(acc);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < nr; k += blockDim.x) {
    float v = 0.0f;
    if (m[k] != 0.0f) {
      const float* hk = h + k * ldh;
      float dot = 0.0f;
      for (int j = 0; j < F; ++j) dot = fmaf(hk[j], c[j], dot);
      v = simgnn_sigmoid(dot) * m[k];
    }
    att[k] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    float sum = 0.0f;
    for (int k = 0; k < nr; ++k) sum = fmaf(m[k], att[k] * h[k * ldh + j], sum);
    out[j] = sum;
  }
}

// SCRATCH = false: the shared route (everything in shared memory, inputs
// double-buffered by cp.async when L.stages == 2). SCRATCH = true: A',
// feats, HW and H in the CTA's slot of `scratch`, copied synchronously.
template <bool SCRATCH>
__global__ void __launch_bounds__(512, 1)
fused_gcn_kernel(const float* __restrict__ adj, const float* __restrict__ feats,
                 const float* __restrict__ mask_g, float* __restrict__ out,
                 int B, const float* __restrict__ wimg, float* scratch,
                 GcnLayout L, int vec_a, int vec_f) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* slot = SCRATCH ? scratch + (size_t)blockIdx.x * L.slot_floats : smem;
  int* neff = reinterpret_cast<int*>(smem + L.neff_off);
  const int n = L.n, f0 = L.dims[0], F = L.dims[L.n_gcn];
  // On the shared route the weights are always resident (the launch checks
  // it), so every operand pointer is known to be shared memory.
  const float* W = smem;
  if (!SCRATCH)
    stage_rows(smem, 0, wimg, 0, 1, L.w_floats, true);
  else if (L.weights_in_smem)
    copy_rows(smem, 0, wimg, 0, 1, L.w_floats);
  else
    W = wimg;
  if (threadIdx.x == 0) *neff = 0;

  auto stage = [&](long gi, int s) {
    stage_rows(slot + L.a_off[s], L.lda, adj + gi * n * n, n, n, n, vec_a);
    stage_rows(slot + L.f_off[s], L.ldf, feats + gi * n * f0, f0, n, f0,
               vec_f);
    stage_rows(smem + L.m_off[s], 0, mask_g + gi * n, 0, 1, n, false);
  };
  long g = blockIdx.x;
  if (!SCRATCH) {
    if (g < B) stage(g, 0);
    cp_async_commit();
  }
  for (int it = 0; g < B; g += gridDim.x, ++it) {
    const int s = (!SCRATCH && L.stages == 2) ? (it & 1) : 0;
    if (SCRATCH) {
      copy_rows(slot + L.a_off[0], L.lda, adj + g * n * n, n, n, n);
      copy_rows(slot + L.f_off[0], L.ldf, feats + g * n * f0, f0, n, f0);
      copy_rows(smem + L.m_off[0], 0, mask_g + g * n, 0, 1, n);
      __syncthreads();
    } else if (L.stages == 2) {
      const long gn = g + gridDim.x;
      if (gn < B) stage(gn, s ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    } else {
      cp_async_wait<0>();
      __syncthreads();
    }
    const float* a = slot + L.a_off[s];
    const float* f = slot + L.f_off[s];
    const float* m = smem + L.m_off[s];
    const int live = live_rows(a, L.lda, f, L.ldf, m, n, f0, neff);
    const int nr = min(n, (live + 4) & ~3);
    embed_graph(L, W, a, f, m, slot + L.hw_off, slot + L.h_off, smem, nr,
                out + g * F);
    if (threadIdx.x == 0) *neff = 0;
    __syncthreads();
    if (!SCRATCH && L.stages == 1) {
      const long gn = g + gridDim.x;
      if (gn < B) stage(gn, 0);
      cp_async_commit();
    }
  }
  if (!SCRATCH) cp_async_wait<0>();
}

// Streaming multiprocessors and the opt-in shared bytes a block may use on
// the current device (what the plan needs).
extern "C" int fused_gcn_device_limits(int* sms, int* smem_optin) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(smem_optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (int)err;
}

// CTAs of the route's kernel that one SM holds at these threads and shared
// bytes, as the runtime computes it (registers included).
extern "C" int fused_gcn_occupancy(int scratch, int threads, int smem_bytes,
                                   int* ctas) {
  auto k = scratch ? fused_gcn_kernel<true> : fused_gcn_kernel<false>;
  cudaError_t err = simgnn_set_smem(k, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, k, threads,
                                                        smem_bytes);
  return (int)err;
}

extern "C" int fused_gcn_launch(const float* adj, const float* feats,
                                const float* mask, float* out, int B,
                                const float* wimg, float* scratch,
                                const GcnLayout* L, int grid, int threads,
                                int smem_bytes, void* stream) {
  const bool scr = scratch != nullptr;
  if (threads % 32 != 0 || threads > 512 || grid < 1 ||
      (size_t)smem_bytes < (size_t)L->smem_floats * 4 ||
      (!scr && !L->weights_in_smem) || (scr && L->stages != 1) ||
      ((uintptr_t)wimg & 15) != 0 || ((uintptr_t)scratch & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int vec_a = L->n % 4 == 0 && ((uintptr_t)adj & 15) == 0;
  const int vec_f = L->f0 % 4 == 0 && ((uintptr_t)feats & 15) == 0;
  auto k = scr ? fused_gcn_kernel<true> : fused_gcn_kernel<false>;
  cudaError_t err = simgnn_set_smem(k, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      adj, feats, mask, out, B, wimg, scratch, *L, vec_a, vec_f);
  return (int)cudaGetLastError();
}
