// Fused NTN + FCN + sigmoid head on graph-embedding pairs for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/simgnn_head.py
// (simgnn_head, body _kernel): per pair, the K bilinear slices
// h1^T W[k] h2, the linear term V [h1; h2] + b, ReLU, the FCN stack and the
// sigmoid; only the [B] scores reach global memory.
//
// What bounds it on this card: the float32 FMA rate (about 17 K MAC per
// pair at F = 32, K = 16: the products t[k, g] = sum_i h1[i] W[k, i, g])
// against 256 bytes of embeddings per pair. Two routes, picked by the
// Python plan (kernels/simgnn_head.py simgnn_head_plan) from the shapes
// alone:
//
// The tiled route (F = 32, the served SimGNN-AIDS head):
//   * persistent CTAs of 256 threads walk tiles of 8 * PT pairs (PT 4 or
//     1, the plan's pick); the NTN
//     tensor (permuted so a thread's eight columns are two float4), V, b
//     and the FCN weights are copied into shared memory once a CTA by
//     cp.async with the first tile's rows (letting each warp start on its
//     own slices as they land measured no faster); the next tile's h1/h2
//     rows are staged while the current one computes (double-buffered);
//   * warp w owns the slice pairs (2q, 2q + 1), q = w, w + 8, ...; a lane
//     is (l = lane & 3, pair slot ps = lane >> 2) and holds PT pairs x 2
//     slices x the 8 columns g = l + 4j in registers: per i it reads two
//     float4 of W a slice (shared by the lane quad's eight pair slots)
//     and, every fourth i, one float4 of h1 per pair (rows padded to 4 mod
//     32 floats): the compiled loop issues 512 FFMA to 40 LDS.128 per
//     eight i;
//   * the reduction over g is the parent's xor butterfly: the butterfly's
//     first three levels pair columns g, g + 16, g + 8, g + 4, which a
//     lane holds, so it adds them in registers in that tree; the last two
//     levels (g + 2, g + 1) are two shuffles inside the lane quad. A full
//     five-step butterfly per (pair, slice) would issue more shuffles than
//     the products issue FMAs. A thread reads its columns of each pair's
//     rows once into registers for both slices, and writes the slices'
//     outputs after all of them (no store between the loads lets the
//     compiler keep them);
//   * the FCN and the sigmoid run one (pair, output) a thread.
// The warp route (any other F, or a NTN tensor that does not fit in shared
// memory): one warp scores one pair through `ntn_fcn_warp`, eight pairs
// per CTA, reading the weights through L1 (PR 12's kernel, unchanged).
//
// Arithmetic: a pair's score is a function of its two rows alone and the
// same bits on both routes, at any batch size and any position in the
// batch (the exact 1-vs-N scan and the two-stage rerank score a shared
// pair identically). Every operation is the one `ntn_fcn_warp` compiles
// to, spelled out: t is an fmaf chain over i = 0..F-1 from 0; the bilinear
// leaf of column g is fmaf(t_g, h2[g], 0) (an fma with a +0 addend, not a
// multiply: it turns -0 into +0); the linear leaf of g is
// fmaf(h2[g], V[k, F + g], fmaf(h1[g], V[k, g], 0)); both are summed in
// the butterfly's tree (float addition commutes bit for bit, so each level
// may take its operands in either order); out_k = relu((bil + lin) +
// b[k]); each FCN output is an fmaf chain over its inputs in order from 0,
// + b, ReLU except on the last layer; then 1 / (1 + expf(-x)). The sources
// are built without --use_fast_math.
#include "simgnn_common.cuh"

// ---------------------------------------------------------- the warp route

__global__ void __launch_bounds__(SIMGNN_THREADS)
simgnn_head_kernel(const float* __restrict__ h1, const float* __restrict__ h2,
                   float* __restrict__ out, long long B, SimgnnParams P) {
  __shared__ float buf[SIMGNN_WARPS][2 * SIMGNN_MAX_HEAD];
  const int warp = threadIdx.x >> 5;
  const long long pair = (long long)blockIdx.x * SIMGNN_WARPS + warp;
  if (pair >= B) return;                  // whole warps leave together
  const int F = P.gcn_dims[P.n_gcn];
  const float s = ntn_fcn_warp(h1 + pair * F, h2 + pair * F, P, buf[warp]);
  if ((threadIdx.x & 31) == 0) out[pair] = s;
}

extern "C" int simgnn_head_launch(const float* h1, const float* h2,
                                  float* out, long long B,
                                  const SimgnnParams* P, void* stream) {
  const long long blocks = (B + SIMGNN_WARPS - 1) / SIMGNN_WARPS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  simgnn_head_kernel<<<(unsigned)blocks, SIMGNN_THREADS, 0,
                       (cudaStream_t)stream>>>(h1, h2, out, B, *P);
  return (int)cudaGetLastError();
}

// --------------------------------------------------------- the tiled route

#define HEAD_F 32             // embedding width of the tiled route
#define HEAD_THREADS 256
#define HEAD_WARPS (HEAD_THREADS / 32)

// Launch layout, filled by the Python plan; all in floats, every offset a
// multiple of 4. The weight image (built by the wrapper) is copied to
// shared offset 0 with its own layout: W [K][F][4][8] (W[k, i, l + 4j] at
// ((k * F + i) * 4 + l) * 8 + j), V [K][2F] at v_off, b [K] at b_off, then
// each FCN layer's w [din][dout] and b [dout].
struct HeadLayout {
  int k, kp, n_fcn;                     // slices, slice pairs, FCN layers
  int fcn_dims[SIMGNN_MAX_FCN + 1];     // K .. 1
  int fcn_w_off[SIMGNN_MAX_FCN], fcn_b_off[SIMGNN_MAX_FCN];
  int v_off, b_off, w_floats;
  int tile, ldh;                        // pairs a tile, row stride
  int row_off[2];                       // h1 rows of a stage; h2 + tile*ldh
  int ks_off[2], kld;                   // NTN outputs / FCN [tile][kld] x 2
  int smem_floats;
};

extern "C" int simgnn_head_layout_size(void) {
  return (int)sizeof(HeadLayout);
}

__device__ __forceinline__ void head_cp16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void head_cp4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void head_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void head_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// `floats` floats (a multiple of 4, 16-byte aligned both sides) from
// global to shared memory, 16 bytes a copy.
__device__ __forceinline__ void head_stage_flat(float* dst, const float* src,
                                                int floats) {
  for (int c = threadIdx.x * 4; c < floats; c += HEAD_THREADS * 4)
    head_cp16(dst + c, src + c);
}

// The h1 and h2 rows of tile `tile` (rows < B) into the stage at `rows`:
// h1 row p at rows + p * ldh, h2 row p at rows + (TILE + p) * ldh.
// 16-byte copies when both inputs are 16-byte aligned, else 4-byte ones:
// the same values land either way.
template <int TILE>
__device__ __forceinline__ void head_stage_tile(float* rows, int ldh,
                                                const float* h1,
                                                const float* h2, long long B,
                                                long long tile, int vec) {
  const long long r0 = tile * TILE;
  const int n = (int)min((long long)TILE, B - r0);
  const float* s1 = h1 + r0 * HEAD_F;
  const float* s2 = h2 + r0 * HEAD_F;
  if (vec) {
    constexpr int Q = HEAD_F / 4;
    for (int idx = threadIdx.x; idx < 2 * n * Q; idx += HEAD_THREADS) {
      const int side = idx >= n * Q;
      const int rem = idx - side * n * Q;
      const int p = rem / Q, c = (rem - p * Q) * 4;
      head_cp16(rows + (side * TILE + p) * ldh + c,
                (side ? s2 : s1) + p * HEAD_F + c);
    }
  } else {
    for (int idx = threadIdx.x; idx < 2 * n * HEAD_F; idx += HEAD_THREADS) {
      const int side = idx >= n * HEAD_F;
      const int rem = idx - side * n * HEAD_F;
      const int p = rem / HEAD_F, c = rem - p * HEAD_F;
      head_cp4(rows + (side * TILE + p) * ldh + c,
               (side ? s2 : s1) + p * HEAD_F + c);
    }
  }
}

__device__ __forceinline__ float4 head_ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float head_comp(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The first three butterfly levels over the columns g = l + 4j a lane
// holds (v[j]): (g, g+16), then (g, g+8), then (g, g+4).
__device__ __forceinline__ float head_tree8(const float (&v)[8]) {
  return ((v[0] + v[4]) + (v[2] + v[6])) + ((v[1] + v[5]) + (v[3] + v[7]));
}

// The last two levels, inside the lane quad: (l, l+2), then (l, l+1).
__device__ __forceinline__ float head_quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// Slices k0 = 2 kp and k1 = min(2 kp + 1, K - 1) of the NTN for the tile's
// pairs ps + 8 pp: out_k into ks[p * kld + k].
template <int PT>
__device__ __forceinline__ void head_slice_pair(const float* smem,
                                                const HeadLayout& L,
                                                const float* r1,
                                                const float* r2, int kp,
                                                float* ks) {
  const int lane = threadIdx.x & 31, l = lane & 3, ps = lane >> 2;
  const int k0 = 2 * kp, k1 = min(k0 + 1, L.k - 1);
  const int ldh = L.ldh;
  const float* w0 = smem + k0 * HEAD_F * HEAD_F + l * 8;
  const float* w1 = smem + k1 * HEAD_F * HEAD_F + l * 8;
  float acc[PT][2][8];
#pragma unroll
  for (int pp = 0; pp < PT; ++pp)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[pp][0][j] = acc[pp][1][j] = 0.0f;
#pragma unroll 2
  for (int i4 = 0; i4 < HEAD_F / 4; ++i4) {
    float4 hv[PT];
#pragma unroll
    for (int pp = 0; pp < PT; ++pp)
      hv[pp] = head_ld4(r1 + (ps + 8 * pp) * ldh + 4 * i4);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * i4 + q;
      const float4 a0 = head_ld4(w0 + i * HEAD_F);
      const float4 a1 = head_ld4(w0 + i * HEAD_F + 4);
      const float4 b0 = head_ld4(w1 + i * HEAD_F);
      const float4 b1 = head_ld4(w1 + i * HEAD_F + 4);
#pragma unroll
      for (int pp = 0; pp < PT; ++pp) {
        const float x = head_comp(hv[pp], q);
        float* c = acc[pp][0];
        c[0] = __fmaf_rn(x, a0.x, c[0]);
        c[1] = __fmaf_rn(x, a0.y, c[1]);
        c[2] = __fmaf_rn(x, a0.z, c[2]);
        c[3] = __fmaf_rn(x, a0.w, c[3]);
        c[4] = __fmaf_rn(x, a1.x, c[4]);
        c[5] = __fmaf_rn(x, a1.y, c[5]);
        c[6] = __fmaf_rn(x, a1.z, c[6]);
        c[7] = __fmaf_rn(x, a1.w, c[7]);
        float* d = acc[pp][1];
        d[0] = __fmaf_rn(x, b0.x, d[0]);
        d[1] = __fmaf_rn(x, b0.y, d[1]);
        d[2] = __fmaf_rn(x, b0.z, d[2]);
        d[3] = __fmaf_rn(x, b0.w, d[3]);
        d[4] = __fmaf_rn(x, b1.x, d[4]);
        d[5] = __fmaf_rn(x, b1.y, d[5]);
        d[6] = __fmaf_rn(x, b1.z, d[6]);
        d[7] = __fmaf_rn(x, b1.w, d[7]);
      }
    }
  }
  const float bk0 = smem[L.b_off + k0], bk1 = smem[L.b_off + k1];
  float res[PT][2];
#pragma unroll
  for (int pp = 0; pp < PT; ++pp) {
    const int p = ps + 8 * pp;
    float y1[8], y2[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      y1[j] = r1[p * ldh + l + 4 * j];
      y2[j] = r2[p * ldh + l + 4 * j];
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const float* v = smem + L.v_off + (kk ? k1 : k0) * 2 * HEAD_F + l;
      float bl[8], ln[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        bl[j] = __fmaf_rn(acc[pp][kk][j], y2[j], 0.0f);
        ln[j] = __fmaf_rn(y2[j], v[HEAD_F + 4 * j],
                          __fmaf_rn(y1[j], v[4 * j], 0.0f));
      }
      const float bil = head_quad_sum(head_tree8(bl));
      const float lin = head_quad_sum(head_tree8(ln));
      res[pp][kk] = simgnn_relu(bil + lin + (kk ? bk1 : bk0));
    }
  }
  if (l == 0) {
#pragma unroll
    for (int pp = 0; pp < PT; ++pp) {
      float* row = ks + (ps + 8 * pp) * L.kld;
      row[k0] = res[pp][0];
      if (k1 != k0) row[k1] = res[pp][1];
    }
  }
}

// PT pairs a thread, 8 * PT pairs a tile. Two CTAs an SM (128 registers
// a thread) where the shared layout lets them.
template <int PT>
__global__ void __launch_bounds__(HEAD_THREADS, 2)
simgnn_head_tiled_kernel(const float* __restrict__ h1,
                         const float* __restrict__ h2,
                         float* __restrict__ out, long long B,
                         const float* __restrict__ image, HeadLayout L,
                         int vec) {
  constexpr int TILE = 8 * PT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles = (int)((B + TILE - 1) / TILE);
  int tile = blockIdx.x;
  if (tile >= tiles) return;

  // The weight image and the first tile's rows; each later tile's rows are
  // staged while the one before computes.
  head_stage_flat(smem, image, L.w_floats);
  head_stage_tile<TILE>(smem + L.row_off[0], L.ldh, h1, h2, B, tile, vec);
  head_commit();
  head_wait<0>();
  __syncthreads();

  for (int s = 0; tile < tiles; tile += gridDim.x, s ^= 1) {
    const int next = tile + gridDim.x;
    if (next < tiles) {
      head_stage_tile<TILE>(smem + L.row_off[s ^ 1], L.ldh, h1, h2, B, next,
                            vec);
      head_commit();
    }
    const float* r1 = smem + L.row_off[s];
    const float* r2 = r1 + TILE * L.ldh;
    float* cur = smem + L.ks_off[0];
    float* nxt = smem + L.ks_off[1];
    for (int kp = threadIdx.x >> 5; kp < L.kp; kp += HEAD_WARPS)
      head_slice_pair<PT>(smem, L, r1, r2, kp, cur);
    __syncthreads();
    for (int layer = 0; layer < L.n_fcn; ++layer) {
      const int din = L.fcn_dims[layer], dout = L.fcn_dims[layer + 1];
      const float* w = smem + L.fcn_w_off[layer];
      const float* b = smem + L.fcn_b_off[layer];
      const bool last = layer + 1 == L.n_fcn;
      for (int idx = threadIdx.x; idx < TILE * dout; idx += HEAD_THREADS) {
        const int p = idx / dout, o = idx - p * dout;
        const float* c = cur + p * L.kld;
        float acc = 0.0f;
        for (int i = 0; i < din; ++i) acc = __fmaf_rn(c[i], w[i * dout + o], acc);
        acc += b[o];
        nxt[p * L.kld + o] = last ? acc : simgnn_relu(acc);
      }
      __syncthreads();
      float* t = cur; cur = nxt; nxt = t;
    }
    for (int p = threadIdx.x; p < TILE; p += HEAD_THREADS) {
      const long long pair = (long long)tile * TILE + p;
      if (pair < B) out[pair] = simgnn_sigmoid(cur[p * L.kld]);
    }
    head_wait<0>();
    __syncthreads();
  }
}

template <int PT>
static cudaError_t head_tiled(const float* h1, const float* h2, float* out,
                              long long B, const float* image,
                              const HeadLayout& L, int grid, int smem_bytes,
                              int vec, cudaStream_t stream) {
  auto k = simgnn_head_tiled_kernel<PT>;
  cudaError_t err = simgnn_set_smem(k, smem_bytes);
  if (err != cudaSuccess) return err;
  k<<<grid, HEAD_THREADS, smem_bytes, stream>>>(h1, h2, out, B, image, L,
                                                vec);
  return cudaGetLastError();
}

extern "C" int simgnn_head_tiled_launch(const float* h1, const float* h2,
                                        float* out, long long B,
                                        const float* image,
                                        const HeadLayout* L, int pt, int grid,
                                        int threads, int smem_bytes,
                                        void* stream) {
  if (threads != HEAD_THREADS || grid < 1 || pt < 1 || L->tile != 8 * pt ||
      (B + L->tile - 1) / L->tile > 0x7fffffffLL || L->k < 1 ||
      L->kp != (L->k + 1) / 2 ||
      L->n_fcn < 1 || L->n_fcn > SIMGNN_MAX_FCN ||
      (size_t)smem_bytes < (size_t)L->smem_floats * 4 ||
      ((uintptr_t)image & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const int vec = ((uintptr_t)h1 & 15) == 0 && ((uintptr_t)h2 & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (pt) {
    case 1: err = head_tiled<1>(h1, h2, out, B, image, *L, grid, smem_bytes, vec, st); break;
    case 4: err = head_tiled<4>(h1, h2, out, B, image, *L, grid, smem_bytes, vec, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// CTAs of the tiled kernel that one SM holds at this tile and shared
// bytes, as the runtime computes it (registers included).
extern "C" int simgnn_head_occupancy(int pt, int smem_bytes, int* ctas) {
  auto k = pt == 1 ? simgnn_head_tiled_kernel<1>
                    : simgnn_head_tiled_kernel<4>;
  cudaError_t err = simgnn_set_smem(k, smem_bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, k, HEAD_THREADS,
                                                        smem_bytes);
  return (int)err;
}
