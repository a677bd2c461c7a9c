// Online-softmax GQA attention for Hopper: causal, sliding window and logit
// softcap, float32 inside.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn.py
// (flash_attention, body _kernel), whose grid (batch, head, q block, kv
// block) carries the running max m, denominator l and the [bq, D]
// accumulator in VMEM across the sequential kv blocks. q is [B, T, H, D],
// k and v [B, S, KV, D] (float32 or bfloat16, one type), o has q's shape
// and type; head h reads kv head h / (H / KV). The masks are the TPU
// body's, by absolute index from 0 on both axes (a causal q row t sees kv
// rows s <= t also when T != S), and so is the order of the arithmetic
// that decides the result's bits up to float32 rounding:
//
//   s = (q . k) * D^-0.5; s = cap * tanh(s / cap) (softcap, before the mask);
//   s = -1e30 where masked; m_new = max(m, rowmax(s)); p = exp(s - m_new),
//   then p = 0 where masked (after the exp: a row whose first tile is fully
//   masked must not weigh each masked entry 1); alpha = exp(m - m_new);
//   l = l * alpha + rowsum(p); acc = acc * alpha + p v;
//   o = acc / max(l, 1e-30) (fully masked rows give 0), rounded once.
//
// P stays float32 in the P.V product, as in the TPU body.
//
// What bounds it on this card: granite's 4096-token prefill (B 1, H 24,
// KV 8, D 64, causal, bf16) needs ~51.5 GFLOP for ~34 MB, ~52 us at the
// bf16 tensor-core rate: operations. This first kernel runs on the float32
// FMA units (no tensor cores yet), with the FlashAttention tiling:
//
//   * one CTA of 256 threads per (64 query rows, head, batch); CTAs of the
//     longest causal rows are scheduled first;
//   * per 64-row kv tile: K (transposed) and V staged in shared memory as
//     float32, zero-padded to DP columns (D rounded up to 32) and to the
//     ragged end of S; tiles that the causal mask or the window empties
//     for every row of the CTA are skipped (an empty tile changes nothing:
//     alpha = 1, p = 0);
//   * each thread computes a 4 x 4 block of the score tile from float4
//     broadcasts of Q (transposed, staged once) and K, keeps m and l of
//     its 4 rows (reduced over the 16 threads of a row with lane shuffles,
//     every lane ending with the same bits), writes p transposed to shared
//     memory, and accumulates its 4 rows x DP/16 output columns of P.V in
//     registers across the kv tiles.
//
// T and S are taken unpadded (the Pallas block_q / block_kv policies have
// no counterpart). No float atomics: every output is owned by one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BKV = 64;         // kv rows per tile
constexpr int THREADS = 256;    // 16 x 16: 4 x 4 score blocks
constexpr int PAD = 4;          // keeps float4 rows aligned, spreads banks
constexpr int QS = BQ + PAD;    // row stride of Qt and Pt
constexpr int KS = BKV + PAD;   // row stride of Kt
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

size_t smem_bytes(int dp) {
  return (size_t)(dp * QS + dp * KS + BKV * dp + BKV * QS) * sizeof(float);
}

template <typename Elt, int DP>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const Elt* __restrict__ q, const Elt* __restrict__ k,
                  const Elt* __restrict__ v, Elt* __restrict__ o, int Tq, int S,
                  int H, int KV, int D, float scale, int causal,
                  int use_window, int window, int use_softcap,
                  float softcap) {
  constexpr int CPT = DP / 16;              // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qt = smem;                         // [DP][QS]  Q transposed
  float* Kt = Qt + DP * QS;                 // [DP][KS]  K transposed
  float* Vs = Kt + DP * KS;                 // [BKV][DP]
  float* Pt = Vs + BKV * DP;                // [BKV][QS] P transposed

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int idx = tid; idx < BQ * DP; idx += THREADS) {
    const int row = idx / DP, dd = idx - row * DP;
    const int tq = q0 + row;
    Qt[dd * QS + row] =
        (tq < Tq && dd < D)
            ? to_f32(q[(((long long)b * Tq + tq) * H + h) * D + dd]) : 0.0f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) acc[r][cc] = 0.0f;
  }

  // kv rows any query row of this CTA can see
  int kv_end = S;
  if (causal) kv_end = min(S, q0 + BQ);
  int kv_begin = 0;
  if (use_window) kv_begin = max(0, q0 - window + 1);

  for (int j0 = kv_begin / BKV * BKV; j0 < kv_end; j0 += BKV) {
    __syncthreads();                        // the previous tile is consumed
    for (int idx = tid; idx < BKV * DP; idx += THREADS) {
      const int jr = idx / DP, dd = idx - jr * DP;
      const int sk = j0 + jr;
      const bool live = sk < S && dd < D;
      const long long off = (((long long)b * S + sk) * KV + kvh) * D + dd;
      Kt[dd * KS + jr] = live ? to_f32(k[off]) : 0.0f;
      Vs[jr * DP + dd] = live ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < DP; ++dd) {
      const float4 qa = *reinterpret_cast<const float4*>(Qt + dd * QS + 4 * ty);
      const float4 kb = *reinterpret_cast<const float4*>(Kt + dd * KS + 4 * tx);
      const float qr[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kc[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

    float p[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + 4 * ty + r;
      bool ok[4];
      float mc = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = j0 + 4 * tx + c;
        float x = s[r][c] * scale;
        if (use_softcap) x = softcap * tanhf(x / softcap);
        ok[c] = kj < S && (!causal || kj <= qi) &&
                (!use_window || qi - kj < window);
        s[r][c] = ok[c] ? x : NEG_INF;
        mc = fmaxf(mc, s[r][c]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float m_new = fmaxf(m[r], mc);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        p[r][c] = ok[c] ? expf(s[r][c] - m_new) : 0.0f;
        rs += p[r][c];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) acc[r][cc] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Pt + (4 * tx + c) * QS + 4 * ty) =
          make_float4(p[0][c], p[1][c], p[2][c], p[3][c]);
    __syncthreads();

#pragma unroll 4
    for (int jr = 0; jr < BKV; ++jr) {
      const float4 pa = *reinterpret_cast<const float4*>(Pt + jr * QS + 4 * ty);
      const float pr[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int cc = 0; cc < CPT; ++cc) {
        const float vv = Vs[jr * DP + tx + 16 * cc];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][cc] = fmaf(pr[r], vv, acc[r][cc]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + 4 * ty + r;
    if (qi >= Tq) continue;
    const float lr = fmaxf(l[r], 1e-30f);
    Elt* dst = o + (((long long)b * Tq + qi) * H + h) * D;
#pragma unroll
    for (int cc = 0; cc < CPT; ++cc) {
      const int col = tx + 16 * cc;
      if (col < D) store(dst + col, acc[r][cc] / lr);
    }
  }
}

template <typename Elt, int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int T, int S, int H, int KV, int D, float scale, int causal,
           int use_window, int window, int use_softcap, float softcap,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(DP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_kernel<Elt, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_attn_kernel<Elt, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const Elt*>(q), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), static_cast<Elt*>(o), T, S, H, KV, D, scale,
      causal, use_window, window, use_softcap, softcap);
  return (int)cudaGetLastError();
}

template <typename Elt>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int T, int S, int H, int KV, int D, float scale, int causal,
             int use_window, int window, int use_softcap, float softcap,
             cudaStream_t st) {
#define FLASH_CASE(DP)                                                     \
  if (D <= DP)                                                             \
    return launch<Elt, DP>(q, k, v, o, B, T, S, H, KV, D, scale, causal,     \
                         use_window, window, use_softcap, softcap, st);
  FLASH_CASE(32)
  FLASH_CASE(64)
  FLASH_CASE(96)
  FLASH_CASE(128)
  FLASH_CASE(160)
  FLASH_CASE(192)
  FLASH_CASE(224)
  FLASH_CASE(256)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// D <= 256, H % KV == 0, S >= 1. dtype (of q, k, v and o) 0: float32,
// 1: bfloat16. causal / use_window / use_softcap are 0 or 1. Returns a
// cudaError_t.
extern "C" int flash_attn_launch(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int B, int T, int S,
                                 int H, int KV, int D, float scale,
                                 int causal, int use_window, int window,
                                 int use_softcap, float softcap,
                                 void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || S <= 0 || H <= 0 || H > 65535 ||
      KV <= 0 || H % KV || D <= 0 || D > 256 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, T, S, H, KV, D, scale, causal,
                           use_window, window, use_softcap, softcap, st);
  return dispatch<__nv_bfloat16>(q, k, v, o, B, T, S, H, KV, D, scale,
                                 causal, use_window, window, use_softcap,
                                 softcap, st);
}
