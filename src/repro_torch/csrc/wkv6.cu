// RWKV-6 (Finch) WKV recurrence for Hopper, float32 state.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wkv6.py (wkv6, body
// _kernel), whose grid (batch, head, time block) keeps the [K, V] float32
// state in VMEM scratch across the sequential time blocks. Per head:
//
//   o_t[j]  = sum_i r_t[i] S[i][j] + (sum_i r_t[i] u[i] k_t[i]) v_t[j]
//   S[i][j] = w_t[i] S[i][j] + k_t[i] v_t[j]
//
// r, k, v are [B, T, H, K|V] in float32 or bfloat16 (one type), w is
// [B, T, H, K] float32 (the model's decay exp(-exp(.)) is float32), u is
// [H, K] float32. The launch reads an optional initial state s0
// [B, H, K, V] (null: zeros) and writes the final state sT [B, H, K, V]
// and o [B, T, H, V], both float32; the wrapper rounds o to bf16 when the
// caller asks for it (one rounding, as the TPU body's astype).
//
// What bounds it on this card: at the served shape (B 4, T 512, H 64,
// K = V = 64) the launch does ~2.1 GFLOP (4 K V flops per token and head)
// against ~121 MB (r, k, v in bf16, w and o in float32, the state), so
// bytes and float32 operations give about the same ~35 us. Time is
// sequential, so the design spreads each head's state over many threads:
//
//   * one CTA per (batch, head) walks the whole sequence; its 4 * V
//     threads own the state, thread (j, q) holding rows q*KQ .. q*KQ+KQ-1
//     of column j in registers (KQ = KMAX / 4; rows K..KMAX-1 stay zero);
//   * TB time steps of r, k, w (float32, zero-padded to KMAX) and v are
//     staged in shared memory at once, and the bonus r.(u*k) of each step
//     is reduced once per step by one warp;
//   * per step a thread does KQ fused multiply-adds for its part of r.S
//     and KQ for its rows of the update; the four parts of o_t[j] are
//     added with two lane shuffles, so the KV-long dependent chain of one
//     thread becomes KQ/4-long chains in four threads.
//
// No float atomics: o_t[j] and every state entry are owned by one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TB = 16;      // time steps staged per pass
constexpr int KSPLIT = 4;   // threads per state column

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Elt, int KMAX>
__global__ void __launch_bounds__(1024)
wkv6_kernel(const Elt* __restrict__ r, const Elt* __restrict__ k,
            const Elt* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ sT, int Tlen, int H,
            int K, int V) {
  constexpr int KQ = KMAX / KSPLIT;
  extern __shared__ __align__(16) float smem[];
  float* rs = smem;                 // [TB][KMAX]
  float* ks = rs + TB * KMAX;       // [TB][KMAX]
  float* ws = ks + TB * KMAX;       // [TB][KMAX]
  float* us = ws + TB * KMAX;       // [KMAX]
  float* bs = us + KMAX;            // [TB] bonus r.(u*k) per step
  float* vs = bs + TB;              // [TB][V]

  const int bh = blockIdx.x;        // b * H + h
  const int b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int j = tid / KSPLIT, q = tid - j * KSPLIT;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const bool owner = j < V;
  const int i0 = q * KQ;

  float s[KQ];
#pragma unroll
  for (int m = 0; m < KQ; ++m) {
    const int i = i0 + m;
    s[m] = (s0 != nullptr && owner && i < K)
               ? s0[((long long)bh * K + i) * V + j] : 0.0f;
  }
  for (int i = tid; i < KMAX; i += nthreads)
    us[i] = i < K ? u[(long long)h * K + i] : 0.0f;

  for (int t0 = 0; t0 < Tlen; t0 += TB) {
    const int nt = min(TB, Tlen - t0);
    __syncthreads();                      // the previous block is consumed
    for (int idx = tid; idx < TB * KMAX; idx += nthreads) {
      const int tt = idx / KMAX, i = idx - tt * KMAX;
      const bool live = tt < nt && i < K;
      const long long off = (((long long)b * Tlen + t0 + tt) * H + h) * K + i;
      rs[idx] = live ? to_f32(r[off]) : 0.0f;
      ks[idx] = live ? to_f32(k[off]) : 0.0f;
      ws[idx] = live ? w[off] : 0.0f;
    }
    for (int idx = tid; idx < TB * V; idx += nthreads) {
      const int tt = idx / V, c = idx - tt * V;
      vs[idx] = tt < nt
          ? to_f32(v[(((long long)b * Tlen + t0 + tt) * H + h) * V + c])
          : 0.0f;
    }
    __syncthreads();
    for (int tt = warp; tt < nt; tt += nwarps) {
      float p = 0.0f;
      for (int i = lane; i < KMAX; i += 32)
        p += rs[tt * KMAX + i] * us[i] * ks[tt * KMAX + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off);
      if (lane == 0) bs[tt] = p;
    }
    __syncthreads();

    for (int tt = 0; tt < nt; ++tt) {
      const float vj = owner ? vs[tt * V + j] : 0.0f;
      const float* rt = rs + tt * KMAX + i0;
      const float* kt = ks + tt * KMAX + i0;
      const float* wt = ws + tt * KMAX + i0;
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < KQ; m += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(rt + m);
        const float4 k4 = *reinterpret_cast<const float4*>(kt + m);
        const float4 w4 = *reinterpret_cast<const float4*>(wt + m);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          a[e] = fmaf(rr[e], s[m + e], a[e]);
          s[m + e] = fmaf(ww[e], s[m + e], kk[e] * vj);
        }
      }
      float dot = (a[0] + a[1]) + (a[2] + a[3]);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      if (owner && q == 0)
        o[(((long long)b * Tlen + t0 + tt) * H + h) * V + j] =
            dot + bs[tt] * vj;
    }
  }

  if (owner) {
#pragma unroll
    for (int m = 0; m < KQ; ++m) {
      const int i = i0 + m;
      if (i < K) sT[((long long)bh * K + i) * V + j] = s[m];
    }
  }
}

template <typename Elt, int KMAX>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, float* o, float* sT, int B,
           int T, int H, int K, int V, cudaStream_t stream) {
  const int vpad = (V + 7) / 8 * 8;          // 4 * vpad threads: whole warps
  const size_t smem = (size_t)(3 * TB * KMAX + KMAX + TB + TB * V) *
                      sizeof(float);
  wkv6_kernel<Elt, KMAX><<<B * H, KSPLIT * vpad, smem, stream>>>(
      static_cast<const Elt*>(r), static_cast<const Elt*>(k),
      static_cast<const Elt*>(v), w, u, s0, o, sT, T, H, K, V);
  return (int)cudaGetLastError();
}

template <typename Elt>
int dispatch(const void* r, const void* k, const void* v, const float* w,
             const float* u, const float* s0, float* o, float* sT, int B,
             int T, int H, int K, int V, cudaStream_t s) {
  if (K <= 16) return launch<Elt, 16>(r, k, v, w, u, s0, o, sT, B, T, H, K, V, s);
  if (K <= 32) return launch<Elt, 32>(r, k, v, w, u, s0, o, sT, B, T, H, K, V, s);
  if (K <= 64) return launch<Elt, 64>(r, k, v, w, u, s0, o, sT, B, T, H, K, V, s);
  return launch<Elt, 128>(r, k, v, w, u, s0, o, sT, B, T, H, K, V, s);
}

}  // namespace

// K <= 128, V <= 256. dtype (of r, k, v) 0: float32, 1: bfloat16; w, u,
// s0 (may be null), o and sT are float32. Returns a cudaError_t.
extern "C" int wkv6_launch(int dtype, const void* r, const void* k,
                           const void* v, const float* w, const float* u,
                           const float* s0, float* o, float* sT, int B,
                           int T, int H, int K, int V, void* stream) {
  const long long bh = (long long)B * H;
  if (B <= 0 || H <= 0 || T <= 0 || K <= 0 || K > 128 || V <= 0 ||
      V > 256 || bh > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch<float>(r, k, v, w, u, s0, o, sT, B, T, H, K, V, s);
  return dispatch<__nv_bfloat16>(r, k, v, w, u, s0, o, sT, B, T, H, K, V, s);
}
