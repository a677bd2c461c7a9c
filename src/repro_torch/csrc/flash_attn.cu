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
// What bounds it on this card: granite's 4096-token prefill (B 1, H 24,
// KV 8, D 64, causal, bf16) needs ~51.5 GFLOP for ~34 MB, ~52 us at the
// bf16 tensor-core rate: operations. Its 201 M exponentials take about as
// long on the SFUs (16 a clock per SM: ~52 us), so at D = 64 the exp and
// the softmax around it limit the kernel as much as the products.
//
// bfloat16 inputs run on the tensor cores (flash_attn_wgmma_kernel):
//
//   * one CTA of two warpgroups (256 threads) per (128 query rows, head,
//     batch), each warpgroup owning 64 rows; CTAs of the longest causal
//     rows are scheduled first; kv tiles that the causal mask or the window
//     empties for every row of the CTA are skipped, and a warpgroup skips
//     the tiles that are empty for its own rows (an empty tile changes
//     nothing: alpha = 1, p = 0);
//   * Q is staged once and 64-row K and V tiles, shared by both
//     warpgroups, are double-buffered in shared memory by cp.async, bf16,
//     in the 128-byte swizzled layout of wgmma.cuh, D padded with zeros to
//     DP (a multiple of 64) and the ragged end of S with zero rows (192 KB
//     at DP 256);
//   * S = Q K^T is wgmma m64n64k16 over DP in steps of 16, into a float32
//     accumulator of 32 registers a thread: each thread holds 2 query rows
//     x 16 kv columns, a row lives on the 4 lanes of a quad, and its max and
//     sum are xor-shuffle butterflies over lanes 1 and 2 that leave the same
//     bits in every lane;
//   * the softmax runs in base 2 on logits pre-scaled by log2(e), with the
//     SFU's ex2.approx (relative error ~2^-22, far inside rtol 2e-4; m and
//     alpha in the same units), in the order above: softcap before the
//     mask (tanh from ex2 and a reciprocal, ~2^-22 * cap absolute), -1e30 on
//     masked entries, p = 0 after the exp, l clamped at 1e-30; tiles that no
//     mask cuts skip the mask;
//   * O += P V takes P from registers as wgmma's A operand (the
//     accumulator's own layout) and V as an MN-major B operand, into a
//     [64, DP] float32 accumulator (DP / 2 registers a thread). P is
//     float32 in the TPU body, so it is split into two bf16 terms, hi =
//     bf16(p) and lo = bf16(p - hi), one MMA each into the same accumulator:
//     what is left out is ~2^-17 of p, far inside the float32 bound
//     (rtol 2e-4); a single rounding (what SDPA does) is ~2^-9 of p.
//
// float32 inputs keep the FMA body (flash_attn_kernel), whose tiling is:
//
//   * one CTA of 256 threads per (64 query rows, head, batch), ordered and
//     skipping tiles as above;
//   * per 64-row kv tile: K (transposed) and V staged in shared memory as
//     float32, zero-padded to DP columns and to the ragged end of S;
//   * each thread computes a 4 x 4 block of the score tile from float4
//     broadcasts of Q (transposed, staged once) and K, keeps m and l of
//     its 4 rows (reduced over the 16 threads of a row with lane shuffles,
//     every lane ending with the same bits), writes p transposed to shared
//     memory, and accumulates its 4 rows x DP/16 output columns of P.V in
//     registers across the kv tiles; P stays float32 in P.V.
//
// T and S are taken unpadded (the Pallas block_q / block_kv policies have
// no counterpart). No float atomics: every output is owned by one thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per CTA
constexpr int BKV = 64;         // kv rows per tile
constexpr int THREADS = 256;    // 16 x 16: 4 x 4 score blocks
constexpr int PAD = 4;          // keeps float4 rows aligned, spreads banks
constexpr int QS = BQ + PAD;    // row stride of Qt and Pt
constexpr int KS = BKV + PAD;   // row stride of Kt
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

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

// ---- bfloat16: the tensor-core kernel ------------------------------------

constexpr int WGS = 2;                  // consumer warpgroups per CTA
constexpr int BQW = WGS * 64;           // query rows per CTA
constexpr int WG_CTA_THREADS = WGS * tc::WG_THREADS;
constexpr float LOG2E = 1.4426950408889634f;

// Q, two K and two V tiles, and room to align them to 1024 bytes.
size_t wgmma_smem_bytes(int dp) {
  return (size_t)(BQW + 4 * BKV) * dp * sizeof(__nv_bfloat16) + 1024;
}

// cap * tanh(y) * log2(e) with tanh(y) = 1 - 2 / (1 + e^2y) from the SFU's
// exp2 and reciprocal: absolute error ~2^-22 * cap in the logit (1.2e-5 at
// cap 50), relative error that small in p.
__device__ __forceinline__ float softcap_log2(float y, float cap_log2e) {
  y = fminf(fmaxf(y, -15.0f), 15.0f);      // tanh(15) is 1 in float32
  const float e = tc::ex2(2.0f * LOG2E * y);
  return cap_log2e * (1.0f - 2.0f * __frcp_rn(1.0f + e));
}

// Two CTAs an SM at DP 64 (at most 128 registers a thread), one above.
template <int DP>
__global__ void __launch_bounds__(WG_CTA_THREADS, DP <= 64 ? 2 : 1)
flash_attn_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o, int Tq, int S, int H,
                        int KV, int D, float scale, int causal,
                        int use_window, int window, int use_softcap,
                        float softcap) {
  constexpr int NCH = DP / 64;                 // 64 O columns per P.V MMA
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* Qs = tc::align_1k(smem_raw);  // [BQW][DP]
  __nv_bfloat16* Ks = Qs + BQW * DP;           // [2][BKV][DP]
  __nv_bfloat16* Vs = Ks + 2 * BKV * DP;       // [2][BKV][DP]

  const int tid = threadIdx.x, wg = tid >> 7;
  const int g = (tid & 31) >> 2, qd = tid & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQW;
  const int qw = q0 + 64 * wg;                 // this warpgroup's 64 rows
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const long long q_row = (long long)H * D, kv_row = (long long)KV * D;
  const __nv_bfloat16* qb = q + ((long long)b * Tq * H + h) * D;
  const __nv_bfloat16* kb = k + ((long long)b * S * KV + kvh) * D;
  const __nv_bfloat16* vb = v + ((long long)b * S * KV + kvh) * D;

  // kv rows any query row of the CTA (of the warpgroup) can see
  const int kv_end = causal ? min(S, q0 + BQW) : S;
  const int kv_begin = use_window ? max(0, q0 - window + 1) : 0;
  const int wg_end = qw >= Tq ? 0 : causal ? min(S, qw + 64) : S;
  const int wg_begin = use_window ? max(0, qw - window + 1) : 0;
  const int j_first = kv_begin / BKV * BKV;
  const int n_tiles = kv_end > j_first ? (kv_end - j_first + BKV - 1) / BKV
                                       : 0;

  auto stage_kv = [&](int t) {
    const int j0 = j_first + t * BKV, live = min(BKV, S - j0);
    tc::stage_tile<BKV, DP, WG_CTA_THREADS>(
        Ks + (t & 1) * BKV * DP,
        [&](int r) { return kb + (j0 + r) * kv_row; }, live, D);
    tc::stage_tile<BKV, DP, WG_CTA_THREADS>(
        Vs + (t & 1) * BKV * DP,
        [&](int r) { return vb + (j0 + r) * kv_row; }, live, D);
  };
  tc::stage_tile<BQW, DP, WG_CTA_THREADS>(
      Qs, [&](int r) { return qb + (q0 + r) * q_row; }, min(BQW, Tq - q0),
      D);
  if (n_tiles > 0) stage_kv(0);
  tc::cp_async_commit();

  // this thread's query rows: 16 w + g and 16 w + g + 8 of its 64
  const int qi[2] = {qw + 16 * ((tid & 127) >> 5) + g,
                     qw + 16 * ((tid & 127) >> 5) + g + 8};
  auto visible = [&](int kj, int row) {
    return kj < S && (!causal || kj <= row) &&
           (!use_window || row - kj < window);
  };
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[NCH][32];
#pragma unroll
  for (int nc = 0; nc < NCH; ++nc)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[nc][x] = 0.0f;
  const float scale2 = scale * LOG2E;
  const float cap_in = use_softcap ? scale / softcap : 0.0f;
  const float cap_log2e = use_softcap ? softcap * LOG2E : 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = j_first + t * BKV;
    if (t + 1 < n_tiles) {
      stage_kv(t + 1);               // into the buffers tile t - 1 used
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    tc::fence_smem_for_wgmma();
    __syncthreads();
    // a tile none of this warpgroup's rows sees changes nothing of it
    if (j0 < wg_end && j0 + BKV > wg_begin) {
      const __nv_bfloat16* kt = Ks + (t & 1) * BKV * DP;
      const __nv_bfloat16* vt = Vs + (t & 1) * BKV * DP;

      // ---- S = Q K^T
      float s[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = 0.0f;
      tc::wg_arrive();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        tc::wgmma_ss_n64<0, 0>(s, tc::desc_kmajor<BQW>(Qs, kk, 64 * wg),
                               tc::desc_kmajor<BKV>(kt, kk), 1);
      tc::wg_commit();
      tc::wg_wait_all();
      tc::fence_regs(s);

      // ---- online softmax, base 2, in the accumulator's layout: logits
      // (softcapped), -1e30 where masked, then the row max
      const bool cut = !(j0 + BKV <= S && (!causal || j0 + BKV - 1 <= qw) &&
                         (!use_window || qw + 63 - j0 < window));
#pragma unroll
      for (int x = 0; x < 32; ++x)
        s[x] = use_softcap ? softcap_log2(s[x] * cap_in, cap_log2e)
                           : s[x] * scale2;
      if (cut) {
#pragma unroll
        for (int x = 0; x < 32; ++x)
          if (!visible(j0 + 8 * (x >> 2) + 2 * qd + (x & 1),
                       qi[(x >> 1) & 1]))
            s[x] = NEG_INF;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mc = NEG_INF;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mc = fmaxf(mc, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
        const float m_new = fmaxf(m[i], mc);
        // p = exp(s - m_new), then 0 where masked
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = s[4 * j + 2 * i + c];
            x = tc::ex2(x - m_new);
            if (cut && !visible(j0 + 8 * j + 2 * qd + c, qi[i])) x = 0.0f;
            rs += x;
          }
        rs += __shfl_xor_sync(0xffffffffu, rs, 1);
        rs += __shfl_xor_sync(0xffffffffu, rs, 2);
        const float alpha = tc::ex2(m[i] - m_new);
        l[i] = l[i] * alpha + rs;
        m[i] = m_new;
#pragma unroll
        for (int nc = 0; nc < NCH; ++nc)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[nc][4 * j + 2 * i] *= alpha;
            acc[nc][4 * j + 2 * i + 1] *= alpha;
          }
      }

      // ---- O += P V, P split into bf16 hi + lo, straight from registers
      uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float a = s[8 * kk + 2 * r], bb = s[8 * kk + 2 * r + 1];
          const float a_hi = tc::split_bf16(a), b_hi = tc::split_bf16(bb);
          p_hi[kk][r] = tc::pack_bf16(a_hi, b_hi);
          p_lo[kk][r] = tc::pack_bf16(a, bb);
        }
#pragma unroll
      for (int nc = 0; nc < NCH; ++nc) tc::fence_regs(acc[nc]);
      tc::wg_arrive();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int nc = 0; nc < NCH; ++nc) {
          const uint64_t dv = tc::desc_mnmajor<BKV>(vt, kk, nc * 64);
          tc::wgmma_rs_n64<1>(acc[nc], p_hi[kk], dv, 1);
          tc::wgmma_rs_n64<1>(acc[nc], p_lo[kk], dv, 1);
        }
      tc::wg_commit();
      tc::wg_wait_all();
#pragma unroll
      for (int nc = 0; nc < NCH; ++nc) tc::fence_regs(acc[nc]);
    }
    __syncthreads();                 // tile t's buffers are free again
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qi[i] >= Tq) continue;
    const float lr = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* dst = o + (((long long)b * Tq + qi[i]) * H + h) * D;
#pragma unroll
    for (int nc = 0; nc < NCH; ++nc)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = nc * 64 + 8 * j + 2 * qd;
        const float a = acc[nc][4 * j + 2 * i] / lr;
        const float bb = acc[nc][4 * j + 2 * i + 1] / lr;
        if (col + 1 < D && (D & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(dst + col) =
              __floats2bfloat162_rn(a, bb);
        } else {
          if (col < D) dst[col] = __float2bfloat16_rn(a);
          if (col + 1 < D) dst[col + 1] = __float2bfloat16_rn(bb);
        }
      }
  }
}

template <int DP>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B,
                 int T, int S, int H, int KV, int D, float scale, int causal,
                 int use_window, int window, int use_softcap, float softcap,
                 cudaStream_t stream) {
  const size_t smem = wgmma_smem_bytes(DP);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attn_wgmma_kernel<DP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((T + BQW - 1) / BQW, H, B);
  flash_attn_wgmma_kernel<DP><<<grid, WG_CTA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      T, S, H, KV, D, scale, causal, use_window, window, use_softcap,
      softcap);
  return (int)cudaGetLastError();
}

// D rounded up to the padded head widths the kernels are instantiated for:
// multiples of 32 (the FMA body), of 64 (the 128-byte swizzle atoms of the
// tensor-core kernel).
int padded_d(int D) { return (D + 31) / 32 * 32; }
int padded_d_wgmma(int D) { return (D + 63) / 64 * 64; }

int dispatch_f32(const void* q, const void* k, const void* v, void* o, int B,
                 int T, int S, int H, int KV, int D, float scale, int causal,
                 int use_window, int window, int use_softcap, float softcap,
                 cudaStream_t st) {
#define FLASH_CASE(DP)                                                     \
  if (padded_d(D) == DP)                                                   \
    return launch<float, DP>(q, k, v, o, B, T, S, H, KV, D, scale, causal,   \
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

int dispatch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                  int T, int S, int H, int KV, int D, float scale, int causal,
                  int use_window, int window, int use_softcap, float softcap,
                  cudaStream_t st) {
#define FLASH_CASE(DP)                                                     \
  if (padded_d_wgmma(D) == DP)                                             \
    return launch_wgmma<DP>(q, k, v, o, B, T, S, H, KV, D, scale, causal,    \
                            use_window, window, use_softcap, softcap, st);
  FLASH_CASE(64)
  FLASH_CASE(128)
  FLASH_CASE(192)
  FLASH_CASE(256)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

bool valid(int dtype, int B, int T, int H, int D) {
  return B > 0 && B <= 65535 && T > 0 && H > 0 && H <= 65535 && D > 0 &&
         D <= 256 && (dtype == 0 || dtype == 1);
}

}  // namespace

// D <= 256, H % KV == 0, S >= 1. dtype (of q, k, v and o) 0: float32 (the
// FMA body), 1: bfloat16 (the tensor-core kernel). causal / use_window /
// use_softcap are 0 or 1. Returns a cudaError_t.
extern "C" int flash_attn_launch(int dtype, const void* q, const void* k,
                                 const void* v, void* o, int B, int T, int S,
                                 int H, int KV, int D, float scale,
                                 int causal, int use_window, int window,
                                 int use_softcap, float softcap,
                                 void* stream) {
  if (!valid(dtype, B, T, H, D) || S <= 0 || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch_f32(q, k, v, o, B, T, S, H, KV, D, scale, causal,
                        use_window, window, use_softcap, softcap, st);
  return dispatch_bf16(q, k, v, o, B, T, S, H, KV, D, scale, causal,
                       use_window, window, use_softcap, softcap, st);
}

// What a launch of these arguments runs: out[0] the path (0: the float32
// FMA body, 1: the bf16 wgmma kernel), out[1] the padded head width DP,
// out[2] CTAs, out[3] threads per CTA, out[4] dynamic shared bytes per CTA.
// Returns a cudaError_t.
extern "C" int flash_attn_plan(int dtype, int B, int T, int H, int D,
                               int* out) {
  if (!valid(dtype, B, T, H, D)) return (int)cudaErrorInvalidValue;
  const int dp = dtype == 1 ? padded_d_wgmma(D) : padded_d(D);
  out[0] = dtype;
  out[1] = dp;
  const int rows = dtype == 1 ? BQW : BQ;
  out[2] = (T + rows - 1) / rows * H * B;
  out[3] = dtype == 1 ? WG_CTA_THREADS : THREADS;
  out[4] = (int)(dtype == 1 ? wgmma_smem_bytes(dp) : smem_bytes(dp));
  return 0;
}
